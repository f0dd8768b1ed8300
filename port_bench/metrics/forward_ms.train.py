"""Mean ms of the train step's model forward and loss (events 1 -> 2)."""

from port_bench import harness


def read(record):
    return harness.mean_phase(record, "forward")
