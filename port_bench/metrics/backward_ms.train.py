"""Mean ms of the train step's backward, K2 in it (events 2 -> 3)."""

from port_bench import harness


def read(record):
    return harness.mean_phase(record, "backward")
