"""Mean ms of the train step's AdamW and schedule step (events 3 -> 4)."""

from port_bench import harness


def read(record):
    return harness.mean_phase(record, "optimizer")
