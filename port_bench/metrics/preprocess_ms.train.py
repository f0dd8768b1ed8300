"""Mean ms of the train step's preprocess and label synthesis (its CUDA
events 0 -> 1) over the traced window's steps."""

from port_bench import harness


def read(record):
    return harness.mean_phase(record, "preprocess")
