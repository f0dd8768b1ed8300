"""Host ms a train step spends in its model forward and loss (the span
``train.forward``, boundaries 1 -> 2), over the traced window's
``train.step`` spans: beside ``forward_ms.train``, the same phase by the
card's events."""

from port_bench import spans


def read(record):
    return spans.ms_per_root("train.forward", "train.step")
