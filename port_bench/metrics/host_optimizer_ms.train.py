"""Host ms a train step spends in its AdamW and schedule step (the span
``train.optimizer``, boundaries 3 -> 4), over the traced window's
``train.step`` spans: beside ``optimizer_ms.train``, the same phase by the
card's events."""

from port_bench import spans


def read(record):
    return spans.ms_per_root("train.optimizer", "train.step")
