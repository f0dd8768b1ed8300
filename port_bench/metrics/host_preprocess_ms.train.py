"""Host ms a train step spends in its preprocess and label synthesis (the
span ``train.preprocess``, boundaries 0 -> 1 of the step), over the traced
window's ``train.step`` spans: beside ``preprocess_ms.train``, the same
phase by the card's events."""

from port_bench import spans


def read(record):
    return spans.ms_per_root("train.preprocess", "train.step")
