"""Host ms a train step spends in its zero_grad, backward and gradient
all-reduce (the span ``train.backward``, boundaries 2 -> 3), over the
traced window's ``train.step`` spans: beside ``backward_ms.train``, the
same phase by the card's events."""

from port_bench import spans


def read(record):
    return spans.ms_per_root("train.backward", "train.step")
