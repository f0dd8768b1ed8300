"""Host ms a train step spends sending its batch to the card
(``data.loader.to_device``: the span ``loader.to_device``), over the traced
window's ``train.step`` spans."""

from port_bench import spans


def read(record):
    return spans.ms_per_root("loader.to_device", "train.step")
