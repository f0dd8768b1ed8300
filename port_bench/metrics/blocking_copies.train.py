"""Copies from or to pageable host memory a train step: the traced
window's device records whose name holds ``Pageable``, over its
``train.step`` spans. In PyTorch eager the host waits on the stream after
each."""

from port_bench import spans


def read(record):
    return spans.pageable_copies_per_root(record, "train.step")
