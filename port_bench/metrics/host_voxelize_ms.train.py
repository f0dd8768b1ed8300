"""Host ms a train step spends voxelising its frames: the per-sample
numbers and the voxeliser's launch (the span ``train.voxelize``, inside
``train.preprocess``), over the traced window's ``train.step`` spans."""

from port_bench import spans


def read(record):
    return spans.ms_per_root("train.voxelize", "train.step")
