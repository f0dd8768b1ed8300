"""The voxeliser's share of its bandwidth roofline in the train step, in
%: its bytes at the step's shape (``arith_v2v.voxelize_bytes``: frames
read, grids written) over 3.35 TB/s, over its mean device time a launch in
the trace."""

from port_bench import arith, arith_v2v, harness


def read(record):
    s = harness.kernel_seconds(record, "voxelize_kernel")
    if s is None or "voxelize" not in record:
        return None
    return arith.roofline_share(arith_v2v.voxelize_bytes(**record["voxelize"]), s)
