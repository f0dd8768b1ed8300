"""Device ms a train step of the voxeliser (``ops/voxel``,
``csrc/voxelize.cu``): the traced window's kernels whose name holds
``voxelize_kernel``, over its ``train.step`` spans. 0 where no step
launched the kernel; None for a window without a step or a trace."""

from port_bench import spans


def read(record):
    trace = record.get("trace")
    steps = sum(s.name == "train.step" for s in spans._spans())
    if trace is None or not steps:
        return None
    return 1e3 * sum(v[0] for n, v in trace["kernels"].items() if "voxelize_kernel" in n) / steps
