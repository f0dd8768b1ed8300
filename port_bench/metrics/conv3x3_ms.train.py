"""Device ms a train step of the hand-written f32 3x3 conv
(``ops/cuda_conv``, ``csrc/conv3x3_f32.cu``): the traced window's kernels
whose name holds ``conv3x3_f32``, over its ``train.step`` spans. 0 where no
conv launched the kernel; None for a window without a step or a trace."""

from port_bench import spans


def read(record):
    trace = record.get("trace")
    steps = sum(s.name == "train.step" for s in spans._spans())
    if trace is None or not steps:
        return None
    return 1e3 * sum(v[0] for n, v in trace["kernels"].items() if "conv3x3_f32" in n) / steps
