"""Fused instance-norm + relu whose backward is a hand-written CUDA kernel
for Hopper (counterpart of ``make_norm_relu_pallas`` in
``pixelwiseregression_tpu/ops/fused_normrelu.py``; K5).

The forward is ``ops/fused_normrelu.py``'s PyTorch forward (the JAX forward
is XLA, not Pallas). The backward, ``normrelu_bwd``:

* CPU tensors go to ``normrelu_bwd_plain``, the plain PyTorch version;
* CUDA tensors launch ``csrc/normrelu_bwd.cu`` (built by
  ``ops/cuda_lib.py``) or raise; there is no fallback.

``make_norm_relu_pallas``'s ``bt`` (samples per VMEM grid step) has no counterpart:
every launch spans the batch. ``LAUNCHES`` counts ``normrelu_bwd`` calls
that launched the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from pixelwiseregression_tpu_torch.ops import cuda_lib
from pixelwiseregression_tpu_torch.ops.fused_normrelu import norm_relu_with, normrelu_bwd_plain

LAUNCHES = 0

_DTYPES = (torch.float32, torch.bfloat16)
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    # (B, HW, C)
    "normrelu_bwd_workspace_floats": ([_I] * 3, ctypes.c_longlong),
    # (bf16, g, x, mean, inv, scale, bias, dx, dscale, dbias, work, B, HW, C, stream)
    "normrelu_bwd": ([_I] + [_P] * 10 + [_I] * 3 + [_P], ctypes.c_int),
}


def _fn(name):
    argtypes, restype = _ARGTYPES[name]
    return cuda_lib.function(name, argtypes, restype)


def normrelu_bwd(g, x, mean, inv, scale, bias):
    """The backward of ``relu(instance_norm(x))`` (K5, or its plain version
    for CPU tensors), with ``normrelu_bwd_plain``'s signature: ``g``, ``x``
    ``[B, H, W, C]`` in the activation dtype (f32 or bf16), ``mean``, ``inv``
    per-(B, C) f32, ``scale``, ``bias`` f32 ``[C]``. Returns dx in x's dtype
    and f32 dscale, dbias. On a card C must be a multiple of 8, at most 2048.
    """
    global LAUNCHES
    tensors = [g, x, mean, inv, scale, bias]
    if cuda_lib.on_cpu("normrelu_bwd", tensors):
        return normrelu_bwd_plain(g, x, mean, inv, scale, bias)
    if x.dtype not in _DTYPES or g.dtype != x.dtype:
        raise TypeError(f"normrelu_bwd takes f32 or bf16 g and x of one dtype, got {g.dtype}, "
                        f"{x.dtype}")
    if x.dim() != 4 or g.shape != x.shape:
        raise ValueError(f"g {tuple(g.shape)} and x {tuple(x.shape)} must be one NHWC shape")
    bsz, h, w, c = x.shape
    if c % 8 or c > 2048:
        raise ValueError(f"the kernel takes a multiple of 8 channels up to 2048, got {c}")
    for name, t in (("g", g), ("x", x)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned NHWC tensor")
    stats = [t.to(torch.float32).reshape(-1).contiguous() for t in (mean, inv)]
    params = [t.to(torch.float32).contiguous() for t in (scale, bias)]
    if any(t.numel() != bsz * c for t in stats) or any(t.shape != (c,) for t in params):
        raise ValueError(f"statistics must hold {bsz}x{c} values and scale, bias [{c}]")
    dx = torch.empty_like(x)
    dparams = torch.empty((2, c), dtype=torch.float32, device=x.device)
    work = torch.empty(int(_fn("normrelu_bwd_workspace_floats")(bsz, h * w, c)),
                       dtype=torch.float32, device=x.device)
    rc = _fn("normrelu_bwd")(
        int(x.dtype == torch.bfloat16), g.data_ptr(), x.data_ptr(), stats[0].data_ptr(),
        stats[1].data_ptr(), params[0].data_ptr(), params[1].data_ptr(), dx.data_ptr(),
        dparams[0].data_ptr(), dparams[1].data_ptr(), work.data_ptr(), bsz, h * w, c,
        torch.cuda.current_stream(x.device).cuda_stream)
    cuda_lib.check(rc, "normrelu_bwd")
    LAUNCHES += 1
    return dx, dparams[0], dparams[1]


def make_norm_relu_cuda():
    """A ``norm_relu(x, scale, bias, eps=1e-5)`` whose backward is K5 (the
    counterpart of ``make_norm_relu_pallas``; its ``bt`` has none)."""

    def norm_relu_cuda(x, scale, bias, eps: float = 1e-5):
        return norm_relu_with(normrelu_bwd, x, scale, bias, eps)

    return norm_relu_cuda


norm_relu_cuda = make_norm_relu_cuda()
