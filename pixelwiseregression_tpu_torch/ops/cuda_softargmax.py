"""Fused soft-argmax decoder as hand-written CUDA kernels for Hopper
(counterpart of ``pixelwiseregression_tpu/ops/pallas_softargmax.py``).

Two kernels, each in its own source under ``csrc/``:

* K1, ``softargmax_fwd.cu``: the forward (heatmaps and uvd);
* K2, ``softargmax_bwd.cu``: the backward, which recomputes the forward and
  returns the gradients of the logits, the depth maps, the temperature
  ``w`` and, when asked, the label image (a second kernel).

A row runs on one of two plans of the same kernel, which the library
picks by the row's length and ``plan`` reports: on chip (the row held in
registers, read once) or streamed (several passes over the row).

Both are built with the port's other kernels into one library by
``ops/cuda_lib.py`` the first time a kernel is needed, and bound with
ctypes. A build or load failure raises.

The forward is a registered operator, ``torch.ops.pwr.softargmax_fwd``
(``torch.library.custom_op``), so that ``torch.export`` keeps K1 as one node
of an exported program (``serve_artifact.py``) instead of tracing into the
ctypes call, which it cannot. Every forward, live or exported, goes through
that operator. Wrappers, and what they do with each tensor:

* CPU tensors go to the plain PyTorch versions: ``ops/softargmax.py`` for
  the forward (the operator's CPU implementation), autograd through it for
  the backward;
* CUDA tensors launch the kernels or raise; there is no fallback;
* when autograd needs the decoder's gradients, ``decode_flat`` runs through
  a ``torch.autograd.Function`` whose forward is the operator (K1) and whose
  backward is K2. Its maps must be f32, as the JAX package's custom VJP
  takes them.

``LAUNCHES`` (K1) and ``BWD_LAUNCHES`` (K2) count the calls that launched
the kernels, so a run can show that its main path went through them;
``BWD_KERNEL_LAUNCHES`` counts K2's kernels (1 a call, 2 with dlabel).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pixelwiseregression_tpu_torch.ops import cuda_lib
from pixelwiseregression_tpu_torch.ops.softargmax import (
    _to_flat,
    soft_argmax_decode,
    soft_argmax_decode_flat,
)

LAUNCHES = 0
BWD_LAUNCHES = 0
BWD_KERNEL_LAUNCHES = 0

_DTYPES = (torch.float32, torch.bfloat16)
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    # (in_bf16, hm_bf16, x, dm, label, mask, w, hm, uvd, B, J, H, W, stream)
    "softargmax_fwd": [_I] * 2 + [_P] * 7 + [_I] * 4 + [_P],
    # (x, dm, label, mask, w, g_hm, g_uvd, dx, ddm, dlabel, dw, B, J, H, W, stream)
    "softargmax_bwd": [_P] * 11 + [_I] * 4 + [_P],
    # (hw, out[2])
    "softargmax_plan": [_I, _P],
    # (lo, hi, n, count, stream)
    "softargmax_div_mismatches": [ctypes.c_float] * 2 + [ctypes.c_longlong, _P, _P],
}
_PLANS = ("on_chip", "streamed")


def _fn(name):
    return cuda_lib.function(name, _ARGTYPES[name])


@functools.lru_cache(maxsize=None)
def plan(hw: int) -> dict:
    """The plan both kernels run for a row of ``hw`` pixels, as the library
    picks it: ``{"plan": "on_chip" | "streamed", "threads": a block's}``."""
    out = (ctypes.c_int * 2)()
    cuda_lib.check(_fn("softargmax_plan")(hw, out), "softargmax_plan")
    return {"plan": _PLANS[out[0]], "threads": out[1]}


def div_mismatches(lo: float, hi: float, n: int, device) -> int:
    """How many of n pairs (a, b), b in [lo, hi), the kernels' branch-free
    division (``div_rn`` in ``csrc/softargmax_common.cuh``) rounds other
    than a true division does, on the card."""
    count = torch.zeros(1, dtype=torch.int64, device=device)
    rc = _fn("softargmax_div_mismatches")(lo, hi, n, count.data_ptr(),
                                          torch.cuda.current_stream(device).cuda_stream)
    cuda_lib.check(rc, "softargmax_div_mismatches")
    return int(count.item())


def _check(x, dm, label, mask, w, h, wd, hm_dtype):
    b, j, hw = x.shape
    if hw != h * wd:
        raise ValueError(f"maps hold {hw} pixels per row, not {h}x{wd}")
    if dm.shape != x.shape or label.shape != (b, 1, hw) or mask.shape != (b, 1, hw):
        raise ValueError(f"shapes x {tuple(x.shape)} dm {tuple(dm.shape)} "
                         f"label {tuple(label.shape)} mask {tuple(mask.shape)}")
    if w.shape != (j,) or w.dtype != torch.float32:
        raise ValueError(f"w must be f32 [{j}], got {w.dtype} {tuple(w.shape)}")
    if x.dtype not in _DTYPES or hm_dtype not in _DTYPES:
        raise TypeError(f"kernel takes f32 or bf16 maps, got {x.dtype} -> {hm_dtype}")
    if any(t.dtype != x.dtype for t in (dm, label, mask)):
        raise TypeError("x, dm, label and mask must share one dtype")
    if b * j == 0 or hw % 8 != 0 or h + wd > 12288:
        raise ValueError(f"kernel needs B*J > 0, H*W % 8 == 0 and small H+W, got {b}x{j}x{h}x{wd}")
    for t in (x, dm, label, mask, w):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("kernel needs contiguous, 16-byte aligned tensors")


@torch.library.custom_op("pwr::softargmax_fwd", mutates_args=())
def softargmax_fwd(x: torch.Tensor, dm: torch.Tensor, label: torch.Tensor, mask: torch.Tensor,
                   w: torch.Tensor, h: int, wd: int,
                   hm_dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """The decoder's forward as a registered operator, ``pwr::softargmax_fwd``:
    K1 for CUDA tensors (``_softargmax_fwd_cuda``), and this, the plain
    version, for CPU tensors. Returns heatmaps ``[B, J, H*W]`` in
    ``hm_dtype`` and uvd ``[B, J, 3]`` f32.

    Being an operator, the call is one node of a traced program:
    ``torch.export`` keeps it as ``torch.ops.pwr.softargmax_fwd`` (its
    shapes from ``_softargmax_fwd_fake``), and the exported program
    dispatches it by the device of its inputs when it runs, so a program
    exported on the CPU and moved to the card launches K1 there.
    """
    cuda_lib.on_cpu("the decoder", [x, dm, label, mask, w])
    hm, uvd = soft_argmax_decode_flat(x, dm, label, mask, w, h, wd)
    return hm.to(hm_dtype), uvd


@softargmax_fwd.register_kernel("cuda")
def _softargmax_fwd_cuda(x, dm, label, mask, w, h, wd, hm_dtype):
    """K1: checks the tensors, launches, raises on a launch error."""
    global LAUNCHES
    cuda_lib.on_cpu("the decoder", [x, dm, label, mask, w])
    _check(x, dm, label, mask, w, h, wd, hm_dtype)
    b, j, hw = x.shape
    hm = torch.empty((b, j, hw), dtype=hm_dtype, device=x.device)
    uvd = torch.empty((b, j, 3), dtype=torch.float32, device=x.device)
    rc = _fn("softargmax_fwd")(
        int(x.dtype == torch.bfloat16), int(hm_dtype == torch.bfloat16),
        x.data_ptr(), dm.data_ptr(), label.data_ptr(), mask.data_ptr(), w.data_ptr(),
        hm.data_ptr(), uvd.data_ptr(), b, j, h, wd,
        torch.cuda.current_stream(x.device).cuda_stream)
    cuda_lib.check(rc, "softargmax_fwd")
    LAUNCHES += 1
    return hm, uvd


@softargmax_fwd.register_fake
def _softargmax_fwd_fake(x, dm, label, mask, w, h, wd, hm_dtype):
    b, j, hw = x.shape
    return x.new_empty((b, j, hw), dtype=hm_dtype), x.new_empty((b, j, 3), dtype=torch.float32)


def decode_flat_backward(x, dm, label, mask, w, g_hm, g_uvd, h: int, wd: int,
                         dlabel: bool = True):
    """The decoder's backward (K2, or autograd of the plain version for CPU tensors).

    ``x``, ``dm``: ``[B, J, H*W]``; ``label``, ``mask``: ``[B, 1, H*W]``;
    ``w``: ``[J]``, all f32; ``g_hm`` ``[B, J, H*W]`` and ``g_uvd``
    ``[B, J, 3]``: the cotangents of ``decode_flat``'s outputs. Returns
    ``(dx, ddm, dlabel, dw)`` with ``dw`` ``[J]`` summed over the batch;
    ``dlabel`` is None unless asked for (on the card, asking for it costs a
    second kernel that reads ``ddm`` back).
    """
    global BWD_LAUNCHES, BWD_KERNEL_LAUNCHES
    g_hm = g_hm.to(torch.float32).contiguous()
    g_uvd = g_uvd.to(torch.float32).contiguous()
    if cuda_lib.on_cpu("the decoder", [x, dm, label, mask, w, g_hm, g_uvd]):
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True) for t in (x, dm, label, w)]
            out = soft_argmax_decode_flat(leaves[0], leaves[1], leaves[2], mask, leaves[3],
                                          h, wd)
            dx, ddm, dl, dw = torch.autograd.grad(out, leaves, (g_hm, g_uvd))
            return dx, ddm, dl if dlabel else None, dw
    _check(x, dm, label, mask, w, h, wd, torch.float32)
    if x.dtype != torch.float32:
        raise TypeError(f"the backward kernel takes f32 maps, got {x.dtype}")
    b, j, hw = x.shape
    if g_hm.shape != x.shape or g_uvd.shape != (b, j, 3):
        raise ValueError(f"cotangents g_hm {tuple(g_hm.shape)} g_uvd {tuple(g_uvd.shape)}")
    dx, ddm = torch.empty_like(x), torch.empty_like(x)
    dl = torch.empty_like(label) if dlabel else None
    dw = torch.empty((b, j), dtype=torch.float32, device=x.device)
    rc = _fn("softargmax_bwd")(
        x.data_ptr(), dm.data_ptr(), label.data_ptr(), mask.data_ptr(), w.data_ptr(),
        g_hm.data_ptr(), g_uvd.data_ptr(), dx.data_ptr(), ddm.data_ptr(),
        dl.data_ptr() if dlabel else None, dw.data_ptr(), b, j, h, wd,
        torch.cuda.current_stream(x.device).cuda_stream)
    cuda_lib.check(rc, "softargmax_bwd")
    BWD_LAUNCHES += 1
    BWD_KERNEL_LAUNCHES += 2 if dlabel else 1
    # per-row dw [B, J] reduces over the batch outside the kernel, as in the JAX package
    return dx, ddm, dl, dw.sum(dim=0)


class _Decode(torch.autograd.Function):
    """K1 forward, K2 backward. The mask gets no gradient (it is 0/1 input
    data, as in the JAX package's custom VJP), and the label image gets one
    only when it requires grad (it does not on the training path). An
    output the loss does not use reaches the backward as materialized zeros."""

    @staticmethod
    def forward(ctx, x, dm, label, mask, w, h, wd):
        ctx.save_for_backward(x, dm, label, mask, w)
        ctx.hw = (h, wd)
        return softargmax_fwd(x, dm, label, mask, w, h, wd, torch.float32)

    @staticmethod
    def backward(ctx, g_hm, g_uvd):
        dx, ddm, dlabel, dw = decode_flat_backward(*ctx.saved_tensors, g_hm, g_uvd, *ctx.hw,
                                                   dlabel=ctx.needs_input_grad[2])
        return dx, ddm, dlabel, None, dw, None, None


def decode_flat(x, dm, label, mask, w, h: int, wd: int, hm_dtype=torch.float32):
    """Softmax decode of ``[B, J, H*W]`` rows: the model's entry.

    ``x``, ``dm``: ``[B, J, H*W]``; ``label``, ``mask``: ``[B, 1, H*W]``, all
    in one dtype (f32 or bf16); ``w``: ``[J]`` f32. Returns heatmaps
    ``[B, J, H*W]`` in ``hm_dtype`` and uvd ``[B, J, 3]`` f32, computed in f32.
    When an input requires grad (and grad mode is on) the call is
    differentiable through K2; it then takes f32 maps and returns f32 heatmaps.
    """
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dm, label, mask, w)):
        if x.dtype != torch.float32 or hm_dtype != torch.float32:
            raise TypeError(f"the differentiable decoder takes and returns f32 maps, got "
                            f"{x.dtype} -> {hm_dtype}")
        return _Decode.apply(x, dm, label, mask, w, h, wd)
    return softargmax_fwd(x, dm, label, mask, w, h, wd, hm_dtype)


def soft_argmax_decode_cuda(logits, depthmaps, label_img, mask, w,
                            method: str = "softmax", fast_boundary: bool = False):
    """Drop-in for ``ops.softargmax.soft_argmax_decode``, as
    ``soft_argmax_decode_pallas`` is in the JAX package.

    Maps NHWC ``[B, H, W, J]``, label/mask ``[B, H, W, 1]``, ``w`` ``[J]``;
    returns heatmaps ``[B, H, W, J]`` and uvd ``[B, J, 3]`` f32.
    ``fast_boundary=True`` keeps the maps in their own dtype (bf16 under
    mixed precision) and returns heatmaps in it (inference only); otherwise
    maps go in and come out as f32, and the call is differentiable. The
    ``sum`` method runs the plain version.
    """
    if method != "softmax":
        return soft_argmax_decode(logits, depthmaps, label_img, mask, w, method)
    b, h, wd, j = logits.shape
    map_dtype = logits.dtype if fast_boundary else torch.float32

    def flat(t):
        return _to_flat(t.to(map_dtype)).contiguous()

    hm, uvd = decode_flat(flat(logits), flat(depthmaps), flat(label_img), flat(mask),
                          w.to(torch.float32), h, wd, hm_dtype=map_dtype)
    return hm.transpose(1, 2).reshape(b, h, wd, j), uvd
