"""Fused conv + instance-norm units as a hand-written CUDA kernel for Hopper
(counterpart of ``pixelwiseregression_tpu/ops/pallas_fused.py``; K3).

A unit is ``[relu(norm(x))] -> conv 1x1 or 3x3 (+ bias) -> [relu(norm(y))]``
on NHWC activations (f32 or bf16) with HWIO weights, as the JAX functions
take them; a chain of units ends with an optional ``+ skip`` (the ResBlock
residual). Instance norm with the exact two-pass statistics (biased
variance, eps inside the rsqrt) in f32; forward only.

``csrc/fused_chain.cu`` holds the kernels (built by ``ops/cuda_lib.py``);
its header says how the TPU design, a whole sample resident in VMEM, became
statistics on one thread-block cluster a sample (``csrc/cluster_norm.cuh``;
``norm_plan`` says how a shape runs) and an implicit-GEMM conv on Hopper.

* CPU tensors go to ``fused_chain_plain``, the plain PyTorch version;
* CUDA tensors launch the kernels, one ``fused_unit`` call per unit, or
  raise; there is no fallback.

``LAUNCHES`` counts ``fused_chain`` calls that launched the kernels.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from pixelwiseregression_tpu_torch.ops import cuda_lib

LAUNCHES = 0

_DTYPES = (torch.float32, torch.bfloat16)
_P, _I = ctypes.c_void_p, ctypes.c_int
# (bf16, x, w, bias, pro_scale, pro_bias, epi_scale, epi_bias, skip, y, tmp, coef_a,
#  coef_b, B, H, W, C, Co, k, eps, stream)
_UNIT_ARGTYPES = [_I] + [_P] * 12 + [_I] * 6 + [ctypes.c_float, _P]
# (bf16, apply, B, HW, C, out[4])
_PLAN_ARGTYPES = [_I] * 5 + [_P]


def norm_launches() -> tuple[int, int]:
    """Kernels that K3's and K5's launchers have launched on the card in
    this process, K4's calls of them included: (the norm kernels, the rest:
    convs and K5's parameter sums)."""
    fn = cuda_lib.function("norm_launches", [_I], ctypes.c_longlong)
    return int(fn(0)), int(fn(1))


def norm_plan(dtype, bsz: int, hw: int, c: int, apply: bool = True) -> dict:
    """How K3's norm kernel runs ``[bsz, hw, c]`` of ``dtype`` on the card:
    the statistics alone (``apply`` False: a prologue, K4) or with the apply
    (an epilogue, ``norm_stats_apply``). Cluster size (blocks a sample),
    ``path`` resident or streamed, ring slots, shared memory a block."""
    fn = cuda_lib.function("norm_plan", _PLAN_ARGTYPES)
    return cuda_lib.cluster_plan(fn, "norm_plan", int(dtype == torch.bfloat16), int(apply), bsz,
                                 hw, c)


def _norm_affine_relu(y32, scale, bias, eps):
    """relu(instance_norm(y32)) of an f32 NHWC tensor: two-pass statistics
    over H and W, then ``y32*a + b`` as two f32 roundings
    (``pallas_fused.py::_norm_affine``)."""
    mean = y32.mean(dim=(1, 2), keepdim=True)
    var = torch.square(y32 - mean).mean(dim=(1, 2), keepdim=True)
    a = torch.rsqrt(var + eps) * scale
    b = bias - mean * a
    return torch.clamp_min(y32 * a + b, 0.0)


def _conv_f32(h, kernel_hwio, act_dtype):
    """Stride-1, zero-padded conv of act-dtype-rounded operands in f32 (NHWC in and out)."""
    w = kernel_hwio.to(act_dtype).float().permute(3, 2, 0, 1)
    y = F.conv2d(h.float().permute(0, 3, 1, 2), w, padding=kernel_hwio.shape[0] // 2)
    return y.permute(0, 2, 3, 1)


def fused_chain_plain(x, units, *, skip=None, eps: float = 1e-5):
    """The plain PyTorch version of ``fused_chain``, with the kernel's
    rounding points: each conv in f32 on act-dtype operands (TF32 must be
    off on a card: the engine builders turn it off), + bias in f32, then
    the cast; an epilogue takes its statistics on the cast conv output;
    the skip is added in the act dtype."""
    act = x.dtype
    h = x
    for u in units:
        if u.get("pro") is not None:
            ps, pb = u["pro"]
            h = _norm_affine_relu(h.float(), ps.float(), pb.float(), eps).to(act)
        y = (_conv_f32(h, u["kernel"], act) + u["bias"].float()).to(act)
        if u.get("epi") is not None:
            es, eb = u["epi"]
            y = _norm_affine_relu(y.float(), es.float(), eb.float(), eps).to(act)
        h = y
    if skip is not None:
        h = h + skip
    return h


def _check_act(t, name, dtype):
    if t.dtype != dtype:
        raise TypeError(f"{name} is {t.dtype}, x is {dtype}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be a contiguous, 16-byte aligned NHWC tensor")


def _unit_tensors(units):
    out = []
    for u in units:
        out += [u["kernel"], u["bias"]]
        for key in ("pro", "epi"):
            if u.get(key) is not None:
                out += list(u[key])
    return out


def fused_chain(x, units, *, skip=None, eps: float = 1e-5):
    """Run a chain of ``[pro-norm] -> conv -> [epi-norm]`` units on ``x``
    ``[B, H, W, C]`` (f32 or bf16).

    ``units``: each a dict with ``kernel`` (HWIO ``[k, k, C, Co]``, k in
    {1, 3}), ``bias`` ``[Co]`` and optional ``pro`` / ``epi`` = (scale,
    bias) enabling the prologue / epilogue instance norm. ``skip``
    ``[B, H, W, Co]`` is added to the final unit's output. Conv weights are
    cast to x's dtype; biases and norm parameters are f32. On a card, C and
    every Co must be multiples of 8.
    """
    global LAUNCHES
    tensors = [x, *_unit_tensors(units)] + ([skip] if skip is not None else [])
    if cuda_lib.on_cpu("fused_chain", tensors):
        return fused_chain_plain(x, units, skip=skip, eps=eps)
    if x.dtype not in _DTYPES:
        raise TypeError(f"fused_chain takes f32 or bf16 activations, got {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"x must be NHWC [B, H, W, C], got {tuple(x.shape)}")
    _check_act(x, "x", x.dtype)
    bsz, h, wd, cin = x.shape
    bf16 = int(x.dtype == torch.bfloat16)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    fn = cuda_lib.function("fused_unit", _UNIT_ARGTYPES)

    def f32(t):
        return t.to(torch.float32).contiguous()

    def ptr(t):
        return None if t is None else t.data_ptr()

    for i, u in enumerate(units):
        kern = u["kernel"]
        if kern.dim() != 4 or kern.shape[0] not in (1, 3) or kern.shape[1] != kern.shape[0] \
                or kern.shape[2] != cin:
            raise ValueError(f"unit {i}: kernel {tuple(kern.shape)} is not [k, k, {cin}, Co], k 1 or 3")
        k, co = kern.shape[0], kern.shape[-1]
        if cin % 8 or co % 8:
            raise ValueError(f"unit {i}: the kernel takes channel counts that are multiples of 8, "
                             f"got {cin} -> {co}")
        w = kern.to(x.dtype).contiguous()
        if w.data_ptr() % 16:  # a view into a larger tensor; the kernel loads 16 bytes at a time
            w = w.clone()
        bias = f32(u["bias"])
        pro = [f32(t) for t in u["pro"]] if u.get("pro") is not None else [None, None]
        epi = [f32(t) for t in u["epi"]] if u.get("epi") is not None else [None, None]
        if bias.shape != (co,) or any(t is not None and t.shape != (cin,) for t in pro) \
                or any(t is not None and t.shape != (co,) for t in epi):
            raise ValueError(f"unit {i}: bias or norm parameters do not match {cin} -> {co}")
        last = i == len(units) - 1
        if last and skip is not None:
            if skip.shape != (bsz, h, wd, co):
                raise ValueError(f"skip {tuple(skip.shape)} does not match the output")
            _check_act(skip, "skip", x.dtype)
        y = torch.empty((bsz, h, wd, co), dtype=x.dtype, device=x.device)
        tmp = torch.empty_like(y) if epi[0] is not None else None
        coef = torch.empty((2, bsz * max(cin, co)), dtype=torch.float32, device=x.device)
        rc = fn(bf16, x.data_ptr(), w.data_ptr(), bias.data_ptr(), ptr(pro[0]), ptr(pro[1]),
                ptr(epi[0]), ptr(epi[1]), ptr(skip if last else None), y.data_ptr(), ptr(tmp),
                coef[0].data_ptr(), coef[1].data_ptr(), bsz, h, wd, cin, co, k, eps, stream)
        cuda_lib.check(rc, "fused_unit")
        x, cin = y, co
    LAUNCHES += 1
    return x


def fused_conv_norm(x, kernel_hwio, conv_bias, *, pro_scale=None, pro_bias=None,
                    epi_scale=None, epi_bias=None, skip=None, eps: float = 1e-5):
    """One ``[instance-norm+relu] -> conv -> [instance-norm+relu | +skip]``
    unit on NHWC: a one-unit ``fused_chain``."""
    unit = {"kernel": kernel_hwio, "bias": conv_bias}
    if pro_scale is not None:
        unit["pro"] = (pro_scale, pro_bias)
    if epi_scale is not None:
        unit["epi"] = (epi_scale, epi_bias)
    return fused_chain(x, [unit], skip=skip, eps=eps)
