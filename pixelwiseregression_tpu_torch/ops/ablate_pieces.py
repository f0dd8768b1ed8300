"""The pieces of the fused conv + instance-norm unit that the ablation tools
time apart (K6), as hand-written CUDA kernels for Hopper, with the plain
versions of the ``ops/pallas_fused.py`` helpers they are built from
(``pack_wcat``, ``_norm_affine``, ``_build_xm``).

The TPU unit runs a 3x3 conv as three products on a tap operand ``xm``,
``[(H+2)W, 3C]`` per sample: column block dj holds ``x[p + dj - 1]`` (zero
where the tap crosses an image row), with W zero rows above and below, so
``y[p] = sum_di xm[di*W + p] @ wcat[di]``. The pieces, each with its plain
version beside it:

* ``copy``: a pass over the activations and nothing else;
* ``build_xm``: ``xm`` materialised, or one of the probes that read a few of
  its blocks (``XM_MODES``);
* ``xm_dots``: the three products on a prebuilt operand, bf16 in and out
  with f32 accumulation;
* ``norm_stats_apply``: the norm's statistics and apply alone, on K3's own
  kernel (``csrc/fused_chain.cu``, one thread-block cluster a sample).

Activations are ``[B, H*W, C]`` (the TPU kernels' ``[HW, C]`` per sample).
CPU tensors go to the plain versions; CUDA tensors launch
``csrc/ablate_pieces.cu`` (or K3's statistics) or raise; there is no
fallback. ``*_LAUNCHES`` count the calls that launched each piece.
"""

from __future__ import annotations

import ctypes

import torch

from pixelwiseregression_tpu_torch.ops import cuda_lib

COPY_LAUNCHES = 0
BUILD_LAUNCHES = 0
DOTS_LAUNCHES = 0
STATS_LAUNCHES = 0

_DTYPES = (torch.float32, torch.bfloat16)
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    # (src, dst, nbytes, stream)
    "ablate_copy": [_P, _P, ctypes.c_longlong, _P],
    # (bf16, x, out, B, H, W, C, R, nblk, sum, ro0, ro1, ro2, cb0, cb1, cb2, stream)
    "ablate_build_xm": [_I, _P, _P] + [_I] * 13 + [_P],
    # (xm, w, y, B, R, HW, K, Co, off0, off1, off2, stream)
    "ablate_xm_dots": [_P] * 3 + [_I] * 8 + [_P],
    # (bf16, x, scale, bias, y, coef_a, coef_b, B, HW, C, eps, stream)
    "norm_stats_apply": [_I] + [_P] * 6 + [_I] * 3 + [ctypes.c_float, _P],
}

# how each build_xm mode reads xm: (rows of the output, its blocks as
# (row offset, xm column block), whether the two blocks are summed)
#   xm         the operand itself, [(H+2)W, 3C]
#   probe_sum  xm[W + p, C:2C] + xm[p, 0:C]      (tools/ablate_fused_unit.py:124)
#   probe_cat  concat(xm[W + p, C:2C], xm[p, 0:C]) (tools/ablate_fused2.py:180)
#   repeat     concat(x[p], x[p], x[p])             (tools/ablate_fused2.py:166)
XM_MODES = ("xm", "probe_sum", "probe_cat", "repeat")


def _layout(mode, h, w):
    if mode == "xm":
        return (h + 2) * w, [(0, 0), (0, 1), (0, 2)], False
    if mode == "probe_sum":
        return h * w, [(w, 1), (0, 0)], True
    if mode == "probe_cat":
        return h * w, [(w, 1), (0, 0)], False
    if mode == "repeat":
        return h * w, [(w, 1)] * 3, False
    raise ValueError(f"unknown build_xm mode {mode!r}; one of {XM_MODES}")


# --------------------------------------------------------------------------- #
# plain versions
# --------------------------------------------------------------------------- #


def pack_wcat(kernel_hwio):
    """HWIO ``[3, 3, C, Co]`` -> ``[3, 3C, Co]``: ``wcat[di, dj*C:(dj+1)*C]
    = W[di, dj]``, so that xm's column block dj meets tap (di, dj)."""
    if kernel_hwio.shape[:2] != (3, 3):
        raise ValueError(f"pack_wcat takes a 3x3 HWIO kernel, got {tuple(kernel_hwio.shape)}")
    return kernel_hwio.reshape(3, 3 * kernel_hwio.shape[2], kernel_hwio.shape[3])


def unpack_wcat(wcat):
    """``[3, 3C, Co]`` -> the HWIO ``[3, 3, C, Co]`` kernel (``pack_wcat``'s inverse)."""
    return wcat.reshape(3, 3, wcat.shape[1] // 3, wcat.shape[2])


def norm_affine(y32, scale, bias, eps: float = 1e-5):
    """Two-pass instance norm + affine + relu of f32 ``[..., N, C]`` over its
    N rows (biased variance, eps inside the rsqrt): ``_norm_affine``."""
    mean = y32.mean(dim=-2, keepdim=True)
    var = torch.square(y32 - mean).mean(dim=-2, keepdim=True)
    a = torch.rsqrt(var + eps) * scale
    b = bias - mean * a
    return torch.clamp_min(y32 * a + b, 0.0)


def _xm(x, h, w):
    """The padded dj-concat ``[B, (H+2)W, 3C]`` of ``x`` ``[B, HW, C]`` in x's dtype."""
    col = (torch.arange(h * w, device=x.device) % w)[None, :, None]
    left = torch.where(col == 0, 0.0, torch.roll(x, 1, dims=1)).to(x.dtype)
    right = torch.where(col == w - 1, 0.0, torch.roll(x, -1, dims=1)).to(x.dtype)
    pad = x.new_zeros(x.shape[0], w, 3 * x.shape[2])
    return torch.cat([pad, torch.cat([left, x, right], dim=2), pad], dim=1)


def build_xm_plain(x, h: int, w: int, mode: str = "xm"):
    """``build_xm``'s plain version: ``_build_xm`` per sample for ``xm``, or
    the probe of ``mode`` read from it."""
    rows, blocks, summed = _layout(mode, h, w)
    c = x.shape[2]
    xm = _xm(x, h, w)
    parts = [xm[:, ro:ro + rows, cb * c:(cb + 1) * c] for ro, cb in blocks]
    return parts[0] + parts[1] if summed else torch.cat(parts, dim=2)


def xm_dots_plain(xm, wcat, hw: int, offsets):
    """``sum_di xm[:, off_di : off_di + hw] @ wcat[di]`` in f32, cast to xm's
    dtype (a card's f32 matmul must not run in TF32)."""
    acc = sum(xm[:, o:o + hw].float() @ wcat[di].float() for di, o in enumerate(offsets))
    return acc.to(xm.dtype)


def norm_stats_apply_plain(x, scale, bias, eps: float = 1e-5):
    """``relu(norm(x))`` from x's own statistics, cast to x's dtype: the
    stats-only probe."""
    return norm_affine(x.float(), scale.float(), bias.float(), eps).to(x.dtype)


# --------------------------------------------------------------------------- #
# the kernels
# --------------------------------------------------------------------------- #


def _check(name, t, dtypes=_DTYPES):
    if t.dtype not in dtypes:
        raise TypeError(f"{name} takes {', '.join(map(str, dtypes))}, got {t.dtype}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} needs contiguous, 16-byte aligned tensors")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def copy(x):
    """A copy of ``x`` through the card: one read, one write."""
    global COPY_LAUNCHES
    if cuda_lib.on_cpu("copy", [x]):
        return x.clone()
    _check("copy", x, (x.dtype,))
    out = torch.empty_like(x)
    nbytes = x.numel() * x.element_size()
    if nbytes % 16:
        raise ValueError(f"copy moves a multiple of 16 bytes, got {nbytes}")
    cuda_lib.check(cuda_lib.function("ablate_copy", _ARGTYPES["ablate_copy"])(
        x.data_ptr(), out.data_ptr(), nbytes, _stream(x)), "ablate_copy")
    COPY_LAUNCHES += 1
    return out


def build_xm(x, h: int, w: int, mode: str = "xm"):
    """The tap operand of ``x`` ``[B, h*w, C]`` (f32 or bf16), or one of
    its probes (``XM_MODES``), in x's dtype; exact data movement (the
    ``probe_sum`` add rounds once, in f32)."""
    global BUILD_LAUNCHES
    rows, blocks, summed = _layout(mode, h, w)
    if x.dim() != 3 or x.shape[1] != h * w:
        raise ValueError(f"x must be [B, {h}*{w}, C], got {tuple(x.shape)}")
    if cuda_lib.on_cpu("build_xm", [x]):
        return build_xm_plain(x, h, w, mode)
    _check("build_xm", x)
    bsz, _, c = x.shape
    if c % 8:
        raise ValueError(f"the kernel takes a multiple of 8 channels, got {c}")
    nblk = 1 if summed else len(blocks)
    out = torch.empty((bsz, rows, nblk * c), dtype=x.dtype, device=x.device)
    ro = [b[0] for b in blocks] + [0] * (3 - len(blocks))
    cb = [b[1] for b in blocks] + [0] * (3 - len(blocks))
    rc = cuda_lib.function("ablate_build_xm", _ARGTYPES["ablate_build_xm"])(
        int(x.dtype == torch.bfloat16), x.data_ptr(), out.data_ptr(), bsz, h, w, c, rows, nblk,
        int(summed), *ro, *cb, _stream(x))
    cuda_lib.check(rc, "ablate_build_xm")
    BUILD_LAUNCHES += 1
    return out


def xm_dots(xm, wcat, hw: int, offsets):
    """``y[b, p] = sum_di xm[b, p + offsets[di]] @ wcat[di]`` for ``p < hw``:
    ``xm`` ``[B, R, K]``, ``wcat`` ``[3, K, Co]``; on a card both bf16 (the
    result too, from f32 accumulators), K and Co multiples of 8."""
    global DOTS_LAUNCHES
    offsets = tuple(int(o) for o in offsets)
    if xm.dim() != 3 or wcat.dim() != 3 or wcat.shape[:2] != (3, xm.shape[2]) or len(offsets) != 3:
        raise ValueError(f"xm [B, R, K] {tuple(xm.shape)} and wcat [3, K, Co] "
                         f"{tuple(wcat.shape)} with three offsets, got {offsets}")
    if min(offsets) < 0 or max(offsets) + hw > xm.shape[1]:
        raise ValueError(f"rows {offsets} + {hw} run past the operand's {xm.shape[1]}")
    if cuda_lib.on_cpu("xm_dots", [xm, wcat]):
        return xm_dots_plain(xm, wcat, hw, offsets)
    bf16 = (torch.bfloat16,)
    _check("xm_dots", xm, bf16)
    _check("xm_dots", wcat, bf16)
    bsz, rows, k = xm.shape
    co = wcat.shape[2]
    if k % 8 or co % 8:
        raise ValueError(f"the kernel takes K and Co in multiples of 8, got {k}, {co}")
    y = torch.empty((bsz, hw, co), dtype=xm.dtype, device=xm.device)
    rc = cuda_lib.function("ablate_xm_dots", _ARGTYPES["ablate_xm_dots"])(
        xm.data_ptr(), wcat.data_ptr(), y.data_ptr(), bsz, rows, hw, k, co, *offsets, _stream(xm))
    cuda_lib.check(rc, "ablate_xm_dots")
    DOTS_LAUNCHES += 1
    return y


def norm_stats_apply(x, scale, bias, eps: float = 1e-5):
    """``relu(norm(x))`` of ``x`` ``[B, N, C]`` (f32 or bf16) from its own
    statistics, in x's dtype, on K3's statistics-and-apply kernel."""
    global STATS_LAUNCHES
    if x.dim() != 3 or scale.shape != (x.shape[2],) or bias.shape != (x.shape[2],):
        raise ValueError(f"x [B, N, C] {tuple(x.shape)}, scale and bias [C]")
    if cuda_lib.on_cpu("norm_stats_apply", [x, scale, bias]):
        return norm_stats_apply_plain(x, scale, bias, eps)
    _check("norm_stats_apply", x)
    bsz, n, c = x.shape
    if c % 8:
        raise ValueError(f"the kernels take a multiple of 8 channels, got {c}")
    params = [t.to(torch.float32).contiguous() for t in (scale, bias)]
    y = torch.empty_like(x)
    coef = torch.empty((2, bsz * c), dtype=torch.float32, device=x.device)
    rc = cuda_lib.function("norm_stats_apply", _ARGTYPES["norm_stats_apply"])(
        int(x.dtype == torch.bfloat16), x.data_ptr(), params[0].data_ptr(), params[1].data_ptr(),
        y.data_ptr(), coef[0].data_ptr(), coef[1].data_ptr(), bsz, n, c, eps, _stream(x))
    cuda_lib.check(rc, "norm_stats_apply")
    STATS_LAUNCHES += 1
    return y
