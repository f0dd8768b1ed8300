"""cv2-semantics image ops on tensors (mirrors ``pixelwiseregression_tpu/ops/image.py``).

``cv2.resize`` INTER_LINEAR for float images: source coordinate
``s = (d + 0.5) * (src / dst) - 0.5``, evaluated in f32 in exactly that order
(a float64 or re-associated form moves taps at the edges), with cv2's
coefficient clamping: a floor index below 0 snaps to pixel 0, one at or
beyond ``src - 1`` snaps to pixel ``src - 1``.

``crop_resize`` folds the reference's zero-padded window crop and the resize
into one gather over the full frame. Each sample has its own crop size and
corner, so the JAX package's ``vmap`` becomes a batch dimension of per-sample
tap indices.

``warp_affine_inverse`` (cv2.warpAffine, INTER_LINEAR, BORDER_CONSTANT 0) is
the explicit 4-tap bilinear gather. The JAX package's default evaluates the
same taps as hat functions through a matmul, a form for the TPU's matrix
unit; the two agree to f32 rounding. With ``quantize=True`` the source
coordinates are cv2's legacy fixed-point ones. ``gaussian_blur`` is
cv2.GaussianBlur: a separable kernel computed in float64, BORDER_REFLECT_101
padding.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

# cv2's INTER_BITS: the legacy warp's fractional offsets are multiples of 1/32
_INTER_TAB_SIZE = 32
# cv2's AB_BITS: the legacy warp's per-axis terms are rounded to 1/1024
_AB_SCALE = 1024.0


def _resize_taps(out_size: int, src_size: torch.Tensor):
    """Tap indices and weights for one axis of a cv2 INTER_LINEAR resize.

    ``src_size`` is an integer tensor of any shape ``S`` (one source size per
    sample). Returns ``(i0, i1, w1)`` of shape ``S + (out_size,)``: the sample
    is ``v[i0] * (1 - w1) + v[i1] * w1`` with indices clamped to
    ``[0, src_size - 1]`` by cv2's rule.
    """
    src = src_size.to(torch.float32)[..., None]
    d = torch.arange(out_size, dtype=torch.float32, device=src_size.device)
    s = (d + 0.5) * (src / out_size) - 0.5
    i0f = torch.floor(s)
    w1 = s - i0f
    i0 = i0f.to(torch.int64)
    src_i = src_size.to(torch.int64)[..., None]
    w1 = torch.where(i0 < 0, 0.0, w1)
    i0 = torch.clamp_min(i0, 0)
    w1 = torch.where(i0 >= src_i - 1, 1.0, w1)
    i0 = torch.minimum(i0, torch.clamp_min(src_i - 2, 0))
    i1 = torch.minimum(i0 + 1, src_i - 1)
    return i0, i1, w1


def resize_bilinear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """cv2.resize(img, (out_w, out_h)) with INTER_LINEAR over the last two axes."""
    h, w = img.shape[-2:]
    # sizes filled on the device: torch.tensor would copy them from pageable
    # host memory and wait on the stream
    r0, r1, wr = _resize_taps(out_h, torch.full((), h, dtype=torch.int64, device=img.device))
    c0, c1, wc = _resize_taps(out_w, torch.full((), w, dtype=torch.int64, device=img.device))
    rows = img[..., r0, :] * (1.0 - wr)[:, None] + img[..., r1, :] * wr[:, None]
    return rows[..., c0] * (1.0 - wc) + rows[..., c1] * wc


def crop_resize(
    frame: torch.Tensor,
    top: torch.Tensor,
    left: torch.Tensor,
    crop_size: torch.Tensor,
    out_size: int,
) -> torch.Tensor:
    """Zero-padded window crop + cv2 INTER_LINEAR resize as one gather.

    Args:
      frame: ``[B, H, W]`` float frames.
      top, left: ``[B]`` integer crop corners in frame coordinates (may be
        negative or past the frame; those pixels read 0).
      crop_size: ``[B]`` integer side length of each square crop.
      out_size: output side length.

    Returns ``[B, out_size, out_size]``.
    """
    b, h, w = frame.shape
    r0, r1, wr = _resize_taps(out_size, crop_size)  # [B, out]
    c0, c1, wc = _resize_taps(out_size, crop_size)
    top = top.to(torch.int64)[:, None]
    left = left.to(torch.int64)[:, None]

    def gather_rows(i):
        fi = top + i
        ok = (fi >= 0) & (fi < h)
        fi = fi.clamp(0, h - 1)
        vals = torch.gather(frame, 1, fi[:, :, None].expand(b, out_size, w))
        return vals * ok[:, :, None].to(frame.dtype)

    rows = gather_rows(r0) * (1.0 - wr)[:, :, None] + gather_rows(r1) * wr[:, :, None]

    def gather_cols(j):
        fj = left + j
        ok = (fj >= 0) & (fj < w)
        fj = fj.clamp(0, w - 1)
        vals = torch.gather(rows, 2, fj[:, None, :].expand(b, out_size, out_size))
        return vals * ok[:, None, :].to(frame.dtype)

    return gather_cols(c0) * (1.0 - wc)[:, None, :] + gather_cols(c1) * wc[:, None, :]


def rotation_matrix_inverse(angle_deg: torch.Tensor, scale: torch.Tensor, center_x: float,
                            center_y: float) -> torch.Tensor:
    """Inverse of cv2.getRotationMatrix2D(center, angle, scale) as ``[..., 6]``
    (``[m00, m01, m02, m10, m11, m12]``, the dst -> src map): a rotation by
    ``-angle`` scaled by ``1 / scale`` about the same center."""
    t = angle_deg * (math.pi / 180.0)
    a = torch.cos(t) / scale
    b = torch.sin(t) / scale
    m00, m01 = a, -b
    m10, m11 = b, a
    m02 = center_x - (m00 * center_x + m01 * center_y)
    m12 = center_y - (m10 * center_x + m11 * center_y)
    return torch.stack([m00, m01, m02, m10, m11, m12], dim=-1)


def warp_affine_inverse(img: torch.Tensor, minv: torch.Tensor,
                        quantize: bool = False) -> torch.Tensor:
    """cv2.warpAffine of ``[B, H, W]`` images with per-sample dst -> src
    matrices ``minv`` ``[B, 6]``. INTER_LINEAR, BORDER_CONSTANT 0, with
    unquantized float source coordinates (modern cv2 for float images).

    ``quantize=True`` takes cv2's legacy fixed-point coordinates instead:
    each column's and each row's term rounded to 1/1024, plus cv2's rounding
    delta of 16/1024, floored to the 1/32 grid. Each product and sum is its
    own op, in the JAX package's f32 order, so that a term on a rounding
    boundary rounds alike on the CPU and the card (no fused multiply-add).
    """
    b, h, w = img.shape
    gy = torch.arange(h, dtype=img.dtype, device=img.device)[:, None]
    gx = torch.arange(w, dtype=img.dtype, device=img.device)[None, :]
    m = [minv[:, i, None, None] for i in range(6)]  # [B, 1, 1] each
    if quantize:
        shift = _AB_SCALE / _INTER_TAB_SIZE  # 32
        delta = shift / 2
        ax = torch.round(m[0] * gx * _AB_SCALE)  # [B, 1, W]
        ay = torch.round(m[3] * gx * _AB_SCALE)
        bx = torch.round((m[1] * gy + m[2]) * _AB_SCALE) + delta  # [B, H, 1]
        by = torch.round((m[4] * gy + m[5]) * _AB_SCALE) + delta
        xq = torch.floor((bx + ax) / shift)  # units of 1/32
        yq = torch.floor((by + ay) / shift)
        ix = torch.floor(xq / _INTER_TAB_SIZE).to(torch.int64)
        iy = torch.floor(yq / _INTER_TAB_SIZE).to(torch.int64)
        fx = (xq - ix.to(img.dtype) * _INTER_TAB_SIZE) / _INTER_TAB_SIZE
        fy = (yq - iy.to(img.dtype) * _INTER_TAB_SIZE) / _INTER_TAB_SIZE
    else:
        sx = m[0] * gx + m[1] * gy + m[2]
        sy = m[3] * gx + m[4] * gy + m[5]
        ix = torch.floor(sx).to(torch.int64)
        iy = torch.floor(sy).to(torch.int64)
        fx = sx - ix.to(img.dtype)
        fy = sy - iy.to(img.dtype)

    flat = img.reshape(b, h * w)

    def tap(yi, xi):
        ok = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        return torch.gather(flat, 1, idx.reshape(b, -1)).reshape(b, h, w) * ok.to(img.dtype)

    top = tap(iy, ix) * (1.0 - fx) + tap(iy, ix + 1) * fx
    bot = tap(iy + 1, ix) * (1.0 - fx) + tap(iy + 1, ix + 1) * fx
    return top * (1.0 - fy) + bot * fy


def gaussian_kernel_1d(ksize: int, sigma: float) -> np.ndarray:
    """cv2.getGaussianKernel(ksize, sigma) in float64."""
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return k / k.sum()


def gaussian_blur(img: torch.Tensor, ksize: int, sigma: float) -> torch.Tensor:
    """cv2.GaussianBlur(img, (ksize, ksize), sigma) over the last two axes,
    with BORDER_REFLECT_101 (``F.pad``'s ``reflect``): two 1-D passes."""
    k = torch.as_tensor(gaussian_kernel_1d(ksize, sigma), dtype=img.dtype, device=img.device)
    pad = ksize // 2
    h, w = img.shape[-2:]
    x = F.pad(img.reshape(-1, h, w), (0, 0, pad, pad), mode="reflect")
    x = sum(k[t] * x[:, t:t + h, :] for t in range(ksize))
    x = F.pad(x, (pad, pad, 0, 0), mode="reflect")
    x = sum(k[t] * x[:, :, t:t + w] for t in range(ksize))
    return x.reshape(img.shape)
