"""Label synthesis ops: COM filter, heatmap splat, blurred heatmaps, depth
maps (mirrors ``pixelwiseregression_tpu/ops/heatmap.py``).

The JAX package vmaps its per-joint functions; here every function takes
leading batch dimensions (``[B, J]`` joints) directly.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pixelwiseregression_tpu_torch.ops.image import gaussian_blur


def com_filter(size_u: int, size_v: int, device: torch.device) -> torch.Tensor:
    """Normalized centered-coordinate filter, ``[2, size_v, size_u]`` f32.

    Channel 0 holds ``(j - size_u//2) / (size_u - 1)`` and channel 1
    ``(i - size_v//2) / (size_v - 1)``, computed in float64 and rounded to
    float32 (the JAX package computes it in numpy float64 and its consumers
    cast to float32). The CUDA decoder computes the same values in-kernel.
    """
    j = torch.arange(size_u, dtype=torch.float64, device=device)
    i = torch.arange(size_v, dtype=torch.float64, device=device)
    fu = ((j - size_u // 2) / (size_u - 1)).expand(size_v, size_u)
    fv = ((i - size_v // 2) / (size_v - 1))[:, None].expand(size_v, size_u)
    return torch.stack([fu, fv]).to(torch.float32)


def splat_heatmap(size: int, u: torch.Tensor, v: torch.Tensor):
    """2x2 sub-pixel splat of a unit of mass at continuous ``(u, v)``, for
    any leading shape ``S`` of ``u`` and ``v``.

    The reference's corner weights, with ``du, dv`` the fractional parts:
    ``d = (max(du + dv - 1, 0) + min(du, dv)) / 2``, ``b = du - d``,
    ``c = dv - d``, ``a = 1 + d - du - dv``, written to ``(lv, lu)``,
    ``(lv, lu+1)``, ``(lv+1, lu)``, ``(lv+1, lu+1)``. An index in
    ``[-size, -1]`` wraps around as numpy's negative indexing does (a floor
    modulo, ``torch.remainder``); only an index ``>= size`` (or below
    ``-size``) makes the joint invalid.

    Returns ``(heatmap S + [size, size], valid S bool)``; an invalid joint's
    heatmap is zero.
    """
    u = u.to(torch.float32)
    v = v.to(torch.float32)
    lu = torch.floor(u).to(torch.int64)
    lv = torch.floor(v).to(torch.int64)
    du = u - lu.to(torch.float32)
    dv = v - lv.to(torch.float32)

    min_d = torch.clamp_min(du + dv - 1.0, 0.0)
    max_d = torch.minimum(du, dv)
    d = (max_d + min_d) / 2.0
    b = du - d
    c = dv - d
    a = 1.0 + d - du - dv

    valid = (lu + 1 <= size - 1) & (lv + 1 <= size - 1) & (lu >= -size) & (lv >= -size)

    def wrap_onehot(idx):
        return F.one_hot(torch.remainder(idx, size), size).to(torch.float32)

    ou0, ou1 = wrap_onehot(lu), wrap_onehot(lu + 1)
    ov0, ov1 = wrap_onehot(lv), wrap_onehot(lv + 1)
    a, b, c, d = (t[..., None] for t in (a, b, c, d))
    hm = (ov0[..., :, None] * (a * ou0 + b * ou1)[..., None, :]
          + ov1[..., :, None] * (c * ou0 + d * ou1)[..., None, :])
    return hm * valid[..., None, None].to(torch.float32), valid


def synthesize_labels(uvd_kernel: torch.Tensor, depth_centered: torch.Tensor,
                      label_image: torch.Tensor, label_size: int, kernel_size: int,
                      sigma: float):
    """Per-joint blurred heatmaps and depth residual maps for a batch.

    Args:
      uvd_kernel: ``[B, J, 2]`` joint (u, v) in label-image pixels.
      depth_centered: ``[B, J]`` COM-centered joint depths.
      label_image: ``[B, S, S]`` COM-centered depth label images.

    Returns ``(heatmaps [B, J, S, S], dmaps [B, J, S, S], mask [B, S, S],
    valid [B, J])``: ``mask = label_image != 0`` and
    ``dmap_j = (d_j - label) * (hm_j > 0) * mask``.
    """
    hms, valid = splat_heatmap(label_size, uvd_kernel[..., 0], uvd_kernel[..., 1])
    hms = gaussian_blur(hms, kernel_size, sigma)
    mask = (label_image != 0).to(torch.float32)
    heatmask = (hms > 0).to(torch.float32) * mask[:, None]
    dmaps = (depth_centered[:, :, None, None] - label_image[:, None]) * heatmask
    return hms, dmaps, mask, valid
