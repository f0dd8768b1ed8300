"""Differentiable soft-argmax decoder in plain PyTorch
(mirrors ``pixelwiseregression_tpu/ops/softargmax.py``).

Decodes per-joint heatmap logits + depth residual maps into (u, v, d):

* plane: normalize the heatmap (learned-temperature softmax over H*W, or
  relu-sum), then reduce against the fixed centered-coordinate filters;
* depth: masked expectation of ``depthmap + label_img`` under the masked
  heatmap.

All reductions run in float32 whatever the input dtype, with eps 1e-14.
This is the ground truth the CUDA kernel (``ops/cuda_softargmax.py``) is
held against.

Two entry points: ``soft_argmax_decode`` keeps the JAX signature (NHWC maps,
so tests compare like with like); ``soft_argmax_decode_flat`` takes the
``[B, J, H*W]`` rows the NCHW model produces without a transpose.
"""

from __future__ import annotations

import torch

from pixelwiseregression_tpu_torch.ops.heatmap import com_filter

_EPS = 1e-14


def _normalize_flat(x: torch.Tensor, w: torch.Tensor | None, method: str) -> torch.Tensor:
    x = x.to(torch.float32)
    if method == "softmax":
        return torch.softmax(x * w.to(torch.float32)[None, :, None], dim=2)
    if method == "sum":
        z = torch.relu(x) + _EPS
        return z / torch.sum(z, dim=2, keepdim=True)
    raise ValueError(f"unknown normalization method: {method}")


def _to_flat(t: torch.Tensor) -> torch.Tensor:
    b, h, w, c = t.shape
    return t.reshape(b, h * w, c).transpose(1, 2)


def normalize_heatmaps(logits: torch.Tensor, w: torch.Tensor | None,
                       method: str = "softmax") -> torch.Tensor:
    """Heatmap normalization over H*W of NHWC ``[B, H, W, J]`` logits;
    ``w`` ``[J]`` is the softmax temperature (softmax method only)."""
    b, h, wd, j = logits.shape
    return _normalize_flat(_to_flat(logits), w, method).transpose(1, 2).reshape(b, h, wd, j)


def soft_argmax_decode_flat(x, dm, label, mask, w, h: int, wd: int, method: str = "softmax"):
    """Decode ``[B, J, H*W]`` rows.

    Args:
      x, dm: ``[B, J, H*W]`` heatmap logits and depth residual maps.
      label, mask: ``[B, 1, H*W]`` label image and hand mask.
      w: ``[J]`` softmax temperature (None for ``method='sum'``).
      h, wd: the map's height and width.

    Returns heatmaps ``[B, J, H*W]`` f32 and uvd ``[B, J, 3]`` f32.
    """
    hm = _normalize_flat(x, w, method)
    fu, fv = com_filter(wd, h, x.device).reshape(2, 1, 1, h * wd)
    u = torch.sum(fu * hm, dim=2)
    v = torch.sum(fv * hm, dim=2)
    m = mask.to(torch.float32)
    recon = (dm.to(torch.float32) + label.to(torch.float32)) * m
    mh = hm * m
    d = torch.sum(mh * recon, dim=2) / (torch.sum(mh, dim=2) + _EPS)
    return hm, torch.stack([u, v, d], dim=-1)


def soft_argmax_decode(logits, depthmaps, label_img, mask, w, method: str = "softmax"):
    """Full decode with the JAX signature.

    Args:
      logits, depthmaps: ``[B, H, W, J]``.
      label_img, mask: ``[B, H, W, 1]``.
      w: ``[J]`` softmax temperature (or None for ``method='sum'``).

    Returns heatmaps ``[B, H, W, J]`` (normalized, f32) and uvd ``[B, J, 3]``.
    """
    b, h, wd, j = logits.shape
    hm, uvd = soft_argmax_decode_flat(
        _to_flat(logits), _to_flat(depthmaps), _to_flat(label_img), _to_flat(mask),
        w, h, wd, method)
    return hm.transpose(1, 2).reshape(b, h, wd, j), uvd
