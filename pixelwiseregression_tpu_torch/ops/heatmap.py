"""COM filter of the soft-argmax decoder (mirrors ``com_filter`` of
``pixelwiseregression_tpu/ops/heatmap.py``). Heatmap label synthesis comes
with the training port."""

from __future__ import annotations

import torch


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
