"""Pinhole camera transforms (mirrors ``pixelwiseregression_tpu/core/camera.py``).

``Camera`` works on host numpy arrays, keeping float64 exact where the host
builds crop integers, and on tensors on the device (the eval step's
metric); ``recover_uvd`` works on tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _stack(parts):
    """np.stack for host arrays, torch.stack for tensors."""
    if isinstance(parts[0], torch.Tensor):
        return torch.stack(parts, dim=-1)
    return np.stack(parts, axis=-1)


@dataclasses.dataclass(frozen=True)
class Camera:
    """Pinhole intrinsics: focal lengths and principal point."""

    fx: float
    fy: float
    halfu: float
    halfv: float

    def xyz2uvd(self, x):
        """World xyz -> image-space (u, v, depth). Last axis is 3."""
        u = x[..., 0] * self.fx / x[..., 2] + self.halfu
        v = x[..., 1] * self.fy / x[..., 2] + self.halfv
        return _stack([u, v, x[..., 2]])

    def uvd2xyz(self, x):
        """Image-space (u, v, depth) -> world xyz. Last axis is 3."""
        gx = (x[..., 0] - self.halfu) / self.fx * x[..., 2]
        gy = (x[..., 1] - self.halfv) / self.fy * x[..., 2]
        return _stack([gx, gy, x[..., 2]])


def recover_uvd(uvd: torch.Tensor, box_size: torch.Tensor, com: torch.Tensor,
                threshold: torch.Tensor) -> torch.Tensor:
    """De-normalize network uvd ``[..., J, 3]`` back to frame coordinates.

    ``uv`` scales by ``box_size - 1``, ``d`` by ``threshold`` (the crop cube
    half-size), then the integer-truncated COM ``[..., 3]`` is added back.
    """
    uv = uvd[..., :2] * (box_size - 1.0)[..., None, None]
    d = uvd[..., 2] * threshold[..., None]
    return torch.cat([uv, d[..., None]], dim=-1) + com[..., None, :]
