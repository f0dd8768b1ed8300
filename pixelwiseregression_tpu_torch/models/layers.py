"""Shared building blocks (mirrors ``pixelwiseregression_tpu/models/layers.py``).

NCHW throughout. Params are f32; a module runs in the dtype of its input
(the activation dtype), with the casts where the JAX package puts them: a
conv casts its weight and bias to the activation dtype, a norm takes its
statistics in f32 and casts y back.

The int8 conv, the anchored norm's EMA update and the norms' hand-written
backward come with later parts of the port.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


class Conv(nn.Conv2d):
    """2-D conv with torch-style explicit ``k//2`` padding, xavier-normal
    weights and torch-uniform bias. Its weight and bias are cast to the
    input's dtype."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=kernel_size // 2)

    def reset_parameters(self):
        nn.init.xavier_normal_(self.weight)
        fan_in = self.in_channels * self.kernel_size[0] * self.kernel_size[1]
        bound = 1.0 / math.sqrt(fan_in)
        nn.init.uniform_(self.bias, -bound, bound)

    def forward(self, x):
        return F.conv2d(x, self.weight.to(x.dtype), self.bias.to(x.dtype),
                        self.stride, self.padding)


class InstanceNorm(nn.Module):
    """torch ``InstanceNorm2d(affine=True)``: per-sample, per-channel over
    H, W; eps 1e-5, biased variance, statistics in f32.

    ``method``:

    * ``instance``: two-pass variance ``E[(x - mean)^2]``;
    * ``instance_fast``: one-pass ``E[x^2] - E[x]^2`` (cancels on
      near-constant channels);
    * ``instance_anchored``: one-pass around a calibrated per-channel anchor
      ``c``, ``var = E[(x-c)^2] - (E[x]-c)^2``, with the debiased anchor
      ``anchor / (1 - 0.9**anchor_n)`` (0 while ``anchor_n`` is 0).

    The anchored norm's buffers ``anchor [C]`` and ``anchor_n []`` may be
    absent: a state dict without them (a reference ``.pt`` file) leaves them
    ``None``, and the norm then runs the exact two-pass form, as the JAX
    package does for a checkpoint without ``batch_stats``.
    """

    eps = 1e-5
    anchor_momentum = 0.9

    def __init__(self, channels: int, method: str = "instance"):
        super().__init__()
        if method not in ("instance", "instance_fast", "instance_anchored"):
            raise ValueError(f"unknown instance norm method: {method}")
        self.method = method
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        if method == "instance_anchored":
            self.register_buffer("anchor", torch.zeros(channels))
            self.register_buffer("anchor_n", torch.zeros(()))

    def _load_from_state_dict(self, state_dict, prefix, local_metadata, strict,
                              missing_keys, unexpected_keys, error_msgs):
        if self.method == "instance_anchored":
            names = [prefix + "anchor", prefix + "anchor_n"]
            if not any(n in state_dict for n in names):
                self.anchor = None
                self.anchor_n = None
            elif self.anchor is None:
                self.anchor = torch.zeros(self.weight.shape, device=self.weight.device)
                self.anchor_n = torch.zeros((), device=self.weight.device)
        super()._load_from_state_dict(state_dict, prefix, local_metadata, strict,
                                      missing_keys, unexpected_keys, error_msgs)

    def _stats(self, x32):
        if self.method == "instance_fast":
            mean = x32.mean(dim=(2, 3), keepdim=True)
            mean_sq = torch.square(x32).mean(dim=(2, 3), keepdim=True)
            return mean, torch.clamp_min(mean_sq - torch.square(mean), 0.0)
        if self.method == "instance_anchored" and self.anchor is not None:
            debias = 1.0 - torch.pow(self.anchor_momentum, self.anchor_n)
            anchor = torch.where(debias > 0, self.anchor / torch.clamp_min(debias, 1e-12), 0.0)
            c = anchor[None, :, None, None]
            xc = x32 - c
            mean_c = xc.mean(dim=(2, 3), keepdim=True)
            var = torch.clamp_min(
                torch.square(xc).mean(dim=(2, 3), keepdim=True) - torch.square(mean_c), 0.0)
            return mean_c + c, var
        mean = x32.mean(dim=(2, 3), keepdim=True)
        return mean, torch.square(x32 - mean).mean(dim=(2, 3), keepdim=True)

    def forward(self, x):
        x32 = x.to(torch.float32)
        mean, var = self._stats(x32)
        inv = torch.rsqrt(var + self.eps)
        a = inv * self.weight[None, :, None, None]
        b = self.bias[None, :, None, None] - mean * a
        return (x32 * a + b).to(x.dtype)


class BatchNorm(nn.BatchNorm2d):
    """torch ``BatchNorm2d`` (eps 1e-5, momentum 0.1) with f32 statistics
    under bf16 activations. The serving path uses it in eval mode."""

    def __init__(self, channels: int):
        super().__init__(channels, eps=1e-5, momentum=0.1)

    def forward(self, x):
        return super().forward(x.to(torch.float32)).to(x.dtype)


def make_norm(method: str, channels: int) -> nn.Module:
    """Norm factory matching the reference's norm selection."""
    if method == "batch":
        return BatchNorm(channels)
    return InstanceNorm(channels, method)


def max_pool_2x2(x):
    """torch ``MaxPool2d(2, stride=2)``."""
    return F.max_pool2d(x, 2, 2)


def upsample_nearest_2x_add(h, x):
    """Nearest 2x upsample of ``h`` plus the skip ``x`` in one broadcast add,
    bit-identical to ``F.interpolate(h, scale_factor=2) + x``."""
    b, c, hh, ww = h.shape
    y = x.reshape(b, c, hh, 2, ww, 2) + h[:, :, :, None, :, None]
    return y.reshape(b, c, 2 * hh, 2 * ww)
