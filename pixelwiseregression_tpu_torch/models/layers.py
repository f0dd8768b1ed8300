"""Shared building blocks (mirrors ``pixelwiseregression_tpu/models/layers.py``).

NCHW throughout. Params are f32; a module runs in the dtype of its input
(the activation dtype), with the casts where the JAX package puts them: a
conv casts its weight and bias to the activation dtype, a norm takes its
statistics in f32 and casts y back.

The int8 conv comes with a later part of the port.
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


class _InstanceNormFn(torch.autograd.Function):
    """Instance norm core with the JAX package's hand-written backward.

    ``forward(x, weight, bias, anchor, method, eps)`` returns y in f32 for x
    of any float dtype, and the per-(B, C) f32 mean (a calibration aux with
    no gradient). It saves x in its own dtype (bf16 under mixed precision)
    plus the per-(B, C) f32 mean and rsqrt, and the backward is
    ``dx = weight*inv * (g - mean(g) - xhat * mean(g*xhat))`` in x's dtype,
    ``dweight = sum(g*xhat)``, ``dbias = sum(g)``. The anchor is a
    calibration constant: it gets no gradient.
    """

    @staticmethod
    def forward(ctx, x, weight, bias, anchor, method, eps):
        x32 = x.to(torch.float32)
        if method == "instance_fast":
            mean = x32.mean(dim=(2, 3), keepdim=True)
            mean_sq = torch.square(x32).mean(dim=(2, 3), keepdim=True)
            var = torch.clamp_min(mean_sq - torch.square(mean), 0.0)
        elif anchor is not None:
            c = anchor[None, :, None, None]
            xc = x32 - c
            mean_c = xc.mean(dim=(2, 3), keepdim=True)
            var = torch.clamp_min(
                torch.square(xc).mean(dim=(2, 3), keepdim=True) - torch.square(mean_c), 0.0)
            mean = mean_c + c
        else:
            mean = x32.mean(dim=(2, 3), keepdim=True)
            var = torch.square(x32 - mean).mean(dim=(2, 3), keepdim=True)
        inv = torch.rsqrt(var + eps)
        w = weight[None, :, None, None]
        a = inv * w
        b = bias[None, :, None, None] - mean * a
        ctx.save_for_backward(x, mean, inv, w)
        ctx.mark_non_differentiable(mean)
        return x32 * a + b, mean

    @staticmethod
    def backward(ctx, g, _g_mean):
        x, mean, inv, w = ctx.saved_tensors
        xhat = (x.to(torch.float32) - mean) * inv
        mg = g.mean(dim=(2, 3), keepdim=True)
        gx = g * xhat
        mgx = gx.mean(dim=(2, 3), keepdim=True)
        dx = ((inv * w) * (g - mg - xhat * mgx)).to(x.dtype)
        return dx, gx.sum(dim=(0, 2, 3)), g.sum(dim=(0, 2, 3)), None, None, None


class InstanceNorm(nn.Module):
    """torch ``InstanceNorm2d(affine=True)``: per-sample, per-channel over
    H, W; eps 1e-5, biased variance, statistics in f32, the JAX package's
    hand-written backward (``_InstanceNormFn``).

    ``method``:

    * ``instance``: two-pass variance ``E[(x - mean)^2]``;
    * ``instance_fast``: one-pass ``E[x^2] - E[x]^2`` (cancels on
      near-constant channels);
    * ``instance_anchored``: one-pass around a calibrated per-channel anchor
      ``c``, ``var = E[(x-c)^2] - (E[x]-c)^2``, with the debiased anchor
      ``anchor / (1 - 0.9**anchor_n)`` (0 while ``anchor_n`` is 0). In train
      mode each forward then updates the anchor's EMA with the batch mean of
      the per-(B, C) means (the forward itself uses the anchor from before
      the update): ``anchor = 0.9*anchor + 0.1*mean``, ``anchor_n += 1``.

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

    def forward(self, x):
        anchored = self.method == "instance_anchored" and self.anchor is not None
        anchor = None
        if anchored:
            debias = 1.0 - torch.pow(self.anchor_momentum, self.anchor_n)
            anchor = torch.where(debias > 0, self.anchor / torch.clamp_min(debias, 1e-12), 0.0)
        y, mean = _InstanceNormFn.apply(x, self.weight, self.bias, anchor, self.method, self.eps)
        if anchored and self.training:
            with torch.no_grad():
                m = torch.tensor(self.anchor_momentum, dtype=torch.float32, device=x.device)
                self.anchor.copy_(m * self.anchor + (1.0 - m) * mean.mean(dim=(0, 2, 3)))
                self.anchor_n += 1.0
        return y.to(x.dtype)


class BatchNorm(nn.BatchNorm2d):
    """torch ``BatchNorm2d`` (eps 1e-5) computed as flax's BatchNorm:
    statistics in f32 under bf16 activations, the one-pass batch variance
    ``E[x^2] - E[x]^2`` in train mode, and running statistics updated with
    momentum 0.1 (flax's 0.9) from the *biased* batch variance, where
    ``torch.nn.BatchNorm2d`` would take the unbiased one."""

    def __init__(self, channels: int):
        super().__init__(channels, eps=1e-5, momentum=0.1)

    def forward(self, x):
        x32 = x.to(torch.float32)
        if self.training:
            mean = x32.mean(dim=(0, 2, 3))
            var = torch.clamp_min(torch.square(x32).mean(dim=(0, 2, 3)) - torch.square(mean), 0.0)
            with torch.no_grad():
                m = 1.0 - self.momentum
                self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
                self.num_batches_tracked += 1
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x32 - mean[None, :, None, None]) * mul[None, :, None, None]
        return (y + self.bias[None, :, None, None]).to(x.dtype)


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
