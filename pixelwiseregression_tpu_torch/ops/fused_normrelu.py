"""Fused instance-norm + relu with a one-pass-fewer backward (mirrors
``pixelwiseregression_tpu/ops/fused_normrelu.py``).

``relu(instance_norm(x))`` on NHWC activations ``[B, H, W, C]`` (f32 or
bf16) with f32 scale and bias ``[C]``:

* the forward takes the exact two-pass statistics in f32 (biased variance,
  eps inside the rsqrt), folds the affine into ``a = inv*scale`` and
  ``b = bias - mean*a``, rounds ``y = x32*a + b`` to x's dtype and applies
  relu; it saves x in its own dtype and the per-(B, C) f32 mean and rsqrt;
* the backward recomputes the relu mask from the saved x (the relu output
  is never read): ``y`` rebuilt with the same folding, rounded to x's
  dtype, tested strictly ``> 0`` (the subgradient at 0 is 0), then
  ``dx = a * (g - mean(g) - xhat * mean(g*xhat))`` in x's dtype and
  ``dscale = sum(g*xhat)``, ``dbias = sum(g)`` over the batch and pixels.

``norm_relu`` is the counterpart of the JAX custom VJP (backward in plain
PyTorch); ``ops/cuda_normrelu.py`` runs the same forward with the backward
as a hand-written CUDA kernel (K5). ``normrelu_bwd_plain`` is that
kernel's plain version.
"""

from __future__ import annotations

import torch


def norm_relu_stats(x, eps: float = 1e-5):
    """Per-(B, C) f32 mean and rsqrt(var + eps) of NHWC ``x``, kept as
    ``[B, 1, 1, C]``: two-pass, biased variance."""
    x32 = x.to(torch.float32)
    mean = x32.mean(dim=(1, 2), keepdim=True)
    var = torch.square(x32 - mean).mean(dim=(1, 2), keepdim=True)
    return mean, torch.rsqrt(var + eps)


def _fold(mean, inv, scale, bias):
    a = inv * scale
    return a, bias - mean * a


def norm_relu_apply(x, mean, inv, scale, bias):
    """``relu(round(x32*a + b))`` in x's dtype from given statistics."""
    a, b = _fold(mean, inv, scale, bias)
    return torch.relu((x.to(torch.float32) * a + b).to(x.dtype))


def _as_stat(t, x):
    return t.reshape(x.shape[0], 1, 1, x.shape[-1]).to(torch.float32)


def normrelu_bwd_plain(g, x, mean, inv, scale, bias):
    """The backward of ``relu(instance_norm(x))`` from its residuals (the
    plain version of K5; ``_bwd_math`` of the JAX module).

    ``g`` and ``x`` are ``[B, H, W, C]`` in the activation dtype; ``mean``
    and ``inv`` the per-(B, C) f32 statistics (``[B, C]`` or
    ``[B, 1, 1, C]``); ``scale`` and ``bias`` f32 ``[C]``. Returns dx in x's
    dtype and f32 dscale, dbias ``[C]``.
    """
    mean, inv = _as_stat(mean, x), _as_stat(inv, x)
    x32 = x.to(torch.float32)
    a, b = _fold(mean, inv, scale, bias)
    y = (x32 * a + b).to(x.dtype)
    g32 = torch.where(y > 0, g.to(torch.float32), 0.0)
    xhat = (x32 - mean) * inv
    gx = g32 * xhat
    mg = g32.mean(dim=(1, 2), keepdim=True)
    mgx = gx.mean(dim=(1, 2), keepdim=True)
    dx = (a * (g32 - mg - xhat * mgx)).to(x.dtype)
    return dx, gx.sum(dim=(0, 1, 2)), g32.sum(dim=(0, 1, 2))


class _NormRelu(torch.autograd.Function):
    """``relu(instance_norm(x))`` with ``backward(g) = bwd(g, *residuals)``."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps, bwd):
        mean, inv = norm_relu_stats(x, eps)
        ctx.save_for_backward(x, mean, inv, scale, bias)
        ctx.bwd = bwd
        return norm_relu_apply(x, mean, inv, scale, bias)

    @staticmethod
    def backward(ctx, g):
        x, mean, inv, scale, bias = ctx.saved_tensors
        dx, ds, db = ctx.bwd(g.contiguous(), x, mean, inv, scale, bias)
        return dx, ds, db, None, None


def norm_relu_with(bwd, x, scale, bias, eps: float = 1e-5):
    """``relu(instance_norm(x))`` whose backward is ``bwd``, a function with
    ``normrelu_bwd_plain``'s signature. Scale and bias are taken as f32."""
    return _NormRelu.apply(x, scale.to(torch.float32), bias.to(torch.float32), eps, bwd)


def norm_relu(x, scale, bias, eps: float = 1e-5):
    """``relu(instance_norm(x))`` on NHWC with the fused backward in plain
    PyTorch (the JAX ``norm_relu``)."""
    return norm_relu_with(normrelu_bwd_plain, x, scale, bias, eps)
