"""FullRegression: the paper's direct-regression ablation model
(mirrors ``pixelwiseregression_tpu/models/fullregression.py``).

The stem and hourglass of ``PixelwiseRegression``; each stage then decodes
by three stride-2 convs, a flatten and an MLP (1024, 1024, 3J) instead of
the soft-argmax decoder, and the next stage reads ``concat(f, label_img)``.
It reaches no hand-written kernel: the JAX model reaches no Pallas kernel
either (it has no decoder), so its convs and dense layers are cuDNN's and
cuBLAS's, as XLA's are there.

NCHW, under the reference torch state-dict names: the stem ``conv.K``, and
per stage ``stages.N.conv`` (the 1x1 projection),
``stages.N.hourglass...``, ``stages.N.downsampling.{0,1,3,4,6,7}`` ([conv,
norm, relu] * 3) and ``stages.N.regression.{0,2,4}`` ([linear, relu,
linear, relu, linear]), so a reference ``.pt`` loads natively and
``compat/flax_bridge.py`` maps the JAX model's params onto it.

The JAX model's quirks, kept:

* the blocks always use ``level=4``, whatever ``level`` says (the
  reference passes ``level`` into another slot; JAX ``:121-128``);
* the stem convs are 3x3 and the stem widths double without the
  ``min(..., features)`` of ``PixelwiseRegression`` (JAX ``:101-103``);
* the next stage's input is ``concat(f, label_img)``: the projection has
  ``features + 1`` inputs (JAX ``:134``);
* the dense layers keep f32 params and run in the activation dtype, and
  the coords are cast to f32 (JAX ``:35-42``, ``:79``). The flatten is
  NCHW's C*H*W, which the JAX model gets by transposing first.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from pixelwiseregression_tpu_torch.models.layers import Conv, make_norm
from pixelwiseregression_tpu_torch.models.pixelwise import Hourglass, _buffer_contexts

# the reference never forwards `level` to its blocks
_BLOCK_LEVEL = 4


class _Dense(nn.Linear):
    """``nn.Linear`` (torch's default init: weight and bias uniform within
    1/sqrt(fan_in), as the JAX ``_Dense``) with its f32 params cast to the
    input's dtype. The bias is added after the product is rounded to that
    dtype, as flax's ``Dense`` adds it."""

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype)) + self.bias.to(x.dtype)


def _down_size(n: int) -> int:
    """The side after a 3x3 stride-2 conv with padding 1."""
    return (n + 1) // 2


class FullRegressionBlock(nn.Module):
    """1x1 projection -> hourglass -> three stride-2 [conv, norm, relu] ->
    flatten -> MLP. ``forward(x, label_img)`` returns ``(f, uvd [B, J, 3] f32)``."""

    def __init__(self, in_channels: int, joints: int, label_size: int = 64,
                 features: int = 256, level: int = _BLOCK_LEVEL,
                 norm_method: str = "instance"):
        super().__init__()
        self.joints = joints
        self.conv = Conv(in_channels, features, 1)
        self.hourglass = Hourglass(features, level, norm_method)
        layers = []
        for _ in range(3):
            layers += [Conv(features, features, 3, stride=2), make_norm(norm_method, features),
                       nn.ReLU()]
        self.downsampling = nn.Sequential(*layers)
        side = _down_size(_down_size(_down_size(label_size)))
        self.regression = nn.Sequential(
            _Dense(features * side * side, 1024), nn.ReLU(), _Dense(1024, 1024), nn.ReLU(),
            _Dense(1024, joints * 3))

    def forward(self, x):
        f = self.hourglass(self.conv(x))
        h = self.downsampling(f)
        coords = self.regression(h.reshape(h.shape[0], -1))
        return f, coords.reshape(-1, self.joints, 3).to(torch.float32)


class FullRegression(nn.Module):
    """``forward(img [B,1,2S,2S], label_img [B,1,S,S], mask)`` returns a list of
    per-stage uvd ``[B, J, 3]`` f32 (``mask`` is unused, as in the reference).

    ``dtype`` is the activation dtype; ``remat`` recomputes each stage in
    the backward (``torch.utils.checkpoint``), as ``PixelwiseRegression``'s.
    ``level`` is accepted and ignored by the blocks (see the module note).
    """

    def __init__(self, joints: int, stage: int = 2, label_size: int = 64, features: int = 256,
                 level: int = 4, norm_method: str = "instance",
                 dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__()
        self.dtype = dtype
        self.remat = remat
        self.level = level
        self.norm_method = norm_method
        self.quant = None
        widths = [32]
        while widths[-1] < features:
            widths.append(2 * widths[-1])
        layers, cin = [], 1
        for w in widths:
            layers += [Conv(cin, w, 3), make_norm(norm_method, w), nn.ReLU()]
            cin = w
        layers += [Conv(cin, features, 3, stride=2), make_norm(norm_method, features), nn.ReLU()]
        self.conv = nn.Sequential(*layers)
        self.stages = nn.ModuleList(
            FullRegressionBlock(features if s == 0 else features + 1, joints, label_size,
                                features, _BLOCK_LEVEL, norm_method)
            for s in range(stage))

    def forward(self, img, label_img, mask=None):
        label_img = label_img.to(self.dtype)
        f = self.conv(img.to(self.dtype))
        results = []
        for block in self.stages:
            if self.remat and torch.is_grad_enabled():
                f, uvd = checkpoint(block, f, use_reentrant=False,
                                    context_fn=functools.partial(_buffer_contexts, block))
            else:
                f, uvd = block(f)
            results.append(uvd)
            f = torch.cat([f, label_img], dim=1)
        return results
