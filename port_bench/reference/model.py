"""Plain PyTorch reference of the two models the benchmark runs:
PixelwiseRegression (stacked hourglasses, soft-argmax decoder) and
FullRegression (the same stem and hourglasses, an MLP head).

Frozen from the port's ``models/`` so that the yardstick does not move when
the port does. Float32 only, no kernels: every norm and the decoder are
plain tensor ops and autograd takes their gradients. The module tree gives
the port's state-dict names, so one weight dictionary loads into both.

``tf32=True`` is the comparison's control: every conv's and dense layer's
operands are rounded to TF32 (10 mantissa bits, round to nearest even)
before the product, in the forward and in the backward's two products,
which is what the card's tensor cores do with float32 operands when TF32
is allowed. The products still accumulate in float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

EPS_NORM = 1e-5
ANCHOR_MOMENTUM = 0.9
EPS_DECODE = 1e-14


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (ties to even), still as float32."""
    i = x.contiguous().view(torch.int32)
    lsb = torch.bitwise_and(torch.bitwise_right_shift(i, 13), 1)
    i = torch.bitwise_and(i + 0xFFF + lsb, -0x2000)
    return i.view(torch.float32)


class _Operand(torch.autograd.Function):
    """A product's operand in TF32; its gradient passes as it is."""

    @staticmethod
    def forward(ctx, x):
        return round_tf32(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _Product(torch.autograd.Function):
    """A product's result as it is; the gradient it receives in TF32, so
    that the backward's products also take TF32 operands."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return round_tf32(g)


def _tf32_product(fn, x, w, *args):
    return _Product.apply(fn(_Operand.apply(x), _Operand.apply(w), *args))


class Conv(nn.Module):
    """``k // 2`` zero padding, weight ``[Co, Ci, k, k]`` and bias ``[Co]``."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, tf32: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.empty(cout))
        self.stride, self.pad, self.tf32 = stride, k // 2, tf32

    def forward(self, x):
        if self.tf32:
            return _tf32_product(F.conv2d, x, self.weight, self.bias, self.stride, self.pad)
        return F.conv2d(x, self.weight, self.bias, self.stride, self.pad)


class Dense(nn.Module):
    def __init__(self, cin: int, cout: int, tf32: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.empty(cout))
        self.tf32 = tf32

    def forward(self, x):
        if self.tf32:
            return _tf32_product(F.linear, x, self.weight, self.bias)
        return F.linear(x, self.weight, self.bias)


class InstanceNorm(nn.Module):
    """Per sample and channel over H, W, affine, eps 1e-5, biased variance.

    ``instance``: the two-pass variance. ``instance_anchored``: the
    one-pass variance around the debiased per-channel anchor
    ``anchor / (1 - 0.9 ** anchor_n)`` (0 before the first update). In
    train mode the forward sums its per-sample means; ``commit_anchors``
    then moves the anchor's EMA ``0.9 * anchor + 0.1 * (batch mean of the
    per-sample means)``, once a step whatever the row blocks.
    """

    def __init__(self, channels: int, method: str):
        super().__init__()
        if method not in ("instance", "instance_anchored"):
            raise ValueError(f"the reference has no norm {method!r}")
        self.method = method
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        if method == "instance_anchored":
            self.register_buffer("anchor", torch.zeros(channels))
            self.register_buffer("anchor_n", torch.zeros(()))
        self.mean_sum, self.mean_rows = None, 0

    def forward(self, x):
        if self.method == "instance_anchored":
            debias = 1.0 - torch.pow(ANCHOR_MOMENTUM, self.anchor_n)
            c = torch.where(debias > 0, self.anchor / torch.clamp_min(debias, 1e-12), 0.0)
            c = c[None, :, None, None]
            xc = x - c
            mean_c = xc.mean(dim=(2, 3), keepdim=True)
            var = torch.clamp_min((xc * xc).mean(dim=(2, 3), keepdim=True) - mean_c * mean_c, 0.0)
            mean = mean_c + c
            if self.training:
                # summed over the row blocks of a step; commit_anchors applies them
                sums = mean.detach().to(torch.float64).sum(dim=(0, 2, 3))
                self.mean_sum = sums if self.mean_sum is None else self.mean_sum + sums
                self.mean_rows += x.shape[0]
        else:
            mean = x.mean(dim=(2, 3), keepdim=True)
            var = ((x - mean) ** 2).mean(dim=(2, 3), keepdim=True)
        y = (x - mean) * torch.rsqrt(var + EPS_NORM)
        return y * self.weight[None, :, None, None] + self.bias[None, :, None, None]


def commit_anchors(model: nn.Module) -> None:
    """After a train step's forwards (one a row block): each anchored norm's
    EMA with the batch mean of the per-sample means of the whole batch."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, InstanceNorm) and m.mean_sum is not None:
                batch_mean = (m.mean_sum / m.mean_rows).to(torch.float32)
                m.anchor.copy_(ANCHOR_MOMENTUM * m.anchor + (1.0 - ANCHOR_MOMENTUM) * batch_mean)
                m.anchor_n += 1.0
                m.mean_sum, m.mean_rows = None, 0


def _unit(cin, cout, k, norm, stride=1, tf32=False):
    return [Conv(cin, cout, k, stride, tf32), InstanceNorm(cout, norm), nn.ReLU()]


class ResBlock(nn.Module):
    """x + [norm, relu, 1x1 f->f/2, norm, relu, kxk, norm, relu, 1x1 -> f](x)."""

    def __init__(self, f: int, norm: str, tf32: bool):
        super().__init__()
        h = f // 2
        self.conv = nn.Sequential(
            InstanceNorm(f, norm), nn.ReLU(), Conv(f, h, 1, tf32=tf32),
            InstanceNorm(h, norm), nn.ReLU(), Conv(h, h, 3, tf32=tf32),
            InstanceNorm(h, norm), nn.ReLU(), Conv(h, f, 1, tf32=tf32))

    def forward(self, x):
        return x + self.conv(x)


class Hourglass(nn.Module):
    """ResBlock, max-pool 2x2, the inner level (a ResBlock at level 0),
    ResBlock, nearest 2x upsample, plus the skip."""

    def __init__(self, f: int, level: int, norm: str, tf32: bool):
        super().__init__()
        self.input_conv = ResBlock(f, norm, tf32)
        self.inner = Hourglass(f, level - 1, norm, tf32) if level > 0 else ResBlock(f, norm, tf32)
        self.output_conv = ResBlock(f, norm, tf32)

    def forward(self, x):
        x = self.input_conv(x)
        h = self.output_conv(self.inner(F.max_pool2d(x, 2, 2)))
        return F.interpolate(h, scale_factor=2, mode="nearest") + x


class Head(nn.Module):
    def __init__(self, f: int, out: int, k: int, norm: str, temperature: bool, tf32: bool):
        super().__init__()
        layers = []
        for _ in range(3):
            layers += _unit(f, f, k, norm, tf32=tf32)
        self.conv = nn.Sequential(*layers, Conv(f, out, k, tf32=tf32))
        if temperature:
            self.w = nn.Parameter(torch.ones(out, 1))

    def forward(self, x):
        return self.conv(x)


def decode(logits, depthmaps, label_img, mask, w):
    """Soft-argmax: heatmaps ``[B, J, H, W]`` (softmax of ``w * logits``
    over H*W) and uvd ``[B, J, 3]``: u, v the heatmap's expectation of the
    centred coordinates ``(j - W//2) / (W - 1)``, ``(i - H//2) / (H - 1)``;
    d the expectation of ``depthmap + label`` under the masked heatmap."""
    b, j, h, wd = logits.shape
    hm = torch.softmax(logits.reshape(b, j, h * wd) * w[None, :, None], dim=2)
    cu = (torch.arange(wd, dtype=torch.float64, device=logits.device) - wd // 2) / (wd - 1)
    cv = (torch.arange(h, dtype=torch.float64, device=logits.device) - h // 2) / (h - 1)
    fu = cu[None, :].expand(h, wd).reshape(h * wd).to(torch.float32)
    fv = cv[:, None].expand(h, wd).reshape(h * wd).to(torch.float32)
    u = (hm * fu).sum(dim=2)
    v = (hm * fv).sum(dim=2)
    m = mask.reshape(b, 1, h * wd)
    recon = (depthmaps.reshape(b, j, h * wd) + label_img.reshape(b, 1, h * wd)) * m
    mh = hm * m
    d = (mh * recon).sum(dim=2) / (mh.sum(dim=2) + EPS_DECODE)
    return hm.reshape(b, j, h, wd), torch.stack([u, v, d], dim=-1)


class PredictionBlock(nn.Module):
    def __init__(self, cin, joints, f, level, k, norm, tf32):
        super().__init__()
        self.conv = Conv(cin, f, 1, tf32=tf32)
        self.hourglass = Hourglass(f, level, norm, tf32)
        self.plane_regression = Head(f, joints, k, norm, True, tf32)
        self.depth_regression = Head(f, joints, k, norm, False, tf32)

    def forward(self, x, label_img, mask):
        f = self.hourglass(self.conv(x))
        depthmaps = self.depth_regression(f)
        heatmaps, uvd = decode(self.plane_regression(f), depthmaps, label_img, mask,
                               self.plane_regression.w[:, 0])
        return heatmaps, depthmaps, uvd


def _stem(widths, k, features, norm, tf32):
    layers, cin = [], 1
    for w in widths:
        layers += _unit(cin, w, k, norm, tf32=tf32)
        cin = w
    return nn.Sequential(*layers, *_unit(cin, features, k, norm, stride=2, tf32=tf32))


class PixelwiseRegression(nn.Module):
    """``forward(img [B,1,2S,2S], label_img [B,1,S,S], mask [B,1,S,S])`` ->
    per stage (heatmaps, depthmaps, uvd); the next stage reads
    ``concat(heatmaps, depthmaps, label_img)``."""

    def __init__(self, joints, stages, features, level, kernel_size, norm, tf32=False):
        super().__init__()
        widths = [32]
        while widths[-1] < features:
            widths.append(min(2 * widths[-1], features))
        self.conv = _stem(widths, kernel_size, features, norm, tf32)
        self.stages = nn.ModuleList(
            PredictionBlock(features if s == 0 else 2 * joints + 1, joints, features, level,
                            kernel_size, norm, tf32) for s in range(stages))

    def forward(self, img, label_img, mask):
        f = self.conv(img)
        out = []
        for block in self.stages:
            heatmaps, depthmaps, uvd = block(f, label_img, mask)
            out.append((heatmaps, depthmaps, uvd))
            f = torch.cat([heatmaps, depthmaps, label_img], dim=1)
        return out


class FullRegressionBlock(nn.Module):
    def __init__(self, cin, joints, label_size, f, norm, tf32):
        super().__init__()
        self.joints = joints
        self.conv = Conv(cin, f, 1, tf32=tf32)
        self.hourglass = Hourglass(f, 4, norm, tf32)
        layers = []
        for _ in range(3):
            layers += _unit(f, f, 3, norm, stride=2, tf32=tf32)
        self.downsampling = nn.Sequential(*layers)
        side = label_size
        for _ in range(3):
            side = (side + 1) // 2
        self.regression = nn.Sequential(Dense(f * side * side, 1024, tf32), nn.ReLU(),
                                        Dense(1024, 1024, tf32), nn.ReLU(),
                                        Dense(1024, 3 * joints, tf32))

    def forward(self, x):
        f = self.hourglass(self.conv(x))
        h = self.downsampling(f)
        return f, self.regression(h.reshape(h.shape[0], -1)).reshape(-1, self.joints, 3)


class FullRegression(nn.Module):
    """The direct-regression model: each stage's hourglass (always level 4)
    feeds three stride-2 [conv, norm, relu] and a 1024-1024-3J MLP; the stem
    widths double from 32 to ``features``; the next stage reads
    ``concat(f, label_img)``. ``forward`` -> per-stage uvd ``[B, J, 3]``."""

    def __init__(self, joints, stages, features, label_size, norm, tf32=False):
        super().__init__()
        widths = [32]
        while widths[-1] < features:
            widths.append(2 * widths[-1])
        self.conv = _stem(widths, 3, features, norm, tf32)
        self.stages = nn.ModuleList(
            FullRegressionBlock(features if s == 0 else features + 1, joints, label_size,
                                features, norm, tf32) for s in range(stages))

    def forward(self, img, label_img, mask=None):
        f = self.conv(img)
        out = []
        for block in self.stages:
            f, uvd = block(f)
            out.append(uvd)
            f = torch.cat([f, label_img], dim=1)
        return out


def build(cfg: dict, norm: str, tf32: bool = False) -> nn.Module:
    """The configuration's model (``cfg["model"]``) with ``norm``, on the
    current default device, parameters uninitialised (``weights.make``
    fills them)."""
    m = cfg["model"]
    if m["class"] == "PixelwiseRegression":
        return PixelwiseRegression(m["joints"], m["stages"], m["features"], m["level"],
                                   m["filter_size"], norm, tf32)
    if m["class"] == "FullRegression":
        return FullRegression(m["joints"], m["stages"], m["features"], m["label_size"], norm,
                              tf32)
    raise ValueError(f"the reference has no model {m['class']!r}")


def init_spec(model: nn.Module):
    """How ``weights.make`` draws each leaf, by name: ``("normal", std)``
    (a conv's weight: Xavier normal), ``("uniform", bound)`` (a conv's bias
    and a dense layer's weight and bias: within 1/sqrt(fan_in)), or
    ``("const", value)`` (norms' scale 1 and shift 0, the softmax
    temperature 1, the anchors 0). The port's initial distributions."""
    spec = {}
    for path, mod in model.named_modules():
        pre = f"{path}." if path else ""
        if isinstance(mod, Conv):
            co, ci, k, _ = mod.weight.shape
            spec[pre + "weight"] = ("normal", math.sqrt(2.0 / (ci * k * k + co * k * k)))
            spec[pre + "bias"] = ("uniform", 1.0 / math.sqrt(ci * k * k))
        elif isinstance(mod, Dense):
            bound = 1.0 / math.sqrt(mod.weight.shape[1])
            spec[pre + "weight"] = ("uniform", bound)
            spec[pre + "bias"] = ("uniform", bound)
        elif isinstance(mod, InstanceNorm):
            spec[pre + "weight"] = ("const", 1.0)
            spec[pre + "bias"] = ("const", 0.0)
            if mod.method == "instance_anchored":
                spec[pre + "anchor"] = ("const", 0.0)
                spec[pre + "anchor_n"] = ("const", 0.0)
        elif isinstance(mod, Head) and hasattr(mod, "w"):
            spec[pre + "w"] = ("const", 1.0)
    return spec
