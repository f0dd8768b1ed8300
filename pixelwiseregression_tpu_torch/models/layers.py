"""Shared building blocks (mirrors ``pixelwiseregression_tpu/models/layers.py``).

NCHW throughout. Params are f32; a module runs in the dtype of its input
(the activation dtype), with the casts where the JAX package puts them: a
conv casts its weight and bias to the activation dtype, a norm takes its
statistics in f32 and casts y back.

``Conv(quant="int8" | "int8_static")`` is the int8 inference conv (the JAX
package's ``_Int8Conv2D``): int8 codes, an int32 product, an f32 epilogue.
An f32 3x3 conv of the shape ``ops/cuda_conv`` takes runs through its
operator (the hand-written kernel on the card, ``F.conv2d`` on the CPU).
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

from pixelwiseregression_tpu_torch.ops import cuda_conv
from pixelwiseregression_tpu_torch.parallel import mesh


# torch._int_mm calls made by the int8 convs (live calls; an exported
# program runs the product as an operator of its own and is not counted)
INT_MM_CALLS = 0
# rows of zeros below an im2col operand: cuBLAS's int8 product on the card
# needs more than 16 rows, and a fixed pad keeps a traced batch symbolic
_ROW_PAD = 16


def _ceil8(n: int) -> int:
    return -(-n // 8) * 8


def _div127(t):
    """``t / 127`` rounded as a true division on every device: divided by a
    Python number, a CUDA tensor is multiplied by the number's reciprocal
    instead, which can round differently (and then the codes and scales
    part from the CPU's and the JAX package's)."""
    return t / t.new_full((), 127.0)


def int8_codes(x, weight, act_absmax_c=None):
    """The int8 conv's codes and scales (JAX ``_Int8Conv2D``, op for op).

    ``x`` ``[B, Cin, H, W]`` any float dtype, ``weight`` ``[Co, Cin, k, k]``
    f32. With ``act_absmax_c`` ``[Cin]`` (static): ``s_a = act_absmax_c /
    127`` per input channel, folded into the weight before its
    quantization, ``w_eff = weight * s_a``; without (dynamic): ``s_a`` is
    each sample's ``|x|max / 127``. The weight's scale is per output
    channel, ``s_w = |w_eff|max / 127``; every scale is at least 1e-12.
    ``round`` is half-to-even in both frameworks; x's codes clip to
    [-127, 127].

    Returns ``(x_q, w_q, s_out)``: int8 ``[B, Cin, H, W]``, int8
    ``[Co, Cin, k, k]`` and the output scale, ``s_w`` ``[Co]`` (static) or
    ``s_a * s_w`` ``[B, 1, Co]`` (dynamic).
    """
    x32 = x.to(torch.float32)
    if act_absmax_c is not None:
        s_a = torch.clamp_min(_div127(act_absmax_c), 1e-12)
        w_eff = weight * s_a[None, :, None, None]
        s_a = s_a[None, :, None, None]
    else:
        s_a = torch.clamp_min(_div127(x32.abs().amax(dim=(1, 2, 3), keepdim=True)), 1e-12)
        w_eff = weight
    s_w = torch.clamp_min(_div127(w_eff.abs().amax(dim=(1, 2, 3))), 1e-12)
    w_q = torch.round(w_eff / s_w[:, None, None, None]).to(torch.int8)
    x_q = torch.clamp(torch.round(x32 / s_a), -127, 127).to(torch.int8)
    s_out = s_w if act_absmax_c is not None else s_a.reshape(-1, 1, 1) * s_w
    return x_q, w_q, s_out


def int8_gemm(x_q, w_q, stride: int = 1):
    """The int32 accumulators of the conv of int8 codes, with ``k // 2``
    zero padding: ``[B, Ho, Wo, Co]``.

    An im2col in int8 (a strided view of the padded NHWC codes, copied once
    into ``[B*Ho*Wo, Cin*k*k]``) times the weight's codes by
    ``torch._int_mm`` (cuBLAS's int8 tensor-core product on the card). The
    card's product needs K and N multiples of 8 and M above 16, so input
    channels and output channels pad with zero codes, and ``_ROW_PAD`` zero
    rows follow the operand; none of them changes a sum. The CPU runs the
    same steps.
    """
    global INT_MM_CALLS
    b, cin, _, _ = x_q.shape
    co, _, k, _ = w_q.shape
    cin_p, co_p, p = _ceil8(cin), _ceil8(co), k // 2
    xp = F.pad(x_q.permute(0, 2, 3, 1), (0, cin_p - cin, p, p, p, p))
    cols = xp.unfold(1, k, stride).unfold(2, k, stride)  # [B, Ho, Wo, Cin_p, k, k]
    ho, wo = cols.shape[1], cols.shape[2]
    m = b * ho * wo
    a = x_q.new_empty((m + _ROW_PAD, cin_p * k * k))
    a[:m].view(b, ho, wo, cin_p, k, k).copy_(cols)
    a[m:].zero_()
    wk = F.pad(w_q, (0, 0, 0, 0, 0, cin_p - cin, 0, co_p - co)).reshape(co_p, cin_p * k * k)
    acc = torch._int_mm(a, wk.t())
    INT_MM_CALLS += 1
    return acc[:m, :co].reshape(b, ho, wo, co)


def int8_conv2d(x, weight, bias, stride: int = 1, act_absmax_c=None):
    """The int8 conv: ``int32 product * s_out + bias`` in f32, cast to x's
    dtype, NCHW (the JAX package's ``y.astype(f32) * s_out + bias``)."""
    x_q, w_q, s_out = int8_codes(x, weight, act_absmax_c)
    acc = int8_gemm(x_q, w_q, stride)
    b, ho, wo, co = acc.shape
    y = acc.reshape(b, ho * wo, co).to(torch.float32) * s_out + bias
    return y.to(x.dtype).reshape(b, ho, wo, co).permute(0, 3, 1, 2).contiguous()


class Conv(nn.Conv2d):
    """2-D conv with torch-style explicit ``k//2`` padding, xavier-normal
    weights and torch-uniform bias. Its weight and bias are cast to the
    input's dtype.

    ``quant`` (inference only): ``"int8"`` runs ``int8_conv2d`` with
    per-sample scales, ``"int8_static"`` with the calibrated per-input-channel
    ``act_absmax_c`` (the JAX package's ``quant_scales`` collection): a
    non-persistent buffer, so the state dict is the unquantized model's. A
    forward inside ``calibrating(model)`` first raises ``act_absmax_c`` to
    the running ``|x|max`` of each input channel; a static conv that was
    never calibrated (nor given scales by ``load_quant_scales``) raises.

    Unquantized, a conv that ``cuda_conv.fits`` (3x3, stride 1, channels
    multiples of 128: the pixelwise heads') takes ``cuda_conv.conv3x3_f32``
    for an input that ``cuda_conv.takes`` (f32, contiguous, 64 wide);
    every other conv and input keeps ``F.conv2d``.
    """

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, quant: str | None = None):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=kernel_size // 2)
        if quant not in (None, "int8", "int8_static"):
            raise ValueError(f"unknown quant mode: {quant}")
        self.quant = quant
        self.calibrating = False
        self.calibrated = False
        self.hand_f32 = quant is None and cuda_conv.fits(
            in_channels, out_channels, self.kernel_size, self.stride, self.padding)
        if quant == "int8_static":
            self.register_buffer("act_absmax_c", torch.zeros(in_channels), persistent=False)

    def reset_parameters(self):
        nn.init.xavier_normal_(self.weight)
        fan_in = self.in_channels * self.kernel_size[0] * self.kernel_size[1]
        bound = 1.0 / math.sqrt(fan_in)
        nn.init.uniform_(self.bias, -bound, bound)

    def forward(self, x):
        if self.quant is None:
            if self.hand_f32 and cuda_conv.takes(x):
                return cuda_conv.conv3x3_f32(x, self.weight, self.bias)
            return F.conv2d(x, self.weight.to(x.dtype), self.bias.to(x.dtype),
                            self.stride, self.padding)
        scales = None
        if self.quant == "int8_static":
            if self.calibrating:
                with torch.no_grad():
                    self.act_absmax_c.copy_(torch.maximum(
                        self.act_absmax_c, x.to(torch.float32).abs().amax(dim=(0, 2, 3))))
                self.calibrated = True
            elif not self.calibrated:
                raise RuntimeError("int8_static conv without calibrated quant_scales: run "
                                   "forwards inside calibrating(model) first, or "
                                   "load_quant_scales")
            scales = self.act_absmax_c
        return int8_conv2d(x, self.weight, self.bias, self.stride[0], scales)


def _static_convs(model: nn.Module) -> dict:
    return {name: m for name, m in model.named_modules()
            if isinstance(m, Conv) and m.quant == "int8_static"}


@contextlib.contextmanager
def calibrating(model: nn.Module):
    """Forwards of ``model`` inside raise its static int8 convs' scales to the
    running per-input-channel ``|x|max`` (JAX: ``apply(...,
    mutable=["quant_scales"])``); each such forward then computes with the
    raised scales, as JAX's does."""
    convs = list(_static_convs(model).values())
    for m in convs:
        m.calibrating = True
    try:
        yield
    finally:
        for m in convs:
            m.calibrating = False


def quant_scales(model: nn.Module) -> dict:
    """The static int8 convs' ``act_absmax_c`` by module name."""
    return {name: m.act_absmax_c for name, m in _static_convs(model).items()}


def load_quant_scales(model: nn.Module, scales) -> None:
    """Set every static int8 conv's ``act_absmax_c`` from ``{module name:
    [Cin]}`` (``compat.flax_bridge.quant_scales_from_flax`` maps the JAX
    package's calibrated collection) and mark it calibrated."""
    convs = _static_convs(model)
    if set(scales) != set(convs):
        raise KeyError(f"scales for {sorted(set(scales) ^ set(convs))} do not match the "
                       "model's static int8 convs")
    with torch.no_grad():
        for name, m in convs.items():
            m.act_absmax_c.copy_(torch.as_tensor(scales[name]))
            m.calibrated = True


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

    In a ``torch.distributed`` run (``parallel/mesh.py``) the anchors' EMA
    takes the mean over the global batch (the ranks' batch means averaged),
    as the JAX norm's update does over a mesh.
    """

    eps = 1e-5
    anchor_momentum = 0.9
    # the EMA's factors as float32 rounds them, 0.9f and 1.0f - 0.9f =
    # 0.10000002f (the JAX package's), kept as Python floats: a kernel takes
    # a scalar operand by value, where a tensor made on the card each call
    # would be a copy from pageable memory, and with it a stream synchronise
    _ema_keep = float(torch.tensor(anchor_momentum, dtype=torch.float32))
    _ema_take = float(1.0 - torch.tensor(anchor_momentum, dtype=torch.float32))

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
                # the batch mean of the per-(B, C) means, summed in f64 (and
                # over the ranks in a distributed run)
                batch_mean = mesh.global_mean(mean.sum(dim=(0, 2, 3), dtype=torch.float64),
                                              mean.shape[0]).to(torch.float32)
                self.anchor.copy_(self.anchor * self._ema_keep + batch_mean * self._ema_take)
                self.anchor_n += 1.0
        return y.to(x.dtype)


def _batch_moments(x32):
    """E[x] and E[x^2] per channel over (B, H, W) of f32 ``x32``: each
    sample's sums in f32, their sum over the batch (and over the ranks, in a
    distributed run: differentiably) in f64, so that the moments do not
    depend on how the batch is split over ranks."""
    b, _, h, w = x32.shape
    per_sample = torch.stack([x32.sum(dim=(2, 3)), torch.square(x32).sum(dim=(2, 3))])
    sums = mesh.all_reduce_sum_grad(per_sample.to(torch.float64).sum(dim=1))
    moments = (sums / (b * h * w * mesh.world_size())).to(torch.float32)
    return moments[0], moments[1]


class BatchNorm(nn.BatchNorm2d):
    """torch ``BatchNorm2d`` (eps 1e-5) computed as flax's BatchNorm:
    statistics in f32 under bf16 activations, the one-pass batch variance
    ``E[x^2] - E[x]^2`` in train mode, and running statistics updated with
    momentum 0.1 (flax's 0.9) from the *biased* batch variance, where
    ``torch.nn.BatchNorm2d`` would take the unbiased one.

    The batch statistics sum each sample's f32 sums in f64
    (``_batch_moments``). In a ``torch.distributed`` run
    (``parallel/mesh.py``) they are the global batch's: those sums are
    all-reduced (``SyncBatchNorm``'s semantics, differentiably), as flax's
    BatchNorm takes them over a mesh."""

    def __init__(self, channels: int):
        super().__init__(channels, eps=1e-5, momentum=0.1)

    def forward(self, x):
        x32 = x.to(torch.float32)
        if self.training:
            mean, mean_sq = _batch_moments(x32)
            var = torch.clamp_min(mean_sq - torch.square(mean), 0.0)
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
