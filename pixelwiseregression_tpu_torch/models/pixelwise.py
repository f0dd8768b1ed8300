"""PixelwiseRegression — stacked-hourglass network with soft-argmax decoding
(mirrors ``pixelwiseregression_tpu/models/pixelwise.py``).

NCHW. The module tree reproduces the reference torch model's state-dict
names (``conv.N.*`` for the stem, ``stages.N.conv`` for the 1x1 projection,
``stages.N.hourglass.{input_conv,inner,output_conv}...conv.K.*``,
``stages.N.{plane,depth}_regression.conv.K.*``,
``stages.N.plane_regression.w``), so a reference ``.pt`` state dict loads
natively and ``compat/flax_bridge.py`` maps the JAX package's params onto it.

``model.train()`` is the JAX package's ``train=True``: BatchNorm takes batch
statistics, the anchored instance norms update their anchors, and the
kernel decoder takes the f32 training boundary. ``remat=True`` is the JAX
package's ``nn.remat(PredictionBlock)``: each stage runs under
``torch.utils.checkpoint`` and is recomputed in the backward.

``quant`` (``int8[_static][_all|_heads]``, inference only) puts int8 convs
(``layers.Conv(quant=...)``) where the JAX package does (``parse_quant``);
the state dict stays the unquantized model's. ``calibrate`` runs a forward
that raises the static modes' scales.

``paired_heads=True`` evaluates the plane and depth heads as one
computation at inference (``models/paired_heads.py``; ``paired_mid`` and
``paired_final`` pick the forms), on the same state dict. It applies in
eval mode, without quant and with instance norms; otherwise the plain heads
run (JAX ``models/pixelwise.py:177-185``). Uncalibrated anchors take the
paired path too, as in JAX, whose norms read them as 0 just as the plain
heads do.
"""

from __future__ import annotations

import contextlib
import functools

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from pixelwiseregression_tpu_torch.models.layers import (
    Conv,
    calibrating,
    make_norm,
    max_pool_2x2,
    upsample_nearest_2x_add,
)
from pixelwiseregression_tpu_torch.models.paired_heads import (
    FINALS,
    MIDS,
    pairable,
    paired_heads_apply,
)
from pixelwiseregression_tpu_torch.ops import cuda_softargmax
from pixelwiseregression_tpu_torch.ops.softargmax import soft_argmax_decode_flat


def parse_quant(quant: str | None):
    """A quant mode ``int8[_static][_all|_heads]`` -> the Conv modes of
    (stem, heads, hourglass), as the JAX package's ``parse_quant``: the
    default covers the stem (not its first conv) and the heads' conv_0..2,
    ``_all`` adds the hourglass ResBlocks, ``_heads`` is the heads alone."""
    if quant in (None, "none"):
        return None, None, None
    m = quant
    if m.endswith("_all"):
        cov, m = "all", m[: -len("_all")]
    elif m.endswith("_heads"):
        cov, m = "heads", m[: -len("_heads")]
    else:
        cov = "default"
    if m not in ("int8", "int8_static"):
        raise ValueError(f"unknown quant mode: {quant}")
    return (m if cov in ("default", "all") else None), m, (m if cov == "all" else None)


class ResBlock(nn.Module):
    """Pre-activation bottleneck residual: [norm, relu, conv1x1, norm, relu,
    convkxk, norm, relu, conv1x1] + skip."""

    def __init__(self, features: int, kernel_size: int = 3, norm_method: str = "instance",
                 quant: str | None = None):
        super().__init__()
        f, h = features, features // 2
        self.conv = nn.Sequential(
            make_norm(norm_method, f), nn.ReLU(), Conv(f, h, 1, quant=quant),
            make_norm(norm_method, h), nn.ReLU(), Conv(h, h, kernel_size, quant=quant),
            make_norm(norm_method, h), nn.ReLU(), Conv(h, f, 1, quant=quant),
        )

    def forward(self, x):
        return x + self.conv(x)


class Hourglass(nn.Module):
    """Recursive encoder/decoder with a skip at every level."""

    def __init__(self, features: int, level: int = 4, norm_method: str = "instance",
                 quant: str | None = None):
        super().__init__()
        # the reference hourglass always uses 3x3 convs, whatever --filter_size is
        self.input_conv = ResBlock(features, 3, norm_method, quant)
        if level > 0:
            self.inner = Hourglass(features, level - 1, norm_method, quant)
        else:
            self.inner = ResBlock(features, 3, norm_method, quant)
        self.output_conv = ResBlock(features, 3, norm_method, quant)

    def forward(self, x):
        x = self.input_conv(x)
        h = self.inner(max_pool_2x2(x))
        return upsample_nearest_2x_add(self.output_conv(h), x)


class _Head(nn.Module):
    """4-conv regression head: [conv, norm, relu] * 3 + [conv]. The plane
    head also holds the learned per-joint softmax temperature ``w [J, 1]``.
    ``quant`` applies to the first three convs; the last one feeds the
    softmax's logits and stays full precision, as in the JAX package."""

    def __init__(self, features: int, out_features: int, kernel_size: int,
                 norm_method: str, temperature: bool, quant: str | None = None):
        super().__init__()
        layers = []
        for _ in range(3):
            layers += [Conv(features, features, kernel_size, quant=quant),
                       make_norm(norm_method, features), nn.ReLU()]
        self.conv = nn.Sequential(*layers, Conv(features, out_features, kernel_size))
        if temperature:
            self.w = nn.Parameter(torch.ones(out_features, 1))

    def forward(self, x):
        return self.conv(x)


class PredictionBlock(nn.Module):
    """1x1 projection -> hourglass -> plane and depth heads -> decoder.

    ``decoder='cuda'`` sends the softmax decode through the CUDA kernel
    wrapper (which runs its plain version for CPU tensors); ``'torch'`` runs
    the plain version. The ``sum`` heatmap method always runs the plain
    version, as in the JAX package. In train mode, or whenever grad mode is
    on, the kernel decoder takes f32 maps and returns f32 heatmaps and is
    differentiable (K1 forward, K2 backward); otherwise it keeps the maps'
    own dtype (the JAX package's inference fast boundary).
    """

    def __init__(self, in_channels: int, joints: int, features: int = 256, level: int = 4,
                 kernel_size: int = 3, norm_method: str = "instance",
                 heatmap_method: str = "softmax", decoder: str = "torch",
                 quant: str | None = None, paired_heads: bool = False,
                 paired_mid: str = "separate", paired_final: str = "separate"):
        super().__init__()
        if decoder not in ("torch", "cuda"):
            raise ValueError(f"unknown decoder: {decoder}")
        if heatmap_method not in ("softmax", "sum"):
            raise ValueError(f"unknown heatmap method: {heatmap_method}")
        if paired_mid not in MIDS or paired_final not in FINALS:
            raise ValueError(f"unknown pairing {paired_mid!r}/{paired_final!r}")
        self.heatmap_method = heatmap_method
        self.decoder = decoder
        self.paired = (paired_mid, paired_final) if paired_heads else None
        _, head_quant, hg_quant = parse_quant(quant)
        self.head_quant = head_quant
        # the projection stays full precision: from stage 2 on it reads the
        # softmax heatmaps (a tiny dynamic range), and it is cheap
        self.conv = Conv(in_channels, features, 1)
        self.hourglass = Hourglass(features, level, norm_method, hg_quant)
        self.plane_regression = _Head(features, joints, kernel_size, norm_method,
                                      temperature=heatmap_method == "softmax", quant=head_quant)
        self.depth_regression = _Head(features, joints, kernel_size, norm_method,
                                      temperature=False, quant=head_quant)

    def use_paired(self) -> bool:
        """Whether this forward takes the paired heads (JAX ``use_paired``)."""
        return (self.paired is not None and not self.training and self.head_quant is None
                and pairable(self.plane_regression) and pairable(self.depth_regression))

    def forward(self, x, label_img, mask):
        f = self.hourglass(self.conv(x))
        if self.use_paired():
            logits, depthmaps = paired_heads_apply(f, self.plane_regression,
                                                   self.depth_regression, *self.paired)
        else:
            logits = self.plane_regression(f)
            depthmaps = self.depth_regression(f)
        b, j, h, wd = logits.shape
        rows = [t.reshape(b, t.shape[1], h * wd).contiguous()
                for t in (logits, depthmaps, label_img, mask)]
        if self.heatmap_method == "softmax":
            w = self.plane_regression.w[:, 0]
            if self.decoder == "cuda" and (self.training or torch.is_grad_enabled()):
                # training: f32 maps in and f32 heatmaps out, through K1 and
                # K2, as the JAX package's custom VJP takes them
                heatmaps, uvd = cuda_softargmax.decode_flat(
                    *(t.to(torch.float32) for t in rows), w, h, wd)
            elif self.decoder == "cuda":
                # inference keeps the maps' own dtype at the boundary (bf16
                # heatmaps under mixed precision), as the JAX fast boundary does
                heatmaps, uvd = cuda_softargmax.decode_flat(*rows, w, h, wd,
                                                            hm_dtype=logits.dtype)
            else:
                heatmaps, uvd = soft_argmax_decode_flat(*rows, w, h, wd)
        else:
            heatmaps, uvd = soft_argmax_decode_flat(*rows, None, h, wd, method="sum")
        return heatmaps.reshape(b, j, h, wd), depthmaps, uvd


def _buffer_contexts(module: nn.Module):
    """``torch.utils.checkpoint``'s ``context_fn`` for a block whose
    train-mode forward updates buffers in place (the anchored norms'
    ``anchor``/``anchor_n``, BatchNorm's running statistics).

    The recompute in the backward runs on the buffers as the forward found
    them, so that it computes what the forward computed, and leaves them as
    the forward left them: the buffers move once a step, as under JAX's
    functional remat, not twice.
    """
    before = []

    @contextlib.contextmanager
    def forward():
        before[:] = [b.clone() for b in module.buffers()]
        yield

    @contextlib.contextmanager
    def recompute():
        buffers = list(module.buffers())
        after = [b.clone() for b in buffers]
        with torch.no_grad():
            for b, v in zip(buffers, before):
                b.copy_(v)
        try:
            yield
        finally:
            with torch.no_grad():
                for b, v in zip(buffers, after):
                    b.copy_(v)

    return forward(), recompute()


class PixelwiseRegression(nn.Module):
    """Flagship model. ``forward(img [B,1,2S,2S], label_img [B,1,S,S],
    mask [B,1,S,S])`` returns a list of per-stage (heatmaps ``[B,J,S,S]``,
    depthmaps ``[B,J,S,S]``, uvd ``[B,J,3]``).

    ``dtype`` is the activation dtype: img, label_img and mask are cast to it
    first, so under bf16 the decoder sees the bf16-rounded label image and
    mask, as in the JAX package.

    ``remat``: with grad enabled, each stage's activations are recomputed in
    the backward instead of kept (``torch.utils.checkpoint``, non-reentrant);
    the stage's forward, the decoder's K1 included, then runs twice a step,
    and its norms' buffers still move once (``_buffer_contexts``).

    ``quant`` (see ``parse_quant``) is for inference: a quantized model
    refuses a train-mode forward. ``paired_heads``, ``paired_mid`` and
    ``paired_final`` go to every ``PredictionBlock``.
    """

    def __init__(self, joints: int, stage: int = 2, features: int = 256, level: int = 4,
                 kernel_size: int = 3, norm_method: str = "instance",
                 heatmap_method: str = "softmax", decoder: str = "torch",
                 dtype: torch.dtype = torch.float32, remat: bool = False,
                 quant: str | None = None, paired_heads: bool = False,
                 paired_mid: str = "separate", paired_final: str = "separate"):
        super().__init__()
        self.dtype = dtype
        self.remat = remat
        self.level = level
        self.kernel_size = kernel_size
        self.norm_method = norm_method
        self.quant = None if quant in (None, "none") else quant
        stem_quant, _, _ = parse_quant(self.quant)
        # stem: 1 -> 32, feature-doubling kxk convs up to `features`, then a
        # stride-2 conv halving the spatial size. The first conv reads the
        # one-channel image and stays full precision
        widths = [32]
        while widths[-1] < features:
            widths.append(min(2 * widths[-1], features))
        layers, cin = [], 1
        for i, w in enumerate(widths):
            layers += [Conv(cin, w, kernel_size, quant=stem_quant if i > 0 else None),
                       make_norm(norm_method, w), nn.ReLU()]
            cin = w
        layers += [Conv(cin, features, kernel_size, stride=2, quant=stem_quant),
                   make_norm(norm_method, features), nn.ReLU()]
        self.conv = nn.Sequential(*layers)
        self.stages = nn.ModuleList(
            PredictionBlock(features if s == 0 else 2 * joints + 1, joints, features, level,
                            kernel_size, norm_method, heatmap_method, decoder, self.quant,
                            paired_heads, paired_mid, paired_final)
            for s in range(stage)
        )

    def calibrate(self, img, label_img, mask):
        """One inference forward that raises the static int8 convs' scales
        first (JAX: ``apply(..., mutable=["quant_scales"])``); returns its
        results."""
        with calibrating(self), torch.no_grad():
            return self(img, label_img, mask)

    def forward(self, img, label_img, mask):
        if self.training and self.quant:
            raise ValueError("quant is an inference-only path (round() kills gradients); "
                             "train with quant=None and quantize at serving time")
        label_img = label_img.to(self.dtype)
        mask = mask.to(self.dtype)
        f = self.conv(img.to(self.dtype))
        results = []
        for block in self.stages:
            if self.remat and torch.is_grad_enabled():
                heatmaps, depthmaps, uvd = checkpoint(
                    block, f, label_img, mask, use_reentrant=False,
                    context_fn=functools.partial(_buffer_contexts, block))
            else:
                heatmaps, depthmaps, uvd = block(f, label_img, mask)
            results.append((heatmaps, depthmaps, uvd))
            # next-stage input: concat(heatmaps, depthmaps, label_img) -> 2J+1
            f = torch.cat([heatmaps.to(self.dtype), depthmaps.to(self.dtype), label_img], dim=1)
        return results
