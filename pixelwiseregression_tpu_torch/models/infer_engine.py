"""Fused inference engines for the port's ``PixelwiseRegression``
(counterpart of ``pixelwiseregression_tpu/models/infer_engine.py``).

Two forwards equivalent to the model's eval-mode forward, instance norm
only, which differ in what runs inside a kernel:

* ``make_unit_fused_apply``: every conv + instance-norm pair of the stem's
  stride-1 convs, of the hourglass ResBlocks at ``min_res`` and above, and
  of the heads' first three convs is one K3 unit (``ops/cuda_fused.py``);
* ``make_fused_apply``: each stage's whole hourglass is one K4 call
  (``ops/cuda_hourglass.py``), with K4's own numerics.

What the JAX engines compute outside any Pallas kernel runs here as plain
PyTorch (``F.conv2d`` and the plain two-pass norm): the stem's first and
stride-2 convs, ResBlocks below ``min_res``, each head's last conv, the
projection conv, and the fused engine's stem and heads. The decoder takes
f32 maps, as the JAX engines call it; ``decoder="cuda"`` blocks decode
through K1 (``ops/cuda_softargmax.py``).

The builders snapshot the model's weights, as the JAX builders close over
their variables: rebuild after changing them. They turn TF32 off
(``core.precision.tf32_off``), as ``Predictor`` does. Inside, activations
run NHWC: ``channels_last`` tensors, which the kernels see as contiguous
``[B, H, W, C]`` views. ``plain=True`` runs the kernels' plain versions on
any device (the counterpart of the JAX builders' interpret mode).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pixelwiseregression_tpu_torch.core.precision import tf32_off
from pixelwiseregression_tpu_torch.models.layers import (
    InstanceNorm,
    _InstanceNormFn,
    max_pool_2x2,
    upsample_nearest_2x_add,
)
from pixelwiseregression_tpu_torch.ops import cuda_fused, cuda_hourglass, cuda_softargmax
from pixelwiseregression_tpu_torch.ops.softargmax import soft_argmax_decode_flat


def _cl(t):
    return t.contiguous(memory_format=torch.channels_last)


def _nhwc(t):
    """An NCHW tensor as a contiguous NHWC view (channels_last storage)."""
    return _cl(t).permute(0, 2, 3, 1)


def _nchw(t):
    return t.permute(0, 3, 1, 2)


def _conv_leaf(m, dtype):
    w = m.weight.detach().clone()
    return {"weight": w, "bias": m.bias.detach().clone(),
            "kernel": w.permute(2, 3, 1, 0).to(dtype).contiguous()}  # HWIO, for the kernels


def _norm_leaf(m):
    return {"weight": m.weight.detach().clone(), "bias": m.bias.detach().clone()}


def _resblock_tree(rb, dtype):
    # ResBlock.conv: [norm, relu, conv1x1, norm, relu, conv3x3, norm, relu, conv1x1]
    seq = rb.conv
    return {"norm_0": _norm_leaf(seq[0]), "conv_0": _conv_leaf(seq[2], dtype),
            "norm_1": _norm_leaf(seq[3]), "conv_1": _conv_leaf(seq[5], dtype),
            "norm_2": _norm_leaf(seq[6]), "conv_2": _conv_leaf(seq[8], dtype)}


def _hourglass_tree(hg, level, dtype):
    inner = (_hourglass_tree(hg.inner, level - 1, dtype) if level > 0
             else _resblock_tree(hg.inner, dtype))
    return {"input_conv": _resblock_tree(hg.input_conv, dtype), "inner": inner,
            "output_conv": _resblock_tree(hg.output_conv, dtype)}


def _head_tree(head, dtype):
    # _Head.conv: [conv, norm, relu] * 3 + [conv]
    tree = {f"conv_{i}": _conv_leaf(head.conv[3 * i], dtype) for i in range(4)}
    tree.update({f"norm_{i}": _norm_leaf(head.conv[3 * i + 1]) for i in range(3)})
    return tree


def _params(model, *, hourglass: bool):
    """The model's weights as the JAX engines' param tree names them."""
    dtype = model.dtype
    n_stem = len(model.conv) // 3  # [conv, norm, relu] per stem layer
    tree = {}
    for i in range(n_stem):
        tree[f"stem_conv_{i}"] = _conv_leaf(model.conv[3 * i], dtype)
        tree[f"stem_norm_{i}"] = _norm_leaf(model.conv[3 * i + 1])
    for s, block in enumerate(model.stages):
        tree[f"stage_{s}"] = {
            "proj": _conv_leaf(block.conv, dtype),
            "plane": _head_tree(block.plane_regression, dtype),
            "depth": _head_tree(block.depth_regression, dtype),
            "w": (block.plane_regression.w.detach()[:, 0].float().clone()
                  if block.heatmap_method == "softmax" else None),
        }
        if hourglass:
            tree[f"stage_{s}"]["hourglass"] = _hourglass_tree(block.hourglass, model.level, dtype)
    return tree, n_stem


def _check_supported(model, name):
    norms = [m for m in model.modules() if isinstance(m, InstanceNorm)]
    if model.norm_method != "instance" or any(m.method != "instance" for m in norms):
        raise ValueError(f"{name} supports instance norm only, got {model.norm_method}")
    if model.quant:
        raise ValueError(f"{name} does not support quantized models, got {model.quant}")


def _conv(x, p, *, stride: int = 1, dtype):
    """The plain conv: ``models.layers.Conv`` (k//2 padding, weight and
    bias cast to the activation dtype)."""
    k = p["weight"].shape[-1]
    return F.conv2d(x.to(dtype), p["weight"].to(dtype), p["bias"].to(dtype), stride, k // 2)


def _inorm_relu(x, p, dtype):
    """The plain two-pass instance norm (``models.layers.InstanceNorm``) + relu."""
    y, _ = _InstanceNormFn.apply(x, p["weight"], p["bias"], None, "instance", InstanceNorm.eps)
    return torch.relu(y).to(dtype)


def _head(x, p, dtype):
    """4-conv regression head, plain (reference model.py:54-65)."""
    for i in range(3):
        x = _inorm_relu(_conv(x, p[f"conv_{i}"], dtype=dtype), p[f"norm_{i}"], dtype)
    return _conv(x, p["conv_3"], dtype=dtype)


def _decode(block, stage, logits, depthmaps, label, mask):
    """The stage's decoder on f32 maps; heatmaps ``[B, J, S, S]`` f32, uvd ``[B, J, 3]``."""
    b, j, h, wd = logits.shape
    rows = [t.float().reshape(b, t.shape[1], h * wd).contiguous()
            for t in (logits, depthmaps, label, mask)]
    if block.heatmap_method != "softmax":
        hm, uvd = soft_argmax_decode_flat(*rows, None, h, wd, method="sum")
    elif block.decoder == "cuda":
        hm, uvd = cuda_softargmax.decode_flat(*rows, stage["w"], h, wd)
    else:
        hm, uvd = soft_argmax_decode_flat(*rows, stage["w"], h, wd)
    return hm.reshape(b, j, h, wd), uvd


def _stages(model, params, img, label_img, mask, stem, hourglass, head):
    """The forward around the engine's stem, hourglass and head."""
    dtype = model.dtype
    with torch.inference_mode():
        label = label_img.to(dtype)
        mask_c = mask.to(dtype)
        f = stem(_cl(img.to(dtype)))
        results = []
        for s, block in enumerate(model.stages):
            sp = params[f"stage_{s}"]
            h = hourglass(_cl(_conv(f, sp["proj"], dtype=dtype)), s)
            logits, depthmaps = head(h, sp["plane"]), head(h, sp["depth"])
            heatmaps, uvd = _decode(block, sp, logits, depthmaps, label, mask_c)
            results.append((heatmaps, depthmaps, uvd))
            f = _cl(torch.cat([heatmaps.to(dtype), depthmaps.to(dtype), label], dim=1))
        return results


def make_unit_fused_apply(model, *, min_res: int = 32, plain: bool = False):
    """Build ``fn(img, label_img, mask) -> [(heatmaps, depthmaps, uvd)]``
    (NCHW in, as ``PixelwiseRegression.forward`` takes them and returns
    them) with every conv + instance-norm pair fused into one K3 unit:

    * stem: conv_0 stays plain (1-channel input); conv_1 fuses norm_0 as
      prologue and norm_1 as epilogue; later stride-1 convs fuse their
      epilogue norm; the stride-2 conv and its norm stay plain;
    * hourglass ResBlocks at resolution >= ``min_res``: three prologue
      units, the last with the residual add; below it, plain;
    * heads: conv_0..2 fuse their epilogue norms; conv_3 stays plain.
    """
    _check_supported(model, "unit-fused engine")
    if model.kernel_size != 3:
        raise ValueError("unit-fused engine supports kernel_size=3 only")
    tf32_off()
    params, n_stem = _params(model, hourglass=True)
    dtype = model.dtype
    chain = cuda_fused.fused_chain_plain if plain else cuda_fused.fused_chain

    def unit(x, cp, pro=None, epi=None, skip=None):
        u = {"kernel": cp["kernel"], "bias": cp["bias"]}
        if pro is not None:
            u["pro"] = (pro["weight"], pro["bias"])
        if epi is not None:
            u["epi"] = (epi["weight"], epi["bias"])
        return _nchw(chain(_nhwc(x), [u], skip=None if skip is None else _nhwc(skip)))

    def resblock(x, p):
        if x.shape[2] < min_res:
            h = _conv(_inorm_relu(x, p["norm_0"], dtype), p["conv_0"], dtype=dtype)
            h = _conv(_inorm_relu(h, p["norm_1"], dtype), p["conv_1"], dtype=dtype)
            return x + _conv(_inorm_relu(h, p["norm_2"], dtype), p["conv_2"], dtype=dtype)
        h = unit(x, p["conv_0"], pro=p["norm_0"])
        h = unit(h, p["conv_1"], pro=p["norm_1"])
        return unit(h, p["conv_2"], pro=p["norm_2"], skip=x)

    def hourglass(x, p, lvl):
        x1 = resblock(x, p["input_conv"])
        h = max_pool_2x2(x1)
        h = hourglass(h, p["inner"], lvl - 1) if lvl > 0 else resblock(h, p["inner"])
        return _cl(upsample_nearest_2x_add(resblock(h, p["output_conv"]), x1))

    def head(x, p):
        for i in range(3):
            x = unit(x, p[f"conv_{i}"], epi=p[f"norm_{i}"])
        return _conv(x, p["conv_3"], dtype=dtype)

    def stem(x):
        x = _conv(x, params["stem_conv_0"], dtype=dtype)
        if n_stem >= 3:
            x = unit(x, params["stem_conv_1"], pro=params["stem_norm_0"],
                     epi=params["stem_norm_1"])
            for i in range(2, n_stem - 1):
                x = unit(x, params[f"stem_conv_{i}"], epi=params[f"stem_norm_{i}"])
        else:
            x = _inorm_relu(x, params["stem_norm_0"], dtype)
        i = n_stem - 1
        x = _conv(x, params[f"stem_conv_{i}"], stride=2, dtype=dtype)
        return _inorm_relu(x, params[f"stem_norm_{i}"], dtype)

    def fn(img, label_img, mask):
        return _stages(model, params, img, label_img, mask, stem,
                       lambda h, s: hourglass(h, params[f"stage_{s}"]["hourglass"], model.level),
                       head)

    return fn


def make_fused_apply(model, *, plain: bool = False):
    """Build ``fn(img, label_img, mask) -> [(heatmaps, depthmaps, uvd)]``
    (NCHW, as ``PixelwiseRegression.forward``) with each stage's hourglass
    one K4 call; the stacked hourglass weights are made here, once."""
    _check_supported(model, "fused engine")
    tf32_off()
    params, n_stem = _params(model, hourglass=False)
    dtype = model.dtype
    run = cuda_hourglass.hourglass_fused_plain if plain else cuda_hourglass.hourglass_fused
    stacked = []
    for block in model.stages:
        st = cuda_hourglass.stack_hourglass_params(block.hourglass, model.level)
        stacked.append({k: v.to(dtype) if k in ("w0", "w1", "w2") else v for k, v in st.items()})

    def stem(x):
        for i in range(n_stem):
            x = _conv(x, params[f"stem_conv_{i}"], stride=2 if i == n_stem - 1 else 1, dtype=dtype)
            x = _inorm_relu(x, params[f"stem_norm_{i}"], dtype)
        return x

    def fn(img, label_img, mask):
        return _stages(model, params, img, label_img, mask, stem,
                       lambda h, s: _nchw(run(_nhwc(h), stacked[s], model.level)),
                       lambda h, p: _head(h, p, dtype))

    return fn
