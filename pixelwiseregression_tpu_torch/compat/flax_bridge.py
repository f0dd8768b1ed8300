"""JAX package params -> the port's state dict.

``state_dict_from_flax`` is the inverse of
``pixelwiseregression_tpu/compat/torch_ckpt.py::convert_state_dict``: it takes
the JAX model's ``{"params", "batch_stats"}`` trees as numpy and returns a
state dict under the reference torch names, which the port's
``PixelwiseRegression`` loads natively:

* conv kernels transpose HWIO -> OIHW;
* norm ``scale``/``bias`` -> ``weight``/``bias``; BatchNorm ``mean``/``var`` ->
  ``running_mean``/``running_var`` (plus a zero ``num_batches_tracked``);
* the anchored norm's ``anchor``/``anchor_n`` keep their names (the forward
  converter does not carry them);
* FullRegression's dense kernels ``fc_i.dense.kernel`` ``[in, out]`` ->
  ``regression.{0,2,4}.weight`` ``[out, in]``, its ``down_conv_i`` /
  ``down_norm_i`` -> ``downsampling.{0,1,3,4,6,7}``;
* flax module names -> the reference's ``nn.Sequential`` indices, by the
  tables below (the inverse of the converter's).

One function serves both model families: their trees differ in module
names only (``proj`` is ``stages.N.conv`` in both).

``quant_scales_from_flax`` maps the JAX int8 model's calibrated
``quant_scales`` collection (``act_absmax_c`` of each static int8 conv) to
the port's conv module names, for ``models.layers.load_quant_scales``: the
port keeps those scales in non-persistent buffers, outside the state dict.

A gradient tree maps like a params tree: ``state_dict_from_flax({"params":
grads})`` names each gradient as the port names its parameter (the tests
compare a JAX train step's gradients with the port's this way).

numpy and torch only; it never imports jax.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

# ResBlock Sequential: [norm, relu, conv1x1, norm, relu, convkxk, norm, relu, conv1x1]
_RESBLOCK_IDX = {"norm_0": 0, "conv_0": 2, "norm_1": 3, "conv_1": 5, "norm_2": 6, "conv_2": 8}
# plane/depth head Sequential: [conv, norm, relu] * 3 + [conv]
_HEAD_IDX = {"conv_0": 0, "norm_0": 1, "conv_1": 3, "norm_1": 4, "conv_2": 6, "norm_2": 7,
             "conv_3": 9}
# FullRegressionBlock.downsampling: [conv, norm, relu] * 3
_DOWN_IDX = {"down_conv_0": 0, "down_norm_0": 1, "down_conv_1": 3, "down_norm_1": 4,
             "down_conv_2": 6, "down_norm_2": 7}
# FullRegressionBlock.regression: [linear, relu, linear, relu, linear]
_FC_IDX = {"fc_0": 0, "fc_1": 2, "fc_2": 4}
_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias", "mean": "running_mean",
         "var": "running_var", "anchor": "anchor", "anchor_n": "anchor_n"}


def _module_name(path: Tuple[str, ...]) -> str:
    """flax module path -> reference module name."""
    head, rest = path[0], path[1:]
    if head.startswith("stem_") and not rest:
        kind, k = head[len("stem_"):].rsplit("_", 1)
        return f"conv.{3 * int(k) + (0 if kind == 'conv' else 1)}"
    if head.startswith("stage_") and rest:
        stage = f"stages.{head[len('stage_'):]}"
        if rest == ("proj",):
            return f"{stage}.conv"
        if rest[0] == "hourglass" and rest[-1] in _RESBLOCK_IDX:
            return ".".join([stage, *rest[:-1], "conv", str(_RESBLOCK_IDX[rest[-1]])])
        if rest[0] in ("plane", "depth") and len(rest) == 2:
            return f"{stage}.{rest[0]}_regression.conv.{_HEAD_IDX[rest[1]]}"
        if rest[0] in _DOWN_IDX and len(rest) == 1:
            return f"{stage}.downsampling.{_DOWN_IDX[rest[0]]}"
        if rest[0] in _FC_IDX and len(rest) == 1:
            return f"{stage}.regression.{_FC_IDX[rest[0]]}"
    raise KeyError(f"no reference name for flax module {'/'.join(path)}")


def state_dict_from_flax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``{"params": ..., "batch_stats": ...}`` numpy trees -> reference-named state dict."""
    out: Dict[str, torch.Tensor] = {}

    def walk(tree: Mapping[str, Any], path: Tuple[str, ...]):
        for name, node in tree.items():
            if isinstance(node, Mapping):
                walk(node, path + (name,))
                continue
            value = np.array(node, np.float32)  # a writable copy for torch
            if name == "w" and len(path) == 1:
                key = f"stages.{path[0][len('stage_'):]}.plane_regression.w"
            else:
                module = path
                if path[-1] == "conv":  # the flax nn.Conv inside the Conv wrapper
                    module = path[:-1]
                    if name == "kernel":
                        value = value.transpose(3, 2, 0, 1)
                elif path[-1] == "dense":  # the flax nn.Dense inside _Dense
                    module = path[:-1]
                    if name == "kernel":
                        value = value.T
                key = f"{_module_name(module)}.{_LEAF[name]}"
                if name == "mean":
                    out[f"{_module_name(module)}.num_batches_tracked"] = torch.tensor(0)
            out[key] = torch.from_numpy(np.ascontiguousarray(value))

    for collection in ("params", "batch_stats"):
        walk(variables.get(collection, {}), ())
    return out


def quant_scales_from_flax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The ``quant_scales`` collection of ``variables`` -> ``{port conv module
    name: act_absmax_c [Cin]}``."""
    out: Dict[str, torch.Tensor] = {}

    def walk(tree: Mapping[str, Any], path: Tuple[str, ...]):
        for name, node in tree.items():
            if isinstance(node, Mapping):
                walk(node, path + (name,))
            elif name == "act_absmax_c" and path[-1] == "conv":
                out[_module_name(path[:-1])] = torch.from_numpy(np.array(node, np.float32))
            else:
                raise KeyError(f"unknown quant_scales entry {'/'.join(path + (name,))}")

    walk(variables.get("quant_scales", {}), ())
    return out
