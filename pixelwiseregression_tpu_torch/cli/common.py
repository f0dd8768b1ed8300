"""Shared CLI plumbing: reference-compatible argparse surfaces
(mirrors ``pixelwiseregression_tpu/cli/common.py``).

Flag names and defaults are the JAX package's, so existing invocations keep
working, with these differences:

* ``--decoder`` takes ``cuda`` (the K1/K2 kernels, the default) or
  ``torch`` (the plain decoder); the JAX spellings ``pallas`` and ``xla``
  name the same two;
* ``--device cuda|cpu`` (default ``cuda``) and ``--gpu_id`` pick the card
  (``cuda:<gpu_id>``); with no card visible and no ``--device cpu`` the CLI
  stops with an error, it never moves to the CPU by itself;
* ``--profile DIR`` writes a ``torch.profiler`` trace of steps 3-6;
* the TPU-only flags (``--compiler_opts``, ``--matmul_precision``,
  ``--no_compile_cache``) are not ported.

The test CLIs' ``--quant int8[_static][_all|_heads]`` runs the int8 model
(``models/layers.py``); a static mode calibrates on the first
``--quant_calib_batches`` test batches. A quantized model refuses to train.

``fullregression=True`` gives the FullRegression CLIs' surfaces, which drop
the flags the JAX package drops there (``--heatmap_method``,
``--lambda_*``, ``--alpha``, ``--filter_size``, ``--quant*``,
``--process_mode``); their default ``--suffix`` is ``full_regression``.
"""

from __future__ import annotations

import argparse
import os

import torch

# the JAX package's decoder names -> the port's
DECODERS = {"cuda": "cuda", "torch": "torch", "pallas": "cuda", "xla": "torch"}


def _bool01(x: str) -> bool:
    return [False, True][int(x)]


def add_model_args(p: argparse.ArgumentParser):
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--label_size", type=int, default=64)
    p.add_argument("--kernel_size", type=int, default=7)
    p.add_argument("--sigmoid", type=float, default=1.5)
    p.add_argument("--norm_method", type=str, default="instance_anchored",
                   help="choose from batch, instance_anchored (default: one-pass "
                        "statistics around calibrated per-channel anchors, kept as "
                        "buffers in the checkpoint; a checkpoint without them runs the "
                        "exact two-pass form), instance (two-pass variance) and "
                        "instance_fast (raw one-pass: unsafe on near-constant channels)")
    p.add_argument("--stages", type=int, default=2)
    p.add_argument("--features", type=int, default=128)
    p.add_argument("--level", type=int, default=4)


def add_device_args(p: argparse.ArgumentParser):
    g = p.add_argument_group("device")
    g.add_argument("--decoder", type=str, default="cuda", choices=sorted(DECODERS),
                   help="soft-argmax decoder: cuda (the K1/K2 kernels) or torch (plain); "
                        "pallas and xla are the JAX package's names for the same two")
    g.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="run on the card (cuda:<gpu_id>) or on the CPU")
    g.add_argument("--data_path", type=str, default=None,
                   help="dataset root (default Data/<dataset>)")
    g.add_argument("--no_strict_quirks", action="store_true",
                   help="fix reference quirks (honor --using_rotation, working flip)")
    g.add_argument("--bf16", action="store_true", help="bfloat16 activations")
    g.add_argument("--aug_fallback", type=str, default="clean", choices=["clean", "drop"],
                   help="failed-augmentation policy: 'clean' = reference fallback to the "
                        "unaugmented sample; 'drop' = mask from loss")
    g.add_argument("--remat", action="store_true",
                   help="recompute each prediction block in the backward (less "
                        "activation memory, larger batches)")
    g.add_argument("--profile", type=str, default=None, metavar="DIR",
                   help="write a torch.profiler trace of training steps 3-6 into DIR")
    g.add_argument("--resume", type=str, default=None, metavar="CKPT",
                   help="resume training from a port .pt or a JAX .ckpt (params, "
                        "optimizer state, step)")


def make_train_parser(dataset_default: str = "NYU", suffix_default: str = "default",
                      msra: bool = False, fullregression: bool = False):
    p = argparse.ArgumentParser()
    p.add_argument("--suffix", type=str, default=suffix_default,
                   help="the suffix of model file and log file")
    if msra:
        p.add_argument("--subject", type=int, default=0)
    else:
        p.add_argument("--dataset", type=str, default=dataset_default,
                       help="choose from MSRA, ICVL, NYU, HAND17")
    p.add_argument("--seed", type=int, default=0,
                   help="the random seed used in the training, 0 means do not use fix seed")
    add_model_args(p)
    if not fullregression:
        p.add_argument("--heatmap_method", type=str, default="softmax",
                       help="choose from softmax and sum")
        p.add_argument("--lambda_h", type=float, default=1.0)
        p.add_argument("--lambda_d", type=float, default=0.01)
        p.add_argument("--alpha", type=float, default=1.0)
        p.add_argument("--filter_size", type=int, default=3)
    p.add_argument("--using_rotation", type=_bool01, default=True)
    p.add_argument("--using_scale", type=_bool01, default=True)
    p.add_argument("--using_shift", type=_bool01, default=True)
    p.add_argument("--using_flip", type=_bool01, default=False)
    if not msra:
        p.add_argument("--small", action="store_true")
    p.add_argument("--gpu_id", type=str, default="0", help="the card: cuda:<gpu_id>")
    p.add_argument("--epoch", type=int, default=50)
    p.add_argument("--num_workers", type=int, default=9999)
    p.add_argument("--opt", type=str, default="adam", help="choose from adam and sgd")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--beta1", type=float, default=0.9)
    p.add_argument("--beta2", type=float, default=0.999)
    p.add_argument("--weight_decay", type=float, default=0)
    p.add_argument("--mixed_precision", action="store_true",
                   help="mixed precision training (bf16 activations)")
    p.add_argument("--lr_decay", type=float, default=0.2)
    p.add_argument("--decay_epoch", type=float, default=15)
    add_device_args(p)
    return p


def make_test_parser(dataset_default: str = "MSRA", msra: bool = False,
                     fullregression: bool = False):
    p = argparse.ArgumentParser()
    p.add_argument("--suffix", type=str,
                   default="full_regression" if fullregression else "default",
                   help="the suffix of model file and log file")
    if msra:
        p.add_argument("--subject", type=int, default=0)
    else:
        p.add_argument("--dataset", type=str, default=dataset_default,
                       help="choose from MSRA, ICVL, NYU, HAND17")
    add_model_args(p)
    if not fullregression:
        p.add_argument("--heatmap_method", type=str, default="softmax",
                       help="choose from softmax and sum")
        p.add_argument("--filter_size", type=int, default=3)
        if not msra:
            p.add_argument("--process_mode", type=str, default="uvd",
                           help="choose from uvd and bb")
        p.add_argument("--quant", type=str, default="none",
                       help="int8 inference quantization, 'int8[_static][_all|_heads]': "
                            "coverage stem+heads / +hourglass / heads only; '_static' uses "
                            "per-channel scales calibrated over --quant_calib_batches. Same "
                            "checkpoint serves every mode")
        p.add_argument("--quant_calib_batches", type=int, default=4,
                       help="batches used to calibrate static int8 activation scales "
                            "(running per-channel |x| max)")
    p.add_argument("--gpu_id", type=str, default="0", help="the card: cuda:<gpu_id>")
    p.add_argument("--num_workers", type=int, default=9999)
    p.add_argument("--seed", type=str, default="final")
    p.add_argument("--skip_bad_samples", action="store_true",
                   help="warn and keep undecodable test samples' rows as NaN instead of "
                        "aborting (test lists are never validity-checked)")
    add_device_args(p)
    return p


def resolve_num_workers(n: int) -> int:
    return min(n, os.cpu_count() or 1)


def resolve_device(args) -> torch.device:
    """``cuda:<gpu_id>`` or the CPU, as ``--device`` asks; raises if the card is
    asked for and none is visible."""
    if getattr(args, "device", "cuda") == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is visible "
                           "(pass --device cpu to run on the CPU)")
    return torch.device(f"cuda:{int(getattr(args, 'gpu_id', '0') or 0)}")


def model_kwargs_from_args(args, joints: int, fullregression: bool = False) -> dict:
    """``PixelwiseRegression``'s (``FullRegression``'s) keyword arguments
    from the parsed flags."""
    quant = getattr(args, "quant", "none")
    bf16 = getattr(args, "bf16", False) or getattr(args, "mixed_precision", False)
    if fullregression:
        return dict(joints=joints, stage=args.stages, label_size=args.label_size,
                    features=args.features, level=args.level, norm_method=args.norm_method,
                    dtype=torch.bfloat16 if bf16 else torch.float32,
                    remat=getattr(args, "remat", False))
    return dict(
        joints=joints,
        stage=args.stages,
        features=args.features,
        level=args.level,
        kernel_size=args.filter_size,
        norm_method=args.norm_method,
        heatmap_method=args.heatmap_method,
        decoder=DECODERS[args.decoder],
        dtype=torch.bfloat16 if bf16 else torch.float32,
        remat=getattr(args, "remat", False),
        quant=None if quant in (None, "none") else quant,
    )


def make_model_param(model_kw: dict, label_size: int) -> dict:
    """The checkpoint's ``model_param``: the JAX package's keys and value types
    (``dtype`` by name), which ``serve.Predictor`` reads."""
    param = dict(model_kw, label_size=label_size)
    param["dtype"] = str(model_kw["dtype"]).replace("torch.", "")
    return param
