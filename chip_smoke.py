#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (pixelwiseregression_tpu_torch) on one GPU.

Run from the root of the repository on a machine with one CUDA card:

    python3 chip_smoke.py

It builds every kernel of the port from csrc/, one nvcc process per source,
all started together (K1 and K2, the soft-argmax decoder's forward and
backward; K3, the fused conv + instance-norm unit; K4, the whole
hourglass; K5, the norm+relu backward; K6, the ablation pieces), then:

1. K1, the forward kernel, at the serving and training shapes
   ([32|128|256, 14, 64*64], f32 and bf16-in/bf16-heatmap), against its
   plain PyTorch version, timed with CUDA events;
2. K2, the backward kernel, through the decoder's autograd.Function at
   [32|128, 14, 64*64] f32 with one all-zero mask row, against autograd of
   the plain decoder: dx, ddm, dlabel and dw, and the backward alone and
   forward + backward timed for both;
3. the serving path: the full-width default model (NYU: 14 joints, 2 stages,
   128 features, level 4, instance_anchored norm, bf16, batch 32) on
   weights made from a seed answers four requests of synthetic 480x640
   frames through K1, checked against the plain decoder and timed;
4. a small f32 Predictor on the card against the same model on the CPU;
5. the training path (the main path of this script): the same full-width
   model, bf16, batch 128, augmented, takes 10 train steps through K1 and
   K2 on synthetic 480x640 frames, each step launching both kernels once
   per stage; its first step is repeated with the plain decoder from the
   same weights, batch and draws; steps/s, frames/s and the step's parts
   are timed for both decoders in turns; one eval step reports mean mm;
6. the CLI's f32 default (batch 32) takes three steps through the kernels;
7. one f32 train step of a small model on the card against the CPU;
8. K3 against its plain version at batch 256, bf16, for every unit kind
   that the unit engine launches at full width (and one f32 case), with
   cuDNN's conv alone at the same shape as a partial yardstick;
9. K4 against its plain version at [256, 64, 64, 128] bf16, level 4;
10. both fused inference engines end to end at full width (NYU: 14
   joints, 2 stages, 128 features, level 4, instance norm, bf16, batch 64)
   on weights made from a seed: the unit engine through 32 K3 and 2 K1
   launches per forward, the fused engine through 2 K4 and 2 K1, each
   against the same engine on the kernels' plain versions and against the
   model's own forward, and frames/s of all three;
11. a small f32 model with both engines on the card against the CPU;
12. K5 against its plain version at [128, 64, 64, 128] bf16 and one f32
   case, each with a channel at scale = bias = 0, timed beside ATen's
   autograd backward of relu(instance_norm);
13. each K6 piece (copy, build_xm and its probes, xm_dots, K3's statistics
   and apply alone) at the head shape, batch 256, against its plain
   version, timed beside Tensor.copy_ and three torch.matmul calls;
14. the tools slice: the five A/B and ablation tools of the port
   (pixelwiseregression_tpu_torch/tools) at their default shapes with few
   rounds, each through its kernels, with the launches of K5, K3 and each
   K6 piece asserted.

With --profile it builds the kernels and profiles the train step of 5.
instead (phase_profile): the breakdown that PERF.md's "Where the time goes"
quotes.

The script exits non-zero, printing no result, when no CUDA device is
visible or any check fails. Its last line is a JSON object naming the card;
the line before it lists the kernels with their launches on each path
(serve, train, unit_engine, fused_engine, tools), their times, their plain
versions' and a library call's, and their bounds: the larger of the bytes
they must move over 3.35 TB/s and their operations over the peak rate of
their type (989 TFLOP/s bf16 tensor cores, 67 TFLOP/s f32), for an H100 SXM.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
H = W = 64          # label_size: the decoder's map side
J = 14              # NYU joints
STAGES = 2
REQUEST_SIZES = (32, 17, 1, 32)
# serving: the plain and kernel decoders feed stage 2 with bf16 heatmaps
# that may differ by 1 ulp; the resulting gap in normalized uvd is expected
# near 1e-4 and bounded here at 1e-3
NORM_GAP_BOUND = 1e-3
TRAIN_BATCH = 128
TRAIN_STEPS = 10
# training, first step from the same weights, batch and draws, kernels vs
# plain decoder (bf16 activations, f32 decoder boundary). Written before the
# first run: the two decoders' f32 outputs differ by ~1e-7 relative, so the
# stage-2 input differs in a few 1-ulp bf16 heatmap values; the loss is
# expected within 1e-5 relative (bound 1e-3), and the whole gradient within
# ~1e-2 relative of the plain decoder's (bound 1e-1), since ReLU inputs near
# zero may flip sign between the two roundings and move whole entries
LOSS_GAP_BOUND = 1e-3
GRAD_GAP_BOUND = 1e-1
UNIT_BATCH = 256    # K3 and K4 alone, at bench.py's batch
ENGINE_BATCH = 64   # the engines end to end
FEATURES, LEVEL = 128, 4
# K3 vs its plain version, bf16: at most this many bf16 ulps of the
# output's largest magnitude (both accumulate in f32 in another order; a
# flip of one rounding moves the statistics of what follows)
UNIT_ULPS = 2.0
# K4 vs its plain version: f32 within 1e-4 of the output's scale (the same
# arithmetic in another order); bf16 within the plain version's own
# bf16-vs-f32 gap, both as relative L2 norms. K4 applies each norm in bf16
# (x*a and + b rounded apart), so one flipped rounding early in a sample
# moves the whole sample by a few ulps: a per-element bound cannot hold
# (the first run read 15.25 ulps of the scale against the 8 predicted)
# the engines, kernels vs the same engine on the plain versions, per-stage
# uvd: 2e-2 (the JAX bf16 engine tests' bound, tests/test_infer_engine.py:
# 77-80) or twice the plain engine's own bf16-vs-f32 gap, whichever is
# larger. Written before the first run: expected ~1e-2 at stage 1 and a
# few 1e-2 at stage 2 (random weights: the instance norms amplify one
# flipped rounding; a 2-stage level-2 model on the card parted by 0.065)
ENGINE_GAP_BOUND = 2e-2
# each engine vs the model's own forward, stage 1: 5e-2 (the bound of
# tests/test_infer_engine.py:117-120) or twice the plain engine's own
# bf16-vs-f32 gap; stage 2 is printed, not bounded. Expected ~2e-2 (unit)
# and ~5e-2 (fused, whose K4 applies its norms in bf16) at stage 1, and
# 0.05-0.3 at stage 2
MODEL_GAP_BOUND = 5e-2
# --profile: device time by kernel name, lowercased; the first group whose
# substring a name holds takes it, the rest is "other"
PROFILE_GROUPS = (
    ("decoder K1 + K2", ("softargmax", "dlabel_kernel")),
    ("cuDNN layout NCHW<->NHWC", ("nchwtonhwc", "nhwctonchw")),
    ("convolution", ("conv", "xmma", "cutlass", "gemm", "cudnn", "sm90")),
    ("optimizer (foreach)", ("multi_tensor_apply",)),
    ("reduction", ("reduce",)),
    ("cast / copy", ("copy_kernel",)),
    ("elementwise", ("elementwise",)),
)


def _median_ms(fn, runs=7, iters=20):
    """Median over ``runs`` of the mean time of ``iters`` back-to-back calls, by CUDA events."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def phase_kernel(cs, plain, device):
    """Kernel vs plain version on the card; returns the main path's case."""
    gen = torch.Generator(device=device).manual_seed(SEED)
    cases = {}
    for b in (32, 128, 256):
        for dtype in (torch.float32, torch.bfloat16):
            hw = H * W
            x = (3 * torch.randn(b, J, hw, generator=gen, device=device)).to(dtype)
            dm = torch.randn(b, J, hw, generator=gen, device=device).to(dtype)
            label = torch.randn(b, 1, hw, generator=gen, device=device).to(dtype)
            mask = (torch.rand(b, 1, hw, generator=gen, device=device) > 0.4).to(dtype)
            w = torch.rand(J, generator=gen, device=device) + 0.5

            def kernel():
                return cs.decode_flat(x, dm, label, mask, w, H, W, hm_dtype=dtype)

            def reference():
                hm, uvd = plain(x, dm, label, mask, w, H, W)
                return hm.to(dtype), uvd

            hm_k, uvd_k = kernel()
            hm_p, uvd_p = reference()
            torch.cuda.synchronize()
            if dtype == torch.float32:
                # both compute in f32; only the summation order differs
                torch.testing.assert_close(hm_k, hm_p, rtol=1e-5, atol=1e-8)
            else:
                # p >= 0, so bf16 bit patterns order like the values: 1 ulp = 1 step
                ulps = (hm_k.view(torch.int16).int() - hm_p.view(torch.int16).int()).abs().max()
                assert int(ulps) <= 1, f"bf16 heatmaps differ by {int(ulps)} ulp"
            torch.testing.assert_close(uvd_k, uvd_p, rtol=1e-5, atol=1e-6)
            err = max(float((hm_k.float() - hm_p.float()).abs().max()),
                      float((uvd_k - uvd_p).abs().max()))
            ms, plain_ms = _median_ms(kernel), _median_ms(reference)
            name = "f32" if dtype == torch.float32 else "bf16"
            print(f"kernel softargmax_fwd [{b},{J},{hw}] {name}: max_abs_err={err:.3e} "
                  f"kernel_ms={ms:.5f} plain_ms={plain_ms:.5f}")
            cases[(b, name)] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
    return cases


def _requests(spec):
    from pixelwiseregression_tpu_torch.utils.synth import make_synthetic_raw_batch

    out = []
    for i, n in enumerate(REQUEST_SIZES):
        raw = make_synthetic_raw_batch(n, spec.frame_h, spec.frame_w, spec.joint_number,
                                       fx=spec.camera.fx, fy=spec.camera.fy,
                                       cube=spec.cube_size, com_z=450.0 + 50.0 * i,
                                       seed=SEED + i)
        out.append(raw)
    return out


def _fps(pred, raw, reps=5):
    pred.predict(raw["frame"], raw["com"])
    t = time.perf_counter()
    for _ in range(reps):
        pred.predict(raw["frame"], raw["com"])
    return reps * raw["frame"].shape[0] / (time.perf_counter() - t)


def phase_serve(cs, device):
    """The serving path at full width; returns the kernel launches of its main run."""
    from pixelwiseregression_tpu_torch.data.sources import SPECS
    from pixelwiseregression_tpu_torch.models.pixelwise import PixelwiseRegression
    from pixelwiseregression_tpu_torch.serve import Predictor

    spec = SPECS["NYU"]
    torch.manual_seed(SEED)
    state = PixelwiseRegression(spec.joint_number, stage=STAGES, features=128, level=4,
                                kernel_size=3, norm_method="instance_anchored").state_dict()
    rng = np.random.RandomState(SEED)
    for k, v in state.items():
        if k.endswith(".anchor"):
            state[k] = torch.from_numpy(rng.normal(0.0, 0.5, v.shape).astype(np.float32))
        elif k.endswith(".anchor_n"):
            state[k] = torch.tensor(float(rng.randint(1, 20)))
    kw = dict(batch_size=32, stages=STAGES, features=128, level=4, label_size=64,
              norm_method="instance_anchored", heatmap_method="softmax", filter_size=3,
              dtype=torch.bfloat16)
    preds = {d: Predictor.from_state_dict(state, "NYU", device, decoder=d, **kw)
             for d in ("cuda", "torch")}
    requests = _requests(spec)

    cs.LAUNCHES = 0
    outs = []
    for raw in requests:
        before = cs.LAUNCHES
        outs.append(preds["cuda"].predict(raw["frame"], raw["com"]))
        assert cs.LAUNCHES - before == STAGES, f"{cs.LAUNCHES - before} launches for one request"
    torch.cuda.synchronize()
    launches = cs.LAUNCHES
    assert launches == STAGES * len(requests), launches

    gap_px = gap_mm = gap_norm = 0.0
    for raw, out in zip(requests, outs):
        n = raw["frame"].shape[0]
        for key in ("uvd", "xyz"):
            assert out[key].shape == (n, spec.joint_number, 3), out[key].shape
            assert np.isfinite(out[key]).all(), f"non-finite {key}"
        ref = preds["torch"].predict(raw["frame"], raw["com"])
        d = np.abs(out["uvd"] - ref["uvd"])
        box = raw["box_size"][:, None].astype(np.float64) - 1.0
        cube = raw["cube"][:, None].astype(np.float64)
        gap_px = max(gap_px, float(d[..., :2].max()))
        gap_mm = max(gap_mm, float(d[..., 2].max()), float(np.abs(out["xyz"] - ref["xyz"]).max()))
        gap_norm = max(gap_norm, float((d[..., 0] / box).max()), float((d[..., 1] / box).max()),
                       float((d[..., 2] / cube).max()))
    print(f"serve NYU stages={STAGES} bf16 batch=32 requests={list(REQUEST_SIZES)}: "
          f"launches={launches} largest gap cuda vs torch decoder: "
          f"{gap_norm:.3e} normalized, {gap_px:.4f} px, {gap_mm:.4f} mm")
    assert gap_norm <= NORM_GAP_BOUND, f"decoders disagree by {gap_norm:.3e} normalized"

    fps = {"cuda": [], "torch": []}
    for rep in range(4):
        for d in (("cuda", "torch") if rep % 2 == 0 else ("torch", "cuda")):
            fps[d].append(_fps(preds[d], requests[0]))
    for d, vals in fps.items():
        print(f"serve frames/s decoder={d} batch=32: median {statistics.median(vals):.1f} "
              f"of {[round(v, 1) for v in vals]}")
    return launches


def phase_reference(device):
    """A small f32 model on the card (kernel decoder, cuDNN with TF32 off) vs
    the same weights and requests on the CPU (plain PyTorch): the port's
    CPU path is what the tests hold against the JAX package.

    The model uses the two-pass `instance` norm: random weights come with
    uncalibrated anchors (anchor_n = 0), and the anchored norm is then the
    raw one-pass form, whose result on near-constant channels depends on the
    order of its sums (card and CPU differ by ~0.7 px there, by ~2e-3 px with
    two-pass statistics or calibrated anchors)."""
    from pixelwiseregression_tpu_torch.data.sources import SPECS
    from pixelwiseregression_tpu_torch.models.pixelwise import PixelwiseRegression
    from pixelwiseregression_tpu_torch.serve import Predictor
    from pixelwiseregression_tpu_torch.utils.synth import make_synthetic_raw_batch

    spec = SPECS["NYU"]
    torch.manual_seed(SEED + 1)
    state = PixelwiseRegression(spec.joint_number, stage=STAGES, features=16, level=2,
                                norm_method="instance").state_dict()
    kw = dict(batch_size=4, stages=STAGES, features=16, level=2, label_size=64,
              norm_method="instance", dtype=torch.float32)
    card = Predictor.from_state_dict(state, "NYU", device, decoder="cuda", **kw)
    host = Predictor.from_state_dict(state, "NYU", "cpu", decoder="torch", **kw)
    raw = make_synthetic_raw_batch(3, spec.frame_h, spec.frame_w, spec.joint_number,
                                   fx=spec.camera.fx, fy=spec.camera.fy, cube=spec.cube_size,
                                   com_z=470.0, seed=SEED + 9)
    got = card.predict(raw["frame"], raw["com"])
    want = host.predict(raw["frame"], raw["com"])
    gap = max(float(np.abs(got[k] - want[k]).max()) for k in ("uvd", "xyz"))
    print(f"reference: small f32 model, card vs CPU: largest uvd/xyz gap {gap:.3e} px/mm")
    # the CPU tests hold the port to the JAX package within 2e-2 px/mm
    assert gap <= 2e-2, f"card and CPU disagree by {gap:.3e}"


def _rows(device, b, gen):
    hw = H * W
    x = 3 * torch.randn(b, J, hw, generator=gen, device=device)
    dm = torch.randn(b, J, hw, generator=gen, device=device)
    label = torch.randn(b, 1, hw, generator=gen, device=device)
    mask = (torch.rand(b, 1, hw, generator=gen, device=device) > 0.4).float()
    mask[0] = 0.0  # den = 1e-14: must give finite zeros
    w = torch.rand(J, generator=gen, device=device) + 0.5
    return x, dm, label, mask, w


def phase_backward(cs, plain, device):
    """K2 through the autograd.Function vs autograd of the plain decoder."""
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    cases = {}
    for b in (32, TRAIN_BATCH):
        x, dm, label, mask, w = _rows(device, b, gen)
        g_hm = torch.randn(b, J, H * W, generator=gen, device=device) * 1e-3
        g_uvd = torch.randn(b, J, 3, generator=gen, device=device)

        def grads(decode):
            leaves = [t.clone().requires_grad_(True) for t in (x, dm, label, w)]
            hm, uvd = decode(leaves[0], leaves[1], leaves[2], mask, leaves[3], H, W)
            torch.autograd.backward((hm, uvd), (g_hm, g_uvd))
            return [t.grad for t in leaves]

        got = grads(cs.decode_flat)
        want = grads(plain)
        torch.cuda.synchronize()
        err = 0.0
        for name, g, r in zip(("dx", "ddm", "dlabel", "dw"), got, want):
            assert torch.isfinite(g).all(), f"non-finite {name}"
            torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-6, msg=name)
            err = max(err, float((g - r).abs().max()))
        assert float(got[1][0].abs().max()) == 0.0 and float(got[2][0].abs().max()) == 0.0

        # the backward alone: K2 (plus the batch sum of dw) vs autograd of the plain graph
        leaves = [t.clone().requires_grad_(True) for t in (x, dm, label, w)]
        out = plain(leaves[0], leaves[1], leaves[2], mask, leaves[3], H, W)

        def k_bwd():
            return cs.decode_flat_backward(x, dm, label, mask, w, g_hm, g_uvd, H, W)

        def p_bwd():
            return torch.autograd.grad(out, leaves, (g_hm, g_uvd), retain_graph=True)

        def fwd_bwd(decode):
            def run():
                lv = [t.detach().requires_grad_(True) for t in (x, dm, label, w)]
                hm, uvd = decode(lv[0], lv[1], lv[2], mask, lv[3], H, W)
                return torch.autograd.grad((hm, uvd), lv, (g_hm, g_uvd))
            return run

        ms, plain_ms = _median_ms(k_bwd), _median_ms(p_bwd)
        fb_ms, fb_plain_ms = _median_ms(fwd_bwd(cs.decode_flat)), _median_ms(fwd_bwd(plain))
        print(f"kernel softargmax_bwd [{b},{J},{H * W}] f32: max_abs_err={err:.3e} "
              f"bwd kernel_ms={ms:.5f} plain_ms={plain_ms:.5f}; fwd+bwd kernel_ms={fb_ms:.5f} "
              f"plain_ms={fb_plain_ms:.5f}")
        cases[b] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
    return cases


def _train_setup(device, decoder, dtype, state_dict, batch_size):
    from pixelwiseregression_tpu_torch.models.pixelwise import PixelwiseRegression
    from pixelwiseregression_tpu_torch.train.loop import create_train_state

    model = PixelwiseRegression(J, stage=STAGES, features=128, level=4, kernel_size=3,
                                norm_method="instance_anchored", heatmap_method="softmax",
                                decoder=decoder, dtype=dtype).to(device)
    model.load_state_dict(state_dict)
    # AdamW lr 1e-3, betas (0.9, 0.999), no weight decay, StepLR 0.2 every 15 epochs
    return create_train_state(model, lr=1e-3, lr_decay=0.2, decay_epoch=15,
                              steps_per_epoch=100)


def _train_cfg(augment=True):
    from pixelwiseregression_tpu_torch.data.preprocess import PreprocessConfig
    from pixelwiseregression_tpu_torch.data.sources import SPECS

    cam = SPECS["NYU"].camera
    return PreprocessConfig(fx=cam.fx, fy=cam.fy, halfu=cam.halfu, halfv=cam.halfv,
                            image_size=2 * H, label_size=H, kernel_size=7, sigma=1.5,
                            using_rotation=augment, using_scale=augment, using_shift=augment)


def _raw_batch(device, n, seed):
    from pixelwiseregression_tpu_torch.data.sources import SPECS
    from pixelwiseregression_tpu_torch.utils.synth import make_synthetic_raw_batch

    spec = SPECS["NYU"]
    raw = make_synthetic_raw_batch(n, spec.frame_h, spec.frame_w, J, fx=spec.camera.fx,
                                   fy=spec.camera.fy, cube=spec.cube_size, com_z=450.0,
                                   seed=seed)
    return {k: torch.from_numpy(v).to(device) for k, v in raw.items()}


def _grads(model):
    return {n: p.grad.detach().double().clone() for n, p in model.named_parameters()}


def _whole_gap(got, want):
    num = sum(float(((got[n] - want[n]) ** 2).sum()) for n in want)
    den = sum(float((want[n] ** 2).sum()) for n in want)
    return (num / den) ** 0.5


def _step_parts(step, state, batch, gen):
    """One train step, its parts timed by the step's own CUDA events:
    preprocess, forward + loss, backward, optimizer."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    step(state, batch, generator=gen, events=ev)
    torch.cuda.synchronize()
    return [ev[i].elapsed_time(ev[i + 1]) for i in range(4)]


def phase_train(cs, device):
    """The training path at full width; returns the (K1, K2) launches of its main run."""
    from pixelwiseregression_tpu_torch.data.preprocess import draw_augmentation
    from pixelwiseregression_tpu_torch.data.sources import SPECS
    from pixelwiseregression_tpu_torch.models.pixelwise import PixelwiseRegression
    from pixelwiseregression_tpu_torch.train.loop import (LossConfig, make_eval_step,
                                                           make_train_step)

    torch.manual_seed(SEED)
    state0 = PixelwiseRegression(J, stage=STAGES, features=128, level=4, kernel_size=3,
                                 norm_method="instance_anchored").state_dict()
    batch = _raw_batch(device, TRAIN_BATCH, SEED + 20)
    cfg, loss_cfg = _train_cfg(), LossConfig(lambda_h=1.0, lambda_d=0.01, alpha=1.0)
    step = make_train_step(cfg, loss_cfg, augment=True)
    gen = torch.Generator(device=device).manual_seed(SEED + 21)
    draws0 = draw_augmentation(TRAIN_BATCH, gen, device)

    state = _train_setup(device, "cuda", torch.bfloat16, state0, TRAIN_BATCH)
    torch.cuda.synchronize()
    cs.LAUNCHES = cs.BWD_LAUNCHES = 0
    losses, t = [], time.perf_counter()
    for i in range(TRAIN_STEPS):
        before = (cs.LAUNCHES, cs.BWD_LAUNCHES)
        m = step(state, batch, generator=gen, draws=draws0 if i == 0 else None)
        assert (cs.LAUNCHES - before[0], cs.BWD_LAUNCHES - before[1]) == (STAGES, STAGES), \
            f"step {i}: {cs.LAUNCHES - before[0]} K1 and {cs.BWD_LAUNCHES - before[1]} K2 launches"
        if i == 0:
            first = {"loss": float(m["loss"]), "grads": _grads(state.model)}
        losses.append(float(m["loss"]))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    launches = (cs.LAUNCHES, cs.BWD_LAUNCHES)
    assert launches == (STAGES * TRAIN_STEPS, STAGES * TRAIN_STEPS), launches
    assert all(np.isfinite(losses)), losses
    print(f"train NYU stages={STAGES} bf16 batch={TRAIN_BATCH} augmented: {TRAIN_STEPS} steps "
          f"in {seconds:.2f} s (first step included), launches K1={launches[0]} "
          f"K2={launches[1]}, losses {[round(v, 5) for v in losses]}")

    plain = _train_setup(device, "torch", torch.bfloat16, state0, TRAIN_BATCH)
    m = step(plain, batch, draws=draws0)
    loss_gap = abs(float(m["loss"]) - first["loss"]) / abs(float(m["loss"]))
    grad_gap = _whole_gap(first["grads"], _grads(plain.model))
    print(f"train first step, kernel vs plain decoder: loss {first['loss']:.6f} vs "
          f"{float(m['loss']):.6f} (relative gap {loss_gap:.3e}), whole-gradient relative "
          f"gap {grad_gap:.3e}")
    assert loss_gap <= LOSS_GAP_BOUND, loss_gap
    assert grad_gap <= GRAD_GAP_BOUND, grad_gap

    # steps/s and the step's parts, both decoders in turns
    rates = {"cuda": [], "torch": []}
    parts = {"cuda": [], "torch": []}
    states = {"cuda": state, "torch": plain}
    for rep in range(4):
        for d in (("cuda", "torch") if rep % 2 == 0 else ("torch", "cuda")):
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(3):
                step(states[d], batch, generator=gen)
            torch.cuda.synchronize()
            rates[d].append(3 / (time.perf_counter() - t))
            parts[d].append(_step_parts(step, states[d], batch, gen))
    for d in ("cuda", "torch"):
        sps = statistics.median(rates[d])
        med = [statistics.median(p[i] for p in parts[d]) for i in range(4)]
        print(f"train rate decoder={d} bf16 batch={TRAIN_BATCH}: median {sps:.3f} steps/s = "
              f"{sps * TRAIN_BATCH:.1f} frames/s of {[round(v, 3) for v in rates[d]]}; parts ms "
              f"preprocess {med[0]:.2f} forward+loss {med[1]:.2f} backward {med[2]:.2f} "
              f"optimizer {med[3]:.2f}")

    ev = make_eval_step(_train_cfg(augment=False), loss_cfg, SPECS["NYU"].camera)
    n_real = TRAIN_BATCH - TRAIN_BATCH // 16  # the rest are marked as padding
    weight = (torch.arange(TRAIN_BATCH, device=device) < n_real).float()
    out = ev(state, {**batch, "weight": weight})
    mean_mm = (out["err_sum_mm"] / out["count"]).tolist()
    assert out["err_sum_mm"].shape == (STAGES,) and float(out["count"]) == n_real
    assert all(np.isfinite(mean_mm)), mean_mm
    print(f"eval step after {state.step} train steps: loss {float(out['loss']):.5f}, "
          f"mean error per stage {[round(v, 3) for v in mean_mm]} mm over "
          f"{int(out['count'])} frames")
    return launches


def phase_train_f32(cs, device):
    """The training CLI's default precision (f32, --mixed_precision off) at batch 32."""
    from pixelwiseregression_tpu_torch.models.pixelwise import PixelwiseRegression
    from pixelwiseregression_tpu_torch.train.loop import LossConfig, make_train_step

    torch.manual_seed(SEED + 3)
    state0 = PixelwiseRegression(J, stage=STAGES, features=128, level=4,
                                 norm_method="instance_anchored").state_dict()
    state = _train_setup(device, "cuda", torch.float32, state0, 32)
    step = make_train_step(_train_cfg(), LossConfig(), augment=True)
    batch = _raw_batch(device, 32, SEED + 30)
    gen = torch.Generator(device=device).manual_seed(SEED + 31)
    before = (cs.LAUNCHES, cs.BWD_LAUNCHES)
    losses = [float(step(state, batch, generator=gen)["loss"]) for _ in range(3)]
    assert (cs.LAUNCHES - before[0], cs.BWD_LAUNCHES - before[1]) == (3 * STAGES, 3 * STAGES)
    assert all(np.isfinite(losses)), losses
    print(f"train NYU stages={STAGES} f32 batch=32: 3 steps, losses "
          f"{[round(v, 5) for v in losses]}")


def phase_train_reference(device):
    """One f32 train step of a small model (instance norms, features 16,
    level 2) on the card (kernel decoder, TF32 off) and on the CPU (plain
    PyTorch, which the CPU tests hold against the JAX package), from the same
    weights, batch and draws.

    The bounds: loss rtol 1e-4; the last stage's output convs and
    temperature (between the loss and the last ReLU) within 1e-3 relative;
    the whole gradient within 5e-2 relative. Upstream of a ReLU a per-tensor
    1e-3 cannot hold between two roundings of this model: near-constant
    channels (a hand on a zero background) amplify the forward's rounding,
    and ReLU inputs near zero flip (tests/test_torch_port_train.py measured
    gaps up to 12% between the port and the JAX package on the CPU)."""
    from pixelwiseregression_tpu_torch.data.preprocess import draw_augmentation
    from pixelwiseregression_tpu_torch.models.pixelwise import PixelwiseRegression
    from pixelwiseregression_tpu_torch.train.loop import (LossConfig, create_train_state,
                                                           make_train_step)

    torch.manual_seed(SEED + 4)
    state0 = PixelwiseRegression(J, stage=STAGES, features=16, level=2,
                                 norm_method="instance").state_dict()
    raw = {k: v.cpu() for k, v in _raw_batch("cpu", 4, SEED + 40).items()}
    draws = draw_augmentation(4, torch.Generator().manual_seed(SEED + 41), torch.device("cpu"))
    cfg = _train_cfg()
    out = {}
    for dev, decoder in ((device, "cuda"), (torch.device("cpu"), "torch")):
        model = PixelwiseRegression(J, stage=STAGES, features=16, level=2,
                                    norm_method="instance", decoder=decoder).to(dev)
        model.load_state_dict(state0)
        state = create_train_state(model, lr=1e-3, steps_per_epoch=100)
        m = make_train_step(cfg, LossConfig(alpha=0.5))(
            state, {k: v.to(dev) for k, v in raw.items()},
            draws={k: v.to(dev) for k, v in draws.items()})
        out[dev.type] = (float(m["loss"]), {n: g.cpu() for n, g in _grads(model).items()})
    (loss_c, g_c), (loss_h, g_h) = out["cuda"], out["cpu"]
    tensor_gaps = {n: float((g_c[n] - g_h[n]).norm() / g_h[n].norm()) for n in g_h
                   if float(g_h[n].norm()) > 0}
    last = f"stages.{STAGES - 1}"
    head = [f"{last}.plane_regression.w", f"{last}.plane_regression.conv.9.weight",
            f"{last}.depth_regression.conv.9.weight", f"{last}.depth_regression.conv.9.bias"]
    whole = _whole_gap(g_c, g_h)
    within = sum(v <= 1e-3 for v in tensor_gaps.values())
    print(f"train reference: small f32 model, card vs CPU: loss {loss_c:.7f} vs {loss_h:.7f}, "
          f"output-side gradient gaps {[f'{tensor_gaps[n]:.2e}' for n in head]}, whole "
          f"gradient gap {whole:.3e}, {within} of {len(tensor_gaps)} tensors within 1e-3, "
          f"largest {max(tensor_gaps.values()):.3e}")
    assert abs(loss_c - loss_h) <= 1e-4 * abs(loss_h), (loss_c, loss_h)
    assert all(tensor_gaps[n] <= 1e-3 for n in head), [tensor_gaps[n] for n in head]
    assert whole <= 5e-2, whole


def phase_profile(device, steps=3):
    """``--profile``: the main path's train step (the configuration of
    phase_train, kernel decoder) under torch.profiler, after three warm-up
    steps. Prints the wall time per step with and without the profiler, the
    device ops and device time per step, that time by the kernel-name groups
    of PROFILE_GROUPS and by the largest kernels, the device's idle share
    over the profiled steps read from the trace's own busy timeline (the
    union of its device ops, from the first one's start to the last one's
    end), and the peak memory allocated."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from pixelwiseregression_tpu_torch.models.pixelwise import PixelwiseRegression
    from pixelwiseregression_tpu_torch.train.loop import LossConfig, make_train_step

    torch.manual_seed(SEED)
    state0 = PixelwiseRegression(J, stage=STAGES, features=128, level=4, kernel_size=3,
                                 norm_method="instance_anchored").state_dict()
    state = _train_setup(device, "cuda", torch.bfloat16, state0, TRAIN_BATCH)
    step = make_train_step(_train_cfg(), LossConfig(), augment=True)
    batch = _raw_batch(device, TRAIN_BATCH, SEED + 20)
    gen = torch.Generator(device=device).manual_seed(SEED + 21)

    def run(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            step(state, batch, generator=gen)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / n * 1e3

    run(3)
    wall_ms = run(10)
    torch.cuda.reset_peak_memory_stats(device)
    with tempfile.TemporaryDirectory() as tmp:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            prof_wall_ms = run(steps)
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    peak_gib = torch.cuda.max_memory_allocated(device) / 2**30
    ops = sorted((float(e["ts"]), float(e["dur"]), e["name"]) for e in events
                 if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    assert ops, "the trace holds no device op"

    busy, (lo, hi) = 0.0, ops[0][:2]
    hi += lo
    for ts, dur, _ in ops:  # union of the device ops' intervals, in us
        if ts > hi:
            busy, lo, hi = busy + hi - lo, ts, ts + dur
        else:
            hi = max(hi, ts + dur)
    busy += hi - lo
    span = max(ts + dur for ts, dur, _ in ops) - ops[0][0]
    device_ms = sum(dur for _, dur, _ in ops) / 1e3 / steps
    print(f"profile train NYU stages={STAGES} bf16 batch={TRAIN_BATCH} decoder=cuda: "
          f"{wall_ms:.2f} ms/step unprofiled (10 steps), {prof_wall_ms:.2f} ms/step profiled "
          f"({steps} steps); {len(ops) / steps:.0f} device ops/step, device time "
          f"{device_ms:.2f} ms/step; device idle share {1 - busy / span:.4f} of the profiled "
          f"span ({span / 1e3 / steps:.2f} ms/step); peak memory allocated {peak_gib:.2f} GiB")

    groups, kernels = {}, {}
    for _, dur, name in ops:
        low = name.lower()
        group = next((g for g, keys in PROFILE_GROUPS if any(k in low for k in keys)), "other")
        groups[group] = groups.get(group, 0.0) + dur
        n, t = kernels.get(name, (0, 0.0))
        kernels[name] = (n + 1, t + dur)
    for group, dur in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"profile group {group}: {dur / 1e3 / steps:.2f} ms/step "
              f"({dur / 1e3 / steps / device_ms:.4f} of device time)")
    for name, (n, dur) in sorted(kernels.items(), key=lambda kv: -kv[1][1])[:15]:
        print(f"profile kernel {dur / 1e3 / steps:.3f} ms/step in {n / steps:.0f} ops: {name[:160]}")


def _bound(flops, nbytes, kind):
    """The least time (ms) an H100 SXM could take, and what bounds it (the
    roofline the port's tools use)."""
    from pixelwiseregression_tpu_torch.tools.ab_common import bound

    seconds, by = bound(flops, nbytes, kind)
    return seconds * 1e3, by


def _decoder_bounds(b):
    """K1 and K2 at [b, J, H*W] f32: each map element read or written once;
    ~16 f32 operations per element forward (three passes), ~30 backward."""
    n, hw = b * J * H * W, b * H * W
    fwd = _bound(16 * n, 4 * (3 * n + 2 * hw + b * J * 3 + J), "f32")
    bwd = _bound(30 * n, 4 * (5 * n + 3 * hw + b * J * 6 + J), "f32")
    return fwd, bwd


def _rounding_gap(got, want):
    """max |got - want| in ulps of the output's largest magnitude, and the
    share of elements more than one ulp (of their own magnitude) apart;
    ulps of the tensors' dtype."""
    bits = 7 if got.dtype == torch.bfloat16 else 23
    g, w = got.float(), want.float()
    err = (g - w).abs()
    ulps = float(err.max()) / 2.0 ** (math.floor(math.log2(float(w.abs().max()))) - bits)
    own = torch.exp2(torch.floor(torch.log2(torch.maximum(g.abs(), w.abs()).clamp_min(1e-30)))
                     - bits)
    return float(err.max()), ulps, float((err > own).float().mean())


# the unit kinds of the unit engine at full width: name, H = W, k, C, Co,
# prologue, epilogue, skip (models/infer_engine.py::make_unit_fused_apply)
UNIT_KINDS = (
    ("stem_conv_1", 2 * H, 3, 32, 64, True, True, False),
    ("stem_conv_2", 2 * H, 3, 64, 128, False, True, False),
    ("resblock_conv_0", H, 1, 128, 64, True, False, False),
    ("resblock_conv_1", H, 3, 64, 64, True, False, False),
    ("resblock_conv_2", H, 1, 64, 128, True, False, True),
    ("head_conv", H, 3, 128, 128, False, True, False),
)


def phase_fused_units(device):
    """K3 vs its plain version for every unit kind, batch 256, bf16, and the
    head unit in f32; cuDNN's conv of the same shape (bias included, nothing
    else) times as a partial yardstick: no one PyTorch call computes a unit."""
    import torch.nn.functional as F

    from pixelwiseregression_tpu_torch.ops import cuda_fused as cf

    gen = torch.Generator(device=device).manual_seed(SEED + 50)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=device)

    cases = {}
    for kind, dtype in [(k, torch.bfloat16) for k in UNIT_KINDS] + [(UNIT_KINDS[-1], torch.float32)]:
        name, hw, k, c, co, pro, epi, with_skip = kind
        x = (1.0 + randn(UNIT_BATCH, hw, hw, c)).to(dtype)
        unit = {"kernel": randn(k, k, c, co) * (2.0 / (k * k * c)) ** 0.5, "bias": 0.1 * randn(co)}
        if pro:
            unit["pro"] = (1.0 + 0.1 * randn(c), 0.1 * randn(c))
        if epi:
            unit["epi"] = (1.0 + 0.1 * randn(co), 0.1 * randn(co))
        skip = randn(UNIT_BATCH, hw, hw, co).to(dtype) if with_skip else None
        w_lib = unit["kernel"].permute(3, 2, 0, 1).to(dtype).contiguous(
            memory_format=torch.channels_last)
        b_lib, x_lib = unit["bias"].to(dtype), x.permute(0, 3, 1, 2)

        def kernel():
            return cf.fused_chain(x, [unit], skip=skip)

        def plain():
            return cf.fused_chain_plain(x, [unit], skip=skip)

        def library():
            return F.conv2d(x_lib, w_lib, b_lib, padding=k // 2)

        got, want = kernel(), plain()
        torch.cuda.synchronize()
        assert got.shape == want.shape and torch.isfinite(got.float()).all(), name
        err, ulps, share = _rounding_gap(got, want)
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        if dtype == torch.bfloat16:
            assert ulps <= UNIT_ULPS, f"{name}: {ulps:.2f} bf16 ulps apart"
        else:
            assert err <= 1e-4 * float(want.abs().max()), f"{name} f32: {err:.3e}"
        ms, lib_ms = _median_ms(kernel), _median_ms(library)
        plain_ms = _median_ms(plain, runs=3, iters=5)
        es = x.element_size()
        bound, by = _bound(2 * UNIT_BATCH * hw * hw * k * k * c * co,
                           es * (UNIT_BATCH * hw * hw * (c + co + (co if with_skip else 0))
                                 + k * k * c * co), tag)
        print(f"kernel fused_chain {name} [{UNIT_BATCH},{hw},{hw},{c}]->{co} k={k} {tag}: "
              f"max_abs_err={err:.3e} ({ulps:.2f} ulps of the scale, {share:.2e} of elements "
              f"> 1 ulp apart) kernel_ms={ms:.5f} plain_ms={plain_ms:.5f} "
              f"library_ms={lib_ms:.5f} (cuDNN conv alone, a partial yardstick) "
              f"bound_ms={bound:.5f} ({by})")
        cases[(name, tag)] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                              "library_ms": lib_ms, "bound_ms": bound, "bound_by": by,
                              "shape": [UNIT_BATCH, hw, hw, c, co, k]}
    return cases


def _hourglass_pixels(side, level):
    """Pixels summed over the ResBlocks of a level-`level` hourglass at side x side."""
    inner = _hourglass_pixels(side // 2, level - 1) if level > 0 else (side // 2) ** 2
    return side * side + inner + (side // 2) ** 2


def _perturbed_hourglass(seed):
    """A full-width Hourglass from a seed, norm scales and biases off 1 and 0."""
    from pixelwiseregression_tpu_torch.models.pixelwise import Hourglass

    torch.manual_seed(seed)
    hg = Hourglass(FEATURES, LEVEL, "instance")
    with torch.no_grad():
        for m in hg.modules():
            if hasattr(m, "method"):
                m.weight.add_(0.1 * torch.randn_like(m.weight))
                m.bias.add_(0.1 * torch.randn_like(m.bias))
    return hg


def phase_hourglass(device):
    """K4 vs its plain version at [256, 64, 64, 128] bf16, level 4, and the
    same input in f32."""
    from pixelwiseregression_tpu_torch.ops import cuda_hourglass as ch

    stacked = {k: v.to(device) for k, v in
               ch.stack_hourglass_params(_perturbed_hourglass(SEED + 60), LEVEL).items()}
    gen = torch.Generator(device=device).manual_seed(SEED + 61)
    x = torch.randn(UNIT_BATCH, H, W, FEATURES, generator=gen, device=device).to(torch.bfloat16)

    def kernel():
        return ch.hourglass_fused(x, stacked, LEVEL)

    def plain():
        return ch.hourglass_fused_plain(x, stacked, LEVEL)

    def rel_l2(a, b):
        return float((a.float() - b.float()).norm() / b.float().norm())

    got, want = kernel(), plain()
    got32 = ch.hourglass_fused(x.float(), stacked, LEVEL)
    want32 = ch.hourglass_fused_plain(x.float(), stacked, LEVEL)
    torch.cuda.synchronize()
    assert got.shape == x.shape and torch.isfinite(got.float()).all()
    err32 = float((got32 - want32).abs().max())
    assert err32 <= 1e-4 * float(want32.abs().max()), f"hourglass f32: {err32:.3e}"
    err, ulps, share = _rounding_gap(got, want)
    gap, own = rel_l2(got, want), rel_l2(want, want32)
    assert gap <= own, f"hourglass bf16: relative L2 gap {gap:.3e} above bf16's own {own:.3e}"
    ms, plain_ms = _median_ms(kernel, runs=5, iters=10), _median_ms(plain, runs=3, iters=2)
    c, ch2 = FEATURES, FEATURES // 2
    per_pixel = 2 * c * ch2 + 2 * 9 * ch2 * ch2 + 2 * ch2 * c
    weights = ch.num_resblocks(LEVEL) * (c * ch2 + 9 * ch2 * ch2 + ch2 * c)
    bound, by = _bound(UNIT_BATCH * _hourglass_pixels(H, LEVEL) * per_pixel,
                       2 * (2 * x.numel() + weights), "bf16")
    print(f"kernel hourglass_fused [{UNIT_BATCH},{H},{W},{FEATURES}] level {LEVEL} bf16: "
          f"max_abs_err={err:.3e} ({ulps:.2f} ulps of the scale, {share:.2e} of elements > 1 ulp "
          f"apart, relative L2 gap {gap:.3e} against bf16's own {own:.3e}; f32 max_abs_err "
          f"{err32:.3e}) kernel_ms={ms:.5f} plain_ms={plain_ms:.5f} library_ms=none "
          f"bound_ms={bound:.5f} ({by})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by}


def _engine_model(device, dtype, features=FEATURES, level=LEVEL):
    from pixelwiseregression_tpu_torch.models.pixelwise import PixelwiseRegression

    torch.manual_seed(SEED + 70)
    return PixelwiseRegression(J, stage=STAGES, features=features, level=level, kernel_size=3,
                               norm_method="instance", decoder="cuda", dtype=dtype).to(device).eval()


def _engine_inputs(device, b, label, seed):
    """bench.py's inputs: uniform image and label, a mask of 70% ones."""
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(a.astype(np.float32)).to(device)
            for a in (rng.rand(b, 1, 2 * label, 2 * label), rng.rand(b, 1, label, label),
                      rng.rand(b, 1, label, label) > 0.3)]


def _forward_fps(fn, inputs, iters=5):
    for _ in range(2):
        fn(*inputs)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(*inputs)
    end.record()
    torch.cuda.synchronize()
    return iters * inputs[0].shape[0] / (start.elapsed_time(end) / 1e3)


def phase_engines(cs, device):
    """Both engines at full width, bf16, batch 64 (the main paths of this
    slice); returns each engine's (K3, K4, K1) launches per forward."""
    from pixelwiseregression_tpu_torch.models.infer_engine import (make_fused_apply,
                                                                   make_unit_fused_apply)
    from pixelwiseregression_tpu_torch.ops import cuda_fused as cf
    from pixelwiseregression_tpu_torch.ops import cuda_hourglass as ch

    builders = {"unit": make_unit_fused_apply, "fused": make_fused_apply}
    model = _engine_model(device, torch.bfloat16)
    inputs = _engine_inputs(device, ENGINE_BATCH, H, SEED + 71)
    engines = {name: make(model) for name, make in builders.items()}
    outs, launches = {}, {}
    for name, fn in engines.items():
        cs.LAUNCHES = cf.LAUNCHES = ch.LAUNCHES = 0
        outs[name] = fn(*inputs)
        torch.cuda.synchronize()
        launches[name] = (cf.LAUNCHES, ch.LAUNCHES, cs.LAUNCHES)
    assert launches["unit"] == (32, 0, STAGES), launches
    assert launches["fused"] == (0, STAGES, STAGES), launches

    plain = {name: make(model, plain=True)(*inputs) for name, make in builders.items()}
    model32 = _engine_model(device, torch.float32)
    plain32 = {name: make(model32, plain=True)(*inputs) for name, make in builders.items()}
    # the plain engine's own sensitivity: one pixel of every sample's image
    # moved by one bf16 ulp (bf16 bit patterns of values >= 0 step by one)
    nudged = inputs[0].clone()
    px = nudged[:, 0, H, W].to(torch.bfloat16)
    nudged[:, 0, H, W] = (px.view(torch.int16) + 1).view(torch.bfloat16).float()
    plain_nudged = {name: make(model, plain=True)(nudged, *inputs[1:])
                    for name, make in builders.items()}
    with torch.inference_mode():
        ref = model(*inputs)

    def uvd_gap(a, b):
        """max |a - b| over uvd, over its uv (normalized map coordinates) and over d."""
        d = (a - b).abs()
        return float(d.max()), float(d[..., :2].max()), float(d[..., 2].max())

    for name in engines:
        for s in range(STAGES):
            hm, dm, uvd = outs[name][s]
            assert hm.shape == dm.shape == (ENGINE_BATCH, J, H, W) and uvd.shape == (ENGINE_BATCH, J, 3)
            assert torch.isfinite(uvd).all() and torch.isfinite(hm).all() and torch.isfinite(dm).all()
            own = uvd_gap(plain[name][s][2], plain32[name][s][2])[0]
            gap, gap_uv, gap_d = uvd_gap(uvd, plain[name][s][2])
            model_gap = uvd_gap(uvd, ref[s][2])[0]
            nudge = uvd_gap(plain_nudged[name][s][2], plain[name][s][2])[0]
            print(f"engine {name} NYU stages={STAGES} bf16 batch={ENGINE_BATCH} stage {s + 1}: uvd gap "
                  f"kernels vs plain {gap:.3e} (uv {gap_uv:.3e}, d {gap_d:.3e}; d's scale "
                  f"{float(uvd[..., 2].abs().max()):.3e}), vs the model's forward {model_gap:.3e}; "
                  f"the plain engine's own bf16-vs-f32 gap {own:.3e}, and its move when one "
                  f"pixel per image moves by one bf16 ulp {nudge:.3e}")
            assert gap <= max(ENGINE_GAP_BOUND, 2 * own), (name, s, gap, own)
            if s == 0:
                assert model_gap <= max(MODEL_GAP_BOUND, 2 * own), (name, model_gap, own)
    print(f"engine launches per forward (K3, K4, K1): unit {launches['unit']}, "
          f"fused {launches['fused']}")

    forwards = {**engines, "model": model}
    fps = {name: [] for name in forwards}
    for rep in range(3):
        for name in (forwards if rep % 2 == 0 else reversed(list(forwards))):
            with torch.inference_mode():
                fps[name].append(_forward_fps(forwards[name], inputs))
    for name, vals in fps.items():
        print(f"forward frames/s {name} NYU stages={STAGES} bf16 batch={ENGINE_BATCH}: median "
              f"{statistics.median(vals):.1f} of {[round(v, 1) for v in vals]}")
    return launches


def phase_engine_reference(device):
    """Small f32 models (14 joints, level 2, 16x16 labels, batch 3) through
    each engine on the card (kernels, TF32 off) and on the CPU (the plain
    versions, which the CPU tests hold against the JAX engines): stage 1
    within 1e-4 of each output's scale, stage 2 within the JAX golden tests'
    stage-2 bounds (tests/test_infer_engine.py:60-67)."""
    from pixelwiseregression_tpu_torch.models.infer_engine import (make_fused_apply,
                                                                   make_unit_fused_apply)

    cpu = torch.device("cpu")
    for name, features in (("unit", 64), ("fused", 32)):
        state = _engine_model(cpu, torch.float32, features, 2).state_dict()
        inputs = _engine_inputs(cpu, 3, 16, SEED + 80)
        outs = {}
        for dev in (device, cpu):
            model = _engine_model(dev, torch.float32, features, 2)
            model.load_state_dict(state)
            fn = (make_unit_fused_apply(model, min_res=4) if name == "unit"
                  else make_fused_apply(model))
            outs[dev.type] = [[t.float().cpu() for t in st] for st in fn(*(t.to(dev) for t in inputs))]
        rel = []
        for s, (got, want) in enumerate(zip(outs["cuda"], outs["cpu"])):
            rel.append([float((g - w).abs().max() / w.abs().max()) for g, w in zip(got, want)])
            if s == 0:
                assert max(rel[0]) <= 1e-4, rel[0]
            else:
                for g, w, (atol, rtol) in zip(got, want, ((1e-3, 1e-3), (2e-2, 2e-2), (5e-3, 1e-3))):
                    torch.testing.assert_close(g, w, atol=atol, rtol=rtol)
        print(f"engine reference: small f32 {name} engine, card vs CPU, (heatmaps, depthmaps, uvd) "
              f"gaps relative to their scale: {[[f'{v:.2e}' for v in r] for r in rel]}")


def _free():
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def phase_normrelu(device):
    """K5 against its plain version: [128, 64, 64, 128] bf16 (the A/B tool's
    shape) and [37, 24, 40, 128] f32 (a batch and a pixel count that fill
    no tile), channel 0 at scale = bias = 0 in both. dx within 1 bf16 ulp
    of its scale (f32: 1e-5 of it), dscale and dbias rtol 1e-4 atol 1e-2,
    the zero channel's gradients exactly 0. Timed at the bf16 shape: K5
    alone, its plain version, and ATen's autograd backward of
    relu(instance_norm) on the same inputs."""
    import torch.nn.functional as F

    from pixelwiseregression_tpu_torch.ops import cuda_normrelu as cn
    from pixelwiseregression_tpu_torch.ops import fused_normrelu as fnr

    gen = torch.Generator(device=device).manual_seed(SEED + 90)
    out = {}
    for shape, dtype in (((128, H, W, FEATURES), torch.bfloat16),
                         ((37, 24, 40, FEATURES), torch.float32)):
        c = shape[-1]
        x = (torch.randn(*shape, generator=gen, device=device) + 0.3).to(dtype)
        g = torch.randn(*shape, generator=gen, device=device).to(dtype)
        scale = 1.0 + 0.2 * torch.randn(c, generator=gen, device=device)
        bias = 0.1 * torch.randn(c, generator=gen, device=device)
        scale[0] = bias[0] = 0.0
        mean, inv = fnr.norm_relu_stats(x)

        def kernel():
            return cn.normrelu_bwd(g, x, mean, inv, scale, bias)

        def plain():
            return fnr.normrelu_bwd_plain(g, x, mean, inv, scale, bias)

        got, want = kernel(), plain()
        torch.cuda.synchronize()
        assert float(got[0][..., 0].abs().max()) == 0.0 and float(got[1][0]) == 0.0 \
            and float(got[2][0]) == 0.0, "the zero channel has gradients"
        assert torch.isfinite(got[0].float()).all()
        err, ulps, share = _rounding_gap(got[0], want[0])
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        if dtype == torch.bfloat16:
            assert ulps <= 1.0, f"K5 dx {tag}: {ulps:.2f} ulps of the scale"
        else:
            assert err <= 1e-5 * float(want[0].abs().max()), f"K5 dx f32: {err:.3e}"
        for name, a, b in (("dscale", got[1], want[1]), ("dbias", got[2], want[2])):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-2, msg=name)
        perr = max(float((got[1] - want[1]).abs().max()), float((got[2] - want[2]).abs().max()))
        line = (f"kernel normrelu_bwd {list(shape)} {tag}: dx max_abs_err={err:.3e} ({ulps:.2f} "
                f"ulps of the scale, {share:.2e} of elements > 1 ulp apart), dscale/dbias "
                f"max_abs_err={perr:.3e}, zero channel exact")
        if dtype == torch.bfloat16:
            leaves = [x.permute(0, 3, 1, 2).detach().requires_grad_(True),
                      scale.clone().requires_grad_(True), bias.clone().requires_grad_(True)]
            y = F.relu(F.instance_norm(leaves[0], weight=leaves[1], bias=leaves[2], eps=1e-5))
            g_nchw = g.permute(0, 3, 1, 2)

            def library():
                return torch.autograd.grad(y, leaves, g_nchw, retain_graph=True)

            ms, plain_ms, lib_ms = _median_ms(kernel), _median_ms(plain, runs=5, iters=5), \
                _median_ms(library)
            n = x.numel()
            bound, by = _bound(12 * n, 2 * 3 * n + 4 * (2 * shape[0] * c + 4 * c), "f32")
            line += (f" kernel_ms={ms:.5f} plain_ms={plain_ms:.5f} library_ms={lib_ms:.5f} "
                     f"(ATen's autograd backward of relu(instance_norm)) bound_ms={bound:.5f} ({by})")
            out = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                   "bound_ms": bound, "bound_by": by, "shape": list(shape)}
            del leaves, y
        print(line)
        del x, g, got, want
    _free()
    return out


def phase_ablate(device):
    """Each K6 piece at the head shape, batch 256, bf16, against its plain
    version: the copy and every build_xm mode bit-exact, xm_dots within 2
    bf16 ulps of its scale (f32 products in another order), K3's
    statistics and apply alone within K3's 2 ulps; build_xm and xm_dots
    again at the stem shape ablate_fused2 gives them. Each timed beside its
    plain version and, where one PyTorch call computes the same function,
    that call: Tensor.copy_ for the copy, the sum of three torch.matmul
    calls on the same operand for xm_dots."""
    from pixelwiseregression_tpu_torch.ops import ablate_pieces as ap

    gen = torch.Generator(device=device).manual_seed(SEED + 91)
    b, hw, c = UNIT_BATCH, H * W, FEATURES
    x = (torch.randn(b, hw, c, generator=gen, device=device) + 2.0).to(torch.bfloat16)
    es = 1.0 + 0.1 * torch.randn(c, generator=gen, device=device)
    eb = 0.1 * torch.randn(c, generator=gen, device=device)
    act = 2 * x.numel()
    out = {}

    def record(name, err, kernel, plain, library, bound, note):
        ms = _median_ms(kernel)
        plain_ms = _median_ms(plain, runs=3, iters=3)
        lib_ms = _median_ms(library) if library is not None else None
        bms, by = bound
        print(f"kernel {name} [{b},{hw},{c}] bf16: max_abs_err={err:.3e}{note} kernel_ms={ms:.5f} "
              f"plain_ms={plain_ms:.5f} library_ms="
              f"{'none' if lib_ms is None else f'{lib_ms:.5f}'} bound_ms={bms:.5f} ({by})")
        out[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                     "bound_ms": bms, "bound_by": by}

    def bits(t):
        return t.view(torch.int16)

    y = ap.copy(x)
    torch.cuda.synchronize()
    assert torch.equal(bits(y), bits(x)), "copy is not exact"
    dst = torch.empty_like(x)
    record("ablate_copy", 0.0, lambda: ap.copy(x), lambda: x.clone(), lambda: dst.copy_(x),
           _bound(0, 2 * act, "bf16"), " (bit-exact)")
    del y, dst

    for mode in ap.XM_MODES:
        got, want = ap.build_xm(x, H, W, mode), ap.build_xm_plain(x, H, W, mode)
        torch.cuda.synchronize()
        assert got.shape == want.shape and torch.equal(bits(got), bits(want)), f"build_xm {mode}"
        del got, want
    xm_bytes = 2 * b * (H + 2) * W * 3 * c
    record("ablate_build_xm", 0.0, lambda: ap.build_xm(x, H, W), lambda: ap.build_xm_plain(x, H, W),
           None, _bound(0, act + xm_bytes, "bf16"),
           f" (bit-exact in every mode: {', '.join(ap.XM_MODES)}; timed: xm)")
    _free()

    xm = (0.5 * torch.randn(b, (H + 2) * W, 3 * c, generator=gen, device=device)).to(torch.bfloat16)
    wcat = (0.1 * torch.randn(3, 3 * c, c, generator=gen, device=device)).to(torch.bfloat16)
    offsets = (0, W, 2 * W)
    got, want = ap.xm_dots(xm, wcat, hw, offsets), ap.xm_dots_plain(xm, wcat, hw, offsets)
    torch.cuda.synchronize()
    err, ulps, share = _rounding_gap(got, want)
    assert ulps <= 2.0, f"xm_dots: {ulps:.2f} bf16 ulps of the scale"
    del got, want
    _free()

    def matmuls():
        return sum(torch.matmul(xm[:, o:o + hw], wcat[di]) for di, o in enumerate(offsets))

    record("ablate_xm_dots", err, lambda: ap.xm_dots(xm, wcat, hw, offsets),
           lambda: ap.xm_dots_plain(xm, wcat, hw, offsets), matmuls,
           _bound(2 * b * hw * 9 * c * c, 2 * xm.numel() + act + 2 * wcat.numel(), "bf16"),
           f" ({ulps:.2f} ulps of the scale, {share:.2e} of elements > 1 ulp apart; operand "
           f"[{b},{(H + 2) * W},{3 * c}], library: three torch.matmul on it, summed)")
    del xm
    _free()

    # the stem shape, on ablate_fused2's own inputs: its conv2_build_only
    # (build_xm probe_cat) and conv2_dots_concat_only (build_xm repeat, then
    # xm_dots with K = 192 at row offsets (0, 0, 0))
    from pixelwiseregression_tpu_torch.tools import ablate_fused2 as af2

    stem = af2.inputs(b, device)
    x2, w2, hws = stem["x2"], stem["w2"], af2.HS * af2.WS
    del stem
    _free()
    for mode in ("probe_cat", "repeat"):
        got, want = ap.build_xm(x2, af2.HS, af2.WS, mode), ap.build_xm_plain(x2, af2.HS, af2.WS, mode)
        torch.cuda.synchronize()
        assert got.shape == want.shape and torch.equal(bits(got), bits(want)), \
            f"build_xm {mode} at the stem shape"
        del got, want
    xr = ap.build_xm(x2, af2.HS, af2.WS, "repeat")
    got, want = ap.xm_dots(xr, w2, hws, (0, 0, 0)), ap.xm_dots_plain(xr, w2, hws, (0, 0, 0))
    torch.cuda.synchronize()
    serr, sulps, sshare = _rounding_gap(got, want)
    assert sulps <= 2.0, f"xm_dots at the stem shape: {sulps:.2f} bf16 ulps of the scale"
    print(f"kernel ablate_build_xm [{b},{hws},64] bf16: probe_cat and repeat bit-exact; "
          f"kernel ablate_xm_dots on the repeat operand [{b},{hws},192] x w2 [3,192,128], offsets "
          f"(0,0,0): max_abs_err={serr:.3e} ({sulps:.2f} ulps of the scale, {sshare:.2e} of "
          f"elements > 1 ulp apart)")
    out["ablate_xm_dots"]["stem"] = {"shape": [b, hws, 192], "max_abs_err": serr, "ulps": sulps}
    del x2, w2, xr, got, want
    _free()

    got, want = ap.norm_stats_apply(x, es, eb), ap.norm_stats_apply_plain(x, es, eb)
    torch.cuda.synchronize()
    err, ulps, share = _rounding_gap(got, want)
    assert ulps <= UNIT_ULPS, f"norm_stats_apply: {ulps:.2f} bf16 ulps of the scale"
    del got, want
    record("norm_stats_apply", err, lambda: ap.norm_stats_apply(x, es, eb),
           lambda: ap.norm_stats_apply_plain(x, es, eb), None, _bound(0, 2 * act, "bf16"),
           f" ({ulps:.2f} ulps of the scale, {share:.2e} of elements > 1 ulp apart)")
    del x
    _free()
    return out


# the port's tools (the tools slice), the kernel counters each must move,
# and the arguments of their run here: default shapes, few rounds
TOOLS = (
    ("normrelu_bwd_ab", {"K5"}),
    ("ablate_fused_unit", {"K3", "build_xm", "xm_dots", "norm_stats_apply", "copy"}),
    ("ablate_fused2", {"K3", "build_xm", "xm_dots"}),
    ("ablate_fused3", {"K3", "copy"}),
    ("bench_fused_chain", {"K3"}),
)
TOOL_ARGS = ["--rounds", "3", "--iters", "3"]


def phase_tools():
    """The tools slice: each tool's main() with every kernel counter set to 0
    just before it and read just after; returns the launches by counter,
    summed over the tools."""
    import importlib

    from pixelwiseregression_tpu_torch.tools import ab_common

    total = dict.fromkeys(ab_common.COUNTERS, 0)
    for name, kernels in TOOLS:
        tool = importlib.import_module(f"pixelwiseregression_tpu_torch.tools.{name}")
        for mod, attr in ab_common.COUNTERS.values():
            setattr(mod, attr, 0)
        print(f"tool {name} {' '.join(TOOL_ARGS)}:", flush=True)
        t = time.perf_counter()
        result = tool.main(TOOL_ARGS)
        torch.cuda.synchronize()
        counts = {k: n for k, n in ab_common.read_counts().items() if n}
        assert counts == result["launches"], (name, counts, result["launches"])
        assert set(counts) == kernels, f"{name} launched {counts}, expected each of {kernels}"
        for k, n in counts.items():
            total[k] += n
        print(f"tool {name}: launches {counts} in {time.perf_counter() - t:.1f} s")
        _free()
    return total


def main() -> int:
    if sys.argv[1:] not in ([], ["--profile"]):
        print("usage: chip_smoke.py [--profile]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from pixelwiseregression_tpu_torch.ops import cuda_lib
    from pixelwiseregression_tpu_torch.ops import cuda_softargmax as cs
    from pixelwiseregression_tpu_torch.ops.softargmax import soft_argmax_decode_flat

    device = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    t = time.perf_counter()
    lib, log = cuda_lib.build()
    print(f"built {lib.name} in {time.perf_counter() - t:.1f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or line.endswith(":"):
            print("ptxas:", line.strip())
    if sys.argv[1:] == ["--profile"]:
        phase_profile(device)
        return 0

    fwd = phase_kernel(cs, soft_argmax_decode_flat, device)
    bwd = phase_backward(cs, soft_argmax_decode_flat, device)
    serve_launches = phase_serve(cs, device)
    phase_reference(device)
    train_launches = phase_train(cs, device)
    phase_train_f32(cs, device)
    phase_train_reference(device)
    units = phase_fused_units(device)
    hourglass = phase_hourglass(device)
    engine_launches = phase_engines(cs, device)
    phase_engine_reference(device)
    normrelu = phase_normrelu(device)
    pieces = phase_ablate(device)
    tool_launches = phase_tools()

    source = "pixelwiseregression_tpu_torch/csrc/{}.cu"
    k6 = [("ablate_copy", "ablate_pieces", "copy", "tools/ablate_fused3.py:113",
           ["tools/ablate_fused3.py:136", "tools/ablate_fused_unit.py:131"]),
          ("ablate_build_xm", "ablate_pieces", "build_xm", "tools/ablate_fused_unit.py:120",
           ["tools/ablate_fused2.py:178", "tools/ablate_fused2.py:165"]),
          ("ablate_xm_dots", "ablate_pieces", "xm_dots", "tools/ablate_fused_unit.py:152",
           ["tools/ablate_fused2.py:165"]),
          ("norm_stats_apply", "fused_chain", "norm_stats_apply", "tools/ablate_fused_unit.py:126",
           [])]
    k6_rows = [{"name": name, "route": "cuda", "source": source.format(src), "replaces": rep,
                "also_replaces": also, "launches": tool_launches[counter],
                "launches_by_path": {"tools": tool_launches[counter]}, **pieces[name],
                "shape": [UNIT_BATCH, H * W, FEATURES], "dtype": "bf16"}
               for name, src, counter, rep, also in k6]
    main_fwd = fwd[(TRAIN_BATCH, "f32")]
    (fwd_bound, fwd_by), (bwd_bound, bwd_by) = _decoder_bounds(TRAIN_BATCH)
    head = units[("head_conv", "bf16")]
    print(json.dumps({"kernels": [
        {"name": "softargmax_fwd", "route": "cuda", "source": source.format("softargmax_fwd"),
         "replaces": "pixelwiseregression_tpu/ops/pallas_softargmax.py:50",
         "launches": train_launches[0],
         "launches_by_path": {"serve": serve_launches, "train": train_launches[0],
                              "unit_engine": engine_launches["unit"][2],
                              "fused_engine": engine_launches["fused"][2]},
         "max_abs_err": main_fwd["max_abs_err"], "ms": main_fwd["ms"],
         "plain_ms": main_fwd["plain_ms"], "library_ms": None, "bound_ms": fwd_bound,
         "bound_by": fwd_by, "shape": [TRAIN_BATCH, J, H * W], "dtype": "f32"},
        {"name": "softargmax_bwd", "route": "cuda", "source": source.format("softargmax_bwd"),
         "replaces": "pixelwiseregression_tpu/ops/pallas_softargmax.py:76",
         "launches": train_launches[1], "launches_by_path": {"train": train_launches[1]},
         "max_abs_err": bwd[TRAIN_BATCH]["max_abs_err"], "ms": bwd[TRAIN_BATCH]["ms"],
         "plain_ms": bwd[TRAIN_BATCH]["plain_ms"], "library_ms": None, "bound_ms": bwd_bound,
         "bound_by": bwd_by, "shape": [TRAIN_BATCH, J, H * W], "dtype": "f32"},
        {"name": "fused_chain", "route": "cuda", "source": source.format("fused_chain"),
         "replaces": "pixelwiseregression_tpu/ops/pallas_fused.py:102",
         "launches": engine_launches["unit"][0],
         "launches_by_path": {"unit_engine": engine_launches["unit"][0],
                              "fused_engine": engine_launches["fused"][0],
                              "tools": tool_launches["K3"]},
         "max_abs_err": head["max_abs_err"], "ms": head["ms"], "plain_ms": head["plain_ms"],
         "library_ms": head["library_ms"], "bound_ms": head["bound_ms"],
         "bound_by": head["bound_by"], "shape": head["shape"], "dtype": "bf16",
         "unit": "head_conv: 3x3 128->128 + epilogue norm; library_ms is cuDNN's conv alone"},
        {"name": "hourglass_fused", "route": "cuda", "source": source.format("hourglass"),
         "replaces": "pixelwiseregression_tpu/ops/pallas_hourglass.py:188",
         "launches": engine_launches["fused"][1],
         "launches_by_path": {"unit_engine": engine_launches["unit"][1],
                              "fused_engine": engine_launches["fused"][1]},
         "max_abs_err": hourglass["max_abs_err"], "ms": hourglass["ms"],
         "plain_ms": hourglass["plain_ms"], "library_ms": None,
         "bound_ms": hourglass["bound_ms"], "bound_by": hourglass["bound_by"],
         "shape": [UNIT_BATCH, H, W, FEATURES], "dtype": "bf16"},
        {"name": "normrelu_bwd", "route": "cuda", "source": source.format("normrelu_bwd"),
         "replaces": "pixelwiseregression_tpu/ops/fused_normrelu.py:124",
         "launches": tool_launches["K5"], "launches_by_path": {"tools": tool_launches["K5"]},
         **normrelu, "dtype": "bf16",
         "unit": "library_ms is ATen's autograd backward of relu(instance_norm)"},
        *k6_rows,
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
