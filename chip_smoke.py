#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (pixelwiseregression_tpu_torch) on one GPU.

Run from the root of the repository on a machine with one CUDA card:

    python3 chip_smoke.py

It builds both soft-argmax decoder kernels from csrc/ with one nvcc call,
then:

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
7. one f32 train step of a small model on the card against the CPU.

With --profile it builds the kernels and profiles the train step of 5.
instead (phase_profile): the breakdown that PERF.md's "Where the time goes"
quotes.

The script exits non-zero, printing no result, when no CUDA device is
visible or any check fails. Its last line is a JSON object naming the card;
the line before it lists the kernels with their launches on the main path.
"""

from __future__ import annotations

import json
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


def main() -> int:
    if sys.argv[1:] not in ([], ["--profile"]):
        print("usage: chip_smoke.py [--profile]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from pixelwiseregression_tpu_torch.ops import cuda_softargmax as cs
    from pixelwiseregression_tpu_torch.ops.softargmax import soft_argmax_decode_flat

    device = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    t = time.perf_counter()
    lib, log = cs.build()
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

    source = "pixelwiseregression_tpu_torch/csrc/{}.cu"
    replaces = "pixelwiseregression_tpu/ops/pallas_softargmax.py:{}"
    main_fwd = fwd[(TRAIN_BATCH, "f32")]
    print(json.dumps({"kernels": [
        {"name": "softargmax_fwd", "route": "cuda", "source": source.format("softargmax_fwd"),
         "replaces": replaces.format(50), "launches": train_launches[0],
         "launches_by_path": {"serve": serve_launches, "train": train_launches[0]},
         "max_abs_err": main_fwd["max_abs_err"], "ms": main_fwd["ms"],
         "plain_ms": main_fwd["plain_ms"], "shape": [TRAIN_BATCH, J, H * W], "dtype": "f32"},
        {"name": "softargmax_bwd", "route": "cuda", "source": source.format("softargmax_bwd"),
         "replaces": replaces.format(76), "launches": train_launches[1],
         "max_abs_err": bwd[TRAIN_BATCH]["max_abs_err"], "ms": bwd[TRAIN_BATCH]["ms"],
         "plain_ms": bwd[TRAIN_BATCH]["plain_ms"], "shape": [TRAIN_BATCH, J, H * W],
         "dtype": "f32"},
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
