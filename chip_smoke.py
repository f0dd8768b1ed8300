#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (pixelwiseregression_tpu_torch) on one GPU.

Run from the root of the repository on a machine with one CUDA card:

    python3 chip_smoke.py

It builds every kernel of the port from csrc/, one nvcc process per source,
all started together (K1 and K2, the soft-argmax decoder's forward and
backward; K3, the fused conv + instance-norm unit; K4, the whole
hourglass; K5, the norm+relu backward; K6, the ablation pieces), then:

1. K1, the forward kernel, at the serving and training shapes
   ([32|128|256, 14, 64*64]: the on-chip plan) in all four dtype forms, at
   HANDS 2017's serving shape [32, 21, 64*64] in f32, and at
   [8, 14, 128*128] (the streamed plan), each with one all-zero mask
   row, against its plain PyTorch version, two calls bit-identical, the
   plan of each shape asserted; the main-path cases timed with CUDA events;
2. K2, the backward kernel, through the decoder's autograd.Function at
   [32|128, 14, 64*64] and [4, 14, 128*128] f32 with one all-zero mask row,
   with the label image requiring grad (dlabel: two kernels) and not (one
   kernel, as in training), against autograd of the plain decoder: dx, ddm,
   dlabel and dw, two calls bit-identical, dlabel equal to ddm summed over
   the joints in order; the backward alone and forward + backward timed
   for both; then K1 at the train, serve and engine shapes and K2 in both
   forms by device time (a CUDA graph of calls) beside the wrapper call's
   time, each with its bound and plan (phase_decoder_device);
3. the serving path: the full-width default model (NYU: 14 joints, 2 stages,
   128 features, level 4, instance_anchored norm, bf16, batch 32) on
   weights made from a seed answers four requests of synthetic 480x640
   frames through K1, checked against the plain decoder and timed; then
   HANDS 2017's box requests (21 joints, instance norm, f32, batch 32): one
   request of 32 frames with a box each and no centre, localised on the
   card, through K1 (launches read from that request), against the plain
   decoder;
4. a small f32 Predictor on the card against the same model on the CPU;
5. the training path (the main path of this script): the same full-width
   model, bf16, batch 128, augmented, takes 10 train steps through K1 and
   K2 on synthetic 480x640 frames, each step launching both kernels once
   per stage; its first step is repeated with the plain decoder from the
   same weights, batch and draws; steps/s, frames/s and the step's parts
   are timed for both decoders in turns; one eval step reports mean mm;
   then (phase_train_preprocessed) the same model, weights, batch and first
   draws through the steps on preprocessed batches (make_train_step(None)):
   3 steps, K1 and K2 once a stage a step, the first step held against the
   raw first step (loss 1e-6, whole gradient 1e-2 relative) and against the
   plain decoder's; make_eval_step(None) against the raw eval step
   (err_sum_mm 1e-5 relative, count exact); cv2's fixed-point warp
   (quantize=True) card vs CPU at 480x640 and 128x128, bit-equal;
6. the CLI's f32 default (batch 32) takes three steps through the kernels;
7. one f32 train step of a small model on the card against the CPU;
8. the CLI path (phase_cli), as a user runs it: the MSRA fixture
   (tests/fixtures/make_msra_fixture.py, 9 subjects x 16 frames) indexed
   with check_dataset's device check, run_training at the CLI's default
   width (bf16, batch 32, 2 epochs, decoder cuda; K1 once a stage a step
   and a val batch, K2 once a stage a step, asserted), the saved .pt's
   anchors calibrated, then run_inference in f32 with the cuda and the
   torch decoder (Result files within 1e-2, finite, near the fixture's
   hand) and Predictor.from_checkpoint on the same .pt against the
   test CLI's Result; samples/s per epoch printed beside the card;
9. K3 against its plain version at batch 256, bf16, for every unit kind
   that the unit engine launches at full width (and one f32 case), with
   cuDNN's conv alone at the same shape as a partial yardstick, each
   unit's share of its bound and its ratio to cuDNN's conv, the kernels a
   call launches (the conv and one norm kernel per norm) asserted, and the
   plan of each norm (cluster size, resident or streamed);
10. K4 against its plain version at [256, 64, 64, 128] bf16, level 4, and
   on its tail's own input ([256, 16, 16, 128], level 2: the levels it
   runs as one block per sample), with the kernels each call reports it
   launched (29 in bf16, 76 in f32) and the tail once in bf16 and never
   in f32, asserted, and the plans of its statistics;
11. both fused inference engines end to end at full width (NYU: 14
   joints, 2 stages, 128 features, level 4, instance norm, bf16, batch 64)
   on weights made from a seed: the unit engine through 32 K3 and 2 K1
   launches per forward, the fused engine through 2 K4 and 2 K1, each
   against the same engine on the kernels' plain versions and against the
   model's own forward, and frames/s of all three;
12. a small f32 model with both engines on the card against the CPU;
13. K5 against its plain version at [128, 64, 64, 128] bf16 and one f32
   case, each with a channel at scale = bias = 0, timed beside ATen's
   autograd backward of relu(instance_norm), its two kernels a call
   asserted and its plans printed;
14. each K6 piece (copy, build_xm and its probes, xm_dots, K3's statistics
   and apply alone) at the head shape, batch 256, against its plain
   version, timed beside Tensor.copy_ (in turns, with both spreads),
   build_xm's repeat mode in turns with x.repeat(1, 1, 3), three
   torch.matmul calls, and ATen's relu(instance_norm) forward;
   then K3's statistics and apply by shape and K4's statistics by launch,
   by device time (phase_norm_shapes, which also measures a parent tree's
   package when this file is loaded by path from the parent's directory);
15. the tools slice: the five A/B and ablation tools of the port
   (pixelwiseregression_tpu_torch/tools) at their default shapes with few
   rounds, each through its kernels, with the launches of K5, K3 and each
   K6 piece asserted, and the head unit's dots_only, conv_only and full
   side by side;
16. the port bench (pixelwiseregression_tpu_torch/bench.py) in this
   process at its defaults (stage 1, batch 256, bf16, 16 calls a sample):
   the model's forward, the unit engine and the fused engine, then stage 2
   with the train line (batch 128), stage 2 in f32, then stage 1 with the
   int8 serving line (--serving: batch norm, bf16, int8_static_all, in
   turns with the headline); every line printed, none an error, the
   launches of each line's counted call over every counter of
   tools/ab_common.COUNTERS (17 K3, 1 K4 with its 29 kernels and its tail,
   K1 a stage, 12 conv3x3_f32 in the f32 forward, K1 and K2 a stage a
   train step, K1 and 42 torch._int_mm for the serving line) and of each
   whole run asserted.

After the CLI path (8.) comes the serving chain (phase_serving_chain): the
full-width NYU Predictor at its defaults (instance norm, f32, K1; batch
32; 4 requests: 8 K1 and 48 conv3x3_f32 launches, one CUDA graph
captured and 3 replays, asserted) exported to a .pwrsrv and served from a
fresh process that cannot import the port's models, its serve module or
jax (2 K1 launches a request, read there; uvd within 1e-4 of the live
Predictor), a poly-batch artifact at request sizes 1 and 5, the HTTP
server over the artifact with 8 concurrent clients of 4 frames a burst
(replies equal to direct predicts, device_calls < requests, p50/p99 and frames/s), the bf16
batch-norm int8_static_all Predictor (4 calibration requests, finite, K1
and torch._int_mm counted, timed in turns with bf16), the int8 conv at the
head shape card vs CPU (int32 accumulators bit-exact) and timed beside
cuDNN's bf16 conv, and a small f32 batch-norm int8_static_all model card
vs CPU.

Then the last of the JAX package's modules, on one MSRA fixture:
phase_fullreg runs the FullRegression family through its entry points at
full width (train_fullregression's run_training bf16 b32 2 epochs,
test_fullregression's run_inference f32, Predictor.from_checkpoint within
1e-2 of the Result file, the artifact in a fresh process that cannot import
the models), K1 and K2 asserted 0 throughout (the family has no decoder),
samples/s per epoch and frames/s printed; phase_paired holds the paired
heads' four forms against the plain heads (full-width NYU f32 Predictor,
the serving default's instance norm, the four requests, K1 twice a
request; uvd within 1e-4 px/mm or twice the plain model's own card-vs-CPU
gap) and runs tools/bench_paired_model at b256 bf16, stages 1 and 2;
phase_ddp takes one full-width bf16 train step at a global batch of 128
on two ranks sharing the card (spawned processes of
tests/torch_port_ddp_worker.py, gloo with CUDA tensors, instance_anchored
and batch norm; K1 and K2 counted in each rank), holds each rank against
the one-process step on the same batch and draws (loss 1e-3, whole
gradient 1e-1 relative) and both ranks' states equal, times three more
steps of each, then runs train_msra under torchrun --nproc_per_node 1
(NCCL) for an epoch.

Then phase_scripts, the last scripts of the JAX package through the port's
tools and viewers, each with the kernel counters set to 0 just before it
and read just after: profile_train_components on the train step at full
width (b128, stage 2, bf16, 3 traced steps; its component table printed,
summing to the trace's device time within 1%, no kernel unattributed, K1
in [fwd] and K2 in [bwd] of each stage, each stage's hourglass and heads
both ways, and the time by module class and kernel group), profile_components,
profile_train, profile_infer, train_ab, train_remat_ab, bench_norm_variants
and bench_upsample_add at reduced sizes, headconv_bwd_split at its default
shape (its two summary lines printed), stage2_amplification on the MSRA
fixture (one seed, 20 steps), check_data_layout on it, bench_http against
serve_http over a live full-width Predictor, and test_samples' and get_sfr's
compute functions on a small random-weight checkpoint (nothing is drawn).
Before phase_tools, phase_conv3x3: the heads' f32 3x3 conv
(csrc/conv3x3_f32.cu) at [128|32, 128, 64, 64] 128->128, its device time
beside the f32 bound, cuDNN's f32 conv (TF32 off) as its heuristic picks it
and in benchmark mode, and each one's largest error to a float64 conv.
Then phase_v2v: V2V-PoseNet's voxeliser (csrc/voxelize.cu) at the V2V train
cell's shape, [32, 480, 640] NYU frames to [32, 1, 88, 88, 88] grids, bit
for bit against its plain version, its device time beside the bytes bound;
and the V2V train step at full width for three steps, asserting one
voxeliser launch and 32 frames a step.

After the build it fails if ptxas reports a spill in K3's wgmma conv, in
K6's xm_dots (the same loop), in K4's tail kernel, in the norm kernels
(K3's norm_kernel, K5's nr_kernel), in the decoder's (K1, K2 and the
dlabel kernel), in the f32 3x3 conv's or in the voxeliser's. With --conv
it builds the kernels and runs phase_conv3x3 alone; with --v2v, phase_v2v
alone.
With --profile it builds the kernels and profiles the train step of 5.
instead (phase_profile, through tools/profile_train.py; the JAX tools'
synthetic raw frames): the breakdown that PERF.md's "Where the time goes"
quotes; then K4's tail kernel's device time a ResBlock in one wave of
blocks (_tail_per_block), and the fused engine's forward at batch 64 by
kernel, with K4's share (_engine_by_kernel). With --decoder it builds the
kernels and runs phase_decoder_device alone; with --decoder DIR it runs it
on the package of the tree at DIR (a parent from `git archive`) and on this
one in turns, DIR, this, this, DIR, each in its own process.

The script exits non-zero, printing no result, when no CUDA device is
visible or any check fails. Its last line is a JSON object naming the card;
the line before it lists the kernels with their launches on each path
(serve, train, train_preprocessed, cli_train, cli_test, artifact, http, int8_serve,
unit_engine, fused_engine, tools, bench, paired_serve, paired_tool,
ddp_train a rank, fullreg_train, fullreg_test, fullreg_artifact, and
scripts_<tool> for each script of phase_scripts that launched it,
v2v_train),
their times, their plain versions' and a library call's, and their bounds:
the larger of the bytes they must move over 3.35 TB/s and their operations
over the peak rate of their type (989 TFLOP/s bf16 tensor cores, 67 TFLOP/s
f32), for an H100 SXM.
"""

from __future__ import annotations

import contextlib
import io
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
HAND17_J = 21       # HANDS 2017 joints: the box-serving path's K1 rows
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
# steps on preprocessed batches (make_train_step(None)), first step vs
# phase_train's first raw step from the same weights, batch and draws.
# Written before the first run: after preprocessing the two run the same
# ops on the same tensors, so the loss and gradient are expected bit-equal,
# unless a cuDNN backward that sums in a run-dependent order moves the
# gradient (then by ~1e-3 relative at most); bounds 1e-6 and 1e-2
PRE_LOSS_GAP_BOUND = 1e-6
PRE_GRAD_GAP_BOUND = 1e-2
PRE_STEPS = 3
# the eval step on a preprocessed batch vs the raw eval step: err_sum_mm
# within 1e-5 relative, count exactly
PRE_EVAL_BOUND = 1e-5
UNIT_BATCH = 256    # K3 and K4 alone, at bench.py's batch
# the heads' f32 3x3 conv alone: the train cells' and the serving batch
CONV_BATCHES = (128, 32)
# conv3x3_f32 launches a full-width f32 forward: the heads' 128->128 3x3
# convs, 3 a head, 2 heads a stage (a bf16, int8 or FullRegression forward: 0)
CONVS = 6 * STAGES
# the conv3x3_f32 launches of each main path the phases drive, by path,
# each counter set to 0 just before the path and read just after it;
# phase_conv3x3's own calls are not among them
CONV_LAUNCHES = {}
# V2V-PoseNet's train cell: NYU frames [32, 480, 640] voxelised into
# [32, 1, 88, 88, 88] grids, at full width (J 14), three steps
V2V_BATCH, V2V_SIDE, V2V_STEPS = 32, 88, 3
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


def _turns(fns, runs=7, iters=20):
    """Each of ``fns`` timed in turns by ``tools/ab_common``'s sampler and
    estimator: ``runs`` samples of ``iters`` back-to-back calls between CUDA
    events, after a warm call. Returns each one's (median ms a call, spread
    = (max - min) / median); raises if a sampler failed."""
    from pixelwiseregression_tpu_torch.tools import ab_common

    device = torch.device("cuda")
    out = []
    for med, quality in ab_common.interleaved_estimate(
            [ab_common.make_sampler(fn, device, iters) for fn in fns], runs):
        if med is None:
            raise RuntimeError(f"timing failed: {quality['error']}")
        out.append((med * 1e3, quality["spread_pct"] / 100))
    return out


def _decoder_rows(device, b, hw, gen, dtype=torch.float32, joints=J):
    """Decoder inputs [b, joints, hw] (label and mask [b, 1, hw]) in dtype;
    sample 0's mask is all zero (den = 1e-14: must give finite zeros)."""
    x = 3 * torch.randn(b, joints, hw, generator=gen, device=device)
    dm = torch.randn(b, joints, hw, generator=gen, device=device)
    label = torch.randn(b, 1, hw, generator=gen, device=device)
    mask = (torch.rand(b, 1, hw, generator=gen, device=device) > 0.4).float()
    mask[0] = 0.0
    w = torch.rand(joints, generator=gen, device=device) + 0.5
    return (*(t.to(dtype) for t in (x, dm, label, mask)), w)


# K1 against its plain version: (batch, map side, joints, maps in, heatmaps
# out, timed). 64x64 is the main path's map (the on-chip plan); 128x128 a row
# too long to hold on chip (the streamed plan); all four dtype forms on each;
# [32, 21, 64*64] f32 the HANDS 2017 box-serving cell's rows
KERNEL_CASES = (
    *((b, H, J, dt, dt, True) for b in (32, TRAIN_BATCH, 256)
      for dt in (torch.float32, torch.bfloat16)),
    (32, H, J, torch.float32, torch.bfloat16, False),
    (32, H, J, torch.bfloat16, torch.float32, False),
    (32, H, HAND17_J, torch.float32, torch.float32, True),
    *((8, 2 * H, J, dt, ht, False) for dt in (torch.float32, torch.bfloat16)
      for ht in (torch.float32, torch.bfloat16)),
)


def phase_kernel(cs, plain, device):
    """Kernel vs plain version on the card, on both plans and in all four
    dtype forms, two calls bit-identical; returns the timed cases (call
    time by CUDA events) by (batch, maps in, joints)."""
    gen = torch.Generator(device=device).manual_seed(SEED)
    cases = {}
    for b, side, joints, dtype, hm_dtype, timed in KERNEL_CASES:
        hw = side * side
        x, dm, label, mask, w = _decoder_rows(device, b, hw, gen, dtype, joints)
        plan = cs.plan(hw)["plan"]
        assert plan == ("on_chip" if side <= H else "streamed"), (side, plan)

        def kernel():
            return cs.decode_flat(x, dm, label, mask, w, side, side, hm_dtype=hm_dtype)

        def reference():
            hm, uvd = plain(x, dm, label, mask, w, side, side)
            return hm.to(hm_dtype), uvd

        hm_k, uvd_k = kernel()
        again = kernel()
        hm_p, uvd_p = reference()
        torch.cuda.synchronize()
        assert torch.equal(hm_k, again[0]) and torch.equal(uvd_k, again[1]), "two calls differ"
        if hm_dtype == torch.float32:
            # both compute in f32; only the summation order differs
            torch.testing.assert_close(hm_k, hm_p, rtol=1e-5, atol=1e-8)
        else:
            # p >= 0, so bf16 bit patterns order like the values: 1 ulp = 1 step
            ulps = (hm_k.view(torch.int16).int() - hm_p.view(torch.int16).int()).abs().max()
            assert int(ulps) <= 1, f"bf16 heatmaps differ by {int(ulps)} ulp"
        torch.testing.assert_close(uvd_k, uvd_p, rtol=1e-5, atol=1e-6)
        err = max(float((hm_k.float() - hm_p.float()).abs().max()),
                  float((uvd_k - uvd_p).abs().max()))
        form = f"{_DT[dtype]}->{_DT[hm_dtype]}"
        line = (f"kernel softargmax_fwd [{b},{joints},{hw}] {form} plan {plan}: "
                f"max_abs_err={err:.3e}")
        if timed:
            ms, plain_ms = _turns([kernel])[0][0], _turns([reference])[0][0]
            line += f" call_ms={ms:.5f} plain_ms={plain_ms:.5f}"
            cases[(b, _DT[dtype], joints)] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
        print(line)
        del x, dm, label, mask, hm_k, hm_p, again
    return cases


def _count_convs(path, n, want):
    """Record ``n`` conv3x3_f32 launches on ``path`` in CONV_LAUNCHES and
    assert that they are ``want``."""
    CONV_LAUNCHES[path] = n
    assert n == want, f"{path}: {n} conv3x3_f32 launches, expected {want}"


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
    from pixelwiseregression_tpu_torch.ops import cuda_conv
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

    cs.LAUNCHES = cuda_conv.LAUNCHES = 0
    outs = []
    for raw in requests:
        before = cs.LAUNCHES
        outs.append(preds["cuda"].predict(raw["frame"], raw["com"]))
        assert cs.LAUNCHES - before == STAGES, f"{cs.LAUNCHES - before} launches for one request"
    torch.cuda.synchronize()
    launches = cs.LAUNCHES
    assert launches == STAGES * len(requests), launches
    _count_convs("serve_bf16", cuda_conv.LAUNCHES, 0)

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


def phase_serve_boxes(cs, device):
    """HANDS 2017's box requests at full width (21 joints, instance norm,
    f32, batch 32): one request of 32 synthetic 480x640 frames, a hand
    before a slanted wall, with a box each and no centre, through the cuda
    and the plain decoder from the same weights; the K1 launches of the
    request, asserted; the same centres from both; the answers within
    NORM_GAP_BOUND normalized. Returns the request's K1 launches."""
    from pixelwiseregression_tpu_torch.data.sources import SPECS
    from pixelwiseregression_tpu_torch.models.pixelwise import PixelwiseRegression
    from pixelwiseregression_tpu_torch.ops import cuda_conv
    from pixelwiseregression_tpu_torch.serve import Predictor
    from pixelwiseregression_tpu_torch.utils.synth import make_synthetic_raw_batch

    spec = SPECS["HAND17"]
    assert spec.joint_number == HAND17_J, spec.joint_number
    torch.manual_seed(SEED)
    state = PixelwiseRegression(HAND17_J, stage=STAGES, features=128, level=4, kernel_size=3,
                                norm_method="instance").state_dict()
    kw = dict(batch_size=32, stages=STAGES, features=128, level=4, label_size=64,
              norm_method="instance", heatmap_method="softmax", filter_size=3)
    preds = {d: Predictor.from_state_dict(state, "HAND17", device, decoder=d, **kw)
             for d in ("cuda", "torch")}
    raw = make_synthetic_raw_batch(32, spec.frame_h, spec.frame_w, HAND17_J, fx=spec.camera.fx,
                                   fy=spec.camera.fy, cube=spec.cube_size, com_z=500.0,
                                   seed=SEED)
    # a wall 150-450 mm behind the hand, so that the box's cuts remove pixels
    xx = np.arange(spec.frame_w)[None, None, :]
    frames = np.where(raw["frame"] > 0, raw["frame"],
                      np.round(800.0 + (xx - spec.frame_w / 2) * 1.0)).astype(np.float32)
    s = raw["box_size"][:, None].astype(np.float64) / 2
    boxes = np.concatenate([raw["com"][:, :2] - s, 2 * s, 2 * s], axis=1)

    before = cs.LAUNCHES
    cuda_conv.LAUNCHES = 0
    out = preds["cuda"].predict(frames, boxes=boxes)
    torch.cuda.synchronize()
    launches = cs.LAUNCHES - before
    assert launches == STAGES, f"{launches} K1 launches for one box request"
    _count_convs("serve_boxes", cuda_conv.LAUNCHES, CONVS)
    ref = preds["torch"].predict(frames, boxes=boxes)
    assert np.array_equal(out["com"], ref["com"]), "the decoders' requests localised apart"
    for key in ("uvd", "xyz"):
        assert out[key].shape == (32, HAND17_J, 3) and np.isfinite(out[key]).all(), key
    d = np.abs(out["uvd"] - ref["uvd"]).astype(np.float64)
    half = spec.cube_size / out["com"][:, 2] * spec.camera.fx
    gap_norm = max(float((d[..., :2] / (2 * half[:, None, None])).max()),
                   float((d[..., 2] / spec.cube_size).max()))
    print(f"serve HAND17 boxes stages={STAGES} f32 batch=32 J={HAND17_J}: K1 launches={launches} "
          f"centre u {out['com'][:, 0].min():.2f}-{out['com'][:, 0].max():.2f} "
          f"d {out['com'][:, 2].min():.1f}-{out['com'][:, 2].max():.1f} mm; "
          f"largest gap cuda vs torch decoder {gap_norm:.3e} normalized, "
          f"{float(d[..., :2].max()):.4f} px, {float(d[..., 2].max()):.4f} mm")
    assert gap_norm <= NORM_GAP_BOUND, f"decoders disagree by {gap_norm:.3e} normalized"
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


def phase_backward(cs, plain, device):
    """K2 through the decoder's autograd.Function vs autograd of the plain
    decoder, on both plans, with the label image requiring grad (two
    kernels: dlabel asked) and not (one kernel, as on the training path);
    two calls bit-identical, dlabel equal to ddm summed over j in order."""
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    cases = {}
    for b, side in ((32, H), (TRAIN_BATCH, H), (4, 2 * H)):
        hw = side * side
        x, dm, label, mask, w = _decoder_rows(device, b, hw, gen)
        g_hm = torch.randn(b, J, hw, generator=gen, device=device) * 1e-3
        g_uvd = torch.randn(b, J, 3, generator=gen, device=device)
        plan = cs.plan(hw)["plan"]
        assert plan == ("on_chip" if side <= H else "streamed"), (side, plan)

        def grads(decode, label_grad):
            leaves = [t.clone().requires_grad_(i != 2 or label_grad)
                      for i, t in enumerate((x, dm, label, w))]
            hm, uvd = decode(leaves[0], leaves[1], leaves[2], mask, leaves[3], side, side)
            torch.autograd.backward((hm, uvd), (g_hm, g_uvd))
            return [t.grad for t in leaves]

        err = 0.0
        for label_grad in (True, False):
            before = (cs.BWD_LAUNCHES, cs.BWD_KERNEL_LAUNCHES)
            got = grads(cs.decode_flat, label_grad)
            torch.cuda.synchronize()
            kernels = cs.BWD_KERNEL_LAUNCHES - before[1]
            assert (cs.BWD_LAUNCHES - before[0], kernels) == (1, 2 if label_grad else 1), kernels
            again = grads(cs.decode_flat, label_grad)
            want = grads(plain, label_grad)
            for name, g, a, r in zip(("dx", "ddm", "dlabel", "dw"), got, again, want):
                if g is None:
                    assert name == "dlabel" and not label_grad and a is None
                    continue
                assert torch.isfinite(g).all(), f"non-finite {name}"
                assert torch.equal(g, a), f"two calls differ in {name}"
                torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-6, msg=name)
                err = max(err, float((g - r).abs().max()))
            assert float(got[1][0].abs().max()) == 0.0
            if label_grad:
                assert float(got[2][0].abs().max()) == 0.0
                fixed = torch.zeros_like(got[2][:, 0])
                for j in range(J):  # the dlabel kernel's order
                    fixed = fixed + got[1][:, j]
                assert torch.equal(got[2][:, 0], fixed), "dlabel is not ddm summed in j order"
        line = (f"kernel softargmax_bwd [{b},{J},{hw}] f32 plan {plan}, with and without "
                f"dlabel (2 and 1 kernels): max_abs_err={err:.3e}")
        if side == H:
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

            ms, plain_ms = _turns([k_bwd])[0][0], _turns([p_bwd])[0][0]
            fb_ms, fb_plain_ms = (_turns([fwd_bwd(cs.decode_flat)])[0][0],
                                  _turns([fwd_bwd(plain)])[0][0])
            line += (f" bwd call_ms={ms:.5f} plain_ms={plain_ms:.5f}; fwd+bwd call_ms={fb_ms:.5f} "
                     f"plain_ms={fb_plain_ms:.5f}")
            cases[b] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
            del out, leaves
        print(line)
        del x, dm, label, mask, g_hm
    return cases


# the decoder's main-path shapes [b, J, H*W]: (path, batch, map dtype, heatmap dtype)
DECODER_SHAPES = (("train", TRAIN_BATCH, torch.float32, torch.float32),
                  ("serve", 32, torch.bfloat16, torch.bfloat16),
                  ("engines", ENGINE_BATCH, torch.bfloat16, torch.bfloat16))


def phase_decoder_device(device):
    """K1 at each of DECODER_SHAPES and K2 at the train shape, with and
    without dlabel: a call's device time (a CUDA graph of calls,
    `_graph_us`) beside the wrapper call's CUDA-event time (back to back,
    host work included), each with its bound and the plan it ran. It
    imports the port lazily, so that a parent tree's package can be
    measured by it (`--decoder DIR`); a form or plan query that tree lacks
    reads None."""
    import inspect

    from pixelwiseregression_tpu_torch.ops import cuda_softargmax as cs

    gen = torch.Generator(device=device).manual_seed(SEED + 4)
    plan = getattr(cs, "plan", None)
    out = {}

    def row(fn, bound):
        dev_ms, call_ms = _graph_us(fn) / 1e3, _turns([fn])[0][0]
        return {"device_ms": dev_ms, "call_ms": call_ms, "bound_ms": bound[0],
                "bound_by": bound[1], "bound_share": bound[0] / dev_ms}

    for path, b, dt, ht in DECODER_SHAPES:
        x, dm, label, mask, w = _decoder_rows(device, b, H * W, gen, dt)
        out[f"fwd {path}"] = {
            **row(lambda: cs.decode_flat(x, dm, label, mask, w, H, W, hm_dtype=ht),
                  _decoder_bound("fwd", b, dt.itemsize, ht.itemsize)),
            "shape": [b, J, H * W], "dtype": f"{_DT[dt]} -> {_DT[ht]}",
            "plan": plan(H * W)["plan"] if plan else None}
        del x, dm, label, mask
    x, dm, label, mask, w = _decoder_rows(device, TRAIN_BATCH, H * W, gen)
    g_hm = torch.randn(x.shape, generator=gen, device=device) * 1e-3
    g_uvd = torch.randn(TRAIN_BATCH, J, 3, generator=gen, device=device)
    takes_dlabel = "dlabel" in inspect.signature(cs.decode_flat_backward).parameters
    for form, dlabel in (("with dlabel", True), ("without dlabel", False)):
        if not dlabel and not takes_dlabel:
            out[f"bwd train {form}"] = None
            continue
        kw = {"dlabel": dlabel} if takes_dlabel else {}
        out[f"bwd train {form}"] = {
            **row(lambda: cs.decode_flat_backward(x, dm, label, mask, w, g_hm, g_uvd, H, W, **kw),
                  _decoder_bound("bwd", TRAIN_BATCH, dlabel=dlabel)),
            "shape": [TRAIN_BATCH, J, H * W], "dtype": "f32",
            "plan": plan(H * W)["plan"] if plan else None}
    for key, r in out.items():
        print(f"decoder device {key}: " + ("not in this tree" if r is None else
              f"{r['shape']} {r['dtype']} plan {r['plan']}: device_ms={r['device_ms']:.5f} "
              f"call_ms={r['call_ms']:.5f} bound_ms={r['bound_ms']:.5f} ({r['bound_by']}), "
              f"{r['bound_share']:.3f} of the bound"))
    del x, dm, label, mask, g_hm
    _free()
    return out


def decoder_ab(parent):
    """`--decoder [DIR]`: phase_decoder_device on this tree's package, or,
    given the root of another tree (a parent from `git archive`), on that
    tree's package and this one's in turns (DIR, this, this, DIR), each in
    its own process (the two packages share a name)."""
    here = os.path.dirname(os.path.abspath(__file__))
    trees = [here] if parent is None else [parent, here, here, parent]
    code = ("import importlib.util, json, sys, torch\n"
            "sys.path.insert(0, sys.argv[1])\n"
            "spec = importlib.util.spec_from_file_location('smoke', sys.argv[2])\n"
            "smoke = importlib.util.module_from_spec(spec)\n"
            "spec.loader.exec_module(smoke)\n"
            "lib, _ = __import__('pixelwiseregression_tpu_torch.ops.cuda_lib',\n"
            "                    fromlist=['build']).build()\n"
            "print('tree', sys.argv[1], 'library', lib.name, flush=True)\n"
            "smoke.phase_decoder_device(torch.device('cuda:0'))\n")
    for tree in trees:
        subprocess.run([sys.executable, "-c", code, os.path.abspath(tree),
                        os.path.abspath(__file__)], cwd=tree, check=True, timeout=600)


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
    """The training path at full width; returns the (K1, K2, K2's kernels)
    launches of its main run, and what phase_train_preprocessed starts from:
    the initial weights, the raw batch, the first step's draws and the first
    step's loss and gradient."""
    from pixelwiseregression_tpu_torch.data.preprocess import draw_augmentation
    from pixelwiseregression_tpu_torch.data.sources import SPECS
    from pixelwiseregression_tpu_torch.models.pixelwise import PixelwiseRegression
    from pixelwiseregression_tpu_torch.ops import cuda_conv
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
    cs.LAUNCHES = cs.BWD_LAUNCHES = cs.BWD_KERNEL_LAUNCHES = cuda_conv.LAUNCHES = 0
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
    launches = (cs.LAUNCHES, cs.BWD_LAUNCHES, cs.BWD_KERNEL_LAUNCHES)
    # label_img needs no gradient: K2 is one kernel a call (no dlabel)
    assert launches == (STAGES * TRAIN_STEPS,) * 3, launches
    _count_convs("train_bf16", cuda_conv.LAUNCHES, 0)
    assert all(np.isfinite(losses)), losses
    print(f"train NYU stages={STAGES} bf16 batch={TRAIN_BATCH} augmented: {TRAIN_STEPS} steps "
          f"in {seconds:.2f} s (first step included), launches K1={launches[0]} "
          f"K2={launches[1]} in {launches[2]} kernels, losses {[round(v, 5) for v in losses]}")

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
    return launches, {"state0": state0, "batch": batch, "draws0": draws0, "first": first}


def _warp_images(batch, data, i):
    """Sample i's depth images at 480x640 (the raw frame, mm on a zero
    background) and at 128x128 (the centred crop, mm), each beside the ramps
    value = x and value = y."""
    out = {}
    for name, depth in (("frame", batch["frame"][i]),
                        ("crop", data["img"][i, ..., 0] * batch["cube"][i])):
        h, w = depth.shape
        out[name] = {"depth": depth.float().contiguous(),
                     "ramp_x": torch.arange(w, dtype=torch.float32, device=depth.device)
                     .expand(h, w).contiguous(),
                     "ramp_y": torch.arange(h, dtype=torch.float32, device=depth.device)[:, None]
                     .expand(h, w).contiguous()}
    return out


def _quantized_warp_card_vs_cpu(device, batch, data):
    """cv2's fixed-point warp (warp_affine_inverse(quantize=True)) on the
    card vs the CPU, at 480x640 and 128x128, on ramps and a depth image, by
    inverse rotation/scale matrices (angles in +-30 degrees, scales
    0.8-1.2) and one random affine: bit-equal."""
    from pixelwiseregression_tpu_torch.ops.image import (rotation_matrix_inverse,
                                                         warp_affine_inverse)

    rng = np.random.RandomState(SEED + 160)
    for name, images in _warp_images(batch, data, 0).items():
        h, w = images["depth"].shape
        angles = torch.from_numpy(rng.uniform(-30, 30, 7).astype(np.float32))
        scales = torch.from_numpy(rng.uniform(0.8, 1.2, 7).astype(np.float32))
        affine = np.array([[1 + rng.uniform(-0.2, 0.2), rng.uniform(-0.3, 0.3),
                            rng.uniform(-6, 6), rng.uniform(-0.3, 0.3),
                            1 + rng.uniform(-0.2, 0.2), rng.uniform(-6, 6)]], np.float32)
        minv = torch.cat([rotation_matrix_inverse(angles, scales, w / 2, h / 2),
                          torch.from_numpy(affine)])
        for kind, img in images.items():
            imgs = img.expand(len(minv), h, w).contiguous()
            card = warp_affine_inverse(imgs, minv.to(device), quantize=True).cpu()
            cpu = warp_affine_inverse(imgs.cpu(), minv, quantize=True)
            differ = int((card != cpu).sum())
            assert differ == 0 and torch.isfinite(card).all(), (name, kind, differ)
        print(f"quantized warp card vs CPU at {h}x{w}: ramp x, ramp y and {name} depth, "
              f"{len(minv)} matrices each, bit-equal")


def phase_train_preprocessed(cs, device, ref):
    """The train and eval steps on preprocessed batches (make_train_step(None),
    make_eval_step(None)) at phase_train's width, weights, batch and first
    draws: PRE_STEPS steps through K1 and K2 (K1 = K2 = STAGES launches a
    step, K2 one kernel a call), the first held against phase_train's first
    raw step and against the plain decoder's; the eval step on a preprocessed
    batch against the raw eval step; cv2's fixed-point warp card vs CPU.
    Returns the (K1, K2, K2's kernels) launches of the steps."""
    from pixelwiseregression_tpu_torch.data.preprocess import preprocess_batch
    from pixelwiseregression_tpu_torch.data.sources import SPECS
    from pixelwiseregression_tpu_torch.train.loop import (LossConfig, make_eval_step,
                                                           make_train_step)

    batch, loss_cfg = ref["batch"], LossConfig(lambda_h=1.0, lambda_d=0.01, alpha=1.0)
    with torch.no_grad():
        data = preprocess_batch(batch, _train_cfg(), augment=True, draws=ref["draws0"])
    step = make_train_step(None, loss_cfg)
    state = _train_setup(device, "cuda", torch.bfloat16, ref["state0"], TRAIN_BATCH)
    torch.cuda.synchronize()
    cs.LAUNCHES = cs.BWD_LAUNCHES = cs.BWD_KERNEL_LAUNCHES = 0
    losses, t = [], time.perf_counter()
    for i in range(PRE_STEPS):
        before = (cs.LAUNCHES, cs.BWD_LAUNCHES, cs.BWD_KERNEL_LAUNCHES)
        m = step(state, data)
        got = (cs.LAUNCHES - before[0], cs.BWD_LAUNCHES - before[1],
               cs.BWD_KERNEL_LAUNCHES - before[2])
        assert got == (STAGES,) * 3, f"step {i}: K1, K2 and K2's kernels {got}"
        if i == 0:
            first = {"loss": float(m["loss"]), "grads": _grads(state.model)}
        losses.append(float(m["loss"]))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    launches = (cs.LAUNCHES, cs.BWD_LAUNCHES, cs.BWD_KERNEL_LAUNCHES)
    assert launches == (STAGES * PRE_STEPS,) * 3, launches
    assert all(np.isfinite(losses)), losses
    raw_first = ref["first"]
    loss_gap = abs(first["loss"] - raw_first["loss"]) / abs(raw_first["loss"])
    grad_gap = _whole_gap(first["grads"], raw_first["grads"])
    print(f"train on preprocessed batches NYU stages={STAGES} bf16 batch={TRAIN_BATCH}: "
          f"{PRE_STEPS} steps in {seconds:.2f} s, launches K1={launches[0]} K2={launches[1]} in "
          f"{launches[2]} kernels, losses {[round(v, 5) for v in losses]}; first step vs the raw "
          f"step: loss {first['loss']:.6f} vs {raw_first['loss']:.6f} (relative gap "
          f"{loss_gap:.3e}), whole-gradient relative gap {grad_gap:.3e}")
    assert loss_gap <= PRE_LOSS_GAP_BOUND, loss_gap
    assert grad_gap <= PRE_GRAD_GAP_BOUND, grad_gap

    plain = _train_setup(device, "torch", torch.bfloat16, ref["state0"], TRAIN_BATCH)
    m = step(plain, data)
    loss_gap = abs(float(m["loss"]) - first["loss"]) / abs(float(m["loss"]))
    grad_gap = _whole_gap(first["grads"], _grads(plain.model))
    print(f"train on preprocessed batches, first step, kernel vs plain decoder: relative loss "
          f"gap {loss_gap:.3e}, whole-gradient relative gap {grad_gap:.3e}")
    assert loss_gap <= LOSS_GAP_BOUND, loss_gap
    assert grad_gap <= GRAD_GAP_BOUND, grad_gap
    del plain

    cfg_eval, cam = _train_cfg(augment=False), SPECS["NYU"].camera
    n_real = TRAIN_BATCH - TRAIN_BATCH // 16
    weight = (torch.arange(TRAIN_BATCH, device=device) < n_real).float()
    want = make_eval_step(cfg_eval, loss_cfg, cam)(state, {**batch, "weight": weight})
    with torch.no_grad():
        clean = preprocess_batch(batch, cfg_eval)
    got = make_eval_step(None, loss_cfg, cam)(state, {**clean, "weight": weight})
    err_gap = float(((got["err_sum_mm"] - want["err_sum_mm"]).abs() / want["err_sum_mm"].abs())
                    .max())
    print(f"eval on a preprocessed batch vs the raw eval step: err_sum_mm "
          f"{[round(v, 4) for v in got['err_sum_mm'].tolist()]} vs "
          f"{[round(v, 4) for v in want['err_sum_mm'].tolist()]} (largest relative gap "
          f"{err_gap:.3e}), count {int(got['count'])} vs {int(want['count'])}")
    assert err_gap <= PRE_EVAL_BOUND, err_gap
    assert float(got["count"]) == float(want["count"]) == n_real
    _quantized_warp_card_vs_cpu(device, batch, clean)
    return launches


def phase_train_f32(cs, device):
    """The training CLI's default precision (f32, --mixed_precision off) at
    batch 32: 3 steps, K1, K2 and conv3x3_f32 launches asserted."""
    from pixelwiseregression_tpu_torch.models.pixelwise import PixelwiseRegression
    from pixelwiseregression_tpu_torch.ops import cuda_conv
    from pixelwiseregression_tpu_torch.train.loop import LossConfig, make_train_step

    torch.manual_seed(SEED + 3)
    state0 = PixelwiseRegression(J, stage=STAGES, features=128, level=4,
                                 norm_method="instance_anchored").state_dict()
    state = _train_setup(device, "cuda", torch.float32, state0, 32)
    step = make_train_step(_train_cfg(), LossConfig(), augment=True)
    batch = _raw_batch(device, 32, SEED + 30)
    gen = torch.Generator(device=device).manual_seed(SEED + 31)
    before = (cs.LAUNCHES, cs.BWD_LAUNCHES, cs.BWD_KERNEL_LAUNCHES)
    cuda_conv.LAUNCHES = 0
    losses = [float(step(state, batch, generator=gen)["loss"]) for _ in range(3)]
    assert (cs.LAUNCHES - before[0], cs.BWD_LAUNCHES - before[1],
            cs.BWD_KERNEL_LAUNCHES - before[2]) == (3 * STAGES,) * 3
    _count_convs("train_f32", cuda_conv.LAUNCHES, 3 * CONVS)
    assert all(np.isfinite(losses)), losses
    print(f"train NYU stages={STAGES} f32 batch=32: 3 steps, conv3x3_f32 launches "
          f"{CONV_LAUNCHES['train_f32']}, losses {[round(v, 5) for v in losses]}")


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


CLI_FRAMES = 16      # MSRA fixture frames a subject: 9 x 16, subject 0 held out
CLI_BATCH = 32
CLI_EPOCHS = 2
CLI_RESULT_BOUND = 1e-2  # px for u and v, mm for d: the cuda vs torch decoder Result files


def _epoch_lines(text):
    """(train loss, val mean-mm per stage, samples/s) of each printed epoch line."""
    import re

    pat = r"train_loss ([0-9.e+-]+)\s+val mean-mm \[([^\]]+)\]\s+\(([0-9.]+) samples/s\)"
    return [(float(a), [float(v) for v in b.split()], float(c))
            for a, b, c in re.findall(pat, text)]


def phase_cli(cs, device, smi_line):
    """The port's own entry points on the card, the path a user runs first:
    raw MSRA files -> index (check_dataset's device check) -> threaded Loader
    -> run_training at the CLI's default width (stages 2, features 128, level
    4, instance_anchored, bf16 under --mixed_precision, decoder cuda) ->
    per-epoch checkpoints and the final alias -> run_inference (f32) with the
    cuda and the torch decoder -> Result files, and Predictor.from_checkpoint
    on the same .pt. Returns the launches of K1 (train and test) and K2."""
    import contextlib
    import shutil
    import tempfile

    from pixelwiseregression_tpu_torch import native
    from pixelwiseregression_tpu_torch.cli.check_dataset import build_dataset
    from pixelwiseregression_tpu_torch.cli.common import make_test_parser, make_train_parser
    from pixelwiseregression_tpu_torch.cli.test_main import run_inference
    from pixelwiseregression_tpu_torch.cli.train_main import run_training
    from pixelwiseregression_tpu_torch.data.sources import get_source
    from pixelwiseregression_tpu_torch.ops import cuda_conv
    from pixelwiseregression_tpu_torch.serve import Predictor

    work = tempfile.mkdtemp(prefix="pwr_cli_")
    cwd, images = os.getcwd(), os.environ.get("PWR_TB_IMAGES")
    fixture = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures",
                           "make_msra_fixture.py")
    try:
        data = os.path.join(work, "msra")
        subprocess.run([sys.executable, fixture, data, str(CLI_FRAMES)], check=True,
                       capture_output=True, timeout=300)
        t = time.perf_counter()
        build_dataset("MSRA", data, device)
        lines = {split: len(get_source("MSRA", path=data, dataset=split, subject=0).lines)
                 for split in ("train", "val", "test")}
        print(f"cli: MSRA fixture {9 * CLI_FRAMES} frames, index built with the device check in "
              f"{time.perf_counter() - t:.2f} s: {lines}; native frame decoder "
              f"{'built' if native.available() else 'NOT built (numpy decoders ran)'}")
        assert lines == {"train": 8 * CLI_FRAMES, "val": CLI_FRAMES, "test": CLI_FRAMES}, lines
        steps_per_epoch = lines["train"] // CLI_BATCH
        steps = CLI_EPOCHS * steps_per_epoch
        val_batches = CLI_EPOCHS * -(-lines["val"] // CLI_BATCH)

        # the image logging's forward would launch K1 outside the counted steps
        os.environ["PWR_TB_IMAGES"] = "0"
        os.chdir(work)
        args = make_train_parser(msra=True).parse_args(
            ["--subject", "0", "--epoch", str(CLI_EPOCHS), "--batch_size", str(CLI_BATCH),
             "--mixed_precision", "--decoder", "cuda", "--seed", "1", "--data_path", data])
        assert (args.stages, args.features, args.level, args.norm_method) == \
            (STAGES, FEATURES, LEVEL, "instance_anchored")
        out = io.StringIO()
        torch.cuda.synchronize()
        cs.LAUNCHES = cs.BWD_LAUNCHES = cs.BWD_KERNEL_LAUNCHES = cuda_conv.LAUNCHES = 0
        t = time.perf_counter()
        with contextlib.redirect_stdout(out):
            best_epoch, best_err = run_training(args, "MSRA", subject=0)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        train = (cs.LAUNCHES, cs.BWD_LAUNCHES, cs.BWD_KERNEL_LAUNCHES)
        epochs = _epoch_lines(out.getvalue())
        for i, (loss, mm, sps) in enumerate(epochs):
            print(f"cli train epoch {i}: train_loss {loss:.5f}, val mean-mm {mm}, {sps:.1f} "
                  f"samples/s ({smi_line}; epoch 0 includes the first step's set-up)")
        print(f"cli train: {steps} steps and {val_batches} val batches in {seconds:.1f} s, "
              f"launches K1={train[0]} K2={train[1]} in {train[2]} kernels, best epoch "
              f"{best_epoch} at {best_err:.3f} mm")
        assert len(epochs) == CLI_EPOCHS and all(np.isfinite(e[0]) for e in epochs), epochs
        assert train == (STAGES * (steps + val_batches), STAGES * steps, STAGES * steps), train
        _count_convs("cli_train_bf16", cuda_conv.LAUNCHES, 0)
        assert np.isfinite(best_err)
        final = os.path.join(work, "Model", "MSRA_default_subject0_final.pt")
        ckpt = torch.load(final, map_location="cpu", weights_only=True)
        anchors = [v for k, v in ckpt["state_dict"].items() if k.endswith("anchor_n")]
        assert anchors and all(float(a) > 0 for a in anchors), "anchors not calibrated"
        assert ckpt["step"] == (best_epoch + 1) * steps_per_epoch and "optimizer" in ckpt
        assert all(torch.isfinite(v).all() for v in ckpt["state_dict"].values())

        results, test_launches, test_convs = {}, {}, {}
        for decoder in ("cuda", "torch"):
            targs = make_test_parser(msra=True).parse_args(
                ["--subject", "0", "--batch_size", str(CLI_BATCH), "--decoder", decoder,
                 "--data_path", data])
            cs.LAUNCHES = cuda_conv.LAUNCHES = 0
            with contextlib.redirect_stdout(io.StringIO()) as text:
                name, fps = run_inference(targs, "MSRA", subject=0)
            torch.cuda.synchronize()
            test_launches[decoder], test_convs[decoder] = cs.LAUNCHES, cuda_conv.LAUNCHES
            results[decoder] = np.loadtxt(os.path.join(work, name))
            print(f"cli test decoder={decoder} f32: {fps:.1f} frames/s, K1 launches "
                  f"{cs.LAUNCHES}, conv3x3_f32 launches {cuda_conv.LAUNCHES}; "
                  f"{text.getvalue().strip().splitlines()[-1]}")
        test_batches = -(-lines["test"] // CLI_BATCH)
        assert test_launches == {"cuda": STAGES * test_batches, "torch": 0}, test_launches
        for decoder, n in test_convs.items():
            _count_convs(f"cli_test_{decoder}", n, CONVS * test_batches)
        got, want = results["cuda"], results["torch"]
        gap = float(np.abs(got - want).max())
        uvd = got.reshape(-1, 21, 3)
        med = [float(np.median(uvd[:, :, i])) for i in range(3)]
        print(f"cli Result cuda vs torch decoder: largest gap {gap:.4f} (bound "
              f"{CLI_RESULT_BOUND}); medians u {med[0]:.2f} v {med[1]:.2f} d {med[2]:.2f}")
        assert got.shape == want.shape == (lines["test"], 63), got.shape
        assert np.isfinite(got).all() and np.isfinite(want).all()
        assert gap <= CLI_RESULT_BOUND, gap
        assert 100 < med[0] < 220 and 60 < med[1] < 180 and 300 < med[2] < 500, med

        # the test frames and their float64 hand centres, as the test CLI's records hold them
        src = get_source("MSRA", path=data, dataset="test", subject=0, test_only=True)
        raw = [src.load_raw(line) for line in src.lines]
        pred = Predictor.from_checkpoint(final, "MSRA", device, batch_size=CLI_BATCH,
                                         dtype=torch.float32, decoder="cuda")
        p_uvd = pred.predict(np.stack([r[0] for r in raw]), np.stack([r[2] for r in raw]))["uvd"]
        p_gap = float(np.abs(p_uvd.reshape(len(raw), -1) - got).max())
        print(f"cli Predictor.from_checkpoint vs the test CLI's Result: largest gap {p_gap:.4f}")
        assert p_gap <= CLI_RESULT_BOUND, p_gap
        return {"K1_train": train[0], "K1_test": test_launches["cuda"], "K2": train[1],
                "K2_kernels": train[2]}
    finally:
        os.chdir(cwd)
        if images is None:
            os.environ.pop("PWR_TB_IMAGES", None)
        else:
            os.environ["PWR_TB_IMAGES"] = images
        shutil.rmtree(work, ignore_errors=True)


SERVE_CHAIN_BATCH = 32
ARTIFACT_GAP_BOUND = 1e-4  # px / mm: the artifact runs the live Predictor's own function
HTTP_CLIENTS = 8           # concurrent clients a burst, each with HTTP_FRAMES frames
HTTP_FRAMES = 4
HTTP_BURSTS = 3
INT8_HEAD_BATCH = 4        # the int8 conv alone at the head shape, card vs CPU

_ARTIFACT_CHILD = """
import json, sys, time
class _Block:
    BLOCKED = ("jax", "flax", "pixelwiseregression_tpu", "pixelwiseregression_tpu_torch.models",
               "pixelwiseregression_tpu_torch.serve")
    def find_spec(self, name, *a, **k):
        if name in self.BLOCKED or any(name.startswith(b + ".") for b in self.BLOCKED):
            raise ImportError("blocked in the serving process: " + name)
sys.meta_path.insert(0, _Block())
import numpy as np, torch
from pixelwiseregression_tpu_torch.ops import cuda_conv as cc, cuda_softargmax as cs
from pixelwiseregression_tpu_torch.serve_artifact import ServingArtifact
path, reqs, out = sys.argv[1:4]
t = time.perf_counter()
art = ServingArtifact.load(path, "cuda:0")
load_s = time.perf_counter() - t
data = np.load(reqs)
launches, convs, uvd = [], [], {}
for i in range(len(data.files) // 2):
    before = (cs.LAUNCHES, cc.LAUNCHES)
    uvd[str(i)] = art.predict(data[f"frame{i}"], data[f"com{i}"])["uvd"]
    torch.cuda.synchronize()
    launches.append(cs.LAUNCHES - before[0])
    convs.append(cc.LAUNCHES - before[1])
np.savez(out, **uvd)
blocked = sorted(m for m in sys.modules if m.startswith(
    ("jax", "pixelwiseregression_tpu_torch.models", "pixelwiseregression_tpu_torch.serve.")))
print(json.dumps({"load_s": load_s, "launches": launches, "conv_launches": convs,
                  "imported_blocked": blocked}))
"""


def phase_serving_chain(cs, device, smi_line):
    """The deployment chain at full width (NYU, 14 joints, 2 stages, 128
    features, level 4, weights from a seed), as a user runs it: a Predictor
    at its defaults (instance norm, f32, K1; batch 32; its four requests
    launch K1 twice and the heads' conv 12 times each, the first eager and
    the other three replays of one CUDA graph, asserted) exported to a
    .pwrsrv, loaded in a fresh process that cannot import the port's models,
    its serve module or jax, answering the four requests (2 K1 launches a
    request, read there; uvd within ARTIFACT_GAP_BOUND of the live
    Predictor); a poly-batch artifact at request sizes 1 and 5 against live
    Predictors of those batch sizes; the HTTP server over the artifact, 8
    concurrent clients of 4 frames a burst (replies equal to the artifact's
    direct predict, device_calls < requests, p50/p99 and frames/s); the bf16
    batch-norm int8_static_all Predictor: 4 calibration requests and one
    more, finite, its K1 launches and torch._int_mm calls counted, timed in
    turns with the same model in bf16; the int8 conv alone at the head shape,
    card vs CPU (int32 accumulators bit-exact, output within 1 f32 ulp) and
    timed beside cuDNN's bf16 conv; a small f32 batch-norm int8_static_all
    model, card vs CPU. Returns the launches by path."""
    import tempfile
    import threading

    from pixelwiseregression_tpu_torch import serve
    from pixelwiseregression_tpu_torch.data.sources import SPECS
    from pixelwiseregression_tpu_torch.models import layers
    from pixelwiseregression_tpu_torch.models.pixelwise import PixelwiseRegression
    from pixelwiseregression_tpu_torch.ops import cuda_conv
    from pixelwiseregression_tpu_torch.serve import Predictor
    from pixelwiseregression_tpu_torch.serve_artifact import ServingArtifact, export_artifact
    from pixelwiseregression_tpu_torch.serve_http import Client, make_server

    spec = SPECS["NYU"]
    requests = _requests(spec)
    torch.manual_seed(SEED + 5)
    state = PixelwiseRegression(spec.joint_number, stage=STAGES, features=128, level=4,
                                kernel_size=3).state_dict()
    pred = Predictor.from_state_dict(state, "NYU", device, batch_size=SERVE_CHAIN_BATCH,
                                     stages=STAGES)
    assert pred.model.dtype == torch.float32 and pred.model.norm_method == "instance"
    cs.LAUNCHES = cuda_conv.LAUNCHES = 0
    graphs = (serve.GRAPH_CAPTURES, serve.GRAPH_REPLAYS)
    live = [pred.predict(r["frame"], r["com"]) for r in requests]
    torch.cuda.synchronize()
    captured, replayed = serve.GRAPH_CAPTURES - graphs[0], serve.GRAPH_REPLAYS - graphs[1]
    print(f"serving chain: f32 Predictor, {len(requests)} requests: K1 launches {cs.LAUNCHES}, "
          f"conv3x3_f32 {cuda_conv.LAUNCHES}; CUDA graphs captured {captured}, replays "
          f"{replayed}", flush=True)
    assert cs.LAUNCHES == STAGES * len(requests), cs.LAUNCHES
    assert (captured, replayed) == (1, len(requests) - 1), (captured, replayed)
    _count_convs("serve_f32", cuda_conv.LAUNCHES, CONVS * len(requests))
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "nyu.pwrsrv")
        t = time.perf_counter()
        header = export_artifact(pred, path)
        export_s = time.perf_counter() - t
        np.savez(os.path.join(tmp, "req.npz"),
                 **{f"{k}{i}": r[k] for i, r in enumerate(requests) for k in ("frame", "com")})
        t = time.perf_counter()
        child = subprocess.run(
            [sys.executable, "-c", _ARTIFACT_CHILD, path, os.path.join(tmp, "req.npz"),
             os.path.join(tmp, "uvd.npz")], capture_output=True, text=True, timeout=300,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        assert child.returncode == 0, child.stderr[-3000:]
        report = json.loads(child.stdout.strip().splitlines()[-1])
        got = np.load(os.path.join(tmp, "uvd.npz"))
        gap = max(float(np.abs(got[str(i)] - live[i]["uvd"]).max()) for i in range(len(live)))
        print(f"serving chain: artifact {os.path.getsize(path) / 1e6:.1f} MB exported in "
              f"{export_s:.1f} s ({header['format']}, batch {header['batch_size']}); a fresh "
              f"process without the model code loaded it in {report['load_s']:.1f} s "
              f"({time.perf_counter() - t:.1f} s with its start); K1 launches a request "
              f"{report['launches']}, conv3x3_f32 {report['conv_launches']}; uvd vs the live "
              f"Predictor {gap:.3e} px/mm", flush=True)
        assert report["launches"] == [STAGES] * len(requests), report
        assert report["conv_launches"] == [CONVS] * len(requests), report
        _count_convs("artifact", sum(report["conv_launches"]), CONVS * len(requests))
        assert not report["imported_blocked"], report
        assert gap <= ARTIFACT_GAP_BOUND, gap
        out["artifact"] = sum(report["launches"])

        poly = os.path.join(tmp, "poly.pwrsrv")
        export_artifact(pred, poly, poly_batch=True)
        art = ServingArtifact.load(poly, device)
        cs.LAUNCHES = 0
        poly_convs = 0
        for n in (1, 5):
            want = Predictor(pred.model, spec, pred.cfg, n, device).predict(
                requests[0]["frame"][:n], requests[0]["com"][:n])["uvd"]
            before = (cs.LAUNCHES, cuda_conv.LAUNCHES)
            uvd = art.predict(requests[0]["frame"][:n], requests[0]["com"][:n])["uvd"]
            poly_convs += cuda_conv.LAUNCHES - before[1]
            pgap = float(np.abs(uvd - want).max())
            print(f"serving chain: poly-batch artifact at request size {n}: K1 launches "
                  f"{cs.LAUNCHES - before[0]}, conv3x3_f32 {cuda_conv.LAUNCHES - before[1]}, uvd "
                  f"vs a live Predictor of batch {n} {pgap:.3e}")
            assert uvd.shape == (n, J, 3) and pgap <= ARTIFACT_GAP_BOUND, (n, pgap)
        _count_convs("artifact_poly", poly_convs, 2 * CONVS)
        del art

        art = ServingArtifact.load(path, device)
        fps = {"live": [], "artifact": []}
        for rep in range(4):
            for name in (("live", "artifact") if rep % 2 == 0 else ("artifact", "live")):
                fps[name].append(_fps(pred if name == "live" else art, requests[0]))
        for name, vals in fps.items():
            print(f"serving chain: f32 {name} predict frames/s batch 32: median "
                  f"{statistics.median(vals):.1f} of {[round(v, 1) for v in vals]}")
        out["predict_fps"] = {k: statistics.median(v) for k, v in fps.items()}
        meta = {"dataset": "NYU", "batch_size": header["batch_size"], "frame_h": spec.frame_h,
                "frame_w": spec.frame_w, "cube_default": spec.cube_size,
                "backend": f"artifact[{device}]"}
        srv = make_server(art, meta, "127.0.0.1", 0, access_log=False, linger_s=0.005)
        server = threading.Thread(target=srv.serve_forever, daemon=True)
        server.start()
        try:
            client = Client(f"http://127.0.0.1:{srv.server_address[1]}")
            frames = np.concatenate([r["frame"] for r in requests])
            coms = np.concatenate([r["com"] for r in requests])
            chunks = [(frames[i * HTTP_FRAMES:(i + 1) * HTTP_FRAMES],
                       coms[i * HTTP_FRAMES:(i + 1) * HTTP_FRAMES]) for i in range(HTTP_CLIENTS)]
            direct = [art.predict(f, c)["uvd"] for f, c in chunks]
            cs.LAUNCHES = cuda_conv.LAUNCHES = 0
            walls, replies = [], []
            for _ in range(HTTP_BURSTS):
                got_burst = [None] * HTTP_CLIENTS

                def post(i, got_burst=got_burst):
                    got_burst[i] = client.predict(*chunks[i])["uvd"]

                threads = [threading.Thread(target=post, args=(i,)) for i in range(HTTP_CLIENTS)]
                t = time.perf_counter()
                for th in threads:
                    th.start()
                for th in threads:
                    th.join(timeout=300)
                walls.append(time.perf_counter() - t)
                replies.append(got_burst)
            metrics = client.metrics()
            http_launches, http_convs = cs.LAUNCHES, cuda_conv.LAUNCHES
        finally:
            srv.shutdown()
            srv.server_close()
            srv.batcher.stop()
        equal = all(np.array_equal(g, d) for burst in replies for g, d in zip(burst, direct))
        n_req = HTTP_CLIENTS * HTTP_BURSTS
        fps = n_req * HTTP_FRAMES / sum(walls)
        print(f"serving chain: HTTP over the artifact, {HTTP_BURSTS} bursts of {HTTP_CLIENTS} "
              f"clients x {HTTP_FRAMES} frames: requests {metrics['requests']}, device_calls "
              f"{metrics['device_calls']}, batch_fill {metrics['batch_fill']:.1f}, latency p50 "
              f"{metrics['latency_ms']['p50']} ms p99 {metrics['latency_ms']['p99']} ms, "
              f"{fps:.1f} frames/s (bursts {[round(w, 3) for w in walls]} s); K1 launches "
              f"{http_launches}, conv3x3_f32 {http_convs}; replies equal to the direct "
              f"predict: {equal}; {smi_line}", flush=True)
        assert metrics["requests"] == n_req and metrics["errors"] == 0, metrics
        assert metrics["device_calls"] < n_req, metrics
        assert http_launches == STAGES * metrics["device_calls"], http_launches
        _count_convs("http", http_convs, CONVS * metrics["device_calls"])
        assert equal
        out["http"] = http_launches
        del art
    del pred
    _free()

    # int8: the bf16 batch-norm int8_static_all Predictor at full width
    torch.manual_seed(SEED + 6)
    state_b = PixelwiseRegression(spec.joint_number, stage=STAGES, features=128, level=4,
                                  norm_method="batch").state_dict()
    kw = dict(batch_size=SERVE_CHAIN_BATCH, stages=STAGES, norm_method="batch",
              dtype=torch.bfloat16)
    pq = Predictor.from_state_dict(state_b, "NYU", device, quant="int8_static_all", **kw)
    pb = Predictor.from_state_dict(state_b, "NYU", device, **kw)
    convs = sum(1 for m in pq.model.modules() if isinstance(m, layers.Conv) and m.quant)
    calib = pq.calib_left
    cs.LAUNCHES, layers.INT_MM_CALLS, cuda_conv.LAUNCHES = 0, 0, 0
    outs = [pq.predict(r["frame"], r["com"]) for r in requests + requests[:1]]
    torch.cuda.synchronize()
    forwards = 2 * calib + len(requests) + 1 - calib
    scales = layers.quant_scales(pq.model)
    print(f"serving chain: int8_static_all bf16 batch norm, {convs} int8 convs: {calib} "
          f"calibration requests then {len(outs) - calib}; K1 launches {cs.LAUNCHES}, "
          f"torch._int_mm calls {layers.INT_MM_CALLS} ({forwards} forwards); every scale "
          f"positive: {all(float(v.max()) > 0 for v in scales.values())}", flush=True)
    assert pq.calib_left == 0 and all(np.isfinite(o["uvd"]).all() for o in outs)
    assert all(float(v.max()) > 0 for v in scales.values())
    assert cs.LAUNCHES == STAGES * forwards and layers.INT_MM_CALLS == convs * forwards
    _count_convs("int8_serve", cuda_conv.LAUNCHES, 0)
    out["int8_serve"], out["int_mm"] = cs.LAUNCHES, layers.INT_MM_CALLS
    fps = {"int8": [], "bf16": []}
    for rep in range(4):
        for name in (("int8", "bf16") if rep % 2 == 0 else ("bf16", "int8")):
            fps[name].append(_fps(pq if name == "int8" else pb, requests[0]))
    for name, vals in fps.items():
        print(f"serving chain: Predictor frames/s {name} batch norm batch 32: median "
              f"{statistics.median(vals):.1f} of {[round(v, 1) for v in vals]}")
    out["fps"] = {k: statistics.median(v) for k, v in fps.items()}
    del pq, pb
    _free()

    # the int8 conv alone at the head shape: card vs CPU, and timed
    gen = torch.Generator(device="cpu").manual_seed(SEED + 7)
    x = torch.randn(INT8_HEAD_BATCH, FEATURES, H, W, generator=gen)
    w = torch.randn(FEATURES, FEATURES, 3, 3, generator=gen) * 0.05
    b = torch.randn(FEATURES, generator=gen)
    for scales in (None, x.abs().amax(dim=(0, 2, 3))):
        x_q, w_q, _ = layers.int8_codes(x, w, scales)
        cpu_acc = layers.int8_gemm(x_q, w_q)
        card_acc = layers.int8_gemm(x_q.to(device), w_q.to(device)).cpu()
        cpu_y = layers.int8_conv2d(x, w, b, 1, scales)
        card_y = layers.int8_conv2d(*(t.to(device) for t in (x, w, b)), 1,
                                    None if scales is None else scales.to(device)).cpu()
        ulps = float(((card_y - cpu_y).abs() / torch.from_numpy(
            np.spacing(cpu_y.abs().numpy()))).max())
        print(f"serving chain: int8 conv [{INT8_HEAD_BATCH},{FEATURES},{H},{W}] 3x3 "
              f"{'static' if scales is not None else 'dynamic'}, card vs CPU: int32 accumulators "
              f"equal {torch.equal(card_acc, cpu_acc)}, output within {ulps:.1f} ulp")
        assert torch.equal(card_acc, cpu_acc) and ulps <= 1.0
    xb = torch.randn(SERVE_CHAIN_BATCH, FEATURES, H, W, device=device).to(torch.bfloat16)
    wd, bd = w.to(device), b.to(device)
    scale = xb.float().abs().amax(dim=(0, 2, 3))
    times = _turns([lambda: layers.int8_conv2d(xb, wd, bd, 1, scale),
                    lambda: torch.nn.functional.conv2d(xb, wd.to(xb.dtype), bd.to(xb.dtype),
                                                       padding=1)])
    print(f"serving chain: head conv [{SERVE_CHAIN_BATCH},{FEATURES},{H},{W}] 3x3 bf16 in: "
          f"int8 (im2col + torch._int_mm) {times[0][0]:.4f} ms, cuDNN bf16 "
          f"{times[1][0]:.4f} ms (medians, in turns); {smi_line}")
    out["head_conv_ms"] = {"int8": times[0][0], "bf16": times[1][0]}
    del xb
    _free()

    # a small f32 int8 model, card vs CPU, on the CPU's calibrated scales. The
    # serving configuration's batch norm: with instance norms a random-weight
    # model moves its uvd by ~1e-3 of the scale in f32, and by ~0.1-0.2 in
    # int8, for inputs 1e-6 apart (tests/torch_port_int8_sensitivity.py)
    from pixelwiseregression_tpu_torch.utils.synth import make_synthetic_raw_batch

    torch.manual_seed(SEED + 8)
    small = PixelwiseRegression(spec.joint_number, stage=STAGES, features=16, level=2,
                                norm_method="batch").state_dict()
    kw = dict(batch_size=4, stages=STAGES, features=16, level=2, norm_method="batch")
    raw = make_synthetic_raw_batch(3, spec.frame_h, spec.frame_w, spec.joint_number,
                                   fx=spec.camera.fx, fy=spec.camera.fy, cube=spec.cube_size,
                                   com_z=470.0, seed=SEED + 9)
    host = Predictor.from_state_dict(small, "NYU", "cpu", quant="int8_static_all",
                                     quant_calib_batches=1, **kw)
    want = host.predict(raw["frame"], raw["com"])["uvd"]
    card = Predictor.from_state_dict(small, "NYU", device, quant="int8_static_all",
                                     quant_calib_batches=0, **kw)
    layers.load_quant_scales(card.model, layers.quant_scales(host.model))
    got = card.predict(raw["frame"], raw["com"])["uvd"]
    f32 = Predictor.from_state_dict(small, "NYU", "cpu", **kw).predict(raw["frame"], raw["com"])
    box = raw["box_size"][:, None].astype(np.float64) - 1.0
    cube = raw["cube"][:, None].astype(np.float64)

    def norm_gap(a, c):
        d = np.abs(a - c)
        return float(max((d[..., 0] / box).max(), (d[..., 1] / box).max(),
                         (d[..., 2] / cube).max()))

    gap, own = norm_gap(got, want), norm_gap(want, f32["uvd"])
    print(f"serving chain: small f32 batch-norm int8_static_all model, card vs CPU: {gap:.3e} of the uvd "
          f"scale (bound twice the CPU's own int8-vs-f32 gap, {own:.3e})")
    assert np.isfinite(got).all() and gap <= 2 * own, (gap, own)
    return out


FULLREG_EPOCHS = 2
FULLREG_BATCH = 32
PAIRED_HEAD_BOUND = 1e-4   # the paired heads' logits and depth maps vs the plain heads' on
                           # the same hourglass output, f32, relative to their largest value
DDP_BATCH = 128            # the global batch of the two-rank step
DDP_TIMED_STEPS = 3
DDP_CASES = ("instance_anchored", "batch")


def _msra_fixture(work):
    """The MSRA fixture (9 subjects x CLI_FRAMES frames) under ``work``,
    indexed with check_dataset's device check on the card; returns its path."""
    from pixelwiseregression_tpu_torch.cli.check_dataset import build_dataset

    fixture = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures",
                           "make_msra_fixture.py")
    data = os.path.join(work, "msra")
    subprocess.run([sys.executable, fixture, data, str(CLI_FRAMES)], check=True,
                   capture_output=True, timeout=300)
    build_dataset("MSRA", data, torch.device("cuda:0"))
    return data


def phase_fullreg(cs, device, smi_line, data, work):
    """The FullRegression family through its own entry points at full width
    (stages 2, features 128, level 4, label_size 64): train_fullregression's
    run_training on the MSRA fixture (bf16, batch 32, 2 epochs), then
    test_fullregression's run_inference in f32, Predictor.from_checkpoint
    (fullregression=True) against the Result file, and the artifact exported
    and loaded in a fresh process that cannot import the models. The family
    has no decoder: K1 and K2 are asserted 0 on every part. Returns the
    launches by path and the rates."""
    from pixelwiseregression_tpu_torch.cli.common import make_test_parser, make_train_parser
    from pixelwiseregression_tpu_torch.cli.test_main import run_inference
    from pixelwiseregression_tpu_torch.cli.train_main import run_training
    from pixelwiseregression_tpu_torch.data.sources import get_source
    from pixelwiseregression_tpu_torch.ops import cuda_conv
    from pixelwiseregression_tpu_torch.serve import Predictor
    from pixelwiseregression_tpu_torch.serve_artifact import export_artifact

    cwd = os.getcwd()
    os.chdir(work)
    try:
        args = make_train_parser(suffix_default="full_regression", msra=True,
                                 fullregression=True).parse_args(
            ["--subject", "0", "--epoch", str(FULLREG_EPOCHS), "--batch_size",
             str(FULLREG_BATCH), "--mixed_precision", "--seed", "1", "--data_path", data])
        assert (args.stages, args.features, args.level, args.label_size) == (STAGES, FEATURES,
                                                                             LEVEL, H)
        out = io.StringIO()
        torch.cuda.synchronize()
        cs.LAUNCHES = cs.BWD_LAUNCHES = cs.BWD_KERNEL_LAUNCHES = cuda_conv.LAUNCHES = 0
        t = time.perf_counter()
        with contextlib.redirect_stdout(out):
            best_epoch, best_err = run_training(args, "MSRA", family="fullregression", subject=0)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        train = {"K1": cs.LAUNCHES, "K2": cs.BWD_LAUNCHES}
        epochs = _epoch_lines(out.getvalue())
        for i, (loss, mm, sps) in enumerate(epochs):
            print(f"fullreg train epoch {i}: train_loss {loss:.5f}, val mean-mm {mm}, "
                  f"{sps:.1f} samples/s ({smi_line}; epoch 0 includes the first step's set-up)")
        print(f"fullreg train: {FULLREG_EPOCHS} epochs in {seconds:.1f} s, launches {train}, "
              f"best epoch {best_epoch} at {best_err:.3f} mm", flush=True)
        assert len(epochs) == FULLREG_EPOCHS and all(np.isfinite(e[0]) for e in epochs), epochs
        assert train == {"K1": 0, "K2": 0}, train
        _count_convs("fullreg_train", cuda_conv.LAUNCHES, 0)
        final = os.path.join(work, "Model", "MSRA_full_regression_subject0_final.pt")
        ckpt = torch.load(final, map_location="cpu", weights_only=True)
        assert "stages.1.regression.4.weight" in ckpt["state_dict"]
        assert all(torch.isfinite(v).all() for v in ckpt["state_dict"].values())

        targs = make_test_parser(msra=True, fullregression=True).parse_args(
            ["--subject", "0", "--batch_size", str(FULLREG_BATCH), "--data_path", data])
        cs.LAUNCHES = cuda_conv.LAUNCHES = 0
        with contextlib.redirect_stdout(io.StringIO()) as text:
            name, test_fps = run_inference(targs, "MSRA", fullregression=True, subject=0)
        torch.cuda.synchronize()
        test_launches = cs.LAUNCHES
        _count_convs("fullreg_test", cuda_conv.LAUNCHES, 0)
        result = np.loadtxt(os.path.join(work, name))
        print(f"fullreg test f32: {test_fps:.1f} frames/s, K1 launches {test_launches}; "
              f"{text.getvalue().strip().splitlines()[-1]}")
        assert test_launches == 0 and np.isfinite(result).all()
        assert result.shape == (CLI_FRAMES, 63), result.shape

        src = get_source("MSRA", path=data, dataset="test", subject=0, test_only=True)
        raw = [src.load_raw(line) for line in src.lines]
        frames, coms = np.stack([r[0] for r in raw]), np.stack([r[2] for r in raw])
        pred = Predictor.from_checkpoint(final, "MSRA", device, batch_size=FULLREG_BATCH,
                                         fullregression=True)
        live = pred.predict(frames, coms)["uvd"]
        gap = float(np.abs(live.reshape(len(raw), -1) - result).max())
        fps = statistics.median(_fps(pred, {"frame": frames, "com": coms}) for _ in range(3))
        print(f"fullreg Predictor.from_checkpoint vs the test CLI's Result: largest gap "
              f"{gap:.4f}; predict f32 batch {FULLREG_BATCH}: {fps:.1f} frames/s ({smi_line})")
        assert gap <= CLI_RESULT_BOUND, gap

        path = os.path.join(work, "fullreg.pwrsrv")
        header = export_artifact(pred, path)
        np.savez(os.path.join(work, "fr_req.npz"), frame0=frames, com0=coms)
        child = subprocess.run(
            [sys.executable, "-c", _ARTIFACT_CHILD, path, os.path.join(work, "fr_req.npz"),
             os.path.join(work, "fr_uvd.npz")], capture_output=True, text=True, timeout=300,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        assert child.returncode == 0, child.stderr[-3000:]
        report = json.loads(child.stdout.strip().splitlines()[-1])
        agap = float(np.abs(np.load(os.path.join(work, "fr_uvd.npz"))["0"] - live).max())
        print(f"fullreg artifact ({header['format']}): a fresh process without the model code "
              f"loaded it in {report['load_s']:.1f} s; K1 launches {report['launches']}; uvd vs "
              f"the live Predictor {agap:.3e}", flush=True)
        assert report["launches"] == [0] and not report["imported_blocked"], report
        assert agap <= ARTIFACT_GAP_BOUND, agap
        return {"fullreg_train": train, "fullreg_test": {"K1": test_launches},
                "artifact": report["launches"][0],
                "samples_per_s": [e[2] for e in epochs], "predict_fps": fps}
    finally:
        os.chdir(cwd)


def _calibrated_full_width(device, seed, norm="instance_anchored"):
    """A full-width NYU PixelwiseRegression's state from a seed after one
    train-mode forward on the card (anchors calibrated, BatchNorm's
    running statistics moved)."""
    from pixelwiseregression_tpu_torch.models.pixelwise import PixelwiseRegression

    torch.manual_seed(seed)
    model = PixelwiseRegression(J, stage=STAGES, features=FEATURES, level=LEVEL,
                                norm_method=norm, decoder="torch").to(device)
    g = torch.Generator(device="cpu").manual_seed(seed)
    xs = [torch.rand(8, 1, s, s, generator=g).to(device) for s in (2 * H, H, H)]
    with torch.no_grad():
        model.train()(*xs)
    return {k: v.cpu() for k, v in model.state_dict().items()}


def phase_paired(cs, device, smi_line):
    """The paired heads at full width (NYU, 2 stages, 128 features, level 4),
    f32, for the two-pass instance norm (the serving default) and the
    anchored norm with calibrated anchors, on one random-weight state each
    (norm scales and biases drawn too).
    Every mid/final form's heads (``paired_heads_apply``) against the plain
    heads on the same hourglass output of each stage (the plain model's, on
    request 0): logits and depth maps within PAIRED_HEAD_BOUND of their
    largest value. Then each form's paired Predictor on the four requests: K1
    twice a request, finite uvd, and its uvd gap to the plain Predictor
    printed (not a gate: the gap after two stages of random weights carries
    the heads' rounding difference amplified). Then the port's
    tools/bench_paired_model at batch 256, bf16, stages 1 and 2 (every
    variant in turns, frames/s and spread). Returns the launches, the gaps
    and the tool's frames/s."""
    from pixelwiseregression_tpu_torch.data.sources import SPECS
    from pixelwiseregression_tpu_torch.models.paired_heads import paired_heads_apply
    from pixelwiseregression_tpu_torch.models.pixelwise import PixelwiseRegression
    from pixelwiseregression_tpu_torch.serve import Predictor
    from pixelwiseregression_tpu_torch.tools import bench_paired_model

    spec = SPECS["NYU"]
    requests = _requests(spec)
    forms = (("separate", "separate"), ("separate", "blockdiag"), ("grouped", "blockdiag"),
             ("grouped", "separate"))
    launches, head_gaps, uvd_gaps = 0, {}, {}
    for i, norm in enumerate(("instance", "instance_anchored")):
        state = _calibrated_full_width(device, SEED + 30 + i, norm)
        # the norms' scales and biases drawn away from their init (ones and
        # zeros), so that each head's own reaches the paired path's output
        g = torch.Generator().manual_seed(SEED + 35 + i)
        for name, t in state.items():
            if t.dim() == 1 and name.endswith((".weight", ".bias")):
                noise = 0.1 * torch.randn(t.shape, generator=g)
                state[name] = t * (1 + noise) if name.endswith(".weight") else t + noise
        kw = dict(batch_size=SERVE_CHAIN_BATCH, stages=STAGES, features=FEATURES, level=LEVEL,
                  norm_method=norm)
        plain = Predictor.from_state_dict(state, "NYU", device, **kw)
        feats = {}

        def keep(k):
            def hook(module, args, out):  # returns None: the output is left as it is
                if k not in feats:
                    feats[k] = out.detach().clone()
            return hook

        hooks = [b.hourglass.register_forward_hook(keep(k))
                 for k, b in enumerate(plain.model.stages)]
        want = [plain.predict(r["frame"], r["com"])["uvd"] for r in requests]
        for h in hooks:
            h.remove()
        with torch.inference_mode():
            for k, block in enumerate(plain.model.stages):
                f = feats[k]
                ref = (block.plane_regression(f), block.depth_regression(f))
                for mid, final in forms:
                    got = paired_heads_apply(f, block.plane_regression, block.depth_regression,
                                             mid, final)
                    for name, g, r in zip(("logits", "depthmaps"), got, ref):
                        rel = float((g - r).abs().max() / r.abs().max())
                        head_gaps[f"{norm} stage {k} {mid}/{final} {name}"] = rel
                        assert torch.isfinite(g).all() and rel <= PAIRED_HEAD_BOUND, (
                            norm, k, mid, final, name, rel)
        worst = max(v for key, v in head_gaps.items() if key.startswith(norm + " "))
        print(f"paired heads {norm}: every form's logits and depth maps vs the plain heads on "
              f"the same hourglass output, each stage: largest gap {worst:.3e} of the "
              f"output's scale (bound {PAIRED_HEAD_BOUND})", flush=True)
        for mid, final in forms:
            model = PixelwiseRegression(J, stage=STAGES, features=FEATURES, level=LEVEL,
                                        norm_method=norm, decoder="cuda", paired_heads=True,
                                        paired_mid=mid, paired_final=final)
            model.load_state_dict(state)
            pred = Predictor(model.to(device).eval(), plain.spec, plain.cfg, SERVE_CHAIN_BATCH,
                             device)
            assert all(b.use_paired() for b in pred.model.stages)
            torch.cuda.synchronize()
            before = cs.LAUNCHES
            got = [pred.predict(r["frame"], r["com"])["uvd"] for r in requests]
            torch.cuda.synchronize()
            n = cs.LAUNCHES - before
            key = f"{norm} {mid}/{final}"
            uvd_gaps[key] = max(float(np.abs(g - w).max()) for g, w in zip(got, want))
            print(f"paired heads {key} f32 Predictor vs the plain heads: largest uvd gap "
                  f"{uvd_gaps[key]:.3e} px/mm over {len(requests)} requests (printed, not "
                  f"gated), K1 launches {n}", flush=True)
            assert n == STAGES * len(requests), n
            assert all(np.isfinite(g).all() for g in got)
            launches += n
            del pred, model
        del plain, feats
    _free()
    t = time.perf_counter()
    res = bench_paired_model.main(["--batch", "256", "--iters", "4", "--rounds", "3"])
    for stages, r in res.items():
        # the tool checks each variant's K1 launches against its calls itself
        assert set(r["launches"]) == {"K1"} and r["launches"]["K1"] > 0, r["launches"]
        print(f"paired heads A/B stage {stages} b256 bf16 ({smi_line}): " + ", ".join(
            f"{name} {fps:.1f} frames/s" for name, fps in r["fps"].items()))
    print(f"paired heads A/B in {time.perf_counter() - t:.1f} s", flush=True)
    _free()
    return {"paired_serve": launches, "tool": sum(r["launches"]["K1"] for r in res.values()),
            "head_gaps": head_gaps, "uvd_gaps": uvd_gaps,
            "fps": {s: r["fps"] for s, r in res.items()}}


def phase_ddp(cs, device, smi_line, data, work):
    """Multi-process training on the card. Two ranks (spawned processes, gloo
    with CUDA tensors: NCCL refuses two ranks on one GPU) take one stage-2
    bf16 train step of the full-width PixelwiseRegression at a global batch
    of 128 (64 a rank), instance_anchored and batch norm, through K1 and K2
    in each rank (counted there), held against the one-process step on the
    same global batch and draws (the train parity bounds), then
    DDP_TIMED_STEPS more steps timed beside the one-process step's; then
    train.py's run_training under torchrun --nproc_per_node 1 (NCCL) for one
    epoch on the MSRA fixture. Returns the launches and the times."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    import torch_port_ddp_worker as worker

    from pixelwiseregression_tpu_torch.data.sources import SPECS

    cam = SPECS["NYU"].camera
    raw = _raw_batch("cpu", DDP_BATCH, SEED + 40)
    cases = []
    for norm in DDP_CASES:
        cases.append({
            "kind": "pixelwise",
            "model": dict(joints=J, stage=STAGES, features=FEATURES, level=LEVEL,
                          norm_method=norm, decoder="cuda", dtype=torch.bfloat16),
            "state": _calibrated_full_width(device, SEED + 41, norm), "batch": raw,
            "cfg": dict(fx=cam.fx, fy=cam.fy, halfu=cam.halfu, halfv=cam.halfv,
                        image_size=2 * H, label_size=H, using_rotation=True, using_scale=True,
                        using_shift=True),
            "eval_cfg": dict(fx=cam.fx, fy=cam.fy, halfu=cam.halfu, halfv=cam.halfv,
                             image_size=2 * H, label_size=H),
            "camera": dict(fx=cam.fx, fy=cam.fy, halfu=cam.halfu, halfv=cam.halfv),
            "loss": dict(lambda_h=1.0, lambda_d=0.01, alpha=1.0),
            "timed_steps": DDP_TIMED_STEPS})
    cases_path = os.path.join(work, "ddp_cases.pt")
    torch.save({"cases": cases, "seed": SEED + 42}, cases_path)
    _free()
    t = time.perf_counter()
    ranks = worker.spawn(cases_path, work, device="cuda", backend="gloo", timeout=600)
    spawn_s = time.perf_counter() - t
    out = {"launches": [], "ms": {}}
    for i, norm in enumerate(DDP_CASES):
        single = worker.run_case(cases[i], device, SEED + 42, local=False)
        _free()
        for r, rank in enumerate(ranks):
            got = rank["results"][i]
            loss_gap = abs(float(got["train"]["loss"]) - float(single["train"]["loss"])) / abs(
                float(single["train"]["loss"]))
            grad_gap = _whole_gap({n: g.double() for n, g in got["grads"].items()},
                                  {n: g.double() for n, g in single["grads"].items()})
            print(f"ddp {norm}: rank {r} of 2 (gloo, CUDA tensors) vs one process on the global "
                  f"batch {DDP_BATCH}: loss {float(got['train']['loss']):.6f} vs "
                  f"{float(single['train']['loss']):.6f} (relative gap {loss_gap:.3e}), "
                  f"whole-gradient relative gap {grad_gap:.3e}, launches {got['launches']}",
                  flush=True)
            assert got["launches"] == {"K1": STAGES, "K2": STAGES}, got["launches"]
            assert loss_gap <= LOSS_GAP_BOUND and grad_gap <= GRAD_GAP_BOUND, (loss_gap, grad_gap)
            out["launches"].append(got["launches"])
        for name, t_ in ranks[0]["results"][i]["state"].items():
            assert torch.equal(t_, ranks[1]["results"][i]["state"][name]), name
        two = [statistics.median(rk["results"][i]["step_s"]) * 1e3 for rk in ranks]
        one = statistics.median(single["step_s"]) * 1e3
        out["ms"][norm] = {"two_ranks": two, "one_process": one}
        print(f"ddp {norm} bf16 step time ({smi_line}): two ranks on one card {two[0]:.1f} / "
              f"{two[1]:.1f} ms (median of {DDP_TIMED_STEPS}, each rank 64 frames), one "
              f"process {one:.1f} ms at {DDP_BATCH} frames", flush=True)
        del single
    print(f"ddp: both ranks' processes in {spawn_s:.1f} s (start, build, steps)")
    assert ranks[0]["backend"] == "gloo"

    env = dict(os.environ, PWR_TB_IMAGES="0",
               PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    t = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "1",
         "--master_addr", "127.0.0.1", "--master_port", str(worker.free_port()), "-m",
         "pixelwiseregression_tpu_torch.cli.train_msra", "--subject", "0", "--epoch", "1",
         "--batch_size", str(CLI_BATCH), "--mixed_precision", "--seed", "2", "--data_path", data],
        capture_output=True, text=True, timeout=600, cwd=work, env=env)
    print(f"ddp: torchrun --nproc_per_node 1 train_msra (NCCL) in {time.perf_counter() - t:.1f} "
          f"s, exit {r.returncode}: " + " | ".join(
              line for line in r.stdout.splitlines() if line.startswith(("device", "epoch"))))
    assert r.returncode == 0, r.stderr[-3000:]
    assert "1 processes of batch 32 (nccl)" in r.stdout and "epoch 0: train_loss" in r.stdout
    return out


# the last scripts of the JAX package (phase_scripts): the tools' reduced
# arguments (the profile of the train step at full width, the head unit at
# its default shape)
SCRIPT_STEPS = 3              # profile_train_components: traced steps, after 2 warm-up steps
SCRIPT_AMP_STEPS = 20         # stage2_amplification: training steps of its one seed
SCRIPT_SAMPLES = 3            # test_samples: samples
SCRIPT_TABLE_BOUND = 1e-2     # the component table's sum vs the trace's device time (1%)
SCRIPT_TIMED = ["--rounds", "3"]
SCRIPT_TOOLS = (
    ("profile_components", ["--batch_size", "64", "--iters", "2"]),
    ("profile_train", ["--batch_size", "32", "--iters", "2", "--warmup", "2",
                       "--wall_steps", "3", "--norm_method", "instance_anchored"]),
    ("profile_infer", ["--batch_size", "64", "--iters", "2", "--warmup", "2",
                       "--wall_steps", "3"]),
    ("headconv_bwd_split", ["--iters", "3", *SCRIPT_TIMED]),
    ("train_ab", ["--batch", "32", "--iters", "2", *SCRIPT_TIMED]),
    ("train_remat_ab", ["--batch", "32", "--iters", "2", *SCRIPT_TIMED]),
    ("bench_norm_variants", ["--batch", "64", "--iters", "4", *SCRIPT_TIMED]),
    ("bench_upsample_add", ["--batch", "64", "--iters", "8", *SCRIPT_TIMED]),
)
# the K1 and K2 launches each tool's run must make (a profile tool's every
# call: warm-up, timed and traced; a timed tool's are checked by ab_common.run);
# a train step's K2 is one kernel a call (no dlabel)
SCRIPT_LAUNCHES = {
    "profile_train_components": dict.fromkeys(("K1", "K2", "K2_kernels"),
                                              STAGES * (2 + SCRIPT_STEPS)),
    "profile_components": {"K1": STAGES * 3},
    "profile_train": dict.fromkeys(("K1", "K2", "K2_kernels"), STAGES * 7),
    "profile_infer": {"K1": STAGES * 7},
}


def phase_scripts(cs, device, smi_line, data, work):
    """The last scripts of the JAX package, each through its port's function
    with every kernel counter set to 0 just before it and read just after:
    profile_train_components at full width (the train step, NYU-shaped raw
    frames, stages 2, bf16, batch 128, instance_anchored, 3 traced steps:
    the component table must sum to the trace's device time within 1%, leave
    no kernel unattributed, put K1's kernels in [fwd] and K2's in [bwd] of
    each stage, and show each stage's hourglass and heads both ways), the
    other profile and timing tools at reduced sizes (headconv_bwd_split at
    its default shape), stage2_amplification on the MSRA fixture (one seed),
    check_data_layout on it, bench_http against serve_http over a live
    Predictor in this process, and test_samples and get_sfr's compute
    functions on a small random-weight checkpoint (nothing is drawn).
    Returns the K1 and K2 launches by tool."""
    import importlib
    import threading

    from pixelwiseregression_tpu_torch.cli import get_sfr, test_samples
    from pixelwiseregression_tpu_torch.models.pixelwise import PixelwiseRegression
    from pixelwiseregression_tpu_torch.data.sources import SPECS
    from pixelwiseregression_tpu_torch.serve import Predictor
    from pixelwiseregression_tpu_torch.serve_http import make_server
    from pixelwiseregression_tpu_torch.tools import (ab_common, bench_http, check_data_layout,
                                                     profile_train_components,
                                                     stage2_amplification)
    from pixelwiseregression_tpu_torch.train.checkpoint import save_checkpoint

    launches = {}

    def counted(name, want, fn):
        """Run fn with every counter at 0; its launches must be ``want``
        (a dict, or a function of fn's result giving one)."""
        ab_common.reset_counts()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        got = {k: n for k, n in ab_common.read_counts().items() if n}
        print(f"scripts {name}: launches {got} in {time.perf_counter() - t:.1f} s", flush=True)
        want = want(out) if callable(want) else want
        assert got == {k: n for k, n in want.items() if n}, (name, got, want)
        launches[name] = {k: got.get(k, 0) for k in ("K1", "K2")}
        _free()
        return out

    def reported(res):
        """The launches a timed tool's runs report (train_ab: a run a batch size)."""
        runs = list(res.values()) if "ms" not in res else [res]
        return {k: sum(r["launches"].get(k, 0) for r in runs)
                for k in set().union(*(r["launches"] for r in runs))}

    # the train step by component, full width
    out = counted("profile_train_components", SCRIPT_LAUNCHES["profile_train_components"],
                  lambda: profile_train_components.main(
                      ["--iters", str(SCRIPT_STEPS), "--warmup", "2", "--top", "60"]))
    prof, comps = out["profile"], out["components"]
    table = sum(us for us, _ in comps.values())
    print(f"scripts component table: {prof.total_us / 1e3 / SCRIPT_STEPS:.3f} ms/step of device "
          f"time, components sum {table / 1e3 / SCRIPT_STEPS:.3f}, unattributed "
          f"{len(prof.unattributed)} kernels ({prof.by_span} tied to their op by the span of "
          f"their runtime call, {prof.stale} records of an earlier session left out); "
          f"{smi_line}", flush=True)
    assert abs(table - prof.total_us) <= SCRIPT_TABLE_BOUND * prof.total_us, (table, prof.total_us)
    assert not prof.unattributed, [(leaf.name, leaf.start) for leaf in prof.unattributed[:5]]
    decoder = {}
    for leaf in prof.leaves:
        if "softargmax" in leaf.name:
            kernel = "K2" if "bwd" in leaf.name else "K1"
            decoder.setdefault(kernel, set()).add(f"[{leaf.kind}] {leaf.where}")
    stages = [f"stages.{s}" for s in range(STAGES)]
    assert decoder == {"K1": {f"[fwd] {s}" for s in stages},
                       "K2": {f"[bwd] {s}" for s in stages}}, decoder
    for s in stages:
        for part in ("hourglass", "plane_regression", "depth_regression"):
            for kind in ("fwd", "bwd"):
                assert f"[{kind}] {s}.{part}" in comps, (kind, s, part)

    # the other profile and timing tools, reduced
    for name, argv in SCRIPT_TOOLS:
        tool = importlib.import_module(f"pixelwiseregression_tpu_torch.tools.{name}")
        print(f"scripts {name} {' '.join(argv)}:", flush=True)
        res = counted(name, SCRIPT_LAUNCHES.get(name, reported), lambda: tool.main(argv))
        if name.startswith("profile_"):
            p = res["profile"]
            print(f"scripts {name}: {p.by_span} kernels tied by span, {p.stale} stale records "
                  f"left out", flush=True)
            assert not p.unattributed, (name, [(leaf.name, leaf.start)
                                               for leaf in p.unattributed[:5]])
        if name == "headconv_bwd_split":
            for line in res["summary"]:
                print(f"scripts head unit split:{line}; {smi_line}", flush=True)
    assert launches["train_ab"]["K2"] > 0 and launches["train_remat_ab"]["K1"] > 0
    assert launches["bench_norm_variants"]["K1"] > 0
    assert launches["headconv_bwd_split"] == launches["bench_upsample_add"] == {"K1": 0, "K2": 0}

    # stage 2's amplification on trained weights, on the MSRA fixture
    amp = counted("stage2_amplification",
                  {"K1": STAGES * (SCRIPT_AMP_STEPS + 5), "K2": STAGES * SCRIPT_AMP_STEPS,
                   "K2_kernels": STAGES * SCRIPT_AMP_STEPS},
                  lambda: stage2_amplification.main(
                      ["--seeds", "1", "--steps", str(SCRIPT_AMP_STEPS), "--dataset", "MSRA",
                       "--data_path", data]))
    for row in amp["seeds"]:
        assert all(math.isfinite(g) for gains in row["gains"].values() for d in gains.values()
                   for g in d)
        print(f"scripts stage2_amplification: gap card vs cpu (mm) {row['gap_mm']}; gains "
              f"{row['gains']}; {smi_line}", flush=True)

    problems, decoded = check_data_layout.check("MSRA", data)
    assert not problems and len(decoded) == 2, (problems, decoded)
    print(f"scripts check_data_layout: {decoded}", flush=True)

    # bench_http against the HTTP server over a live full-width Predictor
    spec = SPECS["NYU"]
    torch.manual_seed(SEED + 40)
    state = PixelwiseRegression(spec.joint_number, stage=STAGES, features=128, level=4,
                                kernel_size=3).state_dict()
    pred = Predictor.from_state_dict(state, "NYU", device, batch_size=8, stages=STAGES)
    meta = {"dataset": "NYU", "batch_size": 8, "frame_h": spec.frame_h, "frame_w": spec.frame_w,
            "cube_default": spec.cube_size, "backend": f"live[{device}]"}
    srv = make_server(pred, meta, "127.0.0.1", 0, access_log=False, linger_s=0.005)
    server = threading.Thread(target=srv.serve_forever, daemon=True)
    server.start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        ab_common.reset_counts()
        res = bench_http.run(url, threads=4, requests=4, size=2)
        k1 = ab_common.read_counts()["K1"]
    finally:
        srv.shutdown()
        srv.server_close()
        srv.batcher.stop()
        server.join(timeout=60)
    print(f"scripts bench_http: requests {res['requests']} ({res['errors']} errors), "
          f"{res['frames_per_s']:.1f} frames/s, latency {res['latency_ms']}, device_calls "
          f"{res['device_calls']}, batch_fill {res['batch_fill']:.2f}; K1 {k1}; {smi_line}",
          flush=True)
    assert res["requests"] == 16 and res["errors"] == 0, res
    assert k1 == STAGES * (res["device_calls"] + 1), (k1, res["device_calls"])
    launches["bench_http"] = {"K1": k1, "K2": 0}
    del pred
    _free()

    # the viewers' compute functions on a small random-weight checkpoint
    viewer = os.path.join(work, "viewer")
    os.makedirs(os.path.join(viewer, "Model"))
    torch.manual_seed(SEED + 41)
    small = PixelwiseRegression(21, stage=STAGES, features=16, level=2)
    for name in ("MSRA_default_subject0_final.pt", "MSRA_sfr_final.pt"):
        save_checkpoint(os.path.join(viewer, "Model", name), small)
    arch = ["--dataset", "MSRA", "--data_path", data, "--label_size", "32", "--features", "16",
            "--level", "2", "--stages", str(STAGES)]
    prev = os.getcwd()
    os.chdir(viewer)
    try:
        got = counted("test_samples", {"K1": STAGES * SCRIPT_SAMPLES}, lambda: list(
            test_samples.predictions(test_samples.parse_args(
                arch + ["--subject", "0", "--max_samples", str(SCRIPT_SAMPLES)]))))
        assert len(got) == SCRIPT_SAMPLES and all(np.isfinite(u).all() and u.shape == (1, 21, 3)
                                                  for _, _, u in got)
        _, rows = counted("get_sfr", {"K1": STAGES}, lambda: get_sfr.maps(get_sfr.parse_args(
            arch + ["--suffixes", "detection", "sfr"])))
        assert [r[0] for r in rows] == ["sfr"] and all(np.isfinite(m).all() for m in rows[0][1:])
    finally:
        os.chdir(prev)
    print(f"scripts: K1 and K2 launches by tool {launches}", flush=True)
    return launches


def phase_conv3x3(device, smi_line):
    """The heads' f32 3x3 conv (``csrc/conv3x3_f32.cu`` through
    ``torch.ops.pwr.conv3x3_f32``) at [b, 128, 64, 64] 128 -> 128 for b in
    CONV_BATCHES: its kernel's device time a launch (torch.profiler's total
    over its launches, which holds where the profiler drops records of a
    long process) beside the float32 bound; each call's time by CUDA events,
    in turns with cuDNN's f32 conv with TF32 off as its heuristic picks it
    (the port's F.conv2d before the kernel) and in benchmark mode (its
    fastest f32 algorithm after its own search), whose kernels are listed;
    each one's largest error to a float64 conv of the same inputs; the
    host's µs a call of the operator and of cuDNN's heuristic pick, without
    and with autograd (_host_us). Asserted: two kernel calls bit-identical,
    one launch a call, the kernel's error no larger than cuDNN's heuristic
    pick's. TF32 is off (``core.precision.tf32_off``); cuDNN's benchmark
    mode is set here only, around its own calls. Returns rows by batch."""
    import torch.nn.functional as F

    from pixelwiseregression_tpu_torch.core.precision import tf32_off
    from pixelwiseregression_tpu_torch.ops import cuda_conv

    tf32_off()

    rows = {}
    for b in CONV_BATCHES:
        gen = torch.Generator(device=device).manual_seed(SEED + 70 + b)
        x = torch.randn(b, FEATURES, H, W, generator=gen, device=device)
        w = torch.randn(FEATURES, FEATURES, 3, 3, generator=gen, device=device) * (
            2.0 / (9 * FEATURES + 9 * FEATURES)) ** 0.5
        bias = 0.1 * torch.randn(FEATURES, generator=gen, device=device)
        ref = F.conv2d(x.double(), w.double(), bias.double(), 1, 1)

        def kernel():
            return cuda_conv.conv3x3_f32(x, w, bias)

        def cudnn(benchmark=False):
            torch.backends.cudnn.benchmark = benchmark
            try:
                return F.conv2d(x, w, bias, 1, 1)
            finally:
                torch.backends.cudnn.benchmark = False

        before = cuda_conv.LAUNCHES
        y, y2 = kernel(), kernel()
        torch.cuda.synchronize()
        assert cuda_conv.LAUNCHES == before + 2, cuda_conv.LAUNCHES - before
        assert torch.equal(y, y2), "two calls of conv3x3_f32 differ"
        errs = {"kernel": (y.double() - ref).abs().max().item(),
                "cudnn": (cudnn().double() - ref).abs().max().item(),
                "cudnn_benchmark": (cudnn(True).double() - ref).abs().max().item()}
        del y, y2
        scale = ref.abs().max().item()
        fns = {"kernel": kernel, "cudnn": cudnn, "cudnn_benchmark": lambda: cudnn(True)}
        by = {name: _device_time_by_kernel(fn) for name, fn in fns.items()}
        conv_ms = next(us / n for k, n, us in by["kernel"] if "conv3x3_f32" in k) / 1e3
        ms = dict(zip(fns, (m for m, _ in _turns(list(fns.values()), runs=5, iters=10))))
        wg = w.detach().requires_grad_()
        with torch.no_grad():
            host_us = {"kernel": _host_us(kernel), "cudnn": _host_us(cudnn)}
        host_us["kernel_autograd"] = _host_us(lambda: cuda_conv.conv3x3_f32(x, wg, bias))
        host_us["cudnn_autograd"] = _host_us(lambda: F.conv2d(x, wg, bias, 1, 1))
        bound_ms, bound_by = _bound(2 * b * H * W * FEATURES * FEATURES * 9,
                                    4 * (2 * b * H * W * FEATURES + FEATURES * FEATURES * 9),
                                    "f32")
        row = {"shape": [b, FEATURES, H, W], "device_ms": conv_ms, "call_ms": ms["kernel"],
               "bound_ms": bound_ms, "bound_by": bound_by, "bound_share": bound_ms / conv_ms,
               "cudnn_ms": ms["cudnn"], "cudnn_benchmark_ms": ms["cudnn_benchmark"],
               "max_abs_err": errs["kernel"], "cudnn_max_abs_err": errs["cudnn"],
               "cudnn_benchmark_max_abs_err": errs["cudnn_benchmark"], "ref_scale": scale,
               "host_us": host_us,
               "cudnn_kernels": [k[:90] for k, _, _ in by["cudnn"]],
               "cudnn_benchmark_kernels": [k[:90] for k, _, _ in by["cudnn_benchmark"]]}
        print(f"conv3x3_f32 [{b}, {FEATURES}, {H}, {W}] {FEATURES}->{FEATURES}: kernel "
              f"{conv_ms:.5f} ms device, bound {bound_ms:.5f} ({bound_by}; "
              f"{100 * bound_ms / conv_ms:.1f}% of it); a call by CUDA events, in turns: the "
              f"kernel {ms['kernel']:.5f} ms (the weight's layout included), cuDNN f32 heuristic "
              f"{ms['cudnn']:.5f}, benchmark mode {ms['cudnn_benchmark']:.5f}; max |err| to float64 (scale {scale:.3f}): kernel {errs['kernel']:.3e}, "
              f"cuDNN {errs['cudnn']:.3e}, benchmark {errs['cudnn_benchmark']:.3e}; host us a "
              f"call: " + ", ".join(f"{k} {v:.2f}" for k, v in host_us.items()) + f"; {smi_line}",
              flush=True)
        for name in fns:
            print(f"  {name} kernels (ms a launch): " + "; ".join(
                f"{k[:80]} {us / n / 1e3:.5f}" for k, n, us in by[name]), flush=True)
        assert errs["kernel"] <= errs["cudnn"], errs
        rows[b] = row
        del x, ref
        _free()
    return rows


def phase_v2v(device, smi_line):
    """V2V-PoseNet's voxeliser (``csrc/voxelize.cu`` through
    ``torch.ops.pwr.voxelize``) at the V2V train cell's shape, [V2V_BATCH,
    480, 640] NYU frames to [V2V_BATCH, 1, 88, 88, 88] grids under the
    paper's augmentation: its grids equal ``voxelize_plain``'s, on the CPU
    and on the card, from the same rows, bit for bit, and two calls equal;
    its kernel's device time a launch (torch.profiler) beside the bytes
    bound (frames read, rows of per-sample numbers read, grids written); a
    call of the operator and of the plain version by CUDA events, in turns.
    Then ``make_train_step_v2v`` at full width (``V2VPoseNet(J)``, RMSprop,
    TF32 off) for V2V_STEPS steps on distinct batches and draws, the two
    voxel counters set to 0 just before: asserted 1 launch and V2V_BATCH
    frames a step, the first step's grid as the model received it equal to
    the plain version's on the CPU, every loss finite. Returns the kernel's
    row."""
    from pixelwiseregression_tpu_torch.core.precision import tf32_off
    from pixelwiseregression_tpu_torch.data.loader import to_device
    from pixelwiseregression_tpu_torch.data.sources import SPECS
    from pixelwiseregression_tpu_torch.models.v2v import V2VPoseNet
    from pixelwiseregression_tpu_torch.ops import voxel
    from pixelwiseregression_tpu_torch.train.loop import create_train_state, make_train_step_v2v

    tf32_off()
    cam = SPECS["NYU"].camera
    cfg = voxel.VoxelConfig(fx=cam.fx, fy=cam.fy, halfu=cam.halfu, halfv=cam.halfv,
                            side=V2V_SIDE)
    gen = torch.Generator(device=device).manual_seed(SEED + 90)
    batches = [_raw_batch(device, V2V_BATCH, SEED + 90 + i) for i in range(V2V_STEPS)]
    draws = [voxel.draw_augmentation(V2V_BATCH, gen, device, cfg) for _ in range(V2V_STEPS)]
    frame = batches[0]["frame"].to(torch.float32).contiguous()
    coef = voxel.coefficients(batches[0]["com"], draws[0], cfg)
    before = (voxel.LAUNCHES, voxel.VOXELIZED)
    grid, grid2 = voxel.voxelize(frame, coef, V2V_SIDE), voxel.voxelize(frame, coef, V2V_SIDE)
    assert (voxel.LAUNCHES - before[0], voxel.VOXELIZED - before[1]) == (2, 2 * V2V_BATCH)
    assert torch.equal(grid, grid2), "two calls of the voxeliser differ"
    plain_cpu = voxel.voxelize_plain(frame.cpu(), coef.cpu(), V2V_SIDE)
    assert torch.equal(grid.cpu(), plain_cpu), "the voxeliser differs from the plain version (CPU)"
    assert torch.equal(grid, voxel.voxelize_plain(frame, coef, V2V_SIDE)), \
        "the voxeliser differs from the plain version (card)"
    occupied = int(grid.sum())
    assert occupied > 100 * V2V_BATCH, occupied
    del grid2, plain_cpu

    def kernel():
        return voxel.voxelize(frame, coef, V2V_SIDE)

    def plain():
        return voxel.voxelize_plain(frame, coef, V2V_SIDE)

    by = _device_time_by_kernel(kernel)
    device_ms = next(us / n for k, n, us in by if "voxelize_kernel" in k) / 1e3
    (call_ms, _), (plain_ms, _) = _turns([kernel, plain], runs=5, iters=10)
    b, h, w = frame.shape
    nbytes = 4 * (b * h * w + b * voxel.COEFS + b * V2V_SIDE ** 3)
    bound_ms, bound_by = _bound(0, nbytes, "f32")
    print(f"voxelize [{b}, {h}, {w}] -> [{b}, 1, {V2V_SIDE}^3]: bit for bit with the plain "
          f"version, {occupied} voxels occupied; kernel {device_ms:.5f} ms device, bound "
          f"{bound_ms:.5f} ({bound_by}; {100 * bound_ms / device_ms:.1f}% of it); a call by CUDA "
          f"events, in turns: the operator {call_ms:.5f} ms, the plain version {plain_ms:.5f}; "
          f"{smi_line}", flush=True)
    del grid
    _free()

    torch.manual_seed(SEED + 91)
    net = V2VPoseNet(J, V2V_SIDE).to(device)
    state = create_train_state(net, opt="rmsprop", lr=2.5e-4, lr_decay=1.0)
    step = make_train_step_v2v(cfg)
    seen = []
    hook = net.register_forward_pre_hook(lambda mod, args: seen.append(args[0]) if not seen
                                         else None)
    host = [{k: v.cpu().numpy() for k, v in bt.items()} for bt in batches]
    del batches
    losses = []
    voxel.LAUNCHES = voxel.VOXELIZED = 0
    t = time.perf_counter()
    for i in range(V2V_STEPS):
        out = step(state, to_device(host[i], device), draws=draws[i])
        losses.append(float(out["loss"]))
    step_ms = (time.perf_counter() - t) / V2V_STEPS * 1e3
    launches, frames = voxel.LAUNCHES, voxel.VOXELIZED
    hook.remove()
    assert (launches, frames) == (V2V_STEPS, V2V_STEPS * V2V_BATCH), (launches, frames)
    assert all(math.isfinite(v) for v in losses), losses
    first = voxel.coefficients(torch.from_numpy(host[0]["com"]).to(device), draws[0], cfg)
    assert torch.equal(seen[0].cpu(), voxel.voxelize_plain(
        torch.from_numpy(host[0]["frame"]).to(torch.float32), first.cpu(), V2V_SIDE)), \
        "the train step's grid differs from the plain version"
    print(f"V2V train b{V2V_BATCH} J={J} {V2V_SIDE}^3 f32 rmsprop: {V2V_STEPS} steps, voxelize "
          f"launches {launches}, frames {frames}, losses {[f'{v:.6g}' for v in losses]}, "
          f"{step_ms:.1f} ms a step (the first included); peak memory allocated "
          f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB", flush=True)
    del state, step, net, seen
    _free()
    return {"launches": launches, "frames": frames, "device_ms": device_ms, "call_ms": call_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_share": bound_ms / device_ms, "shape": [b, h, w], "occupied": occupied}


def _host_us(fn, calls=10, runs=7):
    """Median host µs a call of ``fn`` over ``runs`` runs of ``calls`` calls
    issued back to back, the card idle at each run's start: the time to
    issue, which the card's queue hides from the device."""
    fn()
    us = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        us.append((time.perf_counter() - t) / calls * 1e6)
    torch.cuda.synchronize()
    return statistics.median(us)


def phase_profile(device, steps=3):
    """``--profile``: the main path's train step (phase_train's width:
    NYU-shaped raw frames, stages 2, features 128, level 4,
    instance_anchored, bf16, batch 128, the kernel decoder) under
    torch.profiler, after three warm-up steps and ten timed ones, by
    tools/profile_train.py's ``profile_calls``. Prints the wall time per
    step with and without the profiler, the device ops and device time per
    step, that time by the kernel-name groups of tools/profile_common.py's
    GROUPS and by the largest kernels, the device's idle share over the
    profiled steps read from the trace's own busy timeline (the union of
    its device ops, from the first one's start to the last one's end), and
    the peak memory allocated."""
    from pixelwiseregression_tpu_torch.tools import ab_common, profile_common, profile_train

    call, _ = ab_common.train_step_call(device, TRAIN_BATCH, J, STAGES, 128, 4,
                                        "instance_anchored", "bf16", "cuda", seed=SEED)
    out = profile_train.profile_calls(call, device, steps, warmup=3, wall_steps=10)
    prof = out["profile"]
    assert prof.leaves, "the trace holds no device op"
    device_ms = prof.total_us / 1e3 / steps
    print(f"profile train NYU stages={STAGES} bf16 batch={TRAIN_BATCH} decoder=cuda: "
          f"{out['wall_ms']:.2f} ms/step unprofiled (10 steps), {out['profiled_wall_ms']:.2f} "
          f"ms/step profiled ({steps} steps); {len(prof.leaves) / steps:.0f} device ops/step, "
          f"device time {device_ms:.2f} ms/step; device idle share "
          f"{1 - out['busy_us'] / out['span_us']:.4f} of the profiled span "
          f"({out['span_us'] / 1e3 / steps:.2f} ms/step); peak memory allocated "
          f"{out['peak_gib']:.2f} GiB")
    for group, us in profile_train.groups(prof).items():
        print(f"profile group {group}: {us / 1e3 / steps:.2f} ms/step "
              f"({us / 1e3 / steps / device_ms:.4f} of device time)")
    for name, (us, n) in list(profile_common.by_name(prof).items())[:15]:
        print(f"profile kernel {us / 1e3 / steps:.3f} ms/step in {n / steps:.0f} ops: {name[:160]}")


def _bound(flops, nbytes, kind):
    """The least time (ms) an H100 SXM could take, and what bounds it (the
    roofline the port's tools use)."""
    from pixelwiseregression_tpu_torch.tools.ab_common import bound

    seconds, by = bound(flops, nbytes, kind)
    return seconds * 1e3, by


_DT = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _decoder_bound(kernel, b, map_bytes=4, hm_bytes=4, dlabel=True):
    """K1 ("fwd") or K2 ("bwd") at [b, J, H*W]: each input read once and
    each output written once (K1: x and dm, the label and mask rows, hm, uvd;
    K2: x, dm, g_hm, the label and mask rows, dx, ddm, dlabel if asked,
    g_uvd and dw), ~16 f32 operations per element forward, ~30 backward."""
    n, hw = b * J * H * W, b * H * W
    if kernel == "fwd":
        return _bound(16 * n, map_bytes * (2 * n + 2 * hw) + hm_bytes * n + 4 * (b * J * 3 + J),
                      "f32")
    return _bound(30 * n, 4 * (5 * n + (3 if dlabel else 2) * hw + b * J * 6 + J), "f32")


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
        if pro:
            _plan_line("fused_chain", dtype, UNIT_BATCH, hw * hw, c, apply=False)
        if epi:
            _plan_line("fused_chain", dtype, UNIT_BATCH, hw * hw, co, apply=True)
        norms, others = _kernels_per_call(kernel)
        launched = norms + others
        assert (norms, others) == (pro + epi, 1), f"{name}: {norms} norm kernels, {others} others"
        ms, lib_ms = _turns([kernel])[0][0], _turns([library])[0][0]
        plain_ms = _turns([plain], runs=3, iters=5)[0][0]
        es = x.element_size()
        bound, by = _bound(2 * UNIT_BATCH * hw * hw * k * k * c * co,
                           es * (UNIT_BATCH * hw * hw * (c + co + (co if with_skip else 0))
                                 + k * k * c * co), tag)
        print(f"kernel fused_chain {name} [{UNIT_BATCH},{hw},{hw},{c}]->{co} k={k} {tag}: "
              f"max_abs_err={err:.3e} ({ulps:.2f} ulps of the scale, {share:.2e} of elements "
              f"> 1 ulp apart) kernel_ms={ms:.5f} plain_ms={plain_ms:.5f} "
              f"library_ms={lib_ms:.5f} (cuDNN conv alone, a partial yardstick) "
              f"bound_ms={bound:.5f} ({by}); share of the bound {bound / ms:.4f}, "
              f"{ms / lib_ms:.3f}x cuDNN's conv; {launched} kernels a call")
        cases[(name, tag)] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                              "library_ms": lib_ms, "bound_ms": bound, "bound_by": by,
                              "shape": [UNIT_BATCH, hw, hw, c, co, k]}
    return cases


def _hourglass_pixels(side, level):
    """Pixels summed over the ResBlocks of a level-`level` hourglass at side x side."""
    inner = _hourglass_pixels(side // 2, level - 1) if level > 0 else (side // 2) ** 2
    return side * side + inner + (side // 2) ** 2


def _perturbed_hourglass(seed, level=LEVEL):
    """A full-width Hourglass from a seed, norm scales and biases off 1 and 0."""
    from pixelwiseregression_tpu_torch.models.pixelwise import Hourglass

    torch.manual_seed(seed)
    hg = Hourglass(FEATURES, level, "instance")
    with torch.no_grad():
        for m in hg.modules():
            if hasattr(m, "method"):
                m.weight.add_(0.1 * torch.randn_like(m.weight))
                m.bias.add_(0.1 * torch.randn_like(m.bias))
    return hg


def _hourglass_case(device, side, level):
    """K4 against its plain version at [256, side, side, 128] bf16 on a
    level-`level` stack (the same input in f32 too), timed; returns its
    numbers, its stacked weights and its input. The bound counts each
    ResBlock's products at its own pixels, the input and output once and
    the stacked weights once."""
    from pixelwiseregression_tpu_torch.ops import cuda_hourglass as ch

    stacked = {k: v.to(device) for k, v in
               ch.stack_hourglass_params(_perturbed_hourglass(SEED + 60, level), level).items()}
    gen = torch.Generator(device=device).manual_seed(SEED + 61)
    x = torch.randn(UNIT_BATCH, side, side, FEATURES, generator=gen, device=device).to(torch.bfloat16)

    def kernel():
        return ch.hourglass_fused(x, stacked, level)

    def plain():
        return ch.hourglass_fused_plain(x, stacked, level)

    def rel_l2(a, b):
        return float((a.float() - b.float()).norm() / b.float().norm())

    got, want = kernel(), plain()
    got32 = ch.hourglass_fused(x.float(), stacked, level)
    want32 = ch.hourglass_fused_plain(x.float(), stacked, level)
    torch.cuda.synchronize()
    tag = f"hourglass_fused [{UNIT_BATCH},{side},{side},{FEATURES}] level {level}"
    assert got.shape == x.shape and torch.isfinite(got.float()).all(), tag
    err32 = float((got32 - want32).abs().max())
    assert err32 <= 1e-4 * float(want32.abs().max()), f"{tag} f32: {err32:.3e}"
    err, ulps, share = _rounding_gap(got, want)
    gap, own = rel_l2(got, want), rel_l2(want, want32)
    assert gap <= own, f"{tag} bf16: relative L2 gap {gap:.3e} above bf16's own {own:.3e}"
    del got32, want32
    ms = _turns([kernel], runs=5, iters=10)[0][0]
    plain_ms = _turns([plain], runs=3, iters=2)[0][0]
    c, ch2 = FEATURES, FEATURES // 2
    per_pixel = 2 * c * ch2 + 2 * 9 * ch2 * ch2 + 2 * ch2 * c
    weights = ch.num_resblocks(level) * (c * ch2 + 9 * ch2 * ch2 + ch2 * c)
    bound, by = _bound(UNIT_BATCH * _hourglass_pixels(side, level) * per_pixel,
                       2 * (2 * x.numel() + weights), "bf16")
    by_kernel = _device_time_by_kernel(kernel)
    print(f"{tag} bf16, device time per call by kernel (torch.profiler, 5 calls): " + "; ".join(
        f"{us:.1f} us in {n:g} launches: {name.replace('(anonymous namespace)::', '').split('(')[0][-60:]}"
        for name, n, us in by_kernel))
    print(f"kernel {tag} bf16: max_abs_err={err:.3e} ({ulps:.2f} ulps of the scale, {share:.2e} "
          f"of elements > 1 ulp apart, relative L2 gap {gap:.3e} against bf16's own {own:.3e}; "
          f"f32 max_abs_err {err32:.3e}) kernel_ms={ms:.5f} plain_ms={plain_ms:.5f} "
          f"library_ms=none bound_ms={bound:.5f} ({by})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by, "by_kernel": by_kernel}, stacked, x


def _device_time_by_kernel(fn, calls=5):
    """Device time (us) and launches per call of fn, by kernel name, from
    torch.profiler over `calls` calls after a warm-up; largest first."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        us = getattr(e, "cuda_time_total", 0) if us is None else us
        if us > 0 and not e.key.startswith(("aten::", "Activity", "cuda")):
            rows.append((e.key, e.count / calls, us / calls))
    return sorted(rows, key=lambda r: -r[2])


# substrings of the names of K4's kernels (K3's conv and norm kernels, the
# tail, the pool, the upsample-add): K4's share of a profiled forward
K4_KERNELS = ("conv_wgmma_kernel", "conv_f32_kernel", "norm_kernel", "tail_kernel",
              "maxpool2_kernel", "upsample2_add_kernel")


def _device_events(fn, calls):
    """torch.profiler's device kernels of `calls` calls of fn, after a
    warm-up: (name, device us) in launch order."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return [(e.name, e.device_time if hasattr(e, "device_time") else e.cuda_time)
            for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def _kernels_per_call(fn):
    """The kernels one call of fn launches through K3's and K5's launchers,
    as the library counts them: (norm kernels, others)."""
    from pixelwiseregression_tpu_torch.ops import cuda_fused as cf

    before = cf.norm_launches()
    fn()
    torch.cuda.synchronize()
    return tuple(a - b for a, b in zip(cf.norm_launches(), before))


def _plan_line(kind, dtype, b, hw, c, apply=True):
    """Prints and returns how a cluster-per-sample norm kernel runs [b, hw,
    c]: K3's statistics (`apply` False) or statistics and apply, or K5."""
    from pixelwiseregression_tpu_torch.ops import cuda_fused as cf
    from pixelwiseregression_tpu_torch.ops import cuda_normrelu as cn

    plan = cn.plan(dtype, b, hw, c) if kind == "normrelu_bwd" else cf.norm_plan(dtype, b, hw, c, apply)
    form = kind if kind == "normrelu_bwd" else ("statistics and apply" if apply else "statistics")
    print(f"plan {form} [{b},{hw},{c}] {str(dtype).split('.')[-1]}: cluster of {plan['cluster']} "
          f"blocks, {plan['path']}, {plan['smem']} bytes of shared memory a block")
    return plan


# the levels at 16x16 and below of the full-width level-4 hourglass, on
# their own: a level-2 hourglass at a quarter of the side (7 of its 11
# ResBlocks, 3 of its 5 pools and upsample-adds)
TAIL_SIDE, TAIL_LEVEL = H // 4, LEVEL - 2


def _k4_call_launches(ch, x, stacked, level):
    """What one K4 call reports it launched: (kernels, tail kernels)."""
    ch.KERNEL_LAUNCHES = ch.TAIL_LAUNCHES = 0
    ch.hourglass_fused(x, stacked, level)
    torch.cuda.synchronize()
    return ch.KERNEL_LAUNCHES, ch.TAIL_LAUNCHES


def phase_hourglass(device):
    """K4 vs its plain version at [256, 64, 64, 128] bf16, level 4, and the
    same input in f32; then the same at the levels it runs at 16x16 and
    below alone ([256, 16, 16, 128], level 2). From what each call reports
    it launched: the full-width bf16 call runs the one-block-per-sample tail
    once (torch.profiler's count of tail_kernel agrees), the f32 call never,
    and the level-2 call is the tail alone."""
    from pixelwiseregression_tpu_torch.ops import cuda_hourglass as ch

    full, stacked, x = _hourglass_case(device, H, LEVEL)
    stats = [(n, us) for name, n, us in full["by_kernel"] if "norm" in name]
    full.update(statistics_launches=round(sum(n for n, _ in stats)), statistics_us=sum(us for _, us in stats))
    tail_counts = [n for name, n, _ in full.pop("by_kernel") if "tail_kernel" in name]
    assert tail_counts == [1.0], f"torch.profiler: tail_kernel launches per call {tail_counts}"
    kernels, tails = _k4_call_launches(ch, x, stacked, LEVEL)
    kernels32, tails32 = _k4_call_launches(ch, x.float(), stacked, LEVEL)
    assert (kernels, tails, kernels32, tails32) == (29, 1, 76, 0), (kernels, tails, kernels32, tails32)
    # the statistics K4 runs outside the tail: each ResBlock's input (C)
    # and its two intermediates (C/2), at 64x64, 32x32 and 16x16
    for side in (H, H // 2, H // 4):
        for c in (FEATURES, FEATURES // 2):
            _plan_line("fused_chain", torch.bfloat16, UNIT_BATCH, side * side, c, apply=False)
    smem = ch.TAIL_SMEM_BYTES
    del stacked, x
    _free()
    case, stacked, x = _hourglass_case(device, TAIL_SIDE, TAIL_LEVEL)
    case.pop("by_kernel")
    assert _k4_call_launches(ch, x, stacked, TAIL_LEVEL) == (1, 1), "the level-2 call is the tail"
    full.update(tail_ms=case["ms"], tail_bound_ms=case["bound_ms"],
                tail_max_abs_err=case["max_abs_err"], launches_per_call=kernels,
                launches_per_call_f32=kernels32, tail_smem_bytes=smem)
    print(f"kernel hourglass_fused level {LEVEL}: bf16 launched {kernels} kernels a call, its "
          f"levels at {TAIL_SIDE}x{TAIL_SIDE} and below as one (the tail: {case['ms']:.5f} ms of "
          f"{full['ms']:.5f}, {smem} bytes of shared memory a block); f32 launched {kernels32}")
    del stacked, x
    _free()
    return full


def _tail_per_block(device):
    """``--profile``: the tail kernel's device time for one wave of blocks
    (one sample per SM), at 16x16 (level 2, 7 ResBlocks) and at 2x2 (level
    0, 3): a block's time, and its time per ResBlock at either size."""
    from pixelwiseregression_tpu_torch.ops import cuda_hourglass as ch

    sms = torch.cuda.get_device_properties(device).multi_processor_count
    gen = torch.Generator(device=device).manual_seed(SEED + 62)
    for side, level in ((TAIL_SIDE, TAIL_LEVEL), (2, 0)):
        stacked = {k: v.to(device) for k, v in
                   ch.stack_hourglass_params(_perturbed_hourglass(SEED + 60, level), level).items()}
        x = torch.randn(sms, side, side, FEATURES, generator=gen, device=device).to(torch.bfloat16)
        us = sum(t for name, _, t in _device_time_by_kernel(lambda: ch.hourglass_fused(x, stacked, level))
                 if "tail_kernel" in name)
        print(f"kernel hourglass_tail, one wave ({sms} samples), level {level} at {side}x{side}: "
              f"{us:.1f} us of device time, {us / ch.num_resblocks(level):.1f} us a ResBlock")


def _engine_by_kernel(device):
    """``--profile``: the fused engine's forward at full width, bf16, batch
    64, device time by kernel (torch.profiler, 5 forwards): the top rows,
    and K4's share (its kernels: K3's conv and norm kernels, the tail, the
    pool and the upsample-add)."""
    from pixelwiseregression_tpu_torch.models.infer_engine import make_fused_apply

    model = _engine_model(device, torch.bfloat16)
    inputs = _engine_inputs(device, ENGINE_BATCH, H, SEED + 71)
    fwd = make_fused_apply(model)
    with torch.inference_mode():
        rows = _device_time_by_kernel(lambda: fwd(*inputs))
    total = sum(us for _, _, us in rows)
    k4 = sum(us for name, _, us in rows if any(k in name for k in K4_KERNELS))
    print(f"profile fused engine NYU stages={STAGES} bf16 batch={ENGINE_BATCH}: {total:.1f} us of "
          f"device time a forward in {sum(n for _, n, _ in rows):g} kernels; K4's kernels "
          f"{k4:.1f} us ({k4 / total:.4f})")
    for name, n, us in rows[:12]:
        print(f"profile fused engine kernel {us:.1f} us in {n:g} launches ({us / total:.4f}): "
              f"{name.replace('(anonymous namespace)::', '')[:120]}")


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


def phase_engines(cs, device):
    """Both engines at full width, bf16, batch 64 (the main paths of this
    slice); returns each engine's (K3, K4, K1, K4's tail) launches per
    forward, and (norm_unit, norm_fused) the launches of K3's norm kernel
    in one forward of each."""
    from pixelwiseregression_tpu_torch.models.infer_engine import (make_fused_apply,
                                                                   make_unit_fused_apply)
    from pixelwiseregression_tpu_torch.ops import cuda_fused as cf
    from pixelwiseregression_tpu_torch.ops import cuda_hourglass as ch
    from pixelwiseregression_tpu_torch.tools import ab_common

    builders = {"unit": make_unit_fused_apply, "fused": make_fused_apply}
    model = _engine_model(device, torch.bfloat16)
    inputs = _engine_inputs(device, ENGINE_BATCH, H, SEED + 71)
    engines = {name: make(model) for name, make in builders.items()}
    outs, launches = {}, {}
    for name, fn in engines.items():
        cs.LAUNCHES = cf.LAUNCHES = ch.LAUNCHES = ch.TAIL_LAUNCHES = 0
        outs[name] = fn(*inputs)
        torch.cuda.synchronize()
        launches[name] = (cf.LAUNCHES, ch.LAUNCHES, cs.LAUNCHES, ch.TAIL_LAUNCHES)
    assert launches["unit"] == (32, 0, STAGES, 0), launches
    assert launches["fused"] == (0, STAGES, STAGES, STAGES), launches
    # launches of K3's norm kernel (statistics, or statistics and apply) in
    # a forward: in the unit engine's K3 units and the fused engine's K4
    for name, fn in engines.items():
        launches[f"norm_{name}"] = _kernels_per_call(lambda: fn(*inputs))[0]
    print(f"engine norm kernel launches per forward: unit {launches['norm_unit']}, "
          f"fused {launches['norm_fused']}")

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
    print(f"engine launches per forward (K3, K4, K1, K4's tail): unit {launches['unit']}, "
          f"fused {launches['fused']}")

    forwards = {**engines, "model": model}
    fps = {name: [] for name in forwards}
    for rep in range(3):
        for name in (forwards if rep % 2 == 0 else reversed(list(forwards))):
            with torch.inference_mode():
                sample = ab_common.make_sampler(lambda: forwards[name](*inputs), device, 5)
                fps[name].append(inputs[0].shape[0] / sample())
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
        plan = _plan_line("normrelu_bwd", dtype, shape[0], shape[1] * shape[2], c)

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

            counts = _kernels_per_call(kernel)
            assert counts == (1, 1), f"K5 launched {counts} (norm, other) kernels a call"
            launched = sum(counts)
            ms, lib_ms = _turns([kernel])[0][0], _turns([library])[0][0]
            plain_ms = _turns([plain], runs=5, iters=5)[0][0]
            n = x.numel()
            bound, by = _bound(12 * n, 2 * 3 * n + 4 * (2 * shape[0] * c + 4 * c), "f32")
            line += (f" kernel_ms={ms:.5f} plain_ms={plain_ms:.5f} library_ms={lib_ms:.5f} "
                     f"(ATen's autograd backward of relu(instance_norm)) bound_ms={bound:.5f} ({by}); "
                     f"{launched} kernels a call, cluster of {plan['cluster']}, {plan['path']}")
            out = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                   "bound_ms": bound, "bound_by": by, "shape": list(shape),
                   "kernels_per_call": launched, "cluster": plan["cluster"], "path": plan["path"]}
            del leaves, y
        print(line)
        del x, g, got, want
    _free()
    return out


def _turns_verdict(ms, spread, lib_ms, lib_spread):
    """Slower only if the median exceeds the library's by more than the
    larger of the two spreads."""
    return "slower" if ms - lib_ms > max(spread, lib_spread) * lib_ms else "no slower"


def _repeat_turns(x):
    """build_xm's repeat mode, concat(x, x, x) along channels, timed in
    turns with x.repeat(1, 1, 3), the one PyTorch call that computes it."""
    from pixelwiseregression_tpu_torch.ops import ablate_pieces as ap

    b, hw, c = x.shape
    got = ap.build_xm(x, H, W, "repeat")
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int16), x.repeat(1, 1, 3).view(torch.int16)), "repeat mode"
    del got
    (ms, spread), (lib_ms, lib_spread) = _turns(
        [lambda: ap.build_xm(x, H, W, "repeat"), lambda: x.repeat(1, 1, 3)])
    verdict = _turns_verdict(ms, spread, lib_ms, lib_spread)
    bound, by = _bound(0, 2 * 4 * x.numel(), "bf16")
    print(f"kernel ablate_build_xm repeat vs x.repeat(1, 1, 3) [{b},{hw},{c}] bf16, 7 turns of 20 "
          f"calls each: build_xm {ms:.5f} ms (spread {spread:.4f}), repeat {lib_ms:.5f} ms "
          f"(spread {lib_spread:.4f}): {ms / lib_ms:.4f}x, {verdict}; bound_ms={bound:.5f} ({by})")
    return {"ms": ms, "spread": spread, "library_ms": lib_ms, "library_spread": lib_spread,
            "verdict": verdict, "bound_ms": bound, "bound_by": by}


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

    def record(name, err, kernel, plain, library, bound, note, timed=None):
        ms, lib_ms = timed or (_turns([kernel])[0][0], _turns([library])[0][0] if library else None)
        plain_ms = _turns([plain], runs=3, iters=3)[0][0]
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
    # the copy against Tensor.copy_ in turns: slower only if its median
    # exceeds copy_'s by more than the larger of the two spreads
    (ms, spread), (lib_ms, lib_spread) = _turns([lambda: ap.copy(x), lambda: dst.copy_(x)])
    verdict = _turns_verdict(ms, spread, lib_ms, lib_spread)
    print(f"kernel ablate_copy vs Tensor.copy_ [{b},{hw},{c}] bf16, 7 turns of 20 calls each: "
          f"copy {ms:.5f} ms (spread {spread:.4f}), copy_ {lib_ms:.5f} ms (spread "
          f"{lib_spread:.4f}): {ms / lib_ms:.4f}x, {verdict}")
    record("ablate_copy", 0.0, lambda: ap.copy(x), lambda: x.clone(), lambda: dst.copy_(x),
           _bound(0, 2 * act, "bf16"), " (bit-exact)", timed=(ms, lib_ms))
    out["ablate_copy"].update(spread=spread, library_spread=lib_spread, verdict=verdict)
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
    out["ablate_build_xm"]["repeat"] = _repeat_turns(x)
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
    sms = _turns([lambda: ap.xm_dots(xr, w2, hws, (0, 0, 0))])[0][0]
    sbound, sby = _bound(2 * b * hws * 3 * 192 * 128, 2 * (xr.numel() + got.numel() + w2.numel()),
                         "bf16")
    print(f"kernel ablate_build_xm [{b},{hws},64] bf16: probe_cat and repeat bit-exact; "
          f"kernel ablate_xm_dots on the repeat operand [{b},{hws},192] x w2 [3,192,128], offsets "
          f"(0,0,0): max_abs_err={serr:.3e} ({sulps:.2f} ulps of the scale, {sshare:.2e} of "
          f"elements > 1 ulp apart) kernel_ms={sms:.5f} bound_ms={sbound:.5f} ({sby})")
    out["ablate_xm_dots"]["stem"] = {"shape": [b, hws, 192], "max_abs_err": serr, "ulps": sulps,
                                     "ms": sms, "bound_ms": sbound, "bound_by": sby}
    del x2, w2, xr, got, want
    _free()

    import torch.nn.functional as F

    got, want = ap.norm_stats_apply(x, es, eb), ap.norm_stats_apply_plain(x, es, eb)
    torch.cuda.synchronize()
    err, ulps, share = _rounding_gap(got, want)
    assert ulps <= UNIT_ULPS, f"norm_stats_apply: {ulps:.2f} bf16 ulps of the scale"
    del got, want
    plan = _plan_line("norm_stats_apply", torch.bfloat16, b, hw, c)
    launched = _kernels_per_call(lambda: ap.norm_stats_apply(x, es, eb))
    assert launched == (1, 0), f"norm_stats_apply launched {launched} (norm, other) kernels a call"
    x_nc = x.transpose(1, 2)  # [B, C, HW]: ATen's instance norm over the pixels

    def aten():
        return F.relu(F.instance_norm(x_nc, weight=es, bias=eb, eps=1e-5))

    record("norm_stats_apply", err, lambda: ap.norm_stats_apply(x, es, eb),
           lambda: ap.norm_stats_apply_plain(x, es, eb), aten, _bound(0, 2 * act, "bf16"),
           f" ({ulps:.2f} ulps of the scale, {share:.2e} of elements > 1 ulp apart; one kernel a "
           f"call, a cluster of {plan['cluster']} blocks a sample, {plan['path']}; library: ATen's "
           f"relu(instance_norm) forward on the same tensor)")
    out["norm_stats_apply"].update(cluster=plan["cluster"], path=plan["path"])
    del x
    _free()
    return out


# [B, HW, C] bf16 of K3's statistics and apply timed on their own: the head
# shape; 64x64 at C/2; the 16x16 level (64 KB and 32 KB samples, a cluster
# of one block); C = 8 and 16
NORM_SHAPES = ((UNIT_BATCH, H * W, FEATURES), (UNIT_BATCH, H * W, FEATURES // 2),
               (UNIT_BATCH, (H // 4) ** 2, FEATURES), (UNIT_BATCH, (H // 4) ** 2, FEATURES // 2),
               (UNIT_BATCH, H * W, 8), (UNIT_BATCH, H * W, 16))


def _launch_device_us(fn, key, launches, calls=3):
    """Device time (us) of each of the `launches` launches of a kernel
    whose name holds `key` in one call of fn, in launch order, averaged
    over `calls` calls (torch.profiler, after a warm-up); None if three
    sessions each lost some of them. Late in this script's runs the
    profiler has returned sessions without kernels launched by
    cudaLaunchKernelEx (the norm kernels' cluster launches)."""
    for _ in range(3):
        us = [t for name, t in _device_events(fn, calls) if key in name]
        if len(us) == launches * calls:
            return [sum(us[i + k * launches] for k in range(calls)) / calls for i in range(launches)]
    return None


def _graph_us(fn, reps=20, runs=5):
    """Device time (us) of one call of fn: `reps` calls captured in a CUDA
    graph after a warm-up, the median over `runs` replays timed by CUDA
    events, per call (no host work between the kernels, no profiler)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) * 1e3 / reps)
    del graph
    return statistics.median(times)


def phase_norm_shapes(device):
    """K3's statistics and apply by shape, and K4's statistics by launch,
    by device time: norm_stats_apply at each of NORM_SHAPES (a call's
    device time, from a CUDA graph of calls), and each of the 12
    statistics launches of a level-4 K4 call at [256, 64, 64, 128] bf16 in
    launch order (torch.profiler; "not measured" if it loses them).
    It imports the port lazily and reads nothing of it but the wrappers, so
    that a parent tree's package can be measured by this function in the
    same call (load this file by path from the parent's directory)."""
    from pixelwiseregression_tpu_torch.ops import ablate_pieces as ap
    from pixelwiseregression_tpu_torch.ops import cuda_hourglass as ch

    gen = torch.Generator(device=device).manual_seed(SEED + 95)
    out = {}
    for b, hw, c in NORM_SHAPES:
        x = (torch.randn(b, hw, c, generator=gen, device=device) + 2.0).to(torch.bfloat16)
        es = 1.0 + 0.1 * torch.randn(c, generator=gen, device=device)
        eb = 0.1 * torch.randn(c, generator=gen, device=device)
        out[f"{b}x{hw}x{c}"] = _graph_us(lambda: ap.norm_stats_apply(x, es, eb))
        del x
    print("norm shapes, norm_stats_apply bf16 device us a call: " +
          "; ".join(f"[{k.replace('x', ',')}] {v:.2f}" for k, v in out.items()))
    stacked = {k: v.to(device) for k, v in
               ch.stack_hourglass_params(_perturbed_hourglass(SEED + 60, LEVEL), LEVEL).items()}
    x = torch.randn(UNIT_BATCH, H, W, FEATURES, generator=gen, device=device).to(torch.bfloat16)
    per = _launch_device_us(lambda: ch.hourglass_fused(x, stacked, LEVEL), "norm", 12)
    print(f"norm shapes, K4 level {LEVEL} [{UNIT_BATCH},{H},{W},{FEATURES}] bf16 statistics by launch: " +
          ("not measured (torch.profiler lost launches)" if per is None else
           f"{sum(per):.1f} us in {len(per)} launches: " + ", ".join(f"{v:.1f}" for v in per)))
    out["k4_statistics_us"] = per
    del stacked, x
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
    summed over the tools. Prints the head unit's pieces side by side."""
    import importlib

    from pixelwiseregression_tpu_torch.tools import ab_common

    total = dict.fromkeys(ab_common.COUNTERS, 0)
    for name, kernels in TOOLS:
        tool = importlib.import_module(f"pixelwiseregression_tpu_torch.tools.{name}")
        ab_common.reset_counts()
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
        if name == "ablate_fused_unit":
            unit = result["ms"]
        _free()
    print("head unit by piece (ablate_fused_unit, ms): " + ", ".join(
        f"{v} {unit[v]:.5f}" for v in ("dots_only", "conv_only", "full")) +
        f"; conv_only - dots_only {unit['conv_only'] - unit['dots_only']:.5f}")
    return total


# the port bench's runs: a name, its flags, its headline metric and the
# launches of the headline's counted call (any other counter of
# ab_common.COUNTERS 0: conv3x3 only in the f32 run's forward); a run
# without --no_train adds the train line, whose counted step launches
# BENCH_TRAIN_LAUNCHES (K2 one kernel a call: no dlabel)
BENCH_RUNS = (
    ("model stage 1", ["--no_train", "--no_serving"], "inference_fps_nyu_stage1_128", {"K1": 1}),
    ("unit engine stage 1", ["--engine", "unit", "--no_train", "--no_serving"],
     "inference_fps_nyu_stage1_128_instancenorm", {"K3": 17, "K1": 1}),
    # K4's 29 kernels a bf16 call at [256, 64, 64, 128], level 4 (phase_hourglass)
    ("fused engine stage 1", ["--engine", "fused", "--no_train", "--no_serving"],
     "inference_fps_nyu_stage1_128_instancenorm",
     {"K4": 1, "K4_kernels": 29, "K4_tail": 1, "K1": 1}),
    ("model stage 2 and train", ["--stages", "2", "--no_serving"], "inference_fps_nyu_stage2_128",
     {"K1": STAGES}),
    ("model stage 2 f32", ["--stages", "2", "--dtype", "f32", "--no_train", "--no_serving"],
     "inference_fps_nyu_stage2_128", {"K1": STAGES, "conv3x3": CONVS}),
    ("model and int8 serving stage 1", ["--no_train", "--serving"], "inference_fps_nyu_stage1_128",
     {"K1": 1}),
)
BENCH_TRAIN_LAUNCHES = {"K1": STAGES, "K2": STAGES, "K2_kernels": STAGES}
# the serving line's counted call at stage 1: K1 and the int8 convs' products
# (3 in the stem, 33 in the hourglass's ResBlocks, 6 in the heads)
BENCH_SERVING_LAUNCHES = {"K1": 1, "int_mm": 42}


def phase_bench():
    """The port bench's main() for each of BENCH_RUNS in this process, every
    kernel counter set to 0 just before it and read just after; returns the
    launches by counter, summed over the runs."""
    from pixelwiseregression_tpu_torch import bench
    from pixelwiseregression_tpu_torch.tools import ab_common

    total = dict.fromkeys(ab_common.COUNTERS, 0)
    for name, argv, headline, want in BENCH_RUNS:
        train = "--no_train" not in argv
        serving = "--serving" in argv
        ab_common.reset_counts()
        out, t = io.StringIO(), time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = bench.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        counts = ab_common.read_counts()
        lines = [json.loads(line) for line in out.getvalue().splitlines()]
        for line in lines:
            print(f"bench {name}: {json.dumps(line)}", flush=True)
        assert rc == 0 and not any("error" in line for line in lines), (name, rc)
        by_metric = {line["metric"]: line for line in lines if "metric" in line}
        assert list(by_metric) == ([headline, bench.HEALTH_METRIC]
                                   + [bench.serving_metric(1)] * serving
                                   + [bench.TRAIN_METRIC] * train), list(by_metric)
        assert by_metric[headline]["launches"] == {k: want.get(k, 0) for k in counts}, \
            (name, by_metric[headline]["launches"])
        assert by_metric[headline]["samples"] >= 3
        kernels = set(want)
        if serving:
            line = by_metric[bench.serving_metric(1)]
            assert line["launches"] == {k: BENCH_SERVING_LAUNCHES.get(k, 0) for k in counts}, line
            assert line["samples"] >= 3 and line["quant"] == "int8_static_all", line
            kernels |= set(BENCH_SERVING_LAUNCHES)
        if train:
            line = by_metric[bench.TRAIN_METRIC]
            assert line["launches"] == {k: BENCH_TRAIN_LAUNCHES.get(k, 0) for k in counts}, line
            assert line["samples"] >= 6
            kernels |= set(BENCH_TRAIN_LAUNCHES)
        assert {k for k, n in counts.items() if n} == kernels, (name, counts)
        for k, n in counts.items():
            total[k] += n
        print(f"bench {name}: launches {counts} in {seconds:.1f} s", flush=True)
        _free()
    return total


def _check_no_spill(log, kernel):
    """Raise unless every function of `kernel` in a fresh build's ptxas log
    reports 0 bytes of spill (a cached build has no log: nothing to read);
    prints each one's registers."""
    if not log:
        print(f"ptxas: cached build, no log; spills of {kernel} not read")
        return
    lines = log.splitlines()
    found = [i for i, line in enumerate(lines) if "Function properties for" in line and kernel in line]
    assert found, f"the ptxas log names no {kernel}"
    regs = []
    for i in found:
        spill = next(line for line in lines[i + 1:] if "spill stores" in line)
        assert "0 bytes spill stores, 0 bytes spill loads" in spill, (lines[i], spill)
        used = next(line for line in lines[i + 1:] if "Used" in line)
        regs.append(int(used.split("Used")[1].split()[0]))
    print(f"ptxas: {len(found)} instantiations of {kernel}, no spill; registers {regs}")


def main() -> int:
    args = sys.argv[1:]
    if not (args in ([], ["--profile"], ["--conv"], ["--v2v"])
            or (args[:1] == ["--decoder"] and len(args) <= 2)):
        print("usage: chip_smoke.py [--profile | --conv | --v2v | --decoder [DIR]]",
              file=sys.stderr)
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
    smi_line = smi.stdout.strip().splitlines()[0]
    print(smi_line)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    t = time.perf_counter()
    lib, log = cuda_lib.build()
    print(f"built {lib.name} in {time.perf_counter() - t:.1f} s")
    for line in log.splitlines():
        if (any(k in line for k in ("registers", "spill", "wgmma", "xm_dots", "tail", "norm_kernel",
                                    "nr_kernel", "softargmax", "dlabel", "conv3x3"))
                or line.endswith(":")):
            print("ptxas:", line.strip())
    for kernel in ("conv_wgmma_kernel", "xm_dots_kernel", "tail_kernel", "norm_kernel", "nr_kernel",
                   "softargmax_fwd_kernel", "softargmax_bwd_kernel", "dlabel_kernel",
                   "conv3x3_f32_kernel", "voxelize_kernel"):
        _check_no_spill(log, kernel)
    if args == ["--conv"]:
        phase_conv3x3(device, smi_line)
        return 0
    if args == ["--v2v"]:
        phase_v2v(device, smi_line)
        return 0
    if args[:1] == ["--decoder"]:
        decoder_ab(args[1] if len(args) == 2 else None)
        return 0
    if args == ["--profile"]:
        phase_profile(device)
        _tail_per_block(device)
        _engine_by_kernel(device)
        return 0

    fwd = phase_kernel(cs, soft_argmax_decode_flat, device)
    bwd = phase_backward(cs, soft_argmax_decode_flat, device)
    dev = phase_decoder_device(device)
    serve_launches = phase_serve(cs, device)
    box_launches = phase_serve_boxes(cs, device)
    phase_reference(device)
    train_launches, train_ref = phase_train(cs, device)
    t = time.perf_counter()
    pre_launches = phase_train_preprocessed(cs, device, train_ref)
    del train_ref
    print(f"phase_train_preprocessed: {time.perf_counter() - t:.1f} s")
    phase_train_f32(cs, device)
    phase_train_reference(device)
    cli_launches = phase_cli(cs, device, smi_line)
    chain = phase_serving_chain(cs, device, smi_line)
    import shutil
    import tempfile

    work = tempfile.mkdtemp(prefix="pwr_slice_")
    try:
        data = _msra_fixture(work)
        fullreg = phase_fullreg(cs, device, smi_line, data, work)
        _free()
        paired = phase_paired(cs, device, smi_line)
        ddp = phase_ddp(cs, device, smi_line, data, work)
        _free()
        scripts = phase_scripts(cs, device, smi_line, data, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    _free()
    units = phase_fused_units(device)
    hourglass = phase_hourglass(device)
    engine_launches = phase_engines(cs, device)
    phase_engine_reference(device)
    normrelu = phase_normrelu(device)
    pieces = phase_ablate(device)
    norm_shapes = phase_norm_shapes(device)
    conv = phase_conv3x3(device, smi_line)
    v2v = phase_v2v(device, smi_line)
    tool_launches = phase_tools()
    bench_launches = phase_bench()

    source = "pixelwiseregression_tpu_torch/csrc/{}.cu"
    k6 = [("ablate_copy", "ablate_pieces", "copy", "tools/ablate_fused3.py:113",
           ["tools/ablate_fused3.py:136", "tools/ablate_fused_unit.py:131"],
           "16 bytes a thread per access through registers, four accesses in flight"),
          ("ablate_build_xm", "ablate_pieces", "build_xm", "tools/ablate_fused_unit.py:120",
           ["tools/ablate_fused2.py:178", "tools/ablate_fused2.py:165"],
           "a row-wise copy: a block's threads cover whole output rows in 16-byte chunks, "
           "each thread's column and source resolved once, 4 rows in flight, 32-bit index "
           "math within a sample; repeat mode timed in turns with x.repeat(1, 1, 3)"),
          ("ablate_xm_dots", "ablate_pieces", "xm_dots", "tools/ablate_fused_unit.py:152",
           ["tools/ablate_fused2.py:165"],
           "K3's bf16 conv main loop: wgmma m64n64k16 / m64n128k16 from shared-memory "
           "descriptors (128-byte swizzle), 256-pixel tiles of four warpgroups, 64-deep K "
           "steps over the flattened taps x K on a 3-stage cp.async ring"),
          ("norm_stats_apply", "fused_chain", "norm_stats_apply", "tools/ablate_fused_unit.py:126",
           [], "K3's norm kernel (csrc/cluster_norm.cuh): one thread-block cluster a sample, "
               "its slices in shared memory by bulk copies, the two-pass statistics summed over "
               "distributed shared memory in rank order, then the apply from shared memory")]
    k6_rows = [{"name": name, "route": "cuda", "source": source.format(src), "replaces": rep,
                "also_replaces": also, "launches": tool_launches[counter],
                "launches_by_path": {"tools": tool_launches[counter]}, **pieces[name],
                "shape": [UNIT_BATCH, H * W, FEATURES], "dtype": "bf16", "design": design}
               for name, src, counter, rep, also, design in k6]
    k6_rows[-1].update(
        library="ATen's relu(instance_norm) forward on the same tensor",
        kernel_launches_by_path={"tools": tool_launches["norm_stats_apply"],
                                 "unit_engine": engine_launches["norm_unit"],
                                 "fused_engine": engine_launches["norm_fused"],
                                 "k4_call": hourglass["statistics_launches"]},
        by_shape_device_us={k: v for k, v in norm_shapes.items() if k != "k4_statistics_us"},
        k4_statistics_us=hourglass["statistics_us"])
    main_fwd, main_bwd = fwd[(TRAIN_BATCH, "f32", J)], bwd[TRAIN_BATCH]
    head = units[("head_conv", "bf16")]

    def timing(key):
        r = dev[key]
        return {"device_ms": r["device_ms"], "call_ms": r["call_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "bound_share": r["bound_share"], "plan": r["plan"]}

    fwd_row = timing("fwd train")
    bwd_row = timing("bwd train without dlabel")
    print(json.dumps({"kernels": [
        {"name": "softargmax_fwd", "route": "cuda", "source": source.format("softargmax_fwd"),
         "replaces": "pixelwiseregression_tpu/ops/pallas_softargmax.py:50",
         "launches": train_launches[0],
         "launches_by_path": {"serve": serve_launches, "serve_boxes": box_launches,
                              "train": train_launches[0],
                              "train_preprocessed": pre_launches[0],
                              "cli_train": cli_launches["K1_train"],
                              "cli_test": cli_launches["K1_test"],
                              "unit_engine": engine_launches["unit"][2],
                              "fused_engine": engine_launches["fused"][2],
                              "artifact": chain["artifact"], "http": chain["http"],
                              "int8_serve": chain["int8_serve"],
                              "bench": bench_launches["K1"],
                              "paired_serve": paired["paired_serve"],
                              "paired_tool": paired["tool"],
                              "ddp_train": [r["K1"] for r in ddp["launches"]],
                              "fullreg_train": fullreg["fullreg_train"]["K1"],
                              "fullreg_test": fullreg["fullreg_test"]["K1"],
                              "fullreg_artifact": fullreg["artifact"],
                              **{f"scripts_{tool}": n["K1"] for tool, n in scripts.items()
                                 if n["K1"]}},
         "max_abs_err": main_fwd["max_abs_err"], "ms": fwd_row["call_ms"], **fwd_row,
         "plain_ms": main_fwd["plain_ms"], "library_ms": None,
         "by_path": {path: timing(f"fwd {path}") for path, *_ in DECODER_SHAPES},
         "shape": [TRAIN_BATCH, J, H * W], "dtype": "f32",
         "unit": "ms is call_ms (CUDA events around back-to-back wrapper calls); device_ms a "
                 "call's device time from a CUDA graph of calls; bound_share = bound/device",
         "design": "one block a row; the row's x, dm, label and mask in registers from one wave "
                   "of 16-byte loads, p = exp(z - zmax) / s once an element; rows above 4096 "
                   "pixels streamed in three passes; called through the registered operator "
                   "torch.ops.pwr.softargmax_fwd, which exported programs carry"},
        {"name": "softargmax_bwd", "route": "cuda", "source": source.format("softargmax_bwd"),
         "replaces": "pixelwiseregression_tpu/ops/pallas_softargmax.py:76",
         "launches": train_launches[1],
         "launches_by_path": {"train": train_launches[1],
                              "train_preprocessed": pre_launches[1],
                              "cli_train": cli_launches["K2"],
                              "bench": bench_launches["K2"],
                              "ddp_train": [r["K2"] for r in ddp["launches"]],
                              "fullreg_train": fullreg["fullreg_train"]["K2"],
                              **{f"scripts_{tool}": n["K2"] for tool, n in scripts.items()
                                 if n["K2"]}},
         "kernel_launches_by_path": {"train": train_launches[2],
                                     "train_preprocessed": pre_launches[2],
                                     "cli_train": cli_launches["K2_kernels"],
                                     "bench": bench_launches["K2_kernels"]},
         "max_abs_err": main_bwd["max_abs_err"], "ms": bwd_row["call_ms"], **bwd_row,
         "plain_ms": main_bwd["plain_ms"], "library_ms": None,
         "forms": {"without dlabel (train)": bwd_row, "with dlabel": timing("bwd train with dlabel")},
         "shape": [TRAIN_BATCH, J, H * W], "dtype": "f32",
         "unit": "ms is call_ms; device_ms, call_ms and the bound are the training path's "
                 "form, without dlabel (one kernel); plain_ms is autograd of the plain graph",
         "design": "one block a row; the row's x, dm, label, mask and g_hm in registers from one "
                   "wave of 16-byte loads, p once an element, the row's sums in double across "
                   "the block; dlabel, when asked, a second kernel over ddm"},
        {"name": "fused_chain", "route": "cuda", "source": source.format("fused_chain"),
         "replaces": "pixelwiseregression_tpu/ops/pallas_fused.py:102",
         "launches": engine_launches["unit"][0],
         "launches_by_path": {"unit_engine": engine_launches["unit"][0],
                              "fused_engine": engine_launches["fused"][0],
                              "tools": tool_launches["K3"], "bench": bench_launches["K3"]},
         "max_abs_err": head["max_abs_err"], "ms": head["ms"], "plain_ms": head["plain_ms"],
         "library_ms": head["library_ms"], "bound_ms": head["bound_ms"],
         "bound_by": head["bound_by"], "shape": head["shape"], "dtype": "bf16",
         "unit": "head_conv: 3x3 128->128 + epilogue norm; library_ms is cuDNN's conv alone",
         "design": "bf16: wgmma m64n64k16 / m64n128k16 from shared-memory descriptors "
                   "(128-byte swizzle), 256-pixel tiles of four warpgroups, 64-deep K steps "
                   "over a 3-stage cp.async ring; f32: FMA"},
        {"name": "hourglass_fused", "route": "cuda", "source": source.format("hourglass"),
         "replaces": "pixelwiseregression_tpu/ops/pallas_hourglass.py:188",
         "launches": engine_launches["fused"][1],
         "launches_by_path": {"unit_engine": engine_launches["unit"][1],
                              "fused_engine": engine_launches["fused"][1],
                              "bench": bench_launches["K4"]},
         "max_abs_err": hourglass["max_abs_err"], "ms": hourglass["ms"],
         "plain_ms": hourglass["plain_ms"], "library_ms": None,
         "bound_ms": hourglass["bound_ms"], "bound_by": hourglass["bound_by"],
         "tail_source": source.format("hourglass_tail"),
         "tail_launches": engine_launches["fused"][3],
         "tail_launches_bench": bench_launches["K4_tail"],
         "tail_ms": hourglass["tail_ms"], "tail_bound_ms": hourglass["tail_bound_ms"],
         "tail_max_abs_err": hourglass["tail_max_abs_err"],
         "tail_smem_bytes": hourglass["tail_smem_bytes"],
         "launches_per_call": hourglass["launches_per_call"],
         "launches_per_call_f32": hourglass["launches_per_call_f32"],
         "shape": [UNIT_BATCH, H, W, FEATURES], "dtype": "bf16",
         "design": "levels above 16x16 on K3's kernels plus pool and upsample-add kernels; "
                   "16x16 and below (bf16, C <= 128) one block per sample in shared memory, "
                   "mma.sync m16n8k16 from ldmatrix, weights by cp.async through two stages"},
        {"name": "normrelu_bwd", "route": "cuda", "source": source.format("normrelu_bwd"),
         "replaces": "pixelwiseregression_tpu/ops/fused_normrelu.py:124",
         "launches": tool_launches["K5"], "launches_by_path": {"tools": tool_launches["K5"]},
         **normrelu, "dtype": "bf16",
         "unit": "library_ms is ATen's autograd backward of relu(instance_norm)",
         "design": "one thread-block cluster a sample (csrc/cluster_norm.cuh): x resident in "
                   "shared memory where the cluster holds it, g beside it or through a ring; "
                   "the sums over distributed shared memory in rank order, dx from shared "
                   "memory; then the per-channel sums over the samples"},
        *k6_rows,
        {"name": "conv3x3_f32", "route": "cuda", "source": source.format("conv3x3_f32"),
         "replaces": None, "launches": CONV_LAUNCHES["train_f32"],
         "launches_by_path": {**CONV_LAUNCHES, "tools": tool_launches["conv3x3"],
                              "bench": bench_launches["conv3x3"]},
         "max_abs_err": conv[TRAIN_BATCH]["max_abs_err"], "ms": conv[TRAIN_BATCH]["device_ms"],
         "plain_ms": None, "library_ms": conv[TRAIN_BATCH]["cudnn_ms"], "by_batch": conv,
         "shape": conv[TRAIN_BATCH]["shape"], "dtype": "f32",
         "unit": "ms is the kernel's device time a launch (torch.profiler); library_ms a call of "
                 "cuDNN's f32 conv (TF32 off) as its heuristic picks it, by CUDA events in turns "
                 "with the kernel's call_ms; plain_ms: the plain version is cuDNN's",
         "design": "FFMA implicit GEMM on NCHW: 256 threads a block own 2 rows x 64 pixels x "
                   "128 channels, an 8x8 register tile a thread; chunks of 8 input channels "
                   "(slab with halo, weights [72][128]) by bulk copies on mbarriers, two stages; "
                   "nine taps from shared memory a load"},
        {"name": "voxelize", "route": "cuda", "source": source.format("voxelize"),
         "replaces": None, "launches": v2v["launches"],
         "launches_by_path": {"v2v_train": v2v["launches"]},
         "frames_by_path": {"v2v_train": v2v["frames"]}, "max_abs_err": 0.0,
         "ms": v2v["device_ms"], **{k: v2v[k] for k in ("device_ms", "call_ms", "bound_ms",
                                                           "bound_by", "bound_share")},
         "plain_ms": v2v["plain_ms"], "library_ms": None, "shape": v2v["shape"], "dtype": "f32",
         "unit": "ms is the kernel's device time a launch (torch.profiler); call_ms and plain_ms "
                 "a call of the operator and of voxelize_plain's torch ops by CUDA events, in "
                 "turns; max_abs_err 0: the grids equal the plain version's bit for bit",
         "design": "a block of 512 threads a slab of 22 z-planes of one sample, the slab's "
                   "occupancy as bits in shared memory, every pixel's voxel by __f*_rn steps "
                   "in the plain version's order, the grid written once, whole"},
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
