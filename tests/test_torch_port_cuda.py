"""The port's CUDA kernels on the card: the soft-argmax decoder's forward
(K1) and backward (K2) kernels, the fused conv + instance-norm unit (K3),
the whole hourglass (K4), the norm+relu backward (K5) and the ablation
pieces (K6) vs their plain PyTorch versions, the wrappers' checks, the
Predictor through K1 (and K1 as the operator ``torch.ops.pwr.softargmax_fwd``,
which a serving artifact exported on the CPU calls on the card), the int8
conv's product on the card vs the CPU, a train step through K1 and K2 (on raw and on preprocessed batches),
cv2's fixed-point warp card vs CPU, both inference engines through K3, K4 and K1, and the CLIs: Loader batches
through pinned memory, run_training through K1 and K2 and run_inference
through K1; the localisation of requests from a detector's boxes card vs
CPU, and such a request queued with no sync up to its gather; the heads'
f32 3x3 conv (``torch.ops.pwr.conv3x3_f32``) against a float64 conv and
cuDNN, its gradients against F.conv2d's, and its launches a forward; the
Predictor's CUDA graphs of its serving function: replayed answers equal to
eager ones bit for bit, each request's launches and the replay's kernels
in a trace, two clients racing through the capture, a replayed request
with no sync, a dropped Predictor's graph freed, and the int8 Predictors
capturing after their calibration; V2V-PoseNet's voxeliser
(``torch.ops.pwr.voxelize``) against its plain version bit for bit, and its
train step launching it once with no sync or pageable copy in its
preprocess.

Every test is marked ``cuda`` and skips where no CUDA card is visible. The
file imports neither jax nor the JAX package, so it also runs on a machine
without jax (``tests/conftest.py`` imports jax; pass ``--noconftest`` there):

    python -m pytest tests/test_torch_port_cuda.py -q -m cuda --noconftest
"""

import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from pixelwiseregression_tpu_torch.cli.common import make_test_parser, make_train_parser
from pixelwiseregression_tpu_torch.cli.test_main import run_inference
from pixelwiseregression_tpu_torch.cli.train_main import run_training
from pixelwiseregression_tpu_torch.data.loader import Loader, to_device
from pixelwiseregression_tpu_torch.data.preprocess import (PreprocessConfig, draw_augmentation,
                                                            preprocess_batch)
from pixelwiseregression_tpu_torch.data.sources import SPECS, get_source
from pixelwiseregression_tpu_torch.models.infer_engine import make_fused_apply, make_unit_fused_apply
from pixelwiseregression_tpu_torch.models.pixelwise import Hourglass, PixelwiseRegression
from pixelwiseregression_tpu_torch.models.v2v import V2VPoseNet
from pixelwiseregression_tpu_torch.ops import ablate_pieces as tap
from pixelwiseregression_tpu_torch.ops import cuda_conv as tconv
from pixelwiseregression_tpu_torch.ops import cuda_fused as tfused
from pixelwiseregression_tpu_torch.ops import cuda_hourglass as thg
from pixelwiseregression_tpu_torch.ops import cuda_normrelu as tcn
from pixelwiseregression_tpu_torch.ops import cuda_softargmax as tcuda
from pixelwiseregression_tpu_torch.ops import fused_normrelu as tnr
from pixelwiseregression_tpu_torch.ops import image as timage
from pixelwiseregression_tpu_torch.ops import softargmax as tsa
from pixelwiseregression_tpu_torch.ops import voxel as tvox
from pixelwiseregression_tpu_torch.serve import Predictor
from pixelwiseregression_tpu_torch.train.loop import (LossConfig, create_train_state, make_train_step,
                                                      make_train_step_v2v, model_inputs,
                                                      v2v_inputs)
from pixelwiseregression_tpu_torch.utils.synth import make_synthetic_raw_batch

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    # the plain versions' f32 convs must not run in TF32 (Predictor and the
    # train state set the same)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")


def _rows(device, dtype, b, j, h, w, seed=10):
    rng = np.random.RandomState(seed)
    hw = h * w

    def put(a):
        return torch.from_numpy(a.astype(np.float32)).to(device, dtype)

    return (put(3 * rng.randn(b, j, hw)), put(rng.randn(b, j, hw)), put(rng.randn(b, 1, hw)),
            put(rng.rand(b, 1, hw) > 0.4),
            torch.from_numpy((rng.rand(j) + 0.5).astype(np.float32)).to(device))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(32, 14, 64, 64), (3, 21, 24, 40)])
def test_kernel_matches_plain_version(device, dtype, shape):
    """f32 hm rtol 1e-5 atol 1e-8 (both compute in f32; only the summation
    order differs), bf16 hm within 1 ulp, uvd rtol 1e-5 atol 1e-6. The
    second shape has a map width that is not a power of two."""
    dt = getattr(torch, dtype)
    b, j, h, w = shape
    x, dm, label, mask, wt = _rows(device, dt, b, j, h, w)
    before = tcuda.LAUNCHES
    hm_k, uvd_k = tcuda.decode_flat(x, dm, label, mask, wt, h, w, hm_dtype=dt)
    torch.cuda.synchronize()
    assert tcuda.LAUNCHES == before + 1
    hm_p, uvd_p = tsa.soft_argmax_decode_flat(x, dm, label, mask, wt, h, w)
    if dt == torch.float32:
        torch.testing.assert_close(hm_k, hm_p, rtol=1e-5, atol=1e-8)
    else:
        ulps = (hm_k.view(torch.int16).int() - hm_p.to(dt).view(torch.int16).int()).abs()
        assert int(ulps.max()) <= 1
    torch.testing.assert_close(uvd_k, uvd_p, rtol=1e-5, atol=1e-6)


def test_nhwc_wrapper_matches_plain_decoder(device):
    """The JAX-signature wrapper (NHWC in, f32 boundary) on the card."""
    x, dm, label, mask, wt = _rows(device, torch.float32, 2, 14, 32, 32, seed=11)

    def nhwc(t):
        return t.reshape(t.shape[0], t.shape[1], 32, 32).permute(0, 2, 3, 1)

    args = [nhwc(t) for t in (x, dm, label, mask)] + [wt]
    hm_k, uvd_k = tcuda.soft_argmax_decode_cuda(*args)
    hm_p, uvd_p = tsa.soft_argmax_decode(*args)
    torch.testing.assert_close(hm_k, hm_p, rtol=1e-5, atol=1e-8)
    torch.testing.assert_close(uvd_k, uvd_p, rtol=1e-5, atol=1e-6)


def test_wrapper_rejects_what_the_kernel_does_not_take(device):
    x, dm, label, mask, wt = _rows(device, torch.float32, 2, 4, 8, 8)
    with pytest.raises(ValueError, match="contiguous"):
        strided = x.transpose(1, 2).contiguous().transpose(1, 2)
        tcuda.decode_flat(strided, dm, label, mask, wt, 8, 8)
    with pytest.raises(TypeError, match="one dtype"):
        tcuda.decode_flat(x, dm.to(torch.bfloat16), label, mask, wt, 8, 8)
    with pytest.raises(ValueError, match="pixels per row"):
        tcuda.decode_flat(x, dm, label, mask, wt, 4, 8)
    with pytest.raises(ValueError):
        tcuda.decode_flat(x, dm, label.cpu(), mask, wt, 8, 8)


def _loss(hm, uvd, use_heatmaps=True):
    """Touches both outputs with asymmetric weights, as tests/test_pallas_decoder.py does."""
    loss = torch.sum(uvd ** 2)
    if use_heatmaps:
        loss = loss + 0.1 * torch.sum(hm * hm) + torch.sum(hm[:, 0])
    return loss


def _grads(decode, rows, use_heatmaps):
    leaves = [t.clone().requires_grad_(i != 3) for i, t in enumerate(rows)]
    hm, uvd = decode(*leaves)
    _loss(hm, uvd, use_heatmaps).backward()
    return [leaves[i].grad for i in (0, 1, 2, 4)]


@pytest.mark.parametrize("use_heatmaps", [True, False])
@pytest.mark.parametrize("shape", [(32, 14, 64, 64), (128, 14, 64, 64), (3, 21, 24, 40)])
def test_backward_kernel_matches_plain_autograd(device, shape, use_heatmaps):
    """K2 through the autograd.Function vs autograd of the plain decoder, f32:
    rtol 1e-4, atol 1e-6 (the tolerances of tests/test_pallas_decoder.py).
    Sample 0 has an all-zero mask (den = 1e-14), which must give finite
    zeros; without the heatmap term the heatmap cotangent arrives as
    materialized zeros. The third shape's map width is not a power of two."""
    b, j, h, w = shape
    x, dm, label, mask, wt = _rows(device, torch.float32, b, j, h, w, seed=12)
    mask[0] = 0.0
    before = (tcuda.LAUNCHES, tcuda.BWD_LAUNCHES)
    got = _grads(lambda *a: tcuda.decode_flat(*a, h, w), (x, dm, label, mask, wt), use_heatmaps)
    torch.cuda.synchronize()
    assert (tcuda.LAUNCHES, tcuda.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    want = _grads(lambda *a: tsa.soft_argmax_decode_flat(*a, h, w), (x, dm, label, mask, wt),
                  use_heatmaps)
    for name, g, r in zip(("dx", "ddm", "dlabel", "dw"), got, want):
        assert torch.isfinite(g).all(), name
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-6, msg=name)
    assert float(got[1][0].abs().max()) == 0.0 and float(got[2][0].abs().max()) == 0.0


# (B, J, H, W) and the plan both kernels run it on: 64x64 is the main
# path's map; 128x128 (label_size 128) is too long a row to hold on chip
PLAN_SHAPES = {(4, 14, 64, 64): "on_chip", (2, 14, 128, 128): "streamed",
               (3, 21, 24, 40): "on_chip"}
DTYPE_FORMS = [("float32", "float32"), ("float32", "bfloat16"), ("bfloat16", "float32"),
               ("bfloat16", "bfloat16")]


@pytest.mark.parametrize("form", DTYPE_FORMS, ids=lambda f: f"{f[0]}->{f[1]}")
@pytest.mark.parametrize("shape", list(PLAN_SHAPES))
def test_forward_kernel_on_each_plan_and_dtype_form(device, shape, form):
    """K1 on both plans, in all four dtype forms (maps in, heatmaps out):
    f32 hm rtol 1e-5 atol 1e-8, bf16 hm within 1 ulp, uvd rtol 1e-5 atol
    1e-6; sample 0's mask is all zero; two calls give the same bits."""
    dt, ht = (getattr(torch, f) for f in form)
    b, j, h, w = shape
    assert tcuda.plan(h * w)["plan"] == PLAN_SHAPES[shape]
    x, dm, label, mask, wt = _rows(device, dt, b, j, h, w, seed=13)
    mask[0] = 0.0
    hm_k, uvd_k = tcuda.decode_flat(x, dm, label, mask, wt, h, w, hm_dtype=ht)
    again = tcuda.decode_flat(x, dm, label, mask, wt, h, w, hm_dtype=ht)
    assert torch.equal(hm_k, again[0]) and torch.equal(uvd_k, again[1])
    hm_p, uvd_p = tsa.soft_argmax_decode_flat(x, dm, label, mask, wt, h, w)
    if ht == torch.float32:
        torch.testing.assert_close(hm_k, hm_p, rtol=1e-5, atol=1e-8)
    else:
        ulps = (hm_k.view(torch.int16).int() - hm_p.to(ht).view(torch.int16).int()).abs()
        assert int(ulps.max()) <= 1
    torch.testing.assert_close(uvd_k, uvd_p, rtol=1e-5, atol=1e-6)
    assert float(uvd_k[0, :, 2].abs().max()) == 0.0  # no mask: d = 0 / 1e-14


@pytest.mark.parametrize("label_grad", [False, True])
@pytest.mark.parametrize("shape", list(PLAN_SHAPES))
def test_backward_kernel_on_each_plan(device, shape, label_grad):
    """K2 on both plans, through the autograd.Function, with the label image
    requiring grad or not: the kernels a call launched (1, or 2 with
    dlabel), dx, ddm, dlabel and dw vs autograd of the plain decoder at rtol
    1e-4 atol 1e-6, exact zeros in ddm and dlabel where the mask is all
    zero, dlabel equal to ddm summed over j in order from 0 (the dlabel
    kernel's order), and two calls giving the same bits."""
    b, j, h, w = shape
    assert tcuda.plan(h * w)["plan"] == PLAN_SHAPES[shape]
    x, dm, label, mask, wt = _rows(device, torch.float32, b, j, h, w, seed=14)
    mask[0] = 0.0

    def grads(decode):
        leaves = [t.clone().requires_grad_(i != 3 and (i != 2 or label_grad))
                  for i, t in enumerate((x, dm, label, mask, wt))]
        hm, uvd = decode(*leaves, h, w)
        _loss(hm, uvd).backward()
        return [leaves[i].grad for i in (0, 1, 2, 4)]

    before = (tcuda.BWD_LAUNCHES, tcuda.BWD_KERNEL_LAUNCHES)
    got = grads(tcuda.decode_flat)
    torch.cuda.synchronize()
    assert (tcuda.BWD_LAUNCHES - before[0], tcuda.BWD_KERNEL_LAUNCHES - before[1]) == \
        (1, 2 if label_grad else 1)
    again = grads(tcuda.decode_flat)
    want = grads(tsa.soft_argmax_decode_flat)
    for name, g, a, r in zip(("dx", "ddm", "dlabel", "dw"), got, again, want):
        if name == "dlabel" and not label_grad:
            assert g is None and a is None
            continue
        assert torch.isfinite(g).all(), name
        assert torch.equal(g, a), name
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-6, msg=name)
    assert float(got[1][0].abs().max()) == 0.0
    if label_grad:
        assert float(got[2][0].abs().max()) == 0.0
        fixed = torch.zeros_like(got[2][:, 0])
        for jj in range(j):
            fixed = fixed + got[1][:, jj]
        assert torch.equal(got[2][:, 0], fixed)


@pytest.mark.parametrize("lo, hi", [(1.0, 4096.0), (1e-14, 1.0)])
def test_branch_free_division_rounds_as_a_true_division(device, lo, hi):
    """The kernels divide by a row's s (in [1, H*W]) and den (in [1e-14, 1])
    without __fdiv_rn's branch; on 2^26 pairs it rounds as __fdiv_rn does."""
    assert tcuda.div_mismatches(lo, hi, 1 << 26, device) == 0


def test_backward_wrapper_rejects_what_the_kernel_does_not_take(device):
    x, dm, label, mask, wt = _rows(device, torch.bfloat16, 2, 4, 8, 8)
    with pytest.raises(TypeError, match="f32"):
        tcuda.decode_flat(x.requires_grad_(True), dm, label, mask, wt, 8, 8, hm_dtype=torch.bfloat16)
    x, dm, label, mask, wt = _rows(device, torch.float32, 2, 4, 8, 8)
    g_hm = torch.zeros_like(x)
    with pytest.raises(ValueError, match="cotangents"):
        tcuda.decode_flat_backward(x, dm, label, mask, wt, g_hm, torch.zeros(2, 3, 4, device=device),
                                   8, 8)
    with pytest.raises(TypeError, match="f32"):
        bf = [t.to(torch.bfloat16) for t in (x, dm, label, mask)]
        tcuda.decode_flat_backward(*bf, wt, g_hm, torch.zeros(2, 4, 3, device=device), 8, 8)


def test_decoder_operator_launches_k1(device):
    """``torch.ops.pwr.softargmax_fwd`` on CUDA tensors is K1: one counted
    launch a call, the plain version's answers (f32 hm rtol 1e-5 atol 1e-8,
    uvd rtol 1e-5 atol 1e-6), and the wrapper's checks (a mixed-device call
    raises)."""
    x, dm, label, mask, wt = _rows(device, torch.float32, 8, 14, 64, 64)
    before = tcuda.LAUNCHES
    hm_k, uvd_k = torch.ops.pwr.softargmax_fwd(x, dm, label, mask, wt, 64, 64, torch.float32)
    torch.cuda.synchronize()
    assert tcuda.LAUNCHES == before + 1
    hm_p, uvd_p = tsa.soft_argmax_decode_flat(x, dm, label, mask, wt, 64, 64)
    torch.testing.assert_close(hm_k, hm_p, rtol=1e-5, atol=1e-8)
    torch.testing.assert_close(uvd_k, uvd_p, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="one device"):
        torch.ops.pwr.softargmax_fwd(x, dm, label, mask, wt.cpu(), 64, 64, torch.float32)


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
@pytest.mark.parametrize("b,cin,cout,k,stride,side", [(2, 128, 128, 3, 1, 64),
                                                     (2, 32, 64, 3, 2, 128),
                                                     (3, 5, 3, 3, 1, 9), (1, 64, 64, 3, 1, 2)])
def test_int8_conv_card_matches_cpu(device, static, b, cin, cout, k, stride, side):
    """The int8 conv on the card (cuBLAS's int8 product) vs the CPU on the
    same inputs: codes and int32 accumulators bit-exact (channels padded to
    the product's multiples of 8, fewer than 17 rows padded), the f32
    output within 1 ulp."""
    from pixelwiseregression_tpu_torch.models import layers

    gen = torch.Generator().manual_seed(cin + side)
    x = torch.randn(b, cin, side, side, generator=gen)
    w = torch.randn(cout, cin, k, k, generator=gen) * 0.1
    bias = torch.randn(cout, generator=gen)
    scales = x.abs().amax(dim=(0, 2, 3)) * 0.9 if static else None
    x_q, w_q, _ = layers.int8_codes(x, w, scales)
    card = layers.int8_codes(x.to(device), w.to(device),
                             None if scales is None else scales.to(device))
    assert torch.equal(card[0].cpu(), x_q) and torch.equal(card[1].cpu(), w_q)
    before = layers.INT_MM_CALLS
    assert torch.equal(layers.int8_gemm(card[0], card[1], stride).cpu(),
                       layers.int8_gemm(x_q, w_q, stride))
    assert layers.INT_MM_CALLS == before + 2
    want = layers.int8_conv2d(x, w, bias, stride, scales)
    got = layers.int8_conv2d(x.to(device), w.to(device), bias.to(device), stride,
                             None if scales is None else scales.to(device)).cpu()
    ulp = torch.from_numpy(np.spacing(want.abs().numpy()))
    assert bool(((got - want).abs() <= ulp).all())


def test_artifact_exported_on_the_cpu_runs_k1_on_the_card(device, tmp_path):
    """A small f32 artifact exported on the CPU and loaded onto the card
    (``move_to_device_pass``) launches K1 once a stage a request and answers
    as a live Predictor on the card does (within 1e-4 px/mm)."""
    from pixelwiseregression_tpu_torch.serve_artifact import ServingArtifact, export_artifact

    spec = SPECS["MSRA"]
    torch.manual_seed(2)
    state = PixelwiseRegression(21, stage=2, features=16, level=2).state_dict()
    kw = dict(batch_size=4, stages=2, features=16, level=2, label_size=32)
    path = str(tmp_path / "small.pwrsrv")
    assert export_artifact(Predictor.from_state_dict(state, "MSRA", "cpu", **kw),
                           path)["device"] == "cpu"
    art = ServingArtifact.load(path, device)
    raw = make_synthetic_raw_batch(3, 240, 320, 21, fx=spec.camera.fx, fy=spec.camera.fy,
                                   cube=125.0, com_z=400.0, seed=6)
    before = tcuda.LAUNCHES
    got = art.predict(raw["frame"], raw["com"])
    torch.cuda.synchronize()
    assert tcuda.LAUNCHES == before + 2
    want = Predictor.from_state_dict(state, "MSRA", device, **kw).predict(raw["frame"], raw["com"])
    np.testing.assert_allclose(got["uvd"], want["uvd"], rtol=0, atol=1e-4)


def test_predictor_through_the_kernel_matches_plain_decoder(device):
    """A small bf16 Predictor on the card: decoder='cuda' launches the kernel
    once per stage and agrees with decoder='torch' within 1e-3 normalized
    (bf16 heatmaps from the two decoders may differ by 1 ulp before stage 2)."""
    spec = SPECS["NYU"]
    torch.manual_seed(0)
    state = PixelwiseRegression(14, stage=2, features=32, level=2,
                                norm_method="instance_anchored").state_dict()
    kw = dict(batch_size=8, stages=2, features=32, level=2, label_size=64,
              norm_method="instance_anchored", dtype=torch.bfloat16)
    preds = {d: Predictor.from_state_dict(state, "NYU", device, decoder=d, **kw)
             for d in ("cuda", "torch")}
    raw = make_synthetic_raw_batch(5, 480, 640, 14, fx=spec.camera.fx, fy=spec.camera.fy,
                                   cube=150.0, com_z=480.0)
    before = tcuda.LAUNCHES
    got = preds["cuda"].predict(raw["frame"], raw["com"])
    assert tcuda.LAUNCHES == before + 2
    want = preds["torch"].predict(raw["frame"], raw["com"])
    assert np.isfinite(got["uvd"]).all()
    box = raw["box_size"][:, None].astype(np.float64) - 1.0
    gap = np.abs(got["uvd"] - want["uvd"])
    assert (gap[..., 0] / box).max() <= 1e-3 and (gap[..., 1] / box).max() <= 1e-3
    assert (gap[..., 2] / 150.0).max() <= 1e-3


def test_f32_predictor_on_the_card_matches_the_cpu(device):
    """The same small f32 model and requests on the card (kernel decoder,
    cuDNN with TF32 off) and on the CPU (plain PyTorch, which the CPU tests
    hold against the JAX package): uvd and xyz within 2e-2 px/mm.

    Two-pass `instance` norms: with random weights the anchored norm's anchors
    are uncalibrated (anchor_n = 0), which makes it the raw one-pass form,
    and that form's result depends on the order of its sums (~0.7 px apart
    between card and CPU here)."""
    spec = SPECS["MSRA"]
    torch.manual_seed(1)
    state = PixelwiseRegression(21, stage=2, features=16, level=2,
                                norm_method="instance").state_dict()
    kw = dict(batch_size=4, stages=2, features=16, level=2, label_size=32,
              norm_method="instance", dtype=torch.float32)
    card = Predictor.from_state_dict(state, "MSRA", device, decoder="cuda", **kw)
    host = Predictor.from_state_dict(state, "MSRA", "cpu", decoder="torch", **kw)
    raw = make_synthetic_raw_batch(3, 240, 320, 21, fx=spec.camera.fx, fy=spec.camera.fy,
                                   cube=125.0, com_z=400.0, seed=5)
    got = card.predict(raw["frame"], raw["com"])
    want = host.predict(raw["frame"], raw["com"])
    for k in ("uvd", "xyz"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=2e-2)


def _train_once(device, decoder, state_dict, batch, draws):
    model = PixelwiseRegression(14, stage=2, features=16, level=2, norm_method="instance",
                                decoder=decoder).to(device)
    model.load_state_dict(state_dict)
    state = create_train_state(model, lr=1e-3, steps_per_epoch=100)
    spec = SPECS["NYU"]
    cfg = PreprocessConfig(fx=spec.camera.fx, fy=spec.camera.fy, halfu=spec.camera.halfu,
                           halfv=spec.camera.halfv, image_size=64, label_size=32,
                           using_rotation=True, using_scale=True, using_shift=True)
    metrics = make_train_step(cfg, LossConfig(alpha=0.5))(state, batch, draws=draws)
    return metrics, {n: p.grad.double() for n, p in model.named_parameters()}


def test_train_step_through_the_kernels_matches_plain_decoder(device):
    """One f32 train step of a small model (two stages) through K1 + K2
    against decoder='torch', same weights, batch and draws: each stage
    launches K1 and K2 once, and K2 one kernel (the label image needs no
    gradient, so no dlabel); loss rtol 1e-4; the last stage's output convs
    and temperature (between the loss and the last ReLU) within 1e-3
    relative; the whole gradient within 5e-2 relative (ReLU inputs near zero
    may flip between two roundings of the forward, see
    tests/test_torch_port_train.py)."""
    spec = SPECS["NYU"]
    torch.manual_seed(2)
    state_dict = PixelwiseRegression(14, stage=2, features=16, level=2,
                                     norm_method="instance").state_dict()
    raw = make_synthetic_raw_batch(4, 480, 640, 14, fx=spec.camera.fx, fy=spec.camera.fy,
                                   cube=150.0, com_z=450.0, seed=3)
    batch = {k: torch.from_numpy(v).to(device) for k, v in raw.items()}
    draws = draw_augmentation(4, torch.Generator(device=device).manual_seed(4), device)
    before = (tcuda.LAUNCHES, tcuda.BWD_LAUNCHES, tcuda.BWD_KERNEL_LAUNCHES)
    got, g_k = _train_once(device, "cuda", state_dict, batch, draws)
    torch.cuda.synchronize()
    assert (tcuda.LAUNCHES, tcuda.BWD_LAUNCHES, tcuda.BWD_KERNEL_LAUNCHES) == \
        (before[0] + 2, before[1] + 2, before[2] + 2)
    want, g_p = _train_once(device, "torch", state_dict, batch, draws)
    assert torch.isfinite(got["loss"])
    torch.testing.assert_close(got["loss"], want["loss"], rtol=1e-4, atol=0)
    for name in ("stages.1.plane_regression.w", "stages.1.plane_regression.conv.9.weight",
                 "stages.1.depth_regression.conv.9.weight"):
        assert float((g_k[name] - g_p[name]).norm() / g_p[name].norm()) <= 1e-3, name
    whole = (torch.cat([(g_k[n] - g_p[n]).flatten() for n in g_p]).norm()
             / torch.cat([g_p[n].flatten() for n in g_p]).norm())
    assert float(whole) <= 5e-2, float(whole)


def _small_state(device, state_dict):
    model = PixelwiseRegression(14, stage=2, features=16, level=2, norm_method="instance_anchored",
                                decoder="cuda").to(device)
    model.load_state_dict(state_dict)
    return create_train_state(model, lr=1e-3, steps_per_epoch=100)


@pytest.mark.parametrize("weight", [True, False])
def test_train_step_on_a_preprocessed_batch_equals_the_raw_step(device, weight):
    """make_train_step(None) on preprocess_batch(raw, draws) vs
    make_train_step(cfg) on raw with the same draws, both on the card (a
    small f32 model, two stages, anchored norms), with the last sample
    padded and with no weight: each step launches K1 and K2 once a stage and
    K2 one kernel a call; loss, stage losses, every gradient and every
    updated parameter and buffer equal bit for bit. cuDNN runs its
    deterministic algorithms here: its default f32 weight gradient sums in a
    run-dependent order, so two runs of one step part by an ulp."""
    spec = SPECS["NYU"]
    torch.manual_seed(5)
    state_dict = PixelwiseRegression(14, stage=2, features=16, level=2,
                                     norm_method="instance_anchored").state_dict()
    raw = make_synthetic_raw_batch(4, 480, 640, 14, fx=spec.camera.fx, fy=spec.camera.fy,
                                   cube=150.0, com_z=450.0, seed=6)
    batch = {k: torch.from_numpy(v).to(device) for k, v in raw.items()}
    if weight:
        batch["weight"] = torch.tensor([1.0, 1.0, 1.0, 0.0], device=device)
    draws = draw_augmentation(4, torch.Generator(device=device).manual_seed(7), device)
    cfg = PreprocessConfig(fx=spec.camera.fx, fy=spec.camera.fy, halfu=spec.camera.halfu,
                           halfv=spec.camera.halfv, image_size=64, label_size=32,
                           using_rotation=True, using_scale=True, using_shift=True)
    loss_cfg = LossConfig(alpha=0.5)
    s_raw, s_pre = _small_state(device, state_dict), _small_state(device, state_dict)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        m_raw = make_train_step(cfg, loss_cfg)(s_raw, batch, draws=draws)
        with torch.no_grad():
            data = preprocess_batch(batch, cfg, augment=True, draws=draws)
        if weight:
            data["weight"] = batch["weight"]
        before = (tcuda.LAUNCHES, tcuda.BWD_LAUNCHES, tcuda.BWD_KERNEL_LAUNCHES)
        m_pre = make_train_step(None, loss_cfg)(s_pre, data)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    assert (tcuda.LAUNCHES, tcuda.BWD_LAUNCHES, tcuda.BWD_KERNEL_LAUNCHES) == \
        (before[0] + 2, before[1] + 2, before[2] + 2)
    assert torch.isfinite(m_pre["loss"])
    assert torch.equal(m_pre["loss"], m_raw["loss"])
    assert torch.equal(m_pre["stage_losses"], m_raw["stage_losses"])
    grads = dict(s_raw.model.named_parameters())
    for name, p in s_pre.model.named_parameters():
        assert torch.equal(p.grad, grads[name].grad), name
    want = s_raw.model.state_dict()
    for name, t in s_pre.model.state_dict().items():
        assert torch.equal(t, want[name]), name


def test_full_width_train_step_makes_no_sync_after_the_preprocess(device):
    """One f32 train step of the full-width NYU PixelwiseRegression (14
    joints, two stages, 128 features, level 4, 128/64 crops, anchored norms,
    K1 and K2) at batch 2, on a batch preprocessed on the card before it
    (the preprocess still copies from pageable memory): under
    ``torch.cuda.set_sync_debug_mode("error")`` its forward, backward and
    optimizer step raise nothing. The anchors, calibrated by three
    train-mode forwards on the CPU, then match the same step's on the CPU
    (plain decoder): anchor_n moved once, and each norm's anchors part by
    at most 1e-3 of how far the step moved them (the bound these tests hold
    output-side gradients to). Card and CPU round the forward apart (cuDNN's
    FFT convs): over two seeds the widest norm read 2.0e-4, and 13-16 of the
    82 norms had an element outside the CPU JAX-parity rtol 1e-5 atol 1e-6,
    though the update's own arithmetic is bit-exact
    (tests/test_torch_port_norm_ema.py). A lost update reads 1."""
    spec = SPECS["NYU"]
    torch.manual_seed(8)
    host = PixelwiseRegression(14, stage=2, features=128, level=4, norm_method="instance_anchored",
                               decoder="torch")
    raw = make_synthetic_raw_batch(2, 480, 640, 14, fx=spec.camera.fx, fy=spec.camera.fy,
                                   cube=150.0, com_z=450.0, seed=9)
    batch = {k: torch.from_numpy(v).to(device) for k, v in raw.items()}
    draws = draw_augmentation(2, torch.Generator(device=device).manual_seed(10), device)
    cfg = PreprocessConfig(fx=spec.camera.fx, fy=spec.camera.fy, halfu=spec.camera.halfu,
                           halfv=spec.camera.halfv, image_size=128, label_size=64,
                           using_rotation=True, using_scale=True, using_shift=True)
    with torch.no_grad():
        data = preprocess_batch(batch, cfg, augment=True, draws=draws)
        data_cpu = {k: v.cpu() for k, v in data.items()}
        for _ in range(3):
            host.train()(*model_inputs(data_cpu))
    before = {k: v.clone() for k, v in host.state_dict().items() if k.endswith("anchor")}
    card = PixelwiseRegression(14, stage=2, features=128, level=4,
                               norm_method="instance_anchored", decoder="cuda").to(device)
    card.load_state_dict(host.state_dict())
    loss_cfg = LossConfig(lambda_h=1.0, lambda_d=0.01, alpha=1.0)
    s_card = create_train_state(card, lr=1e-3, steps_per_epoch=568)
    s_host = create_train_state(host, lr=1e-3, steps_per_epoch=568)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        m_card = make_train_step(None, loss_cfg)(s_card, data)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    m_host = make_train_step(None, loss_cfg)(s_host, data_cpu)
    assert torch.isfinite(m_card["loss"]) and torch.isfinite(m_host["loss"])
    got, want = card.state_dict(), host.state_dict()
    assert len(before) == 82
    for k, b in before.items():
        gap = float((got[k].cpu() - want[k]).norm() / (want[k] - b).norm())
        assert gap <= 1e-3, (k, gap)
        assert float(got[k + "_n"]) == float(want[k + "_n"]) == 4.0, k


@pytest.mark.parametrize("h,w", [(128, 128), (480, 640)])
def test_quantized_warp_on_the_card_equals_the_cpu(device, h, w):
    """cv2's fixed-point warp (warp_affine_inverse(quantize=True)) on the
    card vs the CPU, bit for bit: ramps (value = x, value = y) and a
    depth-like image (+-100 mm on a zero background), by inverse
    rotation/scale matrices (angles in +-30 degrees, scales 0.8-1.2) and one
    random affine. Each product and sum is its own kernel, so no fused
    multiply-add moves a term that lies on a rounding boundary."""
    rng = np.random.RandomState(h + w)
    depth = rng.uniform(-100, 100, (h, w)).astype(np.float32)
    depth[: h // 6] = 0.0
    depth[:, w * 3 // 4:] = 0.0
    images = {"ramp_x": np.broadcast_to(np.arange(w, dtype=np.float32), (h, w)),
              "ramp_y": np.broadcast_to(np.arange(h, dtype=np.float32)[:, None], (h, w)),
              "depth": depth}
    angles = torch.from_numpy(np.r_[0.0, 30.0, -30.0, rng.uniform(-30, 30, 4)].astype(np.float32))
    scales = torch.from_numpy(np.r_[1.0, 0.8, 1.2, rng.uniform(0.8, 1.2, 4)].astype(np.float32))
    affine = np.array([[1.07, 0.21, -3.7, -0.17, 0.91, 5.3]], np.float32)
    minv = torch.cat([timage.rotation_matrix_inverse(angles, scales, w / 2, h / 2),
                      torch.from_numpy(affine)])
    for name, img in images.items():
        imgs = torch.from_numpy(np.ascontiguousarray(np.broadcast_to(img, (len(minv), h, w))))
        cpu = timage.warp_affine_inverse(imgs, minv, quantize=True)
        card = timage.warp_affine_inverse(imgs.to(device), minv.to(device), quantize=True).cpu()
        assert torch.equal(card, cpu), (name, int((card != cpu).sum()))


# --------------------------------------------------------------------------- #
# K3 (fused conv + instance norm) and K4 (whole hourglass)
# --------------------------------------------------------------------------- #

# (k, C, Co, prologue, epilogue) per unit, whether the chain ends with + x,
# and the input's (B, H, W). The bf16 conv runs 128-pixel tiles of 64 or 128
# (Co >= 128) output channels, K steps of 8 chunks of 8 channels over the
# flattened taps x channels, and resolves each tile row's own sample
UNIT_FORMS = {
    # one tile and one K step: a plain GEMM
    "gemm": ([(1, 16, 64, False, False)], False, (1, 8, 8)),
    "epi_k1": ([(1, 8, 16, False, True)], False, (3, 12, 12)),
    "epi_k3": ([(3, 8, 16, False, True)], False, (3, 12, 12)),
    "pro_k1": ([(1, 16, 8, True, False)], False, (3, 12, 12)),
    "pro_k3": ([(3, 16, 8, True, False)], False, (3, 12, 12)),
    "both": ([(3, 8, 16, True, True)], False, (3, 12, 12)),
    "pro_skip": ([(1, 16, 16, True, False)], True, (3, 12, 12)),
    "head_chain": ([(3, 8, 8, False, True)] * 3, False, (3, 12, 12)),
    "resblock": ([(1, 16, 8, True, False), (3, 8, 8, True, False), (1, 8, 16, True, False)], True,
                 (3, 12, 12)),
    # past one tile in M and N, K steps across taps (C = 48 and 72), C > 32
    "wide": ([(3, 48, 72, True, True), (1, 72, 48, True, False)], True, (3, 12, 12)),
    # C = 32: two taps per K step; Co = 72 and 24
    "two_taps": ([(3, 32, 72, False, True), (3, 72, 24, True, False)], False, (3, 12, 12)),
    # C = 40: five chunks per tap, K steps that straddle taps; Co = 128
    "c40": ([(3, 40, 128, True, False)], False, (3, 12, 12)),
    # 4x4 samples: every tile spans nine samples, each row its own prologue
    "span_4x4": ([(3, 8, 24, True, True), (1, 24, 8, True, False)], True, (9, 4, 4)),
    # 8x8 samples, C = Co = 128: two samples per tile, the 128-wide tile
    "span_8x8": ([(3, 128, 128, True, True), (1, 128, 128, True, False)], True, (3, 8, 8)),
    # large enough to fill the card: many tiles, every stage of the ring
    "fill": ([(3, 128, 128, False, True)], False, (8, 64, 64)),
}


def _units(spec, seed, device):
    rng = np.random.RandomState(seed)
    units = []
    for k, c, co, pro, epi in spec:
        def put(a):
            return torch.from_numpy(a.astype(np.float32)).to(device)
        u = {"kernel": put(0.3 * rng.randn(k, k, c, co)), "bias": put(0.1 * rng.randn(co))}
        if pro:
            u["pro"] = (put(1.0 + 0.1 * rng.randn(c)), put(0.1 * rng.randn(c)))
        if epi:
            u["epi"] = (put(1.0 + 0.1 * rng.randn(co)), put(0.1 * rng.randn(co)))
        units.append(u)
    return units


def _bf16_ulps(got, want):
    """|got - want| in bf16 ulps of the output's largest magnitude."""
    scale = float(want.float().abs().max())
    ulp = 2.0 ** (np.floor(np.log2(scale)) - 7)
    return float((got.float() - want.float()).abs().max()) / ulp


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("form", list(UNIT_FORMS))
def test_fused_chain_kernel_matches_plain_version(device, form, dtype):
    """K3 vs its plain version on the card, same inputs. f32: atol 1e-4 of
    the output's scale (both accumulate in f32, in another order; an
    epilogue's statistics carry that order into every element). bf16: at
    most 2 bf16 ulps of the output's scale (an order difference flips a
    rounding by 1 ulp; a chain may carry one flip into the next unit)."""
    dt = getattr(torch, dtype)
    spec, with_skip, (b, h, w) = UNIT_FORMS[form]
    rng = np.random.RandomState(20)
    x = torch.from_numpy((1.0 + rng.randn(b, h, w, spec[0][1])).astype(np.float32)).to(device, dt)
    units = _units(spec, 21, device)
    skip = x if with_skip else None
    before = tfused.LAUNCHES
    got = tfused.fused_chain(x, units, skip=skip)
    torch.cuda.synchronize()
    assert tfused.LAUNCHES == before + 1
    want = tfused.fused_chain_plain(x, units, skip=skip)
    assert got.shape == want.shape and got.dtype == dt and torch.isfinite(got.float()).all()
    if dt == torch.float32:
        scale = float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * scale)
    else:
        assert _bf16_ulps(got, want) <= 2.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_chain_kernel_zero_padding_is_exact(device, dtype):
    """The 3x3 border on the card, integer-exact (tests/test_pallas_fused.py):
    interior 9C, edges 6C, corners 4C, and a left tap that sees a zero at x=0."""
    dt = getattr(torch, dtype)
    c = 8
    x = torch.ones(1, 8, 8, c, device=device, dtype=dt)
    w = torch.ones(3, 3, c, c, device=device)
    b = torch.zeros(c, device=device)
    got = tfused.fused_conv_norm(x, w, b)[0, :, :, 0].float().cpu()
    assert got[4, 4] == 9 * c and got[0, 4] == 6 * c and got[4, 0] == 6 * c
    assert got[0, 0] == 4 * c and got[-1, -1] == 4 * c
    xv = torch.arange(8, device=device, dtype=torch.float32)[None, None, :, None].expand(1, 8, 8, c)
    wl = torch.zeros(3, 3, c, c, device=device)
    wl[1, 0] = 1.0
    got = tfused.fused_conv_norm(xv.to(dt).contiguous(), wl, b)[0, 4, :, 0].float().cpu()
    want = torch.cat([torch.zeros(1), torch.arange(7, dtype=torch.float32)]) * c
    assert torch.equal(got, want)


def test_fused_chain_kernel_takes_a_weight_view_off_16_bytes(device):
    """A conv weight that is a view 2 bytes into a larger tensor (the kernel
    loads weights 16 bytes at a time): the same result as a fresh copy."""
    x = torch.randn(2, 8, 8, 16, device=device).to(torch.bfloat16)
    units = _units([(3, 16, 16, True, True)], 42, device)
    flat = torch.empty(units[0]["kernel"].numel() + 1, device=device, dtype=torch.bfloat16)
    view = flat[1:].view(units[0]["kernel"].shape)
    view.copy_(units[0]["kernel"])
    assert view.data_ptr() % 16
    got = tfused.fused_chain(x, [{**units[0], "kernel": view}])
    want = tfused.fused_chain(x, [{**units[0], "kernel": view.clone()}])
    assert torch.equal(got, want)


def _hourglass_state(features, level, seed):
    torch.manual_seed(seed)
    hg = Hourglass(features, level, "instance")
    with torch.no_grad():  # norm scales and biases away from 1 and 0
        for m in hg.modules():
            if hasattr(m, "method"):
                m.weight.add_(0.1 * torch.randn_like(m.weight))
                m.bias.add_(0.1 * torch.randn_like(m.bias))
    return hg


# (shape, level, kernels a bf16 call launches, kernels an f32 call
# launches): the bf16 calls run the levels at 16x16 and below as one block
# per sample (the tail): level 0 at 4x4 and level 1 at 16x16 whole, level 3
# at 32x32 on K3's kernels above the tail (6 a ResBlock, a pool and an
# upsample-add, then the tail), level 2 at 16x16 whole with 133 samples
# (more blocks than the card's 132 SMs), and the full-width level 4 at
# 64x64 (the statistics on clusters of 16, 8, 4 and 2 blocks, 29 kernels);
# f32 runs every level on K3's kernels (14 a level, 20 at level 0)
HOURGLASS_CASES = [((2, 16, 16, 32), 1, 1, 34), ((3, 16, 16, 128), 2, 1, 48),
                   ((5, 4, 4, 128), 0, 1, 20), ((3, 32, 32, 128), 3, 15, 62),
                   ((133, 16, 16, 128), 2, 1, 48), ((2, 64, 64, 128), 4, 29, 76)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape, level, kernels_bf16, kernels_f32", HOURGLASS_CASES)
def test_hourglass_kernel_matches_plain_version(device, dtype, shape, level, kernels_bf16,
                                                kernels_f32):
    """K4 vs its plain version on the card: level 1 at [2, 16, 16, 32], and
    level 2 at [3, 16, 16, 128] (64-channel 3x3 convs with split taps, the
    128-wide conv tile for the 1x1 64->128 convs, and tiles that span
    samples at 8x8 and 4x4), and the tail's cases (HOURGLASS_CASES): the
    call reports the kernels it launched, the tail among them exactly once
    in bf16 and never in f32. f32: atol 1e-4 of the output's
    scale. bf16: at levels 0 and 1 at most 4 bf16 ulps of the scale (17
    convs and 15 norms deep; an order difference that flips one rounding
    moves the statistics of every later norm); at every level a relative
    L2 gap within the plain version's own bf16-vs-f32 gap, as chip_smoke.py
    holds the full-width K4: at level 2 (7 ResBlocks) the per-element gap
    reads 6 ulps, with the conv's earlier wmma loop as with its wgmma loop."""
    dt = getattr(torch, dtype)
    stacked = {k: v.to(device) for k, v in
               thg.stack_hourglass_params(_hourglass_state(shape[-1], level, 30), level).items()}
    x = torch.from_numpy(np.random.RandomState(31).randn(*shape).astype(np.float32))
    x = x.to(device, dt)
    before = (thg.LAUNCHES, thg.KERNEL_LAUNCHES, thg.TAIL_LAUNCHES)
    got = thg.hourglass_fused(x, stacked, level)
    torch.cuda.synchronize()
    bf16 = dt == torch.bfloat16
    assert (thg.LAUNCHES - before[0], thg.KERNEL_LAUNCHES - before[1],
            thg.TAIL_LAUNCHES - before[2]) == (1, kernels_bf16 if bf16 else kernels_f32, int(bf16))
    want = thg.hourglass_fused_plain(x, stacked, level)
    assert torch.isfinite(got.float()).all()
    if dt == torch.float32:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * float(want.abs().max()))
    else:
        want32 = thg.hourglass_fused_plain(x.float(), stacked, level)
        gap = float((got.float() - want.float()).norm() / want.float().norm())
        own = float((want.float() - want32).norm() / want32.norm())
        assert gap <= own, (gap, own)
        if level <= 1:
            assert _bf16_ulps(got, want) <= 4.0


def test_fused_wrappers_reject_what_the_kernels_do_not_take(device):
    x = torch.randn(2, 8, 8, 16, device=device)
    units = _units([(3, 16, 16, True, True)], 40, device)
    with pytest.raises(ValueError, match="contiguous"):
        tfused.fused_chain(x.transpose(1, 2), units)
    with pytest.raises(TypeError):
        tfused.fused_chain(x.half(), units)
    with pytest.raises(TypeError):
        tfused.fused_chain(x, units, skip=x.to(torch.bfloat16))
    with pytest.raises(ValueError):
        tfused.fused_chain(x, [{**units[0], "bias": units[0]["bias"].cpu()}])
    with pytest.raises(ValueError):
        tfused.fused_chain(x.cpu(), units)
    stacked = {k: v.to(device) for k, v in
               thg.stack_hourglass_params(_hourglass_state(16, 0, 41), 0).items()}
    with pytest.raises(ValueError, match="contiguous"):
        thg.hourglass_fused(x.transpose(1, 2), stacked, 0)
    with pytest.raises(TypeError):
        thg.hourglass_fused(x.half(), stacked, 0)
    with pytest.raises(ValueError):
        thg.hourglass_fused(x, {**stacked, "w1": stacked["w1"].cpu()}, 0)
    with pytest.raises(ValueError):
        thg.hourglass_fused(x.cpu(), stacked, 0)


def _engine_inputs(device, b=3, label=16, seed=50):
    rng = np.random.RandomState(seed)

    def put(a):
        return torch.from_numpy(a.astype(np.float32)).to(device)

    return (put(rng.randn(b, 1, 2 * label, 2 * label)), put(rng.randn(b, 1, label, label)),
            put(rng.rand(b, 1, label, label) > 0.3))


@pytest.mark.parametrize("engine", ["unit", "fused"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_engine_through_the_kernels_matches_its_plain_version(device, engine, dtype):
    """Both engines on the card (features 64, level 2, 2 stages, 14 joints):
    the kernels against the same engine on the kernels' plain versions, same
    weights and inputs. Launches per forward: the unit engine (min_res 4)
    runs 1 stem unit and, per stage, 5 ResBlocks of 3 units at 4x4 and
    above plus 6 head units: 43; the fused engine 2 K4; K1 2 either way.
    f32 uvd within the JAX engine tests' bounds, 5e-4 for stage 1 and 5e-3
    for stage 2 (tests/test_infer_engine.py:62-63). bf16 uvd within 2e-2
    (:77-80) or twice the plain engine's own bf16-vs-f32 gap, whichever is
    larger: on random weights two bf16 roundings of this 2-stage level-2
    model part by several 1e-2 in uvd, since the instance norms amplify a
    1-ulp difference (PERF.md, section 6)."""
    dt = getattr(torch, dtype)

    def build(model, **kw):
        if engine == "unit":
            return make_unit_fused_apply(model, min_res=4, **kw)
        return make_fused_apply(model, **kw)

    def model_in(dtype_):
        torch.manual_seed(5)
        return PixelwiseRegression(14, stage=2, features=64, level=2, norm_method="instance",
                                   decoder="cuda", dtype=dtype_).to(device).eval()

    model = model_in(dt)
    inputs = _engine_inputs(device)
    counter, per_forward = (tfused, 43) if engine == "unit" else (thg, 2)
    before = (counter.LAUNCHES, tcuda.LAUNCHES)
    got = build(model)(*inputs)
    torch.cuda.synchronize()
    assert (counter.LAUNCHES - before[0], tcuda.LAUNCHES - before[1]) == (per_forward, 2)
    want = build(model, plain=True)(*inputs)
    if dt == torch.bfloat16:
        want32 = build(model_in(torch.float32), plain=True)(*inputs)
        own = [float((a[2] - b[2]).abs().max()) for a, b in zip(want, want32)]
    for s, ((hm, dm, uvd), (hm_p, dm_p, uvd_p)) in enumerate(zip(got, want)):
        assert hm.shape == (3, 14, 16, 16) and dm.shape == hm.shape and uvd.shape == (3, 14, 3)
        assert torch.isfinite(uvd).all() and torch.isfinite(hm).all()
        bound = max(2e-2, 2 * own[s]) if dt == torch.bfloat16 else (5e-4 if s == 0 else 5e-3)
        gap = float((uvd - uvd_p).abs().max())
        print(f"{engine} {dtype} stage {s + 1}: uvd gap kernels vs plain {gap:.3e}"
              + (f", the plain engine's own bf16-vs-f32 gap {own[s]:.3e}" if dt == torch.bfloat16 else ""))
        assert gap <= bound, (s, gap)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(3, 16, 16, 128), (2, 24, 40, 24), (5, 32, 32, 64)])
def test_normrelu_backward_kernel_matches_plain_version(device, shape, dtype):
    """K5 vs its plain version: channel 0 at scale = bias = 0 gives exact
    zero gradients; dx within 1 bf16 ulp of the output's scale, or in f32
    within 1e-5 of it (the same arithmetic, the means summed in another
    order), dscale and dbias
    rtol 1e-4 atol 1e-2 (sums over the batch in another order). The shapes
    take a batch that fills no tile, 24 channels (a block of 3 channel
    groups), and pixels past one 512-pixel chunk, ragged (960) and not."""
    dt = getattr(torch, dtype)
    rng = np.random.RandomState(60)
    b, h, w, c = shape

    def put(a, dtype_=torch.float32):
        return torch.from_numpy(a.astype(np.float32)).to(device, dtype_)

    x, g = put(rng.randn(b, h, w, c) + 0.3, dt), put(rng.randn(b, h, w, c), dt)
    scale, bias = put(1.0 + 0.2 * rng.randn(c)), put(0.1 * rng.randn(c))
    scale[0] = bias[0] = 0.0
    mean, inv = tnr.norm_relu_stats(x)
    before = tcn.LAUNCHES
    dx, ds, db = tcn.normrelu_bwd(g, x, mean, inv, scale, bias)
    torch.cuda.synchronize()
    assert tcn.LAUNCHES == before + 1
    want = tnr.normrelu_bwd_plain(g, x, mean, inv, scale, bias)
    assert dx.dtype == dt and torch.isfinite(dx.float()).all()
    assert float(dx[..., 0].abs().max()) == 0.0 and float(ds[0]) == 0.0 and float(db[0]) == 0.0
    if dt == torch.bfloat16:
        assert _bf16_ulps(dx, want[0]) <= 1.0
    else:
        torch.testing.assert_close(dx, want[0], rtol=0, atol=1e-5 * float(want[0].abs().max()))
    torch.testing.assert_close(ds, want[1], rtol=1e-4, atol=1e-2)
    torch.testing.assert_close(db, want[2], rtol=1e-4, atol=1e-2)


def test_norm_relu_cuda_backward_launches_k5(device):
    """Autograd through ``norm_relu_cuda`` on the card: one K5 launch per
    backward, the gradients of the plain ``norm_relu``."""
    rng = np.random.RandomState(61)
    x0 = torch.from_numpy(rng.randn(2, 8, 8, 32).astype(np.float32)).to(device, torch.bfloat16)
    r = torch.from_numpy(rng.randn(2, 8, 8, 32).astype(np.float32)).to(device, torch.bfloat16)

    def grads(fn):
        leaves = [x0.clone().requires_grad_(True), torch.ones(32, device=device, requires_grad=True),
                  torch.zeros(32, device=device, requires_grad=True)]
        return torch.autograd.grad(fn(*leaves), leaves, r)

    before = tcn.LAUNCHES
    got = grads(tcn.norm_relu_cuda)
    assert tcn.LAUNCHES == before + 1
    want = grads(tnr.norm_relu)
    assert _bf16_ulps(got[0], want[0]) <= 1.0
    for a, b in zip(got[1:], want[1:]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-2)


# (B, H, W, C) of build_xm's cases: 14x10 maps (W not a power of two); C =
# 8 (one 16-byte chunk a column block in bf16); the head shape, 64x64x128;
# 21x13x40, whose last row tile ends mid-sample; C = 704, rows of more
# chunks than the block has threads
BUILD_XM_SHAPES = {"14x10": (3, 14, 10, 24), "c8": (3, 14, 10, 8), "head": (2, 64, 64, 128),
                   "tile_mid_sample": (2, 21, 13, 40), "wide": (1, 6, 5, 704)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", tap.XM_MODES)
@pytest.mark.parametrize("shape", list(BUILD_XM_SHAPES))
def test_build_xm_kernel_is_exact(device, mode, dtype, shape):
    """The tap operand and its probes on the card, bit-exact against the
    plain version, at each of BUILD_XM_SHAPES."""
    dt = getattr(torch, dtype)
    b, h, w, c = BUILD_XM_SHAPES[shape]
    x = torch.from_numpy(np.random.RandomState(62).randn(b, h * w, c).astype(np.float32))
    x = x.to(device, dt)
    before = tap.BUILD_LAUNCHES
    got = tap.build_xm(x, h, w, mode)
    torch.cuda.synchronize()
    assert tap.BUILD_LAUNCHES == before + 1
    want = tap.build_xm_plain(x, h, w, mode)
    assert got.shape == want.shape and torch.equal(got.view(torch.int16 if dt == torch.bfloat16
                                                             else torch.int32),
                                                    want.view(torch.int16 if dt == torch.bfloat16
                                                              else torch.int32))


def test_copy_kernel_is_exact(device):
    x = torch.randn(3, 1000, 24, device=device).to(torch.bfloat16)
    before = tap.COPY_LAUNCHES
    y = tap.copy(x)
    torch.cuda.synchronize()
    assert tap.COPY_LAUNCHES == before + 1 and torch.equal(y.view(torch.int16), x.view(torch.int16))


# (layout, B, H, W, K per tap, Co): M off the 256-pixel tile and tiles
# that span two samples (H*W not a multiple of 256) throughout; K per tap of
# 8, 72 and 384, so that a 64-deep K step ends mid-step or straddles two
# taps; Co of 8, 72, 128 and 200 (64- and 128-column tiles, a partial last
# one); both offset layouts; one head-sized grid
XM_DOTS_CASES = {
    "taps": ("taps", 3, 12, 10, 72, 72),
    "repeat": ("repeat", 3, 12, 10, 72, 72),
    "k8-co8-taps": ("taps", 3, 12, 10, 8, 8),
    "k8-co128-repeat": ("repeat", 3, 7, 9, 8, 128),
    "k72-co200-taps": ("taps", 5, 9, 13, 72, 200),
    "k384-co72-taps": ("taps", 2, 12, 10, 384, 72),
    "k384-co200-repeat": ("repeat", 2, 12, 10, 384, 200),
    "head": ("taps", 4, 64, 64, 384, 128),
}


@pytest.mark.parametrize("case", list(XM_DOTS_CASES))
def test_xm_dots_kernel_matches_plain_version(device, case):
    """The products on a prebuilt operand, bf16, within 2 bf16 ulps of the
    output's scale of the plain version's f32 products."""
    layout, b, h, w, k, co = XM_DOTS_CASES[case]
    rng = np.random.RandomState(63)
    rows, offsets = ((h + 2) * w, (0, w, 2 * w)) if layout == "taps" else (h * w, (0, 0, 0))
    xm = torch.from_numpy(rng.randn(b, rows, k).astype(np.float32)).to(device, torch.bfloat16)
    wcat = torch.from_numpy((0.1 * rng.randn(3, k, co)).astype(np.float32)).to(device, torch.bfloat16)
    before = tap.DOTS_LAUNCHES
    got = tap.xm_dots(xm, wcat, h * w, offsets)
    torch.cuda.synchronize()
    assert tap.DOTS_LAUNCHES == before + 1
    assert got.shape == (b, h * w, co)
    assert _bf16_ulps(got, tap.xm_dots_plain(xm, wcat, h * w, offsets)) <= 2.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norm_stats_apply_matches_plain_version(device, dtype):
    """K3's statistics and apply alone: f32 within 1e-4 of the scale, bf16
    within 2 bf16 ulps of it (K3's own bounds)."""
    dt = getattr(torch, dtype)
    rng = np.random.RandomState(64)
    x = torch.from_numpy((rng.randn(3, 200, 40) + 2).astype(np.float32)).to(device, dt)
    s = torch.from_numpy((1 + 0.1 * rng.randn(40)).astype(np.float32)).to(device)
    b = torch.from_numpy((0.1 * rng.randn(40)).astype(np.float32)).to(device)
    before = tap.STATS_LAUNCHES
    got = tap.norm_stats_apply(x, s, b)
    torch.cuda.synchronize()
    assert tap.STATS_LAUNCHES == before + 1
    want = tap.norm_stats_apply_plain(x, s, b)
    if dt == torch.float32:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * float(want.abs().max()))
    else:
        assert _bf16_ulps(got, want) <= 2.0


def test_normrelu_and_ablate_wrappers_reject_what_the_kernels_do_not_take(device):
    x = torch.randn(2, 8, 8, 16, device=device)
    stat = torch.zeros(2, 16, device=device)
    p = torch.ones(16, device=device)
    with pytest.raises(ValueError, match="multiple of 8"):
        tcn.normrelu_bwd(x[..., :12].contiguous(), x[..., :12].contiguous(), stat[:, :12],
                         stat[:, :12], p[:12], p[:12])
    with pytest.raises(TypeError):
        tcn.normrelu_bwd(x.half(), x.half(), stat, stat, p, p)
    with pytest.raises(ValueError, match="contiguous"):
        tcn.normrelu_bwd(x.transpose(1, 2), x.transpose(1, 2), stat, stat, p, p)
    with pytest.raises(ValueError):
        tcn.normrelu_bwd(x, x, stat.cpu(), stat, p, p)
    flat = x.reshape(2, 64, 16)
    with pytest.raises(TypeError):
        tap.xm_dots(flat.repeat(1, 1, 3), torch.zeros(3, 48, 8, device=device), 64, (0, 0, 0))
    with pytest.raises(ValueError, match="multiple of 8"):
        tap.build_xm(flat[..., :12].contiguous(), 8, 8)
    with pytest.raises(ValueError, match="multiple of 16"):
        tap.copy(torch.zeros(3, device=device, dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        tap.norm_stats_apply(flat, p.cpu(), p)


# --------------------------------------------------------------------------- #
# The norm kernels on one thread-block cluster a sample: K3's statistics
# and apply (csrc/fused_chain.cu norm_kernel) and K5 (csrc/normrelu_bwd.cu)
# --------------------------------------------------------------------------- #

# [B, HW, C], dtype, and the plan the launcher picks for K3's statistics
# and apply: (blocks a sample, path). Samples of at most 64 KB a block stay
# resident with three blocks an SM (clusters of 1 to 16), up to 128 KB a
# block with one; larger ones stream
NORM_CASES = {
    "c1": ((4, 256, 64), "bfloat16", (1, "resident")),
    "c2": ((2, 256, 256), "bfloat16", (2, "resident")),
    "c4": ((2, 1024, 128), "bfloat16", (4, "resident")),
    "c8": ((2, 4096, 64), "bfloat16", (8, "resident")),
    "c16": ((2, 4096, 128), "bfloat16", (16, "resident")),
    "c16_128k": ((2, 4096, 128), "float32", (16, "resident")),
    "streamed": ((2, 16384, 64), "float32", (16, "streamed")),
    # 1001 pixels: slices of 251, the last one 248, pieces of 64 and a rest
    "ragged": ((3, 1001, 128), "bfloat16", (4, "resident")),
    "ch8": ((3, 4096, 8), "bfloat16", (1, "resident")),
    "ch256": ((2, 1024, 256), "bfloat16", (8, "resident")),
    # more channels than a block's 16-byte vectors: two chunks of 1024
    "ch2048": ((2, 16, 2048), "float32", (2, "resident")),
}


def _norm_inputs(device, shape, dt, seed):
    """x [B, HW, C] around 2 with channel 0 constant (a variance of 0), and
    the norm's scale and bias."""
    rng = np.random.RandomState(seed)
    b, hw, c = shape
    x = rng.randn(b, hw, c) + 2.0
    x[..., 0] = 0.75
    put = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)  # noqa: E731
    return put(x).to(dt), put(1.0 + 0.1 * rng.randn(c)), put(0.1 * rng.randn(c))


@pytest.mark.parametrize("case", list(NORM_CASES))
def test_norm_stats_apply_on_a_cluster_matches_plain_version(device, case):
    """K3's statistics and apply on each plan the launcher picks (clusters
    of 1 to 16 blocks, resident and streamed, a ragged last slice, 8 to
    2048 channels): bf16 within 2 ulps of the scale, f32 within 1e-4 of
    it, a constant channel included; two calls bit-identical."""
    shape, dtype, (cluster, path) = NORM_CASES[case]
    dt = getattr(torch, dtype)
    plan = tfused.norm_plan(dt, *shape)
    assert (plan["cluster"], plan["path"]) == (cluster, path), plan
    x, s, b = _norm_inputs(device, shape, dt, 70)
    before = tfused.norm_launches()
    got = tap.norm_stats_apply(x, s, b)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(tfused.norm_launches(), before)) == (1, 0)
    again = tap.norm_stats_apply(x, s, b)
    torch.cuda.synchronize()
    want = tap.norm_stats_apply_plain(x, s, b)
    assert torch.equal(got, again)
    assert torch.isfinite(got.float()).all()
    if dt == torch.float32:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * float(want.abs().max()))
    else:
        assert _bf16_ulps(got, want) <= 2.0


def test_norm_stats_apply_f32_far_from_zero_matches_float64(device):
    """A channel of mean 1e3 and standard deviation 1 in f32, against the
    norm computed in float64: within 1e-4 of the output's scale (the
    two-pass variance does not cancel)."""
    rng = np.random.RandomState(71)
    x64 = rng.randn(2, 4096, 128)
    x64[..., 1] += 1e3
    x = torch.from_numpy(x64.astype(np.float32)).to(device)
    s = torch.ones(128, device=device)
    b = torch.zeros(128, device=device)
    got = tap.norm_stats_apply(x, s, b).double().cpu()
    xd = x.double().cpu()
    mean = xd.mean(dim=1, keepdim=True)
    var = ((xd - mean) ** 2).mean(dim=1, keepdim=True)
    want = torch.clamp_min((xd - mean) / torch.sqrt(var + 1e-5), 0.0)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * float(want.abs().max()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_chain_unit_on_clusters_matches_plain_version(device, dtype):
    """A K3 unit whose prologue statistics and epilogue (statistics, apply
    and skip, one launch) run on clusters of 16 blocks: 1x1 128 -> 128 at
    [2, 64, 64, 128], within K3's bounds of its plain version."""
    dt = getattr(torch, dtype)
    rng = np.random.RandomState(72)
    x = torch.from_numpy((1.0 + rng.randn(2, 64, 64, 128)).astype(np.float32)).to(device, dt)
    skip = torch.from_numpy(rng.randn(2, 64, 64, 128).astype(np.float32)).to(device, dt)
    units = _units([(1, 128, 128, True, True)], 73, device)
    assert tfused.norm_plan(dt, 2, 64 * 64, 128)["cluster"] == 16
    before = tfused.norm_launches()
    got = tfused.fused_chain(x, units, skip=skip)
    torch.cuda.synchronize()
    # the prologue's statistics, the conv, the epilogue's statistics and apply
    assert tuple(a - b for a, b in zip(tfused.norm_launches(), before)) == (2, 1)
    want = tfused.fused_chain_plain(x, units, skip=skip)
    if dt == torch.float32:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * float(want.abs().max()))
    else:
        assert _bf16_ulps(got, want) <= 2.0


# (B, H, W, C), dtype and K5's plan: (blocks a sample, path); mixed: x
# resident beside a ring of g
NORMRELU_CASES = {
    "c1": ((2, 16, 16, 64), "bfloat16", (1, "resident")),
    "c8": ((2, 32, 32, 128), "bfloat16", (8, "resident")),
    "mixed8": ((2, 64, 64, 128), "bfloat16", (8, "mixed")),
    "mixed16": ((2, 64, 64, 128), "float32", (16, "mixed")),
    "streamed": ((2, 128, 128, 64), "float32", (16, "streamed")),
    "ragged": ((2, 33, 31, 64), "bfloat16", (4, "resident")),
    "ch8": ((2, 64, 64, 8), "bfloat16", (2, "resident")),
    "ch256": ((2, 32, 32, 256), "bfloat16", (16, "resident")),
    "ch2048": ((2, 4, 4, 2048), "bfloat16", (2, "resident")),
    "ch2048_f32": ((2, 4, 4, 2048), "float32", (4, "resident")),
}


@pytest.mark.parametrize("case", list(NORMRELU_CASES))
def test_normrelu_backward_on_a_cluster_matches_plain_version(device, case):
    """K5 on each plan the launcher picks: dx within 1 bf16 ulp of its
    scale (f32: 1e-5 of it), dscale and dbias rtol 1e-4 atol 1e-2, channel
    0 at scale = bias = 0 exactly 0; two calls bit-identical."""
    shape, dtype, (cluster, path) = NORMRELU_CASES[case]
    dt = getattr(torch, dtype)
    b, h, w, c = shape
    plan = tcn.plan(dt, b, h * w, c)
    assert (plan["cluster"], plan["path"]) == (cluster, path), plan
    rng = np.random.RandomState(74)
    put = lambda a, d=torch.float32: torch.from_numpy(a.astype(np.float32)).to(device, d)  # noqa: E731
    x, g = put(rng.randn(*shape) + 0.3, dt), put(rng.randn(*shape), dt)
    scale, bias = put(1.0 + 0.2 * rng.randn(c)), put(0.1 * rng.randn(c))
    scale[0] = bias[0] = 0.0
    mean, inv = tnr.norm_relu_stats(x)
    before = tfused.norm_launches()
    got = tcn.normrelu_bwd(g, x, mean, inv, scale, bias)
    torch.cuda.synchronize()
    # two kernels a call: the cluster kernel and the per-channel sums
    assert tuple(a - b for a, b in zip(tfused.norm_launches(), before)) == (1, 1)
    again = tcn.normrelu_bwd(g, x, mean, inv, scale, bias)
    torch.cuda.synchronize()
    assert all(torch.equal(u, v) for u, v in zip(got, again))
    want = tnr.normrelu_bwd_plain(g, x, mean, inv, scale, bias)
    dx, ds, db = got
    assert float(dx[..., 0].abs().max()) == 0.0 and float(ds[0]) == 0.0 and float(db[0]) == 0.0
    if dt == torch.bfloat16:
        assert _bf16_ulps(dx, want[0]) <= 1.0
    else:
        torch.testing.assert_close(dx, want[0], rtol=0, atol=1e-5 * float(want[0].abs().max()))
    torch.testing.assert_close(ds, want[1], rtol=1e-4, atol=1e-2)
    torch.testing.assert_close(db, want[2], rtol=1e-4, atol=1e-2)


# --------------------------------------------------------------------------- #
# the CLI path: raw files -> Loader -> pinned memory -> train/test CLIs
# --------------------------------------------------------------------------- #

_MSRA_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                             "make_msra_fixture.py")
_CLI_SMALL = ["--features", "16", "--level", "2", "--label_size", "32", "--batch_size", "16",
              "--num_workers", "2"]


@pytest.fixture(scope="module")
def msra_root(tmp_path_factory):
    """The synthetic MSRA fixture (9 subjects x 4 frames) with its index built."""
    root = str(tmp_path_factory.mktemp("msra"))
    subprocess.run([sys.executable, _MSRA_FIXTURE, root], check=True, capture_output=True)
    get_source("MSRA", path=root, dataset="train", subject=0)
    return root


def test_loader_batches_reach_the_card_through_pinned_memory(device, msra_root):
    """Every field of a Loader batch arrives on the card unchanged (values,
    dtypes, shapes) through to_device's pinned, non-blocking copies."""
    src = get_source("MSRA", path=msra_root, dataset="train", subject=0)
    for batch in Loader(src, 8, shuffle=True, seed=3, num_workers=2):
        got = to_device(batch, device)
        torch.cuda.synchronize()
        assert got.keys() == batch.keys()
        for k, v in batch.items():
            assert got[k].device == device and got[k].shape == v.shape, k
            assert torch.equal(got[k].cpu(), torch.from_numpy(np.asarray(v))), k


def _train_cli(msra_root, workdir, monkeypatch, *argv):
    monkeypatch.chdir(workdir)
    # the image logging's forward would launch K1 outside the counted steps
    monkeypatch.setenv("PWR_TB_IMAGES", "0")
    args = make_train_parser(msra=True).parse_args(
        ["--subject", "0", "--seed", "1", "--data_path", msra_root, *_CLI_SMALL, *argv])
    return run_training(args, "MSRA", subject=0)


def test_train_cli_runs_through_k1_and_k2(device, msra_root, tmp_path, monkeypatch):
    """run_training on the card, two epochs of two steps at batch 16 (bf16,
    decoder cuda): K1 once a stage a train step and a val batch, K2 once a
    stage a train step in one kernel; the saved .pt has calibrated anchors
    and finite params."""
    before = (tcuda.LAUNCHES, tcuda.BWD_LAUNCHES, tcuda.BWD_KERNEL_LAUNCHES)
    best_epoch, best_err = _train_cli(msra_root, tmp_path, monkeypatch, "--epoch", "2",
                                      "--mixed_precision", "--decoder", "cuda")
    torch.cuda.synchronize()
    steps, val_batches, stages = 2 * 2, 2 * 1, 2
    assert (tcuda.LAUNCHES - before[0], tcuda.BWD_LAUNCHES - before[1],
            tcuda.BWD_KERNEL_LAUNCHES - before[2]) == \
        (stages * (steps + val_batches), stages * steps, stages * steps)
    assert np.isfinite(best_err)
    ckpt = torch.load(tmp_path / "Model" / "MSRA_default_subject0_final.pt", weights_only=True)
    assert ckpt["step"] == 2 * (best_epoch + 1) and ckpt["optimizer"]["state"]
    anchors = [v for k, v in ckpt["state_dict"].items() if k.endswith("anchor_n")]
    assert anchors and all(float(a) == ckpt["step"] for a in anchors)
    assert all(torch.isfinite(v).all() for v in ckpt["state_dict"].values())


def test_test_cli_kernel_decoder_matches_the_plain_decoder(device, msra_root, tmp_path,
                                                            monkeypatch):
    """The f32 test CLI on one trained checkpoint with --decoder cuda (K1
    once a stage a batch) and --decoder torch: Result files within 1e-2
    (pixels for u and v, mm for d; chip_smoke.py's phase_cli bound), finite,
    one row of 63 values a test frame."""
    _train_cli(msra_root, tmp_path, monkeypatch, "--epoch", "1")
    results = {}
    for decoder in ("cuda", "torch"):
        args = make_test_parser(msra=True).parse_args(
            ["--subject", "0", "--data_path", msra_root, "--decoder", decoder, *_CLI_SMALL])
        before = tcuda.LAUNCHES
        name, _ = run_inference(args, "MSRA", subject=0)
        torch.cuda.synchronize()
        assert tcuda.LAUNCHES - before == (2 if decoder == "cuda" else 0)
        results[decoder] = np.loadtxt(tmp_path / name)
    assert results["cuda"].shape == results["torch"].shape == (4, 63)
    assert np.isfinite(results["cuda"]).all()
    np.testing.assert_allclose(results["cuda"], results["torch"], rtol=0, atol=1e-2)


# --------------------------------------------------------------------------- #
# the paired heads, FullRegression, multi-process and data-parallel serving
# --------------------------------------------------------------------------- #


def _calibrated_state(model, device, b=2, side=32):
    """``model``'s state after one train-mode forward (anchors calibrated)."""
    g = torch.Generator(device="cpu").manual_seed(5)
    xs = [torch.rand(b, 1, s, s, generator=g) for s in (2 * side, side, side)]
    with torch.no_grad():
        model.train()(*xs)
    return model.eval().state_dict(), [x.to(device) for x in xs]


@pytest.mark.parametrize("mid,final", [("separate", "blockdiag"), ("grouped", "blockdiag"),
                                       ("grouped", "separate"), ("separate", "separate")])
def test_paired_heads_on_the_card_match_the_plain_heads(device, mid, final):
    """f32, instance_anchored (calibrated), two stages: the paired model's
    uvd within 1e-4 of the uvd scale of the plain model's on the card, K1
    once a stage for each forward."""
    torch.manual_seed(3)
    kw = dict(stage=2, features=32, level=2, norm_method="instance_anchored", decoder="cuda")
    state, xs = _calibrated_state(PixelwiseRegression(14, **kw), device)
    plain = PixelwiseRegression(14, **kw).to(device)
    plain.load_state_dict(state)
    paired = PixelwiseRegression(14, paired_heads=True, paired_mid=mid, paired_final=final,
                                 **kw).to(device)
    paired.load_state_dict(state)
    assert all(b.use_paired() for b in paired.eval().stages)
    with torch.no_grad():
        want = plain.eval()(*xs)[-1][2]
        before = tcuda.LAUNCHES
        got = paired(*xs)[-1][2]
        torch.cuda.synchronize()
    assert tcuda.LAUNCHES - before == 2
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-4 * scale


@pytest.mark.parametrize("norm", ["instance_anchored", "batch"])
def test_fullregression_on_the_card_matches_the_cpu(device, norm):
    """f32 FullRegression (two stages, label_size 32): per stage uvd on the
    card within 1e-4 of the CPU's scale; no kernel is launched (the family
    has no decoder)."""
    torch.manual_seed(4)
    from pixelwiseregression_tpu_torch.models.fullregression import FullRegression

    model = FullRegression(14, stage=2, label_size=32, features=16, norm_method=norm)
    state, xs = _calibrated_state(model, "cpu")
    card = FullRegression(14, stage=2, label_size=32, features=16, norm_method=norm).to(device)
    card.load_state_dict(state)
    with torch.no_grad():
        want = model.eval()(*xs)
        before = tcuda.LAUNCHES
        got = card.eval()(*(x.to(device) for x in xs))
        torch.cuda.synchronize()
    assert tcuda.LAUNCHES == before
    for g, w in zip(got, want):
        assert float((g.cpu() - w).abs().max()) <= 1e-4 * float(w.abs().max())


def test_data_parallel_predictor_on_the_visible_cards(device):
    """``Predictor(data_parallel=True)`` with no ``devices``: one replica a
    visible card; the uvd equals a single card Predictor's within 1e-4 px/mm
    and K1 runs once a stage a replica."""
    torch.manual_seed(0)
    state = PixelwiseRegression(21, stage=1, features=16, level=1).state_dict()
    arch = dict(stages=1, features=16, level=1, label_size=32)
    n = torch.cuda.device_count()
    single = Predictor.from_state_dict(state, "MSRA", device, batch_size=2 * n, **arch)
    dp = Predictor.from_state_dict(state, "MSRA", device, batch_size=2 * n,
                                   data_parallel=True, **arch)
    assert [d for d, _ in dp.replicas] == [torch.device("cuda", i) for i in range(n)]
    raw = make_synthetic_raw_batch(2 * n, 240, 320, 21, fx=241.42, fy=241.42, cube=150.0,
                                   com_z=400.0, seed=3)
    want = single.predict(raw["frame"], raw["com"])["uvd"]
    before = tcuda.LAUNCHES
    got = dp.predict(raw["frame"], raw["com"])["uvd"]
    assert tcuda.LAUNCHES - before == n
    assert np.abs(got - want).max() <= 1e-4


def test_two_ranks_on_one_card_through_gloo(device, tmp_path):
    """Two ranks of tests/torch_port_ddp_worker.py on this card with gloo
    (NCCL refuses two ranks on one GPU): one PixelwiseRegression train
    step each, K1 and K2 once a stage in each rank, both ranks' states
    equal."""
    import socket

    torch.manual_seed(1)
    kw = dict(joints=14, stage=2, features=16, level=2, norm_method="batch", decoder="cuda")
    raw = make_synthetic_raw_batch(4, 480, 640, 14, fx=588.03, fy=587.07, cube=150.0,
                                   com_z=450.0, seed=2)
    cam = dict(fx=588.03, fy=587.07, halfu=320.0, halfv=240.0)
    case = {"kind": "pixelwise", "model": kw, "state": PixelwiseRegression(**kw).state_dict(),
            "batch": {k: torch.from_numpy(v) for k, v in raw.items()},
            "cfg": dict(cam, image_size=64, label_size=32, using_rotation=True),
            "eval_cfg": dict(cam, image_size=64, label_size=32), "camera": cam,
            "loss": dict(lambda_h=1.0, lambda_d=0.01, alpha=1.0)}
    path = str(tmp_path / "cases.pt")
    torch.save({"cases": [case], "seed": 7}, path)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    worker = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_port_ddp_worker.py")
    procs = [subprocess.Popen([sys.executable, worker, path, str(tmp_path / f"o{r}.pt"), str(r),
                               "2", str(port), "cuda", "gloo"], stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=300)
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    outs = [torch.load(tmp_path / f"o{r}.pt", weights_only=False)["results"][0] for r in range(2)]
    for out in outs:
        assert out["launches"] == {"K1": 2, "K2": 2}
        assert np.isfinite(float(out["train"]["loss"]))
    for name, t in outs[0]["state"].items():
        assert torch.equal(t, outs[1]["state"][name]), name


def _box_request(n, seed):
    """``n`` frames of the benchmark's HANDS 2017 scene with their boxes."""
    from port_bench import scene
    spec = SPECS["HAND17"]
    return scene.frames_and_boxes(n, spec.frame_h, spec.frame_w, fx=spec.camera.fx,
                                  fy=spec.camera.fy, seed=seed)


def test_box_localisation_on_the_card_equals_the_cpu(device):
    """``ops.localize`` on a whole request (32 frames of the benchmark's
    scene, 480x640): the card's cleaned frames, centres and crop integers
    equal the CPU's float64 path (its sums are exact, so their order does
    not matter), which the CPU tests hold against the host's
    ``_load_raw_bb`` and ``make_record``."""
    from pixelwiseregression_tpu_torch.ops import localize as loc
    spec = SPECS["HAND17"]
    req = _box_request(32, 2**31 + 41)
    frames = torch.from_numpy(req["frame"])
    bounds = torch.from_numpy(loc.box_bounds(req["box"], spec.frame_h, spec.frame_w))
    cube = torch.full((32,), spec.cube_size, dtype=torch.float64)
    want, want_com, want_empty = loc.localize(frames, bounds, cube, spec.camera)
    got, com, empty = loc.localize(frames.to(device), bounds.to(device), cube.to(device),
                                   spec.camera)
    assert not want_empty.any() and torch.equal(empty.cpu(), want_empty)
    torch.testing.assert_close(com.cpu(), want_com, rtol=1e-9, atol=0)
    for k in ("frame", "com_int", "bbox", "crop_top", "crop_left", "box_size", "cube"):
        assert torch.equal(got[k].cpu(), want[k]), k


def test_a_box_request_queues_without_a_sync_up_to_the_gather(device, monkeypatch):
    """A full-width HAND17 Predictor (J=21, f32): a request with boxes runs
    under ``torch.cuda.set_sync_debug_mode("error")`` from its batch's copy
    to the card to the gather of the answers (the localisation, the crop
    integers, the preprocess, the forward and K1, queued with no sync),
    counts its frames, and answers as on the second card call."""
    from pixelwiseregression_tpu_torch import serve
    from pixelwiseregression_tpu_torch.ops import localize as loc
    torch.manual_seed(3)
    state = PixelwiseRegression(21, stage=2, features=128, level=4).state_dict()
    pred = Predictor.from_state_dict(state, "HAND17", device, batch_size=32)
    req = _box_request(32, 2**31 + 43)
    want = pred.predict(req["frame"], boxes=req["box"])
    copy, span = serve._device_batch, serve.obs.span

    def strict(batch, d):
        out = copy(batch, d)
        torch.cuda.set_sync_debug_mode("error")
        return out

    def loose(name):
        if name == "serve.wait":
            torch.cuda.set_sync_debug_mode("default")
        return span(name)

    monkeypatch.setattr(serve, "_device_batch", strict)
    monkeypatch.setattr(serve.obs, "span", loose)
    before, k1 = loc.LOCALIZED, tcuda.LAUNCHES
    try:
        got = pred.predict(req["frame"], boxes=req["box"])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert loc.LOCALIZED - before == 32 and tcuda.LAUNCHES - k1 == 2
    np.testing.assert_array_equal(got["com"], want["com"])
    np.testing.assert_allclose(got["uvd"], want["uvd"], rtol=0, atol=1e-3)


# --------------------------------------------------------------------------- #
# the heads' f32 3x3 conv (csrc/conv3x3_f32.cu)
# --------------------------------------------------------------------------- #


def _conv_inputs(device, b, seed):
    """x [b, 128, 64, 64] normal, a xavier-normal weight (the model's
    init) and a bias of 0.1 * normal, from ``seed``."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(b, 128, 64, 64, generator=g, device=device)
    w = torch.randn(128, 128, 3, 3, generator=g, device=device) * (2.0 / (2 * 9 * 128)) ** 0.5
    return x, w, 0.1 * torch.randn(128, generator=g, device=device)


def _cudnn_f32(benchmark=False, deterministic=False):
    return torch.backends.cudnn.flags(enabled=True, benchmark=benchmark,
                                      deterministic=deterministic, allow_tf32=False)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("b", [128, 32])
def test_conv3x3_is_no_further_from_float64_than_cudnn(device, b, seed):
    """At the heads' shape, [b, 128, 64, 64] 128 -> 128, the kernel's
    largest error to a float64 conv of the same inputs is no larger than
    F.conv2d's in f32 with TF32 off (cuDNN's own pick, the port's conv
    before the kernel): the same f32 work, not less precision. One launch a
    call."""
    x, w, bias = _conv_inputs(device, b, seed)
    want = torch.nn.functional.conv2d(x.double(), w.double(), bias.double(), 1, 1)
    before = tconv.LAUNCHES
    got = tconv.conv3x3_f32(x, w, bias)
    torch.cuda.synchronize()
    assert tconv.LAUNCHES == before + 1
    with _cudnn_f32():
        lib = torch.nn.functional.conv2d(x, w, bias, 1, 1)
    err = float((got.double() - want).abs().max())
    assert err <= float((lib.double() - want).abs().max()), err


def test_conv3x3_calls_are_bit_identical(device):
    """Two calls on the same inputs give the same bits (one fixed order of
    sums, no atomics)."""
    x, w, bias = _conv_inputs(device, 32, 3)
    assert torch.equal(tconv.conv3x3_f32(x, w, bias), tconv.conv3x3_f32(x, w, bias))


def test_conv3x3_gradients_are_f_conv2d_autograd_bit_for_bit(device):
    """dx, dw and db through the operator equal F.conv2d's autograd bit for
    bit, given the same grad_out: its backward is ATen's
    convolution_backward with autograd's arguments. cuDNN in deterministic
    mode on both sides, so that its weight gradient, whose default
    algorithm sums with atomics, is one value."""
    x, w, bias = _conv_inputs(device, 8, 4)
    leaves = [t.clone().requires_grad_(True) for t in (x, w, bias)]
    g = torch.randn(8, 128, 64, 64, generator=torch.Generator(device=device).manual_seed(5),
                    device=device)
    with _cudnn_f32(deterministic=True):
        got = torch.autograd.grad(tconv.conv3x3_f32(*leaves), leaves, g)
        want = torch.autograd.grad(torch.nn.functional.conv2d(*leaves, 1, 1), leaves, g)
    for name, a, b in zip(("dx", "dw", "db"), got, want):
        assert torch.equal(a, b), name


def test_conv3x3_wrapper_rejects_what_the_kernel_does_not_take(device):
    """Shapes and dtypes outside the kernel raise on the card; a mixed-device
    call raises."""
    x, w, bias = _conv_inputs(device, 2, 6)
    with pytest.raises(ValueError, match="multiples"):
        tconv.conv3x3_f32(x[:, :, :, :32].contiguous(), w, bias)
    with pytest.raises(ValueError, match="multiples"):
        tconv.conv3x3_f32(x[:, :64].contiguous(), w[:, :64].contiguous(), bias)
    with pytest.raises(TypeError, match="f32"):
        tconv.conv3x3_f32(x.double(), w.double(), bias.double())
    with pytest.raises(ValueError, match="one device"):
        tconv.conv3x3_f32(x, w.cpu(), bias)


def _full_width_step(device, cls, seed):
    """One f32 train step of a full-width NYU model (two stages, 128
    features, 128/64 crops) at batch 2 on a raw batch; the conv's launches."""
    from pixelwiseregression_tpu_torch.models.fullregression import FullRegression
    from pixelwiseregression_tpu_torch.train.loop import make_train_step_fullreg

    spec = SPECS["NYU"]
    torch.manual_seed(seed)
    if cls == "pixelwise":
        model = PixelwiseRegression(14, stage=2, features=128, level=4,
                                    norm_method="instance_anchored", decoder="cuda")
    else:
        model = FullRegression(14, stage=2, label_size=64, features=128,
                               norm_method="instance_anchored")
    state = create_train_state(model.to(device), lr=1e-3, steps_per_epoch=568)
    cfg = PreprocessConfig(fx=spec.camera.fx, fy=spec.camera.fy, halfu=spec.camera.halfu,
                           halfv=spec.camera.halfv, image_size=128, label_size=64,
                           using_rotation=True, using_scale=True, using_shift=True)
    step = (make_train_step(cfg, LossConfig(lambda_h=1.0, lambda_d=0.01, alpha=1.0))
            if cls == "pixelwise" else make_train_step_fullreg(cfg))
    raw = make_synthetic_raw_batch(2, 480, 640, 14, fx=spec.camera.fx, fy=spec.camera.fy,
                                   cube=150.0, com_z=450.0, seed=seed)
    batch = {k: torch.from_numpy(v).to(device) for k, v in raw.items()}
    before = tconv.LAUNCHES
    out = step(state, batch, draws=draw_augmentation(
        2, torch.Generator(device=device).manual_seed(seed), device))
    torch.cuda.synchronize()
    assert torch.isfinite(out["loss"])
    return tconv.LAUNCHES - before


@pytest.mark.parametrize("cls, launches", [("pixelwise", 12), ("fullreg", 0)])
def test_full_width_f32_train_step_launches_the_conv_for_the_heads(device, cls, launches):
    """A full-width f32 train step launches the conv 12 times, once for
    each of the three 128 -> 128 convs of each head of each stage (the
    backward runs cuDNN's); FullRegression, whose convs are stride 2, 1x1
    or 64 wide in channels, none."""
    assert _full_width_step(device, cls, 11) == launches


def test_full_width_f32_request_launches_the_conv_for_the_heads(device):
    """One request of 32 frames to the full-width f32 NYU Predictor
    launches the conv 12 times."""
    spec = SPECS["NYU"]
    torch.manual_seed(12)
    state = PixelwiseRegression(14, stage=2, features=128, level=4).state_dict()
    pred = Predictor.from_state_dict(state, "NYU", device, batch_size=32)
    raw = make_synthetic_raw_batch(32, 480, 640, 14, fx=spec.camera.fx, fy=spec.camera.fy,
                                   cube=150.0, com_z=450.0, seed=13)
    before = tconv.LAUNCHES
    got = pred.predict(raw["frame"], raw["com"])
    assert tconv.LAUNCHES == before + 12
    assert np.isfinite(got["uvd"]).all()


# --------------------------------------------------------------------------- #
# the Predictor's CUDA graphs of its serving function (serve.Graphed)
# --------------------------------------------------------------------------- #


def _graph_predictor(device, kind, features=128, level=4, **kw):
    """A full-width f32 Predictor (batch 32) of ``kind``: ``nyu`` (centres),
    ``hand17`` (boxes) or ``fullreg`` (NYU FullRegression), and its requests'
    maker ``request(pred, seed, n=32)`` -> the answer to ``n`` frames."""
    spec = SPECS["HAND17" if kind == "hand17" else "NYU"]
    torch.manual_seed(21)
    if kind == "fullreg":
        from pixelwiseregression_tpu_torch.models.fullregression import FullRegression
        state = FullRegression(spec.joint_number, stage=2, label_size=64, features=features,
                               level=level).state_dict()
        kw["fullregression"] = True
    else:
        state = PixelwiseRegression(spec.joint_number, stage=2, features=features,
                                    level=level).state_dict()
    pred = Predictor.from_state_dict(state, "HAND17" if kind == "hand17" else "NYU", device,
                                     batch_size=32, features=features, level=level, **kw)

    def request(p, seed, n=32):
        if kind == "hand17":
            req = _box_request(n, seed)
            return p.predict(req["frame"], boxes=req["box"])
        raw = make_synthetic_raw_batch(n, spec.frame_h, spec.frame_w, spec.joint_number,
                                       fx=spec.camera.fx, fy=spec.camera.fy,
                                       cube=spec.cube_size, com_z=450.0, seed=seed)
        return p.predict(raw["frame"], raw["com"])
    return pred, request


def _eager(pred):
    """A Predictor over ``pred``'s model whose first call, eager, is the
    only one it takes."""
    return Predictor(pred.model, pred.spec, pred.cfg, pred.batch_size, pred.device)


GRAPH_KINDS = {"nyu": (2, 12), "hand17": (2, 12), "fullreg": (0, 0)}  # K1, conv3x3 a request


@pytest.mark.parametrize("kind", list(GRAPH_KINDS))
def test_replayed_requests_equal_eager_answers_bit_for_bit(device, kind):
    """Five requests (sizes 32, 32, 7, 32, 32) to a full-width f32
    Predictor: the first runs eagerly, the second captures one graph and
    replays it, the rest replay; each answer equals an eager forward's
    on the same request bit for bit; every request, the first included,
    launches K1 ``stages`` times and the heads' conv 12 times (FullRegression:
    neither)."""
    from pixelwiseregression_tpu_torch import serve
    pred, request = _graph_predictor(device, kind)
    k1, convs = GRAPH_KINDS[kind]
    for i, n in enumerate((32, 32, 7, 32, 32)):
        counts = (tcuda.LAUNCHES, tconv.LAUNCHES, serve.GRAPH_CAPTURES, serve.GRAPH_REPLAYS)
        got = request(pred, 2**31 + 50 + i, n)
        torch.cuda.synchronize()
        moved = [a - b for a, b in zip((tcuda.LAUNCHES, tconv.LAUNCHES, serve.GRAPH_CAPTURES,
                                        serve.GRAPH_REPLAYS), counts)]
        assert moved == [k1, convs, int(i == 1), int(i >= 1)], (i, moved)
        want = request(_eager(pred), 2**31 + 50 + i, n)
        for key in ("uvd", "xyz", "com"):
            np.testing.assert_array_equal(got[key], want[key], err_msg=f"{key} request {i}")
    assert len(pred.forwards[0].graphs) == 1


def test_a_replayed_request_traces_its_kernels_by_name(device):
    """torch.profiler on one replayed request of the full-width f32 NYU
    Predictor: the trace holds K1 (``softargmax_fwd_kernel``) twice and the
    heads' conv (``conv3x3_f32_kernel``) 12 times, and no conv3x3 nor K1
    outside the replay."""
    pred, request = _graph_predictor(device, "nyu")
    for i in range(2):
        request(pred, 60 + i)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        request(pred, 62)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("softargmax_fwd_kernel" in n for n in names) == 2, sorted(set(names))[:40]
    assert sum("conv3x3_f32_kernel" in n for n in names) == 12, sorted(set(names))[:40]


def test_two_clients_race_through_the_capture(device):
    """Two threads, one sending box requests and one centre requests (one
    key: the same fields), start together on a fresh HAND17 Predictor, so
    that the eager calls, the capture and the replays interleave with the
    other client's copies, localisation and gathers: one capture, and each
    answer equals the eager forward's on that client's own request."""
    from pixelwiseregression_tpu_torch import serve
    spec = SPECS["HAND17"]
    pred, _ = _graph_predictor(device, "hand17", features=32, level=2)
    boxes = [_box_request(32, 2**31 + 70 + i) for i in range(4)]
    centres = [make_synthetic_raw_batch(32, spec.frame_h, spec.frame_w, spec.joint_number,
                                        fx=spec.camera.fx, fy=spec.camera.fy,
                                        cube=spec.cube_size, com_z=450.0, seed=80 + i)
               for i in range(4)]
    calls = {"box": lambda p, r: p.predict(r["frame"], boxes=r["box"]),
             "centre": lambda p, r: p.predict(r["frame"], r["com"])}
    reqs = {"box": boxes, "centre": centres}
    want = {c: [calls[c](_eager(pred), r)["uvd"] for r in reqs[c]] for c in calls}
    got = {c: [] for c in calls}
    errors = []
    start = threading.Barrier(2)
    captures = serve.GRAPH_CAPTURES

    def client(c):
        try:
            start.wait(60)
            for _ in range(2):
                for r in reqs[c]:
                    got[c].append(calls[c](pred, r)["uvd"])
        except Exception as e:  # noqa: BLE001 -- reported below
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(c,)) for c in calls]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    assert not errors, errors
    assert serve.GRAPH_CAPTURES - captures == 1
    for c in calls:
        for i, g in enumerate(got[c]):
            np.testing.assert_array_equal(g, want[c][i % 4], err_msg=f"{c} request {i}")


def test_a_replayed_request_queues_without_a_sync_up_to_the_gather(device, monkeypatch):
    """The full-width f32 NYU Predictor, its graph captured: a request runs
    under ``torch.cuda.set_sync_debug_mode("error")`` from its batch's copy
    to the card to the gather (the copy into the graph's inputs, the replay
    and the clone of the output queue with no sync)."""
    from pixelwiseregression_tpu_torch import serve
    pred, request = _graph_predictor(device, "nyu")
    want = [request(pred, 90 + i) for i in range(3)]
    copy, span = serve._device_batch, serve.obs.span

    def strict(batch, d):
        out = copy(batch, d)
        torch.cuda.set_sync_debug_mode("error")
        return out

    def loose(name):
        if name == "serve.wait":
            torch.cuda.set_sync_debug_mode("default")
        return span(name)

    monkeypatch.setattr(serve, "_device_batch", strict)
    monkeypatch.setattr(serve.obs, "span", loose)
    replays = serve.GRAPH_REPLAYS
    try:
        got = request(pred, 92)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert serve.GRAPH_REPLAYS - replays == 1
    np.testing.assert_array_equal(got["uvd"], want[2]["uvd"])


def test_a_dropped_predictor_frees_its_graphs(device):
    """Dropping a Predictor whose graph was captured gives back the graph's
    pool: the card's allocated bytes return to what they were before the
    Predictor was built."""
    import gc
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(device)
    pred, request = _graph_predictor(device, "nyu")
    for i in range(3):
        request(pred, 95 + i)
    torch.cuda.synchronize()
    assert len(pred.forwards[0].graphs) == 1
    assert torch.cuda.memory_allocated(device) > before
    del pred, request
    gc.collect()
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated(device) == before


@pytest.mark.parametrize("quant, calib", [("int8_static_all", 2), ("int8_all", 0)])
def test_an_int8_predictor_captures_after_its_calibration(device, quant, calib):
    """A bf16 batch-norm int8 Predictor (small widths): a static one
    calibrates eagerly on its first ``calib`` requests and captures nothing
    there; then, as any Predictor, one eager request, one capture and
    replays, each answer equal to an eager forward's bit for bit and each
    request counting its int8 products."""
    from pixelwiseregression_tpu_torch import serve
    from pixelwiseregression_tpu_torch.models import layers
    spec = SPECS["NYU"]
    torch.manual_seed(22)
    state = PixelwiseRegression(spec.joint_number, stage=2, features=32, level=2,
                                norm_method="batch").state_dict()
    pred = Predictor.from_state_dict(state, "NYU", device, batch_size=8, stages=2, features=32,
                                     level=2, norm_method="batch", dtype=torch.bfloat16,
                                     quant=quant, quant_calib_batches=calib)
    convs = sum(1 for m in pred.model.modules() if isinstance(m, layers.Conv) and m.quant)
    raws = [make_synthetic_raw_batch(8, spec.frame_h, spec.frame_w, spec.joint_number,
                                     fx=spec.camera.fx, fy=spec.camera.fy, cube=spec.cube_size,
                                     com_z=450.0, seed=100 + i) for i in range(calib + 4)]
    for i, raw in enumerate(raws):
        counts = (layers.INT_MM_CALLS, serve.GRAPH_CAPTURES, serve.GRAPH_REPLAYS)
        got = pred.predict(raw["frame"], raw["com"])["uvd"]
        torch.cuda.synchronize()
        moved = [a - b for a, b in zip((layers.INT_MM_CALLS, serve.GRAPH_CAPTURES,
                                        serve.GRAPH_REPLAYS), counts)]
        after = i - calib  # requests since the calibration
        forwards = 2 if after < 0 else 1
        assert moved == [forwards * convs, int(after == 1), int(after >= 1)], (i, moved)
        if after >= 0:
            want = _eager(pred).predict(raw["frame"], raw["com"])["uvd"]
            np.testing.assert_array_equal(got, want, err_msg=f"request {i}")


# --------------------------------------------------------------------------- #
# V2V-PoseNet's voxeliser
# --------------------------------------------------------------------------- #


def _v2v_batch(device, b=32, seed=21, side=88):
    """A b32 NYU batch of raw 480x640 frames on the card, V2V's draws and
    its configuration."""
    spec = SPECS["NYU"]
    cam = spec.camera
    raw = make_synthetic_raw_batch(b, 480, 640, 14, fx=cam.fx, fy=cam.fy, cube=250.0,
                                   com_z=600.0, seed=seed)
    cfg = tvox.VoxelConfig(fx=cam.fx, fy=cam.fy, halfu=cam.halfu, halfv=cam.halfv, side=side)
    draws = tvox.draw_augmentation(b, torch.Generator(device=device).manual_seed(seed), device,
                                   cfg)
    return {k: torch.from_numpy(v).to(device) for k, v in raw.items()}, draws, cfg


@pytest.mark.parametrize("seed", [21, 22])
@pytest.mark.parametrize("side", [88, 24])
def test_voxelize_kernel_equals_the_plain_version_bit_for_bit(device, seed, side):
    """The kernel against the plain version on the CPU from the same rows,
    and against the plain version's torch ops on the card (the benchmark
    reference's route) from rows made on the card; frames with a third of
    their pixels moved to the cube's faces and the grid's borders."""
    batch, draws, cfg = _v2v_batch(device, seed=seed, side=side)
    frame = batch["frame"].clone()
    frame[:, ::3] = torch.where(frame[:, ::3] > 0, batch["com"][:, 2, None, None] + 124.999,
                                frame[:, ::3])
    frame[:, 1::7] = torch.where(frame[:, 1::7] > 0, batch["com"][:, 2, None, None] - 125.0,
                                 frame[:, 1::7])
    coef = tvox.coefficients(batch["com"], draws, cfg)
    before = (tvox.LAUNCHES, tvox.VOXELIZED)
    grid = tvox.voxelize(frame, coef, side)
    assert (tvox.LAUNCHES, tvox.VOXELIZED) == (before[0] + 1, before[1] + 32)
    assert torch.equal(grid.cpu(), tvox.voxelize(frame.cpu(), coef.cpu(), side))
    assert torch.equal(grid, tvox.voxelize_plain(frame, coef, side))
    assert int(grid.sum()) > 32 * 100
    assert torch.equal(tvox.voxelize(frame, coef, side), grid)


def test_voxelize_wrapper_rejects_what_the_kernel_does_not_take(device):
    batch, draws, cfg = _v2v_batch(device, b=2)
    coef = tvox.coefficients(batch["com"], draws, cfg)
    with pytest.raises(ValueError):
        tvox.voxelize(batch["frame"], coef, 86)
    with pytest.raises(ValueError):
        tvox.voxelize(batch["frame"][:, :, :638].contiguous(), coef, 88)
    with pytest.raises(ValueError):
        tvox.voxelize(batch["frame"], coef.cpu(), 88)
    with pytest.raises(TypeError):
        tvox.voxelize(batch["frame"].double(), coef, 88)


def test_a_v2v_train_step_launches_the_voxeliser_once_with_no_sync(device):
    """The full-width V2V step at b32: one launch of the voxeliser and 32
    frames voxelised a step; its preprocess (grids and targets) under
    ``set_sync_debug_mode("error")`` and traced with no copy from pageable
    memory; the model received the kernel's grids."""
    batch, draws, cfg = _v2v_batch(device)
    torch.manual_seed(3)
    net = V2VPoseNet(14).to(device)
    state = create_train_state(net, opt="rmsprop", lr=2.5e-4, lr_decay=1.0)
    step = make_train_step_v2v(cfg)
    seen = []
    hook = net.register_forward_pre_hook(lambda m, args: seen.append(args[0]))
    before = (tvox.LAUNCHES, tvox.VOXELIZED)
    out = step(state, batch, draws=draws)
    hook.remove()
    assert (tvox.LAUNCHES - before[0], tvox.VOXELIZED - before[1]) == (1, 32)
    assert torch.isfinite(out["loss"])
    coef = tvox.coefficients(batch["com"], draws, cfg)
    assert torch.equal(seen[0], tvox.voxelize_plain(batch["frame"], coef, 88))
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        torch.cuda.set_sync_debug_mode("error")
        try:
            with torch.no_grad():
                grid, target, _ = v2v_inputs(cfg, batch, draws)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()]
    assert any("voxelize_kernel" in n for n in names)
    assert not [n for n in names if "Pageable" in n]
    assert grid.shape == (32, 1, 88, 88, 88) and target.shape == (32, 14, 44, 44, 44)
