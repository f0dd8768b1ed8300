"""The port's CUDA kernels on the card: the soft-argmax decoder's forward
(K1) and backward (K2) kernels, the fused conv + instance-norm unit (K3),
the whole hourglass (K4), the norm+relu backward (K5) and the ablation
pieces (K6) vs their plain PyTorch versions, the wrappers' checks, the
Predictor through K1, a train step through K1 and K2, and both inference
engines through K3, K4 and K1.

Every test is marked ``cuda`` and skips where no CUDA card is visible. The
file imports neither jax nor the JAX package, so it also runs on a machine
without jax (``tests/conftest.py`` imports jax; pass ``--noconftest`` there):

    python -m pytest tests/test_torch_port_cuda.py -q -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from pixelwiseregression_tpu_torch.data.preprocess import PreprocessConfig, draw_augmentation
from pixelwiseregression_tpu_torch.data.sources import SPECS
from pixelwiseregression_tpu_torch.models.infer_engine import make_fused_apply, make_unit_fused_apply
from pixelwiseregression_tpu_torch.models.pixelwise import Hourglass, PixelwiseRegression
from pixelwiseregression_tpu_torch.ops import ablate_pieces as tap
from pixelwiseregression_tpu_torch.ops import cuda_fused as tfused
from pixelwiseregression_tpu_torch.ops import cuda_hourglass as thg
from pixelwiseregression_tpu_torch.ops import cuda_normrelu as tcn
from pixelwiseregression_tpu_torch.ops import cuda_softargmax as tcuda
from pixelwiseregression_tpu_torch.ops import fused_normrelu as tnr
from pixelwiseregression_tpu_torch.ops import softargmax as tsa
from pixelwiseregression_tpu_torch.serve import Predictor
from pixelwiseregression_tpu_torch.train.loop import LossConfig, create_train_state, make_train_step
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


def test_predictor_through_the_kernel_matches_plain_decoder(device):
    """A small bf16 Predictor on the card: decoder='cuda' launches the kernel
    once per stage and agrees with decoder='torch' within 1e-3 normalized
    (bf16 heatmaps from the two decoders may differ by 1 ulp before stage 2)."""
    spec = SPECS["NYU"]
    torch.manual_seed(0)
    state = PixelwiseRegression(14, stage=2, features=32, level=2,
                                norm_method="instance_anchored").state_dict()
    kw = dict(batch_size=8, stages=2, features=32, level=2, label_size=64,
              dtype=torch.bfloat16)
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
    launches K1 and K2 once; loss rtol 1e-4; the last stage's output convs
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
    before = (tcuda.LAUNCHES, tcuda.BWD_LAUNCHES)
    got, g_k = _train_once(device, "cuda", state_dict, batch, draws)
    torch.cuda.synchronize()
    assert (tcuda.LAUNCHES, tcuda.BWD_LAUNCHES) == (before[0] + 2, before[1] + 2)
    want, g_p = _train_once(device, "torch", state_dict, batch, draws)
    assert torch.isfinite(got["loss"])
    torch.testing.assert_close(got["loss"], want["loss"], rtol=1e-4, atol=0)
    for name in ("stages.1.plane_regression.w", "stages.1.plane_regression.conv.9.weight",
                 "stages.1.depth_regression.conv.9.weight"):
        assert float((g_k[name] - g_p[name]).norm() / g_p[name].norm()) <= 1e-3, name
    whole = (torch.cat([(g_k[n] - g_p[n]).flatten() for n in g_p]).norm()
             / torch.cat([g_p[n].flatten() for n in g_p]).norm())
    assert float(whole) <= 5e-2, float(whole)


# --------------------------------------------------------------------------- #
# K3 (fused conv + instance norm) and K4 (whole hourglass)
# --------------------------------------------------------------------------- #

# (k, C, Co, prologue, epilogue) per unit, and whether the chain ends with + x
UNIT_FORMS = {
    "epi_k1": ([(1, 8, 16, False, True)], False),
    "epi_k3": ([(3, 8, 16, False, True)], False),
    "pro_k1": ([(1, 16, 8, True, False)], False),
    "pro_k3": ([(3, 16, 8, True, False)], False),
    "both": ([(3, 8, 16, True, True)], False),
    "pro_skip": ([(1, 16, 16, True, False)], True),
    "head_chain": ([(3, 8, 8, False, True)] * 3, False),
    "resblock": ([(1, 16, 8, True, False), (3, 8, 8, True, False), (1, 8, 16, True, False)], True),
    # past one 64x64 tile in M and N, a partial 32-channel K step, C > 32
    "wide": ([(3, 48, 72, True, True), (1, 72, 48, True, False)], True),
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
    spec, with_skip = UNIT_FORMS[form]
    rng = np.random.RandomState(20)
    x = torch.from_numpy((1.0 + rng.randn(3, 12, 12, spec[0][1])).astype(np.float32)).to(device, dt)
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hourglass_kernel_matches_plain_version(device, dtype):
    """K4 at level 1 ([2, 16, 16, 32]) vs its plain version on the card.
    f32: atol 1e-4 of the output's scale; bf16: at most 4 bf16 ulps of it
    (17 convs and 15 norms deep; an order difference that flips one rounding
    moves the statistics of every later norm)."""
    dt = getattr(torch, dtype)
    stacked = {k: v.to(device) for k, v in
               thg.stack_hourglass_params(_hourglass_state(32, 1, 30), 1).items()}
    x = torch.from_numpy(np.random.RandomState(31).randn(2, 16, 16, 32).astype(np.float32))
    x = x.to(device, dt)
    before = thg.LAUNCHES
    got = thg.hourglass_fused(x, stacked, 1)
    torch.cuda.synchronize()
    assert thg.LAUNCHES == before + 1
    want = thg.hourglass_fused_plain(x, stacked, 1)
    assert torch.isfinite(got.float()).all()
    if dt == torch.float32:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * float(want.abs().max()))
    else:
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", tap.XM_MODES)
def test_build_xm_kernel_is_exact(device, mode, dtype):
    """The tap operand and its probes on the card, bit-exact against the
    plain version (14x10 maps: W not a power of two)."""
    dt = getattr(torch, dtype)
    x = torch.from_numpy(np.random.RandomState(62).randn(3, 14 * 10, 24).astype(np.float32))
    x = x.to(device, dt)
    before = tap.BUILD_LAUNCHES
    got = tap.build_xm(x, 14, 10, mode)
    torch.cuda.synchronize()
    assert tap.BUILD_LAUNCHES == before + 1
    want = tap.build_xm_plain(x, 14, 10, mode)
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


@pytest.mark.parametrize("layout", ["taps", "repeat"])
def test_xm_dots_kernel_matches_plain_version(device, layout):
    """The products on a prebuilt operand, bf16, within 2 bf16 ulps of the
    output's scale of the plain version's f32 products (past one 64x64 tile
    in rows and columns, a partial 32-deep K step: K = 3*24)."""
    rng = np.random.RandomState(63)
    h, w, c, co = 12, 10, 24, 72
    rows, offsets = ((h + 2) * w, (0, w, 2 * w)) if layout == "taps" else (h * w, (0, 0, 0))
    xm = torch.from_numpy(rng.randn(3, rows, 3 * c).astype(np.float32)).to(device, torch.bfloat16)
    wcat = torch.from_numpy((0.1 * rng.randn(3, 3 * c, co)).astype(np.float32)).to(device, torch.bfloat16)
    before = tap.DOTS_LAUNCHES
    got = tap.xm_dots(xm, wcat, h * w, offsets)
    torch.cuda.synchronize()
    assert tap.DOTS_LAUNCHES == before + 1
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
