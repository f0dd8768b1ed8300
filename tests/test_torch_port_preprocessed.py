"""PyTorch port vs the JAX package: the last two options of the JAX package.

cv2's legacy fixed-point warp (``warp_affine_inverse(..., quantize=True)``)
against the JAX package's, bit for bit; and the train and eval steps built
with ``preprocess_cfg=None``, which take batches that are already
preprocessed, against the JAX package's steps on the same weights (carried
through ``compat.flax_bridge``) and the same batch made by the JAX
package's ``preprocess_batch``, and against the port's own raw-batch steps,
exactly. The JAX Pallas decoder runs in interpret mode on the CPU. Each
comparison states its tolerance.
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from pixelwiseregression_tpu.compat.torch_ckpt import convert_state_dict
from pixelwiseregression_tpu.core.camera import Camera as JaxCamera
from pixelwiseregression_tpu.data import preprocess as jpre
from pixelwiseregression_tpu.models import PixelwiseRegression as JaxModel
from pixelwiseregression_tpu.ops import image as jimg
from pixelwiseregression_tpu.train import loop as jloop

from pixelwiseregression_tpu_torch.compat.flax_bridge import state_dict_from_flax
from pixelwiseregression_tpu_torch.core.camera import Camera
from pixelwiseregression_tpu_torch.data import preprocess as tpre
from pixelwiseregression_tpu_torch.models.pixelwise import PixelwiseRegression as PortModel
from pixelwiseregression_tpu_torch.ops import image as timg
from pixelwiseregression_tpu_torch.train import loop as tloop

from test_torch_port_ops import _CAM, jax_draws
from test_torch_port_train import (B, FEATURES, J, LABEL, LEVEL, STAGES, _LOSS, _TRAIN_CFG, _raw,
                                   _significant)
# the existing train-step checks, applied to the steps on preprocessed batches
from test_torch_port_train import test_train_step_gradients_match as _gradients_match
from test_torch_port_train import test_train_step_loss_matches as _loss_matches
from torch_port_threads import one_thread  # noqa: F401 (autouse)


# --------------------------------------------------------------------------- #
# cv2's fixed-point warp
# --------------------------------------------------------------------------- #

WARP_SHAPES = [(40, 40), (28, 44), (128, 128)]


def _warp_images(h, w):
    """Ramps (value = x, value = y) and a depth-like image: a centred crop in
    mm (values within +-100) on a zero background."""
    ramp_x = np.broadcast_to(np.arange(w, dtype=np.float32)[None, :], (h, w))
    ramp_y = np.broadcast_to(np.arange(h, dtype=np.float32)[:, None], (h, w))
    depth = np.random.RandomState(h * w).uniform(-100, 100, (h, w)).astype(np.float32)
    depth[: h // 6] = 0.0
    depth[:, w * 3 // 4:] = 0.0
    return {"ramp_x": ramp_x, "ramp_y": ramp_y, "depth": depth}


def _warp_matrices(h, w, seed=31):
    """Inverse rotation/scale matrices about the centre (angles in +-30
    degrees, scales 0.8-1.2, the identity among them) and one random affine."""
    rng = np.random.RandomState(seed)
    angles = np.concatenate([[0.0, 30.0, -30.0], rng.uniform(-30, 30, 3)]).astype(np.float32)
    scales = np.concatenate([[1.0, 0.8, 1.2], rng.uniform(0.8, 1.2, 3)]).astype(np.float32)
    rot = timg.rotation_matrix_inverse(torch.from_numpy(angles), torch.from_numpy(scales),
                                       w / 2, h / 2)
    affine = np.array([[1 + rng.uniform(-0.2, 0.2), rng.uniform(-0.3, 0.3), rng.uniform(-6, 6),
                        rng.uniform(-0.3, 0.3), 1 + rng.uniform(-0.2, 0.2), rng.uniform(-6, 6)]],
                      np.float32)
    return torch.cat([rot, torch.from_numpy(affine)])


def _jax_warps(img, minv, **kw):
    """The JAX package's warp of one image by each matrix (vmapped), run
    eagerly: one XLA program an op, as the port runs one kernel an op (under
    jax.jit XLA fuses the products and sums and the last bits move)."""
    warp = jax.vmap(lambda m: jimg.warp_affine_inverse(jnp.asarray(img), m, **kw))
    return np.asarray(warp(jnp.asarray(minv.numpy())))


def _port_warp(img, minv, **kw):
    imgs = torch.from_numpy(np.ascontiguousarray(np.broadcast_to(img, (len(minv),) + img.shape)))
    return timg.warp_affine_inverse(imgs, minv, **kw).numpy()


@pytest.mark.parametrize("h,w", WARP_SHAPES)
def test_quantized_warp_matches_jax_bit_for_bit(h, w):
    """quantize=True vs the JAX package's quantize=True with the 4-tap
    gather (method="tap"): equal bit for bit on every image and matrix."""
    minv = _warp_matrices(h, w)
    for name, img in _warp_images(h, w).items():
        got = _port_warp(img, minv, quantize=True)
        want = _jax_warps(img, minv, quantize=True, method="tap")
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("h,w", WARP_SHAPES)
def test_quantized_warp_matches_jax_default(h, w):
    """quantize=True vs the JAX package's default route (method="dot", hat
    functions through a matmul): atol 1e-4 (test_warp_affine_matches's
    bound) and the same zero pattern."""
    minv = _warp_matrices(h, w)
    for name, img in _warp_images(h, w).items():
        got = _port_warp(img, minv, quantize=True)
        want = _jax_warps(img, minv, quantize=True)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4, err_msg=name)
        np.testing.assert_array_equal(got != 0, want != 0, err_msg=name)


@pytest.mark.parametrize("h,w", WARP_SHAPES)
def test_float_warp_is_unchanged(h, w):
    """The default (quantize=False) is the same call as quantize=False and
    equals the JAX package's float warp with the 4-tap gather bit for bit;
    the quantized coordinates move the output."""
    minv = _warp_matrices(h, w)
    for name, img in _warp_images(h, w).items():
        got = _port_warp(img, minv)
        np.testing.assert_array_equal(got, _port_warp(img, minv, quantize=False), err_msg=name)
        np.testing.assert_array_equal(got, _jax_warps(img, minv, method="tap"), err_msg=name)
    depth = _warp_images(h, w)["depth"]
    assert not np.array_equal(_port_warp(depth, minv), _port_warp(depth, minv, quantize=True))


# --------------------------------------------------------------------------- #
# the train and eval steps on preprocessed batches
# --------------------------------------------------------------------------- #

# the train keys of preprocess_batch's output, as a caller hands them over
_TRAIN_KEYS = ("img", "label_img", "mask", "uvd", "heatmaps", "dmaps")
_PADDED = np.array([1.0, 1.0, 1.0, 0.0], np.float32)  # the last sample is padding
_SAMPLE_WEIGHTS = {"valid_and_weight": (True, True), "neither": (False, False),
                   "weight_alone": (False, True)}


@pytest.fixture(scope="module")
def carried():
    """The JAX model's variables, calibrated (the port's init carried over by
    the JAX package's convert_state_dict, which costs no compile, and the
    instance_anchored norms' anchors calibrated on the batch; the decoder's
    plain XLA form, the Pallas kernel's reference), the batch preprocessed by
    the JAX package's preprocess_batch without augmentation, and the jitted
    optimizer: the JAX package's, behind a transformation that keeps the
    gradients it is given, so that a JAX step's own gradients can be read
    back from its optimizer state."""
    raw = _raw()
    jm = JaxModel(joints=J, stage=STAGES, label_size=LABEL, features=FEATURES, level=LEVEL,
                  norm_method="instance_anchored", decoder="xla")
    jcfg = jpre.PreprocessConfig(**_TRAIN_CFG)
    data = jax.device_get(jax.jit(lambda r: jpre.preprocess_batch(r, jax.random.PRNGKey(0), jcfg))(
        {k: jnp.asarray(v) for k, v in raw.items()}))
    inputs = [data[k] for k in ("img", "label_img", "mask")]
    torch.manual_seed(1)
    init = PortModel(J, stage=STAGES, features=FEATURES, level=LEVEL,
                     norm_method="instance_anchored").state_dict()
    params = convert_state_dict({k: t for k, t in init.items()
                                 if not k.endswith(("anchor", "anchor_n"))})["params"]
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *inputs, train=False))
    keep = optax.GradientTransformation(lambda p: jax.tree.map(jnp.zeros_like, p),
                                        lambda g, state, params=None: (g, g))
    tx = optax.chain(keep, jloop.make_optimizer(lr=1e-3, steps_per_epoch=100))
    state = jloop.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                             batch_stats=jax.tree.map(lambda a: np.zeros(a.shape, a.dtype),
                                                      shapes["batch_stats"]),
                             opt_state=tx.init(params), tx=tx, apply_fn=jm.apply)
    calibrate = jax.jit(lambda v: jm.apply(v, *inputs, train=False, mutable=["batch_stats"])[1])
    for _ in range(3):
        upd = calibrate({"params": state.params, "batch_stats": state.batch_stats})
        state = state.replace(batch_stats=upd["batch_stats"])
    return types.SimpleNamespace(
        raw=raw, state=state, data=data, loss_cfg=jloop.LossConfig(**_LOSS),
        before=jax.device_get({"params": state.params, "batch_stats": state.batch_stats}))


def _preprocessed(data, valid, weight):
    batch = {k: data[k] for k in _TRAIN_KEYS}
    if valid:
        batch["valid"] = data["valid"]
    if weight:
        batch["weight"] = _PADDED
    return batch


def _port_state(before):
    torch.manual_seed(0)
    pm = PortModel(J, stage=STAGES, features=FEATURES, level=LEVEL,
                   norm_method="instance_anchored", decoder="cuda")
    pm.load_state_dict(state_dict_from_flax(before))
    return tloop.create_train_state(pm, lr=1e-3, steps_per_epoch=100)


@pytest.fixture(scope="module", params=list(_SAMPLE_WEIGHTS))
def pre_pair(request, carried):
    """One train step of ``make_train_step(None)`` in each package, from the
    same weights and the same preprocessed batch, with the batch carrying
    valid and weight, neither, or weight alone; in the layout of
    test_torch_port_train.py's ``step_pair``."""
    batch = _preprocessed(carried.data, *_SAMPLE_WEIGHTS[request.param])
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jstep = jloop.make_train_step(None, carried.loss_cfg, donate=False)
    jstate, jmetrics = jstep(carried.state, jbatch, jax.random.PRNGKey(7))
    jgrads = jax.device_get(jstate.opt_state[0])
    jax_out = {"grads": jgrads, "metrics": jax.device_get(jmetrics),
               "after": jax.device_get({"params": jstate.params,
                                        "batch_stats": jstate.batch_stats})}
    tstate = _port_state(carried.before)
    tmetrics = tloop.make_train_step(None, tloop.LossConfig(**_LOSS))(
        tstate, {k: torch.from_numpy(np.array(v)) for k, v in batch.items()})
    port_out = {"metrics": tmetrics, "model": tstate.model,
                "grads": {n: p.grad for n, p in tstate.model.named_parameters()}}
    return carried.before, jax_out, port_out


def test_preprocessed_train_step_loss_matches(pre_pair):
    """Loss and per-stage (h, d, u) losses: rtol 1e-4 (test_train_step_loss_matches)."""
    _loss_matches(pre_pair)


def test_preprocessed_train_step_gradients_match(pre_pair):
    """test_train_step_gradients_match's rule: the output-side gradients
    within 1e-3 relative, the whole gradient within 5e-2 relative, and each
    significant tensor's cosine to JAX's at least 0.98."""
    _gradients_match(pre_pair)


def test_preprocessed_train_step_updates_match(pre_pair):
    """The updated params and anchors, by test_train_step_updates_match's
    rule with the part of its tolerance that Adam's arithmetic fixes made
    explicit. Adam's first update is lr * g / (|g| + eps) exactly, so two
    gradient entries of one sign part the updates by d = lr * |g_j / (|g_j| +
    eps) - g_t / (|g_t| + eps)|: at most 1e-6 where both |g| exceed lr * eps
    / 1e-6 = 1e-5, and up to 1e-5 at |g| = 1e-6, where the rule's atol 1e-6
    alone does not hold. Upstream of a ReLU the two packages' gradient
    entries may part many times over (test_train_step_gradients_match says
    why), and on these batches such entries with |g| between 1e-6 and 1e-5
    in one package part the updates by up to a few times 1e-6 (the rule as
    written rejects one in two of the three batches). The rule: every update bounded
    by lr * (1 + 1e-5) plus the f32 rounding of its param; for every param
    whose gradient is not zero by design, the updates agree within 1e-6 + d
    wherever |g| > 1e-6 and the two gradients agree in sign (most of its
    entries); anchors atol 1e-4, anchor_n exact."""
    before, jax_out, port_out = pre_pair
    old = state_dict_from_flax(before)
    new_j = state_dict_from_flax(jax_out["after"])
    grads_j = state_dict_from_flax({"params": jax_out["grads"]})
    new_t = port_out["model"].state_dict()
    significant = _significant(port_out["model"])
    lr, eps = 1e-3, 1e-8
    for name, g in grads_j.items():
        g = g.numpy()
        g_t = port_out["grads"][name].numpy()
        d_j = new_j[name].numpy() - old[name].numpy()
        d_t = new_t[name].numpy() - old[name].numpy()
        bound = lr * (1 + 1e-5) + 2 * np.spacing(np.abs(old[name].numpy()))
        assert (np.abs(d_t) <= bound).all() and (np.abs(d_j) <= bound).all(), name
        if name in significant:
            sure = (np.abs(g) > 1e-6) & (np.sign(g) == np.sign(g_t))
            implied = lr * np.abs(g / (np.abs(g) + eps) - g_t / (np.abs(g_t) + eps))
            gap = np.abs(d_t - d_j) - implied
            assert gap[sure].max(initial=0.0) <= 1e-6, (name, gap[sure].max())
            assert sure.mean() > 0.5, (name, sure.mean())
    anchors = [n for n in new_j if n.endswith(("anchor", "anchor_n"))]
    assert anchors
    for name in anchors:
        np.testing.assert_allclose(new_t[name].numpy(), new_j[name].numpy(), rtol=0, atol=1e-4,
                                   err_msg=name)
        if name.endswith("anchor_n"):
            assert float(new_t[name]) == float(new_j[name]) == float(old[name]) + 1


def _equal_steps(a, b):
    """Two port train states and metrics, equal bit for bit."""
    (sa, ma), (sb, mb) = a, b
    assert torch.equal(ma["loss"], mb["loss"])
    assert torch.equal(ma["stage_losses"], mb["stage_losses"])
    ga = dict(sa.model.named_parameters())
    for name, p in sb.model.named_parameters():
        assert torch.equal(p.grad, ga[name].grad), name
    want = sa.model.state_dict()
    for name, t in sb.model.state_dict().items():
        assert torch.equal(t, want[name]), name
    assert sa.step == sb.step == 1


@pytest.mark.parametrize("augment,weight", [(True, True), (True, False), (False, True)])
def test_preprocessed_train_step_equals_the_raw_step(carried, augment, weight):
    """``make_train_step(None)`` on ``preprocess_batch(raw, draws)`` equals
    ``make_train_step(cfg)`` on ``raw`` with the same draws, exactly: loss,
    stage losses, every gradient and every updated parameter and buffer (the
    anchors and their counts included)."""
    cfg = tpre.PreprocessConfig(**_TRAIN_CFG)
    loss_cfg = tloop.LossConfig(**_LOSS)
    raw = {k: torch.from_numpy(v) for k, v in carried.raw.items()}
    if weight:
        raw["weight"] = torch.from_numpy(_PADDED)
    draws = jax_draws(jax.random.PRNGKey(7), B) if augment else None
    s_raw = _port_state(carried.before)
    m_raw = tloop.make_train_step(cfg, loss_cfg, augment=augment)(s_raw, raw, draws=draws)
    with torch.no_grad():
        data = tpre.preprocess_batch(raw, cfg, augment=augment, draws=draws)
    if weight:
        data["weight"] = raw["weight"]
    s_pre = _port_state(carried.before)
    m_pre = tloop.make_train_step(None, loss_cfg)(s_pre, data)
    _equal_steps((s_raw, m_raw), (s_pre, m_pre))


def _cam():
    return dict(fx=_CAM["fx"], fy=_CAM["fy"], halfu=_CAM["halfu"], halfv=_CAM["halfv"])


def test_preprocessed_eval_step_matches_jax(carried):
    """``make_eval_step(None)`` on the JAX-preprocessed batch (box_size, com
    and cube included) with the last sample padded, in both packages: loss
    and stage losses rtol 1e-4, err_sum_mm rtol 1e-4
    (test_eval_step_matches_with_padded_weight's tolerance), count exact."""
    batch = {**carried.data, "weight": _PADDED}
    jstate = carried.state.replace(opt_state=None)
    jev = jloop.make_eval_step(None, carried.loss_cfg, JaxCamera(**_cam()))
    want = jax.device_get(jev(jstate, {k: jnp.asarray(v) for k, v in batch.items()}))
    tev = tloop.make_eval_step(None, tloop.LossConfig(**_LOSS), Camera(**_cam()))
    got = tev(_port_state(carried.before), {k: torch.from_numpy(np.array(v))
                                            for k, v in batch.items()})
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-4)
    np.testing.assert_allclose(got["stage_losses"].numpy(), np.asarray(want["stage_losses"]),
                               rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(got["err_sum_mm"].numpy(), np.asarray(want["err_sum_mm"]),
                               rtol=1e-4)
    assert float(got["count"]) == float(want["count"]) == 3.0


@pytest.mark.parametrize("weight", [True, False])
def test_preprocessed_eval_step_equals_the_raw_eval_step(carried, weight):
    """``make_eval_step(None)`` on ``preprocess_batch(raw)`` equals
    ``make_eval_step(cfg)`` on ``raw`` exactly, with the last sample padded
    and with no weight (all samples count)."""
    cfg = tpre.PreprocessConfig(**_TRAIN_CFG)
    loss_cfg, cam = tloop.LossConfig(**_LOSS), Camera(**_cam())
    raw = {k: torch.from_numpy(v) for k, v in carried.raw.items()}
    if weight:
        raw["weight"] = torch.from_numpy(_PADDED)
    state = _port_state(carried.before)
    want = tloop.make_eval_step(cfg, loss_cfg, cam)(state, raw)
    data = tpre.preprocess_batch(raw, cfg)
    if weight:
        data["weight"] = raw["weight"]
    got = tloop.make_eval_step(None, loss_cfg, cam)(state, data)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert float(got["count"]) == (3.0 if weight else float(B))


def test_fullregression_steps_require_a_config():
    """The FullRegression family's steps take raw batches only, as the JAX
    package's do."""
    with pytest.raises(ValueError, match="preprocess_cfg is required"):
        tloop.make_train_step_fullreg(None)
    with pytest.raises(ValueError, match="preprocess_cfg is required"):
        tloop.make_eval_step_fullreg(None, Camera(**_cam()))
