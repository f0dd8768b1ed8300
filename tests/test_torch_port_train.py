"""PyTorch port vs the JAX package: the training slice.

The norms' hand-written backward and the anchors' EMA, BatchNorm in train
mode, the losses, the optimizer and its schedule, one whole train step
(preprocess with the JAX package's own augmentation draws, forward through
the kernel decoder's autograd.Function, backward, AdamW) and the eval step,
on the same weights (through ``compat.flax_bridge``) and the same numpy
inputs. The JAX Pallas decoder runs in interpret mode on the CPU. Each
comparison states its tolerance.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from pixelwiseregression_tpu.core.camera import Camera as JaxCamera
from pixelwiseregression_tpu.data import preprocess as jpre
from pixelwiseregression_tpu.models import PixelwiseRegression as JaxModel
from pixelwiseregression_tpu.models import layers as jl
from pixelwiseregression_tpu.train import loop as jloop

from pixelwiseregression_tpu_torch.compat.flax_bridge import state_dict_from_flax
from pixelwiseregression_tpu_torch.core.camera import Camera
from pixelwiseregression_tpu_torch.data import preprocess as tpre
from pixelwiseregression_tpu_torch.models import layers as tl
from pixelwiseregression_tpu_torch.models.pixelwise import PixelwiseRegression as PortModel
from pixelwiseregression_tpu_torch.train import loop as tloop

from test_torch_port_ops import _AUG, _CAM, _train_batch, jax_draws


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(a, np.float32),
                                                              (0, 3, 1, 2))))


def _nhwc(t):
    return np.transpose(t.detach().float().numpy(), (0, 2, 3, 1))


def _rel(a, b):
    """|a - b| / |b| over a whole tensor."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# --------------------------------------------------------------------------- #
# norms
# --------------------------------------------------------------------------- #

_NORM_KW = {"instance": {}, "instance_fast": {"fast": True}, "instance_anchored": {"anchored": True}}


def _norm_case(method, dtype, seed=20):
    """A JAX norm with random affine params (anchored: calibrated on three
    batches) and the port norm loaded with the same variables."""
    rng = np.random.RandomState(seed)
    x = (1.5 + 2.0 * rng.randn(3, 8, 8, 6)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    jnorm = jl.InstanceNorm(dtype=jdt, **_NORM_KW[method])
    v = jnorm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    v = {**v, "params": {"scale": jnp.asarray(rng.rand(6) + 0.5, jnp.float32),
                         "bias": jnp.asarray(rng.randn(6), jnp.float32)}}
    if method == "instance_anchored":
        for _ in range(3):
            _, upd = jnorm.apply(v, jnp.asarray(x + rng.randn(*x.shape).astype(np.float32)),
                                 mutable=["batch_stats"])
            v = {**v, "batch_stats": upd["batch_stats"]}
    v = jax.device_get(v)
    tnorm = tl.InstanceNorm(6, method)
    state = {"weight": v["params"]["scale"], "bias": v["params"]["bias"],
             **v.get("batch_stats", {})}
    tnorm.load_state_dict({k: torch.from_numpy(np.array(a)) for k, a in state.items()})
    return jnorm, v, tnorm, x


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("method", ["instance", "instance_fast", "instance_anchored"])
def test_norm_gradients_match_the_jax_custom_vjp(method, dtype):
    """dx, dscale and dbias of sum(y * r) through the port's autograd.Function
    vs jax.grad through the JAX custom VJP (calibrated anchors). f32: dx
    rtol 1e-4 atol 1e-5, dscale/dbias rtol 1e-4 atol 1e-4 (sums over 192
    terms). bf16: x and y are bf16 and dx comes back in bf16; dx within 2
    bf16 ulps (rtol 2**-7, atol 1e-3), dscale/dbias rtol 1e-2 atol 2e-2 (sums
    of bf16-rounded cotangents times x-hat of bf16 x)."""
    jnorm, v, tnorm, x = _norm_case(method, dtype)
    r = np.random.RandomState(21).randn(*x.shape).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32

    def jloss(xx, params):
        y = jnorm.apply({**v, "params": params}, xx)
        return jnp.sum(y.astype(jnp.float32) * jnp.asarray(r))

    gx, gp = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x, jdt), v["params"])
    xt = _nchw(x).to(tdt).requires_grad_(True)
    y = tnorm(xt)
    assert y.dtype == tdt
    torch.sum(y.float() * _nchw(r)).backward()
    assert xt.grad.dtype == tdt
    if dtype == "f32":
        tol_x, tol_p = dict(rtol=1e-4, atol=1e-5), dict(rtol=1e-4, atol=1e-4)
    else:
        tol_x, tol_p = dict(rtol=2 ** -7, atol=1e-3), dict(rtol=1e-2, atol=2e-2)
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(gx, np.float32), **tol_x)
    np.testing.assert_allclose(tnorm.weight.grad.numpy(), np.asarray(gp["scale"]), **tol_p)
    np.testing.assert_allclose(tnorm.bias.grad.numpy(), np.asarray(gp["bias"]), **tol_p)


def test_anchored_norm_updates_its_anchor_in_train_mode_only():
    """Three train-mode forwards from fresh anchors (anchor_n 0, so the first
    is the raw one-pass form) vs the JAX norm applied with a mutable
    batch_stats: each y uses the anchor from before its update (atol 1e-5),
    and the anchors follow the EMA (atol 1e-6, anchor_n exact). Eval mode
    leaves them unchanged."""
    rng = np.random.RandomState(22)
    jnorm = jl.InstanceNorm(anchored=True)
    xs = [(0.5 + rng.randn(2, 8, 8, 4)).astype(np.float32) for _ in range(3)]
    v = jax.device_get(jnorm.init(jax.random.PRNGKey(0), jnp.asarray(xs[0])))
    tnorm = tl.InstanceNorm(4, "instance_anchored").train()
    for x in xs:
        want, upd = jnorm.apply(v, jnp.asarray(x), mutable=["batch_stats"])
        v = {**v, "batch_stats": jax.device_get(upd["batch_stats"])}
        got = tnorm(_nchw(x))
        np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=0, atol=1e-5)
        np.testing.assert_allclose(tnorm.anchor.numpy(), v["batch_stats"]["anchor"], rtol=0,
                                   atol=1e-6)
        assert float(tnorm.anchor_n) == float(v["batch_stats"]["anchor_n"])
    before = tnorm.anchor.clone()
    with torch.no_grad():
        tnorm.eval()(_nchw(xs[0]))
    assert torch.equal(tnorm.anchor, before) and float(tnorm.anchor_n) == 3.0


def test_batch_norm_train_mode_matches_flax():
    """Batch statistics (flax's one-pass variance), the running statistics'
    update with momentum 0.1 from the biased variance, and the gradients, in
    f32: y atol 1e-5, running stats atol 1e-6, grads rtol 1e-4 atol 1e-5."""
    rng = np.random.RandomState(23)
    x = (2.0 + rng.randn(4, 6, 6, 5)).astype(np.float32)
    r = rng.randn(*x.shape).astype(np.float32)
    jbn = jl.make_norm("batch")()
    v = jax.device_get(jbn.init(jax.random.PRNGKey(0), jnp.asarray(x), use_running_average=True))
    v = {"params": {"scale": (rng.rand(5) + 0.5).astype(np.float32),
                    "bias": rng.randn(5).astype(np.float32)},
         "batch_stats": {"mean": rng.randn(5).astype(np.float32),
                         "var": (rng.rand(5) + 0.2).astype(np.float32)}}
    want, upd = jbn.apply(v, jnp.asarray(x), use_running_average=False, mutable=["batch_stats"])

    def jloss(xx, params):
        y, _ = jbn.apply({**v, "params": params}, xx, use_running_average=False,
                         mutable=["batch_stats"])
        return jnp.sum(y * jnp.asarray(r))

    gx, gp = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), v["params"])
    bn = tl.make_norm("batch", 5).train()
    bn.load_state_dict({"weight": torch.from_numpy(v["params"]["scale"]),
                        "bias": torch.from_numpy(v["params"]["bias"]),
                        "running_mean": torch.from_numpy(v["batch_stats"]["mean"]),
                        "running_var": torch.from_numpy(v["batch_stats"]["var"]),
                        "num_batches_tracked": torch.tensor(0)})
    xt = _nchw(x).requires_grad_(True)
    y = bn(xt)
    torch.sum(y * _nchw(r)).backward()
    np.testing.assert_allclose(_nhwc(y), np.asarray(want), rtol=0, atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(upd["batch_stats"]["mean"]),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(upd["batch_stats"]["var"]),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(gx), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(bn.weight.grad.numpy(), np.asarray(gp["scale"]), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(bn.bias.grad.numpy(), np.asarray(gp["bias"]), rtol=1e-4,
                               atol=1e-5)


# --------------------------------------------------------------------------- #
# losses, optimizer, schedule
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("weights", [None, [1.0, 0.0, 1.0, 1.0], [0.0, 0.0, 0.0, 0.0]])
def test_stage_losses_and_total_match(weights):
    """Two stages, NHWC maps for JAX and NCHW for the port, with sample
    weights (all zero included: the mean divides by at least 1): rtol 1e-5."""
    rng = np.random.RandomState(24)
    b, s, j = 4, 8, 5
    results, targets = [], {"heatmaps": rng.rand(b, s, s, j), "dmaps": rng.randn(b, s, s, j),
                            "uvd": rng.randn(b, j, 3)}
    targets = {k: a.astype(np.float32) for k, a in targets.items()}
    for _ in range(2):
        results.append((rng.rand(b, s, s, j).astype(np.float32),
                        rng.randn(b, s, s, j).astype(np.float32),
                        rng.randn(b, j, 3).astype(np.float32)))
    sw = None if weights is None else np.asarray(weights, np.float32)
    want = jloop.stage_losses([tuple(jnp.asarray(a) for a in r) for r in results],
                              {k: jnp.asarray(a) for k, a in targets.items()}, 1.0, 0.01,
                              None if sw is None else jnp.asarray(sw))
    got = tloop.stage_losses([(_nchw(h), _nchw(d), torch.from_numpy(u)) for h, d, u in results],
                             {"heatmaps": _nchw(targets["heatmaps"]),
                              "dmaps": _nchw(targets["dmaps"]),
                              "uvd": torch.from_numpy(targets["uvd"])}, 1.0, 0.01,
                             None if sw is None else torch.from_numpy(sw))
    np.testing.assert_allclose(np.asarray([[float(t) for t in e] for e in got]),
                               np.asarray(want, np.float32), rtol=1e-5, atol=0)
    for alpha in (1.0, 0.5):
        np.testing.assert_allclose(float(tloop.total_loss(got, alpha)),
                                   float(jloop.total_loss(want, alpha)), rtol=1e-5)


@pytest.mark.parametrize("opt,weight_decay", [("adam", 0.0), ("adam", 0.05), ("sgd", 0.0),
                                              ("sgd", 0.05)])
def test_optimizer_and_schedule_match_optax(opt, weight_decay):
    """Seven steps across two lr decays (steps_per_epoch 2, decay_epoch 1.5,
    lr_decay 0.2: the lr drops before steps 4 and 6) on random gradients of
    size ~1, where Adam's update is far from its sign-flip regime: params
    rtol 1e-5 atol 1e-7 after every step."""
    rng = np.random.RandomState(25)
    shapes = [(3, 4), (5,)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    kw = dict(opt=opt, lr=1e-2, weight_decay=weight_decay, lr_decay=0.2, decay_epoch=1.5,
              steps_per_epoch=2)
    tx = jloop.make_optimizer(**kw)
    jp = [jnp.asarray(p) for p in params]
    opt_state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    optimizer, scheduler = tloop.make_optimizer(tp, **kw)
    for i in range(7):
        grads = [rng.randn(*s).astype(np.float32) for s in shapes]
        updates, opt_state = tx.update([jnp.asarray(g) for g in grads], opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, g in zip(tp, grads):
            p.grad = torch.from_numpy(g)
        optimizer.step()
        scheduler.step()
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-5, atol=1e-7,
                                       err_msg=f"step {i}")
    assert scheduler.get_last_lr()[0] == pytest.approx(1e-2 * 0.2 ** 2)


# --------------------------------------------------------------------------- #
# one whole train step and the eval step
# --------------------------------------------------------------------------- #

J, STAGES, FEATURES, LEVEL, LABEL, B = 14, 2, 16, 2, 32, 4
_TRAIN_CFG = dict(_CAM, image_size=2 * LABEL, label_size=LABEL, **_AUG)
_LOSS = dict(lambda_h=1.0, lambda_d=0.01, alpha=0.5)


def _raw():
    return {k: v[:B] for k, v in _train_batch().items()}


@pytest.fixture(scope="module")
def step_pair():
    """One train step of the JAX package and of the port from the same
    weights, batch and augmentation draws: instance_anchored norms with
    anchors calibrated on the batch, the Pallas / kernel decoders, AdamW at
    lr 1e-3, alpha 0.5 so that every loss term has a gradient."""
    raw = _raw()
    jraw = {k: jnp.asarray(v) for k, v in raw.items()}
    jm = JaxModel(joints=J, stage=STAGES, label_size=LABEL, features=FEATURES, level=LEVEL,
                  norm_method="instance_anchored", decoder="pallas")
    jcfg = jpre.PreprocessConfig(**_TRAIN_CFG)
    inputs = jax.jit(lambda r: [jpre.preprocess_batch(r, jax.random.PRNGKey(0), jcfg)[k]
                                for k in ("img", "label_img", "mask")])(jraw)
    tx = jloop.make_optimizer(lr=1e-3, steps_per_epoch=100)
    # create_train_state, with the init jitted (run eagerly it compiles op by op)
    variables = jax.jit(lambda k: jm.init(k, *inputs, train=False))(jax.random.PRNGKey(1))
    state = jloop.TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                             batch_stats=variables["batch_stats"],
                             opt_state=tx.init(variables["params"]), tx=tx, apply_fn=jm.apply)
    calibrate = jax.jit(lambda v: jm.apply(v, *inputs, train=False, mutable=["batch_stats"])[1])
    for _ in range(3):  # calibrate the anchors
        upd = calibrate({"params": state.params, "batch_stats": state.batch_stats})
        state = state.replace(batch_stats=upd["batch_stats"])
    before = jax.device_get({"params": state.params, "batch_stats": state.batch_stats})

    key = jax.random.PRNGKey(7)
    loss_cfg = jloop.LossConfig(**_LOSS)
    grad_fn = jax.jit(jax.grad(lambda p: _jax_loss(jm, jcfg, loss_cfg, state, p, jraw, key)))
    jgrads = jax.device_get(grad_fn(state.params))
    jstep = jloop.make_train_step(jcfg, loss_cfg, augment=True, donate=False)
    jstate, jmetrics = jstep(state, jraw, key)
    jax_out = {"grads": jgrads, "metrics": jax.device_get(jmetrics),
               "after": jax.device_get({"params": jstate.params,
                                        "batch_stats": jstate.batch_stats})}

    torch.manual_seed(0)
    pm = PortModel(J, stage=STAGES, features=FEATURES, level=LEVEL,
                   norm_method="instance_anchored", decoder="cuda")
    pm.load_state_dict(state_dict_from_flax(before))
    tstate = tloop.create_train_state(pm, lr=1e-3, steps_per_epoch=100)
    tstep = tloop.make_train_step(tpre.PreprocessConfig(**_TRAIN_CFG),
                                  tloop.LossConfig(**_LOSS), augment=True)
    tmetrics = tstep(tstate, {k: torch.from_numpy(v) for k, v in raw.items()},
                     draws=jax_draws(key, B))
    port_out = {"metrics": tmetrics, "model": pm,
                "grads": {n: p.grad for n, p in pm.named_parameters()}}
    return before, jax_out, port_out


def _jax_loss(jm, jcfg, loss_cfg, state, params, jraw, key):
    """The JAX train step's loss as a function of the params (for its grads)."""
    data = jpre.preprocess_batch(jraw, key, jcfg, augment=True)
    results, _ = jm.apply({"params": params, "batch_stats": state.batch_stats}, data["img"],
                          data["label_img"], data["mask"], train=True, mutable=["batch_stats"])
    every = jloop.stage_losses(results, data, loss_cfg.lambda_h, loss_cfg.lambda_d,
                               data["valid"].astype(jnp.float32))
    return jloop.total_loss(every, loss_cfg.alpha)


def test_train_step_loss_matches(step_pair):
    """Loss and per-stage (h, d, u) losses: rtol 1e-4 (f32 through ~80 convs)."""
    _, jax_out, port_out = step_pair
    np.testing.assert_allclose(float(port_out["metrics"]["loss"]),
                               float(jax_out["metrics"]["loss"]), rtol=1e-4)
    np.testing.assert_allclose(port_out["metrics"]["stage_losses"].numpy(),
                               np.asarray(jax_out["metrics"]["stage_losses"]), rtol=1e-4, atol=1e-7)


def _significant(model):
    """Names of the params whose gradient is not zero by design. A conv bias
    that feeds an instance norm, and the plane head's last bias (a softmax
    input), have an exactly zero gradient, which both frameworks give as
    rounding noise."""
    zero = set()
    for name, seq in model.named_modules():
        if isinstance(seq, torch.nn.Sequential):
            for i in range(len(seq) - 1):
                if isinstance(seq[i], tl.Conv) and isinstance(seq[i + 1], tl.InstanceNorm):
                    zero.add(f"{name}.{i}.bias")
    zero |= {f"stages.{s}.plane_regression.conv.9.bias" for s in range(STAGES)}
    return {n for n, _ in model.named_parameters()} - zero


def _cos(a, b):
    a, b = a.ravel().astype(np.float64), b.ravel().astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def test_train_step_gradients_match(step_pair):
    """Every parameter's gradient, mapped by name through the weight bridge
    (state_dict_from_flax maps a gradient tree as it maps params).

    The rule. Between the loss and the last ReLU (the last stage's output
    convs and softmax temperature) the gradients agree within 1e-3
    relative. Upstream of a ReLU they cannot agree that closely: on these
    crops (a hand on a zero background) the random-init model has
    near-constant channels whose instance norms amplify the two frameworks'
    f32 rounding of the forward by ~100x, so a few ReLU inputs near zero take
    opposite signs, and each such flip moves a whole gradient entry (about
    1 in 1e3 relu masks differ; measured gaps reach 12% in the stage-1
    hourglass). The per-op gradients are held tightly elsewhere in this file
    and in test_torch_port_ops.py. Here: the whole gradient's relative gap
    at most 5e-2 and each significant tensor's cosine to JAX's at least 0.98."""
    _, jax_out, port_out = step_pair
    want = {n: t.numpy() for n, t in state_dict_from_flax({"params": jax_out["grads"]}).items()}
    got = {n: g.numpy() for n, g in port_out["grads"].items()}
    assert set(want) == set(got)
    last = f"stages.{STAGES - 1}"
    for name in (f"{last}.plane_regression.w", f"{last}.plane_regression.conv.9.weight",
                 f"{last}.depth_regression.conv.9.weight", f"{last}.depth_regression.conv.9.bias"):
        assert _rel(got[name], want[name]) <= 1e-3, (name, _rel(got[name], want[name]))
    names = sorted(want)
    whole = _rel(np.concatenate([got[n].ravel() for n in names]),
                 np.concatenate([want[n].ravel() for n in names]))
    assert whole <= 5e-2, whole
    significant = _significant(port_out["model"])
    cosines = {n: _cos(got[n], want[n]) for n in significant}
    worst = min(cosines, key=cosines.get)
    assert cosines[worst] >= 0.98, (worst, cosines[worst])


def test_train_step_updates_match(step_pair):
    """The updated params and anchors. Adam's first update is lr * g / (|g| +
    eps), about +-lr wherever |g| >> eps, so where the two gradients differ
    near zero its sign may flip and the params differ by up to 2 lr. The
    rule: for every param whose gradient is not zero by design, the update
    (new - old) agrees within atol 1e-6 wherever |g| > 1e-6 and the two
    gradients agree in sign (most of its entries); every update is bounded
    by lr * (1 + 1e-5), plus the f32 rounding of the param it is added to. Anchors follow the
    batch means of the train-mode forward: atol 1e-4 (values up to ~10),
    anchor_n exact."""
    before, jax_out, port_out = step_pair
    old = state_dict_from_flax(before)
    new_j = state_dict_from_flax(jax_out["after"])
    grads_j = state_dict_from_flax({"params": jax_out["grads"]})
    new_t = port_out["model"].state_dict()
    significant = _significant(port_out["model"])
    lr = 1e-3
    for name, g in grads_j.items():
        g = g.numpy()
        g_t = port_out["grads"][name].numpy()
        d_j = new_j[name].numpy() - old[name].numpy()
        d_t = new_t[name].numpy() - old[name].numpy()
        bound = lr * (1 + 1e-5) + 2 * np.spacing(np.abs(old[name].numpy()))
        assert (np.abs(d_t) <= bound).all() and (np.abs(d_j) <= bound).all(), name
        if name in significant:
            sure = (np.abs(g) > 1e-6) & (np.sign(g) == np.sign(g_t))
            np.testing.assert_allclose(d_t[sure], d_j[sure], rtol=0, atol=1e-6, err_msg=name)
            assert sure.mean() > 0.5, (name, sure.mean())
    anchors = [n for n in new_j if n.endswith(("anchor", "anchor_n"))]
    assert anchors
    for name in anchors:
        np.testing.assert_allclose(new_t[name].numpy(), new_j[name].numpy(), rtol=0, atol=1e-4,
                                   err_msg=name)
        if name.endswith("anchor_n"):
            assert float(new_t[name]) == float(new_j[name]) == float(old[name]) + 1


def test_eval_step_matches_with_padded_weight(step_pair):
    """The eval step on the calibrated weights before the step, with the
    last sample marked as padding: loss and stage losses rtol 1e-4,
    err_sum_mm rtol 1e-4 (mm sums of ~10-100), count exact; the padded
    sample changes nothing when its frame changes."""
    before, _, _ = step_pair
    raw = _raw()
    weight = np.array([1.0, 1.0, 1.0, 0.0], np.float32)
    jm = JaxModel(joints=J, stage=STAGES, label_size=LABEL, features=FEATURES, level=LEVEL,
                  norm_method="instance_anchored", decoder="pallas")
    jstate = jloop.TrainState(step=jnp.zeros((), jnp.int32), params=before["params"],
                              batch_stats=before["batch_stats"], opt_state=None, tx=None,
                              apply_fn=jm.apply)
    cam = dict(fx=_CAM["fx"], fy=_CAM["fy"], halfu=_CAM["halfu"], halfv=_CAM["halfv"])
    jev = jloop.make_eval_step(jpre.PreprocessConfig(**_TRAIN_CFG), jloop.LossConfig(**_LOSS),
                               JaxCamera(**cam))
    want = jax.device_get(jev(jstate, {**{k: jnp.asarray(v) for k, v in raw.items()},
                                       "weight": jnp.asarray(weight)}))
    pm = PortModel(J, stage=STAGES, features=FEATURES, level=LEVEL,
                   norm_method="instance_anchored", decoder="cuda")
    pm.load_state_dict(state_dict_from_flax(before))
    tstate = tloop.create_train_state(pm)
    tev = tloop.make_eval_step(tpre.PreprocessConfig(**_TRAIN_CFG), tloop.LossConfig(**_LOSS),
                               Camera(**cam))
    tb = {k: torch.from_numpy(v) for k, v in raw.items()}
    got = tev(tstate, {**tb, "weight": torch.from_numpy(weight)})
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-4)
    np.testing.assert_allclose(got["stage_losses"].numpy(), np.asarray(want["stage_losses"]),
                               rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(got["err_sum_mm"].numpy(), np.asarray(want["err_sum_mm"]),
                               rtol=1e-4)
    assert float(got["count"]) == float(want["count"]) == 3.0
    tb["frame"] = tb["frame"].clone()
    tb["frame"][3] += 50.0
    again = tev(tstate, {**tb, "weight": torch.from_numpy(weight)})
    assert torch.equal(again["err_sum_mm"], got["err_sum_mm"])


def test_overfit_synthetic_batch():
    """The port's counterpart of tests/test_train_loop.py's overfit test:
    one stage, features 32, level 2, eight clean synthetic samples, AdamW at
    lr 1e-3, alpha 0.5: after 30 steps the loss is below half its start."""
    from test_preprocess import FX, FY, HALFU, HALFV, _host_batch, _synthetic_sample

    torch.manual_seed(0)
    batch = {k: torch.from_numpy(np.array(v))
             for k, v in _host_batch([_synthetic_sample(joints=14) for _ in range(8)]).items()}
    model = PortModel(14, stage=1, features=32, level=2, decoder="cuda")
    state = tloop.create_train_state(model, lr=1e-3, steps_per_epoch=10_000)
    cfg = tpre.PreprocessConfig(fx=FX, fy=FY, halfu=HALFU, halfv=HALFV)
    step = tloop.make_train_step(cfg, tloop.LossConfig(alpha=0.5), augment=False)
    losses = [float(step(state, batch)["loss"]) for _ in range(30)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.5, f"no overfit: {losses[0]} -> {losses[-1]}"
    assert state.step == 30
