"""PyTorch port vs the JAX package: layers, the weight bridge and the whole
model on the same weights.

The JAX model is initialized from a seed, its variables go through
``compat.flax_bridge.state_dict_from_flax`` into the port, and both run the
same numpy inputs. Each comparison states its tolerance.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pixelwiseregression_tpu.compat.torch_ckpt import convert_state_dict
from pixelwiseregression_tpu.models import PixelwiseRegression as JaxModel
from pixelwiseregression_tpu.models import layers as jl

from pixelwiseregression_tpu_torch.compat.flax_bridge import state_dict_from_flax
from pixelwiseregression_tpu_torch.models import layers as tl
from pixelwiseregression_tpu_torch.models.pixelwise import PixelwiseRegression as PortModel

from torch_port_threads import one_thread  # noqa: F401 (autouse)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def _nhwc(t):
    return np.transpose(t.detach().float().numpy(), (0, 2, 3, 1))


def _adversarial_input():
    """The near-constant channels of tests/test_anchored_norm.py."""
    rng = np.random.RandomState(0)
    x = np.zeros((4, 8, 8, 4), np.float32)
    x[..., 0] = 5.0 + rng.randn(4, 8, 8) * 1e-4
    x[..., 1] = rng.randn(4, 8, 8)
    x[..., 2] = -3.0
    x[..., 3] = 100.0 + rng.randn(4, 8, 8) * 1e-3
    return x


# --------------------------------------------------------------------------- #
# layers
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("k,stride", [(1, 1), (3, 1), (3, 2), (7, 1)])
def test_conv_matches(k, stride):
    """Explicit k//2 padding, HWIO -> OIHW: f32 atol 1e-5."""
    x = np.random.RandomState(1).randn(2, 12, 12, 5).astype(np.float32)
    jconv = jl.Conv(features=6, kernel_size=k, stride=stride)
    v = jax.device_get(jconv.init(jax.random.PRNGKey(k), jnp.asarray(x)))
    want = np.asarray(jconv.apply(v, jnp.asarray(x)))
    conv = tl.Conv(5, 6, k, stride)
    conv.load_state_dict({k.removeprefix("conv.0."): t for k, t in
                          state_dict_from_flax({"params": {"stem_conv_0": v["params"]}}).items()})
    with torch.no_grad():
        got = _nhwc(conv(_nchw(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _norm_pair(method, x, calibrate):
    kw = {"instance": {}, "instance_fast": {"fast": True},
          "instance_anchored": {"anchored": True}}[method]
    jnorm = jl.InstanceNorm(**kw)
    v = jnorm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    rng = np.random.RandomState(2)
    v = {**v, "params": {"scale": jnp.asarray(rng.rand(4) + 0.5, jnp.float32),
                         "bias": jnp.asarray(rng.randn(4), jnp.float32)}}
    for _ in range(calibrate):
        _, upd = jnorm.apply(v, jnp.asarray(x), mutable=["batch_stats"])
        v = {**v, "batch_stats": upd["batch_stats"]}
    v = jax.device_get(v)
    tnorm = tl.InstanceNorm(4, method)
    state = {"weight": v["params"]["scale"], "bias": v["params"]["bias"],
             **v.get("batch_stats", {})}
    tnorm.load_state_dict({k: torch.from_numpy(np.array(a)) for k, a in state.items()})
    want = np.asarray(jnorm.apply(v, jnp.asarray(x)))
    with torch.no_grad():
        got = _nhwc(tnorm(_nchw(x)))
    return got, want


@pytest.mark.parametrize("method", ["instance", "instance_fast", "instance_anchored"])
def test_instance_norms_match(method):
    """Well-conditioned channels: f32 atol 1e-5 for all three forms."""
    x = (3.0 + 2.0 * np.random.RandomState(3).randn(4, 8, 8, 4)).astype(np.float32)
    got, want = _norm_pair(method, x, calibrate=20 if method == "instance_anchored" else 0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_anchored_norm_matches_on_near_constant_channels():
    """Calibrated anchors on the adversarial channels: atol 1e-5 on the
    channels whose output f32 can resolve to 1e-5. On the near-constant
    channel at 5.0 the output is x*a + b with x*a ~ 1.6e3, whose f32 ulp is
    1.2e-4, so the two frameworks agree there to 2 ulp of x*a. Against
    float64 ground truth the port is no worse than twice the JAX norm's own
    error (or 1e-3, the bar of tests/test_anchored_norm.py)."""
    x = _adversarial_input()
    got, want = _norm_pair("instance_anchored", x, calibrate=20)
    np.testing.assert_allclose(got[..., 1:], want[..., 1:], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[..., 0], want[..., 0], rtol=0, atol=2 * 1.2207031e-4)
    x64 = x.astype(np.float64)
    mean = x64.mean(axis=(1, 2), keepdims=True)
    ref = (x64 - mean) / np.sqrt(((x64 - mean) ** 2).mean(axis=(1, 2), keepdims=True) + 1e-5)
    rng = np.random.RandomState(2)  # the scale and bias _norm_pair drew
    y_ref = ref * (rng.rand(4) + 0.5).astype(np.float32) + rng.randn(4).astype(np.float32)
    err_port, err_jax = np.abs(got - y_ref).max(), np.abs(want - y_ref).max()
    assert err_port <= max(2 * err_jax, 1e-3), (err_port, err_jax)


def test_batch_norm_eval_matches():
    """BatchNorm on running statistics (eval): f32 atol 1e-5."""
    rng = np.random.RandomState(4)
    x = rng.randn(3, 6, 6, 4).astype(np.float32)
    jbn = jl.make_norm("batch")()
    v = jax.device_get(jbn.init(jax.random.PRNGKey(0), jnp.asarray(x), use_running_average=True))
    v = {"params": {"scale": rng.rand(4).astype(np.float32) + 0.5,
                    "bias": rng.randn(4).astype(np.float32)},
         "batch_stats": {"mean": rng.randn(4).astype(np.float32),
                         "var": rng.rand(4).astype(np.float32) + 0.2}}
    want = np.asarray(jbn.apply(v, jnp.asarray(x), use_running_average=True))
    bn = tl.make_norm("batch", 4).eval()
    bn.load_state_dict({"weight": torch.from_numpy(v["params"]["scale"]),
                        "bias": torch.from_numpy(v["params"]["bias"]),
                        "running_mean": torch.from_numpy(v["batch_stats"]["mean"]),
                        "running_var": torch.from_numpy(v["batch_stats"]["var"]),
                        "num_batches_tracked": torch.tensor(0)})
    with torch.no_grad():
        got = _nhwc(bn(_nchw(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_max_pool_and_upsample_add_match():
    """Exact ops: atol 1e-5 (bit-identical in practice)."""
    rng = np.random.RandomState(5)
    x = rng.randn(2, 8, 8, 3).astype(np.float32)
    h = rng.randn(2, 4, 4, 3).astype(np.float32)
    np.testing.assert_allclose(_nhwc(tl.max_pool_2x2(_nchw(x))),
                               np.asarray(jl.max_pool_2x2(jnp.asarray(x))), rtol=0, atol=1e-5)
    np.testing.assert_allclose(_nhwc(tl.upsample_nearest_2x_add(_nchw(h), _nchw(x))),
                               np.asarray(jl.upsample_nearest_2x_add(jnp.asarray(h), jnp.asarray(x))),
                               rtol=0, atol=1e-5)


# --------------------------------------------------------------------------- #
# whole model through the weight bridge
# --------------------------------------------------------------------------- #

J, STAGES, FEATURES, LEVEL, LABEL = 5, 2, 32, 2, 32


def _model_inputs(seed=7, b=2):
    rng = np.random.RandomState(seed)
    img = rng.randn(b, 2 * LABEL, 2 * LABEL, 1).astype(np.float32)
    label = rng.randn(b, LABEL, LABEL, 1).astype(np.float32)
    mask = (rng.rand(b, LABEL, LABEL, 1) > 0.4).astype(np.float32)
    return img, label, mask


def _jax_variables(norm_method, inputs, calibrate=1):
    """JAX model variables from a seed; anchored norms are calibrated on the inputs."""
    jm = JaxModel(joints=J, stage=STAGES, label_size=LABEL, features=FEATURES, level=LEVEL,
                  norm_method=norm_method)
    args = [jnp.asarray(a) for a in inputs]
    v = jax.device_get(jm.init(jax.random.PRNGKey(1), *args, train=False))
    if norm_method == "instance_anchored":
        for _ in range(calibrate):
            _, upd = jm.apply(v, *args, train=False, mutable=["batch_stats"])
            v = {"params": v["params"], "batch_stats": jax.device_get(upd["batch_stats"])}
    return v


def _run_jax(variables, inputs, norm_method, dtype=jnp.float32, decoder="xla"):
    jm = JaxModel(joints=J, stage=STAGES, label_size=LABEL, features=FEATURES, level=LEVEL,
                  norm_method=norm_method, dtype=dtype, decoder=decoder)
    out = jm.apply(variables, *(jnp.asarray(a) for a in inputs), train=False)
    return [tuple(np.asarray(t, np.float32) for t in stage) for stage in out]


def _run_port(state, inputs, norm_method, dtype=torch.float32, decoder="torch"):
    pm = PortModel(J, stage=STAGES, features=FEATURES, level=LEVEL, norm_method=norm_method,
                   decoder=decoder, dtype=dtype)
    pm.load_state_dict(state)
    pm.eval()
    with torch.inference_mode():
        out = pm(*(_nchw(a) for a in inputs))
    return [(_nhwc(hm), _nhwc(dm), uvd.float().numpy()) for hm, dm, uvd in out]


@pytest.mark.parametrize("norm_method", ["instance", "instance_anchored"])
def test_model_f32_matches_jax_through_the_bridge(norm_method):
    """f32, every stage: uvd rtol 1e-3 atol 2e-5, heatmaps rtol 1e-3 atol 1e-5,
    as tests/test_torch_parity.py holds the reference model; depth maps carry
    f32 reordering noise of ~40 chained convs (atol 1e-3)."""
    inputs = _model_inputs()
    v = _jax_variables(norm_method, inputs)
    want = _run_jax(v, inputs, norm_method)
    got = _run_port(state_dict_from_flax(v), inputs, norm_method)
    for (hm_t, dm_t, uvd_t), (hm_j, dm_j, uvd_j) in zip(got, want):
        np.testing.assert_allclose(hm_t, hm_j, rtol=1e-3, atol=1e-5)
        np.testing.assert_allclose(dm_t, dm_j, rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(uvd_t, uvd_j, rtol=1e-3, atol=2e-5)


def test_model_bf16_matches_jax_at_bf16_precision():
    """bf16 activations, the serving defaults (instance_anchored; the port's
    kernel decoder, its plain version on the CPU, against the JAX Pallas decoder).

    bf16 keeps 8 significant bits and the two frameworks round at different
    points (a bf16 conv accumulates in f32 and rounds once in torch, XLA adds
    the bias after rounding), so on random weights the port's bf16 uvd cannot
    match JAX's bf16 uvd to f32 tolerances. The bound: per stage, the gap
    between the two bf16 runs is at most twice the gap between JAX's own
    bf16 and f32 runs, and the port's f32 run stays at the f32 tolerance."""
    norm = "instance_anchored"
    inputs = _model_inputs(seed=11)
    v = _jax_variables(norm, inputs)
    state = state_dict_from_flax(v)
    j32 = _run_jax(v, inputs, norm)
    j16 = _run_jax(v, inputs, norm, dtype=jnp.bfloat16, decoder="pallas")
    t16 = _run_port(state, inputs, norm, dtype=torch.bfloat16, decoder="cuda")
    for s in range(STAGES):
        own = np.abs(j16[s][2] - j32[s][2]).max()
        gap = np.abs(t16[s][2] - j16[s][2]).max()
        assert np.isfinite(t16[s][2]).all()
        assert gap <= 2 * own, (s, gap, own)
        assert own < 0.5, (s, own)  # the bound itself stays meaningful


@pytest.mark.parametrize("norm_method", ["instance", "instance_anchored", "batch"])
def test_bridge_round_trips_through_convert_state_dict(norm_method):
    """convert_state_dict(port state dict) gives back the JAX params exactly
    (and BatchNorm's statistics); the port loads the bridge's state dict strictly."""
    inputs = _model_inputs(b=1)
    v = _jax_variables(norm_method, inputs)
    state = state_dict_from_flax(v)
    pm = PortModel(J, stage=STAGES, features=FEATURES, level=LEVEL, norm_method=norm_method)
    assert set(pm.state_dict()) == set(state)
    pm.load_state_dict(state)
    anchors = ("anchor", "anchor_n")
    back = convert_state_dict({k: t for k, t in state.items() if not k.endswith(anchors)})
    collections = ["params"] + (["batch_stats"] if norm_method == "batch" else [])
    for c in collections:
        assert jax.tree.structure(back[c]) == jax.tree.structure(v[c])
        for a, b in zip(jax.tree.leaves(back[c]), jax.tree.leaves(v[c])):
            np.testing.assert_array_equal(a, np.asarray(b))
    if norm_method == "instance_anchored":
        assert sum(k.endswith(".anchor") for k in state) == len(jax.tree.leaves(v["batch_stats"])) // 2


def test_state_dict_without_anchors_runs_the_two_pass_form():
    """A reference-style state dict (no anchors) loaded into an anchored model
    leaves the anchors absent and runs the exact two-pass norm: the same
    output as the `instance` model, as the JAX package falls back."""
    norm = "instance_anchored"
    inputs = _model_inputs(seed=12)
    v = _jax_variables(norm, inputs)
    state = {k: t for k, t in state_dict_from_flax(v).items()
             if not k.endswith(("anchor", "anchor_n"))}
    pm = PortModel(J, stage=STAGES, features=FEATURES, level=LEVEL, norm_method=norm)
    pm.load_state_dict(state)
    assert pm.conv[1].anchor is None and "conv.1.anchor" not in pm.state_dict()
    got = _run_port(state, inputs, norm)
    two_pass = _run_port(state, inputs, "instance")
    for a, b in zip(got, two_pass):
        np.testing.assert_array_equal(a[2], b[2])
    # JAX with params only takes its own two-pass fallback
    want = _run_jax({"params": v["params"]}, inputs, norm)
    np.testing.assert_allclose(got[-1][2], want[-1][2], rtol=1e-3, atol=2e-5)
    # loading a state dict with anchors brings them back
    pm.load_state_dict(state_dict_from_flax(v))
    assert pm.conv[1].anchor is not None and float(pm.conv[1].anchor_n) > 0
