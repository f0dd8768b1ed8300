"""PyTorch port vs the JAX package: the fused inference engines
(``models/infer_engine.py``) on the same weights and inputs.

The JAX engines run their Pallas kernels in interpret mode under
``jax.jit``, at the sizes of tests/test_infer_engine.py (5 joints, 16x16
labels, batch 3); their variables go into the port through
``compat.flax_bridge.state_dict_from_flax``. The port's engines run on the
CPU, so their kernels take the plain versions. Each JAX reference is
computed once per module.

Tolerances: in f32 the two compute the same function in another order of
sums, which some 40 instance norms amplify: stage 1 is held to 1e-4 of each
output's largest magnitude (measured up to 5.4e-5, on the heatmaps of the
unit engine); stage 2 is fed by stage 1's heatmaps and amplifies further
(measured up to 3.2e-3 of the scale), so it is held to the JAX golden
tests' stage-2 bounds (tests/test_infer_engine.py:60-67). In bf16 uvd is
held to the JAX engine tests' bounds (0.05 for the unit engine, 0.02 for
the fused one, :77-80, :117-120; measured 0.043 and 0.018).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pixelwiseregression_tpu.models import PixelwiseRegression as JaxModel
from pixelwiseregression_tpu.models import infer_engine as jengine

from pixelwiseregression_tpu_torch.compat.flax_bridge import state_dict_from_flax
from pixelwiseregression_tpu_torch.models import infer_engine as tengine
from pixelwiseregression_tpu_torch.models.pixelwise import PixelwiseRegression as PortModel
from pixelwiseregression_tpu_torch.ops import cuda_fused, cuda_hourglass, cuda_softargmax

from torch_port_threads import one_thread  # noqa: F401 (autouse)

JOINTS = 5

# name: (engine, stages, level, features, dtype), as tests/test_infer_engine.py builds them
CASES = {
    "unit_f32": ("unit", 2, 2, 64, "float32"),
    "unit_bf16": ("unit", 1, 1, 64, "bfloat16"),
    "fused_f32": ("fused", 2, 2, 32, "float32"),
    "fused_bf16": ("fused", 1, 1, 32, "bfloat16"),
}


def _inputs(b=3):
    rng = np.random.RandomState(0)
    return (rng.randn(b, 32, 32, 1).astype(np.float32), rng.randn(b, 16, 16, 1).astype(np.float32),
            (rng.rand(b, 16, 16, 1) > 0.3).astype(np.float32))


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def _port_model(state, stages, level, features, dtype, norm_method="instance"):
    model = PortModel(JOINTS, stage=stages, features=features, level=level,
                      norm_method=norm_method, decoder="cuda", dtype=getattr(torch, dtype))
    model.load_state_dict(state)
    return model.eval()


def _nhwc_stage(stage):
    """(heatmaps, depthmaps) NCHW -> NHWC numpy f32, uvd as it is."""
    hm, dm, uvd = stage
    return tuple(np.transpose(t.float().numpy(), (0, 2, 3, 1)) for t in (hm, dm)) + (
        uvd.float().numpy(),)


@pytest.fixture(scope="module")
def cases():
    """Per case: the port model on the JAX weights and the JAX engine's outputs."""
    img, label, mask = (jnp.asarray(a) for a in _inputs())
    out = {}
    for name, (engine, stages, level, features, dtype) in CASES.items():
        jm = JaxModel(joints=JOINTS, stage=stages, label_size=16, features=features, level=level,
                      norm_method="instance", heatmap_method="softmax", decoder="xla",
                      dtype=getattr(jnp, dtype))
        v = jax.device_get(jax.jit(lambda k: jm.init(k, img, label, mask, train=False))(
            jax.random.PRNGKey(0)))
        if engine == "unit":
            fn = jengine.make_unit_fused_apply(jm, v, min_res=4)
        else:
            fn = jengine.make_fused_apply(jm, v)
        want = [tuple(np.asarray(t, np.float32) for t in s) for s in jax.jit(fn)(img, label, mask)]
        model = _port_model(state_dict_from_flax(v), stages, level, features, dtype)
        out[name] = (model, want)
    return out


def _port_engine(model, engine):
    if engine == "unit":
        return tengine.make_unit_fused_apply(model, min_res=4)
    return tengine.make_fused_apply(model)


def _rel(got, want):
    return float(np.abs(got - want).max()) / float(np.abs(want).max())


@pytest.mark.parametrize("name", list(CASES))
def test_engine_matches_the_jax_engine(cases, name):
    """The three outputs of every stage, against the JAX engine on the same
    weights and inputs (tolerances in the module docstring). The port's
    kernels run once per unit or hourglass, the decoder once per stage."""
    engine, stages, _, _, dtype = CASES[name]
    model, want = cases[name]
    counter = cuda_fused if engine == "unit" else cuda_hourglass
    before = (counter.LAUNCHES, cuda_softargmax.LAUNCHES)
    got = _port_engine(model, engine)(*(_nchw(a) for a in _inputs()))
    # CPU tensors: the plain versions ran, no kernel was launched
    assert (counter.LAUNCHES, cuda_softargmax.LAUNCHES) == before
    assert len(got) == len(want) == stages
    for s, (g, w) in enumerate(zip(got, want)):
        hm, dm, uvd = _nhwc_stage(g)
        assert hm.shape == w[0].shape and dm.shape == w[1].shape and uvd.shape == w[2].shape
        assert np.isfinite(uvd).all()
        print(f"{name} stage {s + 1}: (heatmaps, depthmaps, uvd) gaps relative to their scale "
              f"{[f'{_rel(a, b):.2e}' for a, b in zip((hm, dm, uvd), w)]}, uvd largest "
              f"{float(np.abs(uvd - w[2]).max()):.3e}")
        if dtype == "float32" and s == 0:
            for label, a, b in (("heatmaps", hm, w[0]), ("depthmaps", dm, w[1]), ("uvd", uvd, w[2])):
                assert _rel(a, b) <= 1e-4, (label, _rel(a, b))
        elif dtype == "float32":
            np.testing.assert_allclose(uvd, w[2], atol=5e-3, rtol=1e-3)
            np.testing.assert_allclose(hm, w[0], atol=1e-3, rtol=1e-3)
            np.testing.assert_allclose(dm, w[1], atol=2e-2, rtol=2e-2)
        else:
            bound = 0.05 if engine == "unit" else 0.02
            np.testing.assert_allclose(uvd, w[2], atol=bound, rtol=bound)


@pytest.mark.parametrize("engine", ["unit", "fused"])
def test_engine_matches_the_port_model(cases, engine):
    """Each port engine against the port's own ``PixelwiseRegression``
    forward (eval mode, instance norm), f32, 2 stages: uvd and heatmaps at
    the JAX golden tests' bounds (tests/test_infer_engine.py:60-67; stage 2
    looser, its input holds stage 1's softmax heatmaps), depth maps at 1e-3
    and 2e-2. The fused engine's K4 applies its norms as the model does in
    f32, so the two differ only in the order of their sums."""
    model, _ = cases[f"{engine}_f32"]
    inputs = [_nchw(a) for a in _inputs()]
    got = _port_engine(model, engine)(*inputs)
    with torch.inference_mode():
        want = model(*inputs)
    for s, (g, w) in enumerate(zip(got, want)):
        (hm, dm, uvd), (hm_r, dm_r, uvd_r) = _nhwc_stage(g), _nhwc_stage(w)
        map_tol = 1e-3 if s == 0 else 2e-2
        np.testing.assert_allclose(uvd, uvd_r, atol=5e-4 if s == 0 else 5e-3, rtol=1e-3)
        np.testing.assert_allclose(hm, hm_r, atol=1e-4 if s == 0 else 1e-3, rtol=1e-3)
        np.testing.assert_allclose(dm, dm_r, atol=map_tol, rtol=map_tol)


def test_engines_reject_unsupported_models():
    """As the JAX builders: instance norm only (batch and the anchored and
    one-pass instance norms raise), and kernel_size 3 only for the unit engine."""
    def model(**kw):
        return PortModel(JOINTS, stage=1, features=32, level=1, **kw)

    for norm in ("batch", "instance_anchored", "instance_fast"):
        for make in (tengine.make_unit_fused_apply, tengine.make_fused_apply):
            with pytest.raises(ValueError, match="instance norm"):
                make(model(norm_method=norm))
    with pytest.raises(ValueError, match="kernel_size"):
        tengine.make_unit_fused_apply(model(kernel_size=5))
    tengine.make_fused_apply(model(kernel_size=5))  # the fused engine's heads stay plain
