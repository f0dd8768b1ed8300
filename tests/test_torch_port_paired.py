"""PyTorch port vs the JAX package: the paired heads and the parity tool.

The paired heads (``models/paired_heads.py``) against the port's own plain
heads on one state dict, for every norm and every ``mid/final`` form (the
port's counterpart of tests/test_paired_heads.py), against the JAX
package's paired model on the same weights, and their fallbacks; the
paired-heads A/B tool on the CPU. Then ``compat/verify_parity.py``: its mm
arithmetic against the JAX tool's, its comparison with the JAX model
standing in as the reference, and its entry point. Each comparison states
its tolerance.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pixelwiseregression_tpu.compat.torch_ckpt import convert_state_dict
from pixelwiseregression_tpu.models import PixelwiseRegression as JaxModel

from pixelwiseregression_tpu_torch.cli.check_dataset import build_dataset
from pixelwiseregression_tpu_torch.compat import verify_parity
from pixelwiseregression_tpu_torch.compat.flax_bridge import state_dict_from_flax
from pixelwiseregression_tpu_torch.data.sources import SPECS
from pixelwiseregression_tpu_torch.models.pixelwise import PixelwiseRegression as PortModel
from pixelwiseregression_tpu_torch.tools import bench_paired_model
from pixelwiseregression_tpu_torch.train.checkpoint import save_checkpoint

from test_torch_port_cli import FIXTURE
import torch_port_threads
from torch_port_threads import one_thread  # noqa: F401 (autouse)

J, S, F = 5, 32, 32
FORMS = [("separate", "blockdiag"), ("grouped", "blockdiag"), ("grouped", "separate"),
         ("separate", "separate")]


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def _nhwc(t):
    return np.transpose(t.float().numpy(), (0, 2, 3, 1))


def _inputs(b=2):
    """tests/test_paired_heads.py's inputs."""
    rng = np.random.RandomState(0)
    img = rng.rand(b, 2 * S, 2 * S, 1).astype(np.float32)
    label = rng.rand(b, S, S, 1).astype(np.float32)
    mask = (rng.rand(b, S, S, 1) > 0.3).astype(np.float32)
    return img, label, mask


def _jax(norm, **kw):
    return JaxModel(joints=J, stage=2, label_size=S, features=F, level=2, norm_method=norm,
                    heatmap_method="softmax", decoder="xla", **kw)


_VARS = {}


def _variables(norm):
    """JAX variables of the port's init from a seed (``convert_state_dict``);
    anchored: the anchors calibrated by two JAX applies (nonzero, anchor_n
    2), as a trained model carries them."""
    if norm not in _VARS:
        inputs = _inputs()
        torch.manual_seed(0)
        state = PortModel(J, stage=2, features=F, level=2, norm_method=norm).state_dict()
        # the norms' scales and biases (and the convs' biases) drawn away from
        # their init, so that each head's own reaches the output
        rng = np.random.RandomState(1)
        for name, t in state.items():
            if t.dim() == 1 and name.endswith((".weight", ".bias")):
                noise = torch.from_numpy(0.1 * rng.randn(*t.shape).astype(np.float32))
                state[name] = t * (1 + noise) if name.endswith(".weight") else t + noise
        v = jax.device_get(convert_state_dict(
            {k: t for k, t in state.items() if not k.endswith(("anchor", "anchor_n"))}))
        if norm == "instance_anchored":
            jm = _jax(norm)
            shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *inputs,
                                                    train=False))
            v["batch_stats"] = jax.tree.map(lambda t: np.zeros(t.shape, t.dtype),
                                            shapes["batch_stats"])
            calibrate = jax.jit(lambda v: jm.apply(v, *inputs, train=False,
                                                   mutable=["batch_stats"])[1])
            for _ in range(2):
                v = {"params": v["params"], **jax.device_get(calibrate(v))}
        _VARS[norm] = v
    return _VARS[norm]


def _port(state, norm, **kw):
    model = PortModel(J, stage=2, features=F, level=2, norm_method=norm, decoder="cuda", **kw)
    model.load_state_dict(state)
    return model.eval()


def _run(model):
    with torch.no_grad():
        out = model(*(_nchw(a) for a in _inputs()))
    return [(_nhwc(hm), _nhwc(dm), uvd.numpy()) for hm, dm, uvd in out]


@pytest.mark.parametrize("norm", ["instance", "instance_fast", "instance_anchored"])
def test_paired_equals_the_plain_heads(norm):
    """On one state dict, every form: final=separate is bit-equal to the
    plain heads (each output channel's contraction in the same order);
    blockdiag within uvd atol 2e-5 and maps atol 1e-4 (rtol 1e-2), the
    bounds of tests/test_paired_heads.py (the larger-K conv may reassociate
    its nonzero terms). The paired path is taken on every stage."""
    state = state_dict_from_flax(_variables(norm))
    ref = _run(_port(state, norm))
    for mid, final in FORMS:
        model = _port(state, norm, paired_heads=True, paired_mid=mid, paired_final=final)
        assert all(block.use_paired() for block in model.stages)
        got = _run(model)
        for stage, (r, g) in enumerate(zip(ref, got)):
            for name, a, b in zip(("heatmaps", "depthmaps", "uvd"), r, g):
                msg = f"stage {stage} {name} ({norm}, {mid}, {final})"
                if final == "separate":
                    np.testing.assert_array_equal(b, a, err_msg=msg)
                else:
                    np.testing.assert_allclose(b, a, rtol=1e-2,
                                               atol=2e-5 if name == "uvd" else 1e-4,
                                               err_msg=msg)


@pytest.mark.parametrize("norm,mid,final", [("instance_anchored", "grouped", "blockdiag"),
                                            ("instance", "separate", "separate")])
def test_paired_matches_the_jax_paired_model(norm, mid, final):
    """The port's paired model vs the JAX package's paired model on the same
    weights, f32: uvd rtol 1e-3 atol 2e-5, heatmaps rtol 1e-3 atol 1e-5,
    depth maps atol 1e-3 (tests/test_torch_port_model.py's bounds)."""
    v = _variables(norm)
    kw = dict(paired_heads=True, paired_mid=mid, paired_final=final)
    inputs = _inputs()
    want = jax.jit(lambda v: _jax(norm, **kw).apply(v, *inputs, train=False))(v)
    got = _run(_port(state_dict_from_flax(v), norm, **kw))
    for (hm_t, dm_t, uvd_t), (hm_j, dm_j, uvd_j) in zip(got, want):
        np.testing.assert_allclose(hm_t, np.asarray(hm_j), rtol=1e-3, atol=1e-5)
        np.testing.assert_allclose(dm_t, np.asarray(dm_j), rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(uvd_t, np.asarray(uvd_j), rtol=1e-3, atol=2e-5)


def test_paired_falls_back_in_training_quant_and_without_calibrated_anchors():
    """The plain heads run (JAX ``use_paired`` false) in train mode (where
    the anchors' EMA moves through the head modules), under quant and with
    batch norms. Uncalibrated anchors (a fresh model's, anchor_n 0) and a
    state dict without anchors take the paired path, as JAX's
    ``use_paired`` does, and agree with the plain heads on the same state
    dict within the blockdiag bounds of ``test_paired_equals_the_plain_heads``
    (the paired norms read the anchors as the plain norms do)."""
    norm = "instance_anchored"
    v = _variables(norm)
    state = state_dict_from_flax(v)
    kw = dict(paired_heads=True, paired_mid="grouped", paired_final="blockdiag")
    model = _port(state, norm, **kw)
    assert model.stages[1].use_paired()
    model.train()
    assert not model.stages[1].use_paired()
    n_before = float(model.stages[0].plane_regression.conv[1].anchor_n)
    with torch.no_grad():
        model(*(_nchw(a) for a in _inputs()))
    assert float(model.stages[0].plane_regression.conv[1].anchor_n) == n_before + 1

    quant = _port(state, norm, quant="int8", **kw)
    assert not any(b.use_paired() for b in quant.stages)
    batch = PortModel(J, stage=1, features=F, level=2, norm_method="batch", **kw).eval()
    assert not batch.stages[0].use_paired()

    torch.manual_seed(1)
    fresh = PortModel(J, stage=2, features=F, level=2, norm_method=norm).state_dict()
    assert float(fresh["stages.0.plane_regression.conv.1.anchor_n"]) == 0
    no_anchors = {k: t for k, t in state.items() if not k.endswith(("anchor", "anchor_n"))}
    for sd in (fresh, no_anchors):
        paired = _port(sd, norm, **kw)
        assert all(b.use_paired() for b in paired.stages)
        for r, g in zip(_run(_port(sd, norm)), _run(paired)):
            for name, a, b in zip(("heatmaps", "depthmaps", "uvd"), r, g):
                np.testing.assert_allclose(b, a, rtol=1e-2,
                                           atol=2e-5 if name == "uvd" else 1e-4, err_msg=name)


def test_bench_paired_model_runs_every_variant_on_the_cpu(capsys):
    """The A/B tool at batch 2 on the CPU (its plain versions): every
    variant of both stage counts timed and printed, none launching a kernel."""
    out = bench_paired_model.main(["--device", "cpu", "--batch", "2", "--iters", "1",
                                   "--rounds", "1", "--features", "16", "--level", "1"])
    assert set(out) == {1, 2}
    for res in out.values():
        assert set(res["fps"]) == set(bench_paired_model.VARIANTS)
        assert all(f > 0 for f in res["fps"].values()) and res["launches"] == {}
    assert "stage 2 grp/blockdiag" in capsys.readouterr().out


# --------------------------------------------------------------------------- #
# compat/verify_parity.py
# --------------------------------------------------------------------------- #


def test_mm_conversion_is_the_jax_tools_arithmetic():
    """``to_mm`` on fixed deltas equals the JAX tool's inline conversion
    (``pixelwiseregression_tpu/compat/verify_parity.py``), exactly."""
    rng = np.random.RandomState(5)
    d = rng.randn(3, 14, 3).astype(np.float32) * 1e-4
    box = np.array([180.0, 150.0, 210.0])
    depth = np.array([600.0, 450.0, 700.0])
    cube = np.array([150.0, 150.0, 150.0])
    fx, fy = SPECS["NYU"].camera.fx, SPECS["NYU"].camera.fy
    # the JAX tool's lines, verbatim
    du_mm = np.abs(d[:, :, 0]) * (box[:, None] - 1) * depth[:, None] / float(fx)
    dv_mm = np.abs(d[:, :, 1]) * (box[:, None] - 1) * depth[:, None] / float(fy)
    dd_mm = np.abs(d[:, :, 2]) * cube[:, None]
    for got, want in zip(verify_parity.to_mm(d, box, depth, cube, fx, fy),
                         (du_mm, dv_mm, dd_mm)):
        np.testing.assert_array_equal(got, want)


def test_compare_with_the_jax_model_as_the_reference():
    """``compare`` with the JAX model (NCHW in, NHWC inside) standing in as
    the reference callable, and the port on the same weights: the worst
    per-joint delta passes the 0.1 mm gate on the JAX tool's synthetic
    crops (box 180, cube 150, depth 600)."""
    norm = "instance"
    v = _variables(norm)
    jm = _jax(norm)
    apply = jax.jit(lambda *xs: jm.apply(v, *xs, train=False))

    def reference(img, label, mask):
        return apply(*(jnp.asarray(np.transpose(t.numpy(), (0, 2, 3, 1)))
                       for t in (img, label, mask)))

    img, label, mask = (_nchw(a) for a in _inputs())
    d, ref, got = verify_parity.compare(reference, _port(state_dict_from_flax(v), norm),
                                        img, label, mask)
    assert d.shape == ref.shape == got.shape == (2, J, 3)
    n = len(d)
    du, dv, dd = verify_parity.to_mm(d, np.full(n, 180.0), np.full(n, 600.0),
                                     np.full(n, 150.0), SPECS["NYU"].camera.fx,
                                     SPECS["NYU"].camera.fy)
    worst = max(du.max(), dv.max(), dd.max())
    assert 0 < worst <= 0.1, worst


_FAKE_REFERENCE = '''
"""A stand-in for the reference checkout's model.py: the port's model under
the reference constructor's signature."""
from pixelwiseregression_tpu_torch.models.pixelwise import PixelwiseRegression as _Port


class PixelwiseRegression(_Port):
    def __init__(self, joints, stage=2, label_size=64, features=256, level=4,
                 norm_method="instance", heatmap_method="softmax", kernel_size=3):
        super().__init__(joints, stage=stage, features=features, level=level,
                         kernel_size=kernel_size, norm_method=norm_method,
                         heatmap_method=heatmap_method)
'''


def test_entry_point_gates_and_returns_2_without_a_reference(tmp_path, monkeypatch):
    """``main``: 2 when no reference is given or it cannot be imported; on a .pt whose
    model_param sets the architecture, 0 (a delta of 0 mm: the stand-in
    reference is the port's own model) on the synthetic crops and on the
    MSRA fixture's test frames (``--data_path``)."""
    torch.manual_seed(0)
    model = PortModel(21, stage=1, features=16, level=1)
    ckpt = str(tmp_path / "MSRA_x_final.pt")
    param = {"stage": 1, "features": 16, "level": 1, "label_size": 32,
             "norm_method": "instance", "heatmap_method": "softmax", "kernel_size": 3}
    save_checkpoint(ckpt, model, model_param=param)
    monkeypatch.delitem(sys.modules, "model", raising=False)
    monkeypatch.setattr(sys, "path", list(sys.path))
    with pytest.raises(SystemExit) as no_reference:
        verify_parity.main(["--ckpt", ckpt, "--dataset", "MSRA"])
    assert no_reference.value.code == 2
    empty = tmp_path / "empty"
    empty.mkdir()
    assert verify_parity.main(["--ckpt", ckpt, "--dataset", "MSRA",
                               "--reference", str(empty)]) == 2

    ref = tmp_path / "reference"
    ref.mkdir()
    (ref / "model.py").write_text(_FAKE_REFERENCE)
    monkeypatch.delitem(sys.modules, "model", raising=False)
    assert verify_parity.main(["--ckpt", ckpt, "--dataset", "MSRA", "--samples", "4",
                               "--reference", str(ref)]) == 0
    root = str(tmp_path / "msra")
    subprocess.run([sys.executable, FIXTURE, root], check=True, capture_output=True,
                   env=torch_port_threads.env())
    build_dataset("MSRA", root, torch.device("cpu"))
    assert verify_parity.main(["--ckpt", ckpt, "--dataset", "MSRA", "--samples", "4",
                               "--data_path", root, "--reference", str(ref)]) == 0
