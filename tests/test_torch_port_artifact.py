"""The port's serving artifact (``serve_artifact.py``), the decoder as a
registered operator, and ``serve.Predictor``'s defaults and int8
calibration (counterparts of ``tests/test_serve.py``'s artifact and
quant cases), on the CPU.

A round trip is exact: the artifact runs the live ``Predictor``'s own
serving function, exported (f32, the same operators on the same inputs).
"""

import inspect
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import jax.numpy as jnp

from pixelwiseregression_tpu.serve import Predictor as JaxPredictor
from pixelwiseregression_tpu.serve_artifact import ServingArtifact as JaxArtifact
from pixelwiseregression_tpu.serve_artifact import export_artifact as jax_export

from pixelwiseregression_tpu_torch.models import layers as tl
from pixelwiseregression_tpu_torch.models.pixelwise import PixelwiseRegression
from pixelwiseregression_tpu_torch.ops import cuda_softargmax as tcs
from pixelwiseregression_tpu_torch.ops.softargmax import soft_argmax_decode_flat
from pixelwiseregression_tpu_torch.serve import Predictor
from pixelwiseregression_tpu_torch.serve_artifact import ServingArtifact, export_artifact

import torch_port_threads
from torch_port_threads import one_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = dict(stages=1, features=16, level=1, label_size=32)


def _blob_frame(cu, cv, z, h=240, w=320):
    frame = np.zeros((h, w), np.float64)
    yy, xx = np.mgrid[0:h, 0:w]
    r2 = ((xx - cu) / 40.0) ** 2 + ((yy - cv) / 40.0) ** 2
    frame[r2 < 1] = z + 30 * (r2[r2 < 1] - 0.5)
    return frame


FRAMES = np.stack([_blob_frame(160, 120, 400), _blob_frame(170, 110, 420),
                   _blob_frame(150, 130, 380)])
COMS = np.array([[160.0, 120.0, 400.0], [170.0, 110.0, 420.0], [150.0, 130.0, 380.0]])


@pytest.fixture(scope="module")
def state():
    torch.manual_seed(0)
    return PixelwiseRegression(21, stage=1, features=16, level=1).state_dict()


def _pred(state, batch_size=4, **kw):
    return Predictor.from_state_dict(state, "MSRA", "cpu", batch_size=batch_size, **ARCH, **kw)


@pytest.fixture(scope="module")
def exported(state, tmp_path_factory):
    """The f32 Predictor (K1's decoder, batch 4), its artifact's path and header."""
    pred = _pred(state)
    path = str(tmp_path_factory.mktemp("artifact") / "msra.pwrsrv")
    return pred, path, export_artifact(pred, path)


# --------------------------------------------------------------------------- #
# the decoder operator
# --------------------------------------------------------------------------- #


def _rows(dtype, seed=0, b=3, j=4, h=8, w=8):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, j, h * w, generator=g).to(dtype)
    dm = torch.randn(b, j, h * w, generator=g).to(dtype)
    label = torch.rand(b, 1, h * w, generator=g).to(dtype)
    mask = (label > 0.3).to(dtype)
    return x, dm, label, mask, torch.rand(j, generator=g) + 0.5


@pytest.mark.parametrize("dtype,hm_dtype", [(torch.float32, torch.float32),
                                            (torch.bfloat16, torch.bfloat16),
                                            (torch.bfloat16, torch.float32)])
def test_softargmax_op_on_the_cpu_is_the_plain_decoder(dtype, hm_dtype):
    """``torch.ops.pwr.softargmax_fwd`` on CPU tensors equals the plain
    decoder bit for bit (heatmaps cast to ``hm_dtype``) and launches nothing."""
    x, dm, label, mask, w = _rows(dtype)
    before = tcs.LAUNCHES
    hm, uvd = torch.ops.pwr.softargmax_fwd(x, dm, label, mask, w, 8, 8, hm_dtype)
    want_hm, want_uvd = soft_argmax_decode_flat(x, dm, label, mask, w, 8, 8)
    assert tcs.LAUNCHES == before
    assert hm.dtype == hm_dtype and uvd.dtype == torch.float32
    assert torch.equal(hm, want_hm.to(hm_dtype)) and torch.equal(uvd, want_uvd)


def test_softargmax_op_fake_shapes():
    """The operator's fake implementation (what ``torch.export`` traces)
    gives heatmaps ``[B, J, H*W]`` in ``hm_dtype`` and uvd ``[B, J, 3]`` f32,
    without touching data."""
    x, dm, label, mask, w = _rows(torch.bfloat16, b=5, j=14, h=16, w=16)
    with FakeTensorMode() as mode:
        args = [mode.from_tensor(t) for t in (x, dm, label, mask, w)]
        hm, uvd = torch.ops.pwr.softargmax_fwd(*args, 16, 16, torch.bfloat16)
    assert hm.shape == (5, 14, 256) and hm.dtype == torch.bfloat16
    assert uvd.shape == (5, 14, 3) and uvd.dtype == torch.float32


def test_exported_program_calls_the_decoder_operator(state, exported, tmp_path):
    """The kernel decoder is one operator node a stage in the exported
    program, never the plain decoder's ops; ``decoder="torch"`` has none."""
    plain = str(tmp_path / "plain.pwrsrv")
    export_artifact(_pred(state, decoder="torch"), plain)
    for path, want in ((exported[1], 1), (plain, 0)):
        graph = ServingArtifact.load(path)._program.graph
        ops = [n for n in graph.nodes if n.op == "call_function"]
        assert sum(n.target is torch.ops.pwr.softargmax_fwd.default for n in ops) == want
        assert any("softmax" in str(n.target) for n in ops) == (want == 0)


# --------------------------------------------------------------------------- #
# Predictor
# --------------------------------------------------------------------------- #


def test_predictor_defaults_are_the_jax_from_checkpoint_defaults(state):
    """``from_state_dict`` and ``from_checkpoint`` default to the two-pass
    ``instance`` norm and f32 (JAX ``Predictor.from_checkpoint``'s
    ``"instance"`` and ``dtype=None`` -> f32), with the K1 decoder, the
    port's counterpart of both JAX decoders."""
    port = inspect.signature(Predictor.from_state_dict).parameters
    jaxp = inspect.signature(JaxPredictor.from_checkpoint).parameters
    assert port["norm_method"].default == jaxp["norm_method"].default == "instance"
    assert port["dtype"].default == torch.float32 and jaxp["dtype"].default is None
    assert port["decoder"].default == "cuda" and jaxp["decoder"].default in ("xla", "pallas")
    for name in ("batch_size", "stages", "features", "level", "label_size", "heatmap_method",
                 "filter_size", "quant", "quant_calib_batches"):
        assert port[name].default == jaxp[name].default, name
    model = _pred(state).model
    assert model.dtype == torch.float32 and model.norm_method == "instance"
    assert model.stages[0].decoder == "cuda" and model.quant is None


def test_predictor_static_quant_calibrates_then_freezes(state):
    """(JAX ``test_predictor_static_quant_autocalibrates``.) ``quant=
    "int8_static"``: the first ``quant_calib_batches`` predict calls raise
    the scales, later calls leave them and repeat their answers exactly;
    uv within 20 px of the f32 predictor (quant noise on an untrained net)."""
    f32 = _pred(state).predict(FRAMES, COMS)
    pq = _pred(state, quant="int8_static", quant_calib_batches=2)
    scales = tl.quant_scales(pq.model)
    assert pq.calib_left == 2 and all(float(s.abs().max()) == 0 for s in scales.values())
    pq.predict(FRAMES[:1], COMS[:1])
    first = {k: s.clone() for k, s in scales.items()}
    assert pq.calib_left == 1 and all(float(s.max()) > 0 for s in first.values())
    out = pq.predict(FRAMES, COMS)
    assert pq.calib_left == 0
    assert any(not torch.equal(first[k], s) for k, s in scales.items())
    frozen = {k: s.clone() for k, s in scales.items()}
    again = pq.predict(FRAMES, COMS)
    assert all(torch.equal(frozen[k], s) for k, s in scales.items())
    np.testing.assert_array_equal(again["uvd"], out["uvd"])
    assert np.isfinite(out["uvd"]).all()
    assert np.abs(out["uvd"][..., :2] - f32["uvd"][..., :2]).max() < 20


# --------------------------------------------------------------------------- #
# the artifact
# --------------------------------------------------------------------------- #


def test_artifact_roundtrip_matches_predictor(exported, tmp_path):
    """export_artifact -> ServingArtifact.load reproduces the live
    Predictor's uvd and xyz exactly (f32, CPU), pads a partial request like
    the live path, writes the header, and refuses a corrupt file."""
    pred, path, header = exported
    assert header == {"dataset": "MSRA", "batch_size": 4, "frame_h": 240, "frame_w": 320,
                      "joint_number": 21, "device": "cpu", "format": "torch.export",
                      "torch_version": torch.__version__,
                      "batch_fields": ["bbox", "box_size", "com", "com_int", "crop_left",
                                       "crop_top", "cube", "frame"]}
    art = ServingArtifact.load(path)
    assert art.header == header and art.device == torch.device("cpu")
    live, out = pred.predict(FRAMES, COMS), art.predict(FRAMES, COMS)
    np.testing.assert_array_equal(out["uvd"], live["uvd"])
    np.testing.assert_array_equal(out["xyz"], live["xyz"])
    one = art.predict(FRAMES[:1], COMS[:1])
    np.testing.assert_array_equal(one["uvd"][0], pred.predict(FRAMES[:1], COMS[:1])["uvd"][0])
    with pytest.raises(ValueError, match="request size"):
        art.predict(np.concatenate([FRAMES, FRAMES]), np.concatenate([COMS, COMS]))

    bad = tmp_path / "bad.pwrsrv"
    bad.write_bytes(b"NOTANART" + b"\0" * 64)
    with pytest.raises(ValueError, match="bad magic"):
        ServingArtifact.load(str(bad))


def test_artifact_export_guards(state, tmp_path):
    """A static int8 predictor with calibration batches pending refuses to
    export (it would bake zero scales); once calibrated, it exports, and the
    artifact answers as the frozen predictor does (exactly). A
    data-parallel predictor refuses to export, as in JAX."""
    dp = Predictor.from_state_dict(state, "MSRA", "cpu", batch_size=2, data_parallel=True,
                                   devices=["cpu", "cpu"], **ARCH)
    with pytest.raises(ValueError, match="data_parallel"):
        export_artifact(dp, str(tmp_path / "dp.pwrsrv"))
    pq = _pred(state, batch_size=2, quant="int8_static", quant_calib_batches=2)
    with pytest.raises(ValueError, match="calibration batches pending"):
        export_artifact(pq, str(tmp_path / "q.pwrsrv"))
    for _ in range(2):
        pq.predict(FRAMES[:2], COMS[:2])
    export_artifact(pq, str(tmp_path / "q.pwrsrv"))
    art = ServingArtifact.load(str(tmp_path / "q.pwrsrv"))
    np.testing.assert_array_equal(art.predict(FRAMES[1:], COMS[1:])["uvd"],
                                  pq.predict(FRAMES[1:], COMS[1:])["uvd"])


def test_artifact_poly_batch(state, tmp_path):
    """``poly_batch=True``: a symbolic batch (header ``batch_size`` null);
    requests of 3 and 1 run unpadded and equal a live Predictor of that
    batch size exactly."""
    pred = _pred(state)
    path = str(tmp_path / "poly.pwrsrv")
    assert export_artifact(pred, path, poly_batch=True)["batch_size"] is None
    art = ServingArtifact.load(path)
    for n in (3, 1):
        want = _pred(state, batch_size=n).predict(FRAMES[:n], COMS[:n])["uvd"]
        np.testing.assert_array_equal(art.predict(FRAMES[:n], COMS[:n])["uvd"], want)


def test_artifact_loads_without_the_model_code(exported, tmp_path):
    """A fresh process that blocks imports of the port's models, its
    ``serve`` module, jax and flax loads the artifact and predicts what the
    live Predictor predicts (on one thread in both, so that the sums run in
    one order)."""
    pred, path, _ = exported
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        expect = pred.predict(FRAMES[:1], COMS[:1])["uvd"]
    finally:
        torch.set_num_threads(threads)
    script = f"""
import sys

class _Block:
    BLOCKED = ("jax", "flax", "pixelwiseregression_tpu", "pixelwiseregression_tpu_torch.models",
               "pixelwiseregression_tpu_torch.serve")
    def find_spec(self, name, *a, **k):
        if name in self.BLOCKED or any(name.startswith(b + ".") for b in self.BLOCKED):
            raise ImportError(f"BLOCKED at serving time: {{name}}")
        return None

sys.meta_path.insert(0, _Block())
import numpy as np, torch
torch.set_num_threads(1)
from pixelwiseregression_tpu_torch.serve_artifact import ServingArtifact
art = ServingArtifact.load({path!r}, "cpu")
frames, coms = np.load({str(tmp_path / 'in.npz')!r}).values()
np.save({str(tmp_path / 'out.npy')!r}, art.predict(frames, coms)["uvd"])
"""
    np.savez(tmp_path / "in.npz", frames=FRAMES[:1], coms=COMS[:1])
    r = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                       timeout=300, cwd=REPO, env=torch_port_threads.env())
    assert r.returncode == 0, r.stderr[-3000:]
    np.testing.assert_array_equal(np.load(tmp_path / "out.npy"), expect)


def test_jax_artifact_is_refused_by_its_header(tmp_path, exported):
    """A JAX package's ``.pwrsrv`` (same magic, a ``jax.export`` payload;
    written by the JAX package's own ``export_artifact``, here for a
    predictor whose serving function is a stand-in, since the loader reads
    the header) is refused by the port's loader with an error naming both
    formats; the port's header says ``torch.export``, and the JAX loader
    refuses the port's artifact."""
    import types

    from pixelwiseregression_tpu.data.sources import SPECS as JAX_SPECS

    stand_in = types.SimpleNamespace(
        spec=JAX_SPECS["MSRA"], batch_size=1, variables={}, _calibrate=None, _calib_left=0,
        model=types.SimpleNamespace(decoder="xla"),
        _infer=lambda variables, batch: jnp.zeros((batch["frame"].shape[0], 21, 3)))
    jpath = str(tmp_path / "jax.pwrsrv")
    assert "jax_version" in jax_export(stand_in, jpath, platforms=("cpu",))
    with pytest.raises(ValueError, match=r"jax\.export \(StableHLO\).*torch\.export"):
        ServingArtifact.load(jpath)

    header = exported[2]
    assert header["format"] == "torch.export" and "platforms" not in header
    with pytest.raises(Exception):
        JaxArtifact.load(exported[1])


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.uint16])
def test_host_batch_equals_the_jax_packages_float64_round_trip(dtype):
    """The host batch casts each frame to float32 once; the JAX package's
    ``_build_batch`` goes through float64 first, which rounds to the same
    float32 numbers for float32, float64 and integer frames."""
    from pixelwiseregression_tpu.serve_artifact import _build_batch as jax_build_batch

    from pixelwiseregression_tpu_torch.data.sources import SPECS
    from pixelwiseregression_tpu_torch.serve_artifact import _build_batch

    spec = SPECS["NYU"]
    rng = np.random.RandomState(4)
    frames = rng.uniform(0, 3000, (3, spec.frame_h, spec.frame_w))
    frames = (frames.astype(np.float32) if dtype == np.float32 else
              frames if dtype == np.float64 else frames.astype(np.uint16))
    coms = np.array([[320.5, 240.25, 600.0], [100.0, 50.0, 450.5], [600.0, 400.0, 900.0]])
    got, n = _build_batch(spec, 4, frames, coms, None)
    want, m = jax_build_batch(spec, 4, frames, coms, None)
    assert n == m == 3 and set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
        assert got[k].dtype == np.asarray(want[k]).dtype, k
