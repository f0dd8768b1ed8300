"""The serving slice end to end: the port's Predictor vs the JAX package's
Predictor on the same weights and the same synthetic requests, and the
port's checkpoint loading."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pixelwiseregression_tpu.data.preprocess import PreprocessConfig, preprocess_batch
from pixelwiseregression_tpu.models import PixelwiseRegression as JaxModel
from pixelwiseregression_tpu.serve import Predictor as JaxPredictor
from pixelwiseregression_tpu.serve_artifact import _build_batch
from pixelwiseregression_tpu.train.checkpoint import save_checkpoint

from pixelwiseregression_tpu_torch.compat.flax_bridge import state_dict_from_flax
from pixelwiseregression_tpu_torch.data.sources import SPECS
from pixelwiseregression_tpu_torch.serve import Predictor
from pixelwiseregression_tpu_torch.utils.synth import make_synthetic_raw_batch

from torch_port_threads import one_thread  # noqa: F401 (autouse)

ARCH = dict(stages=2, features=16, level=2, label_size=32, norm_method="instance_anchored")
BATCH = 4


def _requests():
    spec = SPECS["MSRA"]
    out = []
    for i, n in enumerate((4, 3, 1)):
        raw = make_synthetic_raw_batch(n, spec.frame_h, spec.frame_w, spec.joint_number,
                                       fx=spec.camera.fx, fy=spec.camera.fy, cube=125.0,
                                       com_z=380.0 + 40.0 * i, seed=20 + i)
        coms = raw["com"].astype(np.float64) + np.random.RandomState(i).uniform(-4, 4, (n, 3))
        out.append((raw["frame"], coms))
    return out


@pytest.fixture(scope="module")
def jax_weights(tmp_path_factory):
    """JAX model variables from a seed, anchors calibrated on the requests' crops,
    saved as a JAX checkpoint."""
    spec = SPECS["MSRA"]
    model = JaxModel(joints=spec.joint_number, stage=ARCH["stages"], label_size=32,
                     features=ARCH["features"], level=ARCH["level"],
                     norm_method=ARCH["norm_method"])
    cfg = PreprocessConfig(fx=spec.camera.fx, fy=spec.camera.fy, halfu=spec.camera.halfu,
                           halfv=spec.camera.halfv, image_size=64, label_size=32)
    frames, coms = _requests()[0]
    batch, _ = _build_batch(spec, BATCH, frames, coms, None)
    data = preprocess_batch({k: jnp.asarray(v) for k, v in batch.items()},
                            jax.random.PRNGKey(0), cfg, test_only=True)
    args = (data["img"], data["label_img"], data["mask"])
    v = jax.device_get(model.init(jax.random.PRNGKey(3), *args, train=False))
    # one calibration step: the debiased anchors are then the batch means
    _, upd = model.apply(v, *args, train=False, mutable=["batch_stats"])
    v = {"params": v["params"], "batch_stats": jax.device_get(upd["batch_stats"])}
    path = str(tmp_path_factory.mktemp("serve") / "MSRA_port_final.ckpt")
    save_checkpoint(path, params=v["params"], batch_stats=v["batch_stats"])
    return v, path


def test_predictor_matches_jax_predictor(jax_weights):
    """f32, port decoder='torch' vs the JAX Predictor's XLA decoder on full and
    padded requests: uvd (px, mm) and xyz (mm) within atol 2e-2."""
    variables, path = jax_weights
    ref = JaxPredictor.from_checkpoint(path, "MSRA", batch_size=BATCH, **ARCH)
    port = Predictor.from_state_dict(state_dict_from_flax(variables), "MSRA", torch.device("cpu"),
                                     batch_size=BATCH, decoder="torch", dtype=torch.float32,
                                     **ARCH)
    for frames, coms in _requests():
        want = ref.predict(frames, coms)
        got = port.predict(frames, coms)
        assert got["uvd"].shape == want["uvd"].shape == (len(frames), 21, 3)
        assert got["uvd"].dtype == np.float32 and np.isfinite(got["uvd"]).all()
        np.testing.assert_allclose(got["uvd"], want["uvd"], rtol=0, atol=2e-2)
        np.testing.assert_allclose(got["xyz"], want["xyz"], rtol=0, atol=2e-2)


def test_padded_and_unpadded_requests_agree(jax_weights):
    """Rows of a padded request equal the same rows of a full one (f32, CPU):
    padding never reaches the returned rows. atol 1e-4 covers CPU conv
    reordering across batch sizes."""
    variables, _ = jax_weights
    port = Predictor.from_state_dict(state_dict_from_flax(variables), "MSRA", "cpu",
                                     batch_size=BATCH, decoder="cuda", dtype=torch.float32,
                                     **ARCH)
    frames, coms = _requests()[0]
    full = port.predict(frames, coms)
    for n in (1, 3):
        part = port.predict(frames[:n], coms[:n])
        assert part["uvd"].shape == (n, 21, 3)
        np.testing.assert_allclose(part["uvd"], full["uvd"][:n], rtol=0, atol=1e-4)
    with pytest.raises(ValueError, match="request size"):
        port.predict(np.concatenate([frames, frames]), np.concatenate([coms, coms]))


def test_from_checkpoint_reads_reference_format(jax_weights, tmp_path):
    """A torch.save'd {state_dict, model_param} file, with the reference's COM
    filter buffer in it, loads with the architecture it stores and predicts
    what the in-memory state dict predicts (exactly)."""
    variables, _ = jax_weights
    state = state_dict_from_flax(variables)
    kw = dict(batch_size=BATCH, decoder="torch", dtype=torch.float32)
    direct = Predictor.from_state_dict(state, "MSRA", "cpu", **kw, **ARCH)
    path = tmp_path / "MSRA_ref.pt"
    model_param = {"stage": 2, "features": 16, "level": 2, "label_size": 32,
                   "norm_method": "instance_anchored", "heatmap_method": "softmax",
                   "kernel_size": 3}
    filters = {f"stages.{s}.plane_regression.filter": torch.zeros(2, 32, 32) for s in range(2)}
    torch.save({"state_dict": {**state, **filters}, "seed": 0, "model_param": model_param}, path)
    loaded = Predictor.from_checkpoint(str(path), "MSRA", "cpu", **kw)
    frames, coms = _requests()[1]
    np.testing.assert_array_equal(loaded.predict(frames, coms)["uvd"],
                                  direct.predict(frames, coms)["uvd"])
