"""PyTorch port vs the JAX package: camera, host records, image ops,
preprocessing and the soft-argmax decoder.

Inputs are made with numpy from a seed and go through the JAX function and
its port counterpart; each comparison states its tolerance. The JAX Pallas
decoder runs in interpret mode on the CPU, as tests/test_pallas_decoder.py
runs it. The kernel's own tests on the card are in test_torch_port_cuda.py.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pixelwiseregression_tpu.core import camera as jcam
from pixelwiseregression_tpu.data import loader as jloader
from pixelwiseregression_tpu.data import preprocess as jpre
from pixelwiseregression_tpu.data import sources as jsrc
from pixelwiseregression_tpu.ops import heatmap as jheat
from pixelwiseregression_tpu.ops import image as jimg
from pixelwiseregression_tpu.ops import softargmax as jsa
from pixelwiseregression_tpu.ops.pallas_softargmax import soft_argmax_decode_pallas
from pixelwiseregression_tpu.utils import synth as jsynth

from pixelwiseregression_tpu_torch.core import camera as tcam
from pixelwiseregression_tpu_torch.data import loader as tloader
from pixelwiseregression_tpu_torch.data import preprocess as tpre
from pixelwiseregression_tpu_torch.data import sources as tsrc
from pixelwiseregression_tpu_torch.ops import cuda_softargmax as tcuda
from pixelwiseregression_tpu_torch.ops import heatmap as theat
from pixelwiseregression_tpu_torch.ops import image as timg
from pixelwiseregression_tpu_torch.ops import softargmax as tsa
from pixelwiseregression_tpu_torch.utils import synth as tsynth

CPU = torch.device("cpu")
DATASETS = ["MSRA", "ICVL", "NYU", "HAND17"]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# --------------------------------------------------------------------------- #
# camera and host records
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("dataset", DATASETS)
def test_camera_transforms_match(dataset):
    """Host numpy code, same arithmetic: exact in float64."""
    rng = np.random.RandomState(0)
    xyz = np.stack([rng.uniform(-80, 80, 50), rng.uniform(-80, 80, 50),
                    rng.uniform(300, 900, 50)], axis=1)
    jc, tc = jsrc.SPECS[dataset].camera, tsrc.SPECS[dataset].camera
    np.testing.assert_array_equal(tc.xyz2uvd(xyz), jc.xyz2uvd(xyz))
    uvd = jc.xyz2uvd(xyz)
    np.testing.assert_array_equal(tc.uvd2xyz(uvd), jc.uvd2xyz(uvd))
    np.testing.assert_array_equal(tc.uvd2xyz(uvd.astype(np.float32)),
                                  jc.uvd2xyz(uvd.astype(np.float32)))


def test_recover_uvd_matches():
    """Same f32 elementwise formula: agree to f32 rounding (rtol 1e-6)."""
    rng = np.random.RandomState(1)
    uvd = rng.uniform(-0.5, 0.5, (6, 14, 3)).astype(np.float32)
    box = rng.randint(100, 400, 6).astype(np.float32)
    com = rng.uniform(100, 500, (6, 3)).astype(np.float32)
    cube = np.full(6, 150.0, np.float32)
    want = np.asarray(jcam.recover_uvd(jnp.asarray(uvd), jnp.asarray(box), jnp.asarray(com),
                                       jnp.asarray(cube)))
    got = tcam.recover_uvd(_t(uvd), _t(box), _t(com), _t(cube)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_dataset_specs_match_field_for_field():
    """Drift guard: the port's numpy copy of the dataset constants."""
    assert tsrc.SPECS.keys() == jsrc.SPECS.keys()
    for name in jsrc.SPECS:
        assert dataclasses.asdict(tsrc.SPECS[name]) == dataclasses.asdict(jsrc.SPECS[name])


@pytest.mark.parametrize("dataset", DATASETS)
def test_make_record_and_load_bbox_match(dataset):
    """Drift guard for the float64 -> int crop arithmetic: equal fields, dtypes and shapes."""
    rng = np.random.RandomState(2)
    jspec, tspec = jsrc.SPECS[dataset], tsrc.SPECS[dataset]
    frame = rng.uniform(0, 1000, (jspec.frame_h, jspec.frame_w))
    joints = rng.uniform(0, 300, (jspec.joint_number, 3))
    for com, cube in [(np.array([160.7, 119.2, 401.3]), jspec.cube_size),
                      (np.array([300.5, 250.9, 733.7]), int(jspec.cube_size * 5 / 6)),
                      (np.array([3.2, 470.1, 250.0]), jspec.cube_size)]:
        bbox = None
        if jspec.bbox_margin is not None:
            bbox = jsrc.load_bbox(jspec, com, cube)
            assert tsrc.load_bbox(tspec, com, cube) == bbox
        for jts in (joints, None):
            want = jsrc.make_record(jspec, frame, jts, com, cube, bbox)
            got = tsrc.make_record(tspec, frame, jts, com, cube, bbox)
            assert got.keys() == want.keys()
            for k in want:
                assert got[k].dtype == want[k].dtype, k
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_stack_records_and_synth_match():
    kw = dict(fx=588.037, fy=587.075, cube=150.0, com_z=520.0, seed=3)
    want = jsynth.make_synthetic_raw_batch(3, 48, 64, 14, **kw)
    got = tsynth.make_synthetic_raw_batch(3, 48, 64, 14, **kw)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    spec = jsrc.SPECS["NYU"]
    recs = [jsrc.make_record(spec, want["frame"][i], None, want["com"][i].astype(np.float64),
                             150.0) for i in range(3)]
    for pad in (None, 3, 5):
        jb, jn = jloader.stack_records(recs, pad_to=pad)
        tb, tn = tloader.stack_records(recs, pad_to=pad)
        assert tn == jn and tb.keys() == jb.keys()
        for k in jb:
            np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)


# --------------------------------------------------------------------------- #
# image ops and preprocessing
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("size_u,size_v", [(64, 64), (48, 33)])
def test_com_filter_matches(size_u, size_v):
    """float64 then f32 on both sides: exact."""
    want = jheat.com_filter(size_u, size_v).astype(np.float32)
    np.testing.assert_array_equal(theat.com_filter(size_u, size_v, CPU).numpy(), want)


@pytest.mark.parametrize("src,out", [((17, 23), (8, 11)), ((5, 7), (16, 13)), ((128, 128), (64, 64))])
def test_resize_bilinear_matches(src, out):
    """Same f32 taps: atol 1e-5."""
    img = np.random.RandomState(4).randn(*src).astype(np.float32) * 50
    want = np.asarray(jimg.resize_bilinear(jnp.asarray(img), *out))
    got = timg.resize_bilinear(_t(img), *out).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_crop_resize_matches_with_crops_outside_the_frame():
    """Per-sample crops (vmap in JAX, a batch dim in the port) with odd box
    sizes and windows that leave the frame on every side: atol 1e-5."""
    rng = np.random.RandomState(5)
    frames = rng.uniform(-100, 100, (6, 40, 50)).astype(np.float32)
    tops = np.array([-7, 3, 30, -20, 10, 0], np.int32)
    lefts = np.array([5, -9, 40, -30, 45, 0], np.int32)
    sizes = np.array([7, 13, 33, 61, 2, 40], np.int32)
    for out in (16, 9):
        want = np.stack([np.asarray(jimg.crop_resize(jnp.asarray(frames[i]), int(tops[i]),
                                                     int(lefts[i]), int(sizes[i]), out))
                         for i in range(6)])
        got = timg.crop_resize(_t(frames), _t(tops), _t(lefts), _t(sizes), out).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _raw_batch(dataset, n, seed):
    spec = jsrc.SPECS[dataset]
    raw = jsynth.make_synthetic_raw_batch(n, spec.frame_h, spec.frame_w, spec.joint_number,
                                          fx=spec.camera.fx, fy=spec.camera.fy,
                                          cube=spec.cube_size, com_z=430.0, seed=seed)
    rng = np.random.RandomState(seed)
    recs = []
    for i in range(n):
        com = raw["com"][i].astype(np.float64) + rng.uniform(-6, 6, 3)
        bbox = jsrc.load_bbox(spec, com, spec.cube_size) if spec.bbox_margin else None
        recs.append(jsrc.make_record(spec, raw["frame"][i], None, com, spec.cube_size, bbox))
    batch, _ = jloader.stack_records(recs)
    batch.pop("weight")
    return batch


@pytest.mark.parametrize("dataset", ["NYU", "MSRA"])
def test_preprocess_test_only_matches(dataset):
    """img and label_img at atol 1e-5 (normalized by the cube), mask exact."""
    spec = jsrc.SPECS[dataset]
    batch = _raw_batch(dataset, 3, seed=6)
    kw = dict(fx=spec.camera.fx, fy=spec.camera.fy, halfu=spec.camera.halfu,
              halfv=spec.camera.halfv, image_size=64, label_size=32)
    want = jpre.preprocess_batch({k: jnp.asarray(v) for k, v in batch.items()},
                                 jax.random.PRNGKey(0), jpre.PreprocessConfig(**kw),
                                 test_only=True)
    got = tpre.preprocess_batch({k: _t(v) for k, v in batch.items()},
                                tpre.PreprocessConfig(**kw), test_only=True)
    assert got.keys() == want.keys()
    assert float(np.asarray(want["mask"]).mean()) > 0.05  # the hand is in the crop
    np.testing.assert_array_equal(got["mask"].numpy(), np.asarray(want["mask"]))
    for k in ("img", "label_img"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=1e-5,
                                   err_msg=k)
    for k in ("box_size", "cube", "com"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


def test_preprocess_training_branches_wait_for_the_training_port():
    cfg = tpre.PreprocessConfig(fx=1.0, fy=1.0, halfu=1.0, halfv=1.0)
    with pytest.raises(NotImplementedError):
        tpre.preprocess_batch({}, cfg, test_only=False)


# --------------------------------------------------------------------------- #
# decoder
# --------------------------------------------------------------------------- #


def _decoder_inputs(j, b=2, h=64, w=64, seed=3):
    rng = np.random.RandomState(seed)
    logits = rng.randn(b, h, w, j).astype(np.float32)
    dm = rng.randn(b, h, w, j).astype(np.float32)
    label = rng.randn(b, h, w, 1).astype(np.float32)
    mask = (rng.rand(b, h, w, 1) > 0.4).astype(np.float32)
    wt = (rng.rand(j) + 0.5).astype(np.float32)
    return logits, dm, label, mask, wt


@pytest.mark.parametrize("j", [14, 21])
@pytest.mark.parametrize("reference", ["xla", "pallas"])
def test_plain_decoder_matches_jax(j, reference):
    """Port plain decoder vs the JAX decoder and vs the Pallas kernel (interpret
    mode) at the Pallas test's tolerances: hm rtol 1e-6 atol 1e-9, uvd rtol
    1e-5 atol 1e-6."""
    args = _decoder_inputs(j)
    fn = jsa.soft_argmax_decode if reference == "xla" else soft_argmax_decode_pallas
    hm_j, uvd_j = fn(*(jnp.asarray(a) for a in args))
    hm_t, uvd_t = tsa.soft_argmax_decode(*(_t(a) for a in args))
    np.testing.assert_allclose(hm_t.numpy(), np.asarray(hm_j), rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(uvd_t.numpy(), np.asarray(uvd_j), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("method", ["softmax", "sum"])
def test_normalize_heatmaps_matches_jax(method):
    """rtol 1e-6: the same f32 normalization, another summation order."""
    logits, _, _, _, wt = _decoder_inputs(21, seed=4)
    w = wt if method == "softmax" else None
    want = jsa.normalize_heatmaps(jnp.asarray(logits), None if w is None else jnp.asarray(w),
                                  method)
    got = tsa.normalize_heatmaps(_t(logits), None if w is None else _t(w), method)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-12)


def test_plain_decoder_sum_method_matches_jax():
    logits, dm, label, mask, _ = _decoder_inputs(14)
    hm_j, uvd_j = jsa.soft_argmax_decode(*(jnp.asarray(a) for a in (logits, dm, label, mask)),
                                         None, method="sum")
    hm_t, uvd_t = tsa.soft_argmax_decode(*(_t(a) for a in (logits, dm, label, mask)), None,
                                         method="sum")
    np.testing.assert_allclose(hm_t.numpy(), np.asarray(hm_j), rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(uvd_t.numpy(), np.asarray(uvd_j), rtol=1e-5, atol=1e-6)
    # the kernel wrapper sends the sum method to the plain version, as the JAX package does
    hm_c, uvd_c = tcuda.soft_argmax_decode_cuda(*(_t(a) for a in (logits, dm, label, mask)),
                                                None, method="sum")
    torch.testing.assert_close(uvd_c, uvd_t, rtol=0, atol=0)


def test_bf16_fast_boundary_matches_pallas():
    """bf16 maps on the inference fast boundary: the port's kernel wrapper
    (plain version on the CPU) vs the Pallas kernel with fast_boundary=True.
    Both upcast the same bf16 values and compute in f32; the bf16 heatmaps
    they return may round f32 values ~1e-7 apart to neighbouring bf16
    numbers, so hm is held to 1 bf16 ulp (rtol 2**-7); uvd stays f32
    (rtol 1e-5, atol 1e-6)."""
    args = _decoder_inputs(14, seed=8)
    maps = [jnp.asarray(a, jnp.bfloat16) for a in args[:4]]
    hm_j, uvd_j = soft_argmax_decode_pallas(*maps, jnp.asarray(args[4]), fast_boundary=True)
    tmaps = [_t(a).to(torch.bfloat16) for a in args[:4]]
    hm_t, uvd_t = tcuda.soft_argmax_decode_cuda(*tmaps, _t(args[4]), fast_boundary=True)
    assert hm_t.dtype == torch.bfloat16 and hm_j.dtype == jnp.bfloat16
    np.testing.assert_allclose(hm_t.float().numpy(), np.asarray(hm_j, np.float32),
                               rtol=2 ** -7, atol=1e-12)
    np.testing.assert_allclose(uvd_t.numpy(), np.asarray(uvd_j), rtol=1e-5, atol=1e-6)


def test_cuda_wrapper_runs_plain_version_on_cpu_tensors():
    args = [_t(a) for a in _decoder_inputs(14, b=3, h=16, w=32, seed=9)]
    before = tcuda.LAUNCHES
    hm_c, uvd_c = tcuda.soft_argmax_decode_cuda(*args)
    hm_p, uvd_p = tsa.soft_argmax_decode(*args)
    torch.testing.assert_close(hm_c, hm_p, rtol=0, atol=0)
    torch.testing.assert_close(uvd_c, uvd_p, rtol=0, atol=0)
    assert tcuda.LAUNCHES == before  # no kernel ran


def test_cuda_wrapper_raises_when_an_input_requires_grad():
    args = [_t(a) for a in _decoder_inputs(14, b=1, h=16, w=16)]
    args[0].requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward only"):
        tcuda.soft_argmax_decode_cuda(*args)
    with torch.no_grad():  # no graph is recorded, so no backward is needed
        tcuda.soft_argmax_decode_cuda(*args)


# --------------------------------------------------------------------------- #
# the port stands alone
# --------------------------------------------------------------------------- #


def test_port_imports_neither_jax_nor_the_jax_package():
    """In a fresh process (this one already imported jax for the tests)."""
    script = (
        "import importlib, pkgutil, sys\n"
        "import pixelwiseregression_tpu_torch as pkg\n"
        "mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'pixelwiseregression_tpu' or m.startswith('pixelwiseregression_tpu.')]\n"
        "assert not bad, bad\n"
        "print('MODULES', len(mods))\n"
    )
    r = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                       timeout=300, cwd=REPO)
    assert r.returncode == 0, r.stderr[-3000:]
    assert int(r.stdout.split("MODULES")[1]) >= 19  # 13 modules + 6 subpackages
