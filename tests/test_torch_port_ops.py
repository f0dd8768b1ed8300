"""PyTorch port vs the JAX package: camera, host records, image ops, label
synthesis, preprocessing (with the JAX package's own augmentation draws) and
the soft-argmax decoder with its gradients.

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

import torch_port_threads
from torch_port_threads import one_thread  # noqa: F401 (autouse)

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
    """Drift guard: the port's numpy copy of the dataset constants, the NYU
    joint subset, the sources' names and specs and MSRA's index file names
    (the sources themselves: tests/test_torch_port_data.py)."""
    assert tsrc.SPECS.keys() == jsrc.SPECS.keys()
    for name in jsrc.SPECS:
        assert dataclasses.asdict(tsrc.SPECS[name]) == dataclasses.asdict(jsrc.SPECS[name])
    assert tsrc.NYU_JOINT_INDEX == jsrc.NYU_JOINT_INDEX
    assert tsrc.SOURCES.keys() == jsrc.SOURCES.keys()
    for name, cls in jsrc.SOURCES.items():
        port = tsrc.SOURCES[name]
        assert port.__name__ == cls.__name__
        assert dataclasses.asdict(port.SPEC) == dataclasses.asdict(cls.SPEC)
    for split in ("train", "val", "test"):  # MSRA's per-subject index files
        got = tsrc.MSRASource(".", dataset=split, subject=3, build=False)
        want = jsrc.MSRASource(".", dataset=split, subject=3, build=False)
        assert got.index_filename() == want.index_filename() == f"{split}_3.txt"


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
    """The name is kept from when the training branches raised. They run
    now; what waits is an augmented call without its draws: it needs
    ``draws`` or a generator and raises without either."""
    batch = {k: _t(v[:2]) for k, v in _train_batch().items()}
    cfg = tpre.PreprocessConfig(**_CAM, using_rotation=True)
    with pytest.raises(ValueError, match="draws or a generator"):
        tpre.preprocess_batch(batch, cfg, augment=True)
    gen = torch.Generator().manual_seed(0)
    out = tpre.preprocess_batch(batch, cfg, augment=True, generator=gen)
    assert out["heatmaps"].shape == (2, 64, 64, 14) and out["valid"].dtype == torch.bool


@pytest.mark.parametrize("angle,scale", [(0.0, 1.0), (23.7, 1.13), (-29.2, 0.84)])
def test_rotation_matrix_inverse_matches(angle, scale):
    """Same f32 trig (another libm): rtol 1e-6, atol 1e-5 (the centre terms ~64)."""
    want = np.asarray(jimg.rotation_matrix_inverse(jnp.float32(angle), jnp.float32(scale),
                                                    jnp.float32(64), jnp.float32(64)))
    got = timg.rotation_matrix_inverse(torch.tensor([angle]), torch.tensor([scale]), 64.0, 64.0)
    np.testing.assert_allclose(got[0].numpy(), want, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("h,w", [(40, 40), (28, 44)])
def test_warp_affine_matches(h, w):
    """The port's 4-tap gather vs the JAX default (hat functions through a
    matmul, method="dot") on a depth-like image with zero background:
    atol 1e-4 on values up to ~100, and the same zero pattern."""
    rng = np.random.RandomState(12)
    img = rng.uniform(-100, 100, (3, h, w)).astype(np.float32)
    img[:, :6] = 0.0
    img[:, :, 30:] = 0.0
    angles = np.array([0.0, 17.3, -28.9], np.float32)
    scales = np.array([1.0, 0.87, 1.16], np.float32)
    minv = timg.rotation_matrix_inverse(_t(angles), _t(scales), w / 2, h / 2)
    got = timg.warp_affine_inverse(_t(img), minv).numpy()
    for i in range(3):
        want = np.asarray(jimg.warp_affine_inverse(jnp.asarray(img[i]),
                                                   jnp.asarray(minv[i].numpy())))
        np.testing.assert_allclose(got[i], want, rtol=0, atol=1e-4)
        np.testing.assert_array_equal(got[i] != 0, want != 0)


@pytest.mark.parametrize("ksize,sigma", [(7, 1.5), (5, 0.0)])
def test_gaussian_blur_matches(ksize, sigma):
    """The kernel is the same float64 numpy: exact. The blur: atol 1e-6."""
    np.testing.assert_array_equal(timg.gaussian_kernel_1d(ksize, sigma),
                                  jimg.gaussian_kernel_1d(ksize, sigma))
    img = np.random.RandomState(13).rand(2, 3, 16, 16).astype(np.float32)
    want = np.asarray(jimg.gaussian_blur(jnp.asarray(img), ksize, sigma))
    np.testing.assert_allclose(timg.gaussian_blur(_t(img), ksize, sigma).numpy(), want,
                               rtol=0, atol=1e-6)


def test_splat_heatmap_matches_with_wrap_and_invalid_joints():
    """Joints inside, on the last valid index, at negative indices (numpy's
    wrap-around: valid) and at >= size or < -size (invalid, zero map):
    valid exact, heatmaps atol 1e-6."""
    u = np.array([10.3, 30.0, -3.6, 31.2, 5.5, -33.7, 62.0, 12.25], np.float32)
    v = np.array([20.7, 30.99, 7.1, -0.4, 32.0, 1.0, 4.0, -31.5], np.float32)
    size = 32
    got_hm, got_valid = theat.splat_heatmap(size, _t(u), _t(v))
    for i in range(len(u)):
        want_hm, want_valid = jheat.splat_heatmap(size, u[i], v[i])
        assert bool(got_valid[i]) == bool(want_valid), i
        np.testing.assert_allclose(got_hm[i].numpy(), np.asarray(want_hm), rtol=0, atol=1e-6)
    assert got_valid.tolist() == [True, True, True, False, False, False, False, True]


def test_synthesize_labels_matches():
    """Blurred heatmaps atol 1e-6, depth maps atol 1e-5 (values ~50), mask
    and valid exact."""
    rng = np.random.RandomState(14)
    b, j, s = 2, 5, 32
    uv = rng.uniform(-4, 34, (b, j, 2)).astype(np.float32)
    depth = rng.uniform(-60, 60, (b, j)).astype(np.float32)
    label = rng.uniform(-50, 50, (b, s, s)).astype(np.float32)
    label[:, :, :8] = 0.0
    got = theat.synthesize_labels(_t(uv), _t(depth), _t(label), s, 7, 1.5)
    for i in range(b):
        want = jheat.synthesize_labels(jnp.asarray(uv[i]), jnp.asarray(depth[i]),
                                       jnp.asarray(label[i]), s, 7, 1.5)
        np.testing.assert_allclose(got[0][i].numpy(), np.asarray(want[0]), rtol=0, atol=1e-6)
        np.testing.assert_allclose(got[1][i].numpy(), np.asarray(want[1]), rtol=0, atol=1e-5)
        np.testing.assert_array_equal(got[2][i].numpy(), np.asarray(want[2]))
        np.testing.assert_array_equal(got[3][i].numpy(), np.asarray(want[3]))


_CAM = dict(fx=588.03, fy=587.07, halfu=320.0, halfv=240.0)


def _train_batch(n=6, seed=0):
    """Synthetic NYU-shaped raw frames with joints; joint edits make some
    samples fail: sample 1 has a joint 190 px right of the centre (valid
    when clean, out of the label map once scaled up), sample 2 one far below
    (invalid on every path), sample 4 one 230 px left (a negative splat
    index that wraps around: valid)."""
    raw = jsynth.make_synthetic_raw_batch(n, 480, 640, 14, fx=_CAM["fx"], fy=_CAM["fy"],
                                          cube=150.0, com_z=450.0, seed=seed)
    j = raw["joints"]
    j[1, 3, 0] = 320.0 + 190.0
    j[2, 5, 1] += 400.0
    j[4, 0, 0] = 320.0 - 230.0
    return raw


def jax_draws(key, b):
    """The augmentation draws of the JAX package's ``preprocess_batch`` for
    ``key``, as the port's ``draws`` argument: per sample, the key split as
    ``_process_one`` splits it."""
    out = {"angle": [], "scale": [], "shift": [], "flip": []}
    for k in jax.random.split(key, b):
        ka, ks, kh, kf = jax.random.split(k, 4)
        out["angle"].append(jax.random.uniform(ka, (), jnp.float32, -30.0, 30.0))
        out["scale"].append(jax.random.uniform(ks, (), jnp.float32, 0.8, 1.2))
        out["shift"].append(jax.random.uniform(kh, (2,), jnp.float32, -5.0, 5.0))
        out["flip"].append(jax.random.uniform(kf, ()) < 0.5)
    return {k: torch.from_numpy(np.stack([np.asarray(x) for x in v])) for k, v in out.items()}


_AUG = dict(using_rotation=True, using_scale=True, using_shift=True)
_PRE_CONFIGS = {
    "augment_off": (_AUG, False),
    "default": (_AUG, True),
    "flip_strict_quirks": (dict(_AUG, using_flip=True), True),
    "flip_no_strict_quirks": (dict(_AUG, using_flip=True, strict_quirks=False), True),
    "aug_fallback_drop": (dict(_AUG, aug_fallback="drop"), True),
}


@pytest.mark.parametrize("name", list(_PRE_CONFIGS))
def test_preprocess_batch_matches_with_jax_draws(name):
    """The training path with the JAX package's own draws on two keys:
    mask and valid identical; img, label_img and dmaps atol 1e-5 (values are
    normalized by the cube), heatmaps and uvd atol 1e-6; com, box_size and
    cube exact. Key 2's draws scale sample 1 out of the label map, so the
    drop config must lose it there."""
    kw, augment = _PRE_CONFIGS[name]
    raw = _train_batch()
    jcfg, tcfg = jpre.PreprocessConfig(**_CAM, **kw), tpre.PreprocessConfig(**_CAM, **kw)
    valids = []
    for seed in (0, 2):
        key = jax.random.PRNGKey(seed)
        want = jpre.preprocess_batch({k: jnp.asarray(v) for k, v in raw.items()}, key, jcfg,
                                     augment=augment)
        got = tpre.preprocess_batch({k: _t(v) for k, v in raw.items()}, tcfg, augment=augment,
                                    draws=jax_draws(key, len(raw["frame"])))
        assert got.keys() == want.keys()
        for k in ("mask", "valid", "com", "box_size", "cube"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
        for k, atol in (("img", 1e-5), ("label_img", 1e-5), ("dmaps", 1e-5),
                        ("heatmaps", 1e-6), ("uvd", 1e-6)):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=atol,
                                       err_msg=k)
        valids.append(got["valid"].tolist())
    assert not valids[0][2]
    if name == "aug_fallback_drop":
        assert valids[0][1] and not valids[1][1]


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
    """The name is kept from when every differentiable call raised. Now
    differentiable calls run (K2 is their backward) but take f32 maps only:
    bf16 maps that require grad raise (the JAX package's custom VJP is f32
    only); without grad mode no graph is recorded and bf16 runs."""
    args = [_t(a).to(torch.bfloat16) for a in _decoder_inputs(14, b=1, h=16, w=16)[:4]]
    w = _t(_decoder_inputs(14, b=1, h=16, w=16)[4])
    args[0].requires_grad_(True)
    with pytest.raises(TypeError, match="f32"):
        tcuda.soft_argmax_decode_cuda(*args, w, fast_boundary=True)
    with torch.no_grad():
        tcuda.soft_argmax_decode_cuda(*args, w, fast_boundary=True)


def test_decoder_autograd_matches_pallas_gradients():
    """The autograd.Function (K1 forward, K2 backward; their plain versions
    on CPU tensors) vs jax.grad through the Pallas custom VJP in interpret
    mode, with the loss of tests/test_pallas_decoder.py and an all-zero mask
    on sample 0: rtol 1e-4, atol 1e-6, the tolerances of that test."""
    logits, dm, label, mask, wt = _decoder_inputs(14, b=2, seed=15)
    mask[0] = 0.0

    def jloss(*a):
        hm, uvd = soft_argmax_decode_pallas(*a)
        return jnp.sum(uvd ** 2) + 0.1 * jnp.sum(hm * hm) + jnp.sum(hm[..., 0])

    want = jax.grad(jloss, argnums=(0, 1, 2, 4))(*(jnp.asarray(a) for a in
                                                   (logits, dm, label, mask, wt)))
    leaves = [_t(a).requires_grad_(i != 3) for i, a in enumerate((logits, dm, label, mask, wt))]
    hm, uvd = tcuda.soft_argmax_decode_cuda(*leaves)
    (torch.sum(uvd ** 2) + 0.1 * torch.sum(hm * hm) + torch.sum(hm[..., 0])).backward()
    for name, i, w_ in zip(("logits", "depthmaps", "label", "w"), (0, 1, 2, 4), want):
        g = leaves[i].grad.numpy()
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, np.asarray(w_), rtol=1e-4, atol=1e-6, err_msg=name)
    assert leaves[3].grad is None  # the mask gets no gradient
    assert np.abs(leaves[1].grad[0].numpy()).max() == 0.0


@pytest.mark.parametrize("use_heatmaps", [True, False])
def test_decoder_without_label_grad_matches_the_call_with_it(use_heatmaps):
    """Through tcuda.decode_flat on CPU tensors (the plain versions): with
    the label image not requiring grad, as on the training path, dx, ddm
    and dw equal those of the call where it does, bit for bit, and no
    gradient reaches the label image."""
    logits, dm, label, mask, wt = _decoder_inputs(14, b=2, h=16, w=24, seed=16)
    mask[0] = 0.0
    rows = [_t(a).reshape(2, 16 * 24, -1).transpose(1, 2).contiguous()
            for a in (logits, dm, label, mask)]

    def grads(label_grad):
        leaves = [t.clone().requires_grad_(i != 3 and (i != 2 or label_grad))
                  for i, t in enumerate((*rows, _t(wt)))]
        hm, uvd = tcuda.decode_flat(*leaves, 16, 24)
        loss = torch.sum(uvd ** 2)
        if use_heatmaps:
            loss = loss + 0.1 * torch.sum(hm * hm) + torch.sum(hm[:, 0])
        loss.backward()
        return [leaves[i].grad for i in (0, 1, 2, 4)]

    with_label, without = grads(True), grads(False)
    assert without[2] is None and with_label[2] is not None
    for name, a, b in zip(("dx", "ddm", "dw"), (without[0], without[1], without[3]),
                          (with_label[0], with_label[1], with_label[3])):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)


# --------------------------------------------------------------------------- #
# the port stands alone
# --------------------------------------------------------------------------- #


def test_port_imports_neither_jax_nor_the_jax_package():
    """In a fresh process (this one already imported jax for the tests):
    importing every module of the port, the CLI entry modules and the native
    decoder's binding included, imports neither jax nor the JAX package,
    nor the JAX package's ``bench.py`` and top-level ``tools/``."""
    script = (
        "import importlib, pkgutil, sys\n"
        "import pixelwiseregression_tpu_torch as pkg\n"
        "mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'pixelwiseregression_tpu', 'bench', 'tools')]\n"
        "assert not bad, bad\n"
        "print('MODULES', ' '.join(mods))\n"
    )
    r = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                       timeout=300, cwd=REPO, env=torch_port_threads.env())
    assert r.returncode == 0, r.stderr[-3000:]
    mods = set(r.stdout.split("MODULES")[1].split())
    pkg = "pixelwiseregression_tpu_torch."
    new = {"cli", "cli.common", "cli.check_dataset", "cli.train_main", "cli.test_main",
           "cli.train", "cli.train_msra", "cli.test", "cli.test_msra", "native",
           "train.checkpoint", "utils.seeding", "utils.viz", "data.sources", "data.loader",
           "serve_artifact", "serve_http", "tools.export_model", "models.fullregression",
           "models.paired_heads", "parallel", "parallel.mesh", "compat.verify_parity",
           "cli.train_fullregression", "cli.test_fullregression", "tools.bench_paired_model",
           "obs"}
    assert {pkg + m for m in new} <= mods, sorted({pkg + m for m in new} - mods)
    assert len(mods) >= 52  # 42 modules + 10 subpackages


def test_two_threads_build_and_bind_the_kernel_library_once(monkeypatch):
    """Two threads whose first kernel calls meet (a service's first two
    requests) build the library once: the build's files are named by the
    process, so two builds at once would write the same files."""
    import ctypes.util
    import threading
    import time

    from pixelwiseregression_tpu_torch.ops import cuda_lib

    libc = ctypes.util.find_library("c")
    if libc is None:
        pytest.skip("no C library to stand in for the kernels' library")
    builds = []

    def slow_build():
        builds.append(threading.get_ident())
        time.sleep(0.2)
        return libc, ""

    monkeypatch.setattr(cuda_lib, "build", slow_build)
    monkeypatch.setattr(cuda_lib, "_lib", None)
    monkeypatch.setattr(cuda_lib, "_bound", {})
    got = []
    threads = [threading.Thread(target=lambda: got.append(
        cuda_lib.function("abs", [ctypes.c_int]))) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(builds) == 1 and len(got) == 2 and got[0] is got[1]
    assert got[0](-3) == 3
