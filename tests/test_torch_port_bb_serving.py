"""Serving requests that come with a hand detector's box (HANDS 2017's test
protocol): the device localisation (``ops/localize.py``, here on the CPU)
against the host's ``HAND17Source._load_raw_bb`` and ``make_record`` on
16-bit PNG frames, and ``Predictor.predict(boxes=...)`` against the
benchmark's plain reference (``port_bench/reference``) and against the
centre path on the cleaned frames."""

import dataclasses
import os

import numpy as np
import pytest
import torch
from PIL import Image

from port_bench.drivers import predict_bb

from pixelwiseregression_tpu_torch.data.sources import SPECS, HAND17Source, load_png16, make_record
from pixelwiseregression_tpu_torch.ops import localize as loc
from pixelwiseregression_tpu_torch.serve import Predictor

from torch_port_threads import one_thread  # noqa: F401 (autouse)

SPEC = SPECS["HAND17"]
H, W = SPEC.frame_h, SPEC.frame_w


def _frame(rng, cu, cv, z, holes=0.05, flat=False):
    """A hand disc at depth ``z`` before a slanted background plane, with a
    forearm strip behind it and zero holes; whole mm."""
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    r2 = ((xx - cu) / 45.0) ** 2 + ((yy - cv) / 45.0) ** 2
    depth = z + 300.0 + 3.0 * (xx - cu) + 1.5 * (yy - cv)
    depth = np.where((xx > cu) & (np.abs(yy - cv) < 20), z + 60.0, depth)
    depth = np.where(r2 < 1, z + (0.0 if flat else 20.0 * (r2 - 0.5)), depth)
    depth = np.where(rng.uniform(size=(H, W)) < holes, 0.0, np.clip(depth, 0, 4000))
    return np.round(depth).astype(np.uint16)


# (cu, cv, z, box (ustart, vstart, du, dv), holes, flat)
CASES = [
    (320.3, 240.7, 520.0, (250.5, 170.25, 150.0, 140.0), 0.05, False),   # both rounds cut
    (40.0, 30.0, 610.0, (0.0, 0.0, 110.7, 95.2), 0.05, False),           # at the top-left edge
    (600.0, 450.0, 700.0, (540.9, 401.3, 200.0, 200.0), 0.05, False),    # past the bottom-right
    (300.0, 260.0, 450.0, (270.0, 230.0, 60.0, 60.0), 0.0, True),        # the cut removes nothing
    (350.0, 200.0, 640.0, (300.0, 150.0, 100.0, 100.0), 0.3, False),     # many holes
]


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """The cases as 16-bit PNGs in a HAND17 layout, and each one's host
    result: ``_load_raw_bb``'s frame and centre, ``make_record``'s fields."""
    root = tmp_path_factory.mktemp("hand17_bb")
    os.makedirs(root / "frame" / "images")
    for name in ("hands17_center_train.txt", "hands17_center_test.txt"):
        np.savetxt(root / name, np.zeros((1, 3)))
    src = HAND17Source(str(root), dataset="test", process_mode="bb", build=False)
    rng = np.random.RandomState(7)
    out = []
    for i, (cu, cv, z, box, holes, flat) in enumerate(CASES):
        name = f"image_D{i + 1:08d}.png"
        Image.fromarray(_frame(rng, cu, cv, z, holes, flat)).save(root / "frame" / "images" / name)
        raw = load_png16(str(root / "frame" / "images" / name), shape=(H, W))
        frame, _, com, cube, bbox = src._load_raw_bb(f"{name} " + " ".join(map(str, box)))
        out.append((raw, box, frame, com, make_record(SPEC, frame, None, com, cube, bbox)))
    return out


def _localize(host, device="cpu"):
    frames = torch.as_tensor(np.stack([h[0] for h in host]), dtype=torch.float32, device=device)
    bounds = torch.as_tensor(loc.box_bounds(np.array([h[1] for h in host]), H, W), device=device)
    cube = torch.full((len(host),), SPEC.cube_size, dtype=torch.float64, device=device)
    return loc.localize(frames, bounds, cube, SPEC.camera)


def test_the_cases_cover_both_rounds_and_none(host):
    """Round one removes pixels in the first case and nothing in the flat one."""
    for i in (0, 3):
        raw, box, frame = host[i][:3]
        u, v, du, dv = box
        boxed = np.zeros_like(raw, np.float64)
        sl = np.s_[int(v):int(v + dv), int(u):int(u + du)]
        boxed[sl] = raw[sl]
        removed = int(((boxed > 0) & (frame == 0)).sum())
        assert (removed > 0) == (i == 0), (i, removed)


def test_localisation_equals_the_host(host):
    batch, com, empty = _localize(host)
    assert not empty.any()
    for i, (_, _, frame, com_host, rec) in enumerate(host):
        assert torch.equal(batch["frame"][i], torch.from_numpy(frame.astype(np.float32))), i
        np.testing.assert_allclose(com[i].numpy(), com_host, rtol=1e-9, atol=0, err_msg=str(i))
        for k in ("com", "com_int", "cube", "bbox", "crop_top", "crop_left", "box_size"):
            got = batch[k][i].numpy()
            assert got.dtype == rec[k].dtype, k
            np.testing.assert_array_equal(got, rec[k], err_msg=f"{i} {k}")


def test_box_bounds_follow_numpy_slicing():
    boxes = np.array([[10.7, 5.2, 20.5, 30.9], [-3.0, 470.0, 10.0, 40.0], [630.0, 0.0, 50.0, 0.4],
                      [5.0, 5.0, -2.0, 3.0]])
    got = loc.box_bounds(boxes, H, W)
    frame = np.arange(H * W).reshape(H, W)
    for (u, v, du, dv), (t, b, l, r) in zip(boxes, got):
        want = frame[int(v):int(v + dv), int(u):int(u + du)]
        np.testing.assert_array_equal(frame[int(t):int(b), int(l):int(r)].reshape(want.shape),
                                      want)
    with pytest.raises(ValueError):
        loc.box_bounds(np.zeros((2, 3)), H, W)


def test_an_empty_box_is_flagged_with_finite_fields(host):
    raw = host[0][0].copy()
    raw[:100, :100] = 0
    frames = torch.as_tensor(np.stack([raw, host[1][0]]), dtype=torch.float32)
    bounds = torch.as_tensor(loc.box_bounds(np.array([[10, 10, 50, 50], host[1][1]]), H, W))
    batch, com, empty = loc.localize(frames, bounds, torch.full((2,), 150.0), SPEC.camera)
    assert empty.tolist() == [True, False]
    assert torch.isfinite(com).all()
    assert int(batch["box_size"][0]) >= 2


# --------------------------------------------------------------------------- #
# Predictor.predict(boxes=...) at a small width
# --------------------------------------------------------------------------- #

CFG = {"model": {"class": "PixelwiseRegression", "joints": 21, "stages": 2, "features": 16,
                 "level": 2, "filter_size": 3, "image_size": 64, "label_size": 32,
                 "heatmap_method": "softmax", "decoder": "cuda"},
       "dataset": {"name": "HAND17", "frame_h": H, "frame_w": W, "cube": 150.0,
                   "bbox_margin": 40.0,
                   "camera": {"fx": SPEC.camera.fx, "fy": SPEC.camera.fy,
                              "halfu": SPEC.camera.halfu, "halfv": SPEC.camera.halfv}},
       "preprocess": {"image_size": 64, "label_size": 32},
       "dtype": "f32", "tf32": False, "norm": {"serve": "instance"}}
MIX = {"batch": 4, "pool": 2, "reference_rows": 4}


@pytest.fixture(scope="module")
def served():
    """A small Predictor on seeded weights and two requests from the
    benchmark's scene (one padded)."""
    pred, weights, requests = predict_bb.build(CFG, MIX, 2**31 + 9, torch.device("cpu"))
    frames, boxes = requests[1]
    requests[1] = (frames[:3], boxes[:3])
    return pred, weights, requests


def test_predictor_with_boxes_matches_the_reference(served):
    pred, weights, requests = served
    ref = predict_bb.reference(CFG, MIX, weights, requests, torch.device("cpu"))
    for (frames, boxes), want in zip(requests, ref):
        got = pred.predict(frames, boxes=boxes)
        assert got["uvd"].shape == (len(frames), 21, 3) and got["com"].shape == (len(frames), 3)
        np.testing.assert_array_equal(got["com"], want["com"])
        np.testing.assert_allclose(got["uvd"], want["uvd"], rtol=0, atol=2e-2)
        np.testing.assert_allclose(got["xyz"], want["xyz"], rtol=0, atol=2e-2)


def test_the_box_path_is_the_centre_path_on_the_cleaned_frames(served):
    """The box path's answers equal the centre path's on the frames it
    cleaned, with the centres it returned and the whole frame as the
    background bbox."""
    pred, _, requests = served
    frames, boxes = requests[0]
    got = pred.predict(frames, boxes=boxes)
    f = torch.from_numpy(frames)
    bounds = torch.from_numpy(loc.box_bounds(boxes, H, W))
    cleaned = loc.clean(f, bounds).to(torch.float32).numpy()
    whole = Predictor(pred.model, dataclasses.replace(SPEC, bbox_margin=None), pred.cfg,
                      pred.batch_size, pred.device)
    want = whole.predict(cleaned, got["com"])
    np.testing.assert_array_equal(got["uvd"], want["uvd"])
    np.testing.assert_array_equal(got["xyz"], want["xyz"])


def test_padded_rows_are_finite_and_uncounted(served):
    pred, _, requests = served
    frames, boxes = requests[1]
    before = loc.LOCALIZED
    got = pred.predict(frames, boxes=boxes)
    assert loc.LOCALIZED - before == len(frames) < pred.batch_size
    assert all(np.isfinite(got[k]).all() for k in ("uvd", "xyz", "com"))


def test_an_empty_box_raises_naming_its_row(served):
    pred, _, requests = served
    frames, boxes = requests[0]
    boxes = boxes.copy()
    boxes[2] = (0.0, 0.0, 0.0, 0.0)
    with pytest.raises(ValueError, match="row 2"):
        pred.predict(frames, boxes=boxes)


def test_predict_takes_exactly_one_of_coms_and_boxes(served):
    pred, _, requests = served
    frames, boxes = requests[0]
    for kw in ({}, {"coms": np.zeros((len(frames), 3)), "boxes": boxes}):
        with pytest.raises(ValueError, match="exactly one"):
            pred.predict(frames, **kw)


def test_data_parallel_boxes_equal_one_replica(served):
    pred, weights, requests = served
    m = CFG["model"]
    dp = Predictor.from_state_dict(weights, "HAND17", "cpu", batch_size=4, stages=m["stages"],
                                   features=m["features"], level=m["level"],
                                   label_size=m["label_size"], data_parallel=True,
                                   devices=["cpu", "cpu"])
    for frames, boxes in requests:
        a, b = pred.predict(frames, boxes=boxes), dp.predict(frames, boxes=boxes)
        for k in ("uvd", "xyz", "com"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_the_centre_path_returns_the_centres_it_was_given(served):
    pred, _, requests = served
    frames, boxes = requests[0]
    com = pred.predict(frames, boxes=boxes)["com"]
    got = pred.predict(frames, com.astype(np.float32))
    assert got["com"].dtype == np.float64
    np.testing.assert_array_equal(got["com"], com.astype(np.float32))
