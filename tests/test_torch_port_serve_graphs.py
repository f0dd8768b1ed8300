"""The Predictor's CUDA graphs of its serving function (``serve.Graphed``)
on the CPU: a CPU Predictor keeps the eager path and never captures, the
graphs' two counters are registered with the launch counters, the graph
key (``serve.signature``) is the batch's layout, and the replica's
bookkeeping (eager first call, one capture a key, replays that copy in,
clone out and add the capture's launches) with the capture stubbed. The
capture itself needs a card: ``tests/test_torch_port_cuda.py``."""

import threading

import numpy as np
import pytest
import torch

from pixelwiseregression_tpu_torch import serve
from pixelwiseregression_tpu_torch.data.sources import SPECS
from pixelwiseregression_tpu_torch.models.pixelwise import PixelwiseRegression
from pixelwiseregression_tpu_torch.ops.localize import localize
from pixelwiseregression_tpu_torch.serve import Predictor
from pixelwiseregression_tpu_torch.serve_artifact import _build_batch, _device_batch
from pixelwiseregression_tpu_torch.tools import ab_common
from pixelwiseregression_tpu_torch.utils.synth import make_synthetic_raw_batch

from torch_port_threads import one_thread  # noqa: F401 (autouse)

ARCH = dict(stages=1, features=16, level=1, label_size=32)
BATCH = 4


def _predictor(dataset):
    torch.manual_seed(0)
    state = PixelwiseRegression(SPECS[dataset].joint_number, stage=1, features=16,
                                level=1).state_dict()
    return Predictor.from_state_dict(state, dataset, "cpu", batch_size=BATCH, **ARCH)


def _centres(n, seed, dataset="NYU"):
    spec = SPECS[dataset]
    return make_synthetic_raw_batch(n, spec.frame_h, spec.frame_w, spec.joint_number,
                                    fx=spec.camera.fx, fy=spec.camera.fy, cube=spec.cube_size,
                                    com_z=450.0, seed=seed)


def _boxes(n, seed):
    from port_bench import scene
    spec = SPECS["HAND17"]
    return scene.frames_and_boxes(n, spec.frame_h, spec.frame_w, fx=spec.camera.fx,
                                  fy=spec.camera.fy, seed=seed)


def _serving_batch(pred, raw, boxes):
    """What ``predict`` hands the serving function for ``raw``."""
    if not boxes:
        batch, _ = _build_batch(pred.spec, BATCH, raw["frame"], raw["com"], None)
        return _device_batch(batch, "cpu")
    batch, n = serve._build_box_batch(pred.spec, BATCH, raw["frame"], raw["box"], None)
    part = _device_batch(batch, "cpu")
    return localize(part["frame"], part["bounds"], part["cube"], pred.spec.camera, n)[0]


def _request(pred, raw, boxes):
    if boxes:
        return pred.predict(raw["frame"], boxes=raw["box"])
    return pred.predict(raw["frame"], raw["com"])


@pytest.mark.parametrize("boxes", [False, True], ids=["centres", "boxes"])
def test_a_cpu_predictor_never_captures(boxes):
    """Three requests to a CPU Predictor: neither graph counter moves, the
    replica is served by its ``ServingFunction`` itself, and each answer is
    that function's on the request's batch, as before graphs."""
    pred = _predictor("HAND17" if boxes else "NYU")
    assert pred.forwards == [pred.serving]
    before = (serve.GRAPH_CAPTURES, serve.GRAPH_REPLAYS)
    for i, n in enumerate((BATCH, 2, BATCH)):
        raw = (_boxes if boxes else _centres)(n, 40 + i)
        got = _request(pred, raw, boxes)
        with torch.inference_mode():
            want = pred.serving(_serving_batch(pred, raw, boxes))[:n].numpy()
        np.testing.assert_array_equal(got["uvd"], want)
    assert (serve.GRAPH_CAPTURES, serve.GRAPH_REPLAYS) == before


def test_the_graph_counters_are_registered_launch_counters():
    """``ab_common.COUNTERS`` holds both graph counters, so that
    ``counted_call`` reads and ``reset_counts`` zeroes them."""
    assert ab_common.COUNTERS["graph_captures"] == (serve, "GRAPH_CAPTURES")
    assert ab_common.COUNTERS["graph_replays"] == (serve, "GRAPH_REPLAYS")
    saved = (serve.GRAPH_CAPTURES, serve.GRAPH_REPLAYS)
    try:
        serve.GRAPH_CAPTURES, serve.GRAPH_REPLAYS = 3, 5
        counts = ab_common.read_counts()
        assert (counts["graph_captures"], counts["graph_replays"]) == (3, 5)
        ab_common.reset_counts()
        assert (serve.GRAPH_CAPTURES, serve.GRAPH_REPLAYS) == (0, 0)
    finally:
        serve.GRAPH_CAPTURES, serve.GRAPH_REPLAYS = saved


def test_the_graph_key_is_the_batch_layout():
    """Requests of any size pad to one key; a batch of another size or a
    field of another dtype gets another key; a field's values do not enter
    it."""
    pred = _predictor("NYU")
    small, full = (_serving_batch(pred, _centres(n, 7), False) for n in (1, BATCH))
    assert serve.signature(small) == serve.signature(full)
    assert serve.signature({k: v + 1 for k, v in full.items()}) == serve.signature(full)
    other = _device_batch(_build_batch(pred.spec, BATCH + 1, _centres(1, 7)["frame"],
                                       _centres(1, 7)["com"], None)[0], "cpu")
    assert serve.signature(other) != serve.signature(full)
    as64 = dict(full, frame=full["frame"].double())
    assert serve.signature(as64) != serve.signature(full)


def test_the_box_and_centre_paths_share_a_key():
    """The box path's batch (``localize``'s output) has the centre path's
    fields, shapes, dtypes and contiguous layout, so a replica serves both
    paths' requests by one graph: the serving function is the same on
    both."""
    pred = _predictor("HAND17")
    centre = _serving_batch(pred, _centres(2, 8, "HAND17"), False)
    box = _serving_batch(pred, _boxes(2, 8), True)
    assert sorted(box) == sorted(centre)
    for k in box:
        assert (box[k].shape, box[k].dtype) == (centre[k].shape, centre[k].dtype), k
        assert box[k].is_contiguous() and centre[k].is_contiguous(), k
    assert serve.signature(box) == serve.signature(centre)


class _Replay:
    def __init__(self, fn):
        self.replay = fn


LAUNCHES = [2, 12, 0]  # what the stubbed capture records: K1, conv3x3, int_mm


def _stub_capture(self, batch):
    """``Graphed._capture`` without a card: static inputs shaped as the
    batch's, and a 'graph' whose replay runs the forward on them into the
    static output."""
    serve.GRAPH_CAPTURES += 1
    inputs = {k: torch.empty_like(v) for k, v in batch.items()}
    output = torch.empty_like(self.serving(batch))

    def replay():
        output.copy_(self.serving(inputs))
    return serve._Graph(_Replay(replay), inputs, output, list(LAUNCHES))


def test_a_replica_runs_eager_then_captures_once_then_replays(monkeypatch):
    """A replica's first call of a key runs the forward eagerly; the second
    captures once and replays; every replay copies its batch in, answers
    the eager forward's answer for it, and adds the capture's launches to
    the kernels' counters."""
    monkeypatch.setattr(serve.Graphed, "_capture", _stub_capture)
    pred = _predictor("NYU")
    graphed = serve.Graphed(pred.serving, torch.device("cpu"))
    before = ab_common.read_counts()
    for i in range(4):
        batch = _serving_batch(pred, _centres(BATCH, 60 + i), False)
        with torch.inference_mode():
            got, want = graphed(batch), pred.serving(batch)
        assert torch.equal(got, want), i
    moved = {k: n - before[k] for k, n in ab_common.read_counts().items() if n != before[k]}
    assert moved == {"graph_captures": 1, "graph_replays": 3, "K1": 3 * LAUNCHES[0],
                     "conv3x3": 3 * LAUNCHES[1]}
    assert list(graphed.graphs) == [serve.signature(batch)]


def test_clients_racing_through_the_capture_get_their_own_answers(monkeypatch):
    """Four threads send requests at once to one replica (stubbed capture):
    one capture, and each request's answer is the eager forward's on that
    request's own batch."""
    monkeypatch.setattr(serve.Graphed, "_capture", _stub_capture)
    pred = _predictor("NYU")
    graphed = serve.Graphed(pred.serving, torch.device("cpu"))
    batches = [_serving_batch(pred, _centres(BATCH, 70 + i), False) for i in range(4)]
    with torch.inference_mode():
        want = [pred.serving(b) for b in batches]
    got = [[None] * 3 for _ in batches]
    captures = serve.GRAPH_CAPTURES

    def client(c):
        with torch.inference_mode():
            for r in range(3):
                got[c][r] = graphed(batches[c])

    threads = [threading.Thread(target=client, args=(c,)) for c in range(len(batches))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert serve.GRAPH_CAPTURES - captures == 1
    for c, w in enumerate(want):
        for r in range(3):
            assert torch.equal(got[c][r], w), (c, r)
