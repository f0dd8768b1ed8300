"""The port's spans (``pixelwiseregression_tpu_torch.obs``) on the CPU: off
with no profiler running (no record, no range), on under
``torch.profiler`` with their parents and roots, one tree a thread, in the
exported trace as ranges of the same names and lengths, placed on the trace
from their own clock; and the benchmark's readers of them
(``port_bench/metrics``)."""

import json
import statistics
import sys
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity

import pixelwiseregression_tpu_torch
from pixelwiseregression_tpu_torch import obs
from pixelwiseregression_tpu_torch.data.loader import to_device
from pixelwiseregression_tpu_torch.data.preprocess import PreprocessConfig, draw_augmentation
from pixelwiseregression_tpu_torch.data.sources import SPECS
from pixelwiseregression_tpu_torch.models.fullregression import FullRegression
from pixelwiseregression_tpu_torch.models.pixelwise import PixelwiseRegression
from pixelwiseregression_tpu_torch.serve import Predictor
from pixelwiseregression_tpu_torch.train.loop import (PHASES, LossConfig, create_train_state,
                                                      make_train_step, make_train_step_fullreg)
from pixelwiseregression_tpu_torch.utils.synth import make_synthetic_raw_batch

from torch_port_threads import one_thread  # noqa: F401 (autouse)

JOINTS = 14
SPEC = SPECS["NYU"]
CFG = PreprocessConfig(fx=SPEC.camera.fx, fy=SPEC.camera.fy, halfu=SPEC.camera.halfu,
                       halfv=SPEC.camera.halfv, image_size=64, label_size=32)
CHILDREN = {"train.step": list(PHASES),
            "serve.predict": ["serve.build_batch", "serve.to_device", "serve.launch",
                              "serve.wait"],
            "loader.to_device": []}


def _raw(b=2, seed=3):
    return make_synthetic_raw_batch(b, 480, 640, JOINTS, fx=SPEC.camera.fx, fy=SPEC.camera.fy,
                                    cube=150.0, com_z=450.0, seed=seed)


@pytest.fixture(scope="module")
def calls():
    """Each traced call of the port, at small widths, by the root span it
    records."""
    torch.manual_seed(0)
    raw = _raw()
    draws = draw_augmentation(2, torch.Generator().manual_seed(4), torch.device("cpu"))
    pw = create_train_state(PixelwiseRegression(JOINTS, stage=2, features=16, level=2,
                                                norm_method="instance_anchored"), lr=1e-3)
    fr = create_train_state(FullRegression(JOINTS, stage=1, label_size=32, features=16, level=2,
                                           norm_method="instance_anchored"), lr=1e-3)
    step = make_train_step(CFG, LossConfig())
    step_fr = make_train_step_fullreg(CFG)
    pred = Predictor.from_state_dict(
        PixelwiseRegression(JOINTS, stage=1, features=16, level=2).state_dict(), "NYU", "cpu",
        batch_size=2, stages=1, features=16, level=2, label_size=32)
    return {"train_step": lambda: step(pw, to_device(raw, "cpu"), draws=draws),
            "train_step_fullreg": lambda: step_fr(fr, to_device(raw, "cpu"), draws=draws),
            "predict": lambda: pred.predict(raw["frame"], raw["com"])}


def _profiled(fn, window="port_bench.window"):
    """``fn`` under the profiler inside a first range, as the benchmark's
    harness runs it: the first range of a profiler session can take about a
    millisecond to open (the profiler's own set-up), which then falls on
    that range."""
    with torch.profiler.profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(window):
            t = time.monotonic()
            out = fn()
    return prof, out, t


def test_the_switch_is_the_profilers_flag():
    """``obs.tracing`` reads ``torch.autograd.profiler._is_profiler_enabled``:
    a torch that renames it fails here instead of turning the spans off."""
    assert hasattr(torch.autograd.profiler, "_is_profiler_enabled")
    assert not obs.tracing()
    seen = []
    with torch.profiler.profile(activities=[ProfilerActivity.CPU]):
        seen.append(torch.autograd.profiler._is_profiler_enabled)
        t = threading.Thread(target=lambda: seen.append(obs.tracing()))
        t.start()
        t.join(60)
        assert not t.is_alive()
    assert seen == [True, True]
    assert not obs.tracing()


@pytest.mark.parametrize("call", ["train_step", "train_step_fullreg", "predict"])
def test_tracing_off_records_nothing_and_opens_no_range(calls, call, monkeypatch):
    entered = []

    class Counting(torch.profiler.record_function):
        def __init__(self, name, *a, **kw):
            entered.append(name)
            super().__init__(name, *a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", Counting)
    obs.clear()
    calls[call]()
    assert obs.spans() == []
    ours = {n for root, kids in CHILDREN.items() for n in [root, *kids]}
    assert not ours & set(entered)
    assert obs.span("a") is obs.span("b")


def _trees(records):
    """{root span: its children in order} of ``records``."""
    by_id = {s.id: s for s in records}
    kids = {s.id: [] for s in records if s.parent is None}
    for s in sorted(records, key=lambda s: s.start_ns):
        if s.parent is not None:
            assert s.parent == s.root and by_id[s.root].thread == s.thread
            kids[s.root].append(s)
    return {by_id[r]: k for r, k in kids.items()}


@pytest.mark.parametrize("call, roots", [("train_step", ["loader.to_device", "train.step"]),
                                         ("train_step_fullreg",
                                          ["loader.to_device", "train.step"]),
                                         ("predict", ["serve.predict"])])
def test_tracing_on_records_each_boundary_under_its_root(calls, call, roots):
    obs.clear()
    _profiled(calls[call])
    trees = _trees(obs.spans())
    assert [r.name for r in sorted(trees, key=lambda s: s.start_ns)] == roots
    for root, kids in trees.items():
        assert [k.name for k in kids] == CHILDREN[root.name]
        assert all(root.start_ns <= k.start_ns <= k.end_ns <= root.end_ns for k in kids)
        assert all(a.end_ns <= b.start_ns for a, b in zip(kids, kids[1:]))
    obs.clear()
    assert obs.spans() == []


def test_two_threads_each_get_their_own_tree(calls):
    """Two clients calling one Predictor at once: one ``serve.predict`` tree
    a call, each on its own thread."""
    gate = threading.Barrier(2)

    def client():
        gate.wait(60)
        for _ in range(2):
            calls["predict"]()

    obs.clear()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU]):
        threads = [threading.Thread(target=client) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    assert not any(t.is_alive() for t in threads)
    trees = _trees(obs.spans())
    assert len(trees) == 4
    assert len({r.thread for r in trees}) == 2
    for root, kids in trees.items():
        assert root.name == "serve.predict"
        assert [k.name for k in kids] == CHILDREN["serve.predict"]


def _annotations(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def test_profiling_thread_spans_are_ranges_of_the_trace(calls, tmp_path):
    """Each span of the profiling thread is the trace's range of the same
    name, of the same length within 10% or 100 us."""
    obs.clear()
    prof, _, _ = _profiled(lambda: (calls["train_step"](), calls["predict"]()))
    ranges = _annotations(prof, tmp_path)
    spans = obs.spans()
    assert len(spans) == 11
    for name in {s.name for s in spans}:
        ours = sorted((s for s in spans if s.name == name), key=lambda s: s.start_ns)
        theirs = sorted((e for e in ranges if e["name"] == name), key=lambda e: float(e["ts"]))
        assert len(ours) == len(theirs), name
        for s, e in zip(ours, theirs):
            d = (s.end_ns - s.start_ns) * 1e-3
            assert abs(d - float(e["dur"])) <= max(0.1 * d, 100.0), (name, d, e["dur"])


def placement_errors_us(fn, tmp_path, window="port_bench.window"):
    """How far from their own ranges two rules place the spans of ``fn``
    on the trace, in us (median of the absolute errors of the starts): the
    rule of ``port_bench/harness.profile`` (the window range's start plus
    the span's monotonic time since the window opened) and an offset
    between the clocks taken from the profiling thread's spans (their
    median)."""
    obs.clear()
    prof, _, t = _profiled(fn, window)
    ranges = _annotations(prof, tmp_path)
    ts0 = next(float(e["ts"]) for e in ranges if e["name"] == window)
    pairs = []
    for name in {s.name for s in obs.spans()}:
        ours = sorted((s for s in obs.spans() if s.name == name), key=lambda s: s.start_ns)
        theirs = sorted((e for e in ranges if e["name"] == name), key=lambda e: float(e["ts"]))
        pairs += [(s.start_ns * 1e-3, float(e["ts"])) for s, e in zip(ours, theirs)]
    offset = statistics.median(ts - mono for mono, ts in pairs)
    window_rule = [abs(ts0 + (mono - t * 1e6) - ts) for mono, ts in pairs]
    offset_rule = [abs(mono + offset - ts) for mono, ts in pairs]
    return statistics.median(window_rule), statistics.median(offset_rule)


def test_spans_of_other_threads_can_be_placed_on_the_trace(calls, tmp_path):
    """The profiler keeps no range of another thread, so its spans join the
    trace by their monotonic times. The harness's rule (the window's start)
    lands them early by the time the window's range took to open, about a
    millisecond; an offset taken from the profiling thread's spans lands
    them within 100 us."""
    window_rule, offset_rule = placement_errors_us(calls["predict"], tmp_path)
    assert offset_rule <= 100.0
    assert window_rule <= 20e3


# ---------------------------------------------------------------- the readers


def _span(name, i, ms, root=None):
    return obs.Span(name, i, root, root or i, 1, 0, int(ms * 1e6))


SPANS = [_span("train.step", 1, 500.0), _span("train.preprocess", 2, 10.0, 1),
         _span("train.forward", 3, 120.0, 1), _span("train.backward", 4, 300.0, 1),
         _span("train.optimizer", 5, 60.0, 1), _span("loader.to_device", 6, 3.0),
         _span("train.step", 7, 520.0), _span("train.preprocess", 8, 14.0, 7),
         _span("train.forward", 9, 130.0, 7), _span("train.backward", 10, 310.0, 7),
         _span("train.optimizer", 11, 62.0, 7), _span("loader.to_device", 12, 5.0),
         _span("serve.predict", 13, 200.0), _span("serve.build_batch", 14, 90.0, 13),
         _span("serve.to_device", 15, 8.0, 13), _span("serve.launch", 16, 40.0, 13),
         _span("serve.wait", 17, 60.0, 13)]
RECORD = {"trace": {"kernels": {"Memcpy HtoD (Pageable -> Device)": [0.001, 21],
                                "Memcpy DtoH (Device -> Pageable)": [0.001, 1],
                                "Memcpy HtoD (Pinned -> Device)": [0.002, 9],
                                "void at::native::elementwise_kernel": [0.1, 400]}}}
READS = {"to_device_ms.train": 4.0, "host_preprocess_ms.train": 12.0,
         "host_forward_ms.train": 125.0, "host_backward_ms.train": 305.0,
         "host_optimizer_ms.train": 61.0, "blocking_copies.train": 11.0,
         "host_batch_ms.serve": 90.0, "h2d_ms.serve": 8.0, "launch_ms.serve": 40.0,
         "wait_ms.serve": 60.0, "blocking_copies.serve": 22.0}


@pytest.mark.parametrize("name", sorted(READS))
def test_each_reader_of_the_spans(name, monkeypatch):
    from port_bench import harness
    assert name in {m["name"] for m in harness.benchmark()["per_layer"]}
    reader = harness.metric_reader(name)
    monkeypatch.setattr(obs, "spans", lambda: list(SPANS))
    assert reader.read(RECORD) == pytest.approx(READS[name], rel=1e-12)
    root = "serve.predict" if name.endswith(".serve") else "train.step"
    monkeypatch.setattr(obs, "spans", lambda: [s for s in SPANS if s.name != root])
    assert reader.read(RECORD) is None
    # a program without the span module reads nothing
    monkeypatch.setattr(obs, "spans", lambda: list(SPANS))
    monkeypatch.delattr(pixelwiseregression_tpu_torch, "obs")
    monkeypatch.setitem(sys.modules, "pixelwiseregression_tpu_torch.obs", None)
    assert reader.read(RECORD) is None


def test_the_readers_on_a_traced_window(calls):
    """The readers on the spans of real calls: a train step's phases sum to
    at most the step, and to_device is read per step."""
    from port_bench import harness
    obs.clear()
    _profiled(lambda: (calls["train_step"](), calls["train_step"]()))
    read = {n: harness.metric_reader(n).read({"trace": {"kernels": {}}}) for n in READS}
    step = statistics.mean((s.end_ns - s.start_ns) * 1e-6 for s in obs.spans()
                           if s.name == "train.step")
    phases = [read[f"host_{p.split('.')[1]}_ms.train"] for p in PHASES]
    assert all(v > 0 for v in phases) and read["to_device_ms.train"] > 0
    assert sum(phases) <= step
    assert read["blocking_copies.train"] == 0.0
    assert read["host_batch_ms.serve"] is None
