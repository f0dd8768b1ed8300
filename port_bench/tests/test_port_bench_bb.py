"""The HANDS 2017 box-request cell on the CPU at small widths: the program
against the reference, the comparison that decides ``correct`` shown to
fail for the control and for each way of breaking the box step (the box
ignored, one round of the cut instead of two, the raw frame handed to the
network), the scene's cut removing pixels in both rounds of every pooled
frame, with the background behind the hand in every box, and the run's
check of the program's localisation counter.

    python -m pytest port_bench/tests -q
"""

import json
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from port_bench import harness, scene
from port_bench import run as bench_run
from port_bench.reference import localize as ref_localize
from port_bench.tests.conftest import REPO

CPU = torch.device("cpu")
CELL = "serve.hand17_pixelwise.bb_c2x32"
SEED = 2**31 + 23


def _line(root, seed=SEED):
    args = types.SimpleNamespace(workload=CELL, seed=seed, seconds=0.5, trace=0)
    return bench_run.run_cell(args, CPU, root=root)


def test_the_program_is_correct_against_the_reference(small):
    line = _line(small)
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert set(line["checks"]) == {"uvd_gap", "xyz_gap", "com_gap"}


def test_the_control_fails_the_cell(small):
    bench = harness.benchmark(small)
    w = harness.cell(bench, CELL)
    cfg, mix = harness.config(bench, w["config"], small), harness.traffic(w["traffic"], small)
    drv, lim = harness.driver(mix["driver"], small), harness.limits(CELL, small)
    _, weights, requests = drv.build(cfg, mix, SEED, CPU)
    ref = drv.reference(cfg, mix, weights, requests, CPU)
    control = drv.reference(cfg, mix, weights, requests, CPU, tf32=True)
    numbers = drv.gaps([(r, 0, 0, a["uvd"], a["xyz"], a["com"]) for r, a in enumerate(control)],
                       ref)
    assert any(numbers[k] > lim[k] for k in lim), (numbers, lim)


def _one_round(frame, bounds):
    from pixelwiseregression_tpu_torch.ops import localize
    _, h, w = frame.shape
    rows = torch.arange(h, dtype=torch.float64)[None, :, None]
    cols = torch.arange(w, dtype=torch.float64)[None, None, :]
    top, bottom, left, right = (bounds[:, i, None, None] for i in range(4))
    inside = (rows >= top) & (rows < bottom) & (cols >= left) & (cols < right)
    f = frame.to(torch.float64) * inside.to(torch.float64)
    return torch.where(f > localize._mean(f, f > 0) + localize.CUT_MM, 0.0, f)


@pytest.mark.parametrize("fault", ["box_ignored", "one_round", "raw_frame"])
def test_a_broken_box_step_is_not_correct(small, monkeypatch, fault):
    from pixelwiseregression_tpu_torch import serve
    from pixelwiseregression_tpu_torch.ops import localize
    if fault == "box_ignored":
        clean = localize.clean
        monkeypatch.setattr(localize, "clean", lambda frame, bounds: clean(
            frame, torch.tensor([[0, frame.shape[1], 0, frame.shape[2]]],
                                dtype=torch.float64).expand(frame.shape[0], 4)))
    elif fault == "one_round":
        monkeypatch.setattr(localize, "clean", _one_round)
    else:
        good = serve.localize

        def raw(frame, *args):
            batch, com, empty = good(frame, *args)
            return {**batch, "frame": frame}, com, empty

        monkeypatch.setattr(serve, "localize", raw)
    line = _line(small)
    assert not line["correct"], line["checks"]


def test_a_run_fails_where_the_frames_are_not_localised_on_the_device(small, monkeypatch):
    from pixelwiseregression_tpu_torch import serve
    from pixelwiseregression_tpu_torch.ops import localize
    good = serve.localize

    def uncounted(frame, bounds, cube, camera, count):
        out = good(frame, bounds, cube, camera, count)
        localize.LOCALIZED -= count
        return out

    monkeypatch.setattr(serve, "localize", uncounted)
    with pytest.raises(RuntimeError, match="localised on the device"):
        _line(small)


def test_the_program_counts_the_frames_it_localises(small):
    from pixelwiseregression_tpu_torch.ops import localize
    bench = harness.benchmark(small)
    w = harness.cell(bench, CELL)
    cfg, mix = harness.config(bench, w["config"], small), harness.traffic(w["traffic"], small)
    pred, _, requests = harness.driver(mix["driver"], small).build(cfg, mix, SEED, CPU)
    frames, boxes = requests[0]
    before = localize.LOCALIZED
    pred.predict(frames, boxes=boxes)
    pred.predict(frames[:1], boxes=boxes[:1])
    assert localize.LOCALIZED - before == len(frames) + 1


@pytest.mark.parametrize("seed", [0, 2**31 + 5, 3100000001])
def test_both_rounds_of_the_cut_remove_pixels_in_every_pooled_frame(seed):
    bench = harness.benchmark()
    w = harness.cell(bench, CELL)
    cfg, mix = harness.config(bench, w["config"]), harness.traffic(w["traffic"])
    for req in scene.pool(cfg, mix, seed, CPU):
        # the background lies behind the hand everywhere in the box
        assert (req["clear_mm"] >= scene.BG_CLEAR_MM - 1e-9).all(), (seed, req["clear_mm"].min())
        for frame, box in zip(req["frame"], req["box"]):
            u0, v0, du, dv = box
            f = np.zeros(frame.shape)
            sl = np.s_[int(v0):int(v0 + dv), int(u0):int(u0 + du)]
            f[sl] = frame[sl]
            keep = f > 0
            first = keep & (f > f[keep].mean() + ref_localize.CUT_MM)
            left = keep & ~first
            second = left & (f > f[left].mean() + ref_localize.CUT_MM)
            assert first.any() and second.any(), (seed, box)


def test_the_box_reference_and_the_scene_load_nothing_of_the_program():
    code = ("import sys, json\nimport port_bench.reference.localize, port_bench.scene\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "port_bench" in loaded
    assert not {m for m in loaded if m.startswith("pixelwiseregression_tpu")} | (loaded & {"jax"})


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [CELL, "serve.nyu_fullreg.c2x32"])
def test_each_new_cell_at_small_widths_on_the_card(small, card, workload):
    bench = harness.benchmark(small)
    lines = [bench_run.run_cell(types.SimpleNamespace(workload=workload, seed=2**31 + 3,
                                                      seconds=1.0, trace=trace), card, root=small)
             for trace in (0, 1)]
    for line in lines:
        assert line["correct"], line["checks"]
        assert line["device"]["platform"] == "gpu"
    e2e = {m["name"] for m in bench["end_to_end"] if harness.applies(m, workload)}
    assert set(lines[0]["metrics"]) == e2e
    want = {m["name"] for m in bench["per_layer"] if harness.applies(m, workload, e2e)}
    assert set(lines[1]["metrics"]) == want
