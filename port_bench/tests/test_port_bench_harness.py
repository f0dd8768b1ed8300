"""The harness on the CPU: its arithmetic against forward hooks and the
kernel table's bounds, its parts found by name, its import guard, its
refusal to run without a card, the copied traffic generator, the trace
reduction; and, on a card (``cuda``), each cell at small widths end to end.

    python -m pytest port_bench/tests -q
"""

import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from port_bench import arith, harness, synth
from port_bench.reference import model as ref_model
from port_bench.tests.conftest import REPO

GFLOP = {"nyu_pixelwise": 20.879376384, "nyu_fullreg": 6.79088128}


def _hooked_flops(cfg) -> int:
    """FLOP of the reference's convs and dense layers, by forward hooks on
    the meta device (shapes only)."""
    total = [0]

    def hook(m, _inputs, out):
        if isinstance(m, ref_model.Conv):
            co, ci, k, _ = m.weight.shape
            total[0] += 2 * k * k * ci * co * out.shape[2] * out.shape[3]
        elif isinstance(m, ref_model.Dense):
            total[0] += 2 * m.weight.shape[0] * m.weight.shape[1]

    with torch.device("meta"):
        net = ref_model.build(cfg, "instance")
        for m in net.modules():
            m.register_forward_hook(hook)
        s = cfg["model"]["image_size"]
        img, lab = torch.empty(1, 1, s, s), torch.empty(1, 1, s // 2, s // 2)
        net(img, lab, lab)
    return total[0]


@pytest.mark.parametrize("name", sorted(GFLOP))
def test_flop_count_matches_forward_hooks(name):
    cfg = harness.config(harness.benchmark(), name)
    assert arith.forward_flops(cfg) == _hooked_flops(cfg)
    assert arith.forward_flops(cfg) / 1e9 == pytest.approx(GFLOP[name], rel=1e-12)


def test_flop_count_matches_the_port_bench():
    from pixelwiseregression_tpu_torch import bench
    cfg = harness.config(harness.benchmark(), "nyu_pixelwise")
    args = types.SimpleNamespace(seed=0, joints=14, features=128, level=4, norm_method="instance",
                                 decoder="torch", dtype="f32", quant="none")
    assert arith.forward_flops(cfg) == bench.conv_flops(bench.build_model(args, 2, "cpu"))


@pytest.mark.parametrize("nbytes, bound_ms", [
    (arith.k1_bytes(128, 14, 4096, "f32", "f32"), 0.02755),
    (arith.k1_bytes(32, 14, 4096, "bf16", "bf16"), 0.00344),
    (arith.k2_bytes(128, 14, 4096), 0.04509),
    (arith.k2_bytes(128, 14, 4096, dlabel=True), 0.04571),
])
def test_decoder_bytes_match_the_kernel_table(nbytes, bound_ms):
    assert nbytes / arith.PEAK_BYTES * 1e3 == pytest.approx(bound_ms, abs=1.5e-5)


def test_a_new_config_mix_and_metric_are_found_by_name(small):
    bench = json.loads((small / "BENCHMARK.json").read_text())
    cfg = json.loads((small / "port_bench/configs/nyu_pixelwise.json").read_text())
    (small / "port_bench/configs/other.json").write_text(json.dumps({**cfg, "name": "other"}))
    (small / "port_bench/traffic/other_mix.json").write_text(json.dumps({"driver": "predict"}))
    (small / "port_bench/limits/w.other.json").write_text(json.dumps({"uvd_gap": 1.0}))
    (small / "port_bench/metrics/frames_seen.serve.py").write_text(
        "def read(record):\n    return record.get('frames_per_s')\n")
    bench["configs"].append({"name": "other", "source": "x", "file": "port_bench/configs/other.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "w.other", "config": "other", "traffic": "other_mix",
                               "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "frames_seen.serve", "unit": "frames/s", "better": "higher",
                               "source": "host_clock", "layer": "x",
                               "moves": "serve_frames_per_s"})
    (small / "BENCHMARK.json").write_text(json.dumps(bench))
    b = harness.benchmark(small)
    w = harness.cell(b, "w.other")
    assert harness.config(b, w["config"], small)["name"] == "other"
    mix = harness.traffic(w["traffic"], small)
    assert harness.driver(mix["driver"], small).run.__name__ == "run"
    assert harness.limits("w.other", small) == {"uvd_gap": 1.0}
    metric = b["per_layer"][-1]
    assert harness.applies(metric, "w.other", {"serve_frames_per_s", "setup_s"})
    assert not harness.applies(metric, "w.other", {"train_frames_per_s", "setup_s"})
    assert harness.metric_reader(metric["name"], small).read({"frames_per_s": 3.0}) == 3.0


def _modules_after(code: str, cwd) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\nprint(json.dumps("
                          "sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=cwd, capture_output=True, text=True, timeout=600,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_neither_jax_nor_the_jax_package(small):
    code = (f"import sys, types, torch\nsys.path.insert(0, {str(REPO)!r})\n"
            "from pathlib import Path\nfrom port_bench import run\n"
            "args = types.SimpleNamespace(workload='serve.nyu_pixelwise.c2x32', seed=5, "
            "seconds=0.3, trace=1)\n"
            f"line = run.run_cell(args, torch.device('cpu'), root=Path({str(small)!r}))\n"
            "assert line['correct'], line")
    loaded = _modules_after(code, REPO)
    assert "pixelwiseregression_tpu_torch" in loaded
    assert not loaded & set(harness.FORBIDDEN), loaded & set(harness.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    loaded = _modules_after("import port_bench.reference.steps, port_bench.synth, "
                            "port_bench.arith", REPO)
    assert "port_bench" in loaded
    assert not {m for m in loaded if m.startswith("pixelwiseregression_tpu")}


def test_the_run_refuses_without_a_card():
    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload",
                          "train.nyu_pixelwise.b128", "--seed", str(2**31 + 7), "--seconds", "1",
                          "--trace", "0"], cwd=REPO, capture_output=True, text=True, timeout=300,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 2
    assert out.stdout == ""
    assert "CUDA" in out.stderr


def test_the_copied_generator_matches_the_port():
    from pixelwiseregression_tpu_torch.utils.synth import make_synthetic_raw_batch
    kw = dict(fx=147.0, fy=146.8, cube=150.0, seed=2**32 - 3)
    ours = synth.raw_batch(3, 60, 80, 5, **kw)
    port = make_synthetic_raw_batch(3, 60, 80, 5, **kw)
    assert ours.keys() == port.keys()
    for k in ours:
        np.testing.assert_array_equal(ours[k], port[k], err_msg=k)


def test_the_seed_fixes_the_inputs_and_weights():
    cfg = harness.config(harness.benchmark(), "nyu_pixelwise")
    net = ref_model.build(cfg, "instance_anchored")
    seed = 2**31 + 11
    a, b, c = (synth.weights(net, s, "cpu") for s in (seed, seed, seed + 1))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["conv.0.weight"], c["conv.0.weight"])
    assert float(a["conv.0.weight"].std()) == pytest.approx((2.0 / (9 + 32 * 9)) ** 0.5, rel=0.05)
    d1, d2 = synth.draws(2, 4, seed, "cpu"), synth.draws(2, 4, seed, "cpu")
    assert torch.equal(d1[1]["angle"], d2[1]["angle"])


def test_the_trace_reduction():
    ev = [{"ph": "X", "cat": "user_annotation", "name": harness.WINDOW, "ts": 0, "dur": 100},
          {"ph": "X", "cat": "cpu_op", "name": "outer", "ts": 0, "dur": 90},
          {"ph": "X", "cat": "cpu_op", "name": "aten::pin_memory", "ts": 40, "dur": 30},
          {"ph": "X", "cat": "cpu_op", "name": "early", "ts": -3000, "dur": 1},
          {"ph": "X", "cat": "kernel", "name": "k_a", "ts": 10, "dur": 20},
          {"ph": "X", "cat": "kernel", "name": "k_b", "ts": 25, "dur": 10},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 80, "dur": 5},
          {"ph": "X", "cat": "kernel", "name": "stale", "ts": -50, "dur": 5}]
    t = harness.reduce_trace(ev, 100e-6)
    assert t["busy_s"] == pytest.approx(30e-6)
    assert t["kernels"]["k_a"] == [pytest.approx(20e-6), 1]
    assert "stale" not in t["kernels"]
    assert t["idle_gaps"] == [["aten::pin_memory", pytest.approx(45e-6)],
                              ["no traced host op", pytest.approx(15e-6)],
                              ["outer", pytest.approx(10e-6)]]
    assert t["device_ops"][0][0] == "k_a"


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["train.nyu_pixelwise.b128", "serve.nyu_pixelwise.c2x32",
                                      "train.nyu_fullreg.b128"])
def test_each_cell_at_small_widths_on_the_card(small, card, workload):
    from port_bench import run
    bench = harness.benchmark(small)
    lines = [run.run_cell(types.SimpleNamespace(workload=workload, seed=2**31 + 3, seconds=1.0,
                                                trace=trace), card, root=small)
             for trace in (0, 1)]
    for line in lines:
        assert line["correct"], line["checks"]
        assert line["device"]["platform"] == "gpu"
    e2e = {m["name"] for m in bench["end_to_end"] if harness.applies(m, workload)}
    assert set(lines[0]["metrics"]) == e2e
    want = {m["name"] for m in bench["per_layer"] if harness.applies(m, workload, e2e)}
    assert set(lines[1]["metrics"]) == want
    assert 0 < lines[1]["device"]["busy_s"] <= lines[1]["device"]["window_s"]
