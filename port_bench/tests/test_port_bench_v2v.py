"""The V2V-PoseNet cell (``train.nyu_v2v.b32``) on the CPU at a small grid
(an input side of 24, which halves to 12, 6 and 3) with the published
widths: the program is ``correct`` against ``reference/v2v.py``, and the
control (TF32 operands), half of the batch left out of the loss, one
voxel of a grid flipped and a gradient off in one leaf alone each turn
``correct`` false; and its arithmetic.

    python -m pytest port_bench/tests -q
"""

import json
import types

import pytest
import torch

from port_bench import arith_v2v, harness
from port_bench import run as bench_run
from port_bench.tests.conftest import REPO, small_root

CPU = torch.device("cpu")
CELL = "train.nyu_v2v.b32"
SEED = 2**31 + 25


@pytest.fixture
def small(tmp_path):
    """The benchmark at small widths (``small_root``: batches of 2), the V2V
    grid at 24 and its trace at one step."""
    root = small_root(tmp_path)
    f = root / "port_bench" / "configs" / "nyu_v2v.json"
    c = json.loads(f.read_text())
    c["model"].update(in_size=24, out_size=12)
    c["voxel"].update(side=24, out_side=12)
    f.write_text(json.dumps(c))
    t = root / "port_bench" / "traffic" / "train_vox_b32.json"
    t.write_text(json.dumps({**json.loads(t.read_text()), "trace_steps": 1, "pool": 3}))
    return root


def _line(root, trace=0):
    args = types.SimpleNamespace(workload=CELL, seed=SEED, seconds=0.3, trace=trace)
    return bench_run.run_cell(args, CPU, root=root)


def test_the_v2v_cell_is_correct_and_traced(small):
    line = _line(small, trace=1)
    assert line["correct"], line["checks"]
    assert line["checks"]["voxel_gap"]["value"] == 0
    assert line["attempted"] > 0 and line["failed"] == 0
    metrics = line["metrics"]
    assert metrics["host_voxelize_ms.train"]["value"] > 0
    # no kernel on the CPU: the readers of the trace find none, and say 0 or nothing
    assert metrics["voxelize_ms.train"]["value"] == 0.0
    assert "voxelize_roofline.train" not in metrics
    assert {"train_mfu", "host_preprocess_ms.train", "to_device_ms.train"} <= set(metrics)


# the stem's 7^3 conv: a fault confined to it moves no median leaf
STEM = "front_layers.0.block.0.weight"


@pytest.mark.parametrize("fault", ["control_tf32", "half_batch", "voxel_flipped", "one_leaf"])
def test_a_fault_is_not_correct(small, monkeypatch, fault):
    bench = harness.benchmark(small)
    w = harness.cell(bench, CELL)
    cfg, mix = harness.config(bench, w["config"], small), harness.traffic(w["traffic"], small)
    drv, lim = harness.driver(mix["driver"], small), harness.limits(CELL, small)
    prog = drv.build(cfg, mix, SEED, CPU)
    n = mix["setup_steps"]
    if fault == "voxel_flipped":
        from pixelwiseregression_tpu_torch.train import loop
        inputs = loop.v2v_inputs

        def flipped(*args):
            grid, target, coef = inputs(*args)
            grid = grid.clone()
            grid.view(-1)[7] = 1.0 - grid.view(-1)[7]
            return grid, target, coef

        monkeypatch.setattr(loop, "v2v_inputs", flipped)
        readings = drv.setup_steps(cfg, prog, n, CPU)
        numbers = drv.numbers(readings, drv.reference(cfg, mix, prog, n, CPU))
        assert numbers["voxel_gap"] == n
    elif fault == "one_leaf":
        readings = drv.setup_steps(cfg, prog, n, CPU)
        readings["grad_norms"][STEM] *= 1.01
        readings["change_norms"][STEM] *= 1.01
        numbers = drv.numbers(readings, drv.reference(cfg, mix, prog, n, CPU))
        assert numbers["grad_median_gap"] <= lim["grad_median_gap"], numbers
        assert numbers["grad_gap"] > lim["grad_gap"] and numbers["change_gap"] > lim["change_gap"]
    else:
        ref = drv.reference(cfg, mix, prog, n, CPU)
        kw = {"control_tf32": {"tf32": True}, "half_batch": {"half_batch": True}}[fault]
        alt = drv.reference(cfg, mix, prog, n, CPU, **kw)
        numbers = drv.numbers(alt, ref)
    assert any(numbers[k] > lim[k] for k in lim), (numbers, lim)


def test_the_flop_count_and_the_voxeliser_bytes():
    cfg = harness.config(harness.benchmark(), "nyu_v2v")
    assert arith_v2v.forward_flops(cfg) / 1e9 == pytest.approx(72.759402496, rel=1e-12)
    assert arith_v2v.forward_flops(cfg) == cfg["gflop_per_frame"] * 1e9
    # 39.3 MB of frames, 87.2 MB of grids at the cell's shape: 37.6 us at 3.35 TB/s
    nbytes = arith_v2v.voxelize_bytes(32, 480, 640, 88)
    assert nbytes == 4 * (32 * 480 * 640 + 32 * 17 + 32 * 88 ** 3)


def test_neither_the_reference_nor_the_v2v_path_loads_jax():
    from port_bench.tests.test_port_bench_harness import _modules_after
    loaded = _modules_after("import port_bench.reference.v2v, port_bench.arith_v2v", REPO)
    assert not {m for m in loaded if m.startswith("pixelwiseregression_tpu")}
    loaded = _modules_after("import pixelwiseregression_tpu_torch.models.v2v, "
                            "pixelwiseregression_tpu_torch.cli.train_v2v", REPO)
    assert not loaded & set(harness.FORBIDDEN), loaded & set(harness.FORBIDDEN)
