"""The plain reference against the port on the CPU at small widths, and the
comparison that decides ``correct`` shown to fail: the control (the
reference with TF32 operands in the program's place) and a run whose
timed path is broken underneath, once for each fault a cell can have (a
step that leaves its state unchanged, half of the batch left out with the
mean over the rest, an answer altered where it is produced; the exchange
between chips does not exist on one chip).

    python -m pytest port_bench/tests -q
"""

import types

import numpy as np
import pytest
import torch

from port_bench import harness
from port_bench import run as bench_run
from port_bench.reference import preprocess as ref_pp

CPU = torch.device("cpu")
TRAIN = ["train.nyu_pixelwise.b128", "train.nyu_fullreg.b128"]
SERVE = "serve.nyu_pixelwise.c2x32"
SEED = 2**31 + 21


def _parts(root, workload):
    bench = harness.benchmark(root)
    w = harness.cell(bench, workload)
    mix = harness.traffic(w["traffic"], root)
    return (harness.config(bench, w["config"], root), mix, harness.driver(mix["driver"], root),
            harness.limits(workload, root))


def _line(root, workload, trace=0):
    args = types.SimpleNamespace(workload=workload, seed=SEED, seconds=0.5, trace=trace)
    return bench_run.run_cell(args, CPU, root=root)


def test_the_reference_preprocess_equals_the_port(small):
    from pixelwiseregression_tpu_torch.data.preprocess import PreprocessConfig, preprocess_batch
    cfg, mix, drv, _ = _parts(small, TRAIN[0])
    prog = drv.build(cfg, mix, SEED, CPU)
    batch = {k: torch.from_numpy(v) for k, v in prog["pool"][0].items()}
    pp, cam = cfg["preprocess"], cfg["dataset"]["camera"]
    pcfg = PreprocessConfig(fx=cam["fx"], fy=cam["fy"], halfu=cam["halfu"], halfv=cam["halfv"],
                            image_size=pp["image_size"], label_size=pp["label_size"],
                            kernel_size=pp["kernel_size"], sigma=pp["sigma"],
                            using_rotation=True, using_scale=True, using_shift=True)
    for test_only, draws in ((False, prog["draws"][0]), (True, None)):
        port = preprocess_batch(batch, pcfg, test_only=test_only, augment=not test_only,
                                draws=draws)
        ref = ref_pp.preprocess(batch, {**pp, **cam}, test_only=test_only, draws=draws)
        for k in ("img", "label_img", "mask"):
            assert torch.equal(port[k][..., 0], ref[k][:, 0]), k
        if not test_only:
            assert torch.equal(port["heatmaps"].permute(0, 3, 1, 2), ref["heatmaps"])
            assert torch.equal(port["dmaps"].permute(0, 3, 1, 2), ref["dmaps"])
            assert torch.equal(port["uvd"], ref["uvd"])
            assert torch.equal(port["valid"], ref["valid"])


def test_the_reference_crop_integers_equal_the_port():
    from pixelwiseregression_tpu_torch.data.sources import SPECS, load_bbox, make_record
    cfg = harness.config(harness.benchmark(), "nyu_pixelwise")
    ds, spec = cfg["dataset"], SPECS["NYU"]
    frame = np.zeros((ds["frame_h"], ds["frame_w"]), np.float32)
    for com in ([320.7, 240.2, 600.0], [12.5, 470.9, 411.0], [633.0, 3.0, 950.5]):
        com = np.asarray(com)
        port = make_record(spec, frame, None, com, spec.cube_size,
                           load_bbox(spec, com, spec.cube_size))
        ref = ref_pp.crop_record(frame.shape, com, ds["cube"], ds["camera"], ds["bbox_margin"])
        for k, v in ref.items():
            np.testing.assert_array_equal(v, port[k], err_msg=k)


@pytest.mark.parametrize("workload", TRAIN + [SERVE])
def test_the_program_is_correct_against_the_reference(small, workload):
    line = _line(small, workload)
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0


@pytest.mark.parametrize("workload", TRAIN)
def test_the_control_fails_a_train_cell(small, workload):
    cfg, mix, drv, lim = _parts(small, workload)
    prog = drv.build(cfg, mix, SEED, CPU)
    n = mix["setup_steps"]
    ref = drv.reference(cfg, mix, prog, n, CPU)
    control = drv.reference(cfg, mix, prog, n, CPU, tf32=True)
    numbers = harness.train_numbers(control, ref, drv.MOVED_SHARE)
    assert any(numbers[k] > lim[k] for k in lim), (numbers, lim)


def test_the_control_fails_the_serving_cell(small):
    cfg, mix, drv, lim = _parts(small, SERVE)
    _, weights, requests = drv.build(cfg, mix, SEED, CPU)
    ref = drv.reference(cfg, mix, weights, requests, CPU)
    control = drv.reference(cfg, mix, weights, requests, CPU, tf32=True)
    numbers = drv.gaps([(r, 0, 0, a["uvd"], a["xyz"]) for r, a in enumerate(control)], ref)
    assert any(numbers[k] > lim[k] for k in lim), (numbers, lim)


def _half_batch(fn):
    """A loss over the first half of the batch, its mean over those samples."""
    def broken(results, *args):
        args = list(args)
        i = len(args) - 1
        sw = args[i]
        b = sw.shape[0]
        args[i] = torch.cat([sw[: b // 2], torch.zeros_like(sw[b // 2:])])
        return fn(results, *args)
    return broken


@pytest.mark.parametrize("workload", TRAIN)
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
def test_a_broken_train_step_is_not_correct(small, monkeypatch, workload, fault):
    from pixelwiseregression_tpu_torch.train import loop
    if fault == "state_unchanged":
        monkeypatch.setattr(torch.optim.AdamW, "step", lambda self, closure=None: None)
    else:
        monkeypatch.setattr(loop, "stage_losses", _half_batch(loop.stage_losses))
        monkeypatch.setattr(loop, "uvd_losses", _half_batch(loop.uvd_losses))
    line = _line(small, workload)
    assert not line["correct"], line["checks"]


def test_an_altered_answer_is_not_correct(small, monkeypatch):
    from pixelwiseregression_tpu_torch import serve

    def altered(uvd, *args):
        # one joint's u moved by 10 px: past the limit, which float32's
        # rounding on random weights sets at 4 (PERF.md)
        out = serve_recover(uvd, *args)
        return out + 10.0 * torch.nn.functional.one_hot(torch.tensor(0), out.numel()).reshape(
            out.shape)

    serve_recover = serve.recover_uvd
    monkeypatch.setattr(serve, "recover_uvd", altered)
    line = _line(small, SERVE)
    assert not line["correct"], line["checks"]
