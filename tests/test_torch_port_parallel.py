"""The port's multi-process training and serving (``parallel/mesh.py``) on
the CPU: two gloo ranks (spawned processes,
``tests/torch_port_ddp_worker.py``) against one process on the global
batch, for the PixelwiseRegression and the FullRegression steps, with
batch and anchored norms and one sample masked on rank 0 only; the copy of
``process_local_lines`` against the JAX function; the train CLI under
torchrun; ``Predictor(data_parallel=True)`` against the single Predictor.
Each comparison states its tolerance.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from pixelwiseregression_tpu.parallel import mesh as jmesh

from pixelwiseregression_tpu_torch.models.fullregression import FullRegression
from pixelwiseregression_tpu_torch.models.pixelwise import PixelwiseRegression
from pixelwiseregression_tpu_torch.parallel import mesh
from pixelwiseregression_tpu_torch.serve import Predictor
from pixelwiseregression_tpu_torch.serve_artifact import export_artifact

import torch_port_ddp_worker as worker
from test_torch_port_cli import FIXTURE, REPO
from test_torch_port_ops import _AUG, _CAM, _train_batch
import torch_port_threads
from torch_port_threads import one_thread  # noqa: F401 (autouse)

B, LABEL, SEED = 6, 32, 7
CASES = [("pixelwise", "batch"), ("pixelwise", "instance_anchored"), ("fullreg", "batch"),
         ("fullreg", "instance_anchored")]


def _case(kind, norm):
    """A small model's state (anchors calibrated by one train-mode forward),
    the global batch (sample 2 fails on every path; the pixelwise step's
    weight masks sample 0 too: both on rank 0, so the ranks' valid counts
    differ) and the configs."""
    torch.manual_seed(1)
    if kind == "pixelwise":
        kw = dict(joints=14, stage=2, features=16, level=2, norm_method=norm, decoder="cuda")
        model = PixelwiseRegression(**kw)
    else:
        kw = dict(joints=14, stage=1, label_size=LABEL, features=16, norm_method=norm)
        model = FullRegression(**kw)
    raw = {k: torch.from_numpy(v) for k, v in _train_batch(n=B).items()}
    if norm == "instance_anchored":
        with torch.no_grad():
            model.train()(torch.rand(2, 1, 2 * LABEL, 2 * LABEL), torch.rand(2, 1, LABEL, LABEL),
                          torch.ones(2, 1, LABEL, LABEL))
    if kind == "pixelwise":
        raw["weight"] = torch.tensor([0.0, 1, 1, 1, 1, 1])
    cfg = dict(_CAM, image_size=2 * LABEL, label_size=LABEL, **_AUG)
    return {"kind": kind, "model": kw, "state": model.state_dict(), "batch": raw, "cfg": cfg,
            "eval_cfg": dict(_CAM, image_size=2 * LABEL, label_size=LABEL),
            "camera": dict(fx=_CAM["fx"], fy=_CAM["fy"], halfu=_CAM["halfu"],
                           halfv=_CAM["halfv"]),
            "loss": dict(lambda_h=1.0, lambda_d=0.01, alpha=0.5)}


def _spawn(tmp_path, cases, world=2, device="cpu", timeout=300):
    """Run the worker on ``world`` ranks (``worker.spawn``, one intra-op
    thread each: ``torch_port_threads.env``); returns each rank's saved
    results."""
    path = str(tmp_path / "cases.pt")
    torch.save({"cases": cases, "seed": SEED}, path)
    return worker.spawn(path, str(tmp_path), world, device, timeout=timeout,
                        env=torch_port_threads.env())


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Every case on two gloo ranks and in this process on the global batch
    (on one intra-op thread, as the ranks run: ``one_thread``)."""
    cases = [_case(*c) for c in CASES]
    ranks = _spawn(tmp_path_factory.mktemp("ddp"), cases)
    single = [worker.run_case(c, torch.device("cpu"), SEED, local=False) for c in cases]
    return cases, ranks, single


def _adam_step(g, lr=1e-3, eps=1e-8):
    """AdamW's first step (zero moments, no weight decay) for gradient ``g``."""
    return -lr * g / (np.abs(g) + eps)


@pytest.mark.parametrize("index", range(len(CASES)), ids=[f"{k}-{n}" for k, n in CASES])
def test_two_ranks_take_the_global_batch_step(two_ranks, index):
    """Each rank's step equals the one-process step on the global batch:
    loss and stage losses rtol 1e-5; the summed gradient within 1e-5 of its
    norm (BatchNorm: 1e-3, as its backward through E[x^2] - E[x]^2 sums
    cancelling terms over the batch, whose f32 order the split changes:
    measured 1.2e-4 to 1.6e-4 between 3 + 3 and 6 samples); params after one AdamW step (lr 1e-3) atol 1e-6 beyond what the
    two gradients' own difference moves Adam's first step,
    |step(g_2rank) - step(g_1rank)| (a gradient summed in another order
    differs by rounding, and Adam's lr * g / (|g| + 1e-8) turns that into up
    to lr where g is rounding itself: a bias that feeds a norm, an entry
    that cancels); BatchNorm's running statistics and the anchors atol
    1e-6; both ranks hold the same state, bit for bit."""
    cases, ranks, single = two_ranks
    want = single[index]
    for rank, out in enumerate(ranks):
        got = out["results"][index]
        np.testing.assert_allclose(float(got["train"]["loss"]), float(want["train"]["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(got["train"]["stage_losses"].numpy(),
                                   want["train"]["stage_losses"].numpy(), rtol=1e-5, atol=1e-8)
        names = sorted(want["grads"])
        g = torch.cat([got["grads"][n].reshape(-1) for n in names])
        w = torch.cat([want["grads"][n].reshape(-1) for n in names])
        bound = 1e-3 if "batch" in CASES[index] else 1e-5
        assert float((g - w).norm() / w.norm()) <= bound, (rank, float((g - w).norm() / w.norm()))
        for name, t in want["state"].items():
            if name.endswith("num_batches_tracked"):
                continue
            gap = np.abs(got["state"][name].numpy() - t.numpy())
            if name in want["grads"]:
                gap -= np.abs(_adam_step(got["grads"][name].numpy())
                              - _adam_step(want["grads"][name].numpy()))
            assert gap.max() <= 1e-6, (rank, name, gap.max())
    for name, t in ranks[0]["results"][index]["state"].items():
        assert torch.equal(t, ranks[1]["results"][index]["state"][name]), name


@pytest.mark.parametrize("index", [0, 2], ids=["pixelwise", "fullreg"])
def test_two_ranks_all_reduce_the_eval_sums(two_ranks, index):
    """The eval step's err_sum_mm, count and losses on two ranks are the
    global batch's: rtol 1e-5, count exact."""
    _, ranks, single = two_ranks
    want = single[index]["eval"]
    for out in ranks:
        got = out["results"][index]["eval"]
        for key in ("err_sum_mm", "loss", "stage_losses"):
            np.testing.assert_allclose(got[key].numpy(), want[key].numpy(), rtol=1e-5,
                                       atol=1e-8, err_msg=key)
        assert float(got["count"]) == float(want["count"]) == float(
            _case(*CASES[index])["batch"].get("weight", torch.ones(B)).sum())


def test_process_local_lines_matches_the_jax_function(two_ranks, monkeypatch):
    """The port's copy gives each rank the lines the JAX function gives that
    process (with and without a shared shuffle order)."""
    _, ranks, _ = two_ranks
    lines = list(range(11))
    order = list(np.random.RandomState(0).permutation(11))
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    for r, out in enumerate(ranks):
        monkeypatch.setattr(jax, "process_index", lambda r=r: r)
        assert out["lines"] == jmesh.process_local_lines(lines)
        monkeypatch.setattr(mesh, "world_size", lambda: 2)
        monkeypatch.setattr(mesh, "rank", lambda r=r: r)
        assert mesh.process_local_lines(lines, order) == jmesh.process_local_lines(lines, order)
    assert sorted(ranks[0]["lines"] + ranks[1]["lines"]) == lines
    assert ranks[0]["backend"] == "gloo"


def _frames(n):
    from test_torch_port_http import _blob_frame

    coms = np.stack([[160.0 + 5 * i, 120.0 - 3 * i, 400.0 + 4 * i] for i in range(n)])
    return np.stack([_blob_frame(*c) for c in coms]), coms


def test_data_parallel_predictor_equals_the_single_predictor(tmp_path):
    """``Predictor(data_parallel=True)`` over two CPU replicas (``devices``):
    each replica runs its half of the padded batch; the gathered uvd equals
    the single Predictor's (atol 1e-5: the halves run as batches of their
    own), for requests of 4 and 3 frames. It needs a batch that divides,
    refuses a static int8 mode and export, and without ``devices`` needs a
    card."""
    torch.manual_seed(0)
    state = PixelwiseRegression(21, stage=1, features=16, level=1).state_dict()
    arch = dict(stages=1, features=16, level=1, label_size=32)
    single = Predictor.from_state_dict(state, "MSRA", "cpu", batch_size=4, **arch)
    dp = Predictor.from_state_dict(state, "MSRA", "cpu", batch_size=4, data_parallel=True,
                                   devices=["cpu", "cpu"], **arch)
    assert len(dp.replicas) == 2 and dp.replicas[0][1].model is not dp.replicas[1][1].model
    frames, coms = _frames(4)
    for n in (4, 3):
        want = single.predict(frames[:n], coms[:n])
        got = dp.predict(frames[:n], coms[:n])
        assert got["uvd"].shape == (n, 21, 3)
        np.testing.assert_allclose(got["uvd"], want["uvd"], rtol=0, atol=1e-5)
        np.testing.assert_allclose(got["xyz"], want["xyz"], rtol=0, atol=1e-4)
    with pytest.raises(ValueError, match="divide"):
        Predictor.from_state_dict(state, "MSRA", "cpu", batch_size=3, data_parallel=True,
                                  devices=["cpu", "cpu"], **arch)
    with pytest.raises(ValueError, match="static"):
        Predictor.from_state_dict(state, "MSRA", "cpu", batch_size=4, data_parallel=True,
                                  devices=["cpu", "cpu"], quant="int8_static", **arch)
    with pytest.raises(ValueError, match="data_parallel"):
        export_artifact(dp, str(tmp_path / "dp.pwrsrv"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Predictor.from_state_dict(state, "MSRA", "cpu", batch_size=4, data_parallel=True,
                                      **arch)


def test_train_cli_under_torchrun_on_two_processes(tmp_path):
    """``torchrun --nproc_per_node 2 -m ...cli.train_msra --device cpu`` on
    the MSRA fixture (32 train lines: 16 a rank, batch 8 = 4 a rank; 4 val
    lines): one epoch line and one set of checkpoints, written by rank 0,
    with the global step count (32 // 8 = 4), finite; a batch that does not
    divide over the ranks stops the run."""
    root = str(tmp_path / "msra")
    subprocess.run([sys.executable, FIXTURE, root], check=True, capture_output=True,
                   env=torch_port_threads.env())
    env = torch_port_threads.env(PYTHONPATH=REPO, PWR_TB_IMAGES="0")
    subprocess.run([sys.executable, "-m", "pixelwiseregression_tpu_torch.cli.check_dataset",
                    "--dataset", "MSRA", "--data_path", root, "--device", "cpu"], check=True,
                   capture_output=True, env=env, cwd=tmp_path, timeout=300)

    def torchrun(*flags):
        return subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2",
             "--master_addr", "127.0.0.1", "--master_port", str(worker.free_port()), "-m",
             "pixelwiseregression_tpu_torch.cli.train_msra", "--subject", "0", "--epoch", "1",
             "--seed", "3", "--features", "16", "--level", "2", "--stages", "1",
             "--label_size", "32", "--num_workers", "1", "--data_path", root, "--device",
             "cpu", *flags], capture_output=True, text=True, env=env, cwd=tmp_path,
            timeout=600)

    r = torchrun("--batch_size", "8")
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.count("epoch 0: train_loss") == 1, r.stdout
    assert "2 processes of batch 4" in r.stdout
    ckpt = torch.load(tmp_path / "Model" / "MSRA_default_subject0_final.pt", weights_only=True)
    assert ckpt["step"] == 4
    assert all(torch.isfinite(v).all() for v in ckpt["state_dict"].values())
    anchors = [v for k, v in ckpt["state_dict"].items() if k.endswith("anchor_n")]
    assert anchors and all(float(a) == 4.0 for a in anchors)
    r = torchrun("--batch_size", "7")
    assert r.returncode != 0 and "must divide over 2 processes" in r.stderr
