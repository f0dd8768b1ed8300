"""PyTorch port vs the JAX package: checkpoints, remat and the train/test CLIs.

On the CPU (``--device cpu``) at a small size (stages 1-2, features 16,
level 1-2, label_size 32) on the synthetic MSRA fixture
(``tests/fixtures/make_msra_fixture.py``: 9 subjects x 4 frames of a smooth
blob). Each comparison states its tolerance and why.
"""

import argparse
import contextlib
import io
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from pixelwiseregression_tpu.cli import common as jcommon
from pixelwiseregression_tpu.cli.test_main import run_inference as jax_inference
from pixelwiseregression_tpu.cli.train_main import run_training as jax_training
from pixelwiseregression_tpu.data import preprocess as jpre
from pixelwiseregression_tpu.models import PixelwiseRegression as JaxModel
from pixelwiseregression_tpu.train import checkpoint as jck
from pixelwiseregression_tpu.train import loop as jloop

from pixelwiseregression_tpu_torch.cli import common as tcommon
from pixelwiseregression_tpu_torch.cli.test_main import run_inference as port_inference
from pixelwiseregression_tpu_torch.cli.train_main import run_training as port_training
from pixelwiseregression_tpu_torch.compat.flax_bridge import state_dict_from_flax
from pixelwiseregression_tpu_torch.data import preprocess as tpre
from pixelwiseregression_tpu_torch.models import layers as tl
from pixelwiseregression_tpu_torch.models.fullregression import FullRegression
from pixelwiseregression_tpu_torch.parallel import mesh
from pixelwiseregression_tpu_torch.models.pixelwise import PixelwiseRegression as PortModel
from pixelwiseregression_tpu_torch.serve import Predictor
from pixelwiseregression_tpu_torch.train import checkpoint as tck
from pixelwiseregression_tpu_torch.train import loop as tloop

from test_torch_port_ops import _CAM, _train_batch
import torch_port_threads
from torch_port_threads import one_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "make_msra_fixture.py")
SMALL = dict(stages=1, features=16, level=2, label_size=32)


def _zero_gradient_params(model):
    """Params whose gradient is zero by design: a conv bias that feeds an
    instance norm, and the plane head's last bias (a softmax input). Their
    computed gradients are rounding noise, which Adam scales up to steps of
    about lr in either framework."""
    zero = set()
    for name, seq in model.named_modules():
        if isinstance(seq, torch.nn.Sequential):
            for i in range(len(seq) - 1):
                if isinstance(seq[i], tl.Conv) and isinstance(seq[i + 1], tl.InstanceNorm):
                    zero.add(f"{name}.{i}.bias")
    return zero | {f"stages.{s}.plane_regression.conv.9.bias" for s in range(len(model.stages))}


# --------------------------------------------------------------------------- #
# checkpoints
# --------------------------------------------------------------------------- #


def _small_port_state(seed, opt="adam", norm="instance_anchored"):
    torch.manual_seed(seed)
    model = PortModel(14, stage=1, features=16, level=1, norm_method=norm, decoder="cuda")
    return tloop.create_train_state(model, opt=opt, lr=1e-2, lr_decay=0.5, decay_epoch=1,
                                    steps_per_epoch=2)


def _toy_step(state, seed):
    """One train-mode step on random inputs (moves the anchors, the moments
    and the schedule)."""
    g = torch.Generator().manual_seed(seed)
    img, label = torch.rand(2, 1, 32, 32, generator=g), torch.rand(2, 1, 16, 16, generator=g)
    mask = (label > 0.3).float()
    out = state.model.train()(img, label, mask)
    loss = sum((uvd ** 2).sum() + 0.01 * (hm ** 2).sum() for hm, _, uvd in out)
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    state.optimizer.step()
    state.scheduler.step()
    state.step += 1


@pytest.mark.parametrize("opt", ["adam", "sgd"])
def test_checkpoint_round_trip_keeps_optimizer_schedule_and_step(tmp_path, opt):
    """save -> load into a fresh state: the same state dict (anchors
    included), optimizer state, lr, schedule position and step; one more step
    from each gives bit-identical params. The file also serves the
    ``Predictor`` and ``peek_model_param``; ``alias_final`` copies it."""
    state = _small_port_state(0, opt)
    for i in range(3):
        _toy_step(state, i)
    param = {"stage": 1, "features": 16, "level": 1, "label_size": 16,
             "norm_method": "instance_anchored", "kernel_size": 3}
    path = str(tmp_path / "M_2.pt")
    tck.save_checkpoint(path, state.model, seed=7, model_param=param,
                        optimizer=state.optimizer, scheduler=state.scheduler, step=state.step)
    again = _small_port_state(1, opt)
    ckpt = tck.load_checkpoint(path)
    assert ckpt["seed"] == 7 and ckpt["step"] == 3 and ckpt["opt_state"] is None
    tck.restore_train_state(again, ckpt)
    for (k, a), (k2, b) in zip(state.model.state_dict().items(),
                               again.model.state_dict().items()):
        assert k == k2 and torch.equal(a, b), k
    assert float(again.model.conv[1].anchor_n) == 3.0
    assert again.step == 3 and again.scheduler.last_epoch == state.scheduler.last_epoch == 3
    assert again.scheduler.get_last_lr() == state.scheduler.get_last_lr() == [1e-2 * 0.5]
    assert again.optimizer.param_groups[0]["lr"] == 1e-2 * 0.5
    want_opt, got_opt = state.optimizer.state_dict(), again.optimizer.state_dict()
    assert got_opt["param_groups"] == want_opt["param_groups"]
    assert got_opt["state"].keys() == want_opt["state"].keys()
    for i, s in want_opt["state"].items():
        for key, v in s.items():
            assert torch.equal(got_opt["state"][i][key], v), (i, key)
    _toy_step(state, 9)
    _toy_step(again, 9)
    for a, b in zip(state.model.parameters(), again.model.parameters()):
        assert torch.equal(a, b)
    assert tck.peek_model_param(path) == param
    tck.alias_final(str(tmp_path), "M_{}.pt", 2)
    assert open(tmp_path / "M_final.pt", "rb").read() == open(path, "rb").read()
    pred = Predictor.from_checkpoint(path, "NYU", "cpu", dtype=torch.float32)
    assert pred.model.stages[0].hourglass.inner.input_conv.conv[0].anchor_n == 3.0


@pytest.fixture(scope="module")
def jax_variables():
    """A small anchored JAX model's variables, its anchors calibrated by
    three train-mode applies."""
    jm = JaxModel(joints=14, stage=2, label_size=16, features=16, level=1,
                  norm_method="instance_anchored", decoder="xla")
    inputs = (jnp.ones((2, 32, 32, 1)), jnp.ones((2, 16, 16, 1)), jnp.ones((2, 16, 16, 1)))
    v = jax.device_get(jax.jit(lambda k: jm.init(k, *inputs, train=False))(jax.random.PRNGKey(3)))
    img = jnp.asarray(np.random.RandomState(4).rand(2, 32, 32, 1), jnp.float32)
    calibrate = jax.jit(lambda v: jm.apply(v, img, inputs[1], inputs[2], train=True,
                                           mutable=["batch_stats"])[1])
    for _ in range(3):
        v = {**v, **jax.device_get(calibrate(v))}
    return v


def _jax_ckpt(path, opt, variables, steps=3):
    """The JAX package's save_checkpoint of ``variables`` after ``steps``
    optimizer updates on random gradients (so the moments are not zero)."""
    rng = np.random.RandomState(4)
    tx = jloop.make_optimizer(opt=opt, lr=1e-2, lr_decay=0.5, decay_epoch=1, steps_per_epoch=2)
    params, opt_state = variables["params"], tx.init(variables["params"])
    grads = [jax.tree_util.tree_map(lambda p: rng.randn(*np.shape(p)).astype(np.float32), params)
             for _ in range(steps + 1)]
    update = jax.jit(tx.update)
    for g in grads[:steps]:
        updates, opt_state = update(g, opt_state, params)
        params = jax.device_get(jax.tree_util.tree_map(lambda p, u: p + u, params, updates))
    param = {"joints": 14, "stage": 2, "label_size": 16, "features": 16, "level": 1,
             "norm_method": "instance_anchored", "kernel_size": 3, "heatmap_method": "softmax",
             "decoder": "xla", "dtype": "float32", "remat": False, "quant": None}
    jck.save_checkpoint(path, params, variables["batch_stats"], seed=5, model_param=param,
                        opt_state=jax.device_get(opt_state), step=steps)
    return {"params": params, "batch_stats": variables["batch_stats"], "opt_state": opt_state,
            "tx": tx, "next_grads": grads[steps]}


@pytest.mark.parametrize("opt", ["adam", "sgd"])
def test_jax_ckpt_loads_with_its_optimizer_state(tmp_path, opt, jax_variables):
    """A ``.ckpt`` written by the JAX package's save_checkpoint: the flax-free
    reader gives ``flax_bridge``'s state dict exactly; restored into a port
    train state, Adam's mu/nu (SGD's trace) sit in exp_avg/exp_avg_sq
    (momentum_buffer) by name, exactly, Adam's step is optax's count and the
    lr the schedule's at that step. One more update from each side on the
    same gradients then agrees to rtol 1e-5 atol 1e-7 (the optimizer test's
    tolerance)."""
    path = str(tmp_path / "j.ckpt")
    j = _jax_ckpt(path, opt, jax_variables)
    ckpt = tck.load_checkpoint(path)
    want = state_dict_from_flax({"params": j["params"], "batch_stats": j["batch_stats"]})
    assert ckpt["state_dict"].keys() == want.keys()
    for k in want:
        assert torch.equal(ckpt["state_dict"][k], want[k]), k
    assert ckpt["seed"] == 5 and ckpt["step"] == 3 and ckpt["optimizer"] is None
    assert tck.peek_model_param(path)["features"] == 16

    torch.manual_seed(0)
    model = PortModel(14, stage=2, features=16, level=1, norm_method="instance_anchored")
    state = tloop.create_train_state(model, opt=opt, lr=1e-2, lr_decay=0.5, decay_epoch=1,
                                     steps_per_epoch=2)
    tck.restore_train_state(state, ckpt)
    assert state.step == 3 and state.optimizer.param_groups[0]["lr"] == pytest.approx(5e-3)
    names = [n for n, _ in model.named_parameters()]
    if opt == "adam":
        mu = state_dict_from_flax({"params": j["opt_state"][0].mu})
        nu = state_dict_from_flax({"params": j["opt_state"][0].nu})
        for n in names:
            s = state.optimizer.state[model.get_parameter(n)]
            assert torch.equal(s["exp_avg"], mu[n]) and torch.equal(s["exp_avg_sq"], nu[n]), n
            assert float(s["step"]) == 3.0
    else:
        trace = state_dict_from_flax({"params": j["opt_state"][0].trace})
        for n in names:
            s = state.optimizer.state[model.get_parameter(n)]
            assert torch.equal(s["momentum_buffer"], trace[n]), n

    updates, _ = j["tx"].update(j["next_grads"], j["opt_state"], j["params"])
    after = state_dict_from_flax({"params": jax.tree_util.tree_map(
        lambda p, u: np.asarray(p + u), j["params"], updates)})
    grads = state_dict_from_flax({"params": j["next_grads"]})
    for n, p in model.named_parameters():
        p.grad = grads[n]
    state.optimizer.step()
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), after[n].numpy(), rtol=1e-5, atol=1e-7,
                                   err_msg=n)


def test_msgpack_reader_matches_flax():
    """The flax-free msgpack reader vs flax.serialization.msgpack_restore on
    what save_checkpoint writes: nested dicts (an empty one too) of f32 and
    i32 arrays, 0-d ones included."""
    rng = np.random.RandomState(6)
    tree = {"a": {"k": rng.randn(3, 4, 5).astype(np.float32), "n": np.asarray(7, np.int32)},
            "b": rng.randint(0, 9, (40,)).astype(np.int32), "s": np.asarray(2.5, np.float32),
            "e": {}}
    blob = serialization.msgpack_serialize(tree)
    want, got = serialization.msgpack_restore(blob), tck.msgpack_restore(blob)
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (path, g), (_, w) in zip(flat_g, flat_w):
        assert g.dtype == w.dtype and g.shape == w.shape, path
        np.testing.assert_array_equal(g, w, err_msg=str(path))
    assert got["e"] == {}


def test_jax_ckpt_serves_through_predictor_without_jax(tmp_path, jax_variables):
    """``Predictor.from_checkpoint`` on a JAX ``.ckpt`` gives what the
    predictor built from ``flax_bridge``'s state dict gives (exactly), and in
    a process where jax and flax cannot be imported it loads and predicts
    the same uvd (on one thread in both, so that the sums run in one order)."""
    path = str(tmp_path / "NYU_x.ckpt")
    j = _jax_ckpt(path, "adam", jax_variables)
    rng = np.random.RandomState(8)
    frames = np.zeros((3, 480, 640), np.float32)
    frames[:, 200:280, 280:360] = 600 + 30 * rng.rand(3, 80, 80)
    coms = np.array([[320.0, 240.0, 610.0]] * 3)
    kw = dict(batch_size=4, dtype=torch.float32, decoder="cuda")
    got = Predictor.from_checkpoint(path, "NYU", "cpu", **kw).predict(frames, coms)["uvd"]
    ref = Predictor.from_state_dict(
        state_dict_from_flax({"params": j["params"], "batch_stats": j["batch_stats"]}),
        "NYU", "cpu", stages=2, features=16, level=1, label_size=16,
        norm_method="instance_anchored", **kw)
    np.testing.assert_array_equal(got, ref.predict(frames, coms)["uvd"])
    np.save(tmp_path / "in.npy", frames)
    script = (
        "import sys, numpy as np, torch\n"
        "torch.set_num_threads(1)\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['flax'] = None\n"
        "from pixelwiseregression_tpu_torch.serve import Predictor\n"
        f"p = Predictor.from_checkpoint({path!r}, 'NYU', 'cpu', batch_size=4, "
        "dtype=torch.float32, decoder='cuda')\n"
        f"uvd = p.predict(np.load({str(tmp_path / 'in.npy')!r}), "
        "np.array([[320.0, 240.0, 610.0]] * 3))['uvd']\n"
        f"np.save({str(tmp_path / 'out.npy')!r}, uvd)\n"
        "assert not [m for m in sys.modules if m.split('.')[0] == 'pixelwiseregression_tpu']\n")
    r = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                       timeout=300, cwd=REPO, env=torch_port_threads.env())
    assert r.returncode == 0, r.stderr[-3000:]
    np.testing.assert_array_equal(np.load(tmp_path / "out.npy"), got)


# --------------------------------------------------------------------------- #
# remat
# --------------------------------------------------------------------------- #

_J, _LABEL = 14, 32
_CFG = dict(_CAM, image_size=2 * _LABEL, label_size=_LABEL)


def _remat_pair(norm, seed=0):
    torch.manual_seed(seed)
    plain = PortModel(_J, stage=2, features=16, level=2, norm_method=norm, decoder="cuda")
    remat = PortModel(_J, stage=2, features=16, level=2, norm_method=norm, decoder="cuda",
                      remat=True)
    remat.load_state_dict(plain.state_dict())
    return plain, remat


def _port_step(model, raw):
    state = tloop.create_train_state(model, lr=1e-3, steps_per_epoch=100)
    step = tloop.make_train_step(tpre.PreprocessConfig(**_CFG), tloop.LossConfig(alpha=0.5),
                                 augment=False)
    metrics = step(state, {k: torch.from_numpy(v) for k, v in raw.items()})
    return metrics, {n: p.grad.clone() for n, p in model.named_parameters()}


@pytest.mark.parametrize("norm", ["instance_anchored", "batch"])
def test_remat_moves_buffers_once_and_matches_the_plain_step(norm):
    """One train step with remat=True vs remat=False from the same weights
    and batch: the same loss, gradients, params and buffers, bit for bit.
    The anchored norms' anchor_n (BatchNorm's num_batches_tracked) is 1
    after the step: the recompute in the backward neither moves the buffers
    a second time nor runs on the moved ones."""
    raw = {k: v[:4] for k, v in _train_batch().items()}
    plain, remat = _remat_pair(norm)
    m0, g0 = _port_step(plain, raw)
    m1, g1 = _port_step(remat, raw)
    assert torch.equal(m0["loss"], m1["loss"])
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n
    for (k, a), (_, b) in zip(plain.state_dict().items(), remat.state_dict().items()):
        assert torch.equal(a, b), k
    counters = [v for k, v in remat.state_dict().items()
                if k.endswith(("anchor_n", "num_batches_tracked"))]
    assert counters and all(float(c) == 1.0 for c in counters)


def test_remat_step_matches_the_jax_remat_step():
    """The port's remat step vs the JAX package's remat step (nn.remat of
    each PredictionBlock), f32, from the same weights (anchors calibrated on
    the batch) and batch, no augmentation: loss and per-stage losses rtol
    1e-5, the anchors after the step rtol 1e-5 atol 1e-6 (anchor_n exact,
    moved once), and the output-side gradients (the last stage's softmax
    temperature and final convs, downstream of every ReLU) within 1e-3
    relative, the bound tests/test_torch_port_train.py holds the plain step
    to (measured here: 2e-4 on the temperature); upstream of a ReLU
    whole-step gradients cannot agree that closely (that file says why)."""
    raw = {k: v[:4] for k, v in _train_batch().items()}
    jraw = {k: jnp.asarray(v) for k, v in raw.items()}
    jm = JaxModel(joints=_J, stage=2, label_size=_LABEL, features=16, level=1,
                  norm_method="instance_anchored", decoder="xla", remat=True)
    jcfg = jpre.PreprocessConfig(**_CFG)
    data = jax.jit(lambda r: jpre.preprocess_batch(r, jax.random.PRNGKey(0), jcfg,
                                                   augment=False))(jraw)
    x = [data[k] for k in ("img", "label_img", "mask")]
    v = jax.jit(lambda k: jm.init(k, *x, train=False))(jax.random.PRNGKey(2))
    calibrate = jax.jit(lambda v: jm.apply(v, *x, train=False, mutable=["batch_stats"])[1])
    for _ in range(3):
        v = {**v, **calibrate(v)}
    before = jax.device_get(v)

    @jax.jit
    def step(v):
        """The JAX train step's loss, its gradients and the moved anchors."""

        def loss_fn(p):
            results, upd = jm.apply({"params": p, "batch_stats": v["batch_stats"]}, *x,
                                    train=True, mutable=["batch_stats"])
            every = jloop.stage_losses(results, data, 1.0, 0.01,
                                       data["valid"].astype(jnp.float32))
            return jloop.total_loss(every, 0.5), (jnp.asarray(every), upd["batch_stats"])

        (loss, (every, stats)), grads = jax.value_and_grad(loss_fn, has_aux=True)(v["params"])
        return loss, every, stats, grads

    loss, every, stats, grads = jax.device_get(step(v))
    after = state_dict_from_flax({"batch_stats": stats})
    jgrads = state_dict_from_flax({"params": grads})

    torch.manual_seed(0)
    pm = PortModel(_J, stage=2, features=16, level=1, norm_method="instance_anchored",
                   decoder="cuda", remat=True)
    pm.load_state_dict(state_dict_from_flax(before))
    metrics, tgrads = _port_step(pm, raw)
    np.testing.assert_allclose(float(metrics["loss"]), float(loss), rtol=1e-5)
    np.testing.assert_allclose(metrics["stage_losses"].numpy(), np.asarray(every), rtol=1e-5,
                               atol=1e-9)
    got = pm.state_dict()
    anchors = [k for k in after if k.endswith("anchor")]
    assert anchors
    for k in anchors:
        np.testing.assert_allclose(got[k].numpy(), after[k].numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
        assert got[k + "_n"].item() == after[k + "_n"].item() == 4.0
    for k in ("stages.1.plane_regression.w", "stages.1.plane_regression.conv.9.weight",
              "stages.1.depth_regression.conv.9.weight", "stages.1.depth_regression.conv.9.bias"):
        gap = np.linalg.norm(tgrads[k].numpy() - jgrads[k].numpy())
        assert gap <= 1e-3 * np.linalg.norm(jgrads[k].numpy()), (k, gap)


# --------------------------------------------------------------------------- #
# the CLIs: flags
# --------------------------------------------------------------------------- #

# flags the port does not carry (TPU-only) and the ones it adds
_TPU_ONLY = {"compiler_opts", "matmul_precision", "no_compile_cache"}
_PORT_ONLY = {"device"}


@pytest.mark.parametrize("kind,msra", [("train", False), ("train", True), ("test", False),
                                       ("test", True)])
def test_parsers_keep_the_jax_flags_and_defaults(kind, msra):
    """Drift guard: every JAX flag but the TPU-only ones exists in the port
    with the same default, except --decoder (cuda for pallas: the same
    kernel decoder)."""
    if kind == "train":
        jp, tp = jcommon.make_train_parser(msra=msra), tcommon.make_train_parser(msra=msra)
    else:
        jp, tp = jcommon.make_test_parser(msra=msra), tcommon.make_test_parser(msra=msra)
    jd, td = vars(jp.parse_args([])), vars(tp.parse_args([]))
    assert set(jd) - _TPU_ONLY == set(td) - _PORT_ONLY
    for k in set(jd) - _TPU_ONLY - {"decoder"}:
        assert td[k] == jd[k], k
    assert tcommon.DECODERS[jd["decoder"]] == td["decoder"] == "cuda"
    assert td["device"] == "cuda"


def test_model_kwargs_decoder_names_and_unported_options(monkeypatch):
    """pallas/xla name the cuda/torch decoders; --mixed_precision is bf16;
    --quant reaches the model, which refuses to train; the FullRegression
    kwargs build the FullRegression model (no decoder flags); a process
    counts as launched by torchrun only with both WORLD_SIZE and RANK set;
    --device cuda without a card raises, naming what is missing."""
    args = tcommon.make_train_parser(msra=True).parse_args(
        ["--decoder", "xla", "--mixed_precision", "--remat", "--filter_size", "5"])
    kw = tcommon.model_kwargs_from_args(args, 21)
    assert kw["decoder"] == "torch" and kw["dtype"] == torch.bfloat16 and kw["remat"]
    assert kw["kernel_size"] == 5 and kw["joints"] == 21
    model = PortModel(**kw)
    assert model.remat and model.stages[0].decoder == "torch"
    param = tcommon.make_model_param(kw, 64)
    assert param["dtype"] == "bfloat16" and param["label_size"] == 64 and param["quant"] is None
    for name in ("pallas", "cuda"):
        args.decoder = name
        assert tcommon.model_kwargs_from_args(args, 21)["decoder"] == "cuda"

    targs = tcommon.make_test_parser(msra=True).parse_args(["--quant", "int8_static"])
    qkw = tcommon.model_kwargs_from_args(targs, 21)
    assert qkw["quant"] == "int8_static" and kw["quant"] is None
    with pytest.raises(ValueError, match="inference-only"):
        PortModel(**qkw).train()(*(torch.zeros(1, 1, s, s) for s in (128, 64, 64)))
    fargs = tcommon.make_train_parser(msra=True, fullregression=True).parse_args(
        ["--mixed_precision", "--stages", "1", "--features", "16"])
    fkw = tcommon.model_kwargs_from_args(fargs, 21, fullregression=True)
    assert set(fkw) == {"joints", "stage", "label_size", "features", "level", "norm_method",
                        "dtype", "remat"} and fkw["dtype"] == torch.bfloat16
    assert isinstance(FullRegression(**fkw).stages[0].regression[4], torch.nn.Linear)
    assert not hasattr(fargs, "heatmap_method") and not hasattr(fargs, "alpha")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.delenv("RANK", raising=False)
    assert not mesh.launched()
    monkeypatch.setenv("RANK", "0")
    assert mesh.launched()
    monkeypatch.delenv("WORLD_SIZE")
    monkeypatch.delenv("RANK")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcommon.resolve_device(args)
    args.device = "cpu"
    assert tcommon.resolve_device(args) == torch.device("cpu")


# --------------------------------------------------------------------------- #
# the CLIs: port vs JAX on the MSRA fixture
# --------------------------------------------------------------------------- #

RESUME_LR = 1e-5


def _test_args(root, **kw):
    return _cli_args(root, seed="final", **kw)


def _cli_args(root, **kw):
    """The train/test flags both CLIs take; every augmentation off, so that
    neither run takes a random draw."""
    a = argparse.Namespace(
        suffix="par", seed=1, batch_size=8, kernel_size=7, sigmoid=1.5,
        norm_method="instance_anchored", heatmap_method="softmax", filter_size=3,
        using_rotation=False, using_scale=False, using_shift=False, using_flip=False,
        no_strict_quirks=True, aug_fallback="clean", gpu_id="0", epoch=1, num_workers=2,
        opt="adam", lr=1e-3, beta1=0.9, beta2=0.999, weight_decay=0.0, mixed_precision=False,
        bf16=False, remat=False, lambda_h=1.0, lambda_d=0.01, alpha=1.0, lr_decay=0.2,
        decay_epoch=15, decoder="xla", data_path=root, matmul_precision=None, profile=None,
        resume=None, small=False, device="cpu", compiler_opts=None, quant="none",
        skip_bad_samples=False, **SMALL)
    for k, v in kw.items():
        setattr(a, k, v)
    return a


def _in_dir(path, fn, *args, **kw):
    """Run ``fn`` with ``path`` as the working directory; returns its result
    and what it printed."""
    os.makedirs(path, exist_ok=True)
    cwd, out = os.getcwd(), io.StringIO()
    os.chdir(path)
    try:
        with contextlib.redirect_stdout(out):
            result = fn(*args, **kw)
    finally:
        os.chdir(cwd)
    return result, out.getvalue()


def _epoch_line(text):
    """(train loss, val mean-mm per stage) of the printed epoch line."""
    m = re.search(r"train_loss ([0-9.e+-]+)\s+val mean-mm \[([^\]]+)\]", text)
    return float(m.group(1)), np.array(m.group(2).split(), float)


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """The JAX CLI trains one epoch on the MSRA fixture (subject 0 held out,
    lr 1e-3); the JAX CLI and the port's CLI then each --resume from that
    ``.ckpt`` for one epoch with the same seed, at lr 1e-5."""
    base = tmp_path_factory.mktemp("cli")
    root = str(base / "msra")
    subprocess.run([sys.executable, FIXTURE, root], check=True, capture_output=True,
                   env=torch_port_threads.env())
    images = os.environ.get("PWR_TB_IMAGES")
    os.environ["PWR_TB_IMAGES"] = "0"  # the JAX CLI's image logging takes most of its time
    try:
        _in_dir(str(base / "first"), jax_training, _cli_args(root), "MSRA", subject=0)
        ckpt = str(base / "first" / "Model" / "MSRA_par_subject0_0.ckpt")
        jax_run = _in_dir(str(base / "jax"), jax_training,
                          _cli_args(root, resume=ckpt, lr=RESUME_LR), "MSRA", subject=0)
    finally:
        if images is None:
            del os.environ["PWR_TB_IMAGES"]
        else:
            os.environ["PWR_TB_IMAGES"] = images
    # the port's run logs its TensorBoard images
    port_run = _in_dir(str(base / "port"), port_training,
                       _cli_args(root, resume=ckpt, lr=RESUME_LR, decoder="cuda"),
                       "MSRA", subject=0)
    return {"base": base, "root": root, "ckpt": ckpt, "jax": jax_run, "port": port_run}


def test_cli_resume_from_a_jax_ckpt_matches_the_jax_cli(cli_runs):
    """The port's train CLI resumed from the JAX CLI's checkpoint vs the JAX
    CLI resumed from it: the same batches (Loader order from the seed),
    params, anchors, Adam moments, schedule and step.

    Tolerances: train loss and val mean-mm rtol 1e-3; params rtol 1e-4 atol
    1e-6 (a tenth of one Adam step at lr 1e-5); the params whose gradient is
    zero by design within two epochs of Adam's largest step, 4 steps x
    lr(1-b1)/sqrt(1-b2), apart; anchors (batch means of activations up to
    ~0.3) rtol 1e-4 atol 1e-5; the step count exact.

    Why one stage and a resumed lr of 1e-5: the JAX CLI against itself,
    resumed from its checkpoint with every param scaled by 1 +- 1e-7,
    already leaves 7.7% of the params outside rtol 1e-4 atol 1e-6 after one
    Adam epoch at lr 1e-3 (the port: 7.5%), since Adam's steps on params
    whose gradient is near zero flip sign with rounding; at two stages it
    parts by 0.7% (Adam) / 2.7% (SGD) in val mean-mm as well. At lr 1e-5
    both stay inside these tolerances (tests/torch_port_cli_sensitivity.py
    measures all of it)."""
    (jbest, jerr), jtext = cli_runs["jax"]
    (tbest, terr), ttext = cli_runs["port"]
    assert "at step 4" in jtext and "resumed from" in ttext and "at step 4" in ttext
    assert "image logging failed" not in ttext
    jloss, jmm = _epoch_line(jtext)
    tloss, tmm = _epoch_line(ttext)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-3)
    np.testing.assert_allclose(tmm, jmm, rtol=1e-3)
    np.testing.assert_allclose(terr, jerr, rtol=1e-3)
    assert tbest == jbest == 0

    base = cli_runs["base"]
    want = tck.load_checkpoint(str(base / "jax" / "Model" / "MSRA_par_subject0_0.ckpt"))
    got = tck.load_checkpoint(str(base / "port" / "Model" / "MSRA_par_subject0_0.pt"))
    assert got["step"] == want["step"] == 8 and got["seed"] == want["seed"] == 1
    assert set(got["state_dict"]) == set(want["state_dict"])
    model = PortModel(21, stage=SMALL["stages"], features=SMALL["features"], level=SMALL["level"],
                      norm_method="instance_anchored")
    zero = _zero_gradient_params(model)
    adam_reach = 2 * 4 * RESUME_LR * (1 - 0.9) / np.sqrt(1 - 0.999)
    for name, w in want["state_dict"].items():
        g = got["state_dict"][name].numpy()
        w = w.numpy()
        if name in zero:
            assert np.abs(g - w).max() <= adam_reach, name
        elif name.endswith("anchor_n"):
            assert g.item() == w.item() == 8.0
        elif name.endswith("anchor"):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6, err_msg=name)
    adam = tck._find(want["opt_state"], "mu")
    assert int(adam["count"]) == 8
    state = got["optimizer"]["state"]
    assert all(float(s["step"]) == 8.0 for s in state.values())
    assert got["model_param"]["features"] == 16 and got["model_param"]["dtype"] == "float32"


def _result(path):
    return np.loadtxt(path)


def test_test_cli_on_a_jax_ckpt_matches_the_jax_cli(cli_runs):
    """Both test CLIs on the checkpoint the JAX CLI wrote (the port reads the
    .ckpt): Result files within atol 1e-2 (pixels for u and v, mm for d),
    finite, (4, 63), near the fixture's hand (u~160 v~120 d~400). Then the
    port's on its own resumed .pt against the JAX CLI's on its resumed
    .ckpt (two checkpoints as close as the resume test holds them):
    likewise within atol 1e-2."""
    base, root = cli_runs["base"], cli_runs["root"]
    for name in ("first", "jax", "port"):
        os.makedirs(base / f"test_{name}" / "Model", exist_ok=True)
    first = base / "first" / "Model" / "MSRA_par_subject0_final.ckpt"
    for side in ("jax", "port"):
        os.symlink(first, base / f"test_{side}" / "Model" / "MSRA_par_subject0_final.ckpt")
    (jname, _), _ = _in_dir(str(base / "test_jax"), jax_inference, _test_args(root), "MSRA",
                            subject=0)
    (tname, fps), text = _in_dir(str(base / "test_port"), port_inference,
                                 _test_args(root, decoder="cuda"), "MSRA", subject=0)
    want, got = _result(base / "test_jax" / jname), _result(base / "test_port" / tname)
    assert got.shape == want.shape == (4, 63) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-2)
    uvd = got.reshape(4, 21, 3)
    assert 100 < np.median(uvd[:, :, 0]) < 220 and 60 < np.median(uvd[:, :, 1]) < 180
    assert 300 < np.median(uvd[:, :, 2]) < 500
    assert fps > 0 and "FPS" in text

    (jname, _), _ = _in_dir(str(base / "jax"), jax_inference, _test_args(root), "MSRA",
                            subject=0)
    (tname, _), _ = _in_dir(str(base / "port"), port_inference, _test_args(root, decoder="torch"),
                            "MSRA", subject=0)
    np.testing.assert_allclose(_result(base / "port" / tname), _result(base / "jax" / jname),
                               rtol=0, atol=1e-2)


def test_module_entry_points_round_trip(tmp_path):
    """``python -m`` on the port's entry modules, as a user runs them on the
    CPU: check_dataset, train_msra (2 epochs, bf16, with a profiler trace of
    steps 3-6) and test_msra. (Resuming from a .pt runs the code that
    resumes from a .ckpt above, and test_checkpoint_round_trip_* holds it.)"""
    root = str(tmp_path / "msra")
    subprocess.run([sys.executable, FIXTURE, root], check=True, capture_output=True,
                   env=torch_port_threads.env())
    env = torch_port_threads.env(PYTHONPATH=REPO, PWR_TB_IMAGES="0")
    small = ["--features", "16", "--level", "2", "--stages", "1", "--label_size", "32",
             "--batch_size", "8", "--num_workers", "2", "--data_path", root, "--device", "cpu"]

    def run(module, *argv):
        r = subprocess.run([sys.executable, "-m", f"pixelwiseregression_tpu_torch.cli.{module}",
                            *argv], capture_output=True, text=True, timeout=600, cwd=tmp_path,
                           env=env)
        assert r.returncode == 0, r.stderr[-3000:]
        return r.stdout

    assert "Data ready!" in run("check_dataset", "--dataset", "MSRA", "--data_path", root,
                                "--device", "cpu")
    assert len(open(os.path.join(root, "train_0.txt")).read().split("\n")) == 33
    out = run("train_msra", "--subject", "0", "--epoch", "2", "--seed", "3",
              "--mixed_precision", "--profile", str(tmp_path / "trace"), *small)
    assert len(re.findall(r"^epoch \d: train_loss", out, re.M)) == 2
    assert os.path.exists(tmp_path / "trace" / "trace.json")
    for f in ("MSRA_default_subject0_0.pt", "MSRA_default_subject0_1.pt",
              "MSRA_default_subject0_final.pt"):
        assert os.path.exists(tmp_path / "Model" / f), f
    ckpt = torch.load(tmp_path / "Model" / "MSRA_default_subject0_1.pt", weights_only=True)
    assert ckpt["step"] == 8 and ckpt["model_param"]["dtype"] == "bfloat16"
    anchors = [v for k, v in ckpt["state_dict"].items() if k.endswith("anchor_n")]
    assert anchors and all(float(a) == 8.0 for a in anchors)
    assert "FPS" in run("test_msra", "--subject", "0", *small)
    out = np.loadtxt(tmp_path / "Result" / "MSRA_default_subject0.txt")
    assert out.shape == (4, 63) and np.isfinite(out).all()
