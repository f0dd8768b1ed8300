"""The int8 inference path of the PyTorch port vs the JAX package's
(``models/layers.py``'s ``_Int8Conv2D``, ``parse_quant`` and the static
``quant_scales`` collection), and its plumbing: the model, the test CLI and
the bench.

Tolerances, and why:

* the int8 conv alone, on the same weights and inputs: the codes, the int32
  accumulators and the f32 outputs equal the JAX conv's exactly (both take
  half-to-even rounds and the same f32 operations in the same order);
* the whole quantized model, each int8 conv fed the input JAX's conv saw:
  every int8 conv's output equals JAX's to 2 f32 ulps (under ``jax.jit``
  XLA contracts the epilogue's multiply-add into one rounding; run eagerly,
  as above, it is bit-exact), and per-stage uvd holds to the f32 model
  test's rtol 1e-3 atol 2e-5;
* the whole model running free: the f32 activations upstream of the first
  int8 conv differ from JAX's by ~1e-5 (the f32 norm statistics are summed
  in another order; JAX sums them compensated), which flips a few of that
  conv's codes by one, and each flip reaches the following convs' scales
  (dynamic: per sample; static: per channel) and every later code. So the
  free-running uvd cannot hold to 1e-3: it is bounded per stage by twice
  JAX's own int8-vs-f32 gap, as the bf16 paths are bounded by JAX's
  bf16-vs-f32 gap (tests/test_torch_port_model.py).
"""

import os
import subprocess
import sys

import flax.linen as fnn
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pixelwiseregression_tpu.models import PixelwiseRegression as JaxModel
from pixelwiseregression_tpu.models.layers import _Int8Conv2D

from pixelwiseregression_tpu_torch import bench
from pixelwiseregression_tpu_torch.cli import common as tcommon
from pixelwiseregression_tpu_torch.cli.test_main import run_inference
from pixelwiseregression_tpu_torch.compat.flax_bridge import (
    quant_scales_from_flax,
    state_dict_from_flax,
)
from pixelwiseregression_tpu_torch.models import layers as tl
from pixelwiseregression_tpu_torch.models.pixelwise import PixelwiseRegression as PortModel
from pixelwiseregression_tpu_torch.models.pixelwise import parse_quant

import torch_port_threads
from torch_port_threads import one_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = dict(joints=5, stage=2, features=16, level=1, norm_method="instance")
LABEL = 16


def _nchw(a):
    return torch.from_numpy(np.array(np.transpose(np.asarray(a), (0, 3, 1, 2))))


def _nhwc(t):
    return np.transpose(t.detach().float().numpy(), (0, 2, 3, 1))


def _conv_inputs(rng, k, cin, cout, b=2, side=9):
    kernel = (rng.randn(k, k, cin, cout) * 0.2).astype(np.float32)
    bias = rng.randn(cout).astype(np.float32)
    x = rng.randn(b, side, side, cin).astype(np.float32)
    return kernel, bias, x


def _jax_conv(kernel, bias, x, k, stride, static):
    """JAX ``_Int8Conv2D``'s output and, when static, its calibrated scales
    (one calibration apply on ``x``)."""
    mod = _Int8Conv2D(features=kernel.shape[-1], kernel_size=k, stride=stride,
                      static_scale=static)
    v = {"params": {"kernel": kernel, "bias": bias}}
    scales = None
    if static:
        _, upd = mod.apply(v, jnp.asarray(x), mutable=["quant_scales"])
        v = dict(v, **upd)
        scales = np.array(upd["quant_scales"]["act_absmax_c"])
    return np.asarray(mod.apply(v, jnp.asarray(x))), scales


def _port_weight(kernel):
    return torch.from_numpy(np.ascontiguousarray(kernel.transpose(3, 2, 0, 1)))


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
def test_int8_conv_exact_on_the_grid(static):
    """Weights and activations on the int8 grid (JAX ``test_quant.py``'s
    construction): the port's int8 conv equals JAX ``_Int8Conv2D`` bit for
    bit, and both equal the f32 conv to f32 rounding (rtol 1e-4, as there)."""
    rng = np.random.RandomState(0)
    cin, cout, k = 8, 16, 3
    s_w = rng.uniform(0.01, 0.1, cout).astype(np.float32)
    w_int = rng.randint(-127, 128, (k, k, cin, cout))
    w_int[0, 0, 0, :] = 127
    kernel = (w_int * s_w).astype(np.float32)
    x_int = rng.randint(-127, 128, (2, 10, 10, cin))
    x_int[:, 0, 0, :] = 127
    x = (x_int * 0.05).astype(np.float32)
    bias = rng.randn(cout).astype(np.float32)
    want, scales = _jax_conv(kernel, bias, x, k, 1, static)
    got = tl.int8_conv2d(_nchw(x), _port_weight(kernel), torch.from_numpy(bias), 1,
                         None if scales is None else torch.from_numpy(scales))
    np.testing.assert_array_equal(_nhwc(got), want)
    ref = jax.lax.conv_general_dilated(jnp.asarray(x), jnp.asarray(kernel), (1, 1),
                                       [(1, 1), (1, 1)],
                                       dimension_numbers=("NHWC", "HWIO", "NHWC")) + bias
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
@pytest.mark.parametrize("k,stride,cin,cout", [(3, 1, 12, 20), (1, 1, 16, 8), (3, 2, 32, 16),
                                               (3, 1, 5, 3)])
def test_int8_conv_matches_jax_on_random_inputs(static, k, stride, cin, cout):
    """Random weights and inputs (channel counts off the card product's
    multiples of 8 included, and the stem's stride 2): the im2col product's
    int32 accumulators equal XLA's int8 conv of the same codes exactly, and
    the outputs equal JAX ``_Int8Conv2D``'s (rtol 1e-6; they are equal)."""
    rng = np.random.RandomState(k * 100 + cin)
    kernel, bias, x = _conv_inputs(rng, k, cin, cout)
    want, scales = _jax_conv(kernel, bias, x, k, stride, static)
    w = _port_weight(kernel)
    scales_t = None if scales is None else torch.from_numpy(scales)
    x_q, w_q, _ = tl.int8_codes(_nchw(x), w, scales_t)
    acc = tl.int8_gemm(x_q, w_q, stride)
    ref_acc = jax.lax.conv_general_dilated(
        jnp.asarray(_nhwc(x_q).astype(np.int8)), jnp.asarray(w_q.permute(2, 3, 1, 0).numpy()),
        (stride, stride), [(k // 2, k // 2)] * 2, dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), np.asarray(ref_acc))
    got = _nhwc(tl.int8_conv2d(_nchw(x), w, torch.from_numpy(bias), stride, scales_t))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


# --------------------------------------------------------------------------- #
# the quantized model
# --------------------------------------------------------------------------- #


def _inputs(seed=0, b=2):
    rng = np.random.RandomState(seed)
    img = rng.rand(b, 2 * LABEL, 2 * LABEL, 1).astype(np.float32)
    lab = rng.rand(b, LABEL, LABEL, 1).astype(np.float32)
    msk = (rng.rand(b, LABEL, LABEL, 1) > 0.3).astype(np.float32)
    return img, lab, msk


def _jax_model(quant=None):
    return JaxModel(label_size=LABEL, decoder="xla", quant=quant, **ARCH)


@pytest.fixture(scope="module")
def jax_f32():
    """The unquantized JAX model's params from a seed, and its f32 run."""
    inputs = _inputs()
    model = _jax_model()
    v = jax.jit(lambda *xs: model.init(jax.random.PRNGKey(0), *xs, train=False))(*inputs)
    params = {"params": jax.device_get(v["params"])}
    out = jax.jit(lambda v, *xs: model.apply(v, *xs, train=False))(params, *inputs)
    return params, inputs, [np.asarray(o[2]) for o in out]


def _jax_int8_run(quant, params, inputs):
    """JAX's int8 model: its (calibrated) variables, per-stage uvd, and each
    int8 conv's input and output in call order."""
    model = _jax_model(quant)
    v = dict(params)
    if "static" in quant:
        _, upd = jax.jit(lambda v, *xs: model.apply(v, *xs, train=False,
                                                    mutable=["quant_scales"]))(v, *inputs)
        v = dict(v, **jax.device_get(upd))

    def run(v, *xs):
        ins, outs = [], []

        def capture(nxt, args, kwargs, ctx):
            y = nxt(*args, **kwargs)
            if isinstance(ctx.module, _Int8Conv2D) and ctx.method_name == "__call__":
                ins.append(args[0])
                outs.append(y)
            return y

        with fnn.intercept_methods(capture):
            res = model.apply(v, *xs, train=False)
        return [r[2] for r in res], ins, outs

    uvd, ins, outs = jax.jit(run)(v, *inputs)
    return v, [np.asarray(u) for u in uvd], [np.asarray(a) for a in ins], \
        [np.asarray(a) for a in outs]


def _port_int8(quant, v):
    pm = PortModel(decoder="torch", quant=quant, **ARCH)
    pm.load_state_dict(state_dict_from_flax(v))
    if "static" in quant:
        tl.load_quant_scales(pm, quant_scales_from_flax(v))
    return pm.eval()


def _int8_convs(model):
    return [m for m in model.modules() if isinstance(m, tl.Conv) and m.quant]


@pytest.mark.parametrize("quant", ["int8", "int8_static", "int8_static_all", "int8_heads"])
def test_quantized_model_matches_jax(quant, jax_f32):
    """f32, the JAX model's params and calibrated scales in the port.

    (1) Each int8 conv fed the input JAX's conv saw: its output equals
    JAX's (jitted) to 2 f32 ulps of its largest magnitude, and per-stage
    uvd holds to rtol 1e-3 atol 2e-5.
    (2) Running free: the first int8 conv's codes equal JAX's but for
    fewer than 1 in 1,000, each off by one (its input differs from JAX's by
    at most 1e-5 of its scale); per-stage uvd within twice JAX's own
    int8-vs-f32 gap (the module docstring says why not 1e-3)."""
    params, inputs, uvd_f32 = jax_f32
    v, uvd_q, ins, outs = _jax_int8_run(quant, params, inputs)
    pm = _port_int8(quant, v)
    convs = _int8_convs(pm)
    assert len(convs) == len(ins) > 0
    xs = [_nchw(a) for a in inputs]

    forced, got_out, got_in = [_nchw(a) for a in ins], [], []
    hooks = [m.register_forward_pre_hook(lambda m, a: (forced[len(got_out)],)) for m in convs]
    hooks += [m.register_forward_hook(lambda m, a, o: got_out.append(_nhwc(o))) for m in convs]
    with torch.no_grad():
        res = pm(*xs)
    for h in hooks:
        h.remove()
    for i, (g, w, m) in enumerate(zip(got_out, outs, convs)):
        # XLA's jit contracts the epilogue's y * s_out + bias into one
        # rounding: the two part by at most half an ulp of the product plus
        # an ulp of the result, within 2 ulps of the largest |output| + |bias|
        bound = np.abs(w).max() + np.abs(m.bias.detach().numpy()).max()
        np.testing.assert_allclose(g, w, rtol=0, atol=2 * np.spacing(np.float32(bound)),
                                   err_msg=f"int8 conv {i}")
    for s in range(ARCH["stage"]):
        np.testing.assert_allclose(res[s][2].numpy(), uvd_q[s], rtol=1e-3, atol=2e-5)

    hook = convs[0].register_forward_pre_hook(lambda m, a: got_in.append(a[0]))
    with torch.no_grad():
        res = pm(*xs)
    hook.remove()
    x_jax, first = _nchw(ins[0]), convs[0]
    scale = first.act_absmax_c if first.quant == "int8_static" else None
    assert float((got_in[0] - x_jax).abs().max()) <= 1e-5 * float(x_jax.abs().max())
    codes = tl.int8_codes(got_in[0], first.weight, scale)[0].int()
    want = tl.int8_codes(x_jax, first.weight, scale)[0].int()
    flips = codes != want
    assert int(flips.sum()) * 1000 < codes.numel(), int(flips.sum())
    assert int((codes - want).abs().max()) <= 1
    for s in range(ARCH["stage"]):
        own = np.abs(uvd_q[s] - uvd_f32[s]).max()
        gap = np.abs(res[s][2].numpy() - uvd_q[s]).max()
        assert np.isfinite(res[s][2].numpy()).all()
        assert gap <= 2 * own, (s, gap, own)


@pytest.mark.parametrize("quant", ["int8_static", "int8_static_heads"])
def test_port_calibration_matches_jax_scales(quant, jax_f32):
    """The port's own calibration forward (``PixelwiseRegression.calibrate``)
    gives the first static conv the scales JAX's calibration gives it (rtol
    1e-5: its input differs from JAX's by ~1e-6 relative), and a scale for
    every static conv."""
    params, inputs, _ = jax_f32
    v, _, _, _ = _jax_int8_run(quant, params, inputs)
    pm = PortModel(decoder="torch", quant=quant, **ARCH)
    pm.load_state_dict(state_dict_from_flax(v))
    pm.eval().calibrate(*(_nchw(a) for a in inputs))
    got, want = tl.quant_scales(pm), quant_scales_from_flax(v)
    assert got.keys() == want.keys()
    first = next(iter(got))
    np.testing.assert_allclose(got[first].numpy(), want[first].numpy(), rtol=1e-5)
    assert all(float(s.min()) >= 0 and float(s.max()) > 0 for s in got.values())


@pytest.mark.parametrize(
    "quant", ["int8", "int8_all", "int8_heads", "int8_static", "int8_static_all"])
def test_quant_state_dict_identical_and_forward(quant):
    """(JAX ``test_quant_param_tree_identical_and_forward``.) The quantized
    model's state dict has the unquantized model's keys, shapes and dtypes,
    so one checkpoint serves every mode; the f32 params drive the quantized
    forward (static: after one calibration forward, every scale positive);
    uvd finite and the heatmaps still distributions (atol 1e-3)."""
    torch.manual_seed(0)
    m0, mq = PortModel(decoder="torch", **ARCH), PortModel(decoder="torch", quant=quant, **ARCH)
    s0, sq = m0.state_dict(), mq.state_dict()
    assert list(s0) == list(sq)
    assert all(s0[k].shape == sq[k].shape and s0[k].dtype == sq[k].dtype for k in s0)
    mq.load_state_dict(s0)
    mq.eval()
    xs = [_nchw(a) for a in _inputs()]
    if "static" in quant:
        mq.calibrate(*xs)
        assert all(float(s.max()) > 0 for s in tl.quant_scales(mq).values())
    with torch.no_grad():
        res = mq(*xs)
    assert len(res) == 2
    hm, _, uvd = res[-1]
    assert torch.isfinite(uvd).all()
    np.testing.assert_allclose(hm.sum(dim=(2, 3)).numpy(), 1.0, atol=1e-3)


def test_parse_quant_matches_jax():
    from pixelwiseregression_tpu.models.pixelwise import parse_quant as jax_parse_quant

    for q in (None, "none", "int8", "int8_all", "int8_heads", "int8_static", "int8_static_all",
              "int8_static_heads"):
        assert parse_quant(q) == jax_parse_quant(q), q
    with pytest.raises(ValueError, match="unknown quant mode"):
        parse_quant("int4")


def test_quant_refuses_training():
    mq = PortModel(decoder="torch", quant="int8", **ARCH).train()
    with pytest.raises(ValueError, match="inference-only"):
        mq(*(_nchw(a) for a in _inputs()))


def test_engines_refuse_quantized_models():
    """As the JAX engine builders (``tests/test_infer_engine.py``): the unit
    and fused engines refuse an int8 model."""
    from pixelwiseregression_tpu_torch.models import infer_engine

    model = PortModel(5, stage=1, features=32, level=1, quant="int8")
    for make in (infer_engine.make_unit_fused_apply, infer_engine.make_fused_apply):
        with pytest.raises(ValueError, match="quantized"):
            make(model)


def test_static_quant_requires_calibration():
    """A static model that never calibrated (nor loaded scales) raises
    instead of running on zero scales."""
    mq = PortModel(decoder="torch", quant="int8_static", **ARCH).eval()
    with pytest.raises(RuntimeError, match="quant_scales"), torch.no_grad():
        mq(*(_nchw(a) for a in _inputs()))
    with pytest.raises(KeyError):
        tl.load_quant_scales(mq, {"conv.3": torch.ones(32)})


def test_int8_static_accuracy_on_trained_batchnorm_model():
    """(JAX ``test_int8_static_accuracy_on_trained_batchnorm_model``.) The
    JAX gate's tiny batch-norm model, trained as it trains it (40 optax Adam
    steps), carried into the port; the port's ``int8_static_all``,
    calibrated by its own forwards on the gate's two batches (the second the
    first reversed and scaled by 1.1), tracks the port's f32 uvd: max < 0.02
    and mean < 0.005 normalized, JAX's bounds."""
    import optax

    rng = np.random.RandomState(0)
    b, ims, ls, joints = 16, 32, 16, 5
    img = jnp.asarray(rng.rand(b, ims, ims, 1) * 0.5, jnp.float32)
    label = jnp.asarray(rng.rand(b, ls, ls, 1) * 0.5, jnp.float32)
    mask = jnp.asarray((rng.rand(b, ls, ls, 1) > 0.3), jnp.float32)
    uvd_t = jnp.asarray(rng.uniform(-0.3, 0.3, (b, joints, 3)), jnp.float32)
    kw = dict(joints=joints, stage=1, features=16, level=1, norm_method="batch")
    model = JaxModel(label_size=ls, heatmap_method="softmax", decoder="xla", **kw)
    v = jax.jit(lambda *xs: model.init(jax.random.PRNGKey(0), *xs, train=False))(
        img, label, mask)
    params, bs = v["params"], v["batch_stats"]
    tx = optax.adam(1e-3)
    opt_state = tx.init(params)

    @jax.jit
    def step(params, bs, opt_state):
        def loss_fn(p):
            out, newv = model.apply({"params": p, "batch_stats": bs}, img, label, mask,
                                    train=True, mutable=["batch_stats"])
            return jnp.mean(jnp.sum((out[-1][2] - uvd_t) ** 2, -1)), newv["batch_stats"]
        (loss, nbs), g = jax.value_and_grad(loss_fn, has_aux=True)(params)
        up, nopt = tx.update(g, opt_state, params)
        return optax.apply_updates(params, up), nbs, nopt, loss

    for _ in range(40):
        params, bs, opt_state, loss = step(params, bs, opt_state)
    assert np.isfinite(float(loss))
    state = state_dict_from_flax(jax.device_get({"params": params, "batch_stats": bs}))
    xs = [_nchw(a) for a in (img, label, mask)]
    f32 = PortModel(decoder="torch", **kw)
    f32.load_state_dict(state)
    mq = PortModel(decoder="torch", quant="int8_static_all", **kw)
    mq.load_state_dict(state)
    mq.eval().calibrate(*xs)
    mq.calibrate(torch.flip(xs[0], dims=[0]) * 1.1, xs[1], xs[2])
    with torch.no_grad():
        uvd_f32 = f32.eval()(*xs)[-1][2].numpy()
        uvd_q = mq(*xs)[-1][2].numpy()
    d = np.abs(uvd_q - uvd_f32)
    assert d.max() < 0.02, f"int8_static_all drifted: max {d.max():.4f}"
    assert d.mean() < 0.005, f"int8_static_all drifted: mean {d.mean():.4f}"


# --------------------------------------------------------------------------- #
# plumbing: the test CLI and the bench
# --------------------------------------------------------------------------- #


def test_cli_quant_plumbing():
    p = tcommon.make_test_parser()
    assert tcommon.model_kwargs_from_args(p.parse_args(["--quant", "int8"]), 14)["quant"] == "int8"
    assert tcommon.model_kwargs_from_args(p.parse_args([]), 14)["quant"] is None


def test_test_cli_calibrates_and_refuses_zero_batches(tmp_path):
    """The port's test CLI on the MSRA fixture with ``--quant int8_static``:
    it calibrates on the first batch and writes a finite Result within 20
    px / mm of the f32 run's (JAX ``test_serve``'s bound for quant noise on
    an untrained net); with ``--quant_calib_batches 0`` it refuses to run."""
    import argparse

    from pixelwiseregression_tpu_torch.train.checkpoint import save_checkpoint

    root = str(tmp_path / "msra")
    subprocess.run([sys.executable, os.path.join(REPO, "tests", "fixtures",
                                                 "make_msra_fixture.py"), root],
                   check=True, capture_output=True, env=torch_port_threads.env())
    torch.manual_seed(0)
    kw = dict(stages=1, features=16, level=1, label_size=32)
    model = PortModel(21, stage=1, features=16, level=1, norm_method="instance")
    os.makedirs(tmp_path / "Model")
    save_checkpoint(str(tmp_path / "Model" / "MSRA_q_subject0_final.pt"), model,
                    model_param=dict(kw, norm_method="instance"))

    def run(**extra):
        args = argparse.Namespace(
            suffix="q", seed="final", batch_size=8, kernel_size=7, sigmoid=1.5,
            norm_method="instance", heatmap_method="softmax", filter_size=3, gpu_id="0",
            num_workers=2, decoder="cuda", data_path=root, device="cpu", bf16=False,
            quant="none", quant_calib_batches=4, skip_bad_samples=False, **kw)
        for k, v in extra.items():
            setattr(args, k, v)
        cwd = os.getcwd()
        os.chdir(tmp_path)
        try:
            name, _ = run_inference(args, "MSRA", subject=0)
            return np.loadtxt(tmp_path / name)
        finally:
            os.chdir(cwd)

    f32 = run()
    q = run(quant="int8_static", quant_calib_batches=1)
    assert q.shape == f32.shape == (4, 63) and np.isfinite(q).all()
    assert np.abs(q - f32).max() < 20
    with pytest.raises(RuntimeError, match="calibration batch"):
        run(quant="int8_static", quant_calib_batches=0)


def test_bench_quant_and_serving_lines_on_the_cpu(capsys):
    """``--quant int8_static`` tags the headline and calibrates first;
    ``--serving`` adds the int8 batch-norm serving line, sampled in turns with
    the headline; both lines count their ``torch._int_mm`` calls and launch no
    kernel on the CPU."""
    import json

    rc = bench.main(["--device", "cpu", "--joints", "5", "--features", "16", "--level", "2",
                     "--batch_size", "2", "--iters", "1", "--repeat", "3", "--no_train",
                     "--serving", "--quant", "int8_static"])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert rc == 0
    assert [line["metric"] for line in lines] == [
        "inference_fps_nyu_stage1_128_int8_static", "serving_fps_nyu_stage1_128_int8_batchnorm"]
    for line, quant, norm in zip(lines, ("int8_static", "int8_static_all"),
                                 ("instance_anchored", "batch")):
        assert line["value"] > 0 and line["samples"] >= 3 and line["device"] == "cpu"
        assert line["quant"] == quant and line["norm_method"] == norm
        launches = line["launches"]
        assert launches.pop("int_mm") > 0 and not any(launches.values())
