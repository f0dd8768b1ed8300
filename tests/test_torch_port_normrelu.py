"""PyTorch port vs the JAX package: the fused instance-norm + relu
(``ops/fused_normrelu.py`` in both packages) and its backward K5
(``ops/cuda_normrelu.py`` vs ``make_norm_relu_pallas``), and the port's A/B
tool over them (``tools/normrelu_bwd_ab.py``).

The port's K5 wrapper takes its plain version for these CPU tensors; the
JAX Pallas backward runs in interpret mode, as tests/test_fused_normrelu.py
runs it. Inputs are made with numpy from a seed at that file's sizes
([4|3, 8, 8, 128]) and handed to both.

Tolerances: the forward in bf16 is bit-exact (the statistics of bf16 data
agree to the bit or far below a bf16 rounding). In f32 the statistics are
sums in another order than XLA's (a sequential fold on the CPU at these
sizes, another order at larger ones), so the f32 mean is held within a
few f32 ulps of the data's magnitude, the rsqrt to 8 ulps (the variance's
sum parts by ~5, XLA's rsqrt and torch's by up to 2), and the output is
bit-exact when both apply the same statistics. The gradients are held to tests/test_fused_normrelu.py's
tolerances: rtol 1e-4 with atol (2e-2, 1e-3, 1e-3) for (dx, dscale, dbias)
against the XLA custom VJP and (2e-2, 1e-2, 1e-2) against the Pallas
kernel.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pixelwiseregression_tpu.ops import fused_normrelu as jnr

from pixelwiseregression_tpu_torch.ops import cuda_normrelu as tcn
from pixelwiseregression_tpu_torch.ops import fused_normrelu as tnr
from pixelwiseregression_tpu_torch.tools import normrelu_bwd_ab

from torch_port_threads import one_thread  # noqa: F401 (autouse)

EPS = 1e-5
DTYPES = {"bfloat16": (jnp.bfloat16, torch.bfloat16), "float32": (jnp.float32, torch.float32)}


def _make(b, dtype, seed=0, zero_channel=False):
    """x, the cotangent r, scale and bias as numpy, x and r rounded to ``dtype``."""
    rng = np.random.RandomState(seed)
    jdt = DTYPES[dtype][0]
    x = np.array(jnp.asarray(rng.randn(b, 8, 8, 128), jdt).astype(jnp.float32))
    r = np.array(jnp.asarray(rng.randn(b, 8, 8, 128), jdt).astype(jnp.float32))
    scale = (rng.randn(128) * 0.2 + 1.0).astype(np.float32)
    bias = (rng.randn(128) * 0.1).astype(np.float32)
    if zero_channel:
        scale[0] = bias[0] = 0.0
    return x, r, scale, bias


def _jax_grads(fn, x, r, scale, bias, dtype):
    jdt = DTYPES[dtype][0]

    def loss(x_, s_, b_):
        return jnp.sum(fn(x_, s_, b_, EPS).astype(jnp.float32) * jnp.asarray(r))

    g = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(jnp.asarray(x, jdt), jnp.asarray(scale),
                                                   jnp.asarray(bias))
    return [np.asarray(t, np.float32) for t in g]


def _port_grads(fn, x, r, scale, bias, dtype):
    tdt = DTYPES[dtype][1]
    leaves = [torch.from_numpy(x).to(tdt).requires_grad_(True),
              torch.from_numpy(scale).requires_grad_(True),
              torch.from_numpy(bias).requires_grad_(True)]
    y = fn(*leaves, EPS)
    (y.float() * torch.from_numpy(r)).sum().backward()
    assert leaves[0].grad.dtype == tdt
    return [t.grad.float().numpy() for t in leaves]


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_forward_matches_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    x, _, scale, bias = _make(4, dtype)
    want = np.asarray(jnr.norm_relu(jnp.asarray(x, jdt), jnp.asarray(scale), jnp.asarray(bias),
                                    EPS).astype(jnp.float32))
    xt = torch.from_numpy(x).to(tdt)
    got = tnr.norm_relu(xt, torch.from_numpy(scale), torch.from_numpy(bias), EPS)
    assert got.dtype == tdt
    _, (_, jmean, jinv, _, _) = jnr._norm_relu_fwd(jnp.asarray(x, jdt), jnp.asarray(scale),
                                                   jnp.asarray(bias), EPS)
    jmean, jinv = np.array(jmean), np.array(jinv)
    mean, inv = (t.numpy() for t in tnr.norm_relu_stats(xt, EPS))
    # sums of 64 values in another order: within a few f32 ulps of the data
    np.testing.assert_allclose(mean, jmean, rtol=0, atol=2.0 ** -21 * float(np.abs(x).max()))
    # the variance's sum in another order (a few ulps), then two rsqrt
    # implementations (each within 1 ulp of the exact value)
    np.testing.assert_array_max_ulp(inv, jinv, maxulp=8)
    # the same statistics give the same output, to the bit
    same = tnr.norm_relu_apply(xt, torch.from_numpy(jmean), torch.from_numpy(jinv),
                               torch.from_numpy(scale), torch.from_numpy(bias))
    np.testing.assert_array_equal(same.float().numpy(), want)
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got.float().numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("engine", ["norm_relu", "norm_relu_cuda"])
def test_gradients_match_the_jax_custom_vjp(engine, dtype):
    """The port's plain custom backward and K5's wrapper (its plain version
    on these CPU tensors) vs the JAX ``norm_relu`` custom VJP."""
    x, r, scale, bias = _make(4, dtype, seed=1)
    fn = tnr.norm_relu if engine == "norm_relu" else tcn.norm_relu_cuda
    want = _jax_grads(jnr.norm_relu, x, r, scale, bias, dtype)
    got = _port_grads(fn, x, r, scale, bias, dtype)
    for w, g, tol in zip(want, got, (2e-2, 1e-3, 1e-3)):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=tol)


@pytest.mark.parametrize("b", [4, 3])
def test_gradients_match_the_pallas_kernel(b):
    """K5's wrapper vs ``make_norm_relu_pallas(bt=2, interpret=True)``, bf16;
    b = 3 is not a multiple of bt (the JAX kernel falls back to bt = 1)."""
    x, r, scale, bias = _make(b, "bfloat16", seed=2)
    want = _jax_grads(jnr.make_norm_relu_pallas(bt=2, interpret=True), x, r, scale, bias,
                      "bfloat16")
    before = tcn.LAUNCHES
    got = _port_grads(tcn.norm_relu_cuda, x, r, scale, bias, "bfloat16")
    assert tcn.LAUNCHES == before  # CPU tensors take the plain version
    for w, g, tol in zip(want, got, (2e-2, 1e-2, 1e-2)):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=tol)


@pytest.mark.parametrize("engine", ["norm_relu", "norm_relu_cuda"])
def test_zero_channel_gives_zero_gradients(engine):
    """scale = bias = 0 drives y to exactly 0: the relu subgradient there is 0."""
    x, r, scale, bias = _make(2, "bfloat16", seed=3, zero_channel=True)
    fn = tnr.norm_relu if engine == "norm_relu" else tcn.norm_relu_cuda
    dx, ds, db = _port_grads(fn, x, r, scale, bias, "bfloat16")
    assert np.all(dx[..., 0] == 0.0) and ds[0] == 0.0 and db[0] == 0.0
    assert np.isfinite(dx).all() and np.abs(dx[..., 1:]).max() > 0


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_backward_matches_bwd_math(dtype):
    """``normrelu_bwd_plain`` vs ``_bwd_math`` on the same residuals."""
    jdt, tdt = DTYPES[dtype]
    x, r, scale, bias = _make(3, dtype, seed=4)
    _, res = jnr._norm_relu_fwd(jnp.asarray(x, jdt), jnp.asarray(scale), jnp.asarray(bias), EPS)
    xj, mean, inv = res[0], np.array(res[1]), np.array(res[2])
    want = [np.asarray(t, np.float32) for t in
            jnr._bwd_math(jnp.asarray(r, jdt), xj, mean, inv, jnp.asarray(scale),
                          jnp.asarray(bias))]
    got = tnr.normrelu_bwd_plain(torch.from_numpy(r).to(tdt), torch.from_numpy(x).to(tdt),
                                 torch.from_numpy(mean), torch.from_numpy(inv),
                                 torch.from_numpy(scale), torch.from_numpy(bias))
    assert got[0].dtype == tdt
    for w, g, tol in zip(want, got, (2e-2, 1e-3, 1e-3)):
        np.testing.assert_allclose(g.float().numpy(), w, rtol=1e-4, atol=tol)


def test_wrapper_rejects_a_device_that_is_neither_cpu_nor_cuda():
    x = torch.zeros(1, 2, 2, 8, device="meta")
    stat = torch.zeros(1, 8, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tcn.normrelu_bwd(x, x, stat, stat, stat[0], stat[0])


def test_ab_tool_variants_run_on_the_cpu():
    """Every variant of the A/B tool at batch 1 on the CPU gives finite
    gradients, and the norm+relu variants agree on them."""
    variants = normrelu_bwd_ab.build_variants(1, torch.device("cpu"))
    assert list(variants) == list(normrelu_bwd_ab.VARIANTS)
    grads = {name: v.fn() for name, v in variants.items()}
    for name, g in grads.items():
        assert all(torch.isfinite(t.float()).all() for t in g), name
    ref = grads["normrelu_fused"]
    for name in ("normrelu_composed", "normrelu_cuda", "normrelu_aten"):
        for w, g, tol in zip(ref, grads[name], (2e-2, 1e-2, 1e-2)):
            np.testing.assert_allclose(g.float().numpy(), w.float().numpy(), rtol=1e-3, atol=tol)
