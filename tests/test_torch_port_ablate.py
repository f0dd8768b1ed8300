"""PyTorch port vs the JAX package: the pieces of the fused unit that the
ablation tools time apart (K6, ``ops/ablate_pieces.py`` vs the helpers of
``ops/pallas_fused.py`` and the probe bodies of the TPU tools), and the
port's four ablation tools on the CPU.

The JAX ``_build_xm`` rolls with ``pltpu.roll``, which lowers only inside a
kernel, so the reference runs it in a one-block ``pl.pallas_call`` in
interpret mode; each probe's reference is the TPU tool's own body on that
operand. Inputs are made with numpy from a seed (8x8 maps, 16-32 channels).

Tolerances: data movement (``pack_wcat``, the operand, the probes) is
bit-exact; the probe that adds two blocks rounds once in both. f32
arithmetic (the norm, the products) is held within 1e-5 of the output's
largest magnitude (sums in another order); bf16 products within 2 bf16
ulps of it.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from pixelwiseregression_tpu.ops import pallas_fused as jf

from pixelwiseregression_tpu_torch.ops import ablate_pieces as ap
from pixelwiseregression_tpu_torch.tools import ab_common, ablate_fused2, ablate_fused3
from pixelwiseregression_tpu_torch.tools import ablate_fused_unit, bench_fused_chain

from torch_port_threads import one_thread  # noqa: F401 (autouse)

H = W = 8
HW = H * W
DTYPES = {"bfloat16": (jnp.bfloat16, torch.bfloat16), "float32": (jnp.float32, torch.float32)}


def _x(b, c, dtype, seed=0, offset=0.0):
    """[b, HW, c] numpy values rounded to ``dtype``, no exact zeros."""
    rng = np.random.RandomState(seed)
    return np.array(jnp.asarray(rng.randn(b, HW, c) + offset, DTYPES[dtype][0]).astype(jnp.float32))


def _jax_xm(x, dtype):
    """The JAX ``_build_xm`` of each sample of ``x`` [b, HW, c]."""
    jdt = DTYPES[dtype][0]
    c = x.shape[2]

    def kern(x_ref, o_ref):
        o_ref[...] = jf._build_xm(x_ref[...], H, W, c, jdt)

    one = pl.pallas_call(kern, out_shape=jax.ShapeDtypeStruct(((H + 2) * W, 3 * c), jdt),
                         interpret=True)
    return [one(jnp.asarray(s, jdt)) for s in x]


def _probe(mode, xm, xs):
    """The TPU tools' probe bodies on one sample's operand ``xm``."""
    c = xs.shape[1]
    if mode == "xm":
        return xm
    if mode == "probe_sum":  # tools/ablate_fused_unit.py:124
        return (xm[W:W + HW, c:2 * c] + xm[0:HW, 0:c]).astype(xm.dtype)
    if mode == "probe_cat":  # tools/ablate_fused2.py:180
        return jnp.concatenate([xm[W:W + HW, c:2 * c], xm[0:HW, 0:c]], axis=1)
    return jnp.concatenate([xs, xs, xs], axis=1)  # "repeat", tools/ablate_fused2.py:166


def _scale_gap(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    return float(np.abs(got - want).max()) / scale, scale


def test_pack_wcat_matches_jax():
    k = np.random.RandomState(1).randn(3, 3, 16, 24).astype(np.float32)
    np.testing.assert_array_equal(ap.pack_wcat(torch.from_numpy(k)).numpy(),
                                  np.asarray(jf.pack_wcat(jnp.asarray(k))))
    np.testing.assert_array_equal(ap.unpack_wcat(ap.pack_wcat(torch.from_numpy(k))).numpy(), k)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mode", ap.XM_MODES)
def test_build_xm_matches_jax(mode, dtype):
    """The operand and each probe, bit-exact, through the wrapper (its plain
    version on these CPU tensors: no launch)."""
    x = _x(2, 16, dtype, seed=2)
    want = np.stack([np.asarray(_probe(mode, xm, jnp.asarray(s, DTYPES[dtype][0])), np.float32)
                     for xm, s in zip(_jax_xm(x, dtype), x)])
    before = ap.BUILD_LAUNCHES
    got = ap.build_xm(torch.from_numpy(x).to(DTYPES[dtype][1]), H, W, mode)
    assert ap.BUILD_LAUNCHES == before
    assert got.dtype == DTYPES[dtype][1] and got.shape == want.shape
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_norm_affine_and_stats_piece_match_jax():
    """``norm_affine`` vs ``_norm_affine`` in f32, and the stats-only probe
    (bf16 in and out) vs the TPU probe's body."""
    x = _x(2, 32, "float32", seed=3, offset=2.0)
    rng = np.random.RandomState(4)
    s = (1 + 0.1 * rng.randn(32)).astype(np.float32)
    b = (0.1 * rng.randn(32)).astype(np.float32)
    want = np.stack([np.asarray(jf._norm_affine(jnp.asarray(xs), jnp.asarray(s)[None],
                                                jnp.asarray(b)[None], 1e-5)) for xs in x])
    got = ap.norm_affine(torch.from_numpy(x), torch.from_numpy(s), torch.from_numpy(b))
    assert _scale_gap(got.numpy(), want)[0] <= 1e-5

    xb = _x(2, 32, "bfloat16", seed=5, offset=2.0)
    want = np.stack([np.asarray(jf._norm_affine(jnp.asarray(xs, jnp.bfloat16).astype(jnp.float32),
                                                jnp.asarray(s)[None], jnp.asarray(b)[None], 1e-5)
                                .astype(jnp.bfloat16).astype(jnp.float32)) for xs in xb])
    before = ap.STATS_LAUNCHES
    got = ap.norm_stats_apply(torch.from_numpy(xb).to(torch.bfloat16), torch.from_numpy(s),
                              torch.from_numpy(b))
    assert ap.STATS_LAUNCHES == before and got.dtype == torch.bfloat16
    gap, scale = _scale_gap(got.float().numpy(), want)
    assert gap * scale <= 2.0 ** (np.floor(np.log2(scale)) - 7)  # 1 bf16 ulp of the scale


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("layout", ["taps", "repeat"])
def test_xm_dots_matches_jax(layout, dtype):
    """The products on a prebuilt operand (row offsets 0, W, 2W: dots_only)
    and on x repeated three times (offsets 0: conv2_dots_concat_only), vs
    the TPU probes' dots in f32 accumulation."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.RandomState(6)
    c, co = 16, 24
    rows, offsets = ((H + 2) * W, (0, W, 2 * W)) if layout == "taps" else (HW, (0, 0, 0))
    xm = np.array(jnp.asarray(rng.randn(2, rows, 3 * c), jdt).astype(jnp.float32))
    wcat = np.array(jnp.asarray(rng.randn(3, 3 * c, co) * 0.1, jdt).astype(jnp.float32))
    want = []
    for s in xm:
        acc = jnp.zeros((HW, co), jnp.float32)
        for di, o in enumerate(offsets):
            acc += jax.lax.dot_general(jnp.asarray(s, jdt)[o:o + HW], jnp.asarray(wcat[di], jdt),
                                       dimension_numbers=(((1,), (0,)), ((), ())),
                                       preferred_element_type=jnp.float32)
        want.append(np.asarray(acc.astype(jdt), np.float32))
    before = ap.DOTS_LAUNCHES
    got = ap.xm_dots(torch.from_numpy(xm).to(tdt), torch.from_numpy(wcat).to(tdt), HW, offsets)
    assert ap.DOTS_LAUNCHES == before and got.dtype == tdt
    gap, scale = _scale_gap(got.float().numpy(), np.stack(want))
    if dtype == "float32":
        assert gap <= 1e-5
    else:
        assert gap * scale <= 2 * 2.0 ** (np.floor(np.log2(scale)) - 7)


def test_copy_and_wrapper_checks_on_the_cpu():
    x = torch.from_numpy(_x(2, 16, "float32", seed=7)).to(torch.bfloat16)
    before = ap.COPY_LAUNCHES
    y = ap.copy(x)
    assert ap.COPY_LAUNCHES == before and torch.equal(y, x) and y.data_ptr() != x.data_ptr()
    with pytest.raises(ValueError, match="mode"):
        ap.build_xm(x, H, W, "nine_taps")
    with pytest.raises(ValueError):
        ap.build_xm(x, H + 1, W)
    with pytest.raises(ValueError, match="run past"):
        ap.xm_dots(x.repeat(1, 1, 3), torch.zeros(3, 48, 8), HW, (0, 1, 2))
    meta = torch.zeros(2, HW, 16, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ap.build_xm(meta, H, W)


@pytest.mark.parametrize("tool", [ablate_fused_unit, ablate_fused2, ablate_fused3,
                                  bench_fused_chain])
def test_ablation_tool_runs_on_the_cpu(tool):
    """Each tool end to end at batch 1 on the CPU (the plain versions): every
    variant returns finite values and is timed, and no kernel launches."""
    for name, v in tool.build_variants(1, torch.device("cpu")).items():
        out = v.fn()
        assert torch.isfinite(out.float()).all(), name
    out = tool.main(["--device", "cpu", "--batch", "1", "--iters", "1", "--rounds", "1"])
    assert set(out["ms"]) == set(tool.build_variants(1, torch.device("cpu")))
    assert out["launches"] == {} and out["device"] == "cpu"
    assert all(v > 0 for v in out["ms"].values())


def test_interleaved_estimate_isolates_a_failing_variant():
    """The estimator keeps sampling the others when one raises, and keeps
    the samples a variant banked before it died (bench.py's discipline)."""
    calls = {"n": 0}

    def dies_late():
        calls["n"] += 1
        if calls["n"] > 3:
            raise RuntimeError("lost")
        return 2.0

    res = ab_common.interleaved_estimate([lambda: 1.0, lambda: (_ for _ in ()).throw(ValueError("x")),
                                          dies_late, lambda: -1.0], repeat=4)
    # the all-negative sampler holds the round-robin to its bound, 3 x 4 rounds
    assert res[0] == (1.0, {"samples": 12, "spread_pct": 0.0})
    assert res[1][0] is None and "ValueError" in res[1][1]["error"]
    assert res[2][0] == 2.0 and "lost" in res[2][1]["sampler_error"]
    assert res[3][0] is None and "no positive" in res[3][1]["error"]


def test_compensated_norm_matches_jax():
    """``bench_fused_chain.instance_norm_fwd_comp`` (the tool's ``xla_comp``
    statistics) vs the JAX ``_instance_norm_fwd_comp`` on channels offset
    from 0 (where a plain one-pass E[x^2] - E[x]^2 cancels): both carry the
    sums to ~2^-48 and apply ``x*a + b`` alike, so the outputs agree within
    1e-5 of their scale (a rounding of ``x*a``, here ~10x the output)."""
    from pixelwiseregression_tpu.models.layers import _instance_norm_fwd_comp

    rng = np.random.RandomState(8)
    x = (5.0 + 0.5 * rng.randn(2, 16, 16, 32)).astype(np.float32)
    s = (1 + 0.1 * rng.randn(32)).astype(np.float32)
    b = (0.1 * rng.randn(32)).astype(np.float32)
    want, _ = _instance_norm_fwd_comp(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b), 1e-5)
    got = bench_fused_chain.instance_norm_fwd_comp(torch.from_numpy(x), torch.from_numpy(s),
                                                   torch.from_numpy(b))
    assert _scale_gap(got.numpy(), np.asarray(want))[0] <= 1e-5
