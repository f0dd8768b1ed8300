"""PyTorch port vs the JAX package: the fused conv + instance-norm unit (K3,
``ops/cuda_fused.py`` vs ``ops/pallas_fused.py``) and the whole hourglass
(K4, ``ops/cuda_hourglass.py`` vs ``ops/pallas_hourglass.py``).

The port's wrappers take their plain versions for these CPU tensors; the
JAX functions run their Pallas kernels in interpret mode under ``jax.jit``,
as tests/test_pallas_fused.py and tests/test_infer_engine.py run them.
Inputs and weights are made with numpy from a seed, at the JAX tests'
sizes. The kernels themselves are held against the plain versions on the
card in test_torch_port_cuda.py.

Tolerances: in f32 the two compute the same function and differ only in
the order of their sums, so the gap is held to 2e-5 of the output's largest
magnitude. In bf16 the port rounds where the TPU kernels round, but XLA on
the CPU may keep a bf16 intermediate in f32 inside a fusion (its "excess
precision"), and an order difference can flip a rounding by one ulp that a
chain carries on: the K3 gap is held to a few bf16 ulps of the output's
largest magnitude (stated per test), well inside the JAX tests' own bf16
bounds (0.05-0.08). K4's bf16 apply rounds twice per norm and cancels
catastrophically at 1x1 and 2x2 (x*a and b of ~1e3 at a variance of 0), so
there the JAX reference runs in a subprocess with
``--xla_allow_excess_precision=false``, and the port must agree with it to
1 bf16 ulp of the output's scale.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pixelwiseregression_tpu.models.pixelwise import Hourglass as JaxHourglass
from pixelwiseregression_tpu.ops import pallas_fused as jfused
from pixelwiseregression_tpu.ops import pallas_hourglass as jhg

from pixelwiseregression_tpu_torch.compat.flax_bridge import state_dict_from_flax
from pixelwiseregression_tpu_torch.models.pixelwise import Hourglass as PortHourglass
from pixelwiseregression_tpu_torch.ops import cuda_fused as tfused
from pixelwiseregression_tpu_torch.ops import cuda_hourglass as thg

import torch_port_threads
from torch_port_threads import one_thread  # noqa: F401 (autouse)

F32_REL = 2e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _scale_gap(got, want):
    """max |got - want| over the output's largest magnitude, and that magnitude."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    return float(np.abs(got - want).max()) / scale, scale


def _bf16_ulps(got, want):
    """max |got - want| in bf16 ulps of the output's largest magnitude."""
    gap, scale = _scale_gap(got, want)
    return gap * scale / 2.0 ** (np.floor(np.log2(scale)) - 7)


def _torch(a, dtype):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dtype)


# --------------------------------------------------------------------------- #
# K3: fused_chain / fused_conv_norm
# --------------------------------------------------------------------------- #

# the cases of tests/test_pallas_fused.py: (B, H, W, C), the input's offset,
# units as (k, C, Co, prologue, epilogue), and the skip: none, x, or random
FORMS = {
    "epi_k1": ((3, 16, 16, 8), 0.0, [(1, 8, 16, False, True)], None),
    "epi_k3": ((3, 16, 16, 8), 0.0, [(3, 8, 16, False, True)], None),
    "pro_k1": ((2, 16, 16, 16), 5.0, [(1, 16, 8, True, False)], None),
    "pro_k3": ((2, 16, 16, 16), 5.0, [(3, 16, 8, True, False)], None),
    "both": ((2, 16, 16, 8), 2.0, [(3, 8, 16, True, True)], None),
    "pro_skip": ((2, 16, 16, 8), 1.0, [(1, 8, 16, True, False)], "rand"),
    "head_chain": ((2, 16, 16, 8), 0.0, [(3, 8, 8, False, True)] * 3, None),
    "resblock": ((2, 16, 16, 16), 1.0,
                 [(1, 16, 8, True, False), (3, 8, 8, True, False), (1, 8, 16, True, False)], "x"),
}


def _form_arrays(form, seed=0):
    shape, offset, spec, skip_kind = FORMS[form]
    rng = np.random.RandomState(seed)
    x = (offset + rng.randn(*shape)).astype(np.float32)
    units = []
    for k, c, co, pro, epi in spec:
        u = {"kernel": 0.3 * rng.randn(k, k, c, co), "bias": 0.1 * rng.randn(co)}
        if pro:
            u["pro"] = (1.0 + 0.1 * rng.randn(c), 0.1 * rng.randn(c))
        if epi:
            u["epi"] = (1.0 + 0.1 * rng.randn(co), 0.1 * rng.randn(co))
        units.append({k_: (tuple(np.float32(a) for a in v) if isinstance(v, tuple)
                           else v.astype(np.float32)) for k_, v in u.items()})
    co = spec[-1][2]
    skip = {None: None, "x": x, "rand": rng.randn(*shape[:3], co).astype(np.float32)}[skip_kind]
    return x, units, skip


def _run_both(form, dtype):
    x, units, skip = _form_arrays(form)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = getattr(torch, dtype)

    def jtree(u):
        return {k: (tuple(jnp.asarray(a) for a in v) if isinstance(v, tuple) else jnp.asarray(v))
                for k, v in u.items()}

    ju = [jtree(u) for u in units]
    jskip = None if skip is None else jnp.asarray(skip).astype(jdt)
    want = jax.jit(lambda a: jfused.fused_chain(a, ju, skip=jskip))(jnp.asarray(x).astype(jdt))

    def ttree(u):
        return {k: (tuple(_torch(a, torch.float32) for a in v) if isinstance(v, tuple)
                    else _torch(v, torch.float32)) for k, v in u.items()}

    tskip = None if skip is None else _torch(skip, tdt)
    got = tfused.fused_chain(_torch(x, tdt), [ttree(u) for u in units], skip=tskip)
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    return got.float().numpy(), np.asarray(want, np.float32)


@pytest.mark.parametrize("form", list(FORMS))
def test_fused_chain_f32_matches_jax(form):
    """f32: 2e-5 of the output's largest magnitude (the module docstring)."""
    got, want = _run_both(form, "float32")
    gap, _ = _scale_gap(got, want)
    print(f"fused_chain {form} f32: {gap:.3e} of the scale")
    assert gap <= F32_REL, gap


@pytest.mark.parametrize("form", list(FORMS))
def test_fused_chain_bf16_matches_jax(form):
    """bf16: at most 2 bf16 ulps of the output's largest magnitude; the
    three-unit chains (head, ResBlock) 4, since a flip in one unit moves
    the next unit's statistics."""
    got, want = _run_both(form, "bfloat16")
    assert np.isfinite(got).all()
    ulps = _bf16_ulps(got, want)
    print(f"fused_chain {form} bf16: {ulps:.2f} ulps of the scale")
    assert ulps <= (4.0 if len(FORMS[form][2]) > 1 else 2.0)


def test_fused_conv_norm_zero_padding_is_exact():
    """The border of tests/test_pallas_fused.py::test_conv_edges_exact_zero_padding:
    interior 9C, edges 6C, corners 4C, and a left tap that sees a zero at
    x=0, integer-exact in the port and equal to the JAX function's."""
    c = 8
    x = np.ones((1, 8, 8, c), np.float32)
    w = np.ones((3, 3, c, c), np.float32)
    b = np.zeros((c,), np.float32)
    xv = np.broadcast_to(np.arange(8, dtype=np.float32)[None, None, :, None], (1, 8, 8, c))
    wl = np.zeros((3, 3, c, c), np.float32)
    wl[1, 0] = 1.0
    for xi, wi in ((x, w), (xv, wl)):
        got = tfused.fused_conv_norm(_torch(xi, torch.float32), _torch(wi, torch.float32),
                                     _torch(b, torch.float32)).numpy()
        want = np.asarray(jfused.fused_conv_norm(jnp.asarray(xi), jnp.asarray(wi), jnp.asarray(b)))
        np.testing.assert_array_equal(got, want)
    got = tfused.fused_conv_norm(_torch(x, torch.float32), _torch(w, torch.float32),
                                 _torch(b, torch.float32))[0, :, :, 0].numpy()
    assert got[4, 4] == 9 * c and got[0, 4] == 6 * c and got[4, 0] == 6 * c
    assert got[0, 0] == 4 * c and got[-1, -1] == 4 * c
    got = tfused.fused_conv_norm(_torch(xv, torch.float32), _torch(wl, torch.float32),
                                 _torch(b, torch.float32))[0, 4, :, 0].numpy()
    np.testing.assert_array_equal(got, np.concatenate([[0.0], np.arange(7.0)]) * c)


# --------------------------------------------------------------------------- #
# K4: hourglass_fused and stack_hourglass_params
# --------------------------------------------------------------------------- #

LEVELS = [0, 1, 3]


@pytest.fixture(scope="module")
def hourglasses():
    """Per level (tests/test_infer_engine.py:32-46 sizes: 16 features, 16x16,
    batch 4): the stacked flax weights, the port's Hourglass on the same
    weights, the input, and the JAX hourglass_fused output in f32."""
    out = {}
    for level in LEVELS:
        m = JaxHourglass(features=16, level=level, norm_method="instance")
        x = np.random.RandomState(level).randn(4, 16, 16, 16).astype(np.float32)
        v = jax.device_get(jax.jit(lambda k, a: m.init(k, a, False))(jax.random.PRNGKey(0),
                                                                   jnp.asarray(x)))
        # norm scales and biases away from 1 and 0, so the affine is exercised
        rng = np.random.RandomState(10 + level)
        v = jax.tree_util.tree_map_with_path(
            lambda path, a: (a + 0.1 * rng.randn(*a.shape).astype(np.float32)
                             if "norm" in jax.tree_util.keystr(path) else a), v)
        stacked = jhg.stack_hourglass_params(v["params"], level)
        want = np.asarray(jax.jit(lambda a: jhg.hourglass_fused(a, stacked, level,
                                                                block_batch=2))(jnp.asarray(x)))
        port = PortHourglass(16, level, "instance").eval()
        state = state_dict_from_flax({"params": {"stage_0": {"hourglass": v["params"]}}})
        port.load_state_dict({k.removeprefix("stages.0.hourglass."): t for k, t in state.items()})
        out[level] = {"stacked": stacked, "port": port, "x": x, "want": want}
    return out


_BF16_EXACT = """
import sys
import numpy as np
import jax, jax.numpy as jnp
from pixelwiseregression_tpu.ops.pallas_hourglass import hourglass_fused
data = np.load(sys.argv[1])
out = {}
for level in map(int, sys.argv[3:]):
    stacked = {k.split("/", 1)[1]: jnp.asarray(a) for k, a in data.items()
               if k.startswith(f"{level}/")}
    x = jnp.asarray(data[f"x{level}"]).astype(jnp.bfloat16)
    out[str(level)] = np.asarray(jax.jit(lambda a: hourglass_fused(a, stacked, level))(x), np.float32)
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def hourglass_bf16_exact(hourglasses, tmp_path_factory):
    """The JAX hourglass_fused in bf16 with every rounding taken: a fresh
    process with ``--xla_allow_excess_precision=false`` (this one's XLA
    backend is already up)."""
    tmp = tmp_path_factory.mktemp("hg_bf16")
    arrays = {}
    for level, h in hourglasses.items():
        arrays[f"x{level}"] = h["x"]
        arrays.update({f"{level}/{k}": np.asarray(a) for k, a in h["stacked"].items()})
    np.savez(tmp / "in.npz", **arrays)
    env = torch_port_threads.env(
        JAX_PLATFORMS="cpu",
        XLA_FLAGS=os.environ.get("XLA_FLAGS", "") + " --xla_allow_excess_precision=false")
    r = subprocess.run([sys.executable, "-c", _BF16_EXACT, str(tmp / "in.npz"), str(tmp / "out.npz"),
                        *map(str, LEVELS)], capture_output=True, text=True, timeout=300,
                       cwd=REPO, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    with np.load(tmp / "out.npz") as out:
        return {int(k): out[k] for k in out.files}


@pytest.mark.parametrize("level", LEVELS)
def test_stack_hourglass_params_matches_jax(hourglasses, level):
    """The port stacks its module's weights into the JAX function's arrays, exactly."""
    h = hourglasses[level]
    got = thg.stack_hourglass_params(h["port"], level)
    assert set(got) == set(h["stacked"])
    assert got["w0"].shape[0] == thg.num_resblocks(level) == jhg.num_resblocks(level)
    for k, a in h["stacked"].items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(a), err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("level", LEVELS)
def test_hourglass_fused_matches_jax(hourglasses, hourglass_bf16_exact, level, dtype):
    """f32: 2e-5 of the output's largest magnitude (inside the JAX test's
    atol 2e-4, rtol 1e-4). bf16: 1 bf16 ulp of it against the JAX function
    with every rounding taken (the module docstring)."""
    h = hourglasses[level]
    stacked = thg.stack_hourglass_params(h["port"], level)
    got = thg.hourglass_fused(_torch(h["x"], getattr(torch, dtype)), stacked, level)
    assert got.dtype == getattr(torch, dtype)
    got = got.float().numpy()
    if dtype == "float32":
        gap, _ = _scale_gap(got, h["want"])
        print(f"hourglass_fused level {level} f32: {gap:.3e} of the scale")
        assert gap <= F32_REL, gap
    else:
        assert np.isfinite(got).all()
        ulps = _bf16_ulps(got, hourglass_bf16_exact[level])
        print(f"hourglass_fused level {level} bf16: {ulps:.2f} ulps of the scale")
        assert ulps <= 1.0


@pytest.mark.parametrize("level", LEVELS)
def test_hourglass_fused_matches_the_port_module(hourglasses, level):
    """f32: the plain K4 against the port's own Hourglass in eval mode
    (NCHW), 2e-5 of the output's scale: the same function, other sums."""
    h = hourglasses[level]
    x = _torch(h["x"], torch.float32)
    got = thg.hourglass_fused(x, thg.stack_hourglass_params(h["port"], level), level)
    with torch.inference_mode():
        want = h["port"](x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    gap, _ = _scale_gap(got.numpy(), want.numpy())
    print(f"hourglass_fused level {level} vs the port's Hourglass, f32: {gap:.3e} of the scale")
    assert gap <= F32_REL, gap


def _plain_split(x, stacked, level, tail):
    """The plain K4 run as the kernel splits it: the levels above ``tail``
    ResBlock by ResBlock with the plain version's pieces, then the
    sub-hourglass at ``tail`` as a call of its own on the stacked weights
    from its first ResBlock on, the ResBlock index then moving past its
    2*tail + 3 blocks (the weight offsets of csrc/hourglass.cu's hg)."""
    idx = [0]

    def take(n):
        sub = {k: v[idx[0]:idx[0] + n] for k, v in stacked.items()}
        idx[0] += n
        return sub

    def resblock(x):
        p = {k: v[0] if k in ("w0", "w1", "w2") else v[0].float() for k, v in take(1).items()}
        h = thg._norm_relu_act(x, p["s0"], p["sb0"])
        h = thg._dot_c(h, p["w0"], p["b0"])
        h = thg._norm_relu_act(h, p["s1"], p["sb1"])
        h = thg._conv3x3(h, p["w1"], p["b1"])
        h = thg._norm_relu_act(h, p["s2"], p["sb2"])
        return x + thg._dot_c(h, p["w2"], p["b2"])

    def hg(x, lv):
        if lv == tail:
            return thg.hourglass_fused_plain(x, take(thg.num_resblocks(lv)), lv)
        x = resblock(x)
        bsz, hh, ww, c = x.shape
        h = x.reshape(bsz, hh // 2, 2, ww // 2, 2, c).amax(dim=(2, 4))
        h = resblock(hg(h, lv - 1))
        y = x.reshape(bsz, hh // 2, 2, ww // 2, 2, c) + h[:, :, None, :, None, :]
        return y.reshape(x.shape)

    return hg(x, level)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("level, tail", [(3, 0), (3, 1), (3, 2), (1, 0)])
def test_hourglass_plain_split_at_the_tail_is_exact(hourglasses, dtype, level, tail):
    """The plain K4 run as the kernel splits it (``_plain_split``: the
    levels above ``tail``, then the sub-hourglass at ``tail`` on the stacked
    weights from its first ResBlock on) is bit-equal to the unsplit plain
    version: the tail's ResBlock offsets are right."""
    h = hourglasses[level]
    stacked = thg.stack_hourglass_params(h["port"], level)
    x = _torch(h["x"], getattr(torch, dtype))
    want = thg.hourglass_fused_plain(x, stacked, level)
    assert torch.equal(_plain_split(x, stacked, level, tail), want)


# name -> (x's shape, dtype, level of the call, error or None) for the
# wrapper's checks before it launches K4, on stacked weights of level 1 at
# 16 channels
HOURGLASS_CHECKS = {
    "fits": ((2, 16, 16, 16), torch.bfloat16, 1, None),
    "dtype": ((2, 16, 16, 16), torch.float16, 1, TypeError),
    "not_nhwc": ((16, 16, 16), torch.float32, 1, ValueError),
    "side_not_a_multiple": ((2, 18, 16, 16), torch.float32, 1, ValueError),
    "channels_not_a_multiple": ((2, 16, 16, 24), torch.float32, 1, ValueError),
    "stack_of_another_level": ((2, 16, 16, 16), torch.float32, 0, ValueError),
}


@pytest.mark.parametrize("case", [*HOURGLASS_CHECKS, "not_contiguous"])
def test_hourglass_fused_checks_its_inputs(hourglasses, case):
    """What K4's wrapper refuses before a launch: activations neither f32
    nor bf16, not 4-D, sides not multiples of 2^(level+1), channels not a
    multiple of 16, a strided tensor, weights stacked for another level; a
    well-formed call passes."""
    stacked = thg.stack_hourglass_params(hourglasses[1]["port"], 1)
    if case == "not_contiguous":
        shape, dtype, level, error = (2, 16, 16, 16), torch.float32, 1, ValueError
        x = torch.zeros(2, 16, 16, 16).transpose(1, 2)
    else:
        shape, dtype, level, error = HOURGLASS_CHECKS[case]
        x = torch.zeros(shape, dtype=dtype)
    if error is None:
        thg._check(x, stacked, level)
    else:
        with pytest.raises(error):
            thg._check(x, stacked, level)
