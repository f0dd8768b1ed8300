"""Chained A/B: K back-to-back conv + instance-norm units, plain PyTorch vs
the fused kernel (the port of the JAX package's
``tools/bench_fused_chain.py``; a path of K3).

Chaining models production (each unit reads its input from device memory
and writes its output there). The variants keep the JAX tool's names; its
XLA rows are plain PyTorch here (cuDNN's conv, channels_last, then the
norm as PyTorch elementwise ops and reductions), its Pallas rows K3:

  xla           conv (+ bias) -> two-pass instance norm -> relu
  xla_fast      conv -> one-pass norm, E[x^2] - E[x]^2
  xla_comp      conv -> compensated one-pass norm (TwoSum sums and a
                Dekker square; ``instance_norm_fwd_comp``)
  pallas3       K3's head epi unit, K times (no conv bias, as the TPU
                probe)
  pallas9       the TPU unit as one 9-tap product: the same K3 launches
  rb_xla, rb_pallas, rb_merged
                the ResBlock (norm->1x1 128->64, norm->3x3 64->64,
                norm->1x1 64->128 + skip), K times: plain; three one-unit
                K3 launches; one three-unit K3 chain
  head_merged3  three head units as one K3 chain, K/3 times
  stem_xla, stem_merged
                the stem pair at 128x128 ((norm) 3x3 32->64 (norm) ->
                3x3 64->128 (norm)): plain; one two-unit K3 chain

Timing and launch checks: ``tools/ab_common.py``; on the card the lines
also give each variant's time per unit (per ResBlock, per stem pair) and
TFLOP/s.

Run: python -m pixelwiseregression_tpu_torch.tools.bench_fused_chain
         [--batch 256] [--k 6] [--iters 4] [--rounds 3] [--skip_rb]
         [--device cuda|cpu]
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from pixelwiseregression_tpu_torch.ops.cuda_fused import fused_chain, fused_conv_norm
from pixelwiseregression_tpu_torch.tools import ab_common
from pixelwiseregression_tpu_torch.tools.ab_common import Variant

H = W = 64
C = 128
HS = WS = 128
EPS = 1e-5


def _comp_sum(x32, dim):
    """Sum over ``dim`` as a TwoSum (hi, lo) pair: halves added pairwise,
    the exact error of every add carried in lo (the JAX ``_comp_sum``)."""
    hi, lo = x32, torch.zeros_like(x32)
    while hi.shape[dim] > 1:
        if hi.shape[dim] % 2:
            pad = list(hi.shape)
            pad[dim] = 1
            hi = torch.cat([hi, hi.new_zeros(pad)], dim)
            lo = torch.cat([lo, lo.new_zeros(pad)], dim)
        h1, h2 = hi.chunk(2, dim)
        l1, l2 = lo.chunk(2, dim)
        s = h1 + h2
        z = s - h1
        e = (h1 - (s - z)) + (h2 - z)
        hi, lo = s, (l1 + l2) + e
    return hi.squeeze(dim), lo.squeeze(dim)


def _two_prod(a):
    """``a*a = p + pe`` exactly (Dekker's split by 4097)."""
    c = 4097.0 * a
    big = c - (c - a)
    small = a - big
    p = a * a
    return p, ((big * big - p) + 2.0 * big * small) + small * small


def instance_norm_fwd_comp(x, scale, bias, eps: float = EPS):
    """``scale * norm(x) + bias`` in f32 on NHWC ``x`` from compensated
    one-pass statistics (a copy of the JAX ``_instance_norm_fwd_comp``): a
    two-pass-grade variance from one-pass sums. H*W must be a power of two
    (the division by it is then exact); otherwise the two-pass form."""
    x32 = x.to(torch.float32)
    b, h, w, c = x.shape
    n = h * w
    if n & (n - 1):
        mean = x32.mean(dim=(1, 2), keepdim=True)
        var = torch.square(x32 - mean).mean(dim=(1, 2), keepdim=True)
    else:
        flat = x32.reshape(b, n, c)
        s1h, s1l = _comp_sum(flat, 1)
        s2h, s2l = _comp_sum(torch.square(flat), 1)
        mh, ml, e2h, e2l = (t / n for t in (s1h, s1l, s2h, s2l))
        p, pe = _two_prod(mh)
        var = torch.clamp_min((e2h - p) + (e2l - (pe + 2.0 * mh * ml)), 0.0)[:, None, None, :]
        mean = (mh + ml)[:, None, None, :]
    a = torch.rsqrt(var + eps) * scale
    return x32 * a + (bias - mean * a)


def _norm(x, s, b, form="two_pass", eps=EPS):
    """relu(norm(x)) in x's dtype, statistics in f32."""
    if form == "comp":
        return torch.clamp_min(instance_norm_fwd_comp(x, s, b, eps), 0.0).to(x.dtype)
    y32 = x.to(torch.float32)
    mean = y32.mean(dim=(1, 2), keepdim=True)
    if form == "fast":
        var = torch.clamp_min(torch.square(y32).mean(dim=(1, 2), keepdim=True) - mean ** 2, 0.0)
    else:
        var = torch.square(y32 - mean).mean(dim=(1, 2), keepdim=True)
    a = torch.rsqrt(var + eps) * s
    return torch.clamp_min(y32 * a + (b - mean * a), 0.0).to(x.dtype)


class _Conv:
    """A stride-1 zero-padded conv of NHWC activations on cuDNN (channels_last),
    HWIO weight and bias cast to the activation dtype once."""

    def __init__(self, w_hwio, bias, dtype):
        self.w = w_hwio.permute(3, 2, 0, 1).to(dtype).contiguous(memory_format=torch.channels_last)
        self.b = bias.to(dtype)
        self.pad = w_hwio.shape[0] // 2

    def __call__(self, x):
        return F.conv2d(x.permute(0, 3, 1, 2), self.w, self.b, padding=self.pad).permute(0, 2, 3, 1)


def build_variants(batch: int, device: torch.device, k: int = 6, skip_rb: bool = False,
                   seed: int = 0) -> dict:
    """The variants, inputs from numpy with ``seed`` in the JAX tool's order."""
    rng = np.random.RandomState(seed)
    bf16 = torch.bfloat16

    def put(a, dtype=torch.float32):
        return torch.from_numpy(a.astype(np.float32)).to(device, dtype)

    def repeat(fn, times, x0):
        def call():
            x = x0
            for _ in range(times):
                x = fn(x)
            return x
        return call

    x4 = put(rng.randn(batch, H, W, C) + 2.0, bf16)
    w, b = put(rng.randn(3, 3, C, C) * 0.05), put(rng.randn(C) * 0.1)
    es, eb = put(1 + 0.1 * rng.randn(C)), put(0.1 * rng.randn(C))
    conv = _Conv(w, b, bf16)
    zero = torch.zeros(C, device=device)
    pixels = batch * H * W
    head_ops = 2 * pixels * 9 * C * C
    head_bound = ab_common.bound_seconds(k * head_ops, k * 2 * 2 * pixels * C)
    out = {
        "xla": Variant(repeat(lambda x: _norm(conv(x), es, eb), k, x4), {}, head_bound),
        "xla_fast": Variant(repeat(lambda x: _norm(conv(x), es, eb, "fast"), k, x4), {},
                            head_bound),
        "xla_comp": Variant(repeat(lambda x: _norm(conv(x), es, eb, "comp"), k, x4), {},
                            head_bound),
    }
    pallas = repeat(lambda x: fused_conv_norm(x, w, zero, epi_scale=es, epi_bias=eb), k, x4)
    out["pallas3"] = Variant(pallas, {"K3": k}, head_bound)
    out["pallas9"] = Variant(pallas, {"K3": k}, head_bound, ab_common.no_counterpart(
        "one 9-tap product in place of three 3-tap ones", "pallas3's K3 launches"))
    if skip_rb:
        return out

    ch = C // 2
    w0, w1, w2 = (put(rng.randn(1, 1, C, ch) * 0.1), put(rng.randn(3, 3, ch, ch) * 0.05),
                  put(rng.randn(1, 1, ch, C) * 0.1))
    b0, b1, b2 = put(rng.randn(ch) * 0.1), put(rng.randn(ch) * 0.1), put(rng.randn(C) * 0.1)
    n0s, n0b = put(1 + 0.1 * rng.randn(C)), put(0.1 * rng.randn(C))
    n1s, n1b = put(1 + 0.1 * rng.randn(ch)), put(0.1 * rng.randn(ch))
    n2s, n2b = put(1 + 0.1 * rng.randn(ch)), put(0.1 * rng.randn(ch))
    convs = [_Conv(wk, bk, bf16) for wk, bk in ((w0, b0), (w1, b1), (w2, b2))]
    norms = ((n0s, n0b), (n1s, n1b), (n2s, n2b))

    def rb_plain(x):
        h = x
        for cv, (s, sb) in zip(convs, norms):
            h = cv(_norm(h, s, sb))
        return x + h

    def rb_units(x):
        h = fused_conv_norm(x, w0, b0, pro_scale=n0s, pro_bias=n0b)
        h = fused_conv_norm(h, w1, b1, pro_scale=n1s, pro_bias=n1b)
        return fused_conv_norm(h, w2, b2, pro_scale=n2s, pro_bias=n2b, skip=x)

    rb_chain = [{"kernel": wk, "bias": bk, "pro": nrm}
                for (wk, bk), nrm in zip(((w0, b0), (w1, b1), (w2, b2)), norms)]
    head3 = [{"kernel": w, "bias": b, "epi": (es, eb)}] * 3
    rb_bound = ab_common.bound_seconds(k * 2 * pixels * (C * ch + 9 * ch * ch + ch * C),
                                       k * 3 * 2 * pixels * C)
    out["rb_xla"] = Variant(repeat(rb_plain, k, x4), {}, rb_bound)
    out["rb_pallas"] = Variant(repeat(rb_units, k, x4), {"K3": 3 * k}, rb_bound)
    out["head_merged3"] = Variant(repeat(lambda x: fused_chain(x, head3), k // 3, x4),
                                  {"K3": k // 3},
                                  ab_common.bound_seconds(3 * (k // 3) * head_ops,
                                                          (k // 3) * 2 * 2 * pixels * C))
    out["rb_merged"] = Variant(repeat(lambda x: fused_chain(x, rb_chain, skip=x), k, x4),
                               {"K3": k}, rb_bound)

    xs = put(rng.randn(batch, HS, WS, 32) + 1.0, bf16)
    sw1, sb1 = put(rng.randn(3, 3, 32, 64) * 0.1), put(rng.randn(64) * 0.1)
    sw2, sb2 = put(rng.randn(3, 3, 64, 128) * 0.05), put(rng.randn(128) * 0.1)
    s0s, s0b = put(1 + 0.1 * rng.randn(32)), put(0.1 * rng.randn(32))
    s1s, s1b = put(1 + 0.1 * rng.randn(64)), put(0.1 * rng.randn(64))
    s2s, s2b = put(1 + 0.1 * rng.randn(128)), put(0.1 * rng.randn(128))
    sconv1, sconv2 = _Conv(sw1, sb1, bf16), _Conv(sw2, sb2, bf16)
    stem_units = [{"kernel": sw1, "bias": sb1, "pro": (s0s, s0b), "epi": (s1s, s1b)},
                  {"kernel": sw2, "bias": sb2, "epi": (s2s, s2b)}]
    spix = batch * HS * WS
    stem_bound = ab_common.bound_seconds(2 * spix * 9 * (32 * 64 + 64 * 128),
                                         2 * spix * (32 + 128))
    out["stem_xla"] = Variant(
        lambda: _norm(sconv2(_norm(sconv1(_norm(xs, s0s, s0b)), s1s, s1b)), s2s, s2b), {},
        stem_bound)
    out["stem_merged"] = Variant(lambda: fused_chain(xs, stem_units), {"K3": 1}, stem_bound)
    return out


def main(argv=None) -> dict:
    ap = ab_common.parser(__doc__, batch=256, iters=4, rounds=3)
    ap.add_argument("--k", type=int, default=6, help="units (ResBlocks) per chain")
    ap.add_argument("--skip_rb", action="store_true", help="the head chains only")
    args = ap.parse_args(argv)
    device = ab_common.pick_device(args.device)
    print(f"chains of {args.k} at {H}x{W} {C} channels, stem at {HS}x{WS}, batch {args.batch}, "
          f"bf16", flush=True)
    out = ab_common.run(build_variants(args.batch, device, args.k, args.skip_rb), device,
                        args.iters, args.rounds, args.batch, width=14)
    if device.type != "cuda":
        return out
    pixels = args.batch * H * W
    ch = C // 2
    ops = {"head": 2 * pixels * 9 * C * C, "rb": 2 * pixels * (C * ch + 9 * ch * ch + ch * C),
           "stem": 2 * args.batch * HS * WS * 9 * (32 * 64 + 64 * 128)}
    for name, ms in out["ms"].items():
        kind = name.split("_")[0] if name.startswith(("rb", "stem")) else "head"
        n = 3 * (args.k // 3) if name == "head_merged3" else 1 if kind == "stem" else args.k
        print(f"  {name}: {ms / n:.5f} ms per unit, "
              f"{ops[kind] * n / (ms / 1e3) / 1e12:.1f} TFLOP/s", flush=True)
    return out


if __name__ == "__main__":
    main()
