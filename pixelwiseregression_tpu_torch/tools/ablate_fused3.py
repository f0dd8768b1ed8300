"""Chained units and a copy at 128x128 (the port of the JAX package's
``tools/ablate_fused3.py``; a path of K3 and of the K6 copy).

  head_chain_x6_bt{1,2,4}  six head epi units back to back (3x3 128->128
                           + norm+relu at 64x64): six K3 launches; bt (the
                           TPU's samples per grid step) has no counterpart,
                           so the three run the same kernels
  rb_merged_x6_bt{1,2}     six ResBlocks (norm->1x1 128->64, norm->3x3
                           64->64, norm->1x1 64->128 + skip), each one K3
                           chain launch
  copy128_3d, copy128_3d_banded, copy128_2d_rowblocks
                           a copy of [B, 128*128, 64] bf16 through the card
                           in the TPU's three block shapes: one kernel here
                           (``ablate_pieces.copy``)

Timing and launch checks: ``tools/ab_common.py``; on the card the lines also
give the chains' TFLOP/s and the copies' GB/s.

Run: python -m pixelwiseregression_tpu_torch.tools.ablate_fused3
         [--batch 256] [--iters 4] [--rounds 3] [--device cuda|cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from pixelwiseregression_tpu_torch.ops import ablate_pieces as ap
from pixelwiseregression_tpu_torch.ops.cuda_fused import fused_chain
from pixelwiseregression_tpu_torch.tools import ab_common
from pixelwiseregression_tpu_torch.tools.ab_common import Variant

H = W = 64
C = 128
K = 6
HS = WS = 128
CS = 64


def build_variants(batch: int, device: torch.device, seed: int = 0) -> dict:
    """The variants, inputs from numpy with ``seed`` in the JAX tool's order."""
    rng = np.random.RandomState(seed)

    def put(a, dtype=torch.float32):
        return torch.from_numpy(a.astype(np.float32)).to(device, dtype)

    x4 = put(rng.randn(batch, H, W, C) + 2.0, torch.bfloat16)
    w, b = put(rng.randn(3, 3, C, C) * 0.05), put(rng.randn(C) * 0.1)
    es, eb = put(1 + 0.1 * rng.randn(C)), put(0.1 * rng.randn(C))
    head = [{"kernel": w, "bias": b, "epi": (es, eb)}]
    ch = C // 2
    w0, w1, w2 = (put(rng.randn(1, 1, C, ch) * 0.1), put(rng.randn(3, 3, ch, ch) * 0.05),
                  put(rng.randn(1, 1, ch, C) * 0.1))
    b0, b1, b2 = put(rng.randn(ch) * 0.1), put(rng.randn(ch) * 0.1), put(rng.randn(C) * 0.1)
    rb = [{"kernel": wk, "bias": bk, "pro": (put(1 + 0.1 * rng.randn(c)), put(0.1 * rng.randn(c)))}
          for wk, bk, c in ((w0, b0, C), (w1, b1, ch), (w2, b2, ch))]
    xs3 = put(rng.randn(batch, HS * WS, CS), torch.bfloat16)

    def head_chain():
        x = x4
        for _ in range(K):
            x = fused_chain(x, head)
        return x

    def rb_chain():
        x = x4
        for _ in range(K):
            x = fused_chain(x, rb, skip=x)
        return x

    pixels, act = batch * H * W, 2 * batch * H * W * C
    head_bound = ab_common.bound_seconds(K * 2 * pixels * 9 * C * C, K * 2 * act)
    rb_bound = ab_common.bound_seconds(K * 2 * pixels * (C * ch + 9 * ch * ch + ch * C),
                                       K * 3 * act)
    copy_bound = ab_common.bound_seconds(0, 2 * xs3.numel() * 2)
    out = {}
    for bt in (1, 2, 4):
        note = None if bt == 1 else ab_common.no_counterpart(f"bt={bt}", "bt1's six K3 launches")
        out[f"head_chain_x{K}_bt{bt}"] = Variant(head_chain, {"K3": K}, head_bound, note)
    for bt in (1, 2):
        note = None if bt == 1 else ab_common.no_counterpart(f"bt={bt}", "bt1's six K3 launches")
        out[f"rb_merged_x{K}_bt{bt}"] = Variant(rb_chain, {"K3": K}, rb_bound, note)
    blocks = {"copy128_3d": None, "copy128_3d_banded": "block [1, HW/4, C]",
              "copy128_2d_rowblocks": "block [HW, C] of the 2-D view"}
    for name, block in blocks.items():
        note = None if block is None else ab_common.no_counterpart(block, "copy128_3d's kernel")
        out[name] = Variant(lambda: ap.copy(xs3), {"copy": 1}, copy_bound, note)
    return out


def main(argv=None) -> dict:
    args = ab_common.parser(__doc__, batch=256, iters=4, rounds=3).parse_args(argv)
    device = ab_common.pick_device(args.device)
    print(f"head chain x{K} and ResBlock chain x{K} at {H}x{W}, copy at {HS}x{WS}x{CS}, "
          f"batch {args.batch}, bf16", flush=True)
    out = ab_common.run(build_variants(args.batch, device), device, args.iters, args.rounds,
                        args.batch, width=22)
    if device.type != "cuda":
        return out
    pixels = args.batch * H * W
    ops = {"head": K * 2 * pixels * 9 * C * C,
           "rb": K * 2 * pixels * (C * C // 2 + 9 * (C // 2) ** 2 + C // 2 * C)}
    for name, ms in out["ms"].items():
        if name.startswith("copy"):
            rate = 2 * 2 * args.batch * HS * WS * CS / (ms / 1e3) / 1e9
            print(f"  {name}: {rate:.1f} GB/s", flush=True)
        else:
            rate = ops["head" if name.startswith("head") else "rb"] / (ms / 1e3) / 1e12
            print(f"  {name}: {ms / K:.5f} ms per unit, {rate:.1f} TFLOP/s", flush=True)
    return out


if __name__ == "__main__":
    main()
