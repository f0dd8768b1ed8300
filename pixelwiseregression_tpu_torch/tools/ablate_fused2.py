"""Sub-ablations of the fused unit at the head and stem shapes (the port of
the JAX package's ``tools/ablate_fused2.py``; a path of K3 and of the K6
pieces).

1. The head epi unit (3x3 128->128 + norm+relu at 64x64) with two samples
   per grid step, in order or interleaved: a TPU schedule. Both variants
   run K3's epi unit over the batch here.
2. The stem's two epi units at 128x128 and their pieces:

   conv1_32_64_epi         K3, 3x3 32->64 + norm+relu
   conv2_64_128_epi        K3, 3x3 64->128 + norm+relu
   conv2_chunked_acc       the TPU unit with its accumulator in two halves:
                           K3's conv2 unit here
   conv2_dots_concat_only  the products on ``concat(x, x, x)`` (the right
                           shape, not the conv): ``build_xm`` mode
                           ``repeat``, then ``xm_dots`` at row offsets
                           (0, 0, 0)
   conv2_build_only        the TPU probe's two operand blocks side by
                           side, gathered straight from x without the
                           operand (``build_xm`` mode ``probe_cat``)

The units have no conv bias, as the TPU probes. Timing and launch checks:
``tools/ab_common.py``.

Run: python -m pixelwiseregression_tpu_torch.tools.ablate_fused2
         [--batch 256] [--iters 8] [--rounds 3] [--device cuda|cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from pixelwiseregression_tpu_torch.ops import ablate_pieces as ap
from pixelwiseregression_tpu_torch.ops.cuda_fused import fused_conv_norm
from pixelwiseregression_tpu_torch.tools import ab_common
from pixelwiseregression_tpu_torch.tools.ab_common import Variant

H = W = 64
C = 128
HS = WS = 128


def inputs(batch: int, device: torch.device, seed: int = 0) -> dict:
    """Both parts' inputs, from numpy with ``seed`` in the JAX tool's order:
    the head's ``x``, ``wcat``, ``es``, ``eb`` and the stem's ``x1``,
    ``x2``, ``w1``, ``w2``, ``n1s``, ``n1b``, ``n2s``, ``n2b``."""
    rng = np.random.RandomState(seed)

    def put(a, dtype=torch.bfloat16):
        return torch.from_numpy(a.astype(np.float32)).to(device, dtype)

    f32 = torch.float32
    t = {"x": put(rng.randn(batch, H * W, C) + 2.0), "wcat": put(rng.randn(3, 3 * C, C) * 0.05)}
    t["es"], t["eb"] = put(1 + 0.1 * rng.randn(C), f32), put(0.1 * rng.randn(C), f32)
    t["x1"] = put(rng.randn(batch, HS * WS, 32) + 1.0)
    t["x2"] = put(rng.randn(batch, HS * WS, 64) + 1.0)
    t["w1"] = put(rng.randn(3, 96, 64) * 0.1)
    t["w2"] = put(rng.randn(3, 192, 128) * 0.05)
    t["n1s"], t["n1b"] = put(1 + 0.1 * rng.randn(64), f32), put(0.1 * rng.randn(64), f32)
    t["n2s"], t["n2b"] = put(1 + 0.1 * rng.randn(128), f32), put(0.1 * rng.randn(128), f32)
    return t


def build_variants(batch: int, device: torch.device, seed: int = 0) -> dict:
    """Both parts' variants on ``inputs(batch, device, seed)``."""
    t = inputs(batch, device, seed)
    x, wcat, es, eb = t["x"], t["wcat"], t["es"], t["eb"]
    x1, x2, w1, w2 = t["x1"], t["x2"], t["w1"], t["w2"]
    n1s, n1b, n2s, n2b = t["n1s"], t["n1b"], t["n2s"], t["n2b"]
    hws = HS * WS

    def epi_unit(xx, h, w, wc, s, b):
        """One epi unit on ``[B, h*w, C]``: K3 with a zero conv bias."""
        k = ap.unpack_wcat(wc)
        cin, cout = k.shape[2], k.shape[3]
        zero = torch.zeros(cout, device=device)
        x4 = xx.view(xx.shape[0], h, w, cin)
        pixels = xx.shape[0] * h * w
        bound = ab_common.bound_seconds(2 * pixels * 9 * cin * cout, 2 * pixels * (cin + cout))
        return Variant(lambda: fused_conv_norm(x4, k, zero, epi_scale=s, epi_bias=b),
                       {"K3": 1}, bound)

    head, conv2 = epi_unit(x, H, W, wcat, es, eb), epi_unit(x2, HS, WS, w2, n2s, n2b)
    stem_act = 2 * batch * hws * 64
    return {
        "bt2_sequential": Variant(head.fn, head.launches, head.bound_s, ab_common.no_counterpart(
            "two samples per grid step, in order", "K3's head epi unit over the batch")),
        "bt2_interleaved": Variant(head.fn, head.launches, head.bound_s, ab_common.no_counterpart(
            "two samples per grid step, interleaved", "K3's head epi unit over the batch")),
        "conv1_32_64_epi": epi_unit(x1, HS, WS, w1, n1s, n1b),
        "conv2_64_128_epi": conv2,
        "conv2_chunked_acc": Variant(conv2.fn, conv2.launches, conv2.bound_s,
                                     ab_common.no_counterpart("the accumulator in two halves",
                                                              "K3's conv2 unit")),
        "conv2_dots_concat_only": Variant(
            lambda: ap.xm_dots(ap.build_xm(x2, HS, WS, "repeat"), w2, hws, (0, 0, 0)),
            {"build_xm": 1, "xm_dots": 1},
            ab_common.bound_seconds(2 * batch * hws * 3 * 192 * 128, stem_act + 2 * stem_act)),
        "conv2_build_only": Variant(lambda: ap.build_xm(x2, HS, WS, "probe_cat"), {"build_xm": 1},
                                    ab_common.bound_seconds(0, stem_act + 2 * stem_act)),
    }


def main(argv=None) -> dict:
    args = ab_common.parser(__doc__, batch=256, iters=8, rounds=3).parse_args(argv)
    device = ab_common.pick_device(args.device)
    print(f"head epi unit {H}x{W} {C}->{C} and stem units at {HS}x{WS}, batch {args.batch}, bf16",
          flush=True)
    return ab_common.run(build_variants(args.batch, device), device, args.iters, args.rounds,
                         args.batch, width=24)


if __name__ == "__main__":
    main()
