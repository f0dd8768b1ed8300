"""Ablation: where does the fused conv + norm unit's time go on the card?
(the port of the JAX package's ``tools/ablate_fused_unit.py``; a path of K3
and of the K6 pieces)

Variants on the head shape (64x64, 128->128, 3x3, batch 256, bf16):

  full        the unit: K3 (conv + epilogue norm; conv bias 0, as the TPU
              probe has none)
  conv_only   K3 without the epilogue: the conv alone
  dots_only   the three tap products on a prebuilt operand
              ``[B, 66*64, 384]`` (``ablate_pieces.xm_dots``)
  build_only  the TPU probe's slice add ``xm[W:W+HW, C:2C] + xm[0:HW, 0:C]``,
              its two blocks gathered straight from x without the
              operand (``ablate_pieces.build_xm``, mode ``probe_sum``)
  stats_only  the norm's statistics and apply on the input, no conv (K3's
              statistics and apply kernels)
  copy        a read and a write of the input (``ablate_pieces.copy``)

The JAX tool's ``--bt`` (samples per VMEM grid step) is a TPU schedule
with no counterpart. Timing and launch checks: ``tools/ab_common.py``.

Run: python -m pixelwiseregression_tpu_torch.tools.ablate_fused_unit
         [--batch 256] [--iters 16] [--rounds 3] [--device cuda|cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from pixelwiseregression_tpu_torch.ops import ablate_pieces as ap
from pixelwiseregression_tpu_torch.ops.cuda_fused import fused_conv_norm
from pixelwiseregression_tpu_torch.tools import ab_common
from pixelwiseregression_tpu_torch.tools.ab_common import Variant

H = W = 64
C = CO = 128


def build_variants(batch: int, device: torch.device, seed: int = 0) -> dict:
    """The variants at the head shape, inputs from numpy with ``seed`` in
    the JAX tool's order (x + 2, wcat, the epilogue's scale and bias, the
    prebuilt operand)."""
    rng = np.random.RandomState(seed)
    hw = H * W

    def put(a, dtype=torch.bfloat16):
        return torch.from_numpy(a.astype(np.float32)).to(device, dtype)

    x = put(rng.randn(batch, hw, C) + 2.0)
    wcat = put(rng.randn(3, 3 * C, CO) * 0.1)
    es = put(1 + 0.1 * rng.randn(CO), torch.float32)
    eb = put(0.1 * rng.randn(CO), torch.float32)
    xm_pre = put(rng.randn(batch, (H + 2) * W, 3 * C) * 0.5)
    x4, kernel = x.view(batch, H, W, C), ap.unpack_wcat(wcat)
    zero = torch.zeros(CO, device=device)
    conv_ops, act = 2 * batch * hw * 9 * C * CO, 2 * batch * hw * C
    unit_bound = ab_common.bound_seconds(conv_ops, 2 * act + 2 * 9 * C * CO)
    return {
        "full": Variant(lambda: fused_conv_norm(x4, kernel, zero, epi_scale=es, epi_bias=eb),
                        {"K3": 1}, unit_bound),
        "conv_only": Variant(lambda: fused_conv_norm(x4, kernel, zero), {"K3": 1}, unit_bound),
        "build_only": Variant(lambda: ap.build_xm(x, H, W, "probe_sum"), {"build_xm": 1},
                              ab_common.bound_seconds(0, 2 * act)),
        "stats_only": Variant(lambda: ap.norm_stats_apply(x, es, eb), {"norm_stats_apply": 1},
                              ab_common.bound_seconds(0, 2 * act)),
        "copy": Variant(lambda: ap.copy(x), {"copy": 1}, ab_common.bound_seconds(0, 2 * act)),
        "dots_only": Variant(lambda: ap.xm_dots(xm_pre, wcat, hw, (0, W, 2 * W)), {"xm_dots": 1},
                             ab_common.bound_seconds(conv_ops, xm_pre.numel() * 2 + act
                                                     + 2 * 9 * C * CO)),
    }


def main(argv=None) -> dict:
    args = ab_common.parser(__doc__, batch=256, iters=16, rounds=3).parse_args(argv)
    device = ab_common.pick_device(args.device)
    print(f"head shape {H}x{W} {C}->{CO} k3, batch {args.batch}, bf16", flush=True)
    return ab_common.run(build_variants(args.batch, device), device, args.iters, args.rounds,
                         args.batch, width=12)


if __name__ == "__main__":
    main()
