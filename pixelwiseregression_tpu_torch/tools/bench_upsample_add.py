"""The hourglass's nearest 2x upsample and skip add, in two forms timed in
turns (the port of the JAX package's ``tools/bench_upsample_add.py``).

  repeat  ``F.interpolate(h, scale_factor=2)`` then ``+ x``: the upsampled
          tensor is written out, then read back by the add (the JAX
          ``jnp.repeat`` form)
  fused   ``x`` viewed as ``[B, C, H, 2, W, 2]`` plus ``h[:, :, :, None, :,
          None]`` broadcast: one pass (``models/layers.upsample_nearest_2x_add``,
          the form the port's hourglass runs)

Both compute the same function (equal to the bit, checked first), so both
have one bound: h and x read once, the sum written once. NCHW bf16 at the
JAX tool's defaults: batch 256, 32x32 -> 64x64, 128 channels. Timing:
``tools/ab_common.py``.

Run: python -m pixelwiseregression_tpu_torch.tools.bench_upsample_add
         [--batch 256] [--size 32] [--channels 128] [--iters 64] [--rounds 3] [--device cuda|cpu]
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from pixelwiseregression_tpu_torch.models.layers import upsample_nearest_2x_add
from pixelwiseregression_tpu_torch.tools import ab_common
from pixelwiseregression_tpu_torch.tools.ab_common import Variant


def up_repeat(h, x):
    return F.interpolate(h, scale_factor=2, mode="nearest") + x


FORMS = {"repeat": up_repeat, "fused": upsample_nearest_2x_add}


def inputs(batch, size, channels, device, dtype=torch.bfloat16, seed=0):
    """h ``[batch, channels, size, size]`` and x at twice the side, normal
    draws from numpy with ``seed``."""
    rng = np.random.RandomState(seed)
    h = rng.randn(batch, channels, size, size)
    x = rng.randn(batch, channels, 2 * size, 2 * size)
    return [torch.from_numpy(a.astype(np.float32)).to(device, dtype) for a in (h, x)]


def main(argv=None) -> dict:
    ap = ab_common.parser(__doc__, batch=256, iters=64, rounds=3)
    ap.add_argument("--size", type=int, default=32, help="the low-res side (upsampled to 2x)")
    ap.add_argument("--channels", type=int, default=128)
    args = ap.parse_args(argv)
    device = ab_common.pick_device(args.device)
    h, x = inputs(args.batch, args.size, args.channels, device)
    if not torch.equal(up_repeat(h, x), upsample_nearest_2x_add(h, x)):
        raise RuntimeError("the two forms differ")
    bound = ab_common.bound_seconds(0, 2 * h.numel() * (1 + 4 + 4))
    variants = {name: Variant(lambda fn=fn: fn(h, x), bound_s=bound)
                for name, fn in FORMS.items()}
    print(f"upsample + skip add, [{args.batch},{args.channels},{args.size},{args.size}] -> "
          f"{2 * args.size}x{2 * args.size} bf16 (the hourglass runs the fused form):", flush=True)
    out = ab_common.run(variants, device, args.iters, args.rounds, args.batch, width=8)
    for name, ms in out["ms"].items():
        print(f"{name:8s} {ms / args.batch * 1e3:8.3f} us/frame ({ms:.3f} ms/batch-{args.batch})",
              flush=True)
    return out


if __name__ == "__main__":
    main()
