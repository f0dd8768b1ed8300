"""The instance norm's statistic forms in the inference forward, in turns
in one process (the port of the JAX package's ``tools/bench_norm_variants.py``).

Each form is a first-class model config, as the JAX tool's lesson asks
(patching a norm's backward does not change its forward): ``instance``
(two-pass variance), ``instance_anchored`` (one-pass around the anchors:
uncalibrated here, the raw one-pass form, as in the bench) and
``instance_fast`` (one-pass). The JAX tool's forward
(``ab_common.forward_call``: its bench's inputs, stage 1, batch 256, bf16)
with the kernel decoder, one K1 a stage a call (checked by
``ab_common.run``), sampled in turns. Each variant's bound is the forward's
conv operations (``ab_common.conv_flops``) over the bf16 peak.

Run: python -m pixelwiseregression_tpu_torch.tools.bench_norm_variants
         [--batch 256] [--stages 1] [--iters 16] [--rounds 3] [--device cuda|cpu]
"""

from __future__ import annotations

from pixelwiseregression_tpu_torch.cli.common import DECODERS
from pixelwiseregression_tpu_torch.tools import ab_common
from pixelwiseregression_tpu_torch.tools.ab_common import Variant, conv_flops

NORMS = ("instance", "instance_anchored", "instance_fast")


def main(argv=None) -> dict:
    ap = ab_common.parser(__doc__, batch=256, iters=16, rounds=3)
    args = ab_common.model_args(ap, None, stages=1).parse_args(argv)
    device = ab_common.pick_device(args.device)
    k1 = args.stages if DECODERS[args.decoder] == "cuda" else 0
    variants = {}
    for norm in NORMS:
        call, model = ab_common.forward_call(device, args.batch, args.joints, args.stages,
                                             args.features, args.level, norm, "bf16",
                                             args.decoder)
        variants[norm] = Variant(call, launches={"K1": k1}, bound_s=ab_common.bound_seconds(
            conv_flops(model) * args.batch, 0))
    print(f"forward by norm form, batch {args.batch}, stages {args.stages}, bf16:", flush=True)
    out = ab_common.run(variants, device, args.iters, args.rounds, args.batch, width=18)
    for norm, ms in out["ms"].items():
        print(f"{norm}: {args.batch / ms * 1e3:.0f} fps  ({ms / args.batch * 1e3:.1f} us/frame)",
              flush=True)
    return out


if __name__ == "__main__":
    main()
