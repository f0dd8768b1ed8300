"""Base against remat in the train step, in turns in one process (the port
of the JAX package's ``tools/train_remat_ab.py``).

The JAX tool's step (``ab_common.train_step_call``: raw 480x640 frames,
augmentation, the 2-stage model in bf16 with the anchored norms, AdamW),
once plain and once with ``remat=True`` (each stage under
``torch.utils.checkpoint``, recomputed in the backward: the port's
counterpart of ``nn.remat(PredictionBlock)``), each with its own state,
sampled in turns by ``tools/ab_common.py``. The kernel decoder launches K1
and K2 once a stage a step, and K1 once more a stage under remat (the
recompute runs it); ``ab_common.run`` checks both.

Run: python -m pixelwiseregression_tpu_torch.tools.train_remat_ab
         [--batch 128] [--iters 6] [--rounds 4] [--device cuda|cpu]
"""

from __future__ import annotations

from pixelwiseregression_tpu_torch.tools import ab_common
from pixelwiseregression_tpu_torch.tools.train_ab import step_variant


def main(argv=None) -> dict:
    ap = ab_common.parser(__doc__, batch=128, iters=6, rounds=4)
    args = ab_common.model_args(ap, "instance_anchored").parse_args(argv)
    device = ab_common.pick_device(args.device)
    variants = {name: step_variant(device, args.batch, args, args.norm_method, args.decoder,
                                   remat=remat)
                for name, remat in (("base", False), ("remat", True))}
    print(f"train step base vs remat, batch {args.batch}, stages {args.stages}, bf16, "
          f"{args.norm_method}:", flush=True)
    out = ab_common.run(variants, device, args.iters, args.rounds, args.batch, width=6)
    for name, ms in out["ms"].items():
        print(f"  {name:6s} median {ms:7.2f} ms/step  ({args.batch / ms * 1e3:7.1f} f/s median)",
              flush=True)
    return out


if __name__ == "__main__":
    main()
