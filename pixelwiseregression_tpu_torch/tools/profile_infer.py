"""The inference forward's device time by kernel (the port of the JAX
package's ``tools/profile_infer.py``).

The JAX tool's forward (``ab_common.forward_call``: its bench's inputs, the
2-stage model at batch 256, bf16, ``instance`` norms), here with the kernel
decoder (K1 a stage; the JAX tool's default ``xla`` decoder is the port's
``--decoder torch``), and ``--quant int8[_static][_all|_heads]`` for the int8
serving model (static scales calibrated on the inputs first). Timed and
traced as ``profile_train`` does; prints its lines for the forward. With
``--device cpu`` the ops' CPU self time stands in for device time (a
rehearsal: host times).

Run: python -m pixelwiseregression_tpu_torch.tools.profile_infer
         [--batch_size 256] [--stages 2] [--quant int8_static_all] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

from pixelwiseregression_tpu_torch.tools import ab_common, profile_train


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch_size", type=int, default=256)
    ab_common.model_args(ap, "instance", dtype=True)
    ap.add_argument("--quant", type=str, default="",
                    help="int8[_static][_all|_heads]: the int8 serving model")
    ap.add_argument("--iters", type=int, default=8, help="profiled forwards")
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--wall_steps", type=int, default=10)
    ap.add_argument("--top", type=int, default=40)
    return ab_common.device_arg(ap).parse_args(argv)


def measure(args) -> dict:
    """``profile_train.profile_calls`` of the forward, with ``frames``,
    ``groups`` and the kernels' ``launches`` over every forward run."""
    device = ab_common.pick_device(args.device)
    call, _ = ab_common.forward_call(
        device, args.batch_size, args.joints, args.stages, args.features, args.level,
        args.norm_method, args.dtype, args.decoder, quant=args.quant or None)
    before = ab_common.read_counts()
    out = profile_train.profile_calls(call, device, args.iters, args.warmup, args.wall_steps)
    after = ab_common.read_counts()
    out.update(device=str(device), frames=args.batch_size * args.iters,
               groups=profile_train.groups(out["profile"]),
               launches={k: after[k] - before[k] for k in after if after[k] != before[k]})
    return out


def main(argv=None) -> dict:
    args = parse_args(argv)
    out = measure(args)
    print(f"forward by kernel: batch {args.batch_size}, stages {args.stages}, {args.dtype}, "
          f"{args.norm_method}, decoder {args.decoder}, quant {args.quant or 'none'}; launches "
          f"{out['launches']}", flush=True)
    profile_train.report(out, args.iters, args.top)
    return out


if __name__ == "__main__":
    main()
