"""The inference forward's device time by model component (the port of the
JAX package's ``tools/profile_components.py``).

The JAX tool's forward (``ab_common.forward_call``): the 2-stage model at
batch 256 in bf16 with the anchored instance norms and the kernel decoder
(K1 a stage) on its bench's inputs. After a warm call, ``--iters`` forwards
are traced and every device kernel is attributed by
``tools/profile_common.py`` to its module's path cut to ``--depth`` parts
(stem, each stage's hourglass by level, heads, decoder), all ``[fwd]``.
With ``--device cpu`` the same rules split the ops' CPU self time (a
rehearsal: host times).

Run: python -m pixelwiseregression_tpu_torch.tools.profile_components
         [--batch_size 256] [--stages 2] [--iters 8] [--depth 3] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

from pixelwiseregression_tpu_torch.tools import ab_common, profile_common


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch_size", type=int, default=256)
    ab_common.model_args(ap, "instance_anchored", dtype=True)
    ap.add_argument("--iters", type=int, default=8, help="profiled forwards")
    ap.add_argument("--depth", type=int, default=3, help="component path depth")
    ap.add_argument("--top", type=int, default=40)
    return ab_common.device_arg(ap).parse_args(argv)


def measure(args) -> dict:
    """Trace the forwards; returns ``profile``, ``frames``,
    ``components`` (``{component: [us, kernels]}``) and the kernels'
    ``launches`` over every forward run."""
    device = ab_common.pick_device(args.device)
    call, model = ab_common.forward_call(
        device, args.batch_size, args.joints, args.stages, args.features, args.level,
        args.norm_method, args.dtype, args.decoder)
    before = ab_common.read_counts()
    call()
    prof = profile_common.profile(call, args.iters, device, model)
    after = ab_common.read_counts()
    return {"device": str(device), "profile": prof, "frames": args.batch_size * args.iters,
            "components": profile_common.by_component(prof, args.depth),
            "launches": {k: after[k] - before[k] for k in after if after[k] != before[k]}}


def main(argv=None) -> dict:
    args = parse_args(argv)
    out = measure(args)
    prof, frames = out["profile"], out["frames"]
    print(f"forward by component: batch {args.batch_size}, stages {args.stages}, {args.dtype}, "
          f"{args.norm_method}, decoder {args.decoder}, {args.iters} forwards traced; launches "
          f"{out['launches']}", flush=True)
    what = "device op time" if prof.device == "cuda" else "CPU self time (host)"
    print(f"total {what}: {prof.total_us / 1e3:.2f} ms => {prof.total_us / frames:.1f} us/frame",
          flush=True)
    profile_common.print_components(prof, frames, args.depth, args.top)
    return out


if __name__ == "__main__":
    main()
