"""The train step's device time by model component and by direction (the
port of the JAX package's ``tools/profile_train_components.py``).

The JAX tool's step (its bench's train line, ``ab_common.train_step_call``):
raw 480x640 frames, the on-device preprocess with augmentation, the 2-stage
model's forward and backward in bf16 with the anchored instance norms, the
kernel decoder (K1 forward, K2 backward), AdamW. After ``--warmup`` steps,
``--iters`` steps are traced (the JAX tool traced one jitted scan of
``--iters`` steps) and every device kernel is attributed by
``tools/profile_common.py``: ``[fwd]`` or ``[bwd]`` and its module's path
cut to ``--depth`` parts (``stages.0.hourglass``), or ``<non-model>``
(``preprocess``, ``loss``, the optimizer, ...).

Prints the device time a step, the model's forward, its backward and the
rest in us/frame and as a share, the top components with their kernels a
step, and the time by direction and module class (``[fwd] InstanceNorm``,
``[bwd] Conv``, ...) and by component, each split by kernel group
(elementwise, reduction, cast, convolution, ...). With ``--device cpu``
the same rules split the ops' CPU self time (a rehearsal: host times, not
device ones).

Run: python -m pixelwiseregression_tpu_torch.tools.profile_train_components
         [--batch_size 128] [--iters 4] [--depth 3] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

from pixelwiseregression_tpu_torch.tools import ab_common, profile_common
from pixelwiseregression_tpu_torch.train import loop

# the parts of the step outside the model, each run inside a named range
RANGES = (("preprocess", loop, "preprocess_batch"), ("loss", loop, "stage_losses"),
          ("loss", loop, "total_loss"))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch_size", type=int, default=128)
    ab_common.model_args(ap, "instance_anchored")
    ap.add_argument("--iters", type=int, default=4, help="profiled steps")
    ap.add_argument("--warmup", type=int, default=3, help="steps before the trace")
    ap.add_argument("--depth", type=int, default=3, help="component path depth")
    ap.add_argument("--top", type=int, default=50)
    return ab_common.device_arg(ap).parse_args(argv)


def measure(args) -> dict:
    """Trace the steps; returns ``profile`` (``profile_common.Profile``),
    ``frames``, ``ms_per_step``, ``split_us`` (fwd, bwd, non-model,
    unattributed), ``components`` (``{component: [us, kernels]}`` at
    ``--depth``), ``by_class`` (``profile_common.by_module_class``) and the
    kernels' ``launches`` over every step taken."""
    device = ab_common.pick_device(args.device)
    call, model = ab_common.train_step_call(
        device, args.batch_size, args.joints, args.stages, args.features, args.level,
        args.norm_method, "bf16", args.decoder)
    before = ab_common.read_counts()
    for _ in range(args.warmup):
        call()
    prof = profile_common.profile(call, args.iters, device, model, RANGES)
    after = ab_common.read_counts()
    return {"device": str(device), "profile": prof, "frames": args.batch_size * args.iters,
            "ms_per_step": prof.total_us / args.iters / 1e3, "split_us": profile_common.split(prof),
            "components": profile_common.by_component(prof, args.depth),
            "by_class": profile_common.by_module_class(prof, model),
            "launches": {k: after[k] - before[k] for k in after if after[k] != before[k]}}


def report(out: dict, depth: int, top: int) -> None:
    """The JAX tool's lines."""
    prof, frames, total = out["profile"], out["frames"], out["profile"].total_us
    sp = out["split_us"]
    what = "device op time" if prof.device == "cuda" else "CPU self time (host)"
    print(f"total {what} {total / 1e3:.1f} ms for {frames} frames = {total / frames:.1f} "
          f"us/frame ({out['ms_per_step']:.2f} ms/step)", flush=True)
    print(f"  model fwd {sp['fwd'] / frames:7.1f} us/frame ({100 * sp['fwd'] / total:.1f}%)   "
          f"model bwd {sp['bwd'] / frames:7.1f} ({100 * sp['bwd'] / total:.1f}%)   "
          f"non-model {sp['non-model'] / frames:7.1f} ({100 * sp['non-model'] / total:.1f}%)"
          f"   unattributed {sp['unattributed'] / frames:.1f}", flush=True)
    profile_common.print_components(prof, frames, depth, top)
    print("  by direction and module class, ms/step by kernel group:", flush=True)
    _print_groups(out["by_class"], prof.calls, total)
    print(f"  by component (depth {depth}), ms/step by kernel group:", flush=True)
    _print_groups(profile_common.grouped(
        prof, lambda leaf: profile_common.component(leaf.kind, leaf.where, depth)),
        prof.calls, total, least=0.005)


def _print_groups(table: dict, steps: int, total: float, least: float = 0.0) -> None:
    """One line a label of ``profile_common.grouped``: its time a step, then
    each group's; labels under ``least`` of the total are left out."""
    for label, groups in table.items():
        us = sum(groups.values())
        if us < least * total:
            continue
        print(f"  {us / steps / 1e3:8.3f} ms/step  {label}: " + ", ".join(
            f"{g} {t / steps / 1e3:.3f}" for g, t in groups.items()), flush=True)


def main(argv=None) -> dict:
    args = parse_args(argv)
    out = measure(args)
    print(f"train step by component: batch {args.batch_size}, stages {args.stages}, bf16, "
          f"{args.norm_method}, decoder {args.decoder}, {args.iters} steps traced; launches "
          f"{out['launches']}", flush=True)
    report(out, args.depth, args.top)
    return out


if __name__ == "__main__":
    main()
