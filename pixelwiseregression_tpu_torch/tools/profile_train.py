"""The train step's device time by kernel (the port of the JAX package's
``tools/profile_train.py``).

The JAX tool's step (its bench's train line, ``ab_common.train_step_call``;
``--norm_method instance`` as the JAX tool's, the kernel decoder). After
``--warmup`` steps, ``--wall_steps`` are timed by the host clock around a
synchronised run, then ``--iters`` steps are traced without module ranges
(``tools/profile_common.py``; nothing is added to the host's work). Prints
the wall time a step with and without the profiler, the device ops and
device time a step, the device's idle share over the traced span (the
union of its device events against the span from the first one's start to
the last one's end), the peak memory allocated, the time by the kernel-name
groups of ``profile_common.GROUPS``, and the per-kernel table (us/frame, share). With
``--device cpu`` the ops' CPU self time stands in for device time (a
rehearsal: host times).

Run: python -m pixelwiseregression_tpu_torch.tools.profile_train
         [--batch_size 128] [--iters 4] [--norm_method instance] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import time

import torch

from pixelwiseregression_tpu_torch.tools import ab_common, profile_common

def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch_size", type=int, default=128)
    ab_common.model_args(ap, "instance")
    ap.add_argument("--iters", type=int, default=4, help="profiled steps")
    ap.add_argument("--warmup", type=int, default=3, help="steps before the timed ones")
    ap.add_argument("--wall_steps", type=int, default=10, help="steps timed unprofiled")
    ap.add_argument("--top", type=int, default=45)
    return ab_common.device_arg(ap).parse_args(argv)


def groups(prof: profile_common.Profile) -> dict:
    """``{group: us}`` by ``profile_common.GROUPS``, largest first."""
    out = {}
    for name, (us, _) in profile_common.by_name(prof).items():
        g = profile_common.group(name)
        out[g] = out.get(g, 0.0) + us
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def profile_calls(call, device, iters: int, warmup: int, wall_steps: int, model=None,
                  ranges=()) -> dict:
    """Warm ``call`` up, time ``wall_steps`` calls, then trace ``iters``:
    ``wall_ms`` and ``profiled_wall_ms`` a call, the ``profile``, its
    device ``busy_us`` and ``span_us``, and ``peak_gib`` on a card."""
    def run(n):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t = time.perf_counter()
        for _ in range(n):
            call()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return (time.perf_counter() - t) / n * 1e3

    run(warmup)
    out = {"wall_ms": run(wall_steps)}
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    out["profile"] = profile_common.profile(call, iters, device, model, ranges)
    out["profiled_wall_ms"] = out["profile"].wall_s / iters * 1e3
    out["busy_us"], out["span_us"] = profile_common.busy(out["profile"])
    if device.type == "cuda":
        out["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
    return out


def measure(args) -> dict:
    """``profile_calls`` of the train step, with ``frames`` traced, its
    ``groups`` and the kernels' ``launches`` over every step taken."""
    device = ab_common.pick_device(args.device)
    call, _ = ab_common.train_step_call(
        device, args.batch_size, args.joints, args.stages, args.features, args.level,
        args.norm_method, "bf16", args.decoder)
    before = ab_common.read_counts()
    out = profile_calls(call, device, args.iters, args.warmup, args.wall_steps)
    after = ab_common.read_counts()
    out.update(device=str(device), frames=args.batch_size * args.iters,
               groups=groups(out["profile"]),
               launches={k: after[k] - before[k] for k in after if after[k] != before[k]})
    return out


def report(out: dict, iters: int, top: int, prefix: str = "") -> None:
    """The JAX tool's lines, with the wall times, idle share, groups and
    peak memory before them (on ``--device cpu``, host time in place of
    device time)."""
    prof, frames = out["profile"], out["frames"]
    total = prof.total_us
    per = total / iters / 1e3
    dev = "device" if prof.device == "cuda" else "host (CPU self time)"
    peak = f"; peak memory allocated {out['peak_gib']:.2f} GiB" if "peak_gib" in out else ""
    print(f"{prefix}{out['wall_ms']:.2f} ms/step unprofiled, {out['profiled_wall_ms']:.2f} ms/step "
          f"profiled ({iters} steps); {len(prof.leaves) / iters:.0f} {dev} ops/step, {dev} time "
          f"{per:.2f} ms/step; {dev} idle share {1 - out['busy_us'] / out['span_us']:.4f} of the "
          f"profiled span ({out['span_us'] / 1e3 / iters:.2f} ms/step){peak}", flush=True)
    for group, us in out["groups"].items():
        print(f"{prefix}group {group}: {us / 1e3 / iters:.2f} ms/step ({us / total:.4f} of {dev} "
              f"time)", flush=True)
    print(f"{prefix}total {dev} op time {total / 1e3:.1f} ms for {frames} frames = "
          f"{total / frames:.1f} us/frame ({per:.2f} ms/step)", flush=True)
    for name, (us, n) in list(profile_common.by_name(prof).items())[:top]:
        print(f"{prefix}{us / frames:8.2f} us/frame  {100 * us / total:5.1f}%  "
              f"({n / iters:.0f} a step)  {name[:110]}", flush=True)


def main(argv=None) -> dict:
    args = parse_args(argv)
    out = measure(args)
    print(f"train step by kernel: batch {args.batch_size}, stages {args.stages}, bf16, "
          f"{args.norm_method}, decoder {args.decoder}; launches {out['launches']}", flush=True)
    report(out, args.iters, args.top)
    return out


if __name__ == "__main__":
    main()
