"""The readings that the limits of a cell driven by ``predict_bb`` (requests
with a hand detector's boxes) are set from, as ``calibrate.py`` takes them
for the other cells. The benchmark's own runs do not run this.

    python3 port_bench/calibrate_bb.py --workload <cell> --seeds 1,2,3 --control 3 [--seconds 5]

For each seed: the cell's clients for ``--seconds`` at the cell's load, and
every answer against the reference (``uvd_gap``, ``xyz_gap``, ``com_gap``;
and, as ``self_uvd_gap``, against the program's first answer to the same
request). For the first ``--control`` seeds also the control (the reference
with TF32 operands) and the faults of the box step, each the reference with
that step broken (``reference/localize.FAULTS``: the box ignored, one round
of the cut, the raw frame handed on), each held against the reference.

Prints one JSON line a seed and reading, then the largest program reading
and the smallest control and fault readings of each number.
"""

import argparse
import json
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from port_bench import harness  # noqa: E402
from port_bench.reference import localize as ref_localize  # noqa: E402


def readings(ctx, drv, control: bool) -> list:
    pred, weights, requests = drv.build(ctx.cfg, ctx.mix, ctx.seed, ctx.device)
    clients = drv.Clients(ctx.mix["clients"], pred.predict, requests)
    try:
        clients.run(("count", ctx.mix["warm_requests"]))
        answers, _, _ = drv.base.window(clients, ctx.seconds)
    finally:
        clients.close()
    errors = [e for es in clients.errors for e in es]
    if errors:
        raise RuntimeError(f"failed requests: {errors[:3]}")
    del pred, clients
    harness.free(ctx.device)
    ref = drv.reference(ctx.cfg, ctx.mix, weights, requests, ctx.device)
    first = {}
    for a in answers:
        first.setdefault(a[0], a)
    own = {r: {"uvd": a[3], "xyz": a[4], "com": a[5]} for r, a in first.items()}
    out = [("program", {**drv.gaps(answers, ref), "answers": len(answers),
                        "self_uvd_gap": drv.gaps(answers, own)["uvd_gap"]})]
    if control:
        alts = [("control_tf32", {"tf32": True})] + [(f"fault_{f}", {"fault": f})
                                                      for f in ref_localize.FAULTS]
        for name, kw in alts:
            alt = drv.reference(ctx.cfg, ctx.mix, weights, requests, ctx.device, **kw)
            out.append((name, drv.gaps([(r, 0, 0, a["uvd"], a["xyz"], a["com"])
                                        for r, a in enumerate(alt)], ref)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--control", type=int, default=3, help="seeds that also run the control "
                    "and the faults")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("calibrate_bb: no CUDA card", file=sys.stderr)
        return 2
    bench = harness.benchmark()
    w = harness.cell(bench, args.workload)
    cfg, mix = harness.config(bench, w["config"]), harness.traffic(w["traffic"])
    drv = harness.driver(mix["driver"])
    rows = []
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t = time.monotonic()
        ctx = types.SimpleNamespace(cfg=cfg, mix=mix, seed=seed, seconds=args.seconds,
                                    device=device)
        for kind, numbers in readings(ctx, drv, i < args.control):
            rows.append((kind, numbers))
            print(json.dumps({"workload": args.workload, "seed": seed, "kind": kind, **numbers,
                              "seconds": time.monotonic() - t}), flush=True)
    summary = {}
    for kind, numbers in rows:
        for k, v in numbers.items():
            if k in ("answers", "self_uvd_gap"):
                continue
            pick = max if kind == "program" else min
            key = f"{kind}.{k}"
            summary[key] = pick(summary.get(key, v), v)
    print(json.dumps({"workload": args.workload, "summary": summary,
                      "device": torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu"}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
