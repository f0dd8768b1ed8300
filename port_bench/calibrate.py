"""The readings that a cell's limits are set from: the program against the
reference over many seeds (the lower reading), and the control and the
faults against the reference (the upper one). The benchmark's own runs do
not run this.

    python3 port_bench/calibrate.py --workload <cell> --seeds 1,2,3 --control 3 [--seconds 5]

Train cells: for each seed, the cell's set-up steps and the reference's
(``drivers/train_step``), then, for the first ``--control`` seeds, the
control (the reference with TF32 operands, the precision below the
configuration's float32) and the fault ``half_batch`` (the reference with
half of each batch left out of the loss, the mean over the rest), each held
against the float32 reference. A step that leaves its state unchanged
reads 1 on the change numbers by construction and is not run.

Serving cells: for each seed, the cell's clients for ``--seconds`` at the
cell's load and every answer against the reference (and, as
``self_uvd_gap``, against the program's first answer to the same
request); then the control's
answers (the reference with TF32 operands) and the fault ``answer_altered``
(one joint of one answer moved by one pixel).

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


def train_readings(ctx, drv, control: bool) -> list:
    prog = drv.build(ctx.cfg, ctx.mix, ctx.seed, ctx.device)
    n = ctx.mix["setup_steps"]
    readings = drv.setup_steps(ctx.cfg, prog, n, ctx.device)
    del prog["state"], prog["step"]
    harness.free(ctx.device)
    ref = drv.reference(ctx.cfg, ctx.mix, prog, n, ctx.device)
    out = [("program", harness.train_numbers(readings, ref, drv.MOVED_SHARE))]
    if control:
        for name, kw in (("control_tf32", {"tf32": True}), ("fault_half_batch", {"half_batch": True})):
            alt = drv.reference(ctx.cfg, ctx.mix, prog, n, ctx.device, **kw)
            out.append((name, harness.train_numbers(alt, ref, drv.MOVED_SHARE)))
            harness.free(ctx.device)
    return out


def serve_readings(ctx, drv, control: bool) -> list:
    pred, weights, requests = drv.build(ctx.cfg, ctx.mix, ctx.seed, ctx.device)
    clients = drv.Clients(ctx.mix["clients"], pred.predict, requests)
    try:
        clients.run(("count", ctx.mix["warm_requests"]))
        answers, _, _ = drv.window(clients, ctx.seconds)
    finally:
        clients.close()
    del pred, clients
    harness.free(ctx.device)
    ref = drv.reference(ctx.cfg, ctx.mix, weights, requests, ctx.device)
    first = {}
    for a in answers:
        first.setdefault(a[0], a)
    own = {r: {"uvd": a[3], "xyz": a[4]} for r, a in first.items()}
    out = [("program", {**drv.gaps(answers, ref), "answers": len(answers),
                        "self_uvd_gap": drv.gaps(answers, own)["uvd_gap"]})]
    if control:
        alt = drv.reference(ctx.cfg, ctx.mix, weights, requests, ctx.device, tf32=True)
        own = [(r, 0, 0, a["uvd"], a["xyz"]) for r, a in enumerate(alt)]
        out.append(("control_tf32", drv.gaps(own, ref)))
        r, _, _, uvd, xyz = answers[0]
        uvd = uvd.copy()
        uvd[0, 0, 0] += 1.0
        out.append(("fault_answer_altered", drv.gaps([(r, 0, 0, uvd, xyz)], ref)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--control", type=int, default=3, help="seeds that also run the control "
                    "and the faults")
    ap.add_argument("--seconds", type=float, default=5.0, help="a serving cell's window")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    bench = harness.benchmark()
    w = harness.cell(bench, args.workload)
    cfg, mix = harness.config(bench, w["config"]), harness.traffic(w["traffic"])
    drv = harness.driver(mix["driver"])
    reader = train_readings if mix["driver"] == "train_step" else serve_readings
    rows = []
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t = time.monotonic()
        ctx = types.SimpleNamespace(cfg=cfg, mix=mix, seed=seed, seconds=args.seconds,
                                    device=device, trace=False, workload=args.workload)
        for kind, numbers in reader(ctx, drv, i < args.control):
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
