"""The readings that the V2V cell's limits are set from (``calibrate.py``'s
train readings, with ``voxel_gap``): the program against the reference over
many seeds (the lower reading), and the control and the fault against the
reference (the upper one). The benchmark's own runs do not run this.

    python3 port_bench/calibrate_v2v.py --seeds 1,2,3 --control 3

For each seed, the cell's set-up steps and the reference's
(``drivers/train_v2v``); then, for the first ``--control`` seeds, the
control (the reference with TF32 operands) and the fault ``half_batch``
(the loss over half of each batch), each held against the float32
reference. Prints one JSON line a seed and reading, then the largest
program reading and the smallest control and fault readings of each
number.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from port_bench import harness  # noqa: E402

CELL = "train.nyu_v2v.b32"


def readings(cfg, mix, drv, seed, device, control: bool) -> list:
    prog = drv.build(cfg, mix, seed, device)
    n = mix["setup_steps"]
    got = drv.setup_steps(cfg, prog, n, device)
    del prog["state"], prog["step"]
    harness.free(device)
    ref = drv.reference(cfg, mix, prog, n, device)
    out = [("program", drv.numbers(got, ref))]
    del got
    harness.free(device)
    if control:
        for name, kw in (("control_tf32", {"tf32": True}), ("fault_half_batch", {"half_batch": True})):
            alt = drv.reference(cfg, mix, prog, n, device, **kw)
            out.append((name, drv.numbers(alt, ref)))
            del alt
            harness.free(device)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default=CELL)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--control", type=int, default=3, help="seeds that also run the control "
                    "and the fault")
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
    summary = {}
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t = time.monotonic()
        for kind, numbers in readings(cfg, mix, drv, seed, device, i < args.control):
            print(json.dumps({"workload": args.workload, "seed": seed, "kind": kind, **numbers,
                              "seconds": time.monotonic() - t}), flush=True)
            pick = max if kind == "program" else min
            for k, v in numbers.items():
                key = f"{kind}.{k}"
                summary[key] = pick(summary.get(key, v), v)
    print(json.dumps({"workload": args.workload, "summary": summary,
                      "device": torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu"}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
