"""The benchmark of ``pixelwiseregression_tpu_torch`` on one NVIDIA H100.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json`` in this process: the cell's driver
builds the program and its inputs from ``--seed``, warms up the cell's own
shapes, measures for ``--seconds``, then holds what the program produced
against the plain reference (``port_bench/reference``) and prints, as the
last line of standard output, one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics with ``--trace 0``,
its per-layer metrics with ``--trace 1``), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each compared number beside its limit
(also the last lines of standard error).

``setup_s`` runs from this file's first statement to the window's opening:
imports, the kernels' library (built into the port's ``_build/`` on a
checkout's first run, loaded after), weights, traffic and warm-up.

Without a CUDA card, or with fewer than the cell asks for, it exits 2 and
prints no result; if ``jax``, ``jaxlib``, ``flax`` or the JAX package
``pixelwiseregression_tpu`` is loaded when the run ends, it exits 3.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from port_bench import harness  # noqa: E402


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run_cell(args, device, root: Path = harness.ROOT, t_start: float = T_START) -> dict:
    """Run the cell on ``device`` and return its result line as a dict."""
    bench = harness.benchmark(root)
    w = harness.cell(bench, args.workload)
    ctx = types.SimpleNamespace(
        cfg=harness.config(bench, w["config"], root), mix=harness.traffic(w["traffic"], root),
        seed=args.seed, seconds=args.seconds, trace=bool(args.trace), device=device,
        workload=args.workload)
    lim = harness.limits(args.workload, root)
    out = harness.driver(ctx.mix["driver"], root).run(ctx)

    e2e = [m for m in bench["end_to_end"] if harness.applies(m, args.workload)]
    values = {**out["e2e"], "setup_s": out["window_open"] - t_start}
    if args.trace:
        reported = {m["name"] for m in e2e}
        metrics = {}
        for m in bench["per_layer"]:
            if harness.applies(m, args.workload, reported):
                v = harness.metric_reader(m["name"], root).read(out["record"])
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in e2e}
    checks = harness.checks(out["numbers"], lim)
    correct = out["failed"] == 0 and all(c["value"] <= c["limit"] for c in checks.values())
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": out["memory_peak_bytes"]}
    line = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
            "metrics": metrics, "device": dev}
    if args.trace:
        tr = out["record"]["trace"]
        dev.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        line["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    line["checks"] = checks
    if out.get("errors"):
        print("failed requests: " + "; ".join(out["errors"]), file=sys.stderr)
    return line


def main(argv=None) -> int:
    args = parse_args(argv)
    bench = harness.benchmark()
    chips = harness.cell(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"port_bench: needs {chips} CUDA card(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    line = run_cell(args, torch.device("cuda", 0))
    found = harness.forbidden_loaded()
    if found:
        print(f"port_bench: the run loaded {found}; the benchmark runs the port alone",
              file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
