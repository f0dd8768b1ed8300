"""What every cell shares: finding a cell's parts by name, the device's
description, the import guard, the reduction of a ``torch.profiler`` trace,
and the comparisons that decide ``correct``.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix. The
parts are files, found by name, so that a new configuration, mix or
per-layer metric is a new file and no edit:

* ``port_bench/configs/<config>.json``: the model and data sizes as run;
* ``port_bench/traffic/<mix>.json``: the mix's parameters and its
  ``driver``, ``port_bench/drivers/<driver>.py`` (``run(ctx)``);
* ``port_bench/limits/<workload>.json``: each compared number's limit;
* ``port_bench/metrics/<metric>.py``: ``read(record)``, a per-layer metric
  from a traced run's record, or None where the record has nothing for it.
"""

from __future__ import annotations

import bisect
import gc
import importlib.util
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
# compared by whole top-level module name: the port's package begins with
# the JAX package's name and is allowed
FORBIDDEN = ("jax", "jaxlib", "flax", "pixelwiseregression_tpu")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
CPU_CATS = ("cpu_op", "user_annotation")
TOP = 10
NAME_CHARS = 160


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return read_json(root / "BENCHMARK.json")


def cell(bench: dict, workload: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return read_json(root / c["file"])
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str, root: Path = ROOT) -> dict:
    return read_json(root / "port_bench" / "traffic" / f"{name}.json")


def limits(workload: str, root: Path = ROOT) -> dict:
    return read_json(root / "port_bench" / "limits" / f"{workload}.json")


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str, root: Path = ROOT):
    return _module(root / "port_bench" / "drivers" / f"{name}.py", f"port_bench_driver_{name}")


def metric_reader(name: str, root: Path = ROOT):
    return _module(root / "port_bench" / "metrics" / f"{name}.py", f"port_bench_metric_{name}")


def applies(metric: dict, workload: str, reported=None) -> bool:
    """Whether a metric belongs to a cell: it lists the cell, or lists none
    and (a per-layer metric) the cell reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    return reported is None or metric["moves"] in reported


def forbidden_loaded() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def memory_peak(device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


# --------------------------------------------------------------------------- trace


# the traced window's range; the drivers add ranges named port_bench.* around
# their calls into the program
WINDOW = "port_bench.window"


def profile(fn, device, host_spans=()) -> dict:
    """Run ``fn`` under ``torch.profiler`` (CPU ops and, on a card, its
    kernels and copies) inside the range ``WINDOW``, and reduce the trace
    (``reduce_trace``). The window is the host's seconds from the range's
    opening to the synchronise after ``fn``. ``host_spans``, filled by
    ``fn`` with ``(name, start, end)`` on ``time.monotonic``, join the trace
    as ranges: the profiler records ops of the thread that starts it only,
    so the harness names what its other threads were doing itself."""
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    sync(device)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            t = time.monotonic()
            fn()
            sync(device)
            window = time.monotonic() - t
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        events = read_json(Path(path))["traceEvents"]
    ts0 = next((float(e["ts"]) for e in events if e.get("name") == WINDOW), None)
    if ts0 is not None:
        events += [{"ph": "X", "cat": "user_annotation", "name": name,
                    "ts": ts0 + (a - t) * 1e6, "dur": (b - a) * 1e6} for name, a, b in host_spans]
    return reduce_trace(events, window)


def _covering(ops, starts, t):
    """The innermost CPU op or range (latest start) whose span holds time ``t``."""
    i = bisect.bisect_right(starts, t)
    while i > 0:
        i -= 1
        if ops[i][1] >= t:
            return ops[i][2]
    return None


def reduce_trace(events: list, window_s: float) -> dict:
    """Device busy seconds (the union of kernels, copies and sets) inside
    the range ``WINDOW``, kernel seconds and launches by name, the ``TOP``
    device ops by time and the ``TOP`` longest idle gaps, each named by the
    innermost host op or range running at its middle (on any traced
    thread). A device record from before the window belongs to an
    earlier profiler session, and is left out."""
    cpu = [e for e in events if e.get("ph") == "X" and e.get("cat") in CPU_CATS]
    win = [e for e in cpu if e["name"] == WINDOW]
    if win:
        t0 = float(win[0]["ts"])
        t1 = t0 + float(win[0]["dur"])
    else:
        t0 = min((float(e["ts"]) for e in cpu), default=0.0)
        t1 = max((float(e["ts"]) + float(e["dur"]) for e in cpu), default=0.0)
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
           and float(e["ts"]) >= t0]
    by_name = {}
    spans = []
    for e in dev:
        s, d = float(e["ts"]), float(e["dur"])
        spans.append((s, s + d))
        row = by_name.setdefault(e["name"][:NAME_CHARS], [0.0, 0])
        row[0] += d * 1e-6
        row[1] += 1
    spans.sort()
    merged = []
    for s, e in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(e - s for s, e in merged) * 1e-6
    edges = [t0] + [x for m in merged for x in m] + [max(t1, merged[-1][1] if merged else t1)]
    gaps = [(b - a, a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    ops = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in cpu
                 if e["name"] != WINDOW)
    starts = [o[0] for o in ops]
    idle = [[(_covering(ops, starts, (a + b) / 2) or "no traced host op")[:NAME_CHARS], g * 1e-6]
            for g, a, b in sorted(gaps, reverse=True)[:TOP]]
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP]
    return {"busy_s": busy, "window_s": window_s, "kernels": by_name,
            "device_ops": [[n, v[0]] for n, v in top], "idle_gaps": idle}


def kernel_seconds(record: dict, substring: str):
    """Mean device seconds of a launch of the kernels whose name holds
    ``substring`` in the traced window, or None where none ran."""
    rows = [v for n, v in record.get("trace", {}).get("kernels", {}).items() if substring in n]
    n = sum(v[1] for v in rows)
    return sum(v[0] for v in rows) / n if n else None


def mean_phase(record: dict, phase: str):
    """Mean ms of a train-step phase over the traced window's steps."""
    ms = record.get("step_ms", {}).get(phase)
    return sum(ms) / len(ms) if ms else None


# --------------------------------------------------------------------------- compare


def leaf_gaps(prog: dict, ref: dict, names) -> list:
    """Each leaf's gap between two norms, ``|a - b|`` over the larger of the
    reference's norm of that leaf and of the median leaf."""
    names = list(names)
    vals = sorted(ref[k] for k in names)
    median = vals[len(vals) // 2]
    return sorted(abs(prog[k] - ref[k]) / max(ref[k], median) for k in names)


def moved_leaves(ref_grads: dict, share: float) -> list:
    """Leaves whose reference gradient is at least ``share`` of the median
    leaf's: the others are nought to rounding (a conv bias under an instance
    norm) and Adam moves them by round-off alone."""
    vals = sorted(ref_grads.values())
    median = vals[len(vals) // 2]
    return [k for k, v in ref_grads.items() if v >= share * median]


def train_numbers(prog: dict, ref: dict, share: float) -> dict:
    """What a train cell can compare: the loss gap (relative) of the worst
    step and of the first, and the worst and the median leaf's gap
    (``leaf_gaps``) of the first gradient and of the change after the
    steps, over the moved leaves."""
    loss = [abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])]
    grad = leaf_gaps(prog["grad_norms"], ref["grad_norms"], ref["grad_norms"])
    change = leaf_gaps(prog["change_norms"], ref["change_norms"],
                       moved_leaves(ref["grad_norms"], share))
    return {"loss_gap": max(loss), "loss1_gap": loss[0], "grad_gap": grad[-1],
            "grad_median_gap": grad[len(grad) // 2], "change_gap": change[-1],
            "change_median_gap": change[len(change) // 2]}


def checks(numbers: dict, lim: dict) -> dict:
    """``{name: {"value", "limit"}}`` for every number with a limit."""
    return {k: {"value": numbers[k], "limit": lim[k]} for k in lim}
