"""Driver ``predict_bb``: clients in closed loops calling one shared
``Predictor.predict`` with requests of raw depth frames that come with a
hand detector's box per frame and no hand centre, as HANDS 2017's
frame-based test track hands them out (``BoundingBox.txt``).

As the driver ``predict`` (its predictor, weights, clients, windows and
end-to-end metrics), with the requests of ``port_bench/scene.py`` sent as
``predict(frames, boxes=...)``: the program finds each hand in its box on
the device. The first request runs in the main thread before any client
starts, so a program that takes no boxes fails at once, and so does one
without ``ops/localize.py``. The program's
counter ``ops.localize.LOCALIZED`` must rise by exactly the frames
answered, so that a run localising on the host fails.

``correct`` holds every answer against the reference's: the box step in
float64 NumPy (``reference/localize.py``), then the reference's crop
integers (the whole frame as the background bbox), test-time preprocess
and model on the cleaned frames. ``uvd_gap`` and ``xyz_gap`` as in
``predict``; ``com_gap`` the widest gap of the centre the program returned
(u and v in pixels, d in mm).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from port_bench import arith, harness, scene
from port_bench.drivers import predict as base
from port_bench.reference import localize as ref_localize
from port_bench.reference import steps as ref_steps


class Clients(base.Clients):
    """``predict``'s clients, sending boxes; an answer also keeps the
    centre the program used: ``(request, start, end, uvd, xyz, com)``."""

    def _loop(self, c: int):
        k = 2 * c
        while True:
            self.start.wait(base.WAIT_S)
            phase = self.phase
            if phase is None:
                return
            try:
                kind, value = phase
                while (kind == "count" and value > 0) or (kind == "until"
                                                          and time.monotonic() < value):
                    r = k % len(self.requests)
                    frames, boxes = self.requests[r]
                    t = time.monotonic()
                    with torch.profiler.record_function("port_bench.predict"):
                        ans = self.predict(frames, boxes=boxes)
                    self.out[c].append((r, t, time.monotonic(), ans["uvd"], ans["xyz"],
                                        ans["com"]))
                    k += 1
                    value -= kind == "count"
            except Exception as e:  # noqa: BLE001 -- a failed request is counted; the run goes on
                self.errors[c].append(f"{type(e).__name__}: {e}")
            self.done.wait(base.WAIT_S)


def build(cfg: dict, mix: dict, seed: int, device):
    # the base driver's predictor and weights, with none of its requests
    pred, weights, _ = base.build(cfg, {**mix, "pool": 0}, seed, device)
    requests = [(s["frame"], s["box"]) for s in scene.pool(cfg, mix, seed, device)]
    return pred, weights, requests


def reference(cfg, mix, weights, requests, device, tf32=False, fault=None) -> list:
    """The reference's answer to each request, with its centres (``com``)."""
    ds = cfg["dataset"]
    whole = {**cfg, "preprocess": {**cfg["preprocess"], **ds["camera"]},
             "dataset": {**ds, "bbox_margin": None}}
    out = []
    for frames, boxes in requests:
        seen, coms = zip(*(ref_localize.localize(f, b, fault) for f, b in zip(frames, boxes)))
        coms = np.stack(coms)
        ans = ref_steps.serve(whole, weights, np.stack(seen).astype(np.float32), coms, device,
                              mix["reference_rows"], tf32)
        out.append({**ans, "com": coms})
    return out


def gaps(answers, ref) -> dict:
    """``predict``'s gaps, and ``com_gap``."""
    out = base.gaps(answers, ref)
    out["com_gap"] = max(float(np.max(np.abs(a[5] - ref[a[0]]["com"]))) for a in answers)
    return out


def run(ctx) -> dict:
    cfg, mix, device = ctx.cfg, ctx.mix, ctx.device
    pred, weights, requests = build(cfg, mix, ctx.seed, device)
    from pixelwiseregression_tpu_torch.ops import cuda_softargmax as cs
    from pixelwiseregression_tpu_torch.ops import localize
    k1_before, localized = cs.LAUNCHES, localize.LOCALIZED
    first = pred.predict(requests[0][0], boxes=requests[0][1])
    if cs.LAUNCHES - k1_before != base.expected_k1(cfg, device):
        raise RuntimeError(f"a request launched K1 {cs.LAUNCHES - k1_before} times, expected "
                           f"{base.expected_k1(cfg, device)}")
    clients = Clients(mix["clients"], pred.predict, requests)
    try:
        warm, _ = clients.run(("count", mix["warm_requests"]))
        answers, t_open, t_close = base.window(clients, ctx.seconds)
        frames_done = sum(a[3].shape[0] for a in answers)
        lat_ms = np.array([(a[2] - a[1]) * 1e3 for a in answers])
        record = {"frames_per_s": frames_done / (t_close - t_open),
                  "flop_per_frame": arith.forward_flops(cfg),
                  "peak_flops": arith.PEAK_FLOPS[cfg["dtype"]]}
        e2e = {"serve_frames_per_s": record["frames_per_s"],
               "serve_p95_ms": float(np.percentile(lat_ms, 95)) if len(lat_ms) else float("inf")}
        traced, spans = [], []
        if ctx.trace:
            def phase():
                traced.extend(base.window(clients, mix["trace_seconds"])[0])
                spans.extend(("port_bench.predict", a[1], a[2]) for a in traced)
            record["trace"] = harness.profile(phase, device, spans)
            record["requests_traced"] = len(traced)
            m = cfg["model"]
            record["decoder"] = {"k1": dict(b=mix["batch"], j=m["joints"], hw=m["label_size"] ** 2,
                                            in_dtype="f32", hm_dtype="f32")}
    finally:
        clients.close()
    errors = [e for es in clients.errors for e in es]
    every = [(0, 0, 0, first["uvd"], first["xyz"], first["com"])] + warm + answers + traced
    sent = sum(a[3].shape[0] for a in every)
    if not errors and localize.LOCALIZED - localized != sent:
        raise RuntimeError(f"{localize.LOCALIZED - localized} frames localised on the device, "
                           f"{sent} answered")
    out = {"window_open": t_open, "attempted": len(answers) + len(errors),
           "failed": len(errors), "errors": errors[:3], "e2e": e2e, "record": record,
           "memory_peak_bytes": harness.memory_peak(device), "latency_ms_median":
           float(np.median(lat_ms)) if len(lat_ms) else None}
    del pred, clients
    harness.free(device)
    out["numbers"] = gaps(every, reference(cfg, mix, weights, requests, device))
    return out
