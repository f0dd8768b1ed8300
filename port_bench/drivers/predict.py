"""Driver ``predict``: clients in closed loops calling one shared
``Predictor.predict`` with requests of raw depth frames, as a service
taking several camera streams.

Set-up builds the ``Predictor`` from the seed's weights
(``Predictor.from_state_dict`` with the configuration's serving norm,
float32, the K1 decoder) and the mix's ``pool`` of distinct requests of
``batch`` frames each. Each of ``clients`` threads, started once, sends
``warm_requests`` requests, then all wait for the window to open. In the
window each client sends its next request (the pool in turn, from its own
offset) as soon as the last one returned, until ``--seconds`` have passed.

``serve_frames_per_s`` is every frame answered over the seconds from the
window's opening to its last answer; ``serve_p95_ms`` the 95th percentile
of every request's latency, from the call of ``predict`` to its return. A
traced run profiles ``trace_seconds`` more of the same load.

``correct`` holds every answer the clients got, in and out of the window,
against the reference's answer to the same request: the widest gap of
the joints' uvd (pixels and depth mm) and of their world xyz (mm).
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from port_bench import arith, harness, synth
from port_bench.reference import model as ref_model
from port_bench.reference import steps as ref_steps

WAIT_S = 600


class Clients:
    """``n`` threads that run phases of requests on one predictor: a phase
    opens for all at once and closes when each has returned."""

    def __init__(self, n: int, predict, requests):
        self.predict, self.requests = predict, requests
        self.start = threading.Barrier(n + 1)
        self.done = threading.Barrier(n + 1)
        self.phase = None
        self.out = [[] for _ in range(n)]
        self.errors = [[] for _ in range(n)]
        self.threads = [threading.Thread(target=self._loop, args=(c,), daemon=True)
                        for c in range(n)]
        for t in self.threads:
            t.start()

    def _loop(self, c: int):
        k = 2 * c
        while True:
            self.start.wait(WAIT_S)
            phase = self.phase
            if phase is None:
                return
            try:
                kind, value = phase
                while (kind == "count" and value > 0) or (kind == "until"
                                                          and time.monotonic() < value):
                    r = k % len(self.requests)
                    frames, coms = self.requests[r]
                    t = time.monotonic()
                    with torch.profiler.record_function("port_bench.predict"):
                        ans = self.predict(frames, coms)
                    self.out[c].append((r, t, time.monotonic(), ans["uvd"], ans["xyz"]))
                    k += 1
                    value -= kind == "count"
            except Exception as e:  # noqa: BLE001 -- a failed request is counted; the run goes on
                self.errors[c].append(f"{type(e).__name__}: {e}")
            self.done.wait(WAIT_S)

    def run(self, phase) -> list:
        """Run one phase; returns its requests ``(request, start, end, uvd,
        xyz)`` and the phase's opening time."""
        self.phase = phase
        for o in self.out:
            o.clear()
        t_open = time.monotonic()
        self.start.wait(WAIT_S)
        self.done.wait(WAIT_S)
        return [r for o in self.out for r in o], t_open

    def close(self):
        self.phase = None
        self.start.wait(WAIT_S)
        for t in self.threads:
            t.join(WAIT_S)
        if any(t.is_alive() for t in self.threads):
            raise RuntimeError("a client did not stop")


def build(cfg: dict, mix: dict, seed: int, device):
    from pixelwiseregression_tpu_torch.serve import Predictor
    m = cfg["model"]
    norm = cfg["norm"]["serve"]
    if cfg["dtype"] != "f32" or cfg["tf32"]:
        raise ValueError("the reference runs float32 with TF32 off")
    with torch.device(device):
        weights = synth.weights(ref_model.build(cfg, norm), seed, device)
    full = m["class"] == "FullRegression"
    kw = {} if full else {"heatmap_method": m["heatmap_method"], "filter_size": m["filter_size"],
                          "decoder": m["decoder"]}
    pred = Predictor.from_state_dict(weights, cfg["dataset"]["name"], device,
                                     batch_size=mix["batch"], stages=m["stages"],
                                     features=m["features"], level=m["level"],
                                     label_size=m["label_size"], norm_method=norm,
                                     dtype=torch.float32, fullregression=full, **kw)
    requests = [(b["frame"], b["com"]) for b in synth.pool(cfg, mix, seed, device)]
    return pred, weights, requests


def expected_k1(cfg, device) -> int:
    m = cfg["model"]
    return m["stages"] if (device.type == "cuda" and m["class"] == "PixelwiseRegression"
                           and m["decoder"] == "cuda") else 0


def reference(cfg, mix, weights, requests, device, tf32=False) -> list:
    pp = {**cfg["preprocess"], **cfg["dataset"]["camera"]}
    return [ref_steps.serve({**cfg, "preprocess": pp}, weights, f, c, device,
                            mix["reference_rows"], tf32) for f, c in requests]


def gaps(answers, ref) -> dict:
    """Widest uvd and xyz gaps of ``answers`` ``(request, ..., uvd, xyz)``."""
    uvd = max((float(np.max(np.abs(a[3] - ref[a[0]]["uvd"]))) for a in answers),
              default=float("inf"))
    xyz = max((float(np.max(np.abs(a[4] - ref[a[0]]["xyz"]))) for a in answers),
              default=float("inf"))
    return {"uvd_gap": uvd, "xyz_gap": xyz}


def window(clients: Clients, seconds: float):
    """One timed phase: its requests, opening time and end (last answer)."""
    t = time.monotonic()
    answers, t_open = clients.run(("until", t + seconds))
    return answers, t_open, max((a[2] for a in answers), default=time.monotonic())


def run(ctx) -> dict:
    from pixelwiseregression_tpu_torch.ops import cuda_softargmax as cs
    cfg, mix, device = ctx.cfg, ctx.mix, ctx.device
    pred, weights, requests = build(cfg, mix, ctx.seed, device)
    before = cs.LAUNCHES
    first = pred.predict(*requests[0])
    if cs.LAUNCHES - before != expected_k1(cfg, device):
        raise RuntimeError(f"a request launched K1 {cs.LAUNCHES - before} times, expected "
                           f"{expected_k1(cfg, device)}")
    clients = Clients(mix["clients"], pred.predict, requests)
    try:
        warm, _ = clients.run(("count", mix["warm_requests"]))
        answers, t_open, t_close = window(clients, ctx.seconds)
        frames = sum(a[3].shape[0] for a in answers)
        lat_ms = np.array([(a[2] - a[1]) * 1e3 for a in answers])
        record = {"frames_per_s": frames / (t_close - t_open),
                  "flop_per_frame": arith.forward_flops(cfg),
                  "peak_flops": arith.PEAK_FLOPS[cfg["dtype"]]}
        e2e = {"serve_frames_per_s": record["frames_per_s"],
               "serve_p95_ms": float(np.percentile(lat_ms, 95)) if len(lat_ms) else float("inf")}
        traced, spans = [], []
        if ctx.trace:
            def phase():
                traced.extend(window(clients, mix["trace_seconds"])[0])
                spans.extend(("port_bench.predict", a[1], a[2]) for a in traced)
            record["trace"] = harness.profile(phase, device, spans)
            record["requests_traced"] = len(traced)
            m = cfg["model"]
            record["decoder"] = {"k1": dict(b=mix["batch"], j=m["joints"], hw=m["label_size"] ** 2,
                                            in_dtype="f32", hm_dtype="f32")}
    finally:
        clients.close()
    errors = [e for es in clients.errors for e in es]
    out = {"window_open": t_open, "attempted": len(answers) + len(errors),
           "failed": len(errors), "errors": errors[:3], "e2e": e2e, "record": record,
           "memory_peak_bytes": harness.memory_peak(device), "latency_ms_median":
           float(np.median(lat_ms)) if len(lat_ms) else None}
    del pred, clients
    harness.free(device)
    ref = reference(cfg, mix, weights, requests, device)
    every = [(0, 0, 0, first["uvd"], first["xyz"])] + warm + answers + traced
    out["numbers"] = gaps(every, ref)
    return out
