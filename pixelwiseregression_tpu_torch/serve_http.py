"""HTTP inference server (stdlib only) with dynamic batching
(counterpart of ``pixelwiseregression_tpu/serve_http.py``, whose wire
contract, batcher, handler and client it keeps).

Fronts either a live ``serve.Predictor`` (a checkpoint) or a frozen
``serve_artifact.ServingArtifact`` (a ``.pwrsrv`` from
``python -m pixelwiseregression_tpu_torch.tools.export_model``), on the card
(``--device cuda``, the default) or on the CPU (``--device cpu``): train ->
export -> serve.

Wire format: npz both ways (exact float round trip):

  POST /predict   body = npz{frames[N,H,W] float, coms[N,3],
                            optional cubes[N]}
                  reply = npz{uvd[N,J,3] f32, xyz[N,J,3] f32}
  GET  /healthz   reply = JSON {ok, dataset, batch_size, backend, ...}
  GET  /metrics   reply = JSON {requests, frames, errors, device_calls,
                               batch_fill, latency_ms: {p50, p90, p99}}

One consumer thread drives the device and coalesces concurrent requests
into one device batch (a fixed batch costs the same at any fill, so
``device_calls < requests`` in /metrics shows the batching working);
requests larger than the batch are chunked. A poly-batch artifact runs each
request at its own size and is not coalesced.

Run:  python -m pixelwiseregression_tpu_torch.serve_http --artifact nyu.pwrsrv --port 8000
  or  ... --ckpt Model/NYU_default_final.pt --dataset NYU [--quant int8_static]

``Client`` in this module is the matching python caller.
"""

from __future__ import annotations

import io
import json
import queue
import threading
import time
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

_MAX_BODY = 256 * 1024 * 1024  # 256 MB: ~870 raw 240x320 f64 frames


class _Batcher:
    """Single device-consumer thread that coalesces queued request chunks.

    Each submitted chunk is (frames, coms, cubes, Future). The consumer
    blocks for the first chunk, then greedily drains compatible chunks up
    to the device batch size (plus a short linger window so a burst
    arriving over a few ms still coalesces), runs ONE predict, and slices
    the results back onto the futures.
    """

    def __init__(self, predictor, batch_size, cube_default,
                 linger_s: float = 0.002):
        self.predictor = predictor
        self.batch_size = batch_size  # None = poly (no fixed cap)
        self.cube_default = cube_default
        self.linger_s = linger_s
        self.q: queue.Queue = queue.Queue()
        self.metrics_lock = threading.Lock()
        self.device_calls = 0
        self.frames_served = 0
        self._stop = False
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def submit(self, frames, coms, cubes) -> list:
        """Split a request into chunks; returns the futures to wait on."""
        cap = self.batch_size or len(frames)
        futs = []
        for i in range(0, len(frames), cap):
            f = Future()
            self.q.put((frames[i:i + cap], coms[i:i + cap],
                        None if cubes is None else cubes[i:i + cap], f))
            futs.append(f)
        return futs

    def stop(self):
        self._stop = True
        self.q.put(None)
        self.thread.join(timeout=10)

    def _run(self):
        while not self._stop:
            item = self.q.get()
            if item is None:
                continue
            group = [item]
            total = len(item[0])
            # Coalesce only for fixed-batch predictors: a padded batch costs
            # the same at any fill, so merging is pure throughput. A
            # poly-batch artifact runs each request at its own size.
            if self.batch_size is not None:
                deadline = time.monotonic() + self.linger_s
                while total < self.batch_size:
                    remaining = deadline - time.monotonic()
                    try:
                        nxt = self.q.get(timeout=max(remaining, 0))
                    except queue.Empty:
                        break
                    if nxt is None:
                        break
                    if (total + len(nxt[0]) > self.batch_size
                            or nxt[0].shape[1:] != item[0].shape[1:]):
                        # over capacity, or a different frame size (frames
                        # can't share a concatenated device batch) — runs
                        # in the next device call
                        self.q.put(nxt)
                        break
                    group.append(nxt)
                    total += len(nxt[0])
            try:
                self._process(group)
            except Exception as e:  # noqa: BLE001 — NEVER kill the consumer
                for g in group:
                    if not g[3].done():
                        g[3].set_exception(e)

    def _process(self, group):
        try:
            frames = np.concatenate([g[0] for g in group])
            coms = np.concatenate([g[1] for g in group])
            cubes = np.concatenate([
                g[2] if g[2] is not None
                else np.full(len(g[0]), self.cube_default)
                for g in group
            ])
            out = self.predictor.predict(frames, coms, cubes)
        except Exception as e:  # noqa: BLE001 — fail the futures, not the thread
            for g in group:
                g[3].set_exception(e)
            return
        with self.metrics_lock:
            self.device_calls += 1
            self.frames_served += len(frames)
        i = 0
        for g in group:
            n = len(g[0])
            g[3].set_result({"uvd": out["uvd"][i:i + n],
                             "xyz": out["xyz"][i:i + n]})
            i += n


class _Handler(BaseHTTPRequestHandler):
    # set by make_server
    batcher: _Batcher = None
    meta: dict = None
    stats: dict = None  # {"lock", "requests", "errors", "latencies"(deque)}

    def log_message(self, fmt, *a):  # route through the server hook, not stderr
        if self.server.access_log:
            super().log_message(fmt, *a)

    def _reply(self, code: int, body: bytes, ctype: str):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _reply_json(self, code: int, obj: dict):
        self._reply(code, json.dumps(obj).encode(), "application/json")

    def do_GET(self):
        if self.path == "/healthz":
            return self._reply_json(200, dict(self.meta, ok=True))
        if self.path == "/metrics":
            st, b = self.stats, self.batcher
            with st["lock"], b.metrics_lock:
                lat = sorted(st["latencies"])
                m = {
                    "requests": st["requests"],
                    "errors": st["errors"],
                    "frames": b.frames_served,
                    "device_calls": b.device_calls,
                    "batch_fill": (b.frames_served / b.device_calls
                                   if b.device_calls else 0.0),
                    "latency_ms": {
                        "p50": _pct(lat, 0.50), "p90": _pct(lat, 0.90),
                        "p99": _pct(lat, 0.99),
                    },
                }
            return self._reply_json(200, m)
        return self._reply_json(404, {"error": f"no route {self.path}"})

    def do_POST(self):
        if self.path != "/predict":
            return self._reply_json(404, {"error": f"no route {self.path}"})
        t0 = time.perf_counter()
        try:
            n = int(self.headers.get("Content-Length", 0))
            if not 0 < n <= _MAX_BODY:
                return self._reply_json(
                    413 if n else 400,
                    {"error": f"body size {n} outside (0, {_MAX_BODY}]"})
            data = np.load(io.BytesIO(self.rfile.read(n)))
            frames = data["frames"]
            coms = data["coms"]
            cubes = data["cubes"] if "cubes" in data else None
            if (frames.ndim != 3 or frames.shape[0] == 0
                    or coms.shape != (frames.shape[0], 3)):
                return self._reply_json(400, {
                    "error": f"want frames[N,H,W] (N>=1) + coms[N,3], got "
                             f"{frames.shape} / {coms.shape}"})
            want_hw = (self.meta.get("frame_h"), self.meta.get("frame_w"))
            if want_hw[0] is not None and frames.shape[1:] != want_hw:
                return self._reply_json(400, {
                    "error": f"frame size {frames.shape[1:]} != served "
                             f"{want_hw}"})
        except Exception as e:  # noqa: BLE001 — malformed body is a 400
            return self._reply_json(400, {"error": f"bad npz body: {e}"})
        try:
            futs = self.batcher.submit(frames, coms, cubes)
            outs = [f.result(timeout=600) for f in futs]
            buf = io.BytesIO()
            np.savez(buf,
                     uvd=np.concatenate([o["uvd"] for o in outs]).astype(np.float32),
                     xyz=np.concatenate([o["xyz"] for o in outs]).astype(np.float32))
            with self.stats["lock"]:
                self.stats["requests"] += 1
                self.stats["latencies"].append((time.perf_counter() - t0) * 1e3)
            self._reply(200, buf.getvalue(), "application/x-npz")
        except Exception as e:  # noqa: BLE001 — surface, don't kill the server
            with self.stats["lock"]:
                self.stats["errors"] += 1
            self._reply_json(500, {"error": f"{type(e).__name__}: {e}"})


def _pct(sorted_vals, q):
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, int(q * len(sorted_vals)))
    return round(sorted_vals[i], 3)


def make_server(predictor, meta: dict, host: str = "0.0.0.0", port: int = 8000,
                access_log: bool = True,
                linger_s: float = 0.002) -> ThreadingHTTPServer:
    """Build (don't start) the server; ``serve_forever()`` to run.

    ``meta`` must carry dataset/batch_size/cube_default (None batch_size =
    poly artifact). The returned server owns a ``batcher`` — call
    ``srv.batcher.stop()`` after ``shutdown()``."""
    from collections import deque

    batcher = _Batcher(predictor, meta["batch_size"], meta["cube_default"],
                       linger_s=linger_s)
    handler = type("BoundHandler", (_Handler,), {
        "batcher": batcher,
        "meta": dict(meta),
        "stats": {"lock": threading.Lock(), "requests": 0, "errors": 0,
                  "latencies": deque(maxlen=4096)},
    })
    srv = ThreadingHTTPServer((host, port), handler)
    srv.access_log = access_log
    srv.batcher = batcher
    return srv


class Client:
    """Matching python caller: Client(url).predict(frames, coms, cubes)."""

    def __init__(self, url: str, timeout: float = 600.0):
        self.url = url.rstrip("/")
        self.timeout = timeout

    def predict(self, frames, coms, cubes=None):
        import urllib.request

        buf = io.BytesIO()
        arrays = {"frames": np.asarray(frames), "coms": np.asarray(coms)}
        if cubes is not None:
            arrays["cubes"] = np.asarray(cubes)
        np.savez(buf, **arrays)
        req = urllib.request.Request(self.url + "/predict",
                                     data=buf.getvalue(), method="POST")
        with urllib.request.urlopen(req, timeout=self.timeout) as r:
            out = np.load(io.BytesIO(r.read()))
            return {"uvd": out["uvd"], "xyz": out["xyz"]}

    def _get_json(self, route: str):
        import urllib.request

        with urllib.request.urlopen(self.url + route,
                                    timeout=self.timeout) as r:
            return json.loads(r.read())

    def healthz(self):
        return self._get_json("/healthz")

    def metrics(self):
        return self._get_json("/metrics")


def main(argv=None):
    import argparse
    import signal

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--artifact", help=".pwrsrv from pixelwiseregression_tpu_torch.tools."
                                        "export_model")
    src.add_argument("--ckpt", help="live checkpoint (port or reference .pt, or JAX .ckpt)")
    p.add_argument("--dataset", choices=["MSRA", "ICVL", "NYU", "HAND17"],
                   help="required with --ckpt")
    p.add_argument("--batch_size", type=int, default=32,
                   help="device batch for --ckpt (artifacts carry their own)")
    p.add_argument("--quant", default="none",
                   help="--ckpt: int8[_static][_all|_heads]; a static mode calibrates on the "
                        "first --quant_calib_batches device batches it serves")
    p.add_argument("--quant_calib_batches", type=int, default=4)
    p.add_argument("--fullregression", action="store_true",
                   help="--ckpt is a FullRegression checkpoint")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="serve on the card (default) or on the CPU")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--linger_ms", type=float, default=2.0,
                   help="dynamic-batching linger window: how long the device "
                        "thread waits for more requests to coalesce")
    p.add_argument("--no_warmup", dest="warmup", action="store_false",
                   help="skip the start-up dummy predict (the first request then pays "
                        "cuDNN's and the kernels' first-call set-up)")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        p.error("--device cuda: no CUDA device is visible (pass --device cpu to serve on the CPU)")
    device = torch.device("cuda:0" if args.device == "cuda" else "cpu")

    if args.artifact:
        from pixelwiseregression_tpu_torch.serve_artifact import ServingArtifact

        pred = ServingArtifact.load(args.artifact, device)
        meta = {"dataset": pred.header["dataset"], "batch_size": pred.header["batch_size"],
                "frame_h": pred.header["frame_h"], "frame_w": pred.header["frame_w"],
                "cube_default": pred._spec.cube_size, "backend": f"artifact[{device}]"}
    else:
        if not args.dataset:
            p.error("--ckpt needs --dataset")
        from pixelwiseregression_tpu_torch.serve import Predictor

        pred = Predictor.from_checkpoint(
            args.ckpt, args.dataset, device, batch_size=args.batch_size,
            quant=None if args.quant == "none" else args.quant,
            quant_calib_batches=args.quant_calib_batches, fullregression=args.fullregression)
        meta = {"dataset": args.dataset, "batch_size": args.batch_size,
                "frame_h": pred.spec.frame_h, "frame_w": pred.spec.frame_w,
                "cube_default": pred.spec.cube_size, "backend": f"live/{device}"}

    if args.warmup and "static" not in args.quant:
        # the first batches of a static int8 predictor calibrate its scales:
        # an all-zero warm-up frame would poison them
        bs = meta["batch_size"] or 1
        pred.predict(np.zeros((bs, meta["frame_h"], meta["frame_w"])),
                     np.tile([[160.0, 120.0, 400.0]], (bs, 1)))
        print("warmup predict done", flush=True)

    srv = make_server(pred, meta, args.host, args.port, linger_s=args.linger_ms / 1e3)

    # graceful shutdown: finish in-flight device work, then exit 0
    def _term(signum, frame):
        print(f"signal {signum}: draining and shutting down", flush=True)
        threading.Thread(target=srv.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)

    print(f"serving {meta} on {args.host}:{srv.server_address[1]}", flush=True)
    srv.serve_forever()
    srv.server_close()
    srv.batcher.stop()
    print("shutdown complete", flush=True)


if __name__ == "__main__":
    main()
