"""Client-side load generator for the port's HTTP server (the port of the
JAX package's ``tools/bench_http.py``).

Drives a running ``serve_http`` with concurrent synthetic requests through
the port's ``serve_http.Client`` and reports the throughput and latency
percentiles the clients saw, and the server's own ``/metrics``
(device_calls, batch_fill): batching works when batch_fill is well above
the request size. Host code: the server's ``--device`` decides where the
model runs, so this tool takes no ``--device`` of its own.

    python -m pixelwiseregression_tpu_torch.serve_http --artifact m.pwrsrv &
    python -m pixelwiseregression_tpu_torch.tools.bench_http --url http://127.0.0.1:8000 \\
        --threads 16 --requests 32 --size 1
"""

from __future__ import annotations

import argparse
import statistics
import threading
import time

import numpy as np

from pixelwiseregression_tpu_torch.serve_http import Client


def _blob(h, w, cu, cv, z):
    yy, xx = np.mgrid[0:h, 0:w]
    fr = np.zeros((h, w))
    r2 = ((xx - cu) / 40.0) ** 2 + ((yy - cv) / 40.0) ** 2
    fr[r2 < 1] = z + 30 * (r2[r2 < 1] - 0.5)
    return fr


def run(url: str, threads: int = 16, requests: int = 32, size: int = 1) -> dict:
    """``threads`` clients of ``requests`` requests of ``size`` synthetic
    frames each, after one warm request; returns ``target`` (the server's
    /healthz), ``requests`` and ``errors``, ``wall_s``, ``frames_per_s``,
    the client latencies ``latency_ms`` (p50, p90, p99, mean), the
    server's ``device_calls`` and ``batch_fill`` over the window, and the
    ``first_error``."""
    client = Client(url)
    health = client.healthz()
    fh, fw = health["frame_h"], health["frame_w"]
    frames = np.stack([_blob(fh, fw, fw / 2 + i, fh / 2, 400 + i) for i in range(size)])
    coms = np.array([[fw / 2.0 + i, fh / 2.0, 400.0 + i] for i in range(size)])

    client.predict(frames, coms)  # warm the path outside the timed window
    m0 = client.metrics()
    lat, errors = [], []
    lock = threading.Lock()

    def worker():
        c = Client(url)
        for _ in range(requests):
            t0 = time.perf_counter()
            try:
                c.predict(frames, coms)
            except Exception as e:  # noqa: BLE001 -- counted and reported; the load goes on
                with lock:
                    errors.append(f"{type(e).__name__}: {e}")
                continue
            with lock:
                lat.append((time.perf_counter() - t0) * 1e3)

    pool = [threading.Thread(target=worker) for _ in range(threads)]
    t0 = time.perf_counter()
    for t in pool:
        t.start()
    for t in pool:
        t.join(timeout=3600)
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in pool):
        raise RuntimeError("a client thread did not finish within an hour")
    m1 = client.metrics()

    lat.sort()
    n_req = threads * requests - len(errors)
    calls = m1["device_calls"] - m0["device_calls"]
    served = m1["frames"] - m0["frames"]

    def pct(q):
        return lat[min(len(lat) - 1, int(q * len(lat)))] if lat else 0.0

    return {"target": health, "requests": n_req, "errors": len(errors), "wall_s": wall,
            "frames_per_s": n_req * size / wall,
            "latency_ms": {"p50": pct(0.5), "p90": pct(0.9), "p99": pct(0.99),
                           "mean": statistics.mean(lat) if lat else 0.0},
            "device_calls": calls, "batch_fill": served / calls if calls else 0.0,
            "first_error": errors[0] if errors else None}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--url", default="http://127.0.0.1:8000")
    ap.add_argument("--threads", type=int, default=16)
    ap.add_argument("--requests", type=int, default=32, help="requests per thread")
    ap.add_argument("--size", type=int, default=1, help="frames per request")
    args = ap.parse_args(argv)
    out = run(args.url, args.threads, args.requests, args.size)
    lat = out["latency_ms"]
    print(f"target: {out['target']}")
    print(f"requests {out['requests']} ({out['errors']} errors)  wall {out['wall_s']:.2f} s  "
          f"throughput {out['frames_per_s']:.1f} frames/s")
    print(f"latency ms: p50 {lat['p50']:.1f}  p90 {lat['p90']:.1f}  p99 {lat['p99']:.1f}  "
          f"mean {lat['mean']:.1f}" if out["requests"] else "no successful requests")
    print(f"server: device_calls {out['device_calls']}  batch_fill {out['batch_fill']:.2f} "
          f"frames/call")
    if out["first_error"]:
        print(f"first error: {out['first_error']}")
    return out


if __name__ == "__main__":
    main()
