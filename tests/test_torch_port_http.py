"""The port's HTTP serving layer (``serve_http.py``): the wire contract over
the port's live ``Predictor`` and its frozen artifact (an in-thread server
on localhost, port 0, real sockets, npz both ways), the batcher's failure
modes, and the export and serve entry points on the CPU
(counterparts of ``tests/test_serve_http.py``)."""

import io
import json
import os
import signal
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from pixelwiseregression_tpu_torch.models.pixelwise import PixelwiseRegression
from pixelwiseregression_tpu_torch.serve import Predictor
from pixelwiseregression_tpu_torch.serve_artifact import ServingArtifact
from pixelwiseregression_tpu_torch.serve_http import Client, _Batcher, make_server
from pixelwiseregression_tpu_torch.tools import export_model
from pixelwiseregression_tpu_torch.train.checkpoint import save_checkpoint
from pixelwiseregression_tpu_torch import serve_http

import torch_port_threads
from torch_port_threads import one_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = dict(stages=1, features=16, level=1, label_size=32)


def _blob_frame(cu, cv, z, h=240, w=320):
    frame = np.zeros((h, w), np.float64)
    yy, xx = np.mgrid[0:h, 0:w]
    r2 = ((xx - cu) / 40.0) ** 2 + ((yy - cv) / 40.0) ** 2
    frame[r2 < 1] = z + 30 * (r2[r2 < 1] - 0.5)
    return frame


@pytest.fixture(scope="module")
def state():
    torch.manual_seed(0)
    return PixelwiseRegression(21, stage=1, features=16, level=1).state_dict()


def _small_predictor(state, batch_size=2):
    return Predictor.from_state_dict(state, "MSRA", "cpu", batch_size=batch_size, **ARCH)


def _post_npz(port, **arrays):
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    req = urllib.request.Request(f"http://127.0.0.1:{port}/predict", data=buf.getvalue(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return np.load(io.BytesIO(r.read()))


def _serve(pred, meta, linger_s=0.002):
    meta = dict(meta)
    meta.setdefault("cube_default", 125.0)  # MSRA spec cube
    meta.setdefault("frame_h", 240)  # MSRA raw frame size (as main() sets)
    meta.setdefault("frame_w", 320)
    srv = make_server(pred, meta, host="127.0.0.1", port=0, access_log=False, linger_s=linger_s)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return srv, srv.server_address[1]


def _http_error(fn):
    with pytest.raises(urllib.error.HTTPError) as e:
        fn()
    return e.value.code, json.loads(e.value.read())


def test_http_predict_matches_direct_and_chunks(state):
    pred = _small_predictor(state, batch_size=2)
    srv, port = _serve(pred, {"dataset": "MSRA", "batch_size": 2, "backend": "live/cpu"})
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=30) as r:
            h = json.loads(r.read())
        assert h["ok"] and h["dataset"] == "MSRA" and h["batch_size"] == 2

        # 3 frames > batch_size 2: the server chunks; each chunk equals a
        # direct predict of it
        frames = np.stack([_blob_frame(160, 120, 400), _blob_frame(170, 110, 420),
                           _blob_frame(150, 130, 380)])
        coms = np.array([[160.0, 120.0, 400.0], [170.0, 110.0, 420.0], [150.0, 130.0, 380.0]])
        out = _post_npz(port, frames=frames, coms=coms)
        assert out["uvd"].shape == (3, 21, 3) and out["xyz"].shape == (3, 21, 3)
        direct = np.concatenate([pred.predict(frames[:2], coms[:2])["uvd"],
                                 pred.predict(frames[2:], coms[2:])["uvd"]])
        np.testing.assert_array_equal(out["uvd"], direct)

        req = urllib.request.Request(f"http://127.0.0.1:{port}/predict", data=b"not npz",
                                     method="POST")
        code, body = _http_error(lambda: urllib.request.urlopen(req, timeout=30))
        assert code == 400 and "bad npz body" in body["error"]
        assert _http_error(lambda: _post_npz(port, frames=frames[0], coms=coms))[0] == 400
        assert _http_error(lambda: _post_npz(port, frames=np.zeros((0, 240, 320)),
                                             coms=np.zeros((0, 3))))[0] == 400
        code, body = _http_error(lambda: _post_npz(port, frames=np.zeros((1, 64, 64)),
                                                   coms=np.array([[32.0, 32.0, 400.0]])))
        assert code == 400 and "frame size" in body["error"]
        assert _http_error(lambda: urllib.request.urlopen(f"http://127.0.0.1:{port}/nope",
                                                          timeout=30))[0] == 404
        out2 = _post_npz(port, frames=frames[:1], coms=coms[:1])
        np.testing.assert_array_equal(out2["uvd"][0], pred.predict(frames[:1], coms[:1])["uvd"][0])
    finally:
        srv.shutdown()
        srv.server_close()
        srv.batcher.stop()


def test_batcher_survives_poison_batches():
    """Chunks of different frame sizes never share a device batch, and a
    predictor exception fails that group's futures only: later submissions
    still serve."""
    calls = []

    class Stub:
        def predict(self, frames, coms, cubes):
            assert len({f.shape for f in frames}) == 1
            calls.append(frames.shape)
            if frames.shape[1] == 13:  # the poison size
                raise RuntimeError("boom")
            n = len(frames)
            return {"uvd": np.zeros((n, 21, 3)), "xyz": np.zeros((n, 21, 3))}

    b = _Batcher(Stub(), batch_size=4, cube_default=125.0, linger_s=0.2)
    try:
        f_a = b.submit(np.zeros((1, 10, 10)), np.zeros((1, 3)), None)
        f_b = b.submit(np.zeros((1, 12, 12)), np.zeros((1, 3)), None)
        assert f_a[0].result(timeout=30)["uvd"].shape == (1, 21, 3)
        assert f_b[0].result(timeout=30)["uvd"].shape == (1, 21, 3)
        assert len(calls) == 2, f"mixed-size chunks shared a batch: {calls}"
        f_bad = b.submit(np.zeros((2, 13, 13)), np.zeros((2, 3)), None)
        with pytest.raises(RuntimeError, match="boom"):
            f_bad[0].result(timeout=30)
        f_ok = b.submit(np.zeros((1, 10, 10)), np.zeros((1, 3)), None)
        assert f_ok[0].result(timeout=30)["uvd"].shape == (1, 21, 3)
        assert b.thread.is_alive()
    finally:
        b.stop()
    assert not b.thread.is_alive()


def test_http_dynamic_batching_coalesces(state):
    """Concurrent size-1 requests coalesce into shared device calls
    (device_calls < requests in /metrics) and every caller gets its own
    rows: equal to a direct predict of the same four frames."""
    pred = _small_predictor(state, batch_size=4)
    srv, port = _serve(pred, {"dataset": "MSRA", "batch_size": 4, "backend": "live/cpu"},
                       linger_s=0.25)
    try:
        client = Client(f"http://127.0.0.1:{port}")
        coms = np.array([[150.0 + 5 * i, 110.0 + 3 * i, 380.0 + 10 * i] for i in range(8)])
        frames = [_blob_frame(*c) for c in coms]
        direct = pred.predict(np.stack(frames[:4]), coms[:4])
        results = [None] * 8

        def post(i):
            results[i] = client.predict(frames[i][None], coms[i:i + 1])

        threads = [threading.Thread(target=post, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
        for i in range(4):
            np.testing.assert_allclose(results[i]["uvd"][0], direct["uvd"][i], rtol=0, atol=1e-4)
        m = client.metrics()
        assert m["requests"] == 8 and m["frames"] == 8
        assert m["device_calls"] < 8, f"no coalescing happened: {m}"
        assert m["batch_fill"] > 1.0 and m["latency_ms"]["p50"] > 0
        h = client.healthz()
        assert h["ok"] and h["batch_size"] == 4
    finally:
        srv.shutdown()
        srv.server_close()
        srv.batcher.stop()


def test_entry_points_need_a_card_unless_cpu_is_asked(monkeypatch, tmp_path):
    """``export_model`` and ``serve_http`` default to ``--device cuda`` and
    exit non-zero with no card visible; ``serve_http --fullregression
    --device cpu`` goes on to load the checkpoint (a missing one raises
    there; tests/test_torch_port_fullreg.py serves a real one)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        export_model.main(["--ckpt", "x.pt", "--dataset", "MSRA", "--output",
                           str(tmp_path / "x.pwrsrv")])
    assert e.value.code != 0
    with pytest.raises(SystemExit) as e:
        serve_http.main(["--artifact", "x.pwrsrv"])
    assert e.value.code != 0
    with pytest.raises(FileNotFoundError):
        serve_http.main(["--ckpt", str(tmp_path / "x.pt"), "--dataset", "MSRA",
                         "--fullregression", "--device", "cpu"])


def test_export_then_serve_on_the_cpu(state, tmp_path):
    """The deployment chain as a user runs it on the CPU, and the HTTP server
    over a frozen artifact (JAX ``test_http_serves_frozen_artifact``): a
    port ``.pt`` -> ``python -m ...tools.export_model --device cpu --quant
    int8_static`` (calibrated on an npz of frames) -> ``python -m
    ...serve_http --artifact --device cpu --port 0`` -> ``Client``: replies
    equal the artifact's own predict; SIGTERM drains and exits 0."""
    model = PixelwiseRegression(21, stage=1, features=16, level=1)
    model.load_state_dict(state)
    ckpt = str(tmp_path / "MSRA_x_final.pt")
    save_checkpoint(ckpt, model, model_param={"stage": 1, "features": 16, "level": 1,
                                              "label_size": 32, "norm_method": "instance"})
    coms = np.array([[160.0, 120.0, 400.0], [170.0, 110.0, 420.0]])
    frames = np.stack([_blob_frame(*c) for c in coms])
    np.savez(tmp_path / "calib.npz", frames=frames, coms=coms)
    env = torch_port_threads.env(PYTHONPATH=REPO)
    path = str(tmp_path / "q.pwrsrv")
    r = subprocess.run(
        [sys.executable, "-m", "pixelwiseregression_tpu_torch.tools.export_model", "--ckpt",
         ckpt, "--dataset", "MSRA", "--output", path, "--batch_size", "2", "--device", "cpu",
         "--quant", "int8_static", "--calib_npz", str(tmp_path / "calib.npz")],
        capture_output=True, text=True, timeout=300, env=env, cwd=tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "format=torch.export" in r.stdout
    want = ServingArtifact.load(path).predict(frames, coms)["uvd"]
    assert np.isfinite(want).all()

    proc = subprocess.Popen(
        [sys.executable, "-m", "pixelwiseregression_tpu_torch.serve_http", "--artifact",
         path, "--device", "cpu", "--host", "127.0.0.1", "--port", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=tmp_path)
    try:
        line = ""
        while "serving" not in line:
            line = proc.stdout.readline()
            assert line, proc.stderr.read()[-3000:]
        port = int(line.rsplit(":", 1)[1])
        client = Client(f"http://127.0.0.1:{port}")
        assert client.healthz()["backend"] == "artifact[cpu]"
        np.testing.assert_array_equal(client.predict(frames, coms)["uvd"], want)
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
        assert proc.returncode == 0 and "shutdown complete" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
