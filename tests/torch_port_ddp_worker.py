"""One rank of the port's multi-process checks (tests/test_torch_port_parallel.py
spawns two; chip_smoke.py's phase_ddp spawns two on one card).

    python tests/torch_port_ddp_worker.py CASES OUT RANK WORLD PORT DEVICE [BACKEND]

Joins a process group at tcp://127.0.0.1:PORT, then for each case in the
``torch.save``d CASES file (``{"cases": [...], "seed": int}``; a case holds
``kind`` "pixelwise" or "fullreg", the model's keyword arguments and state
dict, the global raw batch and the augmentation's config) takes this rank's
slice of the global batch and runs one train step (the augmentation draws
from a generator seeded with ``seed``: the global batch's, sliced) and one
eval step on the state before the step, then ``timed_steps`` more train
steps (a case's optional count; each timed), and saves to OUT the metrics,
the state and gradients of the first step, the kernels' launches of the
first step, the step times and this rank's ``process_local_lines`` of 11
lines. Imports torch and the port only.

``spawn`` runs this worker on ``world`` ranks and gathers their results;
both its callers use it.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pixelwiseregression_tpu_torch.core.camera import Camera  # noqa: E402
from pixelwiseregression_tpu_torch.data.preprocess import PreprocessConfig  # noqa: E402
from pixelwiseregression_tpu_torch.models.fullregression import FullRegression  # noqa: E402
from pixelwiseregression_tpu_torch.models.pixelwise import PixelwiseRegression  # noqa: E402
from pixelwiseregression_tpu_torch.ops import cuda_softargmax as cs  # noqa: E402
from pixelwiseregression_tpu_torch.parallel import mesh  # noqa: E402
from pixelwiseregression_tpu_torch.train import loop  # noqa: E402


def run_case(case, device, seed, local=True):
    """One case's train and eval steps on this rank's slice (``local``) or on
    the whole batch; returns the metrics, the state after the step and the
    kernels' launches of the train step."""
    fullreg = case["kind"] == "fullreg"
    model_cls = FullRegression if fullreg else PixelwiseRegression

    def fresh():
        m = model_cls(**case["model"]).to(device)
        m.load_state_dict(case["state"])
        return m

    def part(t):
        t = torch.as_tensor(t).to(device)
        return mesh.local_slice(t) if local else t

    batch = {k: part(v) for k, v in case["batch"].items()}
    cfg = PreprocessConfig(**case["cfg"])
    cam = Camera(**case["camera"])
    if fullreg:
        train_step = loop.make_train_step_fullreg(cfg)
        eval_step = loop.make_eval_step_fullreg(PreprocessConfig(**case["eval_cfg"]), cam)
    else:
        loss_cfg = loop.LossConfig(**case["loss"])
        train_step = loop.make_train_step(cfg, loss_cfg, augment=True)
        eval_step = loop.make_eval_step(PreprocessConfig(**case["eval_cfg"]), loss_cfg, cam)

    evaluated = eval_step(loop.create_train_state(fresh()), batch)
    state = loop.create_train_state(fresh(), lr=1e-3, steps_per_epoch=100)
    gen = torch.Generator(device=device).manual_seed(seed)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    before = (cs.LAUNCHES, cs.BWD_LAUNCHES)
    t = time.perf_counter()
    metrics = train_step(state, batch, generator=gen)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t
    launches = {"K1": cs.LAUNCHES - before[0], "K2": cs.BWD_LAUNCHES - before[1]}
    grads = {n: p.grad.detach().cpu() for n, p in state.model.named_parameters()}
    after = {k: v.detach().cpu() for k, v in state.model.state_dict().items()}
    step_s = []
    for _ in range(case.get("timed_steps", 0)):  # the step's time, once warm
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t = time.perf_counter()
        train_step(state, batch, generator=gen)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        step_s.append(time.perf_counter() - t)
    cpu = lambda d: {k: v.detach().cpu() for k, v in d.items()}  # noqa: E731
    return {"train": cpu(metrics), "eval": cpu(evaluated), "state": after, "grads": grads,
            "launches": launches, "seconds": seconds, "step_s": step_s}


def free_port() -> int:
    """A free TCP port on 127.0.0.1 (bound once, then released)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(cases_path, work, world=2, device="cpu", backend=None, timeout=300, env=None):
    """Run this worker on ``world`` ranks over the ``torch.save``d cases at
    ``cases_path``, each writing ``work/rank{r}.pt``; returns each rank's
    results. Every rank has its own timeout; a rank that fails raises (and
    the others are killed)."""
    port = free_port()
    cmd = [sys.executable, os.path.abspath(__file__), str(cases_path)]
    procs = [subprocess.Popen(cmd + [os.path.join(work, f"rank{r}.pt"), str(r), str(world),
                                     str(port), device] + ([backend] if backend else []),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
             for r in range(world)]
    try:
        for r, p in enumerate(procs):
            _, err = p.communicate(timeout=timeout)
            if p.returncode != 0:
                raise RuntimeError(f"rank {r} failed (exit {p.returncode}): {err[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def main(argv):
    cases_path, out, rank, world, port, device = argv[:6]
    backend = argv[6] if len(argv) > 6 else None
    data = torch.load(cases_path, weights_only=False)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = mesh.init(device, int(rank), int(world), f"tcp://127.0.0.1:{port}", backend,
                    timeout_s=300)
    try:
        results = [run_case(case, dev, data["seed"]) for case in data["cases"]]
        torch.save({"results": results, "lines": mesh.process_local_lines(list(range(11))),
                    "backend": torch.distributed.get_backend()}, out)
    finally:
        mesh.shutdown()


if __name__ == "__main__":
    main(sys.argv[1:])
