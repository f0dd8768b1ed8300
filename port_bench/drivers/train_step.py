"""Driver ``train_step``: the port's train step on raw frames, as the train
CLI runs it, one state stepped through the window.

Set-up builds the model from the seed's weights, its AdamW state
(``create_train_state``: TF32 off) and the step (``make_train_step`` with
the configuration's preprocess and loss, or ``make_train_step_fullreg``),
makes the pool of raw batches in host memory and the augmentation draws on
the card, then takes the first ``setup_steps`` steps through the window's
own call: the step launches every kernel of its shapes there, and the
reference follows those steps. Each step sends its batch through the
port's ``data.loader.to_device`` (pinned memory, non-blocking copies), as
the CLI does, and passes its draws.

The window steps until ``--seconds`` have passed, then synchronises;
``train_frames_per_s`` is every frame of every step over those seconds. A
traced run also records the step's five CUDA events in every step of the
window (preprocess, forward + loss, backward, optimizer), then profiles
``trace_steps`` more steps.

``correct`` compares the set-up steps with the reference's from the same
weights, batches and draws: each step's loss, each leaf's norm of the
first gradient as AdamW holds it after one step (``exp_avg / (1 -
beta1)``), and each moved leaf's norm of its change after the last set-up
step.
"""

from __future__ import annotations

import time

import torch

from port_bench import arith, harness, synth
from port_bench.reference import model as ref_model
from port_bench.reference import steps as ref_steps

PHASES = ("preprocess", "forward", "backward", "optimizer")
# a leaf whose reference gradient is under this share of the median leaf's
# is nought to rounding, and is not compared by its change
MOVED_SHARE = 1e-3


def _check_config(cfg):
    pp = cfg["preprocess"]
    if pp["augment"] and (pp["using_flip"] or not pp["strict_quirks"]
                          or pp["aug_fallback"] != "clean"):
        raise ValueError("the reference follows the strict-quirk path without flips and "
                         "with the clean fallback only")
    if cfg["dtype"] != "f32" or cfg["tf32"]:
        raise ValueError("the reference runs float32 with TF32 off")


def build(cfg: dict, mix: dict, seed: int, device):
    """The program's state and step, the seed's weights (kept for the
    reference) and the traffic."""
    from pixelwiseregression_tpu_torch.data.preprocess import PreprocessConfig
    from pixelwiseregression_tpu_torch.models.fullregression import FullRegression
    from pixelwiseregression_tpu_torch.models.pixelwise import PixelwiseRegression
    from pixelwiseregression_tpu_torch.train.loop import (LossConfig, create_train_state,
                                                          make_train_step, make_train_step_fullreg)
    _check_config(cfg)
    m, pp, norm = cfg["model"], cfg["preprocess"], cfg["norm"]["train"]
    with torch.device(device):
        weights = synth.weights(ref_model.build(cfg, norm), seed, device)
        if m["class"] == "FullRegression":
            net = FullRegression(m["joints"], stage=m["stages"], label_size=m["label_size"],
                                 features=m["features"], level=m["level"], norm_method=norm)
        else:
            net = PixelwiseRegression(m["joints"], stage=m["stages"], features=m["features"],
                                      level=m["level"], kernel_size=m["filter_size"],
                                      norm_method=norm, heatmap_method=m["heatmap_method"],
                                      decoder=m["decoder"])
    net.load_state_dict(weights, strict=True)
    o = cfg["optimizer"]
    state = create_train_state(net, opt="adam", lr=o["lr"], beta1=o["beta1"], beta2=o["beta2"],
                               weight_decay=o["weight_decay"], lr_decay=o["lr_decay"],
                               decay_epoch=o["decay_epoch"], steps_per_epoch=o["steps_per_epoch"])
    cam = cfg["dataset"]["camera"]
    pcfg = PreprocessConfig(fx=cam["fx"], fy=cam["fy"], halfu=cam["halfu"], halfv=cam["halfv"],
                            image_size=pp["image_size"], label_size=pp["label_size"],
                            kernel_size=pp["kernel_size"], sigma=pp["sigma"],
                            using_rotation=pp["using_rotation"], using_scale=pp["using_scale"],
                            using_shift=pp["using_shift"], using_flip=pp["using_flip"],
                            strict_quirks=pp["strict_quirks"], aug_fallback=pp["aug_fallback"])
    if m["class"] == "FullRegression":
        step = make_train_step_fullreg(pcfg)
    else:
        lo = cfg["loss"]
        step = make_train_step(pcfg, LossConfig(lo["lambda_h"], lo["lambda_d"], lo["alpha"]),
                               augment=pp["augment"])
    pool = synth.pool(cfg, mix, seed, device)
    draws = synth.draws(mix["draw_sets"], mix["batch"], seed, device)
    return {"state": state, "step": step, "weights": weights, "pool": pool, "draws": draws}


def _launches():
    from pixelwiseregression_tpu_torch.ops import cuda_softargmax as cs
    return {"K1": cs.LAUNCHES, "K2": cs.BWD_LAUNCHES}


def expected_launches(cfg, device) -> dict:
    """K1 and K2 a step: one each a stage where the decoder is the kernels'."""
    m = cfg["model"]
    n = m["stages"] if (device.type == "cuda" and m["class"] == "PixelwiseRegression"
                        and m["decoder"] == "cuda") else 0
    return {"K1": n, "K2": n}


def setup_steps(cfg: dict, prog: dict, n: int, device) -> dict:
    """The first ``n`` steps; the program's readings the reference is held to."""
    from pixelwiseregression_tpu_torch.data.loader import to_device
    state, step = prog["state"], prog["step"]
    names = {p: k for k, p in state.model.named_parameters()}
    beta1 = cfg["optimizer"]["beta1"]
    losses, grad_norms, launches = [], None, None
    for i in range(n):
        before = _launches()
        out = step(state, to_device(prog["pool"][i], device), draws=prog["draws"][i])
        losses.append(float(out["loss"]))
        if launches is None:
            after = _launches()
            launches = {k: after[k] - before[k] for k in after}
        if grad_norms is None:
            # a leaf the optimizer holds no state for got no gradient: 0
            held = state.optimizer.state
            grad_norms = {names[p]: float(torch.linalg.vector_norm(held[p]["exp_avg"]))
                          / (1.0 - beta1) if "exp_avg" in held.get(p, {}) else 0.0
                          for p in names}
    change = {k: float(torch.linalg.vector_norm(p.detach() - prog["weights"][k]))
              for k, p in state.model.named_parameters()}
    want = expected_launches(cfg, device)
    if launches != want:
        raise RuntimeError(f"a train step launched {launches}, expected {want}")
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}


def reference(cfg: dict, mix: dict, prog: dict, n: int, device, tf32=False, half_batch=False):
    """The reference's readings over the same first ``n`` steps."""
    batches = [{k: torch.from_numpy(v).to(device) for k, v in b.items()}
               for b in prog["pool"][:n]]
    pp = {**cfg["preprocess"], **cfg["dataset"]["camera"]}
    return ref_steps.train_steps({**cfg, "preprocess": pp}, prog["weights"], batches,
                                 prog["draws"][:n], mix["reference_rows"], tf32, half_batch)


def run(ctx) -> dict:
    from pixelwiseregression_tpu_torch.data.loader import to_device
    cfg, mix, device = ctx.cfg, ctx.mix, ctx.device
    prog = build(cfg, mix, ctx.seed, device)
    n0 = mix["setup_steps"]
    readings = setup_steps(cfg, prog, n0, device)
    state, step, pool, draws = prog["state"], prog["step"], prog["pool"], prog["draws"]
    b = mix["batch"]
    k = n0

    def one(events=None):
        nonlocal k
        with torch.profiler.record_function("port_bench.to_device"):
            batch = to_device(pool[k % len(pool)], device)
        with torch.profiler.record_function("port_bench.train_step"):
            step(state, batch, draws=draws[k % len(draws)], events=events)
        k += 1

    timed = []
    harness.sync(device)
    t_open = time.monotonic()
    steps = 0
    while time.monotonic() - t_open < ctx.seconds:
        ev = None
        if ctx.trace and device.type == "cuda":
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
            timed.append(ev)
        one(ev)
        steps += 1
    harness.sync(device)
    window = time.monotonic() - t_open
    record = {"frames_per_s": steps * b / window, "flop_per_frame": arith.forward_flops(cfg),
              "peak_flops": arith.PEAK_FLOPS[cfg["dtype"]]}
    out = {"window_open": t_open, "attempted": steps, "failed": 0,
           "e2e": {"train_frames_per_s": record["frames_per_s"]},
           "memory_peak_bytes": harness.memory_peak(device)}
    if ctx.trace:
        record["step_ms"] = {p: [ev[i].elapsed_time(ev[i + 1]) for ev in timed]
                             for i, p in enumerate(PHASES)}
        record["trace"] = harness.profile(lambda: [one() for _ in range(mix["trace_steps"])],
                                          device)
        m = cfg["model"]
        hw = m["label_size"] ** 2
        record["decoder"] = {"k1": dict(b=b, j=m["joints"], hw=hw, in_dtype="f32",
                                        hm_dtype="f32"),
                             "k2": dict(b=b, j=m["joints"], hw=hw, dlabel=False)}
    out["record"] = record
    del state, step, prog["state"], prog["step"]
    harness.free(device)
    ref = reference(cfg, mix, prog, n0, device)
    out["numbers"] = harness.train_numbers(readings, ref, MOVED_SHARE)
    return out
