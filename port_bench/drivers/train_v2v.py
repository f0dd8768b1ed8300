"""Driver ``train_v2v``: V2V-PoseNet's train step on raw frames
(``train/loop.make_train_step_v2v``), one state stepped through the window.

Set-up builds ``V2VPoseNet`` from the seed's weights (the published
initialisation, ``reference/v2v.init_spec``), its RMSprop state
(``create_train_state``: TF32 off) and the step, makes the pool of raw
batches in host memory (``synth.pool``: NYU-sized frames, centres and
joints) and V2V's augmentation draws on the card from the seed (rotation
U(-40, 40) degrees in the XY plane, scale U(0.8, 1.2), shift U(-8, 8)
voxels an axis), then takes the first ``setup_steps`` steps through the
window's own call. Each step sends its batch through
``data.loader.to_device`` and passes its draws; on a card each launches the
voxeliser once for the whole batch.

The window and the traced run are ``train_step``'s: ``train_frames_per_s``
is every frame of every step over the window's seconds; a traced run
records the step's five CUDA events in every step of the window, then
profiles ``trace_steps`` more steps.

``correct`` compares the set-up steps with the reference's
(``reference/v2v.py``) from the same weights, batches and draws: each
step's loss, each leaf's norm of the first gradient as RMSprop holds it
after one step (``square_avg / (1 - alpha)``), each moved leaf's norm of
its change after the last set-up step, and ``voxel_gap``: the voxels of the
set-up steps' grids, as the model received them, that differ from the
reference's.
"""

from __future__ import annotations

import time

import torch

from port_bench import arith, arith_v2v, harness, synth
from port_bench.reference import v2v as ref_v2v

PHASES = ("preprocess", "forward", "backward", "optimizer")
# a leaf whose reference gradient is under this share of the median leaf's
# is nought to rounding (a conv's bias under a BatchNorm), and is not
# compared by its change
MOVED_SHARE = 1e-3


def _check_config(cfg):
    m, v = cfg["model"], cfg["voxel"]
    if cfg["dtype"] != "f32" or cfg["tf32"]:
        raise ValueError("the reference runs float32 with TF32 off")
    if m["in_size"] != v["side"] or m["out_size"] != v["side"] // 2:
        raise ValueError("the model's sides are the voxeliser's")


def voxel_config(cfg: dict):
    from pixelwiseregression_tpu_torch.ops.voxel import VoxelConfig
    v, cam = cfg["voxel"], cfg["dataset"]["camera"]
    return VoxelConfig(fx=cam["fx"], fy=cam["fy"], halfu=cam["halfu"], halfv=cam["halfv"],
                       cube=v["cube"], side=v["side"], sigma=v["sigma"], rotation=v["rotation"],
                       scale=tuple(v["scale"]), shift=v["shift"])


def weights(net: torch.nn.Module, seed: int, device) -> dict:
    """Every leaf of ``net``'s state dict as ``ref_v2v.init_spec`` draws
    it, the normal ones in one call of a generator seeded from ``seed``."""
    sd = net.state_dict()
    spec = ref_v2v.init_spec({k: tuple(v.shape) for k, v in sd.items()})
    g = torch.Generator(device=device).manual_seed(synth.sub_seed(seed, 0))
    names = [k for k in sd if spec[k][0] == "normal"]
    flat = torch.randn(sum(sd[k].numel() for k in names), generator=g, device=device)
    out, at = {}, 0
    for k in names:
        n = sd[k].numel()
        out[k] = flat[at:at + n].view(sd[k].shape) * spec[k][1]
        at += n
    for k, v in sd.items():
        if spec[k][0] == "const":
            out[k] = torch.full(v.shape, spec[k][1], dtype=v.dtype, device=device)
    return {k: out[k] for k in sd}


def draws(n: int, b: int, cfg: dict, seed: int, device) -> list:
    """``n`` sets of V2V's augmentation draws for batches of ``b``."""
    v = cfg["voxel"]
    g = torch.Generator(device=device).manual_seed(synth.sub_seed(seed, 2))

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=g, device=device) * (hi - lo) + lo

    return [{"angle": uniform((b,), -v["rotation"], v["rotation"]),
             "scale": uniform((b,), *v["scale"]),
             "shift": uniform((b, 3), -v["shift"], v["shift"])} for _ in range(n)]


def build(cfg: dict, mix: dict, seed: int, device):
    """The program's state and step, the seed's weights (kept for the
    reference) and the traffic."""
    from pixelwiseregression_tpu_torch.models.v2v import V2VPoseNet
    from pixelwiseregression_tpu_torch.train.loop import create_train_state, make_train_step_v2v
    _check_config(cfg)
    m, o = cfg["model"], cfg["optimizer"]
    with torch.device(device):
        net = V2VPoseNet(m["joints"], m["in_size"])
    w = weights(net, seed, device)
    net.load_state_dict(w, strict=True)
    state = create_train_state(net, opt="rmsprop", lr=o["lr"], weight_decay=o["weight_decay"],
                               lr_decay=1.0)
    return {"state": state, "step": make_train_step_v2v(voxel_config(cfg)), "weights": w,
            "pool": synth.pool(cfg, mix, seed, device),
            "draws": draws(mix["draw_sets"], mix["batch"], cfg, seed, device)}


def _launches():
    from pixelwiseregression_tpu_torch.ops import voxel
    return {"voxelize": voxel.LAUNCHES, "voxelized": voxel.VOXELIZED}


def setup_steps(cfg: dict, prog: dict, n: int, device) -> dict:
    """The first ``n`` steps; the program's readings the reference is held
    to, and the grids the model received."""
    from pixelwiseregression_tpu_torch.data.loader import to_device
    state, step = prog["state"], prog["step"]
    names = {p: k for k, p in state.model.named_parameters()}
    alpha = cfg["optimizer"]["alpha"]
    grids = []
    hook = state.model.register_forward_pre_hook(lambda mod, args: grids.append(args[0]))
    losses, grad_norms, launches = [], None, None
    try:
        for i in range(n):
            before = _launches()
            out = step(state, to_device(prog["pool"][i], device), draws=prog["draws"][i])
            losses.append(float(out["loss"]))
            if launches is None:
                after = _launches()
                launches = {k: after[k] - before[k] for k in after}
            if grad_norms is None:
                held = state.optimizer.state
                grad_norms = {names[p]: (float(held[p]["square_avg"].sum()) / (1.0 - alpha)) ** 0.5
                              if "square_avg" in held.get(p, {}) else 0.0 for p in names}
    finally:
        hook.remove()
    change = {k: float(torch.linalg.vector_norm(p.detach() - prog["weights"][k]))
              for k, p in state.model.named_parameters()}
    b = prog["pool"][0]["frame"].shape[0]
    want = {"voxelize": 1, "voxelized": b} if device.type == "cuda" else {"voxelize": 0,
                                                                         "voxelized": 0}
    if launches != want:
        raise RuntimeError(f"a train step launched {launches}, expected {want}")
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change, "grids": grids}


def reference(cfg: dict, mix: dict, prog: dict, n: int, device, tf32=False, half_batch=False):
    """The reference's readings over the same first ``n`` steps."""
    batches = [{k: torch.from_numpy(prog["pool"][i][k]).to(device)
                for k in ("frame", "com", "joints")} for i in range(n)]
    return ref_v2v.train_steps(cfg, prog["weights"], batches, prog["draws"][:n],
                               mix["reference_rows"], tf32, half_batch)


def numbers(readings: dict, ref: dict) -> dict:
    """``harness.train_numbers`` and ``voxel_gap``: the voxels of every
    set-up step's grid that differ from the reference's."""
    gap = sum(int(torch.count_nonzero(a != b)) for a, b in zip(readings["grids"], ref["grids"]))
    return {**harness.train_numbers(readings, ref, MOVED_SHARE), "voxel_gap": gap}


def run(ctx) -> dict:
    from pixelwiseregression_tpu_torch.data.loader import to_device
    cfg, mix, device = ctx.cfg, ctx.mix, ctx.device
    prog = build(cfg, mix, ctx.seed, device)
    n0 = mix["setup_steps"]
    readings = setup_steps(cfg, prog, n0, device)
    state, step, pool, dr = prog["state"], prog["step"], prog["pool"], prog["draws"]
    b = mix["batch"]
    k = n0

    def one(events=None):
        nonlocal k
        with torch.profiler.record_function("port_bench.to_device"):
            batch = to_device(pool[k % len(pool)], device)
        with torch.profiler.record_function("port_bench.train_step"):
            step(state, batch, draws=dr[k % len(dr)], events=events)
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
    record = {"frames_per_s": steps * b / window, "flop_per_frame": arith_v2v.forward_flops(cfg),
              "peak_flops": arith.PEAK_FLOPS[cfg["dtype"]]}
    out = {"window_open": t_open, "attempted": steps, "failed": 0,
           "e2e": {"train_frames_per_s": record["frames_per_s"]},
           "memory_peak_bytes": harness.memory_peak(device)}
    if ctx.trace:
        record["step_ms"] = {p: [ev[i].elapsed_time(ev[i + 1]) for ev in timed]
                             for i, p in enumerate(PHASES)}
        record["trace"] = harness.profile(lambda: [one() for _ in range(mix["trace_steps"])],
                                          device)
        ds = cfg["dataset"]
        record["voxelize"] = dict(b=b, h=ds["frame_h"], w=ds["frame_w"], side=cfg["voxel"]["side"])
    out["record"] = record
    del state, step, prog["state"], prog["step"]
    harness.free(device)
    ref = reference(cfg, mix, prog, n0, device)
    out["numbers"] = numbers(readings, ref)
    return out
