"""The benchmark's inputs, from the seed: raw depth frames with their crop
integers, the augmentation draws, and the weights.

``raw_batch`` is a copy of the port's ``utils/synth.make_synthetic_raw_batch``
(a textured paraboloid "hand" near the frame's centre, joints drawn around
it, the crop integers the host computes), kept here so that the traffic
does not move when the port does. It draws the same numbers from
``RandomState(seed)`` in the same order and gives the same arrays; the
frames are computed in float64 on ``device``, all frames of a batch at
once, then rounded to float32 and copied to host memory.

``draws`` copies ``data/preprocess.draw_augmentation``'s distributions:
angle U(-30, 30) degrees, scale U(0.8, 1.2), world shift U(-5, 5)^2 mm.
"""

from __future__ import annotations

import numpy as np
import torch

from port_bench.reference.model import init_spec


def sub_seed(seed: int, *path: int) -> int:
    """A 32-bit seed for one use of the run's ``seed`` (any non-negative
    integer, also beyond 32 bits)."""
    return int(np.random.SeedSequence([seed, *path]).generate_state(1)[0])


def raw_batch(b: int, fh: int, fw: int, joints: int, *, fx: float, fy: float,
              cube: float = 125.0, com_z: float = 600.0, seed: int = 0, device="cpu") -> dict:
    rng = np.random.RandomState(seed)
    centres = np.array([[fw / 2 + rng.uniform(-5, 5), fh / 2 + rng.uniform(-5, 5)]
                        for _ in range(b)])
    r_pix = max(8.0, min(fh, fw) / 8.0)
    yy, xx = np.mgrid[0:fh, 0:fw]
    bumps = (6.0 * np.sin(xx / 3.1) * np.cos(yy / 4.3)
             + 4.0 * np.sin((xx + yy) / 7.7)).astype(np.float32)
    dev = torch.device(device)
    xt = torch.arange(fw, dtype=torch.float64, device=dev)[None, None, :]
    yt = torch.arange(fh, dtype=torch.float64, device=dev)[None, :, None]
    c = torch.as_tensor(centres, dtype=torch.float64, device=dev)
    r2 = ((xt - c[:, 0, None, None]) / r_pix) ** 2 + ((yt - c[:, 1, None, None]) / r_pix) ** 2
    bt = torch.as_tensor(bumps, device=dev).to(torch.float64)
    depth = com_z + 40 * (r2 - 0.5) + bt
    frames = torch.where(r2 < 1, depth, 0.0).to(torch.float32).cpu().numpy()

    com = np.stack([np.full(b, fw / 2), np.full(b, fh / 2), np.full(b, com_z)],
                   axis=1).astype(np.float32)
    box = max(int(cube / com_z * fx + cube / com_z * fy), 2)
    s = box // 2
    joints_uvd = np.stack([
        rng.uniform(fw / 2 - r_pix, fw / 2 + r_pix, (b, joints)),
        rng.uniform(fh / 2 - r_pix, fh / 2 + r_pix, (b, joints)),
        rng.uniform(com_z - 30, com_z + 30, (b, joints)),
    ], axis=2).astype(np.float32)
    return {
        "frame": frames,
        "joints": joints_uvd,
        "com": com,
        "com_int": com[:, :2].astype(np.int32),
        "cube": np.full(b, cube, np.float32),
        "bbox": np.tile(np.array([0, 0, fw, fh], np.int32), (b, 1)),
        "crop_top": np.full(b, int(fh / 2) - s, np.int32),
        "crop_left": np.full(b, int(fw / 2) - s, np.int32),
        "box_size": np.full(b, 2 * s, np.int32),
    }


def pool(cfg: dict, mix: dict, seed: int, device) -> list:
    """``mix["pool"]`` distinct raw batches of ``mix["batch"]`` frames at the
    configuration's frame size, intrinsics and crop cube, in host memory."""
    ds = cfg["dataset"]
    return [raw_batch(mix["batch"], ds["frame_h"], ds["frame_w"], cfg["model"]["joints"],
                      fx=ds["camera"]["fx"], fy=ds["camera"]["fy"], cube=ds["cube"],
                      seed=sub_seed(seed, 1, k), device=device)
            for k in range(mix["pool"])]


def draws(n: int, b: int, seed: int, device) -> list:
    """``n`` sets of augmentation draws for batches of ``b``, on ``device``."""
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, 2))

    def uniform(shape, lo, hi):
        u = torch.rand(shape, generator=g, device=device)
        return torch.clamp_min(u * (hi - lo) + lo, lo)

    return [{"angle": uniform((b,), -30.0, 30.0), "scale": uniform((b,), 0.8, 1.2),
             "shift": uniform((b, 2), -5.0, 5.0),
             "flip": torch.rand((b,), generator=g, device=device) < 0.5} for _ in range(n)]


def weights(net: torch.nn.Module, seed: int, device) -> dict:
    """Every leaf of ``net``'s state dict, drawn from ``seed`` on ``device``
    in two calls of one generator (all normal leaves, then all uniform
    ones) as ``init_spec`` says; float32, keyed by state-dict name."""
    spec = init_spec(net)
    shapes = {k: v.shape for k, v in net.state_dict().items()}
    if set(spec) != set(shapes):
        raise KeyError(f"no initial distribution for {sorted(set(shapes) ^ set(spec))}")
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, 0))
    out = {}
    for kind, draw in (("normal", torch.randn), ("uniform", torch.rand)):
        names = [k for k in shapes if spec[k][0] == kind]
        flat = draw(sum(shapes[k].numel() for k in names), generator=g, device=device)
        at = 0
        for k in names:
            n = shapes[k].numel()
            x = flat[at:at + n].view(shapes[k])
            out[k] = x * spec[k][1] if kind == "normal" else (2.0 * x - 1.0) * spec[k][1]
            at += n
    for k in shapes:
        if spec[k][0] == "const":
            out[k] = torch.full(shapes[k], spec[k][1], dtype=torch.float32, device=device)
    return {k: out[k] for k in shapes}
