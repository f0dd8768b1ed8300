"""Depth frames with a hand detector's boxes, from the seed: the HANDS 2017
frame-based track's test requests (a 480x640 SR300 frame and a box per
frame), synthesised, since no dataset ships with the repository.

A frame holds, per frame drawn from ``RandomState``:

* a hand: a disc of radius U(45, 65) mm at a depth of U(400, 800) mm, within
  +-120 px of the frame's centre, with a relief of a few mm;
* a forearm: a strip U(50, 70) mm wide, U(40, 90) mm behind the hand, from
  the hand's centre in a random direction off the frame;
* a background plane U(250, 600) mm behind the hand at its centre, filling
  the rest of the frame, tilted by U(3.5, 6) mm a pixel in a random
  direction, as a wall or a desk seen at a slant, the tilt lowered where it
  must be so that the plane lies at least ``BG_CLEAR_MM`` behind the hand
  at every pixel of the box;
* 5% zero holes (a hash of the pixel and the seed, so that the frame does
  not depend on the device).

Depths are rounded to whole mm, as the camera's 16-bit frames hold them.
The box is the hand and the first U(15, 35) mm of the forearm, a hand
detector's box, widened by U(10, 30) px a side and clipped to the frame:
the rest of the forearm lies outside it, inside the hand's crop, so the
network sees a different crop when the box is not applied. The plane's tilt
puts background in the box on both sides of the first round's cut, so both
rounds of the cut remove pixels (``port_bench/tests``).

The frames are computed in float64 on ``device``, a batch at once, then
rounded to float32 and copied to host memory; the boxes are float64
``(ustart, vstart, du, dv)`` in frame pixels.
"""

from __future__ import annotations

import numpy as np
import torch

from port_bench.synth import sub_seed

HOLE_SHARE = 0.05
# the least depth of the background plane behind the hand inside its box (mm)
BG_CLEAR_MM = 100.0


def _hash01(idx: torch.Tensor, seed: int) -> torch.Tensor:
    """A uniform number in [0, 1) a pixel index: two rounds of a 32-bit
    multiply-xorshift hash, the same on every device."""
    m = 0xFFFFFFFF
    x = (idx * 2654435761 + (seed & m)) & m
    x = ((x ^ (x >> 15)) * 0x7FEB352D) & m
    x = ((x ^ (x >> 13)) * 0x5BD1E995) & m
    x = x ^ (x >> 16)
    return x.to(torch.float64) / 2.0 ** 32


def frames_and_boxes(b: int, fh: int, fw: int, *, fx: float, fy: float, seed: int = 0,
                     device="cpu") -> dict:
    """``b`` frames ``[b, fh, fw]`` float32 (mm), their boxes ``[b, 4]`` and
    ``clear_mm`` ``[b]``: how far the plane lies behind the hand at its
    nearest pixel inside the box, before rounding."""
    rng = np.random.RandomState(seed)
    d = rng.uniform(400, 800, b)
    cu = fw / 2 + rng.uniform(-120, 120, b)
    cv = fh / 2 + rng.uniform(-120, 120, b)
    r_mm = rng.uniform(45, 65, b)
    arm_angle = rng.uniform(0, 2 * np.pi, b)
    arm_mm = rng.uniform(50, 70, b)
    arm_behind = rng.uniform(40, 90, b)
    wrist_mm = rng.uniform(15, 35, b)
    margin = rng.uniform(10, 30, b)
    bg_behind = rng.uniform(250, 600, b)
    tilt = rng.uniform(3.5, 6.0, b)
    tilt_angle = rng.uniform(0, 2 * np.pi, b)
    hole_seed = int(rng.randint(0, 2 ** 31))

    f = np.sqrt(fx * fy)
    r_px, arm_px, wrist_px = r_mm * f / d, arm_mm * f / d, wrist_mm * f / d
    dirs = np.stack([np.cos(arm_angle), np.sin(arm_angle)], 1)

    # the box: the hand's disc and the forearm's first wrist_px, widened
    reach = r_px + wrist_px
    perp = np.stack([-dirs[:, 1], dirs[:, 0]], 1) * (arm_px / 2)[:, None]
    c = np.stack([cu, cv], 1)
    pts = [c - r_px[:, None], c + r_px[:, None]] + [
        c + s * reach[:, None] * dirs + t * perp for s in (0, 1) for t in (-1, 1)]
    lo = np.min(pts, axis=0) - margin[:, None]
    hi = np.max(pts, axis=0) + margin[:, None]
    lo = np.maximum(lo, 0.0)
    hi = np.minimum(hi, [fw, fh])
    boxes = np.concatenate([lo, hi - lo], axis=1)
    # the plane stays BG_CLEAR_MM behind the hand's depth at every corner of
    # the box's pixels, so inside it (a plane's lowest point on a rectangle is
    # a corner); the box's first pixel is its start truncated
    first = np.floor(lo)
    corners = np.stack([np.stack([first[:, 0], hi[:, 0], first[:, 0], hi[:, 0]], 1) - cu[:, None],
                        np.stack([first[:, 1], first[:, 1], hi[:, 1], hi[:, 1]], 1) - cv[:, None]],
                       2)
    rise = -(corners @ np.stack([np.cos(tilt_angle), np.sin(tilt_angle)], 1)[:, :, None])[..., 0]
    tilt = np.minimum(tilt, (bg_behind - BG_CLEAR_MM) / np.maximum(rise.max(1), 1e-9))

    dev = torch.device(device)

    def col(x):
        return torch.as_tensor(x, dtype=torch.float64, device=dev)[:, None, None]

    xs = torch.arange(fw, dtype=torch.float64, device=dev)[None, None, :]
    ys = torch.arange(fh, dtype=torch.float64, device=dev)[None, :, None]
    dx, dy = xs - col(cu), ys - col(cv)
    rho2 = (dx * dx + dy * dy) / col(r_px) ** 2
    bumps = 3.0 * torch.sin(xs / 3.1) * torch.cos(ys / 4.3) + 2.0 * torch.sin((xs + ys) / 7.7)
    hand = col(d) + 15.0 * (rho2 - 0.5) + bumps
    along = dx * col(dirs[:, 0]) + dy * col(dirs[:, 1])
    across = (-dx * col(dirs[:, 1]) + dy * col(dirs[:, 0])) / (col(arm_px) / 2)
    arm = col(d + arm_behind) + 8.0 * across * across
    slope = (dx * col(np.cos(tilt_angle)) + dy * col(np.sin(tilt_angle))) * col(tilt)
    depth = col(d + bg_behind) + slope
    inside = ((ys >= col(first[:, 1])) & (ys < col(np.floor(hi[:, 1])))
              & (xs >= col(first[:, 0])) & (xs < col(np.floor(hi[:, 0]))))
    clear = torch.where(inside, depth, torch.inf).amin((1, 2)).cpu().numpy() - d
    depth = torch.where((along >= 0) & (across.abs() <= 1), arm, depth)
    depth = torch.where(rho2 < 1, hand, depth)
    idx = torch.arange(b * fh * fw, dtype=torch.int64, device=dev).reshape(b, fh, fw)
    depth = torch.where(_hash01(idx, hole_seed) < HOLE_SHARE, 0.0, depth.clamp_min(0.0).round())
    frames = depth.to(torch.float32).cpu().numpy()

    return {"frame": frames, "box": boxes, "clear_mm": clear}


def pool(cfg: dict, mix: dict, seed: int, device) -> list:
    """``mix["pool"]`` requests of ``mix["batch"]`` frames and boxes at the
    configuration's frame size and intrinsics, in host memory."""
    ds = cfg["dataset"]
    return [frames_and_boxes(mix["batch"], ds["frame_h"], ds["frame_w"], fx=ds["camera"]["fx"],
                             fy=ds["camera"]["fy"], seed=sub_seed(seed, 3, k), device=device)
            for k in range(mix["pool"])]
