"""Synthetic raw-frame batches (mirrors ``pixelwiseregression_tpu/utils/synth.py``).

Produces the host-batch dict the loader emits (see data/sources.py
``make_record``): a centered blob "hand" per frame plus the per-sample crop
integers computed the reference way.
"""

from __future__ import annotations

import numpy as np


def make_synthetic_raw_batch(
    b: int,
    fh: int,
    fw: int,
    joints: int,
    *,
    fx: float,
    fy: float,
    cube: float = 125.0,
    com_z: float = 600.0,
    seed: int = 0,
):
    rng = np.random.RandomState(seed)
    frames = np.zeros((b, fh, fw), np.float32)
    yy, xx = np.mgrid[0:fh, 0:fw]
    r_pix = max(8.0, min(fh, fw) / 8.0)
    # mid-frequency surface texture: a bare paraboloid gives near-constant
    # activation channels whose instance-norm statistics are degenerate
    bumps = (6.0 * np.sin(xx / 3.1) * np.cos(yy / 4.3)
             + 4.0 * np.sin((xx + yy) / 7.7)).astype(np.float32)
    for i in range(b):
        cx = fw / 2 + rng.uniform(-5, 5)
        cy = fh / 2 + rng.uniform(-5, 5)
        r2 = ((xx - cx) / r_pix) ** 2 + ((yy - cy) / r_pix) ** 2
        frames[i][r2 < 1] = com_z + 40 * (r2[r2 < 1] - 0.5) + bumps[r2 < 1]

    com = np.stack(
        [np.full(b, fw / 2), np.full(b, fh / 2), np.full(b, com_z)], axis=1
    ).astype(np.float32)
    du = cube / com_z * fx
    dv = cube / com_z * fy
    box = max(int(du + dv), 2)
    s = box // 2
    joints_uvd = np.stack(
        [
            rng.uniform(fw / 2 - r_pix, fw / 2 + r_pix, (b, joints)),
            rng.uniform(fh / 2 - r_pix, fh / 2 + r_pix, (b, joints)),
            rng.uniform(com_z - 30, com_z + 30, (b, joints)),
        ],
        axis=2,
    ).astype(np.float32)
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
