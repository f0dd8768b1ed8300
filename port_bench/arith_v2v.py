"""The yardstick's arithmetic for V2V-PoseNet: operations of a forward from
the configuration's shapes, and the bytes of the voxeliser's call.

A forward's FLOP are ``2 * k^3 * C_in * C_out * (output voxels)`` over every
conv at the side it runs at, and ``2 * C_in * C_out * (output voxels)``
over each 2^3 stride-2 transposed conv (one tap an output voxel): bias
adds, norms, pooling and the additions are not counted, so a train step's
``3 x forward`` is the usual estimate of its products (as ``arith.py``).
"""

from __future__ import annotations

# the row of per-sample numbers the voxeliser reads (ops/voxel.COEFS)
COEFS = 17


def _conv(cin: int, cout: int, k: int, side: int) -> int:
    return 2 * k ** 3 * cin * cout * side ** 3


def _res(cin: int, cout: int, side: int) -> int:
    skip = _conv(cin, cout, 1, side) if cin != cout else 0
    return _conv(cin, cout, 3, side) + _conv(cout, cout, 3, side) + skip


def forward_flops(cfg: dict) -> float:
    """FLOP of one frame's forward from ``cfg["model"]``."""
    m = cfg["model"]
    s, j = m["in_size"], m["joints"]
    a, b, c = s // 2, s // 4, s // 8
    total = _conv(1, 16, 7, s)
    total += _res(16, 32, a) + 2 * _res(32, 32, a)
    total += _res(32, 32, a) + _res(32, 64, b) + _res(64, 64, b)          # s1, encoder 1, s2
    total += _res(64, 128, c) + 2 * _res(128, 128, c)                     # encoder 2, mid, decoder 2
    total += 2 * 128 * 64 * b ** 3 + _res(64, 64, b) + 2 * 64 * 32 * a ** 3  # up, decoder 1, up
    total += _res(32, 32, a) + 2 * _conv(32, 32, 1, a) + _conv(32, j, 1, a)
    return float(total)


def voxelize_bytes(b: int, h: int, w: int, side: int) -> float:
    """The voxeliser's call: reads the frames ``[B, H, W]`` and the rows of
    per-sample numbers ``[B, COEFS]``, writes the grids ``[B, side^3]``, all
    float32. The targets are torch ops of their own, not counted here."""
    return float(4 * (b * h * w + b * COEFS + b * side ** 3))
