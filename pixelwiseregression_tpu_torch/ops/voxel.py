"""V2V-PoseNet's inputs and targets, on the device: raw depth frames
voxelised into occupancy grids, and a 3D Gaussian a joint.

For every pixel ``(u, v)`` of a frame whose depth ``d`` is positive:

1. ``p = pixel2world(u, v, d)``: ``x = (u - halfu) / fx * d``,
   ``y = (v - halfv) / fy * d``, ``z = d`` (``core.camera``'s formula);
2. ``q = s R(theta) (p - c) + t * vox``, with ``c`` the world point of the
   frame's centre ``com``, ``R`` a rotation in the XY plane, ``s`` a scale,
   ``t`` a shift in voxels and ``vox = cube / side`` the voxel's edge;
3. the voxel ``floor((q + cube / 2) / vox)``, kept if it lies in
   ``[0, side)^3``, holds 1; every other voxel 0.

The grid is ``[B, 1, side, side, side]`` float32, its axes (z, y, x). Each
joint (uvd) goes through steps 1-2 to ``q_j``, and its coordinate on the
output grid of ``side / 2`` is ``(q_j + cube / 2) / (2 vox) - 0.5``; its
target is ``exp(-|x - x_j|^2 / (2 sigma^2))`` over the output grid's voxel
indices ``x`` (``targets``), ``[B, J, side/2, side/2, side/2]``.

``coefficients`` computes a sample's camera, centre, rotation, scale, shift
and voxel edge once, with torch calls on the frames' device, into one row of
``COEFS`` float32 numbers. The voxeliser then only subtracts, multiplies,
adds and divides in float32, in one fixed order, with no fused
multiply-add: its plain version (``voxelize_plain``, each step one torch
op) and the kernel (``csrc/voxelize.cu``, ``__fsub_rn`` / ``__fmul_rn`` /
``__fadd_rn`` / ``__fdiv_rn``) give the same grids bit for bit from the
same rows. Every divisor is a tensor on the frames' device: a CUDA tensor
divided by a Python number is multiplied by its reciprocal, which rounds
otherwise.

``voxelize`` is the registered operator ``torch.ops.pwr.voxelize(frame,
coef, side)``: CPU tensors take the plain version, CUDA tensors the kernel
(no fallback). It writes into a fresh grid and never reads a value back to
the host. ``LAUNCHES`` counts the kernel's launches and ``VOXELIZED`` the
frames it voxelised.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Dict, Optional

import torch

from pixelwiseregression_tpu_torch.ops import cuda_lib

LAUNCHES = 0
VOXELIZED = 0

# a row of ``coefficients``, by position
COEF_NAMES = ("halfu", "halfv", "fx", "fy", "cx", "cy", "cz", "m00", "m01", "m10", "m11",
              "m22", "tx", "ty", "tz", "half", "vox")
COEFS = len(COEF_NAMES)
# the kernel's slabs of z a sample: one block each
SLABS = 4

_P, _I = ctypes.c_void_p, ctypes.c_int
# (frame, coef, grid, B, H, W, side, stream)
_ARGTYPES = [_P] * 3 + [_I] * 4 + [_P]


@dataclasses.dataclass(frozen=True)
class VoxelConfig:
    """The camera, the cube around the centre (mm), the input grid's side
    (the output grid's is half of it), the targets' sigma (output voxels)
    and the augmentation's ranges: rotation in the XY plane (degrees),
    scale, shift (input voxels, each axis)."""

    fx: float
    fy: float
    halfu: float
    halfv: float
    cube: float = 250.0
    side: int = 88
    sigma: float = 1.7
    rotation: float = 40.0
    scale: tuple = (0.8, 1.2)
    shift: float = 8.0

    @property
    def out_side(self) -> int:
        return self.side // 2


def draw_augmentation(b: int, generator: Optional[torch.Generator], device,
                      cfg: VoxelConfig) -> Dict[str, torch.Tensor]:
    """``b`` samples' draws: ``angle`` U(-rotation, rotation) degrees,
    ``scale`` U(scale), ``shift`` U(-shift, shift)^3 voxels."""

    def uniform(shape, lo, hi):
        u = torch.rand(shape, generator=generator, device=device)
        return u * (hi - lo) + lo

    return {"angle": uniform((b,), -cfg.rotation, cfg.rotation),
            "scale": uniform((b,), *cfg.scale),
            "shift": uniform((b, 3), -cfg.shift, cfg.shift)}


def no_augmentation(b: int, device) -> Dict[str, torch.Tensor]:
    """The identity's draws (evaluation)."""
    return {"angle": torch.zeros(b, device=device), "scale": torch.ones(b, device=device),
            "shift": torch.zeros((b, 3), device=device)}


def _world(u, v, d, halfu, halfv, fx, fy):
    """pixel2world, one torch op a step: ``((u - halfu) / fx) * d``."""
    return (u - halfu) / fx * d, (v - halfv) / fy * d


def coefficients(com: torch.Tensor, draws: Dict[str, torch.Tensor],
                 cfg: VoxelConfig) -> torch.Tensor:
    """``[B, COEFS]`` float32 on ``com``'s device: the camera, the centre's
    world point, ``s R``, ``t * vox``, ``cube / 2`` and ``vox``."""
    dev = com.device
    b = com.shape[0]

    def const(x):
        return torch.full((b,), x, dtype=torch.float32, device=dev)

    halfu, halfv, fx, fy = (const(x) for x in (cfg.halfu, cfg.halfv, cfg.fx, cfg.fy))
    com = com.to(torch.float32)
    cx, cy = _world(com[:, 0], com[:, 1], com[:, 2], halfu, halfv, fx, fy)
    theta = draws["angle"].to(torch.float32) * (math.pi / 180.0)
    s = draws["scale"].to(torch.float32)
    sc, ss = s * torch.cos(theta), s * torch.sin(theta)
    cube = const(cfg.cube)
    vox = cube / const(float(cfg.side))
    t = draws["shift"].to(torch.float32) * vox[:, None]
    return torch.stack([halfu, halfv, fx, fy, cx, cy, com[:, 2], sc, -ss, ss, sc, s,
                        t[:, 0], t[:, 1], t[:, 2], cube * 0.5, vox], dim=1)


def _named(coef: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The rows ``[B, COEFS]`` as ``[B, 1]`` columns by name."""
    return {n: coef[:, i, None] for i, n in enumerate(COEF_NAMES)}


def _transform(x, y, z, k):
    """``q = s R (p - c) + t * vox`` from a ``[B, N]`` world point and the
    named rows ``k``, one torch op a step."""
    dx, dy, dz = x - k["cx"], y - k["cy"], z - k["cz"]
    qx = k["m00"] * dx + k["m01"] * dy + k["tx"]
    qy = k["m10"] * dx + k["m11"] * dy + k["ty"]
    qz = k["m22"] * dz + k["tz"]
    return qx, qy, qz


def voxelize_plain(frame: torch.Tensor, coef: torch.Tensor, side: int) -> torch.Tensor:
    """The semantics, in torch ops: ``frame`` ``[B, H, W]`` float32 depths,
    ``coef`` ``[B, COEFS]`` -> the grid ``[B, 1, side, side, side]``."""
    b, h, w = frame.shape
    dev = frame.device
    d = frame.reshape(b, h * w)
    u = torch.arange(w, dtype=torch.float32, device=dev).repeat(h)[None]
    v = torch.arange(h, dtype=torch.float32, device=dev).repeat_interleave(w)[None]
    k = _named(coef)
    x, y = _world(u, v, d, k["halfu"], k["halfv"], k["fx"], k["fy"])
    qx, qy, qz = _transform(x, y, d, k)
    idx = [torch.floor((q + k["half"]) / k["vox"]) for q in (qz, qy, qx)]
    keep = d > 0
    for i in idx:
        keep &= (i >= 0) & (i < side)
    iz, iy, ix = (torch.where(keep, i, 0.0).to(torch.int64) for i in idx)
    rows = torch.arange(b, device=dev)[:, None]
    # cells that are not kept land on one spare cell past the grids
    flat = torch.where(keep, ((rows * side + iz) * side + iy) * side + ix, b * side ** 3)
    grid = torch.zeros(b * side ** 3 + 1, dtype=torch.float32, device=dev)
    grid.index_fill_(0, flat.reshape(-1), 1.0)
    return grid[:-1].view(b, 1, side, side, side)


def _check(frame, coef, side):
    b, h, w = frame.shape
    if frame.dtype != torch.float32 or coef.dtype != torch.float32:
        raise TypeError(f"the voxeliser takes float32, got {frame.dtype} {coef.dtype}")
    if coef.shape != (b, COEFS):
        raise ValueError(f"coef {tuple(coef.shape)} for {b} frames, expected [{b}, {COEFS}]")
    if side <= 0 or side % SLABS or w % 4 or b == 0:
        raise ValueError(f"the kernel takes a side that {SLABS} divides and rows that 4 "
                         f"divides, got side {side} and frames {tuple(frame.shape)}")
    for t in (frame, coef):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("kernel needs contiguous, 16-byte aligned tensors")


@torch.library.custom_op("pwr::voxelize", mutates_args=())
def voxelize(frame: torch.Tensor, coef: torch.Tensor, side: int) -> torch.Tensor:
    """The occupancy grids ``[B, 1, side, side, side]`` of ``frame`` ``[B, H,
    W]`` under ``coef`` ``[B, COEFS]`` (``coefficients``), as a registered
    operator: the plain version for CPU tensors, the kernel for CUDA ones."""
    cuda_lib.on_cpu("the voxeliser", [frame, coef])
    return voxelize_plain(frame, coef, side)


@voxelize.register_kernel("cuda")
def _voxelize_cuda(frame, coef, side):
    global LAUNCHES, VOXELIZED
    cuda_lib.on_cpu("the voxeliser", [frame, coef])
    _check(frame, coef, side)
    b, h, w = frame.shape
    grid = torch.empty((b, 1, side, side, side), dtype=torch.float32, device=frame.device)
    rc = cuda_lib.function("voxelize", _ARGTYPES)(
        frame.data_ptr(), coef.data_ptr(), grid.data_ptr(), b, h, w, side,
        torch.cuda.current_stream(frame.device).cuda_stream)
    cuda_lib.check(rc, "voxelize")
    LAUNCHES += 1
    VOXELIZED += b
    return grid


@voxelize.register_fake
def _voxelize_fake(frame, coef, side):
    return frame.new_empty((frame.shape[0], 1, side, side, side))


def joint_coords(joints: torch.Tensor, coef: torch.Tensor) -> torch.Tensor:
    """Joints uvd ``[B, J, 3]`` -> their coordinates on the output grid
    (x, y, z), ``[B, J, 3]``: ``(q_j + cube / 2) / (2 vox) - 0.5``."""
    j = joints.to(torch.float32)
    k = _named(coef)
    x, y = _world(j[..., 0], j[..., 1], j[..., 2], k["halfu"], k["halfv"], k["fx"], k["fy"])
    qx, qy, qz = _transform(x, y, j[..., 2], k)
    return torch.stack([(q + k["half"]) / (k["vox"] * 2.0) - 0.5 for q in (qx, qy, qz)], dim=-1)


def targets(joints: torch.Tensor, coef: torch.Tensor, out_side: int,
            sigma: float) -> torch.Tensor:
    """The Gaussian targets ``[B, J, out_side^3]`` (axes z, y, x) around each
    joint's output-grid coordinate: ``exp(-|x - x_j|^2 / (2 sigma^2))``,
    taken as the product of its three factors along the axes."""
    xj = joint_coords(joints, coef)
    grid = torch.arange(out_side, dtype=torch.float32, device=joints.device)
    g = torch.exp(-((grid - xj[..., None]) ** 2) / (2.0 * sigma * sigma))  # [B, J, 3, S]
    gx, gy, gz = g[:, :, 0], g[:, :, 1], g[:, :, 2]
    return gz[..., :, None, None] * gy[..., None, :, None] * gx[..., None, None, :]


def world_from_grid(index: torch.Tensor, coef: torch.Tensor) -> torch.Tensor:
    """Output-grid voxel coordinates (x, y, z) ``[B, J, 3]`` -> world xyz
    (mm), the transform of step 2 inverted."""
    k = _named(coef)
    q = (index.to(torch.float32) + 0.5) * (k["vox"][..., None] * 2.0) - k["half"][..., None]
    qx, qy, qz = q[..., 0] - k["tx"], q[..., 1] - k["ty"], q[..., 2] - k["tz"]
    s2 = k["m00"] * k["m11"] - k["m01"] * k["m10"]
    dx = (k["m11"] * qx - k["m01"] * qy) / s2
    dy = (k["m00"] * qy - k["m10"] * qx) / s2
    return torch.stack([dx + k["cx"], dy + k["cy"], qz / k["m22"] + k["cz"]], dim=-1)
