"""Dataset constants and host crop records (mirrors ``pixelwiseregression_tpu/data/sources.py``).

A numpy-only copy of the part the serving path needs: the four datasets'
specs, ``make_record`` and ``load_bbox``. The JAX module pulls in jax through
its camera, so the port keeps this copy; a test holds it field for field
against the JAX module. The raw dataset decoders come with the training port.

The host computes the crop integers in float64 and truncates exactly as the
reference does (``int(du + dv)``, ``int(com[0])``, ``box // 2``): they feed
normalization denominators, so a float32 truncation boundary is not
acceptable.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from pixelwiseregression_tpu_torch.core.camera import Camera


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    camera: Camera
    cube_size: float
    joint_number: int
    frame_h: int
    frame_w: int
    bbox_margin: Optional[float]  # None -> no load-time bbox mask (MSRA)
    skeleton: Tuple[Tuple[int, ...], ...]  # finger chains, bottom-up


MSRA_SPEC = DatasetSpec(
    name="MSRA",
    camera=Camera(241.42, 241.42, 160.0, 120.0),
    cube_size=125.0,
    joint_number=21,
    frame_h=240,
    frame_w=320,
    bbox_margin=None,
    skeleton=(
        (0, 17, 18, 19, 20),
        (0, 1, 2, 3, 4),
        (0, 5, 6, 7, 8),
        (0, 9, 10, 11, 12),
        (0, 13, 14, 15, 16),
    ),
)

ICVL_SPEC = DatasetSpec(
    name="ICVL",
    camera=Camera(241.42, 241.42, 160.0, 120.0),
    cube_size=125.0,
    joint_number=16,
    frame_h=240,
    frame_w=320,
    bbox_margin=30.0,
    skeleton=(
        (0, 1, 2, 3),
        (0, 4, 5, 6),
        (0, 7, 8, 9),
        (0, 10, 11, 12),
        (0, 13, 14, 15),
    ),
)

NYU_SPEC = DatasetSpec(
    name="NYU",
    camera=Camera(588.037, 587.075, 320.0, 240.0),
    cube_size=150.0,
    joint_number=14,
    frame_h=480,
    frame_w=640,
    bbox_margin=40.0,
    skeleton=(
        (13, 10, 9, 8),
        (13, 1, 0),
        (13, 3, 2),
        (13, 5, 4),
        (13, 7, 6),
        (11, 13, 12),
    ),
)

HAND17_SPEC = DatasetSpec(
    name="HAND17",
    camera=Camera(475.065948, 475.065857, 315.944855, 245.287079),
    cube_size=150.0,
    joint_number=21,
    frame_h=480,
    frame_w=640,
    bbox_margin=40.0,
    skeleton=(
        (0, 1, 6, 7, 8),
        (0, 2, 9, 10, 11),
        (0, 3, 12, 13, 14),
        (0, 4, 15, 16, 17),
        (0, 5, 18, 19, 20),
    ),
)

SPECS = {"MSRA": MSRA_SPEC, "ICVL": ICVL_SPEC, "NYU": NYU_SPEC, "HAND17": HAND17_SPEC}


def make_record(
    spec: DatasetSpec,
    frame: np.ndarray,
    joints_uvd: Optional[np.ndarray],
    com: np.ndarray,
    cube: float,
    bbox: Optional[Tuple[int, int, int, int]] = None,
) -> Dict[str, np.ndarray]:
    """Assemble the host record with exact float64->int crop parameters."""
    cam = spec.camera
    du = cube / com[2] * cam.fx
    dv = cube / com[2] * cam.fy
    box = max(int(du + dv), 2)
    s = box // 2
    com_u, com_v = int(com[0]), int(com[1])
    if bbox is None:
        bbox = (0, 0, frame.shape[1], frame.shape[0])
    rec = {
        "frame": np.ascontiguousarray(frame, dtype=np.float32),
        "com": com.astype(np.float32),
        "com_int": np.array([com_u, com_v], np.int32),
        "cube": np.float32(cube),
        "bbox": np.array(bbox, np.int32),
        "crop_top": np.int32(com_v - s),
        "crop_left": np.int32(com_u - s),
        "box_size": np.int32(2 * s),
    }
    if joints_uvd is not None:
        rec["joints"] = joints_uvd.astype(np.float32)
    return rec


def load_bbox(spec: DatasetSpec, com: np.ndarray, cube: float) -> Tuple[int, int, int, int]:
    """Load-time background bbox: margin-shrunk projected cube, clamped to the frame."""
    cam = spec.camera
    margin = spec.bbox_margin
    du = (cube - margin) / com[2] * cam.fx
    dv = (cube - margin) / com[2] * cam.fy
    left = max(int(com[0] - du), 0)
    top = max(int(com[1] - dv), 0)
    right = int(min(int(com[0] + du), cam.halfu * 2))
    bottom = int(min(int(com[1] + dv), cam.halfv * 2))
    return left, top, right, bottom
