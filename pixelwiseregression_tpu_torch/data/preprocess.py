"""On-device batched preprocessing (mirrors ``pixelwiseregression_tpu/data/preprocess.py``).

The clean inference path of the JAX module: background bbox mask, depth-cube
mask and COM depth centering on the full frame, the fused crop + resize to
``image_size``, the label image resized to ``label_size`` and its nonzero
mask. The augmented path and label synthesis (heatmaps, depth maps,
normalized uvd) come with the training port.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from pixelwiseregression_tpu_torch.ops.image import crop_resize, resize_bilinear


@dataclasses.dataclass(frozen=True)
class PreprocessConfig:
    """Static preprocessing parameters (the inference subset of the JAX config)."""

    fx: float
    fy: float
    halfu: float
    halfv: float
    image_size: int = 128
    label_size: int = 64


def _mask_and_center(frame, bbox, com_z, cube):
    """bbox mask + depth-cube mask + COM depth centering on ``[B, H, W]`` frames.

    ``bbox`` ``[B, 4]`` is (left, top, right, bottom); bounds are strict
    where the JAX module's are.
    """
    _, h, w = frame.shape
    rows = torch.arange(h, device=frame.device)[None, :, None]
    cols = torch.arange(w, device=frame.device)[None, None, :]
    left, top, right, bottom = (bbox[:, i, None, None] for i in range(4))
    inside = ((rows >= top) & (rows < bottom) & (cols >= left) & (cols < right)).to(frame.dtype)
    f = frame * inside
    com_z = com_z[:, None, None]
    cube = cube[:, None, None]
    in_cube = (f > com_z - cube) & (f < com_z + cube)
    f = f * in_cube.to(frame.dtype)
    return torch.where(f > 0, f - com_z, 0.0)


def preprocess_batch(batch: Dict[str, torch.Tensor], cfg: PreprocessConfig,
                     test_only: bool = False) -> Dict[str, torch.Tensor]:
    """Preprocess a raw host batch already on the device.

    ``batch`` fields (leading batch dim B): frame ``[B, H, W]`` f32, com
    ``[B, 3]`` f32, com_int ``[B, 2]`` i32, cube ``[B]`` f32, bbox ``[B, 4]``
    i32, crop_top/crop_left/box_size ``[B]`` i32.

    Returns NHWC tensors as the JAX module does: img ``[B, I, I, 1]``,
    label_img and mask ``[B, L, L, 1]``, box_size and cube ``[B]``, com
    ``[B, 3]``.
    """
    if not test_only:
        raise NotImplementedError("label synthesis and augmentation are not ported yet: "
                                  "only test_only=True is available")
    com = batch["com"]
    cube = batch["cube"].to(torch.float32)
    centered = _mask_and_center(batch["frame"], batch["bbox"], com[:, 2], cube)
    img = crop_resize(centered, batch["crop_top"], batch["crop_left"], batch["box_size"],
                      cfg.image_size)
    label = resize_bilinear(img, cfg.label_size, cfg.label_size)
    mask = (label != 0).to(torch.float32)
    com_int = batch["com_int"].to(torch.float32)
    scale = cube[:, None, None]
    return {
        "img": (img / scale)[..., None],
        "label_img": (label / scale)[..., None],
        "mask": mask[..., None],
        "box_size": batch["box_size"].to(torch.float32),
        "cube": cube,
        "com": torch.stack([com_int[:, 0], com_int[:, 1], com[:, 2]], dim=1),
    }
