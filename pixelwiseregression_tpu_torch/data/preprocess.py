"""On-device batched preprocessing and label synthesis
(mirrors ``pixelwiseregression_tpu/data/preprocess.py``).

The host computes the exact integer crop parameters in float64
(``data/sources.py``); the device does all pixel work in f32, batched over
the samples where the JAX package vmaps a per-sample function:

  1. background bbox mask, depth-cube mask and COM depth centering,
  2. the fused crop + resize to ``image_size``,
  3. the label image resized to ``label_size`` and its nonzero mask,
  4. (training) heatmap splat + Gaussian blur, depth maps, normalized uvd.

The augmented path (train only) keeps the reference's quirks: with
``strict_quirks`` rotation applies whenever any augmentation flag is on, and
with ``using_flip`` a sample whose flip coin lands true falls back to the
clean path instead of flipping. A sample whose augmentation fails (a heatmap
splat out of range, a crop centre outside the frame) falls back to its clean
version (``aug_fallback="clean"``) or is masked out of the loss
(``"drop"``).

The random draws (angle, scale, shift, flip per sample) come from a
``torch.Generator``, or are handed in as ``draws``, so that a test can make
them with ``jax.random`` on the JAX package's key and compare exactly.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch

from pixelwiseregression_tpu_torch.ops.heatmap import synthesize_labels
from pixelwiseregression_tpu_torch.ops.image import (
    crop_resize,
    resize_bilinear,
    rotation_matrix_inverse,
    warp_affine_inverse,
)


@dataclasses.dataclass(frozen=True)
class PreprocessConfig:
    """Static preprocessing parameters (the JAX package's config, field for field)."""

    fx: float
    fy: float
    halfu: float
    halfv: float
    image_size: int = 128
    label_size: int = 64
    kernel_size: int = 7
    sigma: float = 1.5
    using_rotation: bool = False
    using_scale: bool = False
    using_shift: bool = False
    using_flip: bool = False
    # Replicate the reference's quirks. When False: rotation honors
    # using_rotation, and using_flip actually flips.
    strict_quirks: bool = True
    # A failed augmentation: "clean" falls back to the unaugmented sample,
    # "drop" masks the sample out of the loss.
    aug_fallback: str = "clean"

    @property
    def augmentation(self) -> bool:
        return self.using_rotation or self.using_scale or self.using_shift or self.using_flip


def draw_augmentation(b: int, generator: Optional[torch.Generator],
                      device: torch.device) -> Dict[str, torch.Tensor]:
    """Per-sample draws: angle U(-30, 30) degrees, scale U(0.8, 1.2), world
    shift U(-5, 5)^2 mm, and a flip coin. ``preprocess_batch`` uses each
    only where its flag asks for it."""

    def uniform(shape, lo, hi):
        u = torch.rand(shape, generator=generator, device=device)
        return torch.clamp_min(u * (hi - lo) + lo, lo)

    return {"angle": uniform((b,), -30.0, 30.0), "scale": uniform((b,), 0.8, 1.2),
            "shift": uniform((b, 2), -5.0, 5.0),
            "flip": torch.rand((b,), generator=generator, device=device) < 0.5}


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


def _labels_from_crop(img, uvd_centered, box_size, cube, cfg: PreprocessConfig):
    """Label image, mask, heatmaps, dmaps, normalized uvd and validity of
    ``[B, I, I]`` crops with COM-centered joints ``[B, J, 3]``."""
    ls, ims = cfg.label_size, cfg.image_size
    label_img = resize_bilinear(img, ls, ls)
    uvd_resized_uv = uvd_centered[..., :2] / (box_size[:, None, None] - 1.0) * (ims - 1.0)
    uvd_kernel = uvd_resized_uv / (ims - 1.0) * (ls - 1.0) + (ls // 2)
    heatmaps, dmaps, mask, valid_j = synthesize_labels(
        uvd_kernel, uvd_centered[..., 2], label_img, ls, cfg.kernel_size, cfg.sigma)
    norm_uvd = torch.cat([uvd_resized_uv / (ims - 1.0),
                          uvd_centered[..., 2:3] / cube[:, None, None]], dim=-1)
    valid = valid_j.all(dim=-1) & (mask.sum(dim=(-2, -1)) >= 10)
    return {"img": img, "label_img": label_img, "mask": mask, "heatmaps": heatmaps,
            "dmaps": dmaps, "uvd": norm_uvd, "valid": valid}


def _augmented(batch, centered, draws, box_size, cube, cfg: PreprocessConfig):
    """The augmented crop and its labels; returns (outputs, aug_ok)."""
    _, h, w = centered.shape
    ims = cfg.image_size
    com = batch["com"]
    com_z = com[:, 2]
    box_f = box_size.to(torch.float32)
    ones = torch.ones_like(com_z)
    # QUIRK(parity): the reference redraws the angle whatever using_rotation
    # says, so with strict quirks rotation applies whenever any flag is on
    angle = draws["angle"] if cfg.strict_quirks or cfg.using_rotation else 0.0 * ones
    scale = draws["scale"] if cfg.using_scale else ones

    com_a = com
    if cfg.using_shift:
        # shift in world xy; z (and hence the box size) is unchanged
        shift = draws["shift"]
        gx = (com[:, 0] - cfg.halfu) / cfg.fx * com_z + shift[:, 0]
        gy = (com[:, 1] - cfg.halfv) / cfg.fy * com_z + shift[:, 1]
        com_a = torch.stack([gx * cfg.fx / com_z + cfg.halfu, gy * cfg.fy / com_z + cfg.halfv,
                             com_z], dim=1)
    com_a_int = torch.trunc(com_a[:, :2]).to(torch.int64)
    s_half = box_size // 2
    img = crop_resize(centered, com_a_int[:, 1] - s_half, com_a_int[:, 0] - s_half, box_size, ims)

    # rotate + scale about the image centre, then scale the depth values
    minv = rotation_matrix_inverse(angle, scale, float(ims // 2), float(ims // 2))
    img = warp_affine_inverse(img, minv) * scale[:, None, None]

    flip_draw = draws["flip"]
    do_flip = (not cfg.strict_quirks) and cfg.using_flip
    if do_flip:
        img = torch.where(flip_draw[:, None, None], img.flip(-1), img)

    com_af = torch.stack([com_a_int[:, 0].to(torch.float32), com_a_int[:, 1].to(torch.float32),
                          com_z], dim=1)
    uvd_a = batch["joints"] - com_af[:, None, :]
    uv = uvd_a[..., :2] / (box_f[:, None, None] - 1.0) * (ims - 1.0)
    if do_flip:
        mirror = torch.tensor([-1.0, 1.0], device=uv.device)
        uv = torch.where(flip_draw[:, None, None], uv * mirror, uv)
    t = angle * (math.pi / 180.0)
    cos_t, sin_t, sc = torch.cos(t)[:, None], torch.sin(t)[:, None], scale[:, None]
    # uv @ Rot.T with Rot = [[c, s], [-s, c]], then * scale
    u2 = (uv[..., 0] * cos_t + uv[..., 1] * sin_t) * sc
    v2 = (-uv[..., 0] * sin_t + uv[..., 1] * cos_t) * sc
    d2 = uvd_a[..., 2] * sc
    # _labels_from_crop rescales uv by the box; hand it the unresized uv
    uv_unresized = torch.stack([u2, v2], dim=-1) / (ims - 1.0) * (box_f[:, None, None] - 1.0)
    out = _labels_from_crop(img, torch.cat([uv_unresized, d2[..., None]], dim=-1), box_f, cube,
                            cfg)
    out["com"] = com_af

    # a crop centre outside the frame gives the reference an empty crop and
    # sends the sample to the clean path
    crop_ok = ((com_a_int[:, 1] >= 0) & (com_a_int[:, 1] <= h)
               & (com_a_int[:, 0] >= 0) & (com_a_int[:, 0] <= w))
    aug_ok = out["valid"] & crop_ok
    if cfg.strict_quirks and cfg.using_flip:
        # QUIRK(parity): a drawn flip raises in the reference, and that
        # sample falls back to the clean path
        aug_ok = aug_ok & ~flip_draw
    out["valid"] = aug_ok
    return out, aug_ok


def preprocess_batch(batch: Dict[str, torch.Tensor], cfg: PreprocessConfig,
                     test_only: bool = False, augment: bool = False,
                     generator: Optional[torch.Generator] = None,
                     draws: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
    """Preprocess a raw batch already on the device.

    ``batch`` fields (leading batch dim B): frame ``[B, H, W]`` f32, joints
    ``[B, J, 3]`` f32 (not needed if ``test_only``), com ``[B, 3]`` f32,
    com_int ``[B, 2]`` i32, cube ``[B]`` f32, bbox ``[B, 4]`` i32,
    crop_top/crop_left/box_size ``[B]`` i32.

    Returns NHWC tensors, as the JAX module does: img ``[B, I, I, 1]``,
    label_img and mask ``[B, L, L, 1]``, box_size and cube ``[B]``, com
    ``[B, 3]``; unless ``test_only``, also uvd ``[B, J, 3]``, heatmaps and
    dmaps ``[B, L, L, J]`` (views of ``[B, J, L, L]`` tensors) and valid
    ``[B]`` bool.

    The augmented path (``augment`` and a flag of ``cfg``) takes its draws
    from ``draws`` (``draw_augmentation``'s keys) or, if None, from
    ``generator``, which must then be given.
    """
    com = batch["com"]
    com_z = com[:, 2]
    cube = batch["cube"].to(torch.float32)
    box_size = batch["box_size"]
    centered = _mask_and_center(batch["frame"], batch["bbox"], com_z, cube)
    img_c = crop_resize(centered, batch["crop_top"], batch["crop_left"], box_size,
                        cfg.image_size)
    com_int = batch["com_int"].to(torch.float32)
    com_c = torch.stack([com_int[:, 0], com_int[:, 1], com_z], dim=1)
    scale = cube[:, None, None]
    common = {"box_size": box_size.to(torch.float32), "cube": cube}

    if test_only:
        label = resize_bilinear(img_c, cfg.label_size, cfg.label_size)
        return {"img": (img_c / scale)[..., None], "label_img": (label / scale)[..., None],
                "mask": (label != 0).to(torch.float32)[..., None], **common, "com": com_c}

    use_aug = augment and cfg.augmentation
    drop_fallback = use_aug and cfg.aug_fallback == "drop"
    if not drop_fallback:
        uvd_centered = batch["joints"] - com_c[:, None, :]
        out = _labels_from_crop(img_c, uvd_centered, common["box_size"], cube, cfg)
        out["com"] = com_c
    if use_aug:
        if draws is None:
            if generator is None:
                raise ValueError("the augmented path needs draws or a generator")
            draws = draw_augmentation(com.shape[0], generator, com.device)
        out_a, aug_ok = _augmented(batch, centered, draws, box_size, cube, cfg)
        if drop_fallback:
            out = out_a
        else:
            # fall back to the clean sample, which is then valid whenever
            # the clean path is
            out_a["valid"] = aug_ok | out["valid"]
            out = {k: torch.where(aug_ok.reshape((-1,) + (1,) * (a.ndim - 1)), a, out[k])
                   for k, a in out_a.items()}

    return {
        "img": (out["img"] / scale)[..., None],
        "label_img": (out["label_img"] / scale)[..., None],
        "mask": out["mask"][..., None],
        **common,
        "com": out["com"],
        "uvd": out["uvd"],
        "heatmaps": out["heatmaps"].permute(0, 2, 3, 1),
        "dmaps": (out["dmaps"] / cube[:, None, None, None]).permute(0, 2, 3, 1),
        "valid": out["valid"],
    }
