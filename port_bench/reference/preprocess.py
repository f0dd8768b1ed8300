"""Plain reference of the on-device preprocess and label synthesis, and of
the serving path's host crop integers (frozen from the port's
``data/preprocess.py``, ``ops/image.py``, ``ops/heatmap.py`` and
``data/sources.make_record``).

The crop and resizes follow cv2 (INTER_LINEAR: source coordinate
``(d + 0.5) * src / dst - 0.5``, taps clamped to the image), the rotation
cv2.warpAffine (bilinear, border 0), the blur cv2.GaussianBlur (a float64
kernel, reflect-101 borders). The augmented path keeps the reference
quirks: rotation whenever any augmentation is on, and a sample whose
augmentation fails (a joint off the label map, too small a hand mask, a
crop centre off the frame) falls back to its clean version.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def _taps(out: int, src: torch.Tensor):
    """cv2 INTER_LINEAR taps of one axis for source sizes ``src`` (any shape):
    ``(i0, i1, w1)`` of shape ``src.shape + (out,)``."""
    s_f = src.to(torch.float32)[..., None]
    d = torch.arange(out, dtype=torch.float32, device=src.device)
    s = (d + 0.5) * (s_f / out) - 0.5
    i0f = torch.floor(s)
    w1 = s - i0f
    i0 = i0f.to(torch.int64)
    n = src.to(torch.int64)[..., None]
    w1 = torch.where(i0 < 0, 0.0, w1)
    i0 = torch.clamp_min(i0, 0)
    w1 = torch.where(i0 >= n - 1, 1.0, w1)
    i0 = torch.minimum(i0, torch.clamp_min(n - 2, 0))
    return i0, torch.minimum(i0 + 1, n - 1), w1


def resize(img, out: int):
    """``[..., H, W]`` -> ``[..., out, out]``."""
    h, w = img.shape[-2:]
    r0, r1, wr = _taps(out, torch.tensor(h, device=img.device))
    c0, c1, wc = _taps(out, torch.tensor(w, device=img.device))
    rows = img[..., r0, :] * (1.0 - wr)[:, None] + img[..., r1, :] * wr[:, None]
    return rows[..., c0] * (1.0 - wc) + rows[..., c1] * wc


def crop_resize(frame, top, left, size, out: int):
    """Zero-padded square crops of ``[B, H, W]`` frames at per-sample
    corners and sizes, resized to ``out``: one gather a tap, rows then
    columns."""
    b, h, w = frame.shape
    r0, r1, wr = _taps(out, size)
    c0, c1, wc = _taps(out, size)
    top, left = top.to(torch.int64)[:, None], left.to(torch.int64)[:, None]

    def rows_at(i):
        fi = top + i
        ok = ((fi >= 0) & (fi < h)).to(frame.dtype)
        v = torch.gather(frame, 1, fi.clamp(0, h - 1)[:, :, None].expand(b, out, w))
        return v * ok[:, :, None]

    rows = rows_at(r0) * (1.0 - wr)[:, :, None] + rows_at(r1) * wr[:, :, None]

    def cols_at(j):
        fj = left + j
        ok = ((fj >= 0) & (fj < w)).to(frame.dtype)
        v = torch.gather(rows, 2, fj.clamp(0, w - 1)[:, None, :].expand(b, out, out))
        return v * ok[:, None, :]

    return cols_at(c0) * (1.0 - wc)[:, None, :] + cols_at(c1) * wc[:, None, :]


def rotate_scale(img, angle_deg, scale):
    """cv2.warpAffine of ``[B, S, S]`` by getRotationMatrix2D(centre S//2,
    angle, scale): each output pixel reads the source at the inverse map."""
    b, h, w = img.shape
    cx = cy = float(h // 2)
    t = angle_deg * (math.pi / 180.0)
    a, bb = torch.cos(t) / scale, torch.sin(t) / scale
    m = [a, -bb, cx - (a * cx - bb * cy), bb, a, cy - (bb * cx + a * cy)]
    m = [v[:, None, None] for v in m]
    gy = torch.arange(h, dtype=img.dtype, device=img.device)[:, None]
    gx = torch.arange(w, dtype=img.dtype, device=img.device)[None, :]
    sx = m[0] * gx + m[1] * gy + m[2]
    sy = m[3] * gx + m[4] * gy + m[5]
    ix, iy = torch.floor(sx).to(torch.int64), torch.floor(sy).to(torch.int64)
    fx, fy = sx - ix.to(img.dtype), sy - iy.to(img.dtype)
    flat = img.reshape(b, h * w)

    def tap(yi, xi):
        ok = ((yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)).to(img.dtype)
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).reshape(b, -1)
        return torch.gather(flat, 1, idx).reshape(b, h, w) * ok

    top = tap(iy, ix) * (1.0 - fx) + tap(iy, ix + 1) * fx
    bot = tap(iy + 1, ix) * (1.0 - fx) + tap(iy + 1, ix + 1) * fx
    return top * (1.0 - fy) + bot * fy


def blur(img, k: int, sigma: float):
    """cv2.GaussianBlur over the last two axes (reflect-101 borders)."""
    x = np.arange(k, dtype=np.float64) - (k - 1) * 0.5
    g = np.exp(-(x * x) / (2.0 * sigma * sigma))
    g = torch.as_tensor(g / g.sum(), dtype=img.dtype, device=img.device)
    p = k // 2
    h, w = img.shape[-2:]
    y = F.pad(img.reshape(-1, h, w), (0, 0, p, p), mode="reflect")
    y = sum(g[t] * y[:, t:t + h, :] for t in range(k))
    y = F.pad(y, (p, p, 0, 0), mode="reflect")
    y = sum(g[t] * y[:, :, t:t + w] for t in range(k))
    return y.reshape(img.shape)


def labels(img, uvd_centered, box, cube, pp: dict):
    """Label image, mask, heatmaps, depth maps, normalised uvd and validity
    of ``[B, I, I]`` crops with COM-centred joints ``[B, J, 3]``."""
    ls, ims = pp["label_size"], pp["image_size"]
    label = resize(img, ls)
    uv = uvd_centered[..., :2] / (box[:, None, None] - 1.0) * (ims - 1.0)
    kern = uv / (ims - 1.0) * (ls - 1.0) + (ls // 2)
    # a unit of mass split over the 2x2 pixels around each joint; an index in
    # [-ls, -1] wraps as numpy's negative indexing does
    u, v = kern[..., 0], kern[..., 1]
    lu, lv = torch.floor(u).to(torch.int64), torch.floor(v).to(torch.int64)
    du, dv = u - lu.to(torch.float32), v - lv.to(torch.float32)
    d = (torch.minimum(du, dv) + torch.clamp_min(du + dv - 1.0, 0.0)) / 2.0
    corners = ((lv, lu, 1.0 + d - du - dv), (lv, lu + 1, du - d), (lv + 1, lu, dv - d),
               (lv + 1, lu + 1, d))
    valid_j = (lu + 1 <= ls - 1) & (lv + 1 <= ls - 1) & (lu >= -ls) & (lv >= -ls)
    hm = torch.zeros(*u.shape, ls * ls, dtype=torch.float32, device=img.device)
    for r, c, wt in corners:
        idx = torch.remainder(r, ls) * ls + torch.remainder(c, ls)
        hm = hm + F.one_hot(idx, ls * ls).to(torch.float32) * wt[..., None]
    hm = hm.reshape(*u.shape, ls, ls) * valid_j[..., None, None].to(torch.float32)
    hm = blur(hm, pp["kernel_size"], pp["sigma"])
    mask = (label != 0).to(torch.float32)
    dmaps = (uvd_centered[..., 2][:, :, None, None] - label[:, None]) * (
        (hm > 0).to(torch.float32) * mask[:, None])
    norm_uvd = torch.cat([uv / (ims - 1.0), uvd_centered[..., 2:3] / cube[:, None, None]], dim=-1)
    valid = valid_j.all(dim=-1) & (mask.sum(dim=(-2, -1)) >= 10)
    return {"img": img, "label_img": label, "mask": mask, "heatmaps": hm, "dmaps": dmaps,
            "uvd": norm_uvd, "valid": valid}


def _centred(batch):
    """Background bbox and depth-cube masks, depth centred on the COM."""
    frame, com_z, cube = batch["frame"], batch["com"][:, 2], batch["cube"]
    _, h, w = frame.shape
    rows = torch.arange(h, device=frame.device)[None, :, None]
    cols = torch.arange(w, device=frame.device)[None, None, :]
    l, t, r, b = (batch["bbox"][:, i, None, None] for i in range(4))
    f = frame * ((rows >= t) & (rows < b) & (cols >= l) & (cols < r)).to(frame.dtype)
    z, c = com_z[:, None, None], cube[:, None, None]
    f = f * ((f > z - c) & (f < z + c)).to(frame.dtype)
    return torch.where(f > 0, f - z, 0.0)


def preprocess(batch, pp: dict, test_only: bool = False, draws=None):
    """A raw batch on the device (frames and crop integers) -> the model's
    inputs (NCHW img ``[B,1,I,I]``, label_img and mask ``[B,1,L,L]``), and
    box_size, cube and com; for training also heatmaps and dmaps ``[B, J,
    L, L]`` (dmaps over the cube), uvd ``[B, J, 3]`` and valid ``[B]``,
    with the augmentation ``draws`` (angle, scale, shift)."""
    com, cube = batch["com"], batch["cube"]
    box = batch["box_size"]
    centred = _centred(batch)
    img = crop_resize(centred, batch["crop_top"], batch["crop_left"], box, pp["image_size"])
    ci = batch["com_int"].to(torch.float32)
    com_c = torch.stack([ci[:, 0], ci[:, 1], com[:, 2]], dim=1)
    box_f = box.to(torch.float32)
    common = {"box_size": box_f, "cube": cube}
    scale3 = cube[:, None, None]
    if test_only:
        label = resize(img, pp["label_size"])
        return {"img": (img / scale3)[:, None], "label_img": (label / scale3)[:, None],
                "mask": (label != 0).to(torch.float32)[:, None], "com": com_c, **common}

    out = labels(img, batch["joints"] - com_c[:, None, :], box_f, cube, pp)
    out["com"] = com_c
    if draws is not None:
        aug = _augmented(batch, centred, draws, box, cube, pp)
        ok = aug["valid"]
        aug["valid"] = ok | out["valid"]
        out = {k: torch.where(ok.reshape((-1,) + (1,) * (a.ndim - 1)), a, out[k])
               for k, a in aug.items()}
    return {"img": (out["img"] / scale3)[:, None], "label_img": (out["label_img"] / scale3)[:, None],
            "mask": out["mask"][:, None], "heatmaps": out["heatmaps"],
            "dmaps": out["dmaps"] / cube[:, None, None, None], "uvd": out["uvd"],
            "valid": out["valid"], "com": out["com"], **common}


def _augmented(batch, centred, draws, box, cube, pp: dict):
    """The rotated, scaled and shifted crop and its labels; ``valid`` says
    where the augmentation succeeded."""
    _, h, w = centred.shape
    ims = pp["image_size"]
    com = batch["com"]
    z = com[:, 2]
    box_f = box.to(torch.float32)
    angle = draws["angle"]
    scale = draws["scale"] if pp["using_scale"] else torch.ones_like(z)
    com_a = com
    if pp["using_shift"]:
        gx = (com[:, 0] - pp["halfu"]) / pp["fx"] * z + draws["shift"][:, 0]
        gy = (com[:, 1] - pp["halfv"]) / pp["fy"] * z + draws["shift"][:, 1]
        com_a = torch.stack([gx * pp["fx"] / z + pp["halfu"], gy * pp["fy"] / z + pp["halfv"], z],
                            dim=1)
    ai = torch.trunc(com_a[:, :2]).to(torch.int64)
    half = box // 2
    img = crop_resize(centred, ai[:, 1] - half, ai[:, 0] - half, box, ims)
    img = rotate_scale(img, angle, scale) * scale[:, None, None]
    com_af = torch.stack([ai[:, 0].to(torch.float32), ai[:, 1].to(torch.float32), z], dim=1)
    uvd = batch["joints"] - com_af[:, None, :]
    uv = uvd[..., :2] / (box_f[:, None, None] - 1.0) * (ims - 1.0)
    t = angle * (math.pi / 180.0)
    c, s, sc = torch.cos(t)[:, None], torch.sin(t)[:, None], scale[:, None]
    u2 = (uv[..., 0] * c + uv[..., 1] * s) * sc
    v2 = (-uv[..., 0] * s + uv[..., 1] * c) * sc
    uv_box = torch.stack([u2, v2], dim=-1) / (ims - 1.0) * (box_f[:, None, None] - 1.0)
    out = labels(img, torch.cat([uv_box, (uvd[..., 2] * sc)[..., None]], dim=-1), box_f, cube, pp)
    out["com"] = com_af
    crop_ok = (ai[:, 1] >= 0) & (ai[:, 1] <= h) & (ai[:, 0] >= 0) & (ai[:, 0] <= w)
    out["valid"] = out["valid"] & crop_ok
    return out


def crop_record(frame_hw, com, cube: float, cam: dict, bbox_margin):
    """The host's crop integers of one frame, in float64 as the reference
    data loader computes them: box side, corner, truncated COM and the
    background bbox (the cube shrunk by the margin, clamped to the frame)."""
    fh, fw = frame_hw
    com = np.asarray(com, np.float64)
    du, dv = cube / com[2] * cam["fx"], cube / com[2] * cam["fy"]
    s = max(int(du + dv), 2) // 2
    cu, cv = int(com[0]), int(com[1])
    if bbox_margin is None:
        bbox = (0, 0, fw, fh)
    else:
        mu = (cube - bbox_margin) / com[2] * cam["fx"]
        mv = (cube - bbox_margin) / com[2] * cam["fy"]
        bbox = (max(int(com[0] - mu), 0), max(int(com[1] - mv), 0),
                int(min(int(com[0] + mu), cam["halfu"] * 2)),
                int(min(int(com[1] + mv), cam["halfv"] * 2)))
    return {"com": com.astype(np.float32), "com_int": np.array([cu, cv], np.int32),
            "cube": np.float32(cube), "bbox": np.array(bbox, np.int32),
            "crop_top": np.int32(cv - s), "crop_left": np.int32(cu - s),
            "box_size": np.int32(2 * s)}
