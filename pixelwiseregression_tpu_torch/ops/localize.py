"""The hand found from a detector's box, on the device: the HANDS 2017
test protocol's box-to-centre step, batched over a request.

``localize`` takes raw frames ``[B, H, W]`` (depth mm) and each frame's box
as row and column bounds (``box_bounds``, on the host) and gives what
``HAND17Source._load_raw_bb`` gives one frame at a time on the host
(reference: datasets.py:976-996), for every frame at once:

1. the frame masked to its box;
2. the mean of its positive depths; pixels above that mean + 100 mm zeroed
   on a copy;
3. the mean of the copy's positive depths; pixels above that mean + 100 mm
   zeroed on the frame;
4. the centre: the column mean (u) and row mean (v) of the positive pixels
   left and their mean depth (``center_of_mass_fallback``);

then the crop integers ``make_record`` computes from that centre with the
spec's cube and the whole frame as the background bbox. The cleaned frame
and those fields are a batch for ``data.preprocess.preprocess_batch``.

Means and sums run in float64. For depths in whole mm, as a camera's
16-bit frames hold them, a float64 sum of a frame is exact, so it does not
depend on the order of the additions, and the centre and the cleaned frame
equal the host's bit for bit; the crop integers are truncated from the same
float64 arithmetic. Other float32 depths agree with the host to rounding:
the device's order of the additions may move the centre's last bit, and so
a crop integer that the centre truncates to.
Nothing is read back to the host: a row whose box holds no positive depth
is flagged in ``empty`` and given a placeholder centre (the frame's middle
at ``PLACEHOLDER_MM``), so that it computes finite numbers.

``LOCALIZED`` counts the frames localised, so a run can show that its
requests were localised here and not on the host.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

# the cut above each round's mean depth (mm)
CUT_MM = 100.0
# the depth of an empty row's placeholder centre (mm)
PLACEHOLDER_MM = 1000.0

LOCALIZED = 0


def box_bounds(boxes: np.ndarray, frame_h: int, frame_w: int) -> np.ndarray:
    """``[N, 4]`` boxes ``(ustart, vstart, du, dv)`` in frame pixels ->
    ``[N, 4]`` float64 bounds ``(top, bottom, left, right)``: the numpy slice
    ``[int(vstart):int(vstart + dv), int(ustart):int(ustart + du)]`` of an
    ``frame_h`` x ``frame_w`` frame, negative indices and all."""
    boxes = np.asarray(boxes, np.float64)
    if boxes.ndim != 2 or boxes.shape[1] != 4:
        raise ValueError(f"boxes must be [N, 4] (ustart, vstart, du, dv), got {boxes.shape}")
    out = np.empty((len(boxes), 4), np.float64)
    for i, (u, v, du, dv) in enumerate(boxes):
        top, bottom, _ = slice(int(v), int(v + dv)).indices(frame_h)
        left, right, _ = slice(int(u), int(u + du)).indices(frame_w)
        out[i] = (top, max(bottom, top), left, max(right, left))
    return out


def _mean(f: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """The mean of ``f`` over ``keep`` a frame, ``[B, 1, 1]`` (0 where none)."""
    n = keep.sum((1, 2)).clamp_min(1).to(f.dtype)
    return (torch.where(keep, f, 0.0).sum((1, 2)) / n)[:, None, None]


def clean(frame: torch.Tensor, bounds: torch.Tensor) -> torch.Tensor:
    """Steps 1-3: the float64 frames masked to their boxes, with both rounds
    of the cut."""
    _, h, w = frame.shape
    rows = torch.arange(h, device=frame.device, dtype=torch.float64)[None, :, None]
    cols = torch.arange(w, device=frame.device, dtype=torch.float64)[None, None, :]
    top, bottom, left, right = (bounds[:, i, None, None] for i in range(4))
    inside = (rows >= top) & (rows < bottom) & (cols >= left) & (cols < right)
    f = frame.to(torch.float64) * inside.to(torch.float64)
    keep = f > 0
    keep = keep & ~(f > _mean(f, keep) + CUT_MM)
    return torch.where(f > _mean(f, keep) + CUT_MM, 0.0, f)


def centre(f: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Step 4: ``[B, 3]`` float64 (u, v, d) of the positive pixels of
    ``f``, and ``[B]`` bool, True where there is none."""
    _, h, w = f.shape
    pos = f > 0
    count = pos.sum((1, 2))
    empty = count == 0
    n = count.clamp_min(1).to(torch.float64)
    rows = torch.arange(h, device=f.device, dtype=torch.float64)
    cols = torch.arange(w, device=f.device, dtype=torch.float64)
    u = (pos.sum(1).to(torch.float64) * cols).sum(1) / n
    v = (pos.sum(2).to(torch.float64) * rows).sum(1) / n
    d = torch.where(pos, f, 0.0).sum((1, 2)) / n
    com = torch.stack([torch.where(empty, w / 2, u), torch.where(empty, h / 2, v),
                       torch.where(empty, PLACEHOLDER_MM, d)], dim=1)
    return com, empty


def crop_fields(com: torch.Tensor, cube: torch.Tensor, camera, frame_h: int,
                frame_w: int) -> Dict[str, torch.Tensor]:
    """``make_record``'s fields from float64 centres ``[B, 3]`` and cubes
    ``[B]``, on their device: ``box = max(int(du + dv), 2)`` with ``du =
    cube / d * fx``, ``s = box // 2``, the centre truncated, the corner
    ``(v - s, u - s)``, the whole frame as the bbox."""
    cube = cube.to(torch.float64)
    du = cube / com[:, 2] * camera.fx
    dv = cube / com[:, 2] * camera.fy
    half = torch.clamp_min(torch.trunc(du + dv), 2.0).to(torch.int64) // 2
    ci = torch.trunc(com[:, :2]).to(torch.int64)
    bbox = torch.zeros((com.shape[0], 4), dtype=torch.int32, device=com.device)
    bbox[:, 2] = frame_w
    bbox[:, 3] = frame_h
    return {"com": com.to(torch.float32), "com_int": ci.to(torch.int32),
            "cube": cube.to(torch.float32), "bbox": bbox,
            "crop_top": (ci[:, 1] - half).to(torch.int32),
            "crop_left": (ci[:, 0] - half).to(torch.int32),
            "box_size": (2 * half).to(torch.int32)}


def localize(frame: torch.Tensor, bounds: torch.Tensor, cube: torch.Tensor, camera,
             count: Optional[int] = None):
    """Frames ``[B, H, W]`` f32, their ``box_bounds`` ``[B, 4]`` and cubes
    ``[B]``, all on one device -> (the test-time preprocess's batch: the
    cleaned frame and ``crop_fields``; the float64 centres ``[B, 3]``;
    ``empty`` ``[B]``). Adds ``count`` (default: every row) to
    ``LOCALIZED``."""
    global LOCALIZED
    _, h, w = frame.shape
    f = clean(frame, bounds)
    com, empty = centre(f)
    batch = {"frame": f.to(torch.float32), **crop_fields(com, cube, camera, h, w)}
    LOCALIZED += frame.shape[0] if count is None else count
    return batch, com, empty
