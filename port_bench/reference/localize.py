"""Plain reference of the HANDS 2017 test protocol's step from a hand
detector's box to a hand centre (the reference data loader's 'bb' mode,
datasets.py:976-996), one frame at a time in float64 NumPy; nothing of the
program.

The box ``(ustart, vstart, du, dv)`` keeps the pixels
``[int(vstart):int(vstart + dv), int(ustart):int(ustart + du)]``. Two rounds
of a cut follow: the mean of the positive depths left, and every pixel
deeper than that mean + 100 mm dropped; the first round on a copy, which
only sets the second round's mean, the second on the frame. The centre is
the mean column, the mean row and the mean depth of the positive pixels
left; the network sees the cleaned frame, cropped about that centre with
the whole frame as the background bbox.

``fault`` breaks one step, for the readings that a cell's limits are set
against: ``box_ignored`` (the whole frame in place of the box),
``one_round`` (the second round left out), ``raw_frame`` (the right centre,
but the raw frame handed on to the network).
"""

from __future__ import annotations

import numpy as np

CUT_MM = 100.0
FAULTS = ("box_ignored", "one_round", "raw_frame")


def localize(frame: np.ndarray, box, fault=None):
    """``[H, W]`` depth mm and one box -> (the frame the network sees,
    float64 ``[H, W]``; the centre ``(u, v, d)``, float64)."""
    if fault not in (None,) + FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    raw = np.asarray(frame, np.float64)
    f = raw
    if fault != "box_ignored":
        ustart, vstart, du, dv = (float(x) for x in box)
        inside = np.zeros(f.shape, bool)
        inside[int(vstart):int(vstart + dv), int(ustart):int(ustart + du)] = True
        f = np.where(inside, f, 0.0)
    keep = f > 0
    if not keep.any():
        raise ValueError("no positive depth in the box")
    limit = f[keep].mean() + CUT_MM
    if fault != "one_round":
        keep = keep & ~(f > limit)
        limit = f[keep].mean() + CUT_MM
    f = np.where(f > limit, 0.0, f)
    vs, us = np.nonzero(f > 0)
    centre = np.array([us.mean(), vs.mean(), f[vs, us].mean()])
    return (raw if fault == "raw_frame" else f), centre
