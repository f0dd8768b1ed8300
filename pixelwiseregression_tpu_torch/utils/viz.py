"""Host-side visualization: skeleton overlays and feature grids
(mirrors ``pixelwiseregression_tpu/utils/viz.py``).

Counterparts of the reference's drawing helpers (reference: utils.py:84-149)
for TensorBoard logging. Pure host/numpy code, never on the training hot
path; cv2 and matplotlib are imported inside the functions that use them.
"""

from __future__ import annotations

import numpy as np

_COLORS_5 = [(1, 0, 0), (0.5, 0.5, 0), (0, 1, 0), (0, 0.5, 0.5), (0, 0, 1)]
_COLORS_6 = _COLORS_5 + [(0.5, 0.5, 0.5)]


def draw_skeleton(img: np.ndarray, joints: np.ndarray, config, r: int = 3, linewidth: int = 1):
    """Overlay a hand skeleton on a depth image.

    ``img``: [H, W] depth; ``joints``: [J, >=2] pixel (u, v); ``config``:
    list of per-finger joint index chains. Returns [H, W, 3] float RGB.
    """
    import cv2

    img3d = np.repeat(np.asarray(img, np.float64)[:, :, None], 3, axis=2)
    maxv = np.max(img3d)
    if maxv > 0:
        img3d = img3d / maxv
    img3d = 1.0 - (img3d * 0.5 + 0.25)

    pts = [(int(joints[i][0]), int(joints[i][1])) for i in range(joints.shape[0])]
    colors = _COLORS_6 if len(config) == 6 else _COLORS_5
    for chain, color in zip(config, colors):
        for idx in chain:
            cv2.circle(img3d, pts[idx], r, color, -1)
        for a, b in zip(chain[:-1], chain[1:]):
            cv2.line(img3d, pts[a], pts[b], color, linewidth)
    return img3d


def draw_skeleton_normalized(img: np.ndarray, uvd: np.ndarray, config):
    """Skeleton from *normalized* network uvd on a network-input image
    (reference: utils.py:116-122): uv scales by (size-1) and re-centers."""
    size = img.shape[0]
    joints = uvd * (size - 1) + np.array([size // 2, size // 2, 0.0])
    return draw_skeleton(img, joints, config)


def draw_features(features: np.ndarray, cols: int = 8):
    """Grid of per-channel maps (heatmaps/depthmaps), [H, W, C] input.
    Returns a matplotlib figure (reference: utils.py:124-145)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    c = features.shape[2]
    rows = c // cols + (0 if c % cols == 0 else 1)
    fig, axes = plt.subplots(rows, cols, figsize=(cols, rows), squeeze=False)
    plt.subplots_adjust(wspace=0.0, hspace=0.0)
    for i in range(rows):
        for j in range(cols):
            k = i * cols + j
            if k >= c:
                axes[i, j].imshow(np.zeros_like(features[:, :, 0]), cmap="jet")
            else:
                axes[i, j].imshow(features[:, :, k], cmap="jet")
            axes[i, j].axis("off")
    return fig
