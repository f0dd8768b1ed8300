"""cv2-semantics image ops on tensors (mirrors ``pixelwiseregression_tpu/ops/image.py``).

``cv2.resize`` INTER_LINEAR for float images: source coordinate
``s = (d + 0.5) * (src / dst) - 0.5``, evaluated in f32 in exactly that order
(a float64 or re-associated form moves taps at the edges), with cv2's
coefficient clamping: a floor index below 0 snaps to pixel 0, one at or
beyond ``src - 1`` snaps to pixel ``src - 1``.

``crop_resize`` folds the reference's zero-padded window crop and the resize
into one gather over the full frame. Each sample has its own crop size and
corner, so the JAX package's ``vmap`` becomes a batch dimension of per-sample
tap indices. ``warp_affine_inverse`` and ``gaussian_blur`` come with the
training port.
"""

from __future__ import annotations

import torch


def _resize_taps(out_size: int, src_size: torch.Tensor):
    """Tap indices and weights for one axis of a cv2 INTER_LINEAR resize.

    ``src_size`` is an integer tensor of any shape ``S`` (one source size per
    sample). Returns ``(i0, i1, w1)`` of shape ``S + (out_size,)``: the sample
    is ``v[i0] * (1 - w1) + v[i1] * w1`` with indices clamped to
    ``[0, src_size - 1]`` by cv2's rule.
    """
    src = src_size.to(torch.float32)[..., None]
    d = torch.arange(out_size, dtype=torch.float32, device=src_size.device)
    s = (d + 0.5) * (src / out_size) - 0.5
    i0f = torch.floor(s)
    w1 = s - i0f
    i0 = i0f.to(torch.int64)
    src_i = src_size.to(torch.int64)[..., None]
    w1 = torch.where(i0 < 0, 0.0, w1)
    i0 = torch.clamp_min(i0, 0)
    w1 = torch.where(i0 >= src_i - 1, 1.0, w1)
    i0 = torch.minimum(i0, torch.clamp_min(src_i - 2, 0))
    i1 = torch.minimum(i0 + 1, src_i - 1)
    return i0, i1, w1


def resize_bilinear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """cv2.resize(img, (out_w, out_h)) with INTER_LINEAR over the last two axes."""
    h, w = img.shape[-2:]
    r0, r1, wr = _resize_taps(out_h, torch.tensor(h, device=img.device))
    c0, c1, wc = _resize_taps(out_w, torch.tensor(w, device=img.device))
    rows = img[..., r0, :] * (1.0 - wr)[:, None] + img[..., r1, :] * wr[:, None]
    return rows[..., c0] * (1.0 - wc) + rows[..., c1] * wc


def crop_resize(
    frame: torch.Tensor,
    top: torch.Tensor,
    left: torch.Tensor,
    crop_size: torch.Tensor,
    out_size: int,
) -> torch.Tensor:
    """Zero-padded window crop + cv2 INTER_LINEAR resize as one gather.

    Args:
      frame: ``[B, H, W]`` float frames.
      top, left: ``[B]`` integer crop corners in frame coordinates (may be
        negative or past the frame; those pixels read 0).
      crop_size: ``[B]`` integer side length of each square crop.
      out_size: output side length.

    Returns ``[B, out_size, out_size]``.
    """
    b, h, w = frame.shape
    r0, r1, wr = _resize_taps(out_size, crop_size)  # [B, out]
    c0, c1, wc = _resize_taps(out_size, crop_size)
    top = top.to(torch.int64)[:, None]
    left = left.to(torch.int64)[:, None]

    def gather_rows(i):
        fi = top + i
        ok = (fi >= 0) & (fi < h)
        fi = fi.clamp(0, h - 1)
        vals = torch.gather(frame, 1, fi[:, :, None].expand(b, out_size, w))
        return vals * ok[:, :, None].to(frame.dtype)

    rows = gather_rows(r0) * (1.0 - wr)[:, :, None] + gather_rows(r1) * wr[:, :, None]

    def gather_cols(j):
        fj = left + j
        ok = (fj >= 0) & (fj < w)
        fj = fj.clamp(0, w - 1)
        vals = torch.gather(rows, 2, fj[:, None, :].expand(b, out_size, out_size))
        return vals * ok[:, None, :].to(frame.dtype)

    return gather_cols(c0) * (1.0 - wc)[:, None, :] + gather_cols(c1) * wc[:, None, :]
