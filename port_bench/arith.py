"""The yardstick's arithmetic: operations of a forward from the
configuration's shapes, bytes of the decoder kernels' calls, and the H100's
peaks. Copied from the port (``bench.conv_flops``, ``tools/ab_common``'s
``PEAK_FLOPS`` and the byte counts behind the kernel table's ``bound_ms``)
so that it does not move when the port does.

A forward's FLOP are ``2 * k * k * C_in * C_out * (output pixels)`` over
every conv at the resolution it runs at, plus ``2 * in * out`` over every
dense layer: bias adds, norms, pooling and the decoder are not counted, so
a train step's ``3 x forward`` is the usual estimate of its products.
"""

from __future__ import annotations

# NVIDIA's data sheet, H100 SXM, dense: bf16 989 TFLOP/s, float32 outside
# the tensor cores 67 TFLOP/s; HBM3 3.35 TB/s
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}
PEAK_BYTES = 3.35e12
DTYPE_BYTES = {"bf16": 2, "f32": 4}


def _conv(cin: int, cout: int, k: int, side: int, stride: int = 1):
    out = (side + 2 * (k // 2) - k) // stride + 1
    return 2 * k * k * cin * cout * out * out, out


def _resblock(f: int, side: int) -> int:
    h = f // 2
    return _conv(f, h, 1, side)[0] + _conv(h, h, 3, side)[0] + _conv(h, f, 1, side)[0]


def _hourglass(f: int, level: int, side: int) -> int:
    inner = _hourglass(f, level - 1, side // 2) if level > 0 else _resblock(f, side // 2)
    return _resblock(f, side) + inner + _resblock(f, side // 2)


def forward_flops(cfg: dict) -> float:
    """FLOP of one frame's forward, all stages, from ``cfg["model"]``."""
    m = cfg["model"]
    f, j, side = m["features"], m["joints"], m["image_size"]
    full = m["class"] == "FullRegression"
    k = 3 if full else m["filter_size"]
    widths = [32]
    while widths[-1] < f:
        widths.append(2 * widths[-1] if full else min(2 * widths[-1], f))
    total, cin = 0, 1
    for w in widths:
        total += _conv(cin, w, k, side)[0]
        cin = w
    t, side = _conv(cin, f, k, side, 2)
    total += t
    for s in range(m["stages"]):
        if full:
            cin = f if s == 0 else f + 1
            total += _conv(cin, f, 1, side)[0] + _hourglass(f, 4, side)
            d = side
            for _ in range(3):
                t, d = _conv(f, f, 3, d, 2)
                total += t
            total += 2 * (f * d * d * 1024 + 1024 * 1024 + 1024 * 3 * j)
        else:
            cin = f if s == 0 else 2 * j + 1
            total += _conv(cin, f, 1, side)[0] + _hourglass(f, m["level"], side)
            for out in (j, j):
                total += 3 * _conv(f, f, k, side)[0] + _conv(f, out, k, side)[0]
    return float(total)


def k1_bytes(b: int, j: int, hw: int, in_dtype: str, hm_dtype: str) -> float:
    """The decoder forward (K1): reads the logits and depth maps ``[B, J,
    HW]``, the label image and mask ``[B, 1, HW]`` and the temperature
    ``[J]``; writes the heatmaps ``[B, J, HW]`` and uvd ``[B, J, 3]`` f32."""
    e = DTYPE_BYTES[in_dtype]
    return float(b * j * hw * (2 * e + DTYPE_BYTES[hm_dtype]) + 2 * b * hw * e + 4 * j
                 + 12 * b * j)


def k2_bytes(b: int, j: int, hw: int, dlabel: bool = False) -> float:
    """The decoder backward (K2, f32): reads the logits, depth maps and the
    heatmaps' cotangent ``[B, J, HW]``, label and mask ``[B, 1, HW]``, the
    temperature and uvd's cotangent; writes the logits' and depth maps'
    gradients ``[B, J, HW]`` and per-row temperature gradients ``[B, J]``
    (and, with ``dlabel``, the label's gradient ``[B, 1, HW]``)."""
    return float(4 * (5 * b * j * hw + 2 * b * hw + j + 3 * b * j + b * j
                      + (b * hw if dlabel else 0)))


def roofline_share(nbytes: float, seconds: float) -> float:
    """A call's share of its bandwidth roofline, in %: the least time its
    bytes take at the peak over the time it took."""
    return 100.0 * nbytes / PEAK_BYTES / seconds
