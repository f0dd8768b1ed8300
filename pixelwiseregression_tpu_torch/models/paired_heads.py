"""Paired evaluation of the plane and depth heads at inference
(mirrors ``pixelwiseregression_tpu/models/paired_heads.py``).

Both heads read the same hourglass output. ``paired_heads_apply`` runs the
two ``_Head`` modules as one computation on their own, unchanged
parameters (the state dict stays the unpaired model's; the weights are
concatenated at apply time):

* ``conv_0``: one conv with ``2C`` outputs on the shared input, then one
  norm over the concatenated channels with the concatenated scale, bias
  and debiased anchors (the statistics are per channel, so this is
  exact);
* ``conv_1/2``: ``separate`` (each head its own conv on its half) or
  ``grouped`` (one conv with ``groups=2``);
* ``conv_3``: ``separate``, or ``blockdiag``: one conv with a
  ``[2J, 2C, k, k]`` block-diagonal weight whose zero blocks add exact
  zeros.

Every output channel keeps its own contraction set, so the paired heads
part from the plain ones only by the conv's summation order. The convs are
``F.conv2d`` (cuDNN on the card): the JAX package computes them with
``lax.conv`` outside any Pallas kernel. The decoder that reads the maps is
the model's own (K1 on the card).

The JAX docstring's verdict (measured slower than the plain heads, and off
by default) is a v5e measurement; ``tools/bench_paired_model.py`` measures
the same A/B on the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pixelwiseregression_tpu_torch.models.layers import InstanceNorm, _InstanceNormFn

MIDS = ("separate", "grouped")
FINALS = ("blockdiag", "separate")


def _parts(head):
    """A ``_Head``'s four convs and three norms, in order."""
    seq = head.conv
    return [seq[i] for i in (0, 3, 6, 9)], [seq[i] for i in (1, 4, 7)]


def pairable(head) -> bool:
    """Whether a head's norms take the paired path: instance norms of any
    method (JAX ``use_paired``). Uncalibrated or absent anchors need no
    fallback: ``_norm_relu`` then uses the anchors the plain norm uses (0
    while ``anchor_n`` is 0, the two-pass form without them)."""
    _, norms = _parts(head)
    return all(isinstance(n, InstanceNorm) for n in norms)


def _conv(x, conv, weight=None, bias=None, groups: int = 1):
    """``layers.Conv``'s full-precision forward, with the given weight and bias
    (default: the module's own) cast to x's dtype."""
    w = conv.weight if weight is None else weight
    b = conv.bias if bias is None else bias
    return F.conv2d(x, w.to(x.dtype), b.to(x.dtype), 1, conv.padding, 1, groups)


def _debiased(norm):
    debias = 1.0 - torch.pow(norm.anchor_momentum, norm.anchor_n)
    return torch.where(debias > 0, norm.anchor / torch.clamp_min(debias, 1e-12), 0.0)


def _norm_relu(h, norms):
    """One ``InstanceNorm`` over channels concatenated from ``norms`` (each
    over its own slice), then relu; ``InstanceNorm.forward``'s arithmetic."""
    n0 = norms[0]
    weight = torch.cat([n.weight for n in norms])
    bias = torch.cat([n.bias for n in norms])
    anchor = None
    if n0.method == "instance_anchored" and n0.anchor is not None:
        anchor = torch.cat([_debiased(n) for n in norms])
    y, _ = _InstanceNormFn.apply(h, weight, bias, anchor, n0.method, n0.eps)
    return torch.relu(y.to(h.dtype))


def paired_heads_apply(f, plane, depth, mid: str = "separate", final: str = "blockdiag"):
    """Evaluate the ``plane`` and ``depth`` ``_Head``s on ``f`` ``[B, C, H, W]``;
    returns ``(logits, depthmaps)``, each ``[B, J, H, W]``, as the two heads'
    own forwards give them up to the conv's summation order."""
    if mid not in MIDS or final not in FINALS:
        raise ValueError(f"unknown pairing {mid!r}/{final!r}")
    (pc, pn), (dc, dn) = _parts(plane), _parts(depth)
    c = pc[0].out_channels

    w0 = torch.cat([pc[0].weight, dc[0].weight])
    b0 = torch.cat([pc[0].bias, dc[0].bias])
    h = _norm_relu(_conv(f, pc[0], w0, b0), [pn[0], dn[0]])

    if mid == "grouped":
        for i in (1, 2):
            wi = torch.cat([pc[i].weight, dc[i].weight])
            bi = torch.cat([pc[i].bias, dc[i].bias])
            h = _norm_relu(_conv(h, pc[i], wi, bi, groups=2), [pn[i], dn[i]])
        hp, hd = h[:, :c], h[:, c:]
    else:
        hp, hd = h[:, :c], h[:, c:]
        for i in (1, 2):
            hp = _norm_relu(_conv(hp, pc[i]), [pn[i]])
            hd = _norm_relu(_conv(hd, dc[i]), [dn[i]])

    if final == "blockdiag":
        kp, kd = pc[3].weight, dc[3].weight
        j = kp.shape[0]
        zeros = kp.new_zeros((j, c) + tuple(kp.shape[2:]))
        w3 = torch.cat([torch.cat([kp, zeros], dim=1),    # out 0:J  <- in 0:C
                        torch.cat([zeros, kd], dim=1)])   # out J:2J <- in C:2C
        b3 = torch.cat([pc[3].bias, dc[3].bias])
        z = _conv(torch.cat([hp, hd], dim=1) if mid == "separate" else h, pc[3], w3, b3)
        return z[:, :j], z[:, j:]
    return _conv(hp, pc[3]), _conv(hd, dc[3])
