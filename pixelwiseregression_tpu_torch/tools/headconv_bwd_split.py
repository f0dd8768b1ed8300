"""The head unit's backward split into dx, dW and the norm chain (the port
of the JAX package's ``tools/headconv_bwd_split.py``).

One head unit, the shape of ``stages.{0,1}.{plane,depth}_regression``'s
first three convs: a 3x3 conv 128->128 at 64x64, batch 128, bf16
activations and f32 weights, then the model's instance norm
(``models/layers._InstanceNormFn``, its hand backward) and relu. The loss
is ``sum(f(x) * r)`` for a fixed bf16 ``r``. Variants:

  fwd        the unit's forward, conv + norm + relu
  convpair   the conv's backward: dx and dW
  dx_only    the input gradient alone
  dw_only    the kernel gradient alone
  unit_bwd   the unit's backward: dx, dW, dscale, dbias (what the train
             profile attributes to a head unit's conv, norm and relu)
  normrelu   the norm + relu backward alone
  dw_dot9    dW as nine shifted ``torch.matmul``s, one [Ci, B*H*W] x
             [B*H*W, Co] product a tap, as the JAX tool computes them
             outside any Pallas kernel (bf16 products, rounded to bf16
             where JAX keeps them in f32: the outputs are [C, C])

The conv is cuDNN's (``normrelu_bwd_ab.conv``: NHWC tensors as NCHW views,
channels_last). Timing, bounds and launch checks (none: no kernel of the
port runs here): ``tools/ab_common.py``. After the table, the JAX tool's
two lines: convpair + normrelu against unit_bwd, and dx + dw against
dw_dot9.

Run: python -m pixelwiseregression_tpu_torch.tools.headconv_bwd_split
         [--batch 128] [--iters 24] [--rounds 4] [--device cuda|cpu]
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from pixelwiseregression_tpu_torch.tools import ab_common
from pixelwiseregression_tpu_torch.tools.ab_common import Variant
from pixelwiseregression_tpu_torch.tools.normrelu_bwd_ab import EPS, conv
from pixelwiseregression_tpu_torch.models.layers import _InstanceNormFn

H = W = 64
C = 128
VARIANTS = ("fwd", "convpair", "dx_only", "dw_only", "unit_bwd", "normrelu", "dw_dot9")


def normrelu(x, scale, bias):
    """relu over the model's instance norm of NHWC ``x``: f32 NHWC out, as
    the JAX ``relu(_instance_norm(...))``."""
    y, _ = _InstanceNormFn.apply(x.permute(0, 3, 1, 2), scale, bias, None, "instance", EPS)
    return torch.relu(y).permute(0, 2, 3, 1)


def unit(x, w, scale, bias):
    """conv -> norm -> relu, in x's dtype (NHWC in and out)."""
    return normrelu(conv(x, w), scale, bias).to(x.dtype)


def _dot(a, b):
    return torch.sum(a.float() * b.float())


def dw_dot9(x, dy):
    """dW ``[3, 3, Ci, Co]`` of the 3x3 conv of NHWC ``x`` given its output
    gradient ``dy``: ``dW[i, j] = sum_{b,h,w} x_pad[b, h+i, w+j, :]^T dy[b, h, w, :]``."""
    b, h, w, c = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    g = dy.reshape(-1, dy.shape[-1])
    return torch.stack([torch.stack([
        torch.matmul(xp[:, i:i + h, j:j + w, :].reshape(-1, c).t(), g).float()
        for j in range(3)]) for i in range(3)])


def values(name, x, w, scale, bias, r):
    """What the variant ``name`` computes on these inputs (x, r NHWC; w
    HWIO): the forward's sum, or the gradients of ``sum(f * r)``."""
    def grads(loss, leaves):
        leaves = [t.detach().requires_grad_(True) for t in leaves]
        return list(torch.autograd.grad(loss(*leaves), leaves))

    if name == "fwd":
        with torch.no_grad():
            return [unit(x, w, scale, bias).float().sum()]
    if name == "convpair":
        return grads(lambda x_, w_: _dot(conv(x_, w_), r), (x, w))
    if name == "dx_only":
        return grads(lambda x_: _dot(conv(x_, w), r), (x,))
    if name == "dw_only":
        return grads(lambda w_: _dot(conv(x, w_), r), (w,))
    if name == "unit_bwd":
        return grads(lambda *t: _dot(unit(*t), r), (x, w, scale, bias))
    if name == "normrelu":
        return grads(lambda x_, s, b: _dot(normrelu(x_, s, b), r), (x, scale, bias))
    if name == "dw_dot9":
        return [dw_dot9(x, r)]
    raise KeyError(name)


def inputs(batch, device, seed=0, side=H, channels=C, dtype=torch.bfloat16):
    """x and r ``[batch, side, side, channels]`` in ``dtype``, w 0.05 *
    normal ``[3, 3, C, C]`` f32, scale 1, bias 0, from numpy with ``seed``."""
    rng = np.random.RandomState(seed)

    def put(a, dt=torch.float32):
        return torch.from_numpy(a.astype(np.float32)).to(device, dt)

    x = put(rng.randn(batch, side, side, channels), dtype)
    w = put(rng.randn(3, 3, channels, channels) * 0.05)
    r = put(rng.randn(batch, side, side, channels), dtype)
    return x, w, torch.ones(channels, device=device), torch.zeros(channels, device=device), r


def build_variants(batch: int, device: torch.device, seed: int = 0) -> dict:
    """The variants at [batch, 64, 64, 128] with their bounds: a conv's
    operations 2*9*C a pixel and channel, x, r and dx bf16 and w, dW f32
    read or written once each."""
    x, w, scale, bias, r = inputs(batch, device, seed)
    n = batch * H * W * C
    act, wb, ops = 2 * n, 4 * 9 * C * C, 2 * 9 * C * n
    bounds = {"fwd": (ops, 2 * act + wb), "convpair": (2 * ops, 3 * act + 2 * wb),
              "dx_only": (ops, 2 * act + wb), "dw_only": (ops, 2 * act + wb),
              "unit_bwd": (3 * ops, 3 * act + 2 * wb), "normrelu": (0, 3 * act),
              "dw_dot9": (ops, 2 * act + wb)}
    return {name: Variant(lambda name=name: values(name, x, w, scale, bias, r),
                          bound_s=ab_common.bound_seconds(*bounds[name]))
            for name in VARIANTS}


def summary(ms: dict, batch: int) -> list:
    """The JAX tool's two lines, from ms per call."""
    us = {k: v / batch * 1e3 for k, v in ms.items()}
    add = us["convpair"] + us["normrelu"]
    return [f"  convpair+normrelu = {add:.2f} us/frame vs unit_bwd {us['unit_bwd']:.2f} "
            f"(fusion saves {add - us['unit_bwd']:.2f})",
            f"  dx {us['dx_only']:.2f} + dw {us['dw_only']:.2f} us/frame; dw_dot9 alternative "
            f"{us.get('dw_dot9', float('nan')):.2f}"]


def main(argv=None) -> dict:
    args = ab_common.parser(__doc__, batch=128, iters=24, rounds=4).parse_args(argv)
    device = ab_common.pick_device(args.device)
    print(f"head unit backward split, [{args.batch},{H},{W},{C}] bf16, 3x3 {C}->{C}:", flush=True)
    out = ab_common.run(build_variants(args.batch, device), device, args.iters, args.rounds,
                        args.batch, width=9)
    out["summary"] = summary(out["ms"], args.batch)
    for line in out["summary"]:
        print(line, flush=True)
    return out


if __name__ == "__main__":
    main()
