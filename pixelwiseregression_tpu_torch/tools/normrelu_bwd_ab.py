"""A/B of the norm+relu backward engines on the head-unit shape (the port of
the JAX package's ``tools/normrelu_bwd_ab.py``; the path of K5).

Each variant is one forward and backward: the gradients of
``sum(f(x) * r)`` with respect to the input, the norm's scale and bias (and
the conv weight in the ``unit_*`` variants), at [batch, 64, 64, 128] bf16
activations with f32 parameters (the shape of the head units' 3x3 conv
128->128 at 64x64, batch 128 by default):

  normrelu_composed  relu over ``models/layers._InstanceNormFn`` on an
                     NHWC view: the model's own norm with its hand
                     backward, then relu's (the JAX ``normrelu_xla``)
  normrelu_fused     one autograd.Function over relu(norm(x)), backward in
                     plain PyTorch: the mask recomputed from the saved x
                     (``ops/fused_normrelu.norm_relu``)
  normrelu_cuda      the same forward, backward K5
                     (``ops/cuda_normrelu.norm_relu_cuda``; the JAX
                     ``normrelu_pal1`` and ``normrelu_pal8``, whose samples
                     per grid step have no counterpart)
  normrelu_aten      autograd of ``F.relu(F.instance_norm(...))``: a
                     library yardstick, not part of the port
  unit_composed      ``F.conv2d`` 3x3 (cuDNN, channels_last) then
                     normrelu_composed
  unit_fused         the conv then normrelu_fused
  unit_cuda          the conv then normrelu_cuda (the JAX ``unit_pal8``)

The JAX tool's scalar sum of the gradients (a ``lax.scan`` needs a scalar)
has no counterpart. Timing and launch checks: ``tools/ab_common.py``.

Run: python -m pixelwiseregression_tpu_torch.tools.normrelu_bwd_ab
         [--batch 128] [--iters 24] [--rounds 4] [--device cuda|cpu]
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from pixelwiseregression_tpu_torch.models.layers import _InstanceNormFn
from pixelwiseregression_tpu_torch.ops.cuda_normrelu import norm_relu_cuda
from pixelwiseregression_tpu_torch.ops.fused_normrelu import norm_relu
from pixelwiseregression_tpu_torch.tools import ab_common
from pixelwiseregression_tpu_torch.tools.ab_common import Variant

EPS = 1e-5
H = W = 64
C = 128
VARIANTS = ("normrelu_composed", "normrelu_fused", "normrelu_cuda", "normrelu_aten",
            "unit_composed", "unit_fused", "unit_cuda")


def composed(x, scale, bias, eps=EPS):
    """relu over the model's instance norm (NCHW inside), on NHWC ``x``."""
    y32, _ = _InstanceNormFn.apply(x.permute(0, 3, 1, 2), scale, bias, None, "instance", eps)
    return torch.relu(y32.to(x.dtype)).permute(0, 2, 3, 1)


def aten(x, scale, bias, eps=EPS):
    """``relu(F.instance_norm(x))`` on NHWC ``x`` (ATen's own backward)."""
    return F.relu(F.instance_norm(x.permute(0, 3, 1, 2), weight=scale, bias=bias,
                                  eps=eps)).permute(0, 2, 3, 1)


def conv(x, w_hwio):
    """3x3 stride-1 zero-padded conv of NHWC ``x`` with an HWIO kernel cast
    to x's dtype (cuDNN, channels_last); NHWC out."""
    w = w_hwio.permute(3, 2, 0, 1).to(x.dtype).contiguous(memory_format=torch.channels_last)
    return F.conv2d(x.permute(0, 3, 1, 2), w, padding=1).permute(0, 2, 3, 1).contiguous()


def build_variants(batch: int, device: torch.device, seed: int = 0) -> dict:
    """The variants at [batch, 64, 64, 128], inputs from numpy with ``seed``
    (x and r bf16, w 0.05*normal f32 HWIO, scale 1, bias 0)."""
    rng = np.random.RandomState(seed)

    def put(a, dtype=torch.float32):
        return torch.from_numpy(a.astype(np.float32)).to(device, dtype)

    x0 = put(rng.randn(batch, H, W, C), torch.bfloat16)
    w0 = put(rng.randn(3, 3, C, C) * 0.05)
    r = put(rng.randn(batch, H, W, C), torch.bfloat16)
    scale = torch.ones(C, device=device)
    bias = torch.zeros(C, device=device)
    n = batch * H * W * C

    def grads(nr, with_conv):
        def call():
            leaves = [t.detach().requires_grad_(True)
                      for t in ((x0, w0, scale, bias) if with_conv else (x0, scale, bias))]
            h = conv(leaves[0], leaves[1]) if with_conv else leaves[0]
            return torch.autograd.grad(nr(h, *leaves[-2:]), leaves, r)
        return call

    # fwd + bwd of relu(norm): x and r read, dx written (the norm's own
    # statistics and the parameters' gradients are small); a unit adds
    # three 3x3 convs' operations (forward, dx, dw) and w and dw
    nr_bound = ab_common.bound_seconds(0, 3 * 2 * n)
    unit_bound = ab_common.bound_seconds(3 * 2 * n * 9 * C, 3 * 2 * n + 2 * 4 * 9 * C * C)
    engines = {"composed": composed, "fused": norm_relu, "cuda": norm_relu_cuda, "aten": aten}
    out = {}
    for name in VARIANTS:
        kind, engine = name.split("_")
        unit = kind == "unit"
        out[name] = Variant(grads(engines[engine], unit),
                            launches={"K5": 1} if engine == "cuda" else {},
                            bound_s=unit_bound if unit else nr_bound)
    out["normrelu_cuda"].note = ab_common.no_counterpart(
        "the JAX bt (samples per grid step: normrelu_pal1, normrelu_pal8)",
        "one K5 launch over the batch")
    return out


def main(argv=None) -> dict:
    args = ab_common.parser(__doc__, batch=128, iters=24, rounds=4).parse_args(argv)
    device = ab_common.pick_device(args.device)
    print(f"norm+relu backward A/B, [{args.batch},{H},{W},{C}] bf16:", flush=True)
    out = ab_common.run(build_variants(args.batch, device), device, args.iters, args.rounds,
                        args.batch)
    ms = out["ms"]
    for base, prefix in (("normrelu_composed", "normrelu_"), ("unit_composed", "unit_")):
        for name, t in ms.items():
            if name.startswith(prefix) and name != base:
                print(f"  {name}: {t:.5f} vs composed {ms[base]:.5f} ms "
                      f"({(ms[base] - t) / ms[base] * 100:+.1f}%)", flush=True)
    return out


if __name__ == "__main__":
    main()
