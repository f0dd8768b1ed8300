"""Whole-hourglass forward as hand-written CUDA kernels for Hopper
(counterpart of ``pixelwiseregression_tpu/ops/pallas_hourglass.py``; K4).

A level-L hourglass (``models.pixelwise.Hourglass`` in eval mode, instance
norm only): 2L+3 pre-activation bottleneck ResBlocks, 2x2 max-pools,
nearest 2x upsamples and skip adds, on NHWC activations (f32 or bf16), with
the TPU kernel's numerics, which differ from the module's:

* the norm's apply runs in the act dtype: ``a = rsqrt(var+eps)*scale`` and
  ``b = bias - mean*a`` are cast to it, then ``x*a`` and ``+ b`` are each
  rounded to it (``_instance_norm_relu``);
* the 3x3 conv sums its even taps (0, 2, 4, 6, 8) and its odd taps
  (1, 3, 5, 7) apart in f32, casts each sum, and adds the two in f32 with
  the bias (``_conv3x3``);
* 1x1 convs accumulate in f32, add the bias, cast; the residual and the
  upsample skip adds run in the act dtype.

``csrc/hourglass.cu`` holds the kernel (built by ``ops/cuda_lib.py``): a
host-side recursion over the stacked weights launching K3's statistics and
conv kernels and its own pool and upsample-add kernels, since a 64x64x128
sample does not fit an SM the way it fit the TPU's VMEM, down to the first
level whose sub-hourglass fits one block's shared memory (bf16, C a
multiple of 16 and at most 128, at most 256 pixels at that level; the rule
is ``tail::fits`` in ``csrc/hourglass_tail.cu``): that one runs as a single
kernel of one block per sample.

* CPU tensors go to ``hourglass_fused_plain``, the plain PyTorch version;
* CUDA tensors launch the kernel or raise; there is no fallback.

The JAX function's ``block_batch`` (samples per grid step in VMEM) has no
counterpart: every kernel here spans the whole batch.

``LAUNCHES`` counts ``hourglass_fused`` calls that launched the kernel.
Each call adds what ``hourglass_fwd`` reports it launched: every kernel to
``KERNEL_LAUNCHES``, the one-block-per-sample tail kernels to
``TAIL_LAUNCHES``; ``TAIL_SMEM_BYTES`` is the shared memory a block of the
last tail launched.
"""

from __future__ import annotations

import ctypes

import torch

from pixelwiseregression_tpu_torch.ops import cuda_lib

LAUNCHES = 0
KERNEL_LAUNCHES = 0
TAIL_LAUNCHES = 0
TAIL_SMEM_BYTES = 0

_EPS = 1e-5
_DTYPES = (torch.float32, torch.bfloat16)
_P, _I = ctypes.c_void_p, ctypes.c_int
_WEIGHTS = ("w0", "w1", "w2")
_PARAMS = ("b0", "b1", "b2", "s0", "sb0", "s1", "sb1", "s2", "sb2")
_ARGTYPES = {
    # (bf16, B, H, W, C, level)
    "hourglass_workspace_bytes": [_I] * 6,
    # (bf16, x, out, w0, w1, w2, b0, b1, b2, s0, sb0, s1, sb1, s2, sb2, workspace,
    #  B, H, W, C, level, stream, launched[3])
    "hourglass_fwd": [_I] + [_P] * 15 + [_I] * 5 + [_P, _P],
}


def num_resblocks(level: int) -> int:
    """ResBlocks in a level-L hourglass: 2 per level + 3 at the bottom."""
    return 2 * level + 3


def stack_hourglass_params(hourglass, level: int) -> dict:
    """Stack the ResBlocks of an ``models.pixelwise.Hourglass`` into
    per-role f32 tensors with a leading block axis, in the kernel's
    traversal order (input_conv, inner..., output_conv), as
    ``pallas_hourglass.stack_hourglass_params`` does for the flax tree.

    Returns ``w0 [N,C,C/2]``, ``w1 [N,3,3,C/2,C/2]`` (HWIO), ``w2 [N,C/2,C]``,
    ``b0``/``b1 [N,C/2]``, ``b2 [N,C]``, and the norms' scale and bias
    ``s0``/``sb0 [N,C]``, ``s1``/``sb1``/``s2``/``sb2 [N,C/2]``.
    """
    blocks = []

    def visit(m, lv):
        blocks.append(m.input_conv)
        if lv > 0:
            visit(m.inner, lv - 1)
        else:
            blocks.append(m.inner)
        blocks.append(m.output_conv)

    visit(hourglass, level)

    def stack(i, leaf):
        # ResBlock.conv: [norm, relu, conv1x1, norm, relu, conv3x3, norm, relu, conv1x1]
        return torch.stack([getattr(b.conv[i], leaf).detach().float() for b in blocks])

    return {
        "w0": stack(2, "weight")[:, :, :, 0, 0].transpose(1, 2).contiguous(),
        "w1": stack(5, "weight").permute(0, 3, 4, 2, 1).contiguous(),
        "w2": stack(8, "weight")[:, :, :, 0, 0].transpose(1, 2).contiguous(),
        "b0": stack(2, "bias"), "b1": stack(5, "bias"), "b2": stack(8, "bias"),
        "s0": stack(0, "weight"), "sb0": stack(0, "bias"),
        "s1": stack(3, "weight"), "sb1": stack(3, "bias"),
        "s2": stack(6, "weight"), "sb2": stack(6, "bias"),
    }


def _norm_relu_act(x, scale, bias):
    """``_instance_norm_relu``: f32 two-pass statistics over H and W, the
    apply in x's dtype."""
    x32 = x.float()
    mean = x32.mean(dim=(1, 2), keepdim=True)
    var = torch.square(x32 - mean).mean(dim=(1, 2), keepdim=True)
    a32 = torch.rsqrt(var + _EPS) * scale
    a = a32.to(x.dtype)
    b = (bias - mean * a32).to(x.dtype)
    return torch.clamp_min(x * a + b, 0.0)


def _dot_c(h, w, b):
    """1x1 conv: f32 products of act-dtype operands, + b, cast."""
    return (h.float() @ w.to(h.dtype).float() + b).to(h.dtype)


def _conv3x3(h, w, b):
    """3x3 zero-padded conv with the even and odd taps summed apart."""
    bsz, hh, ww, _ = h.shape
    hp = torch.nn.functional.pad(h.float(), (0, 0, 1, 1, 1, 1))
    w32 = w.to(h.dtype).float()
    sums = [None, None]
    for t in range(9):
        dy, dx = divmod(t, 3)
        z = hp[:, dy:dy + hh, dx:dx + ww, :] @ w32[dy, dx]
        sums[t % 2] = z if sums[t % 2] is None else sums[t % 2] + z
    even, odd = (s.to(h.dtype).float() for s in sums)
    return (even + odd + b).to(h.dtype)


def hourglass_fused_plain(x, stacked, level: int):
    """The plain PyTorch version of ``hourglass_fused``, with its numerics."""
    idx = [0]

    def p(name):
        return stacked[name][idx[0]].float() if name not in _WEIGHTS else stacked[name][idx[0]]

    def resblock(x):
        h = _norm_relu_act(x, p("s0"), p("sb0"))
        h = _dot_c(h, p("w0"), p("b0"))
        h = _norm_relu_act(h, p("s1"), p("sb1"))
        h = _conv3x3(h, p("w1"), p("b1"))
        h = _norm_relu_act(h, p("s2"), p("sb2"))
        h = _dot_c(h, p("w2"), p("b2"))
        idx[0] += 1
        return x + h

    def pool(x):
        bsz, hh, ww, c = x.shape
        return x.reshape(bsz, hh // 2, 2, ww // 2, 2, c).amax(dim=(2, 4))

    def up2_add(h, skip):
        bsz, hh, ww, c = h.shape
        y = skip.reshape(bsz, hh, 2, ww, 2, c) + h[:, :, None, :, None, :]
        return y.reshape(bsz, 2 * hh, 2 * ww, c)

    def hg(x, lv):
        x = resblock(x)
        h = pool(x)
        h = hg(h, lv - 1) if lv > 0 else resblock(h)
        return up2_add(resblock(h), x)

    return hg(x, level)


def _check(x, stacked, level):
    if x.dtype not in _DTYPES:
        raise TypeError(f"hourglass_fused takes f32 or bf16 activations, got {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"x must be NHWC [B, H, W, C], got {tuple(x.shape)}")
    bsz, h, w, c = x.shape
    step = 2 ** (level + 1)
    if h % step or w % step or c % 16:
        raise ValueError(f"the kernel needs H and W multiples of {step} and C of 16, "
                         f"got {h}x{w}x{c}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be a contiguous, 16-byte aligned NHWC tensor")
    n, ch = num_resblocks(level), c // 2
    shapes = {"w0": (n, c, ch), "w1": (n, 3, 3, ch, ch), "w2": (n, ch, c), "b0": (n, ch),
              "b1": (n, ch), "b2": (n, c), "s0": (n, c), "sb0": (n, c), "s1": (n, ch),
              "sb1": (n, ch), "s2": (n, ch), "sb2": (n, ch)}
    for name, shape in shapes.items():
        t = stacked[name]
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} is {tuple(t.shape)}, level {level} at C={c} needs {shape}")


def hourglass_fused(x, stacked, level: int):
    """Run a level-``level`` hourglass on ``x`` ``[B, H, W, C]``. ``stacked``
    is ``stack_hourglass_params``'s output (conv weights are cast to x's
    dtype; biases and norm parameters stay f32). Semantics of
    ``pallas_hourglass.hourglass_fused``."""
    global LAUNCHES, KERNEL_LAUNCHES, TAIL_LAUNCHES, TAIL_SMEM_BYTES
    if cuda_lib.on_cpu("hourglass_fused", [x, *stacked.values()]):
        return hourglass_fused_plain(x, stacked, level)
    _check(x, stacked, level)
    bsz, h, w, c = x.shape
    bf16 = int(x.dtype == torch.bfloat16)
    ws_bytes = cuda_lib.function("hourglass_workspace_bytes", _ARGTYPES["hourglass_workspace_bytes"],
                                 ctypes.c_size_t)(bf16, bsz, h, w, c, level)
    workspace = torch.empty(ws_bytes, dtype=torch.uint8, device=x.device)
    wts = [stacked[k].to(x.dtype).contiguous() for k in _WEIGHTS]
    params = [stacked[k].to(torch.float32).contiguous() for k in _PARAMS]
    out = torch.empty_like(x)
    launched = (ctypes.c_int * 3)()
    rc = cuda_lib.function("hourglass_fwd", _ARGTYPES["hourglass_fwd"])(
        bf16, x.data_ptr(), out.data_ptr(), *(t.data_ptr() for t in wts + params),
        workspace.data_ptr(), bsz, h, w, c, level, torch.cuda.current_stream(x.device).cuda_stream,
        ctypes.addressof(launched))
    KERNEL_LAUNCHES += launched[0]
    TAIL_LAUNCHES += launched[1]
    if launched[1]:
        TAIL_SMEM_BYTES = launched[2]
    cuda_lib.check(rc, "hourglass_fwd")
    LAUNCHES += 1
    return out
