"""The heads' 3x3 conv in float32 as a hand-written CUDA kernel for Hopper,
``csrc/conv3x3_f32.cu``: an FFMA implicit GEMM on NCHW tensors. No TPU
kernel corresponds to it (the JAX package leaves its convs to XLA); cuDNN
runs these convs in f32 by its FFT algorithm, far below the card's f32 rate.

The conv is a registered operator, ``torch.ops.pwr.conv3x3_f32(x, weight,
bias)``, so that ``torch.export`` keeps it as one node of an exported
program (its shapes from ``register_fake``):

* CPU tensors take ``F.conv2d(x, weight, bias, 1, 1)``, the plain version;
* CUDA tensors launch the kernel or raise; there is no fallback;
* its backward (``register_autograd``) is ATen's ``convolution_backward``
  with the arguments autograd passes for ``F.conv2d``, so the gradients are
  cuDNN's, as they were before the forward went through the kernel.

``layers.Conv`` takes the operator by shape alone (``fits`` and
``takes``); every other conv keeps ``F.conv2d``. ``LAUNCHES`` counts the
calls that launched the kernel.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from pixelwiseregression_tpu_torch.ops import cuda_lib

LAUNCHES = 0

# output channels a block of the kernel; the rule asks the same of the input
TILE = 128
# the row width the kernel takes (two rows a block)
WIDTH = 64

_P, _I = ctypes.c_void_p, ctypes.c_int
# (x, wt, bias, y, B, C, K, H, W, stream)
_ARGTYPES = [_P] * 4 + [_I] * 5 + [_P]


def fits(in_channels: int, out_channels: int, kernel_size, stride, padding) -> bool:
    """The module's half of the rule: a 3x3 conv, stride 1, padding 1, whose
    input and output channels are multiples of ``TILE``."""
    return (tuple(kernel_size) == (3, 3) and tuple(stride) == (1, 1)
            and tuple(padding) == (1, 1)
            and in_channels % TILE == 0 and out_channels % TILE == 0)


def takes(x: torch.Tensor) -> bool:
    """The input's half: float32, contiguous NCHW, rows ``WIDTH`` wide, an
    even number of them."""
    return (x.dtype == torch.float32 and x.dim() == 4 and x.shape[3] == WIDTH
            and x.shape[2] % 2 == 0 and x.is_contiguous())


def _check(x, weight, bias):
    b, c, h, w = x.shape
    k = weight.shape[0]
    if any(t.dtype != torch.float32 for t in (x, weight, bias)):
        raise TypeError(f"the kernel takes f32, got {x.dtype} {weight.dtype} {bias.dtype}")
    if weight.shape != (k, c, 3, 3) or bias.shape != (k,):
        raise ValueError(f"weight {tuple(weight.shape)} and bias {tuple(bias.shape)} for "
                         f"{c} input channels")
    if not (fits(c, k, (3, 3), (1, 1), (1, 1)) and takes(x)) or b == 0:
        raise ValueError(f"the kernel takes [B, C, H, {WIDTH}] with H even and C, K multiples "
                         f"of {TILE}, got x {tuple(x.shape)} -> {k}")
    for t in (x, bias):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("kernel needs contiguous, 16-byte aligned tensors")


@torch.library.custom_op("pwr::conv3x3_f32", mutates_args=())
def conv3x3_f32(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``F.conv2d(x, weight, bias, stride 1, padding 1)`` as a registered
    operator, ``pwr::conv3x3_f32``: the kernel for CUDA tensors
    (``_conv3x3_f32_cuda``), and this, the plain version, for CPU tensors."""
    cuda_lib.on_cpu("the 3x3 conv", [x, weight, bias])
    return F.conv2d(x, weight, bias, 1, 1)


@conv3x3_f32.register_kernel("cuda")
def _conv3x3_f32_cuda(x, weight, bias):
    """The kernel: checks the tensors, lays the weight out as
    ``[K / TILE][C * 9][TILE]``, launches, raises on a launch error."""
    global LAUNCHES
    cuda_lib.on_cpu("the 3x3 conv", [x, weight, bias])
    _check(x, weight, bias)
    b, c, h, w = x.shape
    k = weight.shape[0]
    wt = weight.reshape(k // TILE, TILE, c * 9).transpose(1, 2).contiguous()
    y = torch.empty((b, k, h, w), dtype=torch.float32, device=x.device)
    rc = cuda_lib.function("conv3x3_f32", _ARGTYPES)(
        x.data_ptr(), wt.data_ptr(), bias.data_ptr(), y.data_ptr(), b, c, k, h, w,
        torch.cuda.current_stream(x.device).cuda_stream)
    cuda_lib.check(rc, "conv3x3_f32")
    LAUNCHES += 1
    return y


@conv3x3_f32.register_fake
def _conv3x3_f32_fake(x, weight, bias):
    return x.new_empty((x.shape[0], weight.shape[0], x.shape[2], x.shape[3]))


def _setup_context(ctx, inputs, output):
    x, weight, _ = inputs
    ctx.save_for_backward(x, weight)


def _backward(ctx, grad):
    x, weight = ctx.saved_tensors
    return torch.ops.aten.convolution_backward(
        grad, x, weight, [weight.shape[0]], [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
        list(ctx.needs_input_grad))


conv3x3_f32.register_autograd(_backward, setup_context=_setup_context)
