"""The port's float32 rule on the card: an f32 model runs in f32.

cuDNN's convs and cuBLAS's products on an Ampere or later card round f32
operands to TF32 by default (cuDNN's flag is on in PyTorch). Every entry
point that builds or loads a model calls ``tf32_off`` first, so that an f32
model trains, serves and tests in f32, as its JAX counterpart does on the
CPU.
"""

from __future__ import annotations

import torch


def tf32_off() -> None:
    """Set ``torch.backends.cudnn.allow_tf32`` and
    ``torch.backends.cuda.matmul.allow_tf32`` to False."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
