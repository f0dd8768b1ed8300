"""pixelwiseregression_tpu_torch — the PyTorch + CUDA port of pixelwiseregression_tpu.

The JAX package ``pixelwiseregression_tpu`` stays the reference: every module
here mirrors the module of the same name there and is tested against it on
the same inputs. This package imports ``torch`` and numpy, never ``jax`` and
never the JAX package.

Conventions:

- the model is NCHW inside (cuDNN's layout); public functions that mirror a
  JAX function keep its layout (NHWC maps), so the two compare like with like;
- params are f32; under bf16 activations the casts sit where the JAX package
  puts them (conv operands in the activation dtype, norm statistics and the
  decoder in f32);
- every function that makes tensors takes an explicit ``device``;
- hand-written CUDA kernels live in ``csrc/``; they are compiled with ``nvcc``
  at first use into ``_build/`` and bound with ctypes. Each wrapper runs the
  kernel's plain PyTorch version for CPU tensors only.
"""

__version__ = "0.1.0"
