"""Fused soft-argmax decoder forward as a hand-written CUDA kernel for Hopper
(counterpart of ``pixelwiseregression_tpu/ops/pallas_softargmax.py``).

The kernel (``csrc/softargmax_fwd.cu``) is compiled with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface the first time it
is needed, cached under ``_build/`` by the hash of its source, and bound with
ctypes. A build or load failure raises.

Wrappers, and what they do with each tensor:

* CPU tensors go to the plain PyTorch version (``ops/softargmax.py``);
* CUDA tensors launch the kernel or raise; there is no fallback;
* an input that requires grad raises while autograd is on: the backward
  kernel is not ported yet.

``LAUNCHES`` counts kernel launches, so a run can show that its main path
went through the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from pixelwiseregression_tpu_torch.ops.softargmax import (
    _to_flat,
    soft_argmax_decode,
    soft_argmax_decode_flat,
)

LAUNCHES = 0

_PKG = Path(__file__).resolve().parent.parent
_SOURCE = _PKG / "csrc" / "softargmax_fwd.cu"
_BUILD_DIR = _PKG / "_build"
_DTYPES = (torch.float32, torch.bfloat16)
_lib = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def build() -> tuple[Path, str]:
    """Compile the kernel if its source changed; returns (library, compiler log).

    The log holds ``-Xptxas -v``'s registers, shared memory and spills for a
    fresh build, and is empty when the cached library was current.
    """
    digest = hashlib.sha256(_SOURCE.read_bytes()).hexdigest()[:16]
    lib = _BUILD_DIR / f"libsoftargmax_fwd_{digest}.so"
    if lib.exists():
        return lib, ""
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = _BUILD_DIR / f"{lib.name}.{os.getpid()}.tmp"
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp), str(_SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib, proc.stdout + proc.stderr


def _load():
    global _lib
    if _lib is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        fn = lib.softargmax_fwd
        # (in_bf16, hm_bf16, x, dm, label, mask, w, hm, uvd, B, J, H, W, stream)
        fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(x, dm, label, mask, w, h, wd, hm_dtype):
    b, j, hw = x.shape
    if hw != h * wd:
        raise ValueError(f"maps hold {hw} pixels per row, not {h}x{wd}")
    if dm.shape != x.shape or label.shape != (b, 1, hw) or mask.shape != (b, 1, hw):
        raise ValueError(f"shapes x {tuple(x.shape)} dm {tuple(dm.shape)} "
                         f"label {tuple(label.shape)} mask {tuple(mask.shape)}")
    if w.shape != (j,) or w.dtype != torch.float32:
        raise ValueError(f"w must be f32 [{j}], got {w.dtype} {tuple(w.shape)}")
    if x.dtype not in _DTYPES or hm_dtype not in _DTYPES:
        raise TypeError(f"kernel takes f32 or bf16 maps, got {x.dtype} -> {hm_dtype}")
    if any(t.dtype != x.dtype for t in (dm, label, mask)):
        raise TypeError("x, dm, label and mask must share one dtype")
    if b * j == 0 or hw % 8 != 0 or h + wd > 12288:
        raise ValueError(f"kernel needs B*J > 0, H*W % 8 == 0 and small H+W, got {b}x{j}x{h}x{wd}")
    for t in (x, dm, label, mask, w):
        if t.device != x.device:
            raise ValueError(f"tensors on {x.device} and {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("kernel needs contiguous, 16-byte aligned tensors")


def decode_flat(x, dm, label, mask, w, h: int, wd: int, hm_dtype=torch.float32):
    """Softmax decode of ``[B, J, H*W]`` rows: the model's entry.

    ``x``, ``dm``: ``[B, J, H*W]``; ``label``, ``mask``: ``[B, 1, H*W]``, all
    in one dtype (f32 or bf16); ``w``: ``[J]`` f32. Returns heatmaps
    ``[B, J, H*W]`` in ``hm_dtype`` and uvd ``[B, J, 3]`` f32, computed in f32.
    """
    global LAUNCHES
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dm, label, mask, w)):
        raise RuntimeError("decode_flat is forward only: its backward kernel is not ported yet")
    if all(t.device.type == "cpu" for t in (x, dm, label, mask, w)):
        hm, uvd = soft_argmax_decode_flat(x, dm, label, mask, w, h, wd)
        return hm.to(hm_dtype), uvd
    if x.device.type != "cuda":
        raise ValueError(f"decode_flat runs on CPU or CUDA tensors, not {x.device}")
    _check(x, dm, label, mask, w, h, wd, hm_dtype)
    b, j, hw = x.shape
    hm = torch.empty((b, j, hw), dtype=hm_dtype, device=x.device)
    uvd = torch.empty((b, j, 3), dtype=torch.float32, device=x.device)
    rc = _load().softargmax_fwd(
        int(x.dtype == torch.bfloat16), int(hm_dtype == torch.bfloat16),
        x.data_ptr(), dm.data_ptr(), label.data_ptr(), mask.data_ptr(), w.data_ptr(),
        hm.data_ptr(), uvd.data_ptr(), b, j, h, wd,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"softargmax_fwd launch failed with cudaError {rc}")
    LAUNCHES += 1
    return hm, uvd


def soft_argmax_decode_cuda(logits, depthmaps, label_img, mask, w,
                            method: str = "softmax", fast_boundary: bool = False):
    """Drop-in for ``ops.softargmax.soft_argmax_decode``, as
    ``soft_argmax_decode_pallas`` is in the JAX package.

    Maps NHWC ``[B, H, W, J]``, label/mask ``[B, H, W, 1]``, ``w`` ``[J]``;
    returns heatmaps ``[B, H, W, J]`` and uvd ``[B, J, 3]`` f32.
    ``fast_boundary=True`` keeps the maps in their own dtype (bf16 under
    mixed precision) and returns heatmaps in it; otherwise maps go in and
    come out as f32. The ``sum`` method runs the plain version.
    """
    if method != "softmax":
        return soft_argmax_decode(logits, depthmaps, label_img, mask, w, method)
    b, h, wd, j = logits.shape
    map_dtype = logits.dtype if fast_boundary else torch.float32

    def flat(t):
        return _to_flat(t.to(map_dtype)).contiguous()

    hm, uvd = decode_flat(flat(logits), flat(depthmaps), flat(label_img), flat(mask),
                          w.to(torch.float32), h, wd, hm_dtype=map_dtype)
    return hm.transpose(1, 2).reshape(b, h, wd, j), uvd
