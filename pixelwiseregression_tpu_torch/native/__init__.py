"""Native (C++) host-side frame decoding, loaded via ctypes
(mirrors ``pixelwiseregression_tpu/native/__init__.py``).

Builds ``frame_ops.cpp`` (a copy of the JAX package's) with g++ on first
use into the port's git-ignored ``_build/``, named by the hash of the
source, never next to the source. Falls back as the JAX module does:
``available()`` returns False if the build fails (no compiler, no zlib),
and callers then take the numpy paths in ``data.sources``. This is a
host-decoder choice with bit-identical results, not a device fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parent / "frame_ops.cpp"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _lib_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return _BUILD_DIR / f"libframe_ops_{digest}.so"


def _build(lib: Path) -> bool:
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-o", tmp, str(_SRC),
           "-lpthread", "-lz"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
    except (OSError, subprocess.SubprocessError):
        if os.path.exists(tmp):
            os.remove(tmp)
        return False
    os.replace(tmp, lib)
    return True


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        path = _lib_path()
        if not path.exists() and not _build(path):
            _build_failed = True
            return None
        lib = ctypes.CDLL(str(path))
        lib.msra_decode_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_int), ctypes.c_int,
        ]
        lib.nyu_pack_batch.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ]
        lib.png16_scale_batch.argtypes = [
            ctypes.POINTER(ctypes.c_uint16), ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ]
        lib.png_decode_depth_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int),
            ctypes.c_int,
        ]
        for fn in (lib.msra_decode_batch, lib.nyu_pack_batch, lib.png16_scale_batch,
                   lib.png_decode_depth_batch):
            fn.restype = None
        _lib = lib
        return lib


def available() -> bool:
    return _load() is not None


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable: g++ could not build frame_ops.cpp")
    return lib


def msra_decode_batch(
    paths: List[str], frame_h: int, frame_w: int, num_threads: int = 0
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Decode a batch of MSRA .bin files -> (frames [n,H,W] f32,
    coms [n,3] f64, status [n] i32; status 0 = ok)."""
    lib = _require()
    n = len(paths)
    if num_threads <= 0:
        num_threads = min(n, os.cpu_count() or 1)
    frames = np.zeros((n, frame_h, frame_w), np.float32)
    coms = np.zeros((n, 3), np.float64)
    status = np.zeros(n, np.int32)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    lib.msra_decode_batch(
        c_paths, n, frame_h, frame_w,
        frames.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        coms.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        num_threads,
    )
    return frames, coms, status


def nyu_pack_batch(rgb: np.ndarray, num_threads: int = 0) -> np.ndarray:
    """[n,h,w,3] u8 -> [n,h,w] f32 depth with reference rounding."""
    lib = _require()
    rgb = np.ascontiguousarray(rgb, np.uint8)
    n, h, w, _ = rgb.shape
    if num_threads <= 0:
        num_threads = min(n, os.cpu_count() or 1)
    out = np.empty((n, h, w), np.float32)
    lib.nyu_pack_batch(
        rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n, h, w,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), num_threads,
    )
    return out


def png16_scale_batch(raw16: np.ndarray, num_threads: int = 0) -> np.ndarray:
    """[n,h,w] u16 -> [n,h,w] f32 with plt.imread*65535 rounding."""
    lib = _require()
    raw16 = np.ascontiguousarray(raw16, np.uint16)
    n, h, w = raw16.shape
    if num_threads <= 0:
        num_threads = min(n, os.cpu_count() or 1)
    out = np.empty((n, h, w), np.float32)
    lib.png16_scale_batch(
        raw16.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), n, h, w,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), num_threads,
    )
    return out


PNG_MODE_NYU_RGB = 0      # 8-bit RGB(A), depth = (g/255*256 + b/255)*255
PNG_MODE_GRAY16 = 1       # 16-bit grayscale, depth = (v/65535)*65535


def png_decode_depth_batch(
    paths: List[str], mode: int, h: int, w: int, num_threads: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """FULL native PNG decode (zlib inflate + unfilter) of dataset depth
    frames -> (depth [n,h,w] f32, status [n] i32; 0 = ok). Nonzero status
    (interlaced / unexpected layout / corrupt file) means the caller should
    fall back to the PIL path for that file."""
    lib = _require()
    n = len(paths)
    if num_threads <= 0:
        num_threads = min(n, os.cpu_count() or 1)
    out = np.empty((n, h, w), np.float32)
    status = np.empty(n, np.int32)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    lib.png_decode_depth_batch(
        c_paths, n, mode, h, w,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        num_threads,
    )
    return out, status
