"""One build of every hand-written CUDA kernel of the port.

``build()`` compiles every ``csrc/*.cu`` (with the shared ``.cuh`` headers)
with one ``nvcc`` call for ``sm_90a`` into one shared library with a plain C
interface under ``_build/``, named by the hash of ``csrc/``, the first time a
kernel is needed; ``function()`` binds one of its C entry points with ctypes.
A build or load failure raises. Each wrapper module registers the argument
types of its own entry points and checks their return code (a
``cudaError_t``) after every launch with ``check()``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD_DIR = _PKG / "_build"
_lib = None
_bound: dict[str, object] = {}


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
    """Compile the kernels if a source changed; returns (library, compiler log).

    The log holds ``-Xptxas -v``'s registers, shared memory and spills for a
    fresh build, and is empty when the cached library was current.
    """
    sources = sorted(_CSRC.glob("*.cu"))
    h = hashlib.sha256()
    for src in sorted(_CSRC.glob("*.cu*")):
        h.update(src.name.encode() + src.read_bytes())
    lib = _BUILD_DIR / f"libpwr_kernels_{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib, ""
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = _BUILD_DIR / f"{lib.name}.{os.getpid()}.tmp"
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp),
           *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib, proc.stdout + proc.stderr


def function(name: str, argtypes: list, restype=ctypes.c_int):
    """The C entry point ``name`` of the library, built and loaded on first use."""
    global _lib
    fn = _bound.get(name)
    if fn is None:
        if _lib is None:
            _lib = ctypes.CDLL(str(build()[0]))
        fn = getattr(_lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
        _bound[name] = fn
    return fn


def check(rc: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name} launch failed with cudaError {rc}")
