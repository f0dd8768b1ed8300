"""One build of every hand-written CUDA kernel of the port.

``build()`` compiles every ``csrc/*.cu`` (with the shared ``.cuh`` headers)
for ``sm_90a``, one ``nvcc`` process per source, all at once, and links them
into one shared library with a plain C interface under ``_build/``, named by
the hash of ``csrc/``, the first time a kernel is needed; ``function()``
binds one of its C entry points with ctypes. A build or load failure
raises. ``on_cpu()`` routes a wrapper's call: CPU tensors take the kernel's
plain version, CUDA tensors the kernel. Each wrapper module registers the argument types of its own entry
points and checks their return code (a ``cudaError_t``) after every launch
with ``check()``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD_DIR = _PKG / "_build"
_lib = None
_bound: dict[str, object] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _run(procs) -> str:
    """Wait for every compiler process, then raise if one failed."""
    done = [(cmd, *proc.communicate(), proc) for cmd, proc in procs]
    for cmd, out, err, proc in done:
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}\n{err}")
    return "".join(out + err for _, out, err, _ in done)


def build() -> tuple[Path, str]:
    """Compile the kernels if a source changed; returns (library, compiler log).

    Each source compiles in its own ``nvcc`` process, all started together,
    and one more links the objects. The log holds ``-Xptxas -v``'s
    registers, shared memory and spills for a fresh build, and is empty when
    the cached library was current.
    """
    sources = sorted(_CSRC.glob("*.cu"))
    h = hashlib.sha256()
    for src in sorted(_CSRC.glob("*.cu*")):
        h.update(src.name.encode() + src.read_bytes())
    lib = _BUILD_DIR / f"libpwr_kernels_{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib, ""
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stem = _BUILD_DIR / f"{lib.stem}.{os.getpid()}"
    arch = ["-gencode", "arch=compute_90a,code=sm_90a"]
    objs, procs = [], []
    for src in sources:
        obj = f"{stem}.{src.stem}.o"
        cmd = [_nvcc(), *arch, "-std=c++17", "-O3", "-c", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-o", obj, str(src)]
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                            text=True)))
        objs.append(obj)
    log = _run(procs)
    tmp = f"{stem}.so.tmp"
    cmd = [_nvcc(), *arch, "-shared", "-o", tmp, *objs]
    log += _run([(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                        text=True))])
    os.replace(tmp, lib)
    for obj in objs:
        os.remove(obj)
    return lib, log


def function(name: str, argtypes: list, restype=ctypes.c_int):
    """The C entry point ``name`` of the library, built and loaded on first use.

    One thread builds and binds at a time: the build's files are named by the
    process, so two threads of a service whose first requests arrive
    together would otherwise write the same files."""
    global _lib
    fn = _bound.get(name)
    if fn is None:
        with _lock:
            fn = _bound.get(name)
            if fn is None:
                if _lib is None:
                    _lib = ctypes.CDLL(str(build()[0]))
                fn = getattr(_lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
                _bound[name] = fn
    return fn


def on_cpu(name: str, tensors) -> bool:
    """Where a wrapper runs: True when every tensor lies on the CPU (its
    plain version), False when all lie on one CUDA device (its kernel);
    anything else raises."""
    if all(t.device.type == "cpu" for t in tensors):
        return True
    if any(t.device != tensors[0].device for t in tensors) or tensors[0].device.type != "cuda":
        raise ValueError(f"{name} runs on CPU or CUDA tensors on one device, got "
                         f"{sorted({str(t.device) for t in tensors})}")
    return False


def cluster_plan(fn, name: str, *args) -> dict:
    """The plan a cluster-per-sample norm kernel (``csrc/cluster_norm.cuh``)
    would run: ``fn(*args, out)`` fills cluster size, resident tensors (a
    bit each, the last tensor x), ring slots and shared memory a block."""
    out = (ctypes.c_int * 4)()
    check(fn(*args, out), name)
    cs, resident, ring, smem = out
    path = "resident" if ring == 0 else ("mixed" if resident else "streamed")
    return {"cluster": cs, "path": path, "ring": ring, "smem": smem}


def check(rc: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name} launch failed with cudaError {rc}")
