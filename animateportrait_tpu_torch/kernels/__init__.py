"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

The sources are compiled by ``nvcc`` into one shared library with a plain
C interface and loaded with ``ctypes``: no PyTorch headers are compiled, so
a build takes seconds. The library goes under ``build/torch_kernels/`` next
to the package, in a directory named by a hash of the sources and flags, so
an edited source rebuilds and an unchanged one loads what is there.

Nothing is built when this module is imported: the first call of
:func:`library` builds (or finds) the library and loads it. Every entry
point returns ``cudaGetLastError()`` right after its launch; the wrappers
in ``ops/`` raise when it is not 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import tempfile
import threading
import time

PACKAGE_DIR = pathlib.Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_ROOT = PACKAGE_DIR.parent / "build" / "torch_kernels"
SOURCES = ("stft.cu", "instnorm.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
LIB_NAME = "libap_kernels.so"

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_seconds: float | None = None   # wall time of this process's build


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: nvcc is needed to build "
                           "the port's kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build() -> pathlib.Path:
    """Compile the sources unless a library for this hash exists; return
    its path. The compiler's report (registers, shared memory, spills) is
    kept beside it as ``nvcc.log``."""
    out_dir = BUILD_ROOT / _source_hash()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    # build under a temporary name, then rename: a concurrent process
    # either sees no library or a complete one
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *(str(CSRC_DIR / s) for s in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (out_dir / "nvcc.log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib_path)
    return lib_path


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ap_stft_magnitude.argtypes = [p, i, p, p, p, i, p]
    lib.ap_stft_magnitude.restype = i
    lib.ap_instance_norm.argtypes = [p, p, i, i, f, i, p]
    lib.ap_instance_norm.restype = i
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib, build_seconds
    with _lock:
        if _lib is None:
            t0 = time.perf_counter()
            path = build()
            _lib = _bind(ctypes.CDLL(str(path)))
            build_seconds = time.perf_counter() - t0
        return _lib


def check(err: int, name: str) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
