"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by its own ``nvcc`` process, all started together,
and the objects are linked into one shared library with a plain C
interface, loaded with ``ctypes``: no PyTorch headers are compiled, so a
build takes seconds. The library goes under ``build/torch_kernels/`` next
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
SOURCES = ("stft.cu", "instnorm.cu", "instnorm_bwd.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")
LIB_NAME = "libap_kernels.so"

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_seconds: float | None = None   # wall time of this process's build


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
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
    # build under temporary names, then rename: a concurrent process
    # either sees no library or a complete one
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp_dir:
        objs = [os.path.join(tmp_dir, s + ".o") for s in SOURCES]
        jobs = [[_nvcc(), *NVCC_FLAGS, "-c", "-o", o, str(CSRC_DIR / s)]
                for s, o in zip(SOURCES, objs)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cmd in jobs]
        tmp = os.path.join(tmp_dir, LIB_NAME)
        log, failed = [], []
        for cmd, proc in zip(jobs, procs):
            log += [" ".join(cmd), proc.communicate()[0]]
            if proc.returncode != 0:
                failed.append(proc.returncode)
        if not failed:
            link = [_nvcc(), *LINK_FLAGS, "-o", tmp, *objs]
            proc = subprocess.run(link, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
            log += [" ".join(link), proc.stdout]
            if proc.returncode != 0:
                failed.append(proc.returncode)
        (out_dir / "nvcc.log").write_text("\n".join(log))
        if failed:
            raise RuntimeError(f"nvcc failed ({failed}):\n" + "\n".join(log))
        os.replace(tmp, lib_path)
    return lib_path


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ap_stft_magnitude.argtypes = [p, i, p, i, p]
    lib.ap_stft_magnitude.restype = i
    for name in ("ap_instance_norm", "ap_instance_norm_bf16"):
        getattr(lib, name).argtypes = [p, p, p, i, i, f, i, i, p]
        getattr(lib, name).restype = i
    for name in ("ap_instance_norm_bwd", "ap_instance_norm_bwd_bf16"):
        getattr(lib, name).argtypes = [p, p, p, p, i, i, i, i, p]
        getattr(lib, name).restype = i
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
