"""Build and load the hand-written CUDA kernels of ``ops/csrc``.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper (``sm_90a``)
into one shared library with a plain C interface, at first use, and loaded
with ``ctypes``. The library's file name carries a hash of the sources and
the flags, so an edited kernel is rebuilt and a stale build is never
loaded. Nothing here runs at import time: the CPU tests import every
module of the package on machines without ``nvcc``.

The build directory defaults to ``build/kernels`` at the root of the
checkout (listed in ``.gitignore``); ``OPENMATCH_KERNEL_BUILD_DIR``
overrides it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

SRC_DIR = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C entry point -> argument types; every pointer and the stream are c_void_p
SIGNATURES = {
    "plain_gmax_launch": (_P, _P, _P, _P, _I, _I, _LL, _LL, _LL, _I, _P),
    "gather_rescore_launch": (_P, _P, _P, _P, _I, _I, _I, _LL, _P),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_info: dict = {}  # seconds, library path, compiler output of the last build


def _build_dir() -> Path:
    env = os.environ.get("OPENMATCH_KERNEL_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[2] / "build" / "kernels"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built from source at first use")


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library. Raises on failure."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        srcs = sorted(SRC_DIR.glob("*.cu"))
        if not srcs:
            raise RuntimeError(f"no CUDA sources under {SRC_DIR}")
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for s in srcs:
            h.update(s.name.encode())
            h.update(s.read_bytes())
        out_dir = _build_dir()
        out_dir.mkdir(parents=True, exist_ok=True)
        lib_path = out_dir / f"libopenmatch_kernels_{h.hexdigest()[:16]}.so"
        build_info.update(library=str(lib_path), seconds=0.0, log="(cached)")
        if not lib_path.exists():
            tmp = lib_path.with_suffix(f".{os.getpid()}.tmp.so")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, srcs)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            build_info.update(seconds=time.perf_counter() - t0,
                              log=proc.stdout + proc.stderr)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                    f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, lib_path)
        lib = ctypes.CDLL(str(lib_path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def check(rc: int, name: str):
    """Raise if a launch entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name}: launch failed with cudaError_t {rc}")
