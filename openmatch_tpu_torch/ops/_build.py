"""Build and load the hand-written CUDA kernels of ``ops/csrc``.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` for Hopper
(``sm_90a``), all of them at once, and the objects are linked into one
shared library with a plain C interface, at first use, and loaded with
``ctypes``. Linking needs nothing but ``nvcc``: the kernels that load
through TMA look ``cuTensorMapEncodeTiled`` up in the loaded ``libcuda`` at
run time (``cudaGetDriverEntryPoint``), so ``libcuda`` is not linked. The
library's file name carries a hash of the sources, the headers and the
flags, so an edited kernel is rebuilt and a stale build is never loaded.
The compiler's output (ptxas's registers, stack frames and spills a
kernel) is kept beside the library and read back with a cached build.
Nothing here runs at import time: the CPU tests import every module of the
package on machines without ``nvcc``.

The build directory defaults to ``build/kernels`` at the root of the
checkout (listed in ``.gitignore``); ``OPENMATCH_KERNEL_BUILD_DIR``
overrides it.

``launches`` counts every successful launch a wrapper makes (a CUDA
graph's replays run no Python and are not counted), keyed by the name the
wrapper passes to ``check``: ``plain_gmax`` (K1/K2), ``gather_rescore``
(K3), ``plain_gmax_segs`` (K4), ``gather_rescore_seg`` (K5),
``gather_rescore_pipelined`` (K6), ``block_gmax`` (K7), ``scores`` (K8),
``score_gmax`` (K9), ``gmax_only`` (K10), ``gmax_phase`` (K11) and
``grouped_gemm`` (K12). Readers take ``launches.copy()`` (a kernel that
never launched reads 0) and reset it with ``launches.clear()``.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

SRC_DIR = Path(__file__).resolve().parent / "csrc"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas=-v")

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C entry point -> argument types; every pointer and the stream are c_void_p
SIGNATURES = {
    "plain_gmax_launch": (_P, _P, _P, _I, _P, _P, _I, _I, _LL, _LL, _LL, _I,
                          _P),
    "gather_rescore_launch": (_P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _I,
                              _I, _P),
    "gather_rescore_pipelined_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _I,
                                        _I, _I, _LL, _P),
    "block_gmax_launch": (_P, _P, _P, _I, _I, _LL, _P),
    "scores_launch": (_P, _P, _P, _I, _I, _LL, _P),
    "score_gmax_launch": (_P, _P, _P, _P, _I, _I, _LL, _I, _P),
    "gmax_only_launch": (_P, _P, _P, _I, _I, _LL, _I, _P),
    "gmax_phase_launch": (_P, _P, _P, _I, _I, _LL, _I, _P),
    "grouped_gemm_launch": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_info: dict = {}  # seconds, library path, compiler output of the build
launches: collections.Counter = collections.Counter()  # kernel -> launches


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
        for s in sorted(SRC_DIR.glob("*.cu*")):
            h.update(s.name.encode())
            h.update(s.read_bytes())
        out_dir = _build_dir()
        out_dir.mkdir(parents=True, exist_ok=True)
        lib_path = out_dir / f"libopenmatch_kernels_{h.hexdigest()[:16]}.so"
        log_path = lib_path.with_suffix(".log")
        build_info.update(library=str(lib_path), seconds=0.0, log="(cached)")
        if not lib_path.exists():
            t0 = time.perf_counter()
            log = _compile_and_link(srcs, lib_path)
            build_info.update(seconds=time.perf_counter() - t0, log=log)
        elif log_path.exists():
            build_info.update(log=log_path.read_text())
        lib = ctypes.CDLL(str(lib_path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def _run(cmds):
    """Run the commands at once; return their output, raise if any failed."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    outs = [(cmd, p.communicate()[0], p.returncode) for cmd, p in procs]
    for cmd, out, rc in outs:
        if rc != 0:
            raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{out}")
    return "".join(out for _, out, _ in outs)


def _compile_and_link(srcs, lib_path: Path) -> str:
    """One nvcc per source, all started together, then one link. Objects
    and the library are written under per-process names and the library
    renamed into place, so concurrent builds never see a partial file."""
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    objs = [lib_path.with_name(f"{lib_path.stem}.{s.stem}.{tag}.o")
            for s in srcs]
    tmp = lib_path.with_suffix(f".{tag}.so")
    tmp_log = lib_path.with_suffix(f".{tag}.log")
    try:
        log = _run([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)]
                    for s, o in zip(srcs, objs)])
        log += _run([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                      *map(str, objs)]])
        tmp_log.write_text(log)
        os.replace(tmp_log, lib_path.with_suffix(".log"))
        os.replace(tmp, lib_path)
    finally:
        for f in objs + [tmp, tmp_log]:
            f.unlink(missing_ok=True)
    return log


def ptxas_usage(log: str, name_part: str) -> dict:
    """What ptxas reported (``-Xptxas=-v``) for each kernel whose mangled
    name holds ``name_part``: name -> {"registers" (a thread),
    "stack_frame", "spill_stores", "spill_loads" (bytes)}."""
    found, name, props = {}, None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1) if name_part in m.group(1) else None
            if name:
                found[name] = {}
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = m.group(1)
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and props == name:
            found[name].update(stack_frame=int(m.group(1)),
                               spill_stores=int(m.group(2)),
                               spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            found[name]["registers"] = int(m.group(1))
    return found


ENCODE_FAILED = 10000  # csrc/score_tile_sm90.cuh: + the CUresult


def check(rc: int, name: str):
    """Raise if the launch of kernel ``name`` reported a CUDA error or a
    failed tensor-map encode; else count it in ``launches``."""
    if rc >= ENCODE_FAILED:
        raise RuntimeError(f"{name}: cuTensorMapEncodeTiled failed with "
                           f"CUresult {rc - ENCODE_FAILED}")
    if rc != 0:
        raise RuntimeError(f"{name}: launch failed with cudaError_t {rc}")
    launches[name] += 1
