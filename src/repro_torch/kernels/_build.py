"""Build the port's CUDA kernels at first use and bind them with ctypes.

``nvcc`` compiles ``csrc/*.cu`` (plain C entry points, no PyTorch headers)
for ``sm_90a`` into a shared library under ``_build/`` beside this file (a
directory git ignores), named by the hash of the source, so an unchanged
source is compiled once per checkout. Nothing is compiled or loaded at
import time: the CPU tests import every module, and there is no ``nvcc``
without the CUDA toolkit.

**The port's compile counter.** PyTorch runs eagerly, so the port has no
trace cache whose misses the reference counts (its ``trace_counts``).
What the port compiles is a kernel library, and each miss of
:func:`load` (a library built, or found built, and bound in this
process) is the port's compile: it adds one to :func:`loads_total` and
fires ``obs.on_engine_trace`` with the library's name.
``EngineContext.trace_counts``, ``TopKServer.trace_counts`` and
``SegmentStats.engine_compiles_total`` attribute deltas of
:func:`loads_total` as the reference attributes traces, so a warmed
server's compactions count 0.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

from repro_torch import obs

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class BuildResult:
    path: Path       # the shared library
    log: str         # nvcc's output, including the -Xptxas -v report
    seconds: float   # compile wall time (0.0 when the library was cached)


def find_nvcc() -> str:
    """``nvcc`` from ``$CUDA_HOME``, then ``$PATH``, then the toolkit's
    default install prefix."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append(os.path.join("/usr/local/cuda", "bin", "nvcc"))
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels are compiled on "
                       "the machine with the card (set CUDA_HOME)")


def build(name: str) -> BuildResult:
    """Compile ``csrc/<name>.cu`` unless a library of the same source hash
    is already in :data:`BUILD_DIR`."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = BUILD_DIR / f"lib{name}-{digest}.so"
    log_path = lib.with_suffix(".log")
    if lib.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return BuildResult(lib, log, 0.0)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    log_path.write_text(log)
    os.replace(tmp, lib)        # atomic: a concurrent loader never sees half
    return BuildResult(lib, log, seconds)


#: Each library's C entry points: name -> (argument types, return type).
#: Pointers and the stream are ``c_void_p`` (ctypes would cut a bare int
#: to 32 bits); every launch function returns ``cudaGetLastError()``.
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "topk_mips": {
        "topk_mips_score_launch": ([_P] * 6 + [_I] * 8 + [_P], _I),
        "topk_mips_walk_launch": ([_P] * 9 + [_I] * 7 + [_P], _I),
        "topk_mips_error_string": ([_I], ctypes.c_char_p),
    },
    "gather_scores": {
        "gather_scores_rows_launch": ([_P] * 4 + [_I] * 4 + [_P], _I),
        "gather_scores_lanes_launch": ([_P] * 4 + [_I] * 8 + [_P], _I),
        "gather_scores_error_string": ([_I], ctypes.c_char_p),
    },
    "embedding_bag": {
        "embedding_bag_launch": ([_P] * 3 + [_I] * 9 + [_P], _I),
        "embedding_bag_error_string": ([_I], ctypes.c_char_p),
    },
    "fm_interaction": {
        "fm_interaction_launch": ([_P] * 2 + [_I] * 4 + [_P], _I),
        "fm_interaction_error_string": ([_I], ctypes.c_char_p),
    },
}


_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def load(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu`` (built if needed), with
    the C signatures of :data:`SIGNATURES` set; loaded once per process.
    Each miss counts as one compile (see the module docstring)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        lib = ctypes.CDLL(str(build(name).path))
        for fn, (argtypes, restype) in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _LIBS[name] = lib
    obs.on_engine_trace(name)
    return lib


def loads_total() -> int:
    """Library loads in this process (each library loads once)."""
    with _LOCK:
        return len(_LIBS)
