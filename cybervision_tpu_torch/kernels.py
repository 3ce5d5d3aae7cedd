"""Build and load the hand-written CUDA kernels (csrc/*.cu).

Every source compiles with its own nvcc process, all started together,
into an object file for sm_90a; one link step joins them into a shared
library with a plain C interface, loaded with ctypes. The library is
named by a hash of the sources and flags, so an edit rebuilds and an
unchanged tree reuses the last build. Nothing here runs at import: the
first kernel launch (or an explicit `library()` call) builds.

The wrappers call `library()`, `on_device()` and `stream_of()` on every
launch, so each is a few attribute reads once the library is loaded.

Build directory: cybervision_tpu_torch/_build/ (git-ignored).
"""

from __future__ import annotations

import contextlib
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import torch

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
]

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _digest(sources: list[str]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile csrc/*.cu (parallel nvcc processes) and link one shared
    library; returns its path. Raises on any compiler error."""
    sources = _sources()
    so = os.path.join(BUILD_DIR, f"libcvtorch_kernels_{_digest(sources)}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tmp = tempfile.mkdtemp(dir=BUILD_DIR)
    try:
        procs = []
        objs = []
        for src in sources:
            obj = os.path.join(tmp, os.path.basename(src) + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", src, "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )))
        failed = []
        for src, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{src}:\n{out}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_so = os.path.join(tmp, "lib.so")
        subprocess.run(
            [nvcc, "-shared", *NVCC_FLAGS, *objs, "-o", tmp_so],
            check=True, capture_output=True, text=True,
        )
        os.replace(tmp_so, so)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build())
            vp = ctypes.c_void_p
            ci = ctypes.c_int
            cf = ctypes.c_float
            lib.cv_ncc_sweep.argtypes = [
                vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp,
                vp, vp, vp,
                ci, ci, ci, ci, ci, ci, ci, ci, cf, cf,
                ci, ci, ci, ci, ci, ci, ci, ci, ci, vp,
            ]
            lib.cv_score_candidates.argtypes = [
                vp, vp, vp, ci, ci, cf, ci, ci, vp, vp, vp, vp, vp,
            ]
            lib.cv_gather_packed.argtypes = [vp, ci, vp, ctypes.c_long, vp, vp]
            for fn in (
                lib.cv_ncc_sweep, lib.cv_score_candidates, lib.cv_gather_packed,
            ):
                fn.restype = ci
            _LIB = lib
        return _LIB


_HERE = contextlib.nullcontext()


def stream_of(dev: torch.device) -> int:
    """The current stream of CUDA device `dev`, as the C entry points take
    it: its raw pointer, without building a torch.cuda.Stream per call.
    Read on every launch: a kept stream would ignore a caller's
    torch.cuda.stream context."""
    return torch._C._cuda_getCurrentRawStream(dev.index)


def on_device(dev: torch.device):
    """A context under which `dev` is the host thread's current device,
    where the C entry points launch: torch.cuda.device(dev), or nothing
    when `dev` already is current."""
    if torch.cuda.current_device() == dev.index:
        return _HERE
    return torch.cuda.device(dev)


def check(err: int, name: str) -> None:
    """Raise on a nonzero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
