"""Build, load and count the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` source compiles with ``nvcc`` into its own shared
library with a plain C interface, loaded with :mod:`ctypes` (no PyTorch
headers, so a build takes seconds).  The sources build in parallel, one
``nvcc`` each, at first use; the libraries land in a build directory
(``$REPRO_TORCH_BUILD_DIR``, default ``build/cuda`` at the repository
root) keyed by a hash of the source and flags, so an unchanged source is
not rebuilt.  Nothing here runs at import time: the CPU tests import every
module on a machine with no ``nvcc``.

Each kernel wrapper adds one to :data:`LAUNCHES` where it launches its
kernel, so a run can show that its main path went through the kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("hash_join", "closure", "attention", "ssd")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v"]

LAUNCHES: Dict[str, int] = {
    "join_compact": 0, "probe_compact": 0, "match_matrix": 0,
    "closure_step": 0, "descendants": 0,
    "flash_attention": 0, "decode_attention": 0, "ssd": 0,
}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
BUILD_LOG: Dict[str, str] = {}     # nvcc's output per source (ptxas -v)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def count_launch(name: str) -> None:
    LAUNCHES[name] += 1


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "cuda"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    """The library's path, keyed by its source, the shared headers (every
    ``csrc/*.cuh``) and the flags."""
    src = (CSRC / (name + ".cu")).read_bytes()
    for header in sorted(CSRC.glob("*.cuh")):
        src += header.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return build_dir() / ("%s-%s.so" % (name, digest))


def build_all() -> Dict[str, Path]:
    """Compile every source that is not built yet, all ``nvcc`` runs started
    together.  Raises with the compiler's output if any build fails."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    paths = {}
    for name in SOURCES:
        path = _lib_path(name)
        paths[name] = path
        if path.exists():
            continue
        tmp = path.with_suffix(".so.tmp%d" % os.getpid())
        cmd = [_nvcc()] + NVCC_FLAGS + ["-o", str(tmp), str(CSRC / (name + ".cu"))]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, path)
    failed = []
    for name, (proc, tmp, path) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            failed.append("%s (exit %d):\n%s" % (name, proc.returncode, log))
        else:
            os.replace(tmp, path)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return paths


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        if name not in _LIBS:
            paths = build_all()
            for n, p in paths.items():
                if n not in _LIBS:
                    _LIBS[n] = ctypes.CDLL(str(p))
        return _LIBS[name]


def check(err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if err != 0:
        raise RuntimeError("CUDA kernel %s failed to launch: cudaError %d"
                           % (what, err))


def stream_of(t: torch.Tensor) -> int:
    """The handle of PyTorch's current stream on ``t``'s device, read raw:
    ``torch.cuda.current_stream`` builds a Stream object and switches the
    current device twice a call.  CUDA builds only (as every launch).

    The launchers take their device from the CUDA runtime's current one,
    so ``t``'s device must be current: a launch elsewhere would read
    another card's memory with no order against its stream.  Callers that
    spread work over cards make each card current in turn
    (``torch.cuda.device``)."""
    dev = t.get_device()
    if dev != torch._C._cuda_getDevice():
        raise RuntimeError(
            "kernel launch on cuda:%d while cuda:%d is current; run it "
            "under torch.cuda.device(%d)"
            % (dev, torch._C._cuda_getDevice(), dev))
    return torch._C._cuda_getCurrentRawStream(dev)


def require(t: torch.Tensor, dtype: torch.dtype, ndim: int, what: str) -> None:
    """The wrapper-side contract every kernel argument is held to."""
    if not t.is_cuda:
        raise ValueError("%s must be a CUDA tensor" % what)
    if t.dtype != dtype:
        raise TypeError("%s must be %s, got %s" % (what, dtype, t.dtype))
    if t.dim() != ndim:
        raise ValueError("%s must have %d dims, got shape %s"
                         % (what, ndim, tuple(t.shape)))
    if not t.is_contiguous():
        raise ValueError("%s must be contiguous" % what)


P = ctypes.c_void_p
I = ctypes.c_int
U = ctypes.c_uint
LL = ctypes.c_longlong
