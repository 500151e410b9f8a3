"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

All `csrc/*.cu` sources compile into ONE shared library with a plain C
interface (no PyTorch headers, so a build takes seconds, not minutes):

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared \
         -Xcompiler -fPIC -o build/kalman_hydra_tpu_torch/libkh_<hash>.so \
         csrc/*.cu

The library lands in `build/kalman_hydra_tpu_torch/` beside the package
(git-ignored), named by a hash of the sources and flags, so an edited
source rebuilds and an unchanged one is reused. Nothing is built or
loaded at import time: the first kernel launch calls `function()`.

Conventions shared by every entry point:
  * pointers and the stream are passed as `c_void_p` (ctypes would cut a
    Python int to 32 bits otherwise);
  * kernels launch on `torch.cuda.current_stream().cuda_stream`, never
    synchronise, and allocate nothing (wrappers allocate with torch.empty);
  * each entry point returns `cudaGetLastError()`; `check()` raises on a
    non-zero code, so a refused launch cannot pass silently.
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

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = CSRC.parents[1] / "build" / "kalman_hydra_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC")

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float

_lock = threading.Lock()
_lib = None
_fns: dict = {}
build_seconds = None      # wall time of the last nvcc run (None = reused)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): the "
                           "port's CUDA kernels are built on the GPU host")
    return path


def build() -> Path:
    """Compile csrc/*.cu into the shared library (reused when the sources
    and flags are unchanged)."""
    global build_seconds
    srcs = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    out = BUILD_DIR / f"libkh_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           *map(str, srcs)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                           f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            _lib = ctypes.CDLL(str(build()))
            _lib.kh_error_string.argtypes = [I]
            _lib.kh_error_string.restype = ctypes.c_char_p
        return _lib


def function(name: str, *argtypes):
    """The C entry point `name` with its argument types declared."""
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(library(), name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def check(rc: int, name: str) -> None:
    if rc != 0:
        msg = library().kh_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def stream(t: torch.Tensor) -> int:
    """Raw handle of PyTorch's current stream on t's device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require(t: torch.Tensor, name: str, dtypes, ndim: int) -> None:
    """Wrapper-side argument check: a CUDA kernel trusts its pointers."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if t.ndim != ndim:
        raise ValueError(f"{name}: expected {ndim}-D, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
