"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

All `csrc/*.cu` sources compile into ONE shared library with a plain C
interface (no PyTorch headers, so a build takes seconds, not minutes):
one nvcc per source, all started together so that the build takes as long
as its slowest source however many are added, then one link:

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 \
         -Xcompiler -fPIC -I csrc -c -o <obj> csrc/<name>.cu   # each
    nvcc -gencode arch=compute_90a,code=sm_90a -shared \
         -o build/kalman_hydra_tpu_torch/libkh_<hash>.so <objs>

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
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH + ("-O3", "-std=c++17", "-Xcompiler", "-fPIC")

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


def _run_all(cmds) -> None:
    """Run the commands in parallel; raise with the output of any that
    failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    fails = []
    for c, p in zip(cmds, procs):
        out, _ = p.communicate()
        if p.returncode != 0:
            fails.append(f"{' '.join(c)}\n{out}")
    if fails:
        raise RuntimeError("nvcc failed:\n" + "\n".join(fails))


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
    nvcc = _nvcc()
    tmpdir = BUILD_DIR / f"objs_{h.hexdigest()[:16]}.{os.getpid()}"
    tmpdir.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    objs = [tmpdir / f"{p.stem}.o" for p in srcs]
    t0 = time.perf_counter()
    try:
        _run_all([[nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(o),
                   str(p)] for p, o in zip(srcs, objs)])
        _run_all([[nvcc, *ARCH, "-shared", "-o", str(tmp),
                   *map(str, objs)]])
        os.replace(tmp, out)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
        tmp.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0
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
    """Raw handle of PyTorch's current stream on t's device (the
    capturing stream inside a CUDA graph capture). Read without building
    a torch.cuda.Stream object: it is on every launch's host path."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


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
