"""ctypes binding of the repo's C++ threaded frame loader
(`native/frameloader.cpp`), a copy of `kalman_hydra_tpu/io/native_loader.py`.

Decode runs on a C++ worker thread into a preallocated ring; Python only
copies frames out, so host decode overlaps the card's compute without the
GIL in the way. The loader is optional, as in the reference: importers
check `available()`. The library is `native/libframeloader.so`; where that
one is missing or does not load on this host, it is built from the same
source (with the system OpenCV 4.x, as `native/Makefile` builds it) into
the git-ignored `build/native/`, never under the tracked `native/`.
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess
from typing import Iterator, Optional

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SOURCE = os.path.join(_ROOT, "native", "frameloader.cpp")
_LIB_PATHS = (os.path.join(_ROOT, "native", "libframeloader.so"),
              os.path.join(_ROOT, "build", "native", "libframeloader.so"))


def _build(out: str) -> None:
    os.makedirs(os.path.dirname(out), exist_ok=True)
    subprocess.run(["g++", "-O3", "-std=c++17", "-fPIC", "-Wall",
                    "-I/usr/include/opencv4", "-shared", "-o", out, _SOURCE,
                    "-lopencv_core", "-lopencv_videoio", "-lpthread"],
                   check=True, capture_output=True, timeout=120)


def _open(path: str):
    try:
        return ctypes.CDLL(path)
    except OSError:
        return None


@functools.lru_cache(maxsize=None)
def _load():
    """The bound library, or None where it neither loads nor builds."""
    lib = None
    for path in _LIB_PATHS:
        if os.path.exists(path):
            lib = _open(path)
        if lib is not None:
            break
    if lib is None:
        try:
            _build(_LIB_PATHS[-1])
        except (OSError, subprocess.SubprocessError):
            return None
        lib = _open(_LIB_PATHS[-1])
        if lib is None:
            return None
    lib.fl_open.restype = ctypes.c_void_p
    lib.fl_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
    if hasattr(lib, "fl_open2"):
        lib.fl_open2.restype = ctypes.c_void_p
        lib.fl_open2.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                 ctypes.c_int]
    lib.fl_info.restype = None
    lib.fl_info.argtypes = [ctypes.c_void_p,
                            ctypes.POINTER(ctypes.c_int),
                            ctypes.POINTER(ctypes.c_int),
                            ctypes.POINTER(ctypes.c_int64),
                            ctypes.POINTER(ctypes.c_double)]
    lib.fl_next.restype = ctypes.c_int
    lib.fl_next.argtypes = [ctypes.c_void_p,
                            ctypes.POINTER(ctypes.c_uint8)]
    lib.fl_close.restype = None
    lib.fl_close.argtypes = [ctypes.c_void_p]
    if hasattr(lib, "fl_error"):
        lib.fl_error.restype = ctypes.c_int
        lib.fl_error.argtypes = [ctypes.c_void_p]
    return lib


def available() -> bool:
    return _load() is not None


class NativeFrameStream:
    """Threaded-decode frame stream backed by the C++ ring loader.

    gray=True converts BGR -> gray u8 on the decode thread with cv2's
    exact fixed-point BT.601 (bit-identical to ops.color.grayscale_u8):
    frames come out (H, W) uint8 and the host -> card copy moves 1/3 of
    the bytes."""

    def __init__(self, path: str, ring: int = 8, gray: bool = False):
        lib = _load()
        if lib is None:
            raise RuntimeError("native frame loader unavailable (it needs "
                               "g++ and the system OpenCV 4.x to build)")
        self._lib = lib
        self.gray = bool(gray)
        if self.gray and not hasattr(lib, "fl_open2"):
            raise RuntimeError("gray mode needs a rebuilt loader "
                               "(make -C native)")
        if self.gray:
            self._h = lib.fl_open2(path.encode(), ring, 1)
        else:
            self._h = lib.fl_open(path.encode(), ring)
        if not self._h:
            raise IOError(f"cannot open video {path!r}")
        w = ctypes.c_int()
        h = ctypes.c_int()
        n = ctypes.c_int64()
        fps = ctypes.c_double()
        lib.fl_info(self._h, ctypes.byref(w), ctypes.byref(h),
                    ctypes.byref(n), ctypes.byref(fps))
        self.width = w.value
        self.height = h.value
        self.num_frames = int(n.value)
        self.fps = fps.value or 30.0

    def __iter__(self) -> Iterator[np.ndarray]:
        shape = ((self.height, self.width) if self.gray
                 else (self.height, self.width, 3))
        buf = np.empty(shape, dtype=np.uint8)
        ptr = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        while True:
            if not self._lib.fl_next(self._h, ptr):
                # a decode failure is not a clean end of stream (older
                # builds without fl_error can only report the end)
                if (hasattr(self._lib, "fl_error")
                        and self._lib.fl_error(self._h)):
                    raise RuntimeError(
                        "native loader: decode error mid-stream (frame "
                        "dimensions disagree with the container header)")
                break
            yield buf.copy()

    def read_all(self, limit: Optional[int] = None) -> np.ndarray:
        out = []
        for i, f in enumerate(self):
            if limit is not None and i >= limit:
                break
            out.append(f)
        return np.stack(out)

    def close(self):
        if self._h:
            self._lib.fl_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter shutdown
            pass
