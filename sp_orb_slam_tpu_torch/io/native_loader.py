"""ctypes bindings for the native C++ PNG loader (native/dataio.cpp).

The port's own copy of the JAX package's io/native_loader.py.  The
reference's IO layer is C++ (src/io/data_loader.cc: cv::imread on the
tracking thread); this one is too, restructured for a device pipeline: a
worker pool decodes PNGs ahead of the consumer into a bounded in-order
ring, so host decode latency hides behind device work.

The shared library is built from `native/dataio.cpp` with g++ on first use
into `build/torch_native/libdataio.so` at the root of the checkout, not
into `native/build/` where the JAX copy builds, and through a temporary
file renamed into place, so two processes building at once never load a
half-written library.  When the toolchain or libpng is missing,
`available()` is False and the loaders decode with PIL on the host.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Iterator, List, Optional

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_ROOT, "native", "dataio.cpp")
_LIB_PATH = os.path.join(_ROOT, "build", "torch_native", "libdataio.so")

_lib = None
_lib_lock = threading.Lock()
_build_failed = False


def _build() -> bool:
    """Compile the library (as native/Makefile does); False on failure."""
    os.makedirs(os.path.dirname(_LIB_PATH), exist_ok=True)
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            ["g++", "-O2", "-std=c++17", "-fPIC", "-Wall", "-shared", _SRC,
             "-lpng", "-lz", "-lpthread", "-o", tmp],
            check=True, capture_output=True, timeout=120)
        os.replace(tmp, _LIB_PATH)
    except Exception:
        if os.path.exists(tmp):
            os.remove(tmp)
        return False
    return True


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lib_lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        if not os.path.exists(_LIB_PATH) and not (os.path.exists(_SRC)
                                                  and _build()):
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            _build_failed = True
            return None
        lib.dataio_png_size.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int)]
        lib.dataio_png_size.restype = ctypes.c_int
        lib.dataio_png_gray.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int,
            ctypes.c_int]
        lib.dataio_png_gray.restype = ctypes.c_int
        lib.dataio_prefetch_open.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.dataio_prefetch_open.restype = ctypes.c_void_p
        lib.dataio_prefetch_next.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_ubyte)]
        lib.dataio_prefetch_next.restype = ctypes.c_int
        lib.dataio_prefetch_close.argtypes = [ctypes.c_void_p]
        lib.dataio_prefetch_close.restype = None
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def png_size(path: str):
    lib = _load()
    if lib is None:
        raise RuntimeError("native dataio unavailable")
    w = ctypes.c_int()
    h = ctypes.c_int()
    rc = lib.dataio_png_size(path.encode(), ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        raise IOError(f"dataio_png_size({path}) -> {rc}")
    return w.value, h.value


def png_gray(path: str) -> np.ndarray:
    lib = _load()
    if lib is None:
        raise RuntimeError("native dataio unavailable")
    w, h = png_size(path)
    out = np.empty((h, w), np.uint8)
    rc = lib.dataio_png_gray(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        w, h)
    if rc != 0:
        raise IOError(f"dataio_png_gray({path}) -> {rc}")
    return out


class PngPrefetcher:
    """In-order prefetching iterator over a homogeneous PNG sequence."""

    def __init__(self, paths: List[str], ring: int = 8, threads: int = 3):
        if not paths:
            raise ValueError("empty path list")
        self.lib = _load()
        if self.lib is None:
            raise RuntimeError("native dataio unavailable")
        self.w, self.h = png_size(paths[0])
        self.n = len(paths)
        self._encoded = [p.encode() for p in paths]
        arr = (ctypes.c_char_p * self.n)(*self._encoded)
        self._handle = self.lib.dataio_prefetch_open(
            arr, self.n, self.w, self.h, ring, threads)
        if not self._handle:
            raise RuntimeError("dataio_prefetch_open failed")
        self._emitted = 0

    def __iter__(self) -> Iterator[np.ndarray]:
        return self

    def __next__(self) -> np.ndarray:
        if self._handle is None or self._emitted >= self.n:
            self.close()
            raise StopIteration
        out = np.empty((self.h, self.w), np.uint8)
        rc = self.lib.dataio_prefetch_next(
            self._handle, out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)))
        if rc < 0:
            self.close()
            raise IOError(f"prefetch_next -> {rc}")
        self._emitted += 1
        return out

    def close(self) -> None:
        if self._handle is not None:
            self.lib.dataio_prefetch_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def iter_gray_images(paths: List[str]):
    """The native prefetch ring when the library is available, else PIL.

    A decode failure after k images were yielded resumes with PIL at image
    k, never at 0: the consumer zips these images with timestamps, and a
    restart would pair every later timestamp with the wrong image."""
    if not paths:
        return  # as PngPrefetcher's caller would see without the library
    emitted = 0
    if available():
        try:
            for img in PngPrefetcher(paths):
                yield img
                emitted += 1
            return
        except (RuntimeError, IOError):
            pass  # fall through to PIL (e.g. non-PNG input), resuming
    from PIL import Image

    for p in paths[emitted:]:
        yield np.asarray(Image.open(p).convert("L"))
