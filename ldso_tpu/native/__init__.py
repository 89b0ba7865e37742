"""ctypes bindings for the native image decode + prefetch pipeline.

The compute path of this framework is JAX/XLA on the device; the
host-side runtime around it — like the reference's OpenCV/libzip frame
IO (reference: n-lalanne/LDSO src/frontend/ImageRW_OpenCV.cc,
examples/run_dso_*.cc ImageFolderReader) — is native C++
(``loader.cc``): libpng/libjpeg decode plus a pthread worker pool that
decodes frames AHEAD of the tracking loop into a bounded in-order
buffer, overlapping host IO with device compute.

The shared library is built lazily on first use with the system g++
(no pip deps, no pybind11 — plain C ABI + ctypes). Every consumer must
handle :func:`available` returning False (source-only checkouts on
machines without a toolchain fall back to the pure-Python decoders in
ldso_tpu/io/datasets.py).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Sequence

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "loader.cc")
_SO = os.path.join(_DIR, "libldso_native.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _build() -> bool:
    cmd = ["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
           _SRC, "-lpng", "-ljpeg", "-pthread", "-o", _SO]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=180)
    except (OSError, subprocess.TimeoutExpired):
        return False
    if r.returncode != 0:
        import logging

        logging.getLogger(__name__).warning(
            "native loader build failed:\n%s", r.stderr[-2000:])
        return False
    return True


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        needs_build = (not os.path.isfile(_SO)
                       or os.path.getmtime(_SO) < os.path.getmtime(_SRC))
        if needs_build and not _build():
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            _build_failed = True
            return None
        lib.ldso_decode_gray.restype = ctypes.c_int
        lib.ldso_decode_gray.argtypes = [
            ctypes.c_char_p, ctypes.c_long,
            ctypes.POINTER(ctypes.c_float), ctypes.c_long,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        lib.ldso_probe.restype = ctypes.c_int
        lib.ldso_probe.argtypes = [
            ctypes.c_char_p, ctypes.c_long,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        lib.ldso_prefetcher_create.restype = ctypes.c_void_p
        lib.ldso_prefetcher_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int]
        lib.ldso_prefetcher_get.restype = ctypes.c_int
        lib.ldso_prefetcher_get.argtypes = [
            ctypes.c_void_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_long,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        lib.ldso_prefetcher_destroy.restype = None
        lib.ldso_prefetcher_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    """True if the native loader is built (building it if needed)."""
    return _load() is not None


_MAX_PIXELS = 4096 * 3072


def decode_gray(data: bytes) -> Optional[np.ndarray]:
    """Decode PNG/JPEG bytes to f32 [H, W] in [0, 255]; None on failure."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty(_MAX_PIXELS, np.float32)
    w = ctypes.c_int()
    h = ctypes.c_int()
    rc = lib.ldso_decode_gray(
        data, len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.size, ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        return None
    return out[: w.value * h.value].reshape(h.value, w.value).copy()


class Prefetcher:
    """In-order frame prefetcher over a list of image paths.

    Worker threads decode up to `ahead` frames past the last-consumed
    index; :meth:`get` blocks until frame `idx` is ready. Consumption
    must be in order (the SLAM frame loop is)."""

    def __init__(self, paths: Sequence[str], n_threads: int = 3,
                 ahead: int = 8):
        lib = _load()
        if lib is None:
            raise RuntimeError("native loader unavailable")
        self._lib = lib
        self._paths = [os.fsencode(p) for p in paths]
        arr = (ctypes.c_char_p * len(self._paths))(*self._paths)
        self._h = lib.ldso_prefetcher_create(arr, len(self._paths),
                                             n_threads, ahead)
        self._n = len(paths)
        self._buf = np.empty(_MAX_PIXELS, np.float32)

    def __len__(self) -> int:
        return self._n

    def get(self, idx: int) -> np.ndarray:
        w = ctypes.c_int()
        h = ctypes.c_int()
        rc = self._lib.ldso_prefetcher_get(
            self._h, idx,
            self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self._buf.size, ctypes.byref(w), ctypes.byref(h))
        if rc != 0:
            raise RuntimeError(f"prefetcher_get({idx}) failed rc={rc}")
        return self._buf[: w.value * h.value].reshape(h.value, w.value).copy()

    def close(self):
        if getattr(self, "_h", None):
            self._lib.ldso_prefetcher_destroy(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass
