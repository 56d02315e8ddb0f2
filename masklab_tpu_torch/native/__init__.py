"""Native (C++) helpers for the host-side data pipeline.

The port's copy of ``masklab_tpu/native``: ``rasterize.cpp`` is compiled
with ``g++`` at first use into ``masklab_tpu_torch/_build/`` (git-ignored;
the library's name carries a digest of the source, so an edited source
rebuilds) and loaded with ctypes. Without a toolchain ``load`` returns
None and the callers fall back to cv2. A host helper, not a device kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, 'rasterize.cpp')
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), '_build')
_FLAGS = ['-O3', '-shared', '-fPIC', '-std=c++17']
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _build() -> Optional[str]:
    with open(_SRC, 'rb') as f:
        digest = hashlib.sha256(f.read() + ' '.join(_FLAGS).encode()
                                ).hexdigest()[:16]
    so = os.path.join(_BUILD_DIR, f'rasterize_{digest}.so')
    if os.path.exists(so):
        return so
    os.makedirs(_BUILD_DIR, exist_ok=True)
    # build beside the target and rename: concurrent builders (ETL pool
    # workers, test workers) each finish one whole file
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=_BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(['g++', *_FLAGS, _SRC, '-o', tmp], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, so)
        return so
    except (OSError, subprocess.SubprocessError):
        return None
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load() -> Optional[ctypes.CDLL]:
    """Compile-on-demand loader; returns None when unavailable."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        so = _build()
        if so is None:
            _build_failed = True
            return None
        lib = ctypes.CDLL(so)
        lib.fill_polygon.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_uint8]
        lib.fill_polygon.restype = None
        lib.fill_polygons.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.c_uint8]
        lib.fill_polygons.restype = None
        lib.row_extents.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]
        lib.row_extents.restype = None
        _lib = lib
        return _lib


def fill_polygon_native(mask: np.ndarray, points: np.ndarray,
                        value: int = 1) -> bool:
    """Fill ``points`` [N, 2] (x, y) into the C-contiguous uint8 [H, W]
    ``mask`` in place; False if the native library is unavailable (the
    caller falls back to cv2)."""
    if (mask.dtype != np.uint8 or mask.ndim != 2
            or not mask.flags.c_contiguous):
        raise ValueError('mask must be a C-contiguous uint8 [H, W] array')
    lib = load()
    if lib is None:
        return False
    pts = np.ascontiguousarray(points, dtype=np.float64).reshape(-1, 2)
    lib.fill_polygon(
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        mask.shape[0], mask.shape[1],
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        len(pts), value)
    return True


def row_extents_native(mask: np.ndarray):
    """Row-wise (min x, max x) of the nonzero pixels of an [H, W] mask, -1
    where a row is empty; None if the library is unavailable."""
    lib = load()
    if lib is None:
        return None
    mask = np.ascontiguousarray(mask.astype(np.uint8))
    h, w = mask.shape
    x_min = np.empty(h, np.int32)
    x_max = np.empty(h, np.int32)
    lib.row_extents(
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w,
        x_min.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        x_max.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return x_min, x_max
