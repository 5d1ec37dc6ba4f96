"""ctypes binding to the native host runtime (native/libmola_tpu_native.so).

Port of ``mola_lidar_odometry_tpu/utils/native.py``: the same ctypes
binding to the repo's ``native/libmola_tpu_native.so`` (this file sits at
the same depth, so ``parents[2]`` is the repo root here too);
``decode_bin.calls`` counts the scans the library decoded.

The C++ library (native/src/scan_io.cpp) provides the hot host-side paths:
fast .bin scan decode (with vertical-angle correction + azimuth timestamp
model) into padded buffers, a background prefetch thread, and raw float32
blob writes for simple-map lazy-load externalization.  Everything degrades
gracefully to the numpy implementations when the library is absent
(``available()`` returns False) — mirroring how the reference's optional
input packages are compile-time gated.

Build: ``make -C native`` (or cmake); the loader searches next to the
repo root and ``$MOLA_TPU_NATIVE_LIB``.
"""

from __future__ import annotations

import ctypes
import os
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

_LIB = None
_TRIED = False


def _find_lib() -> Optional[str]:
    cand = os.environ.get("MOLA_TPU_NATIVE_LIB")
    if cand and Path(cand).exists():
        return cand
    here = Path(__file__).resolve().parents[2]  # repo root
    p = here / "native" / "libmola_tpu_native.so"
    return str(p) if p.exists() else None


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = _find_lib()
    if not path:
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.mola_tpu_decode_bin.argtypes = [
        ctypes.c_char_p, ctypes.c_int32, ctypes.c_float, ctypes.c_float,
        f32p, f32p, f32p,
    ]
    lib.mola_tpu_decode_bin.restype = ctypes.c_int32
    lib.mola_tpu_prefetch_open.argtypes = [
        ctypes.c_char_p, ctypes.c_int32, ctypes.c_float, ctypes.c_float,
        ctypes.c_int32,
    ]
    lib.mola_tpu_prefetch_open.restype = ctypes.c_void_p
    lib.mola_tpu_prefetch_next.argtypes = [ctypes.c_void_p, f32p, f32p, f32p]
    lib.mola_tpu_prefetch_next.restype = ctypes.c_int32
    lib.mola_tpu_prefetch_close.argtypes = [ctypes.c_void_p]
    lib.mola_tpu_prefetch_close.restype = None
    lib.mola_tpu_write_f32.argtypes = [ctypes.c_char_p, f32p, ctypes.c_int64]
    lib.mola_tpu_write_f32.restype = ctypes.c_int32
    _LIB = lib
    return lib


def available() -> bool:
    return _load() is not None


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def decode_bin(
    path: str,
    capacity: int,
    vertical_angle_correction_rad: float = 0.0,
    spin_period: float = 0.1,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Decode one x/y/z/intensity .bin into padded buffers.

    Returns (xyz (cap,3), intensity (cap,), times (cap,), n_valid).
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native library not built (make -C native)")
    xyz = np.zeros((capacity, 3), np.float32)
    inten = np.zeros(capacity, np.float32)
    times = np.zeros(capacity, np.float32)
    n = lib.mola_tpu_decode_bin(
        str(path).encode(), capacity,
        ctypes.c_float(vertical_angle_correction_rad),
        ctypes.c_float(spin_period),
        _f32p(xyz), _f32p(inten), _f32p(times),
    )
    if n < 0:
        raise IOError(f"native decode failed ({n}) for {path}")
    decode_bin.calls += 1
    return xyz, inten, times, int(n)


decode_bin.calls = 0  # scans decoded by the library (a run can show it read through it)


class Prefetcher:
    """Background-thread scan prefetcher over a list of .bin files."""

    def __init__(
        self,
        paths: Sequence[str],
        capacity: int,
        vertical_angle_correction_rad: float = 0.0,
        spin_period: float = 0.1,
        lookahead: int = 4,
    ):
        lib = _load()
        if lib is None:
            raise RuntimeError("native library not built (make -C native)")
        self._lib = lib
        self.capacity = capacity
        joined = "\n".join(str(p) for p in paths).encode()
        self._h = lib.mola_tpu_prefetch_open(
            joined, capacity,
            ctypes.c_float(vertical_angle_correction_rad),
            ctypes.c_float(spin_period), lookahead,
        )

    def next(self) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, int]]:
        """Next decoded scan in order, or None when exhausted."""
        xyz = np.zeros((self.capacity, 3), np.float32)
        inten = np.zeros(self.capacity, np.float32)
        times = np.zeros(self.capacity, np.float32)
        n = self._lib.mola_tpu_prefetch_next(
            self._h, _f32p(xyz), _f32p(inten), _f32p(times)
        )
        if n == -100:
            return None
        if n < 0:
            raise IOError(f"native prefetch decode failed ({n})")
        return xyz, inten, times, int(n)

    def close(self) -> None:
        if self._h:
            self._lib.mola_tpu_prefetch_close(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


def write_f32(path: str, data: np.ndarray) -> None:
    lib = _load()
    if lib is None:
        np.asarray(data, np.float32).tofile(path)
        return
    flat = np.ascontiguousarray(data, np.float32).reshape(-1)
    rc = lib.mola_tpu_write_f32(str(path).encode(), _f32p(flat), flat.size)
    if rc != 0:
        raise IOError(f"native write failed ({rc}) for {path}")
