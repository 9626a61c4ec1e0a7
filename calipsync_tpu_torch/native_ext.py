"""ctypes binding of the host compositor (native/compositor.cpp), the
port's own copy of calipsync_tpu/native_ext.py's ``composite_frame``.

Builds the shared library on first use with g++ -O3 into
``.cache/native_torch/`` at the repository root. Without a compiler the
numpy version runs instead; both blend in float and truncate to uint8 like
the reference, and the library is byte-exact against numpy.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import shutil
import subprocess
import threading

import numpy as np

_REPO = pathlib.Path(__file__).resolve().parents[1]
_SRC = _REPO / "native" / "compositor.cpp"
_LIB_DIR = _REPO / ".cache" / "native_torch"
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_TRIED = False


def _build() -> pathlib.Path | None:
    if shutil.which("g++") is None or not _SRC.exists():
        return None
    _LIB_DIR.mkdir(parents=True, exist_ok=True)
    lib = _LIB_DIR / "libcalipsync_native.so"
    if lib.exists() and lib.stat().st_mtime >= _SRC.stat().st_mtime:
        return lib
    # -ffp-contract=off: no FMA contraction in the blend, so the float math
    # rounds exactly like numpy's separate multiply and add
    tmp = _LIB_DIR / f"libcalipsync_native.so.{os.getpid()}"
    cmd = ["g++", "-O3", "-march=native", "-ffp-contract=off", "-shared",
           "-fPIC", str(_SRC), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
    except subprocess.CalledProcessError:
        return None
    tmp.replace(lib)
    return lib


def _load() -> ctypes.CDLL | None:
    global _LIB, _TRIED
    with _LOCK:
        if not _TRIED:
            _TRIED = True
            path = _build()
            if path is not None:
                lib = ctypes.CDLL(str(path))
                u8p = ctypes.POINTER(ctypes.c_uint8)
                f32p = ctypes.POINTER(ctypes.c_float)
                i64 = ctypes.c_int64
                lib.composite_frame.argtypes = [u8p, u8p, f32p, u8p,
                                                i64, i64, i64, i64, i64, i64]
                lib.composite_frame.restype = None
                _LIB = lib
        return _LIB


def have_native() -> bool:
    return _load() is not None


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def composite_frame(frame: np.ndarray, crop: np.ndarray, fm: np.ndarray,
                    y0: int, x0: int) -> np.ndarray:
    """frame (H,W,3) u8, crop (rh,rw,3) u8, fm (rh,rw) f32 -> new frame
    with the region alpha-blended in (truncating uint8 cast, matching the
    reference's float->uint8 assignment)."""
    rh, rw = crop.shape[:2]
    if not (0 <= y0 and y0 + rh <= frame.shape[0] and 0 <= x0
            and x0 + rw <= frame.shape[1]) or fm.shape != (rh, rw):
        raise ValueError("composite_frame: region outside the frame or "
                         "mask shape differs from the crop")
    lib = _load()
    if lib is None:
        out = frame.copy()
        region = out[y0:y0 + rh, x0:x0 + rw]
        blended = (crop.astype(np.float32) * fm[..., None]
                   + region.astype(np.float32) * (1.0 - fm[..., None]))
        out[y0:y0 + rh, x0:x0 + rw] = blended  # trunc-cast
        return out
    frame = np.ascontiguousarray(frame, dtype=np.uint8)
    crop = np.ascontiguousarray(crop, dtype=np.uint8)
    fm = np.ascontiguousarray(fm, dtype=np.float32)
    out = np.empty_like(frame)
    lib.composite_frame(
        _u8(frame), _u8(crop),
        fm.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), _u8(out),
        frame.shape[0], frame.shape[1], y0, x0, rh, rw)
    return out
