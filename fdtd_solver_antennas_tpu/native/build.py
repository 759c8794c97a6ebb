"""Build/load the native (C++) voxelizer core via ctypes.

The reference's geometry rasterization lives in CSXCAD.dll (C++); this
framework keeps the same split — a small C ABI library for the host-side
containment hot loop — but builds it from in-repo source on first use with
``g++`` and falls back to the NumPy implementation when no toolchain is
available. No pybind11: plain ctypes over an ``extern "C"`` interface.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / "voxelize.cpp"
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

BOX_DOUBLES = 22


def _build_library() -> Optional[Path]:
    out = _HERE / "_libvoxelize.so"
    if out.exists() and out.stat().st_mtime >= _SRC.stat().st_mtime:
        return out
    # compile to a process-unique temp name and os.replace() into place:
    # g++ writes non-atomically, and a concurrent process (pytest-xdist,
    # multi-process sweeps) could dlopen a half-written .so, fail, and
    # silently fall back to the slow NumPy path for its whole lifetime
    tmp = _HERE / f"_libvoxelize.{os.getpid()}.tmp.so"
    cmd = [
        "g++", "-O3", "-shared", "-fPIC", "-std=c++17",
        str(_SRC), "-o", str(tmp),
    ]
    try:
        subprocess.run(
            cmd, check=True, capture_output=True, timeout=120
        )
        os.replace(tmp, out)
        return out
    except Exception:
        try:
            tmp.unlink(missing_ok=True)
        except OSError:
            pass
        return None


def get_voxelize_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None on failure."""
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        if os.environ.get("FDTD_DISABLE_NATIVE"):
            return None
        path = _build_library()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        dp = ctypes.POINTER(ctypes.c_double)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i64 = ctypes.c_int64
        lib.box_contains_or.argtypes = [dp, i64, dp, u8p]
        lib.box_contains_or.restype = None
        lib.paint_materials.argtypes = [dp, i64, dp, dp, i64, dp, dp]
        lib.paint_materials.restype = None
        fp = ctypes.POINTER(ctypes.c_float)
        try:
            lib.cell_edge_avg_f32.argtypes = [
                fp, i64, i64, i64, ctypes.c_int, fp
            ]
            lib.cell_edge_avg_f32.restype = None
            lib.cell_edge_avg_f64.argtypes = [
                dp, i64, i64, i64, ctypes.c_int, dp
            ]
            lib.cell_edge_avg_f64.restype = None
        except AttributeError:
            # a stale .so predating the fused edge-average (mtime can lie
            # after a git checkout): keep the voxelize entry points, let
            # callers hasattr-gate onto the NumPy fallback for the rest
            pass
        _LIB = lib
        return _LIB


def native_available() -> bool:
    return get_voxelize_lib() is not None
