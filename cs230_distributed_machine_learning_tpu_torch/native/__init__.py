"""Native (C++) data-plane components, ctypes-bound.

A copy of the JAX package's ``native/`` (framework-free). First
component: the CSV loader (csv_loader.cpp, the JAX package's file) —
mmap + multithreaded parse replacing pandas for fully-numeric tables
(covertype, MNIST, synthetics) and the Python line count in metadata
collection.

The shared library is compiled on first use with g++ into
``<storage.root>/native/`` (keyed by source hash, so upgrades rebuild) and
loaded with ctypes — no pybind11 dependency. Every caller must handle
``get_lib() is None`` and take the pure-Python path: machines without a
toolchain lose speed, not capability. The rules for when pandas parses a
table (a string column, a quoted header, labels >= 2^24) are the
callers' (``data/datasets.py::load_table``) and are semantics, not a
fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "csv_loader.cpp")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_failed = False


def _build_dir() -> str:
    from ..utils.config import get_config

    return os.path.join(get_config().storage.root, "native")


def _compile(src: str, out: str) -> bool:
    cmd = [
        "g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
        src, "-o", out,
    ]
    try:
        res = subprocess.run(cmd, capture_output=True, timeout=120)
        return res.returncode == 0 and os.path.exists(out)
    except (OSError, subprocess.TimeoutExpired):
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded native library, compiling it on first call; None if the
    source is missing, g++ is unavailable, or compilation fails."""
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        try:
            with open(_SRC, "rb") as f:
                tag = hashlib.sha256(f.read()).hexdigest()[:16]
            so_path = os.path.join(_build_dir(), f"csv_loader_{tag}.so")
            if not os.path.exists(so_path):
                os.makedirs(os.path.dirname(so_path), exist_ok=True)
                tmp = so_path + f".build{os.getpid()}"
                if not _compile(_SRC, tmp):
                    _lib_failed = True
                    return None
                os.replace(tmp, so_path)  # atomic vs concurrent builders
            lib = ctypes.CDLL(so_path)
            lib.csv_dims.argtypes = [
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64),
            ]
            lib.csv_dims.restype = ctypes.c_int
            lib.csv_parse_f32.argtypes = [
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_float),
                ctypes.c_int64,
                ctypes.c_int64,
                ctypes.POINTER(ctypes.c_uint8),
            ]
            lib.csv_parse_f32.restype = ctypes.c_int64
            _lib = lib
        except Exception:  # noqa: BLE001 — any failure degrades to Python
            _lib_failed = True
        return _lib


def csv_dims(path: str) -> Optional[Tuple[int, int]]:
    """(n_rows, n_cols) of a headered CSV via the native scanner, or None."""
    lib = get_lib()
    if lib is None:
        return None
    rows = ctypes.c_int64()
    cols = ctypes.c_int64()
    if lib.csv_dims(path.encode(), ctypes.byref(rows), ctypes.byref(cols)) != 0:
        return None
    return int(rows.value), int(cols.value)


def csv_parse_f32(path: str) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Parse a headered CSV to (matrix float32 [rows, cols], numeric_ok bool
    per column). Returns None when the native path is unavailable or the
    file can't be read; the caller decides what to do with non-numeric
    columns (``load_table``: pandas label-encoding)."""
    lib = get_lib()
    if lib is None:
        return None
    dims = csv_dims(path)
    if dims is None or dims[0] <= 0 or dims[1] <= 0:
        return None
    n_rows, n_cols = dims
    out = np.empty((n_rows, n_cols), dtype=np.float32)
    ok = np.ones(n_cols, dtype=np.uint8)
    parsed = lib.csv_parse_f32(
        path.encode(),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n_rows,
        n_cols,
        ok.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    if parsed < 0:
        return None
    return out[:parsed], ok.astype(bool)
