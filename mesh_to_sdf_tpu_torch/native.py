"""ctypes binding for the shared native C++ host library (native/libm2s.so).

Only the CPT seed-binning entry point is bound here; it is the one native
call on the grid path (``ops.cpt.build_seed_bins``). The library lives at the
repo root and is shared with the JAX package; build it with
``make -C native`` (or set ``M2S_NATIVE_BUILD=1`` to build it at first
use). Without it, ``build_seed_bins`` uses its numpy fallback.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_LIB_PATH = Path(__file__).resolve().parent.parent / "native" / "libm2s.so"
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    path = os.environ.get("M2S_NATIVE_LIB", str(_LIB_PATH))
    if not Path(path).exists() and os.environ.get("M2S_NATIVE_BUILD") == "1":
        # Opt-in build (idempotent, quiet, never fatal); tests/conftest.py
        # opts in, since the library is not under version control.
        mk = Path(path).parent / "Makefile"
        if mk.exists():
            try:
                subprocess.run(
                    ["make", "-C", str(mk.parent)],
                    capture_output=True,
                    timeout=120,
                    check=False,
                )
            except (OSError, subprocess.TimeoutExpired):
                pass
    if not Path(path).exists():
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None

    u32 = ctypes.c_uint32
    u64 = ctypes.c_uint64
    p_u32 = ctypes.POINTER(ctypes.c_uint32)
    p_i32 = ctypes.POINTER(ctypes.c_int32)
    lib.m2s_seed_bins.argtypes = [p_i32, p_i32, u64, p_u32, u32, p_u32]
    lib.m2s_seed_bins.restype = u64
    lib.m2s_copy_seed_bins.argtypes = [p_i32, p_i32, p_i32]
    lib.m2s_copy_seed_bins.restype = None
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def seed_bins(lo_cell: np.ndarray, hi_cell: np.ndarray, counts, k: int):
    """Native CPT seed-bin layout (see ops/cpt.py::build_seed_bins).

    lo_cell/hi_cell: (T, 3) int32 clipped window corners. Returns
    (entry (k, R_pad) int32 — K-major, see SeedBins, rows_cell (R_pad,)
    int32, cell_row (N,) int32, n_rounds int).
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native/libm2s.so is not built (make -C native)")
    lo = np.ascontiguousarray(lo_cell, np.int32)
    hi = np.ascontiguousarray(hi_cell, np.int32)
    cc = np.ascontiguousarray(counts, np.uint32)
    n_cells = int(np.prod(cc.astype(np.int64)))
    rounds = ctypes.c_uint32()
    r_pad = lib.m2s_seed_bins(
        _ptr(lo, ctypes.c_int32), _ptr(hi, ctypes.c_int32), len(lo),
        _ptr(cc, ctypes.c_uint32), k, ctypes.byref(rounds),
    )
    entry = np.empty((k, r_pad), np.int32)
    rows = np.empty((r_pad,), np.int32)
    cell_row = np.empty((n_cells,), np.int32)
    lib.m2s_copy_seed_bins(
        _ptr(entry, ctypes.c_int32), _ptr(rows, ctypes.c_int32),
        _ptr(cell_row, ctypes.c_int32),
    )
    return entry, rows, cell_row, int(rounds.value)
