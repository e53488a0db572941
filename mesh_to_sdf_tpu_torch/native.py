"""ctypes bindings for the shared native C++ host library (native/libm2s.so).

The host-side runtime: GLB framing, accessor decode, Morton preprocessing,
SDF container packing and the CPT seed bins. Each takes and gives numpy
arrays. The library lives at the repo root and is shared with the JAX
package; build it with ``make -C native`` (or set ``M2S_NATIVE_BUILD=1`` to
build it at first use). Without it every entry point raises
``RuntimeError``, and the callers take their Python paths: the numpy seed
bins of ``ops.cpt.build_seed_bins``, the GLB parser and accessor decode of
``io.gltf``, and the container codec of ``io.serde``.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path
from typing import Optional, Tuple

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

    u64 = ctypes.c_uint64
    u32 = ctypes.c_uint32
    p_u8 = ctypes.POINTER(ctypes.c_uint8)
    p_u32 = ctypes.POINTER(ctypes.c_uint32)
    p_u64 = ctypes.POINTER(ctypes.c_uint64)
    p_f32 = ctypes.POINTER(ctypes.c_float)
    p_i32 = ctypes.POINTER(ctypes.c_int32)

    lib.m2s_glb_chunks.argtypes = [p_u8, u64, p_u64, p_u64, p_u64, p_u64]
    lib.m2s_glb_chunks.restype = ctypes.c_int
    lib.m2s_accessor_to_f32.argtypes = [p_u8, u64, u64, u64, u32, u32, u32,
                                        p_f32]
    lib.m2s_accessor_to_f32.restype = ctypes.c_int
    lib.m2s_accessor_to_u32.argtypes = [p_u8, u64, u64, u64, u32, u32, p_u32]
    lib.m2s_accessor_to_u32.restype = ctypes.c_int
    lib.m2s_seed_bins.argtypes = [p_i32, p_i32, u64, p_u32, u32, p_u32]
    lib.m2s_seed_bins.restype = u64
    lib.m2s_copy_seed_bins.argtypes = [p_i32, p_i32, p_i32]
    lib.m2s_copy_seed_bins.restype = None
    lib.m2s_morton3d.argtypes = [p_f32, u64, p_f32, p_f32, p_u64]
    lib.m2s_morton3d.restype = None
    lib.m2s_argsort_u64.argtypes = [p_u64, u64, p_u32]
    lib.m2s_argsort_u64.restype = None
    lib.m2s_pack_grid_sdf.argtypes = [p_f32, p_f32, p_u32, p_f32]
    lib.m2s_pack_grid_sdf.restype = u64
    lib.m2s_pack_generic_sdf.argtypes = [p_f32, p_f32, u64]
    lib.m2s_pack_generic_sdf.restype = u64
    lib.m2s_copy_packed.argtypes = [p_u8]
    lib.m2s_copy_packed.restype = None
    lib.m2s_version.restype = ctypes.c_int
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _need() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("native/libm2s.so is not built (make -C native)")
    return lib


def version() -> int:
    """The library's own version number (``m2s_version``)."""
    return int(_need().m2s_version())


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


# ---------------------------------------------------------------- GLB framing
def glb_chunks(data: bytes) -> Tuple[bytes, Optional[bytes]]:
    """Native GLB container split → (json_bytes, bin_bytes|None).

    Raises ValueError on malformed input (same contract as the Python parser,
    ``io.gltf._parse_glb``).
    """
    lib = _need()
    buf = np.frombuffer(data, np.uint8)
    offs = [ctypes.c_uint64() for _ in range(4)]
    rc = lib.m2s_glb_chunks(
        _ptr(buf, ctypes.c_uint8), len(data), *[ctypes.byref(o) for o in offs]
    )
    if rc != 0:
        raise ValueError(f"malformed GLB (native rc={rc})")
    jo, jl, bo, bl = (o.value for o in offs)
    js = data[jo : jo + jl]
    bn = data[bo : bo + bl] if bl else None
    return js, bn


def accessor_to_f32(buf: bytes, base: int, stride: int, count: int,
                    ncomp: int, component_type: int) -> np.ndarray:
    """A glTF accessor's elements as (count, ncomp) float32."""
    lib = _need()
    src = np.frombuffer(buf, np.uint8)
    out = np.empty((count, ncomp), np.float32)
    rc = lib.m2s_accessor_to_f32(
        _ptr(src, ctypes.c_uint8), len(buf), base, stride, count, ncomp,
        component_type, _ptr(out, ctypes.c_float),
    )
    if rc != 0:
        raise ValueError(f"accessor decode failed (native rc={rc})")
    return out


def accessor_to_u32(buf: bytes, base: int, stride: int, count: int,
                    component_type: int) -> np.ndarray:
    """A glTF index accessor as (count,) uint32."""
    lib = _need()
    src = np.frombuffer(buf, np.uint8)
    out = np.empty((count,), np.uint32)
    rc = lib.m2s_accessor_to_u32(
        _ptr(src, ctypes.c_uint8), len(buf), base, stride, count,
        component_type, _ptr(out, ctypes.c_uint32),
    )
    if rc != 0:
        raise ValueError(f"index decode failed (native rc={rc})")
    return out


# ------------------------------------------------------------- seed binning
def seed_bins(lo_cell: np.ndarray, hi_cell: np.ndarray, counts, k: int):
    """Native CPT seed-bin layout (see ops/cpt.py::build_seed_bins).

    lo_cell/hi_cell: (T, 3) int32 clipped window corners. Returns
    (entry (k, R_pad) int32 — K-major, see SeedBins, rows_cell (R_pad,)
    int32, cell_row (N,) int32, n_rounds int).
    """
    lib = _need()
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


# ------------------------------------------------------------------- Morton
def morton_argsort(points: np.ndarray) -> np.ndarray:
    """Morton-order permutation (int64) of (N, 3) points: 21-bit-per-axis
    codes over the points' bounding box. Equal codes come in no set order
    (the torch engines order by ``ops.culling._morton_order``)."""
    lib = _need()
    pts = np.ascontiguousarray(points, np.float32)
    n = len(pts)
    lo = pts.min(axis=0) if n else np.zeros(3, np.float32)
    hi = pts.max(axis=0) if n else np.ones(3, np.float32)
    lo = np.ascontiguousarray(lo, np.float32)
    hi = np.ascontiguousarray(hi, np.float32)
    codes = np.empty(n, np.uint64)
    lib.m2s_morton3d(
        _ptr(pts, ctypes.c_float), n, _ptr(lo, ctypes.c_float),
        _ptr(hi, ctypes.c_float), _ptr(codes, ctypes.c_uint64),
    )
    perm = np.empty(n, np.uint32)
    lib.m2s_argsort_u64(_ptr(codes, ctypes.c_uint64), n,
                        _ptr(perm, ctypes.c_uint32))
    return perm.astype(np.int64)


# ---------------------------------------------------------------- SDF packing
def _copy_packed(lib, n: int) -> bytes:
    if n == 0:
        raise ValueError("SDF payload exceeds msgpack bin32 (2^32 bytes)")
    out = np.empty(n, np.uint8)
    lib.m2s_copy_packed(_ptr(out, ctypes.c_uint8))
    return out.tobytes()


def pack_grid_sdf(first_cell, cell_size, cell_count, distances) -> bytes:
    """The ``io.serde.dumps`` container of a grid SDF, byte for byte."""
    lib = _need()
    fc = np.ascontiguousarray(first_cell, np.float32)
    cs = np.ascontiguousarray(cell_size, np.float32)
    cc = np.ascontiguousarray(cell_count, np.uint32)
    d = np.ascontiguousarray(distances, np.float32).reshape(-1)
    return _copy_packed(lib, lib.m2s_pack_grid_sdf(
        _ptr(fc, ctypes.c_float), _ptr(cs, ctypes.c_float),
        _ptr(cc, ctypes.c_uint32), _ptr(d, ctypes.c_float),
    ))


def pack_generic_sdf(query_points, distances) -> bytes:
    """The ``io.serde.dumps`` container of a generic SDF, byte for byte."""
    lib = _need()
    q = np.ascontiguousarray(query_points, np.float32).reshape(-1, 3)
    d = np.ascontiguousarray(distances, np.float32).reshape(-1)
    return _copy_packed(lib, lib.m2s_pack_generic_sdf(
        _ptr(q, ctypes.c_float), _ptr(d, ctypes.c_float), len(q)
    ))
