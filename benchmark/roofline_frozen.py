"""Frozen roofline arithmetic of the benchmark: the card's peaks and the
work a layer's inputs need, counted from the grid, the mesh and the
queries alone (never from the port's own prep, which a later change may
schedule differently).

Copied from ``mesh_to_sdf_tpu_torch/utils/roofline.py`` (``FLOPS``,
``sweep_flops``, ``sweep_bytes``) and frozen here, so that a change to the
port cannot move the yardstick. The peaks are NVIDIA's data sheet for the
H100 SXM at its 700 W limit: 67 TFLOP/s FP32 outside the tensor cores
(a fused multiply-add counted as two operations) and 3.35 TB/s of HBM.
The port builds its kernels with ``-fmad=false``, so no multiply-add is
fused and its FP32 code can reach at most half of 67 TFLOP/s; a share of
this peak therefore reads at most 50 % for FP32 code of the port.
"""
from __future__ import annotations

#: NVIDIA H100 SXM data sheet, at a 700 W power limit.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12

#: FP32 operations per pair (counted from the port's CUDA sources when
#: frozen; comparisons and selects not counted). ``sweep_candidate``: one
#: sweep candidate (the distance ladder on its record, the merge's first
#: compare, the square root).
FLOPS = {"ladder": 53, "axis": 13, "axis_tail": 10, "normal": 5,
         "segment": 43, "parity": 15, "parity_tail": 13,
         "sweep_candidate": 54}
#: Candidates one directional sweep evaluates per cell.
SWEEP_CANDIDATES = 18
#: Directional sweeps of one CPT round (x, y, z; each way).
SWEEPS = 6
#: Bytes of the sweep state per cell (d1, i1, d2, i2), read and written.
SWEEP_STATE_BYTES = 16
#: Bytes of one packed triangle record a sweep reads.
SWEEP_RECORD_BYTES = 80


def sweep_flops(n_cells: int) -> float:
    """FP32 operations of one directional sweep over ``n_cells`` cells."""
    return float(n_cells) * SWEEP_CANDIDATES * FLOPS["sweep_candidate"]


def sweep_bytes(n_cells: int, n_records: int = 0) -> float:
    """HBM bytes of one directional sweep: the state read and written
    once, ``n_records`` records read once."""
    return (2.0 * SWEEP_STATE_BYTES * n_cells
            + float(SWEEP_RECORD_BYTES) * n_records)


def sweep_bound_s(n_cells: int, n_triangles: int) -> float:
    """The least time one CPT round of sweeps could take on the card: the
    larger of its operations over the FP32 peak and its bytes over the HBM
    peak, for ``n_cells`` grid cells and the mesh's ``n_triangles`` (one
    record each, and the pad record)."""
    ops = SWEEPS * sweep_flops(n_cells)
    nbytes = SWEEPS * sweep_bytes(n_cells, n_triangles + 1)
    return max(ops / PEAK_FP32, nbytes / PEAK_BYTES)
