"""Roofline accounting on an NVIDIA H100: peaks, per-kernel operation and
byte counts, and the bound a piece of work cannot beat.

Written for the port's CUDA kernels (``csrc/``), not copied from the JAX
package, whose peaks and byte models are a TPU's. The JAX module's API names
are kept: :func:`account`, :func:`pairs_query_flops`,
:func:`cpt_sweep_flops`, :func:`cpt_seed_flops`,
:func:`parity_binned_flops`, :func:`grid_total_flops`.

Peaks:

* HBM: 3.35e12 B/s (the H100 SXM's data sheet, at 700 W).
* FP32 outside the tensor cores: SMs x 128 FP32 lanes x the max SM clock,
  read on the card by :func:`fp32_peak` (about 3.3454e13 operations/s on a
  132-SM H100 at 1.98 GHz, :data:`FP32_PEAK_H100`). The data sheet's
  67 TFLOP/s counts a fused multiply-add as two operations; every kernel is
  built with ``-fmad=false``, so no multiply-add is fused and each lane
  retires at most one operation per clock.

Operation counts (:data:`FLOPS`, FP32 operations per pair, counted from the
CUDA sources; comparisons and selects are not counted):

* ``ladder``: the distance ladder (q - a, ``tri_record.cuh`` dist2 and the
  running min);
* ``axis``: one +axis crossing test (``sdf.cu`` crosses; its edges come
  from the record), and ``axis_tail``, needed only where the ray passes
  inside the triangle;
* ``normal``: the normal-side dot product;
* ``segment``: the segment test (``culled.cu`` add_crossing);
* ``parity``: the line-parity hit test (``parity.cu``: the transverse
  offsets and three edge functions of every pair, with ac - ab once per
  triangle), and ``parity_tail`` (the division and the bucket) only where
  the line passes inside the triangle;
* ``sweep_candidate``: one sweep candidate (``sweep.cu``: the ladder on the
  candidate's record, the merge's first compare in place of the running
  min, and the square root). A directional sweep evaluates 18 candidates
  per cell.
* ``phase_a_box``: CULLED phase A's box distance from a sub-tile centre to
  one block AABB (``phase_a.cu``: six differences, the sum of squares,
  the root), and ``phase_a_fine``: its csphere bound to one window
  triangle (three differences, the sum of squares, the root, minus the
  radius); :func:`phase_a_work` counts both.

Byte models count each input read once and each output written once. The
CPT sweep's state is x-first, the cell's two best (distance, id) pairs
(d1, i1, d2, i2): 16 B per cell, read and written by every directional
sweep, which also reads each triangle's 80 B record once
(:func:`sweep_bytes`).
"""
from __future__ import annotations

import subprocess

import numpy as np

#: HBM bandwidth of the H100 SXM at 700 W (NVIDIA's data sheet), B/s.
PEAK_BYTES = 3.35e12
#: SMs x 128 lanes x max SM clock of a 132-SM H100 at 1980 MHz; the
#: default peak where the card's own (:func:`fp32_peak`) is not at hand.
FP32_PEAK_H100 = 132 * 128 * 1980e6

#: FP32 operations per pair (see the module docstring).
FLOPS = {"ladder": 53, "axis": 13, "axis_tail": 10, "normal": 5,
         "segment": 43, "parity": 15, "parity_tail": 13,
         "sweep_candidate": 54, "phase_a_box": 12, "phase_a_fine": 10}
#: Candidates a directional sweep evaluates per cell.
SWEEP_CANDIDATES = 18
#: Bytes of the sweep state per cell (d1, i1, d2, i2), read and written.
SWEEP_STATE_BYTES = 16
#: Bytes of one packed sweep record (``SweepTris.rec``: 20 float32).
SWEEP_RECORD_BYTES = 80


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the first card, as in
    "NVIDIA H100 80GB HBM3, 700.00 W": the line every measured number is
    written beside."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def fp32_peak() -> float:
    """SMs x 128 FP32 lanes x max SM clock (``nvidia-smi``) of CUDA card 0,
    operations/s."""
    import torch

    out = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    mhz = float(out.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * 128 * mhz * 1e6


def bound(flops: float, nbytes: float, peak_fp32: float):
    """(ms, "operations" or "bytes"): the least time the card could take for
    ``flops`` FP32 operations and ``nbytes`` of HBM traffic, the larger of
    the two times, and which one it is. ``peak_fp32`` is the card's FP32
    rate (:func:`fp32_peak`)."""
    t_ops, t_bytes = flops / peak_fp32, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), (
        "operations" if t_ops >= t_bytes else "bytes")


def phase_a_work(n_sub, n_blocks, tb, c, kg=None):
    """FP32 operations and HBM bytes of one phase-A launch
    (``culled._phase_a_hier``): every centre's box distance to every block
    and csphere bound to every triangle of its window of c' = min(c, B - 1)
    blocks; the centres, AABBs and csphere table read once, the ``kg`` ids
    and one bound (or the full window's bounds and ids) written once."""
    cc = min(c, n_blocks - 1)
    width = cc if kg is None else kg
    flops = n_sub * (n_blocks * FLOPS["phase_a_box"]
                     + cc * tb * FLOPS["phase_a_fine"])
    nbytes = (12 * n_sub + 24 * n_blocks + 16 * n_blocks * tb
              + n_sub * (4 * width + 4 + (4 * cc if kg is None else 0)))
    return {"flops": flops, "hbm_bytes": nbytes, "pairs": n_sub * cc * tb}


def raycast_flops(n_queries, n_tris, axes, counts):
    """FP32 operations of the raycast kernel's work on this data: every
    pair's ladder and crossing tests, and the crossing tails of the pairs
    that the run's ``counts`` show crossing (t > 0). The pairs whose ray
    line passes inside at t <= 0 (about as many, a few per query) are left
    out, so this stays a lower count."""
    return (n_queries * n_tris * (FLOPS["ladder"] + axes * FLOPS["axis"])
            + FLOPS["axis_tail"] * int(counts.sum()))


def parity_flops(pairs, counts):
    """FP32 operations of a line-parity kernel's work on this data: every
    pair's edge test, and the tails of the hits that the run's ``counts``
    show (counts[:, 0], every hit at t > 0 in a cell at or past cell 0).
    Pairs that pass inside at t <= 0 are left out, so this stays a lower
    count."""
    return pairs * FLOPS["parity"] + FLOPS["parity_tail"] * int(
        counts[:, 0].sum())


def sweep_flops(n_cells: int) -> float:
    """FP32 operations of one directional sweep over ``n_cells`` cells."""
    return float(n_cells) * SWEEP_CANDIDATES * FLOPS["sweep_candidate"]


def sweep_bytes(n_cells: int, n_records: int = 0) -> float:
    """HBM bytes of one directional sweep over ``n_cells`` cells: the state
    read and written once, and ``n_records`` packed records (the PAD record
    included) read once."""
    return (2.0 * SWEEP_STATE_BYTES * n_cells
            + float(SWEEP_RECORD_BYTES) * n_records)


def account(seconds: float, flops: float = 0.0, hbm_bytes: float = 0.0,
            peak_flops: float = FP32_PEAK_H100) -> dict:
    """Roofline summary for one timed region.

    ``bound`` names the limiting resource under the model: whichever of
    compute-time-at-peak vs HBM-time-at-peak is larger. When BOTH are a
    small fraction of the wall time (< 30%), the region is dominated by
    neither — launch latency, host work or dependency chains — and is
    labeled ``latency``.
    """
    out: dict = {"seconds": round(seconds, 4)}
    t_flops = flops / peak_flops if flops else 0.0
    t_bytes = hbm_bytes / PEAK_BYTES if hbm_bytes else 0.0
    if flops:
        out["achieved_gflops"] = round(flops / seconds / 1e9, 1)
        out["pct_fp32_peak"] = round(100.0 * t_flops / seconds, 1)
    if hbm_bytes:
        out["achieved_gbps"] = round(hbm_bytes / seconds / 1e9, 1)
        out["pct_hbm_peak"] = round(100.0 * t_bytes / seconds, 1)
    if flops or hbm_bytes:
        frac = max(t_flops, t_bytes) / seconds
        if frac < 0.30:
            out["bound"] = "latency"
        else:
            out["bound"] = "compute" if t_flops >= t_bytes else "bandwidth"
    return out


# ---------------------------------------------------------------------------
# Workload models
# ---------------------------------------------------------------------------

def pairs_query_flops(n_queries: int, n_tris: int,
                      raycast_axes: int = 3) -> dict:
    """The fused raycast kernel (``sdf.cu``): every (query, triangle) pair
    runs the ladder and ``raycast_axes`` crossing tests (tails not
    counted: a lower count). HBM: queries (12 B) and triangles (36 B) read
    once, the distance and three crossing counts (16 B) written once."""
    pairs = float(n_queries) * n_tris
    flops = pairs * (FLOPS["ladder"] + raycast_axes * FLOPS["axis"])
    hbm = 12.0 * n_queries + 36.0 * n_tris + 16.0 * n_queries
    return {"flops": flops, "hbm_bytes": hbm, "pairs": pairs}


def cpt_sweep_flops(n_cells: int, rounds: int = 1,
                    n_sweeps_per_round: int = 6, n_records: int = 0) -> dict:
    """CPT directional sweeps (``sweep.cu``): 18 candidates per cell per
    sweep; per sweep the :func:`sweep_bytes` of ``n_cells`` and
    ``n_records``."""
    sweeps = rounds * n_sweeps_per_round
    return {"flops": sweep_flops(n_cells) * sweeps,
            "hbm_bytes": sweep_bytes(n_cells, n_records) * sweeps,
            "evals_per_cell": SWEEP_CANDIDATES * sweeps}


def cpt_seed_flops(seed_bins, n_tris: int) -> dict:
    """The seed kernel's work (``csrc/seed.cu``, ``ops.cpt.seed_from_bins``)
    on ``n_tris`` triangles, counted from the gather lists: each real slot
    (an id below ``n_tris``) evaluates one candidate; HBM: ``entry_tri``,
    ``rows_cell``, ``cell_row`` and the ``n_tris + 1`` packed records read
    once, the four flat (N,) outputs (16 B a cell) written once."""
    entry = _host(seed_bins.entry_tri)
    rows_cell = _host(seed_bins.rows_cell)
    n_cells = _host(seed_bins.cell_row).size
    pairs = float(np.count_nonzero((entry >= 0) & (entry < n_tris)))
    hbm = (4.0 * (entry.size + rows_cell.size + n_cells)
           + float(SWEEP_RECORD_BYTES) * (n_tris + 1) + 16.0 * n_cells)
    return {"flops": pairs * FLOPS["sweep_candidate"], "hbm_bytes": hbm,
            "pairs": pairs}


def _host(a) -> np.ndarray:
    """A tensor's or an array's values as a numpy array on the host."""
    return np.asarray(a.detach().cpu() if hasattr(a, "detach") else a)


def parity_binned_flops(line_bins_3) -> dict:
    """Binned line-parity work (``parity.cu`` binned), counted from the
    candidate tables: every line of a tile against every triangle of each
    real block in its table (hit tails not counted: a lower count). HBM:
    the packed planes and the tables read once, 4 B per line written."""
    flops = hbm = pairs = 0.0
    for b in line_bins_3:
        n_lines = float(b.t1 * b.t2 * b.tile * b.tile)
        real = float((b.tbl != b.n_blocks).sum())
        p = real * b.tb * b.tile * b.tile
        pairs += p
        flops += p * FLOPS["parity"]
        hbm += (b.rows.numel() * b.rows.element_size()
                + b.tbl.numel() * b.tbl.element_size() + 4.0 * n_lines)
    return {"flops": flops, "hbm_bytes": hbm, "pairs": pairs}


def grid_total_flops(n_cells: int, seed_bins=None, line_bins_3=None,
                     rounds: int = 1, n_tris: int | None = None) -> dict:
    """The CPT ``generate_grid_sdf`` (raycast) model: seeds (of ``n_tris``
    triangles, which seed bins need) + sweeps + parity. Missing structures
    contribute zero."""
    parts = [cpt_sweep_flops(n_cells, rounds)]
    if seed_bins is not None:
        if n_tris is None:
            raise ValueError("seed bins need n_tris, the triangles' count")
        parts.append(cpt_seed_flops(seed_bins, n_tris))
    if line_bins_3 is not None:
        parts.append(parity_binned_flops(line_bins_3))
    return {"flops": sum(p["flops"] for p in parts),
            "hbm_bytes": sum(p["hbm_bytes"] for p in parts)}
