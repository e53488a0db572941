"""The CPT seed's wrapper (``ops.kernels.seed``) on the CPU: the dispatch
to the plain version, the input checks, and the tie rule that the seed
kernel (``csrc/seed.cu``, held bit-equal on the card by
``test_torch_kernels_cuda.py``) keeps, written out on hand-made bins.

Each case's triangles are copies of a few shapes, so cells hold equal
distances under distinct ids: only the rule decides which id is the best
and which the runner-up.
"""
import numpy as np
import pytest
import torch

import mesh_to_sdf_tpu_torch as tm
from mesh_to_sdf_tpu_torch import F32_MAX
from mesh_to_sdf_tpu_torch.ops import cpt
from mesh_to_sdf_tpu_torch.ops.kernels import seed as seed_k
from mesh_to_sdf_tpu_torch.ops.kernels import sweep
from mesh_to_sdf_tpu_torch.utils.meshgen import icosphere

#: Two cells at z = 0 and z = 1; the FAR triangle lies at z = 5, the NEAR
#: one at z = 3, both over the cells.
GRID = tm.Grid.new([0.0, 0.0, 0.0], [1.0, 1.0, 1.0], (1, 1, 2))
FAR = np.array([[-1, -1, 5], [2, -1, 5], [-1, 2, 5]], np.float32)
NEAR = FAR - np.array([0, 0, 2], np.float32)


def _soup(shapes):
    """(ta, tb, tc) of the triangles listed by shape (FAR or NEAR)."""
    v = np.stack(shapes)
    return tuple(torch.from_numpy(np.ascontiguousarray(v[:, k]))
                 for k in range(3))


def _bins(rows, n_tris, n_rounds, n_cells=2):
    """SeedBins of ``rows`` [(cell, [ids])], consecutive per cell, each
    padded to the longest row with id ``n_tris``, then padding rows up to
    a power of two of at least 8 and 2^n_rounds (as the builder pads)."""
    k = max(len(ids) for _, ids in rows)
    r_pad = max(8, 1 << n_rounds, 1 << len(rows).bit_length())
    entry = np.full((k, r_pad), n_tris, np.int32)
    rows_cell = np.full((r_pad,), n_cells, np.int32)
    cell_row = np.full((n_cells,), -1, np.int32)
    for r, (cell, ids) in enumerate(rows):
        entry[:len(ids), r] = ids
        rows_cell[r] = cell
        if cell_row[cell] < 0:
            cell_row[cell] = r
    return cpt.SeedBins(entry, rows_cell, cell_row, n_rounds)


#: name: (triangle shapes, rows, shift rounds, cell 0's (best, runner-up)).
CASES = {
    # One row: the first minimum in slot order, then the first minimum
    # among the other ids.
    "row": ([FAR] * 4, [(0, [2, 0, 1, 3])], 0, (2, 0)),
    # A repeated id is masked for the runner-up.
    "row-repeated-id": ([FAR] * 2, [(0, [1, 1, 0])], 0, (1, 0)),
    # A closer slot later in the row wins; the old best is the runner-up.
    "row-closer-later": ([FAR, FAR, NEAR], [(0, [0, 1, 2])], 0, (2, 0)),
    # Two rows: the earlier row wins the tie for best; the runner-up is
    # the first minimum of [loser's best, earlier runner-up, later
    # runner-up], so the later row's best (2), not the earlier runner-up.
    "two-rows": ([FAR] * 4, [(0, [0, 1]), (0, [2, 3])], 1, (0, 2)),
    # Three rows, two rounds: ((0, 1) + (2, 3)) then + (4, 5), whose
    # loser's best (4) comes first.
    "three-rows": ([FAR] * 6, [(0, [0, 1]), (0, [2, 3]), (0, [4, 5])], 2,
                   (0, 4)),
    # Four rows: ((0, 1) + (2, 3)) + ((4, 5) + (6, 7)).
    "four-rows": ([FAR] * 8, [(0, [0, 1]), (0, [2, 3]), (0, [4, 5]),
                              (0, [6, 7])], 2, (0, 4)),
    # A closer later row takes the best; the earlier row's best is the
    # loser's best and comes first among the runner-up candidates.
    "later-row-closer": ([FAR, FAR, NEAR, FAR], [(0, [0, 1]), (0, [2, 3])],
                         1, (2, 0)),
    # A merge round beyond the cell's rows changes nothing.
    "extra-round": ([FAR] * 4, [(0, [0, 1]), (0, [2, 3])], 3, (0, 2)),
    # Fewer rounds than rows: the tree reaches the first 2^n rows only.
    "short-tree": ([FAR, FAR, NEAR], [(0, [0]), (0, [1]), (0, [2])], 1,
                   (0, 1)),
}


@pytest.mark.parametrize("name", CASES)
def test_seed_tie_rule(name):
    """The contract the seed kernel keeps, on the plain version: cell 0's
    ids as the case states, its distances those of its ids' shapes, cell 1
    unseeded (F32_MAX, -1)."""
    shapes, rows, n_rounds, (best, runner_up) = CASES[name]
    tris = _soup(shapes)
    bins = _bins(rows, len(shapes), n_rounds)
    d1, i1, d2, i2 = cpt.seed_from_bins(GRID, *tris, bins)
    assert (int(i1[0]), int(i2[0])) == (best, runner_up)
    one = [cpt.seed_from_bins(GRID, *(t[i:i + 1] for t in tris),
                              _bins([(0, [0])], 1, 0))[0][0]
           for i in (best, runner_up)]
    assert torch.equal(d1[0], one[0]) and torch.equal(d2[0], one[1])
    assert (float(d1[1]), int(i1[1]), float(d2[1]), int(i2[1])) == (
        F32_MAX, -1, F32_MAX, -1)


def test_seed_padding_slots_and_rows_take_no_part():
    """A row of one triangle and padding slots: runner-up (F32_MAX, -1);
    the padding row at the end and the unseeded cell stay sentinels."""
    tris = _soup([FAR, NEAR])
    bins = _bins([(1, [1])], 2, 0)
    d1, i1, d2, i2 = cpt.seed_from_bins(GRID, *tris, bins)
    assert i1.tolist() == [-1, 1] and i2.tolist() == [-1, -1]
    assert d1[0] == F32_MAX and d2.tolist() == [F32_MAX, F32_MAX]
    assert 0.0 < float(d1[1]) < 3.0


def test_cpu_tensors_take_the_plain_version():
    """CPU tensors: one plain call, no launch; given records (shared with
    the sweeps) change no bit."""
    verts, faces = icosphere(2)
    grid = tm.Grid.from_bounding_box([-1.3] * 3, [1.3] * 3, [12, 10, 8])
    v = verts[faces]
    soup = tuple(torch.from_numpy(np.ascontiguousarray(v[:, k]))
                 for k in range(3))
    bins = cpt.build_seed_bins(grid, *(t.numpy() for t in soup),
                               pad=cpt.seed_pad_for(grid))
    assert bins.n_shift_rounds >= 2
    before = (seed_k.COUNT.kernel, seed_k.COUNT.plain)
    got = cpt.seed_from_bins(grid, *soup, bins)
    assert (seed_k.COUNT.kernel, seed_k.COUNT.plain) == (before[0],
                                                         before[1] + 1)
    records = sweep.sweep_tris(*soup)
    again = cpt.seed_from_bins(grid, *soup, bins, records)
    for a, b in zip(again, got):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    d_a, i_a = cpt.closest_point_grid(grid, *soup, seed=got)
    d_b, i_b = cpt.closest_point_grid(grid, *soup, seed=got, tris=records)
    assert torch.equal(d_a, d_b) and torch.equal(i_a, i_b)


def _meta_inputs():
    """(grid, soup, bins, records) of 4 triangles on a 2 x 3 x 4 grid, as
    meta tensors (no data)."""
    grid = tm.Grid.new([0.0] * 3, [1.0] * 3, (2, 3, 4))
    soup = tuple(torch.empty((4, 3), device="meta") for _ in range(3))
    bins = cpt.SeedBins(torch.empty((8, 16), dtype=torch.int32,
                                    device="meta"),
                        torch.empty((16,), dtype=torch.int32, device="meta"),
                        torch.empty((24,), dtype=torch.int32, device="meta"),
                        1)
    records = sweep.SweepTris(torch.empty((5, 9), device="meta"),
                              torch.empty((5, 20), device="meta"))
    return grid, soup, bins, records


#: name: (what to change in the meta inputs, the message it raises).
BAD = {
    "tb-shape": (lambda g, s, b, r: (g, (s[0], s[1][:3], s[2]), b, r), "tb"),
    "ta-dtype": (lambda g, s, b, r: (g, (s[0].double(),) + s[1:], b, r),
                 "ta"),
    "entry-dtype": (lambda g, s, b, r: (g, s, b._replace(
        entry_tri=b.entry_tri.long()), r), "entry_tri"),
    "entry-1d": (lambda g, s, b, r: (g, s, b._replace(
        entry_tri=b.entry_tri[0]), r), "entry_tri"),
    "rows-cell-length": (lambda g, s, b, r: (g, s, b._replace(
        rows_cell=b.rows_cell[:8]), r), "rows_cell"),
    "cell-row-length": (lambda g, s, b, r: (tm.Grid.new(
        [0.0] * 3, [1.0] * 3, (2, 3, 5)), s, b, r), "cell_row"),
    "rounds": (lambda g, s, b, r: (g, s, b._replace(n_shift_rounds=31), r),
               "n_shift_rounds"),
    "records-shape": (lambda g, s, b, r: (g, s, b, r._replace(
        rec=r.rec[:4])), "tris.rec"),
    "too-many-cells": (lambda g, s, b, r: (tm.Grid.new(
        [0.0] * 3, [1.0] * 3, (2048, 1024, 1024)), s, b, r), "cells"),
}


@pytest.mark.parametrize("name", BAD)
def test_seed_wrapper_rejects_bad_inputs(name):
    """Bad shapes and dtypes are refused before any device is asked; meta
    tensors hold no data, so well-formed ones stop at the device check."""
    change, match = BAD[name]
    grid, soup, bins, records = change(*_meta_inputs())
    with pytest.raises(ValueError, match=match):
        cpt.seed_from_bins(grid, *soup, bins, records)


def test_seed_wrapper_has_no_kernel_for_meta():
    grid, soup, bins, records = _meta_inputs()
    before = (seed_k.COUNT.kernel, seed_k.COUNT.plain)
    with pytest.raises(ValueError, match="no kernel"):
        cpt.seed_from_bins(grid, *soup, bins, records)
    assert (seed_k.COUNT.kernel, seed_k.COUNT.plain) == before
