"""Cells of ``generate_grid_sdf`` into a host buffer: the CPT route slab by
slab (``gridgen_streamed``), the field written into memory the caller
owns, as the reference returns its ``Vec<f32>``.

As ``entries/grid.py`` (the configuration's grid and sign through AUTO,
the same sampled cells and guarantee), but every call passes ``out=``: one
float32 host buffer of the grid's cells, allocated and written once in
set-up and reused by every call, as a baker that saves each field reuses
its buffer (the window does not time the first touch of fresh pages).
"""
from __future__ import annotations

import numpy as np

import mesh_to_sdf_tpu_torch as tm
from benchmark.entries import grid


class Entry(grid.Entry):
    def __init__(self, config: dict, feed, device, seed: int):
        super().__init__(config, feed, device, seed)
        self.buf = np.empty(int(np.prod(self.cells)), np.float32)
        self.buf.fill(0.0)

    def call(self, i: int):
        """One timed call: call ``i``'s field in the host buffer (the view
        ``generate_grid_sdf`` returns)."""
        return tm.generate_grid_sdf(self.feed.vertices(i), self.topo,
                                    self.grid, self.sign,
                                    device=self.device, out=self.buf)

    def release(self) -> None:
        """Free the program's state: both content-keyed prep caches, and
        the buffer."""
        from mesh_to_sdf_tpu_torch import gridgen_streamed

        super().release()
        gridgen_streamed._STREAM_PREP_CACHE.clear()
        self.buf = None
