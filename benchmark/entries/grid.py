"""Cells of ``generate_grid_sdf``: a grid over a mesh per call.

The timed call is ``generate_grid_sdf(vertices, Topology, Grid, sign)``
with the configuration's grid and sign, through AUTO. Its answers are held
against the plain reference at a sample of cells drawn from the seed, in
the fields that timed calls produced, on their own meshes, by the
configuration's guarantee (``"cpt_contract"``: the CPT route's contract).
"""
from __future__ import annotations

import numpy as np
import torch

import mesh_to_sdf_tpu_torch as tm
from benchmark.harness.traffic import derive


class Entry:
    def __init__(self, config: dict, feed, device, seed: int):
        args = config["args"]
        g = args["grid"]
        self.lo = np.asarray(g["lo"], np.float32)
        self.hi = np.asarray(g["hi"], np.float32)
        self.cells = tuple(int(c) for c in g["cells"])
        self.grid = tm.Grid.from_bounding_box(self.lo, self.hi, self.cells)
        self.sign = tm.SignMethod[args.get("sign_method", "raycast").upper()]
        self.topo = tm.Topology.triangle_list(feed.faces.reshape(-1))
        self.feed = feed
        self.device = torch.device(device)
        self.guarantee = config["guarantee"]
        self.work_per_call = float(np.prod(self.cells))
        check = config["check"]
        rng = np.random.default_rng(derive(seed, "check cells"))
        n = int(np.prod(self.cells))
        self.sample_idx = np.unique(rng.integers(0, n, int(check["samples"])))
        self._idx_dev = torch.from_numpy(self.sample_idx).to(self.device)
        self._idx_host = torch.from_numpy(self.sample_idx)

    def call(self, i: int):
        """One timed call: call ``i``'s field, on the host when the mix
        says so."""
        out = tm.generate_grid_sdf(self.feed.vertices(i), self.topo,
                                   self.grid, self.sign,
                                   device=self.device)
        if self.feed.output == "host":
            out = out.cpu()
        return out

    def sample(self, out):
        """The sampled cells of a field (an index on the field's device,
        no host sync)."""
        idx = self._idx_dev if out.device == self._idx_dev.device \
            else self._idx_host
        return out.reshape(-1)[idx]

    def points(self) -> np.ndarray:
        """The sampled cells' centres by the grid's definition, float32:
        ``cell_size = (hi - lo) / count``, ``first = lo + cell_size / 2``,
        ``centre = first + index * cell_size``."""
        counts = np.asarray(self.cells, np.float32)
        cs = (self.hi - self.lo) / counts
        first = self.lo + cs * np.float32(0.5)
        nx, ny, nz = self.cells
        i = self.sample_idx
        ijk = np.stack([i // (ny * nz), (i // nz) % ny, i % nz], axis=1)
        return (first + ijk.astype(np.float32) * cs).astype(np.float32)

    def reference_inputs(self, i: int):
        """(points, triangle soup) of call ``i``, numpy float32."""
        v = self.feed.host_vertices(i)
        return self.points(), v[self.feed.faces]

    def compare(self, got, ref_signed, ref_unsigned) -> dict:
        """The guarantee's numbers on one call's sample (name -> value),
        and the reference distance where the worst of some of them lies."""
        g = self.guarantee
        got = torch.as_tensor(got, dtype=torch.float64).cpu()
        ref_signed = ref_signed.cpu()
        d_ref = ref_unsigned.cpu()
        d_got = got.abs()
        cs = float(np.max(np.abs((self.hi - self.lo) / np.asarray(
            self.cells, np.float32))))
        band = d_ref <= g["band_cells"] * cs
        far = ~band
        err = d_got - d_ref
        away = d_ref > g["surface_eps"]
        flips = ((got < 0) != (ref_signed < 0)) & away
        numbers = {
            "undershoot": float(torch.clamp_min(-err, 0).max()),
            "band_err": float(err[band].abs().max()) if band.any() else 0.0,
            "far_rel": float((err[far] / d_ref[far]).max())
            if far.any() else 0.0,
            "sign_flips": float(flips.sum()),
        }
        at = {"undershoot": float(d_ref[torch.argmax(-err)]),
              "band_err": float(d_ref[band][torch.argmax(err[band].abs())])
              if band.any() else None}
        return numbers, at

    def limits(self) -> dict:
        g = self.guarantee
        return {"undershoot": g["undershoot_max"],
                "band_err": g["band_err_max"],
                "far_rel": g["far_rel_max"],
                "sign_flips": g["sign_flips_max"]}

    def release(self) -> None:
        """Free the program's state: its content-keyed prep cache."""
        from mesh_to_sdf_tpu_torch import gridgen

        gridgen._CPT_PREP_CACHE.clear()
