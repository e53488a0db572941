"""Cells of ``generate_sdf``: signed distances at query points per call.

The timed call is ``generate_sdf(vertices, Topology, queries,
sign_method=...)`` through AUTO, the queries a tensor on the card from the
mix's pool. Its answers are held against the plain reference at a sample
of queries drawn from the seed, in the results of timed calls, by the
configuration's guarantee (``"exact"``: exact distances with signs).
"""
from __future__ import annotations

import numpy as np
import torch

import mesh_to_sdf_tpu_torch as tm
from benchmark.harness.traffic import derive


class Entry:
    def __init__(self, config: dict, feed, device, seed: int):
        args = config["args"]
        self.sign = tm.SignMethod[args.get("sign_method", "raycast").upper()]
        self.topo = tm.Topology.triangle_list(feed.faces.reshape(-1))
        self.feed = feed
        self.device = torch.device(device)
        self.guarantee = config["guarantee"]
        n = int(feed.pool[0].shape[0])
        self.work_per_call = float(n)
        rng = np.random.default_rng(derive(seed, "check queries"))
        self.sample_idx = np.unique(
            rng.integers(0, n, int(config["check"]["samples"])))
        self._idx = torch.from_numpy(self.sample_idx).to(self.device)

    def call(self, i: int):
        """One timed call: the signed distances of pool draw ``i``."""
        out = tm.generate_sdf(self.feed.vertices(i), self.topo,
                              self.feed.queries(i), sign_method=self.sign,
                              device=self.device)
        if self.feed.output == "host":
            out = out.cpu()
        return out

    def note(self, launches: dict) -> dict:
        """Which engine the call just made took, and what CULLED's
        certificate recorded for it (``launches``: the call's kernel
        launches by counter)."""
        from mesh_to_sdf_tpu_torch.ops import culling

        if launches.get("ops.kernels.culled.COUNT", (0, 0))[0] == 0:
            return {"engine": "no culled launch"}
        s = culling.LAST_CULLED_STATS
        return {k: s.get(k) for k in ("engine", "n_flagged", "queries",
                                      "k_fix", "work_frac")}

    def sample(self, out):
        idx = self._idx if out.device == self._idx.device else self._idx.cpu()
        return out[idx]

    def reference_inputs(self, i: int):
        """(points, triangle soup) of call ``i``, numpy float32."""
        q = self.feed.queries(i)[self._idx].cpu().numpy()
        v = self.feed.host_vertices(i)
        return q, v[self.feed.faces]

    def compare(self, got, ref_signed, ref_unsigned) -> dict:
        """The guarantee's numbers on one call's sample (name -> value),
        and the reference distance where the worst distance lies."""
        g = self.guarantee
        got = torch.as_tensor(got, dtype=torch.float64).cpu()
        ref_signed = ref_signed.cpu()
        d_ref = ref_unsigned.cpu()
        away = d_ref > g["surface_eps"]
        flips = ((got < 0) != (ref_signed < 0)) & away
        err = (got.abs() - d_ref).abs()
        numbers = {"dist_err": float(err.max()),
                   "sign_flips": float(flips.sum())}
        return numbers, {"dist_err": float(d_ref[torch.argmax(err)])}

    def limits(self) -> dict:
        g = self.guarantee
        return {"dist_err": g["dist_err_max"],
                "sign_flips": g["sign_flips_max"]}

    def release(self) -> None:
        """Free the program's state: CULLED's content-keyed per-mesh
        structures and its route cache."""
        from mesh_to_sdf_tpu_torch import query
        from mesh_to_sdf_tpu_torch.ops import culling

        for cache in (query._SIGN_GRID_CACHE, query._PARITY_BINS_CACHE,
                      query._BLOCK_INDEX_CACHE, culling._ROUTE_CACHE):
            cache.clear()
