#!/usr/bin/env python
"""Headline benchmark of the PyTorch/CUDA port: grid cells/s, raycast sign
(BASELINE.json's metric), on one NVIDIA GPU.

    python3 bench_torch.py [--quick] [--device DEVICE]

The port's counterpart of ``bench.py``: the same workloads at the same
sizes, with the same asserts, through ``mesh_to_sdf_tpu_torch``. Prints ONE
JSON line with ``bench.py``'s keys: {"metric", "value", "unit",
"vs_baseline", "extra"}.

Primary workload: ``generate_grid_sdf`` on ``icosphere(5)`` (20 480
triangles) over a 256³ grid (``--quick``: 128³) with the raycast sign,
through AUTO (the CPT route on a card). "extra" carries ``bench.py``'s
extras: the primary's roofline, 1M queries through PALLAS, 1M queries on
``icosphere(8)`` through CULLED, the 512³ slab-streamed grid, the measured
1-core baseline (``native/baseline_rtree_bvh.cpp``, run on this host) and,
where the reference assets exist, their criterion workloads. Each extra is
guarded: a failure is recorded as an ``"error: ..."`` string and never
kills the primary metric. ``extra["card"]`` holds the card's name and
power limit (``nvidia-smi``), beside which every number of the line
stands.

Inputs are moved to the device once, before any timing; each timed call
ends with a host read of a reduction of its output, so the clock covers the
device work. Runs on CUDA unless ``--device`` names another device; on a
host without a card it exits non-zero and prints no result. Imports nothing
of JAX.
"""
import argparse
import json
import os
import time
from pathlib import Path

import numpy as np
import torch

import mesh_to_sdf_tpu_torch as tm
from mesh_to_sdf_tpu_torch import cli, gridgen, gridgen_streamed
from mesh_to_sdf_tpu_torch.ops import culling
from mesh_to_sdf_tpu_torch.utils import baseline as bl
from mesh_to_sdf_tpu_torch.utils import roofline
from mesh_to_sdf_tpu_torch.utils.meshgen import icosphere

#: bench.py's estimate of the Rust crate's multithreaded grid pipeline;
#: vs_baseline = measured / BASELINE_CELLS_PER_S.
BASELINE_CELLS_PER_S = 2.0e6
#: bench.py's estimated single-core Rust RtreeBvh query rate at ~100k tris.
BASELINE_QUERIES_PER_S = 1.0e5

#: The reference crate's assets (knight.glb, FlightHelmet.glb), copied into
#: this checkout (the directory is not committed); their cells skip where it
#: is absent, as in bench.py.
ASSETS = str(Path(__file__).resolve().parent / "assets" / "reference")

#: bench.py's line: its keys, its extra names without the reference assets
#: (`bench.py:139-143`, `:291-294`, `:423-427`) and the asset cells' names
#: (`bench.py:296-390`). This script adds ``extra["card"]``.
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "extra"}
BENCH_EXTRA = {"roofline_primary_grid", "queries_per_s_1M_20k_pallas",
               "sdf_1.3M_tris_1M_scattered_culled",
               "streamed_grid_512^3_raycast", "baseline_1core_measured",
               "vs_1core_grid_measured", "timing_stats"}
BENCH_ASSET_EXTRA = {"knight_query_grid_r0.01_pallas",
                     "flighthelmet_query_grid_culled",
                     "flighthelmet_1M_scattered_culled",
                     "knight_grid_100^3_raycast"}

#: Workload sizes, bench.py's (module constants so a test can shrink them):
#: the primary grid's cells per axis (``--quick``: QUICK_CELLS) and its
#: icosphere level, the query count, the CULLED mesh's level, the streamed
#: grid's cells per axis and the baseline's query subsample.
CELLS = 256
QUICK_CELLS = 128
SUBDIV = 5
N_QUERIES = 1_000_000
CULLED_SUBDIV = 8
STREAMED_CELLS = 512
BASELINE_QUERIES = 100_000


def _timeit(fn, repeats):
    """Sampled timing: one warm call, then the MEDIAN wall time of
    ``repeats`` calls. The spread is recorded in ``TIMING_STATS`` under the
    current workload (``_stats_scope``)."""
    fn()  # warm-up
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    ts = sorted(times)
    med = ts[len(ts) // 2] if len(ts) % 2 else 0.5 * (
        ts[len(ts) // 2 - 1] + ts[len(ts) // 2]
    )
    if _STATS_KEY[0] is not None:
        TIMING_STATS[_STATS_KEY[0]] = {
            "n": len(ts),
            "median_s": round(med, 4),
            "min_s": round(ts[0], 4),
            "max_s": round(ts[-1], 4),
        }
    return med


#: Per-workload timing spread, keyed by workload name (filled by _timeit).
TIMING_STATS = {}
_STATS_KEY = [None]


class _stats_scope:
    """Route _timeit spread recording to TIMING_STATS[name] while active."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        _STATS_KEY[0] = self.name

    def __exit__(self, *exc):
        _STATS_KEY[0] = None


def _query_grid(verts, cell_radius, scale=1.0):
    """The reference bench's query grid: lattice points stepped by
    ``cell_radius`` over the mesh bbox (`benches/generate_sdf.rs:34-49`)."""
    lo = verts.min(axis=0)
    hi = verts.max(axis=0)
    cs = cell_radius * scale
    counts = np.maximum(np.ceil((hi - lo) / cs).astype(int), 1)
    g = tm.Grid.from_bounding_box(lo, hi, [int(c) for c in counts])
    return g.all_cell_centers().reshape(-1, 3).numpy()


def grid_work(vertices, topology, grid, device) -> dict:
    """The FP32 operations and HBM bytes (``roofline.grid_total_flops``) of
    a CPT-route ``generate_grid_sdf(vertices, topology, grid)`` call on
    ``device``: its seeds, sweeps and binned parity, counted from the prep
    that call used (looked up by that call's cache key)."""
    prep = gridgen._cached_cpt_prep(vertices, topology, grid, device)
    if prep is None:
        raise LookupError("no cached CPT prep for this call")
    tris, seed_bins, line_bins = prep
    return roofline.grid_total_flops(grid.total_cell_count, seed_bins,
                                     line_bins, n_tris=tris.shape[1])


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Headline benchmark of mesh_to_sdf_tpu_torch: one JSON "
                    "line")
    p.add_argument("--quick", action="store_true",
                   help=f"the primary grid at {QUICK_CELLS}^3 and no "
                        f"extras but its roofline")
    cli._device_arg(p)
    args = p.parse_args(argv)
    dev = cli._device(args)
    quick = args.quick
    n = QUICK_CELLS if quick else CELLS
    TIMING_STATS.clear()
    on_card = dev.type == "cuda"
    extra = {"card": roofline.card_line() if on_card
             else f"no card: {dev.type}"}
    # The card's own FP32 rate (SMs x 128 lanes x max SM clock); a roofline
    # share needs a card.
    peak = roofline.fp32_peak() if on_card else None

    def account(seconds, flops, hbm_bytes):
        if peak is None:
            return f"not measured: no card ({dev.type})"
        return roofline.account(seconds, flops, hbm_bytes, peak_flops=peak)

    verts, faces = icosphere(subdiv=SUBDIV)  # 20480 triangles
    topo = tm.Topology.triangle_list(faces.reshape(-1))
    grid = tm.Grid.from_bounding_box([-1.1] * 3, [1.1] * 3, [n, n, n])
    v_dev = torch.from_numpy(verts).to(dev)

    def run():
        out = tm.generate_grid_sdf(v_dev, topo, grid, tm.SignMethod.RAYCAST)
        float(out.sum())  # a host read: the clock covers the device work
        return out

    out = run()  # cold call (host prep) + warm-up
    # Sanity: watertight unit sphere in a 2.2-box → inside fraction ≈ 0.393.
    inside = float((out < 0).sum()) / out.numel()
    if not 0.37 < inside < 0.42:
        raise AssertionError(f"bad sign fraction {inside}")
    del out

    with _stats_scope("primary_grid"):
        med = _timeit(run, 3 if quick else 5)
    cells_per_s = n**3 / med

    def guarded(name, fn):
        try:
            with _stats_scope(name):
                extra[name] = fn()
        except Exception as e:  # noqa: BLE001 — record, never kill the bench
            extra[name] = f"error: {type(e).__name__}: {e}"

    # Roofline of the timed call: the seed pairs, sweep evaluations and
    # binned parity pairs its prep schedules (utils/roofline.py).
    def roofline_primary_grid():
        route = gridgen._auto_route(len(faces), n**3, dev)
        if route != tm.Strategy.CPT:
            raise RuntimeError(f"AUTO took {route.value}, not cpt")
        return account(med, **grid_work(v_dev, topo, grid, v_dev.device))

    guarded("roofline_primary_grid", roofline_primary_grid)

    def load(asset):
        from mesh_to_sdf_tpu_torch.io import gltf

        scene = gltf.load_scene(f"{ASSETS}/{asset}.glb")
        return scene.merge()

    # 1M scattered queries × 20k tris through the fused raycast kernel.
    def q_1m():
        rng = np.random.default_rng(0)
        q = rng.uniform(-1.3, 1.3, (N_QUERIES, 3)).astype(np.float32)
        q_dev = torch.from_numpy(q).to(dev)

        def f():
            d = tm.generate_sdf(v_dev, topo, q_dev, tm.Strategy.PALLAS,
                                sign_method=tm.SignMethod.RAYCAST)
            float(d.sum())

        t = _timeit(f, 3)
        m = roofline.pairs_query_flops(len(q), len(faces), raycast_axes=3)
        return {"queries_per_s": round(len(q) / t, 1),
                "roofline": account(t, m["flops"], m["hbm_bytes"])}

    # The slab-streamed pipeline at 512^3 (gridgen_streamed.py).
    def streamed_512():
        g512 = tm.Grid.from_bounding_box([-1.1] * 3, [1.1] * 3,
                                         [STREAMED_CELLS] * 3)

        def f():
            # The field comes back on the host: the call ends with it.
            return gridgen_streamed.generate_grid_sdf_streamed(
                v_dev, faces, g512, tm.SignMethod.RAYCAST)

        out = f()  # cold call (host prep) + warm-up
        inside = float((out < 0).sum()) / out.numel()
        if not 0.37 < inside < 0.42:
            raise AssertionError(f"bad sign fraction {inside}")
        del out
        t0 = time.perf_counter()
        f()
        t = time.perf_counter() - t0
        return {"cells_per_s": round(STREAMED_CELLS**3 / t, 1),
                "seconds": round(t, 2)}

    # MEASURED single-core baseline (native/baseline_rtree_bvh.cpp: the
    # reference's RtreeBvh backend + 3-phase grid generator in C++, one
    # core), on this host: every "vs reference" multiplier divides two
    # times taken on the same machine.
    def measured_baseline():
        if not bl.available(build=True):
            return "binary unavailable"
        out = {}

        # Primary workload mesh at the bench resolution.
        p_tri = (verts[faces[:, 0]], verts[faces[:, 1]],
                 verts[faces[:, 2]])
        r = bl.run_grid(*p_tri, grid)
        out[f"grid_{n}^3_cells_per_s_1core"] = r["cells_per_s"]

        if os.path.isdir(ASSETS):
            hv, hf = load("FlightHelmet")
            h_tri = (hv[hf[:, 0]], hv[hf[:, 1]], hv[hf[:, 2]])

            # FlightHelmet query grid (the crate's big_big criterion).
            qg = _query_grid(hv, 0.01)
            r = bl.run_query(*h_tri, qg)
            out["helmet_query_grid_qps_1core"] = r["queries_per_s"]

            # FlightHelmet scattered (subsampled ×10, same distribution).
            rng = np.random.default_rng(1)
            lo, hi = hv.min(0), hv.max(0)
            c, half = (lo + hi) / 2, (hi - lo) * 0.65
            qs = (c + rng.uniform(-1, 1, (BASELINE_QUERIES, 3))
                  * half).astype(np.float32)
            r = bl.run_query(*h_tri, qs)
            out["helmet_scattered_qps_1core"] = r["queries_per_s"]

            kv, kf = load("knight")
            k_tri = (kv[kf[:, 0]], kv[kf[:, 1]], kv[kf[:, 2]])
            ext = (kv.max(0) - kv.min(0)).astype(np.float64)
            cr = float((ext.prod() / 32_768) ** (1.0 / 3.0)) / 2.0
            r = bl.run_query(*k_tri, _query_grid(kv, cr))
            out["knight_query_grid_qps_1core"] = r["queries_per_s"]

            lo, hi = kv.min(0), kv.max(0)
            pad = 0.05 * (hi - lo)
            g100 = tm.Grid.from_bounding_box(lo - pad, hi + pad, [100] * 3)
            r = bl.run_grid(*k_tri, g100)
            out["knight_grid_100^3_cells_per_s_1core"] = r["cells_per_s"]
        return out

    # BASELINE config-5 scale on one card: a ~1.3M-triangle procedural mesh
    # through CULLED scattered queries, with the certificate flag rate and
    # the measured 1-core multiplier on the same workload (a 100k-query
    # subsample through the C++ baseline).
    def tris_1m_scattered():
        mv, mf = icosphere(subdiv=CULLED_SUBDIV)  # 1,310,720 triangles
        mtopo = tm.Topology.triangle_list(mf.reshape(-1))
        rng = np.random.default_rng(2)
        q = rng.uniform(-1.3, 1.3, (N_QUERIES, 3)).astype(np.float32)
        mv_dev, q_dev = (torch.from_numpy(x).to(dev) for x in (mv, q))

        def f():
            d = tm.generate_sdf(mv_dev, mtopo, q_dev, tm.Strategy.CULLED,
                                sign_method=tm.SignMethod.RAYCAST)
            float(d.sum())

        t = _timeit(f, 3)
        out = {
            "tris": int(len(mf)),
            "queries_per_s": round(len(q) / t, 1),
            "culled_stats": dict(culling.LAST_CULLED_STATS),
        }
        if bl.available(build=True):
            tri = (mv[mf[:, 0]], mv[mf[:, 1]], mv[mf[:, 2]])
            r = bl.run_query(*tri, q[:BASELINE_QUERIES])
            out["qps_1core_measured"] = r["queries_per_s"]
            out["vs_rtree_bvh_1core_measured"] = round(
                out["queries_per_s"] / r["queries_per_s"], 2
            )
        return out

    if not quick:
        guarded("queries_per_s_1M_20k_pallas", q_1m)
        guarded("sdf_1.3M_tris_1M_scattered_culled", tris_1m_scattered)
        guarded("streamed_grid_512^3_raycast", streamed_512)
        guarded("baseline_1core_measured", measured_baseline)

    if os.path.isdir(ASSETS) and not quick:
        # Reference criterion: knight.glb, query grid at cell_radius 0.01
        # (`generate_sdf.rs:12-58`), reproduced by count: the cell radius
        # that tiles the merged bbox into ~32k cells.
        def knight_queries():
            kv, kf = load("knight")
            ktopo = tm.Topology.triangle_list(kf.reshape(-1))
            ext = (kv.max(0) - kv.min(0)).astype(np.float64)
            cell_radius = float((ext.prod() / 32_768) ** (1.0 / 3.0)) / 2.0
            q = _query_grid(kv, cell_radius)
            kv_dev, q_dev = (torch.from_numpy(x).to(dev) for x in (kv, q))

            def f():
                d = tm.generate_sdf(kv_dev, ktopo, q_dev, tm.Strategy.PALLAS,
                                    sign_method=tm.SignMethod.RAYCAST)
                float(d.sum())

            t = _timeit(f, 3)
            m = roofline.pairs_query_flops(len(q), len(kf), raycast_axes=3)
            return {"queries": int(len(q)),
                    "queries_per_s": round(len(q) / t, 1),
                    "roofline": account(t, m["flops"], m["hbm_bytes"])}

        guarded("knight_query_grid_r0.01_pallas", knight_queries)

        # Reference criterion big_big: FlightHelmet merged (94,722 tris),
        # query grid at cell_radius 0.01 (`generate_sdf.rs:216-236`).
        def helmet_query_grid():
            hv, hf = load("FlightHelmet")
            htopo = tm.Topology.triangle_list(hf.reshape(-1))
            q = _query_grid(hv, 0.01)
            hv_dev, q_dev = (torch.from_numpy(x).to(dev) for x in (hv, q))

            def f():
                d = tm.generate_sdf(hv_dev, htopo, q_dev, tm.Strategy.CULLED,
                                    sign_method=tm.SignMethod.RAYCAST)
                float(d.sum())

            t = _timeit(f, 3)
            qps = len(q) / t
            return {
                "tris": int(len(hf)),
                "queries": int(len(q)),
                "queries_per_s": round(qps, 1),
                "vs_rtree_bvh_1core": round(qps / BASELINE_QUERIES_PER_S, 2),
                # CULLED does data-dependent work: the dense-pair rate an
                # uncropped sweep would need to match this time.
                "effective_dense_pairs_per_s": round(
                    len(q) * len(hf) / t, 1),
            }

        guarded("flighthelmet_query_grid_culled", helmet_query_grid)

        # Worst case for tile culling: 1M uniformly scattered queries.
        def helmet_scattered():
            hv, hf = load("FlightHelmet")
            htopo = tm.Topology.triangle_list(hf.reshape(-1))
            rng = np.random.default_rng(1)
            lo, hi = hv.min(0), hv.max(0)
            c, half = (lo + hi) / 2, (hi - lo) * 0.65
            q = (c + rng.uniform(-1, 1, (N_QUERIES, 3)) * half).astype(
                np.float32
            )
            hv_dev, q_dev = (torch.from_numpy(x).to(dev) for x in (hv, q))

            def f():
                d = tm.generate_sdf(hv_dev, htopo, q_dev, tm.Strategy.CULLED,
                                    sign_method=tm.SignMethod.RAYCAST)
                float(d.sum())

            t = _timeit(f, 3)
            qps = len(q) / t
            return {
                "queries_per_s": round(qps, 1),
                "vs_rtree_bvh_1core": round(qps / BASELINE_QUERIES_PER_S, 2),
                "effective_dense_pairs_per_s": round(
                    len(q) * len(hf) / t, 1),
            }

        guarded("flighthelmet_1M_scattered_culled", helmet_scattered)

        # Reference criterion: knight grid at 100^3 raycast
        # (`generate_grid_sdf.rs:68-96`).
        def knight_grid():
            kv, kf = load("knight")
            ktopo = tm.Topology.triangle_list(kf.reshape(-1))
            lo, hi = kv.min(0), kv.max(0)
            pad = 0.05 * (hi - lo)
            g = tm.Grid.from_bounding_box(lo - pad, hi + pad, [100, 100, 100])
            kv_dev = torch.from_numpy(kv).to(dev)

            def f():
                d = tm.generate_grid_sdf(kv_dev, ktopo, g,
                                         tm.SignMethod.RAYCAST)
                float(d.sum())

            t = _timeit(f, 3)
            return {"cells_per_s": round(100**3 / t, 1)}

        guarded("knight_grid_100^3_raycast", knight_grid)

    if not quick:
        # Re-state the headline multipliers against the MEASURED 1-core
        # baseline where both sides ran the same workload.
        bl_m = extra.get("baseline_1core_measured")
        if isinstance(bl_m, dict):
            hq = extra.get("flighthelmet_query_grid_culled")
            if isinstance(hq, dict):
                hq["vs_rtree_bvh_1core_measured"] = round(
                    hq["queries_per_s"] / bl_m["helmet_query_grid_qps_1core"],
                    2,
                )
            hs = extra.get("flighthelmet_1M_scattered_culled")
            if isinstance(hs, dict):
                hs["vs_rtree_bvh_1core_measured"] = round(
                    hs["queries_per_s"] / bl_m["helmet_scattered_qps_1core"],
                    2,
                )
            kq = extra.get("knight_query_grid_r0.01_pallas")
            if isinstance(kq, dict):
                kq["vs_rtree_bvh_1core_measured"] = round(
                    kq["queries_per_s"] / bl_m["knight_query_grid_qps_1core"],
                    2,
                )
            kg = extra.get("knight_grid_100^3_raycast")
            if isinstance(kg, dict):
                kg["vs_1core_measured"] = round(
                    kg["cells_per_s"]
                    / bl_m["knight_grid_100^3_cells_per_s_1core"],
                    2,
                )
            extra["vs_1core_grid_measured"] = round(
                cells_per_s / bl_m[f"grid_{n}^3_cells_per_s_1core"], 2
            )

    if TIMING_STATS:
        extra["timing_stats"] = dict(TIMING_STATS)

    result = {
        "metric": f"grid_cells_per_s_{n}^3_raycast",
        "value": round(cells_per_s, 1),
        "unit": "cells/s",
        "vs_baseline": round(cells_per_s / BASELINE_CELLS_PER_S, 3),
        "extra": extra,
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
