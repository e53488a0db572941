#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (mesh_to_sdf_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the native host library and the CUDA kernels from this checkout,
checks each kernel against its plain PyTorch version on the card (the
packed triangle records bit for bit; CULLED's phase A bit for bit at the
query cells' pass shapes and on ``icosphere(8)``, ``phase_a_phase``), and
drives three paths on
``icosphere(5)`` (20 480 triangles), each checked against the analytic
sphere and timed:

- ``generate_grid_sdf`` with the raycast sign on a 256³ grid (AUTO, which
  takes the CPT route: sweep and binned parity kernels; one sweep launch
  per directional sweep, all in place on the x-first state, which the run
  checks; the sweep held bit-equal to its plain version in all six
  directions at 128³ and 256³);
- ``generate_sdf`` through ``Strategy.PALLAS`` at 1 000 000 queries, both
  sign methods (the fused raycast and normal kernels, the normal kernel
  bit-equal to its plain version);
- ``generate_grid_sdf`` through ``Strategy.PALLAS`` at 128³ (the raycast
  kernel for distances, the dense parity kernel for the sign), also held
  against the CPT route on the same grid; its times give the AUTO cost
  model's ``"cuda"`` constants.

and a fourth on ``icosphere(8)`` (1 310 720 triangles): ``generate_sdf``
at 1 000 000 scattered queries through AUTO, which takes CULLED (the
block-culled kernel) with the gather engine; CULLED is also held against PALLAS on ``icosphere(6)``, the culled kernel
against its plain version at every group shape the path gave it, and the
raycast and normal kernels at the path's fix-up shape (the triangle split
against one chunk and against the plain version). Every launch of the
raycast kernel in one CULLED call is listed with its query count and time.

The two line-parity kernels are held bit-equal to their plain versions on
all three axes at 128³ and 256³ (at 128³ also with the triangle-block
split forced to 1, 2 and 7 chunks) and at the three dense launches of the
cold CULLED call's sign grid (128 x 128 lines x 1 310 720 triangles). Their
times (each call replayed from a CUDA graph, beside CUDA events around
back-to-back calls, which count the host's gaps) are printed with
their bounds and the launch shapes the planner chose, and the 256³ parity
stage is split into the wrapper calls and the vote glue around them.

A fifth phase trains (``training_phase``): ``DifferentiableSDF``'s CPT
engine on ``icosphere(6)`` at 256³ (6 Adam steps; the sweep kernel 6
times per forward; never below the PALLAS route's distance by more than
ATOL; finite differences of the vertex gradient; stage times), its
forward and backward at 128³ against the CPU, the dense engine (both
signs; the dense parity kernel for RAYCAST) and ``sdf_at_points`` against
the CPU.

A sixth drives the slab-streamed grid (``streamed_phase``):
``generate_grid_sdf_streamed`` on ``icosphere(5)`` at 512³ in slabs of 64
(128 sweep and 24 binned parity launches per call), checked against the
analytic sphere and the in-core CPT route at 512³ (and its peak device
memory beside theirs), NORMAL at 128³ against the in-core NORMAL route, the
whole call at 64×32×32 card against CPU, and both kernels against their
plain versions at the slab shapes; cold and warm times, stage times per
pass and what the fetch to the host costs.

A seventh drives ``parallel/`` (``sharded_phase``): on a world of 1 (NCCL,
in process) the x-slab CPT grid at 512³ against the sphere and the in-core
route, ``generate_sdf_sharded`` at 1M queries bit-equal to PALLAS (both
signs), sharded CULLED on ``icosphere(6)`` against single-device CULLED,
and three sharded training steps with their vertex gradient against the
single-device one; then four spawned gloo ranks on the one card (256³ on
cells 4, bit-equal to the same call on the CPU at 64×32×32; cells 2 × tris
2 queries bit-equal to the world of 1; the weak-scaling report); and every
kernel of the path against its plain version at the path's shapes (the
sweep and binned parity at the rank slab, the dense parity at the sign
grid, the raycast and normal kernels with pad rows, the culled kernel).

An eighth drives the user surface (``surface_phase``): the CLI through
``cli.main`` and once through ``python -m mesh_to_sdf_tpu_torch``, on
``icosphere(5)`` written to a GLB: ``generate`` at 256³ (bit-equal to
``generate_grid_sdf``; 6 sweep and 3 binned parity launches), with
``--format reference`` and ``--exact`` at 64³; ``info``; ``render`` at
512x512 in every mode, as voxels, as the model, model + SDF and with a
base-colour material, each image against the analytic sphere and against the
same call on the CPU at 64³ / 128x128; ``bench`` grid and query, both signs;
``gridgen.calibrate_auto``; warm times of the renderers.

A ninth runs the bench (``bench_phase``): ``bench_torch.main([])`` in this
process from cold content caches, bench.py's workloads at bench.py's sizes
(the 256³ grid and its roofline, 1M x 20 480 through PALLAS, 1M x 1 310 720
through CULLED, the 512³ streamed grid, the 1-core C++ baseline on this
host). Its line is printed and must have bench.py's keys, no failed
workload, the measured 1-core multiplier, no roofline share above 100 %,
no plain call, and every kernel of those workloads launched.

A tenth holds the port's host-sync markers (``tracing_phase``): the
``sync.*`` spans of one warm 256³ CPT grid call and one warm CULLED call
on ``icosphere(6)`` against the waits PyTorch's sync debug mode reports
(``tests/test_torch_tracing_cuda.py``, run in its own process).

Any failed phase raises, so the script exits non-zero and prints no result.
Its last two lines are one JSON object with a row per kernel (name, route,
source, launches on its path, error against the plain version, times, the
card's bound for the same work) and ``{"ok": true, "device": {...}}``.

Exits non-zero without a CUDA device. Imports nothing of JAX.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))
from mesh_to_sdf_tpu_torch.utils import roofline  # noqa: E402
from mesh_to_sdf_tpu_torch.utils.roofline import (  # noqa: E402
    FLOPS, PEAK_BYTES, card_line, parity_flops, raycast_flops)

#: Distance tolerance kernel vs plain version (and index re-evaluation).
#: Both round every operation as written (-fmad=false, correctly rounded
#: sqrt), so they agree far inside it.
RTOL, ATOL = 2e-4, 1e-5

#: FP32 operations/s outside the tensor cores, set in main() from this card
#: (``roofline.fp32_peak``: SMs x 128 FP32 lanes x the max SM clock). The
#: bounds, the HBM rate and the operation counts per pair come from
#: ``mesh_to_sdf_tpu_torch/utils/roofline.py``.
PEAK_FP32 = 0.0
#: The previous designs' kernel times (one query per thread with triangle
#: constants computed while staging; per-group staging between CTA-wide
#: barriers; one sweep launch per slice over vertex-carrying volumes) on
#: the H100 80GB HBM3 at 700 W (PERF.md), printed beside the current
#: kernels' times.
PREVIOUS_MS = {"raycast 1M x 20,480, 3 axes": 140.36,
               "raycast 128^3 centres, axes 0": 175.2,
               "culled 64x32": 53.36, "culled 16x128": 75.8,
               "culled 1024x256 anchors": 210.18,
               "normal 1M x 20,480": 93.842,
               "sweep 256^3 +x": 5.725, "sweep 128^3 +x": 1.879,
               "binned 256^3 +x": 0.710, "binned 128^3 +x": 0.959,
               "dense 256^3 +x": 2.823, "dense 128^3 +x": 2.162}
def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps):
    """Mean device time of ``fn`` in ms over ``reps`` calls after one
    warm-up call (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps):
    """Device time of one call of ``fn`` in ms: the call captured once in a
    CUDA graph and replayed ``reps`` times between two CUDA events. Unlike
    events around back-to-back calls it leaves out the host's gaps between
    launches, which dominate calls of ~0.1 ms."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up off the capture, as torch.cuda.graph asks
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def plain_once(fn):
    """(result, device ms) of one call of a plain version."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def warm_times(fn, reps=3):
    """(cold s, warm host-clock times s): one cold call, then ``reps``."""
    t0 = time.perf_counter()
    fn()
    t_cold = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return t_cold, times


def degenerate_soup(device):
    """64 segment and point triangles (tests/test_pallas.py:105-113)."""
    import torch

    rng = np.random.default_rng(3)
    a = rng.standard_normal((64, 3)).astype(np.float32)
    b = a.copy()  # b == a → segment [a, c]
    c = rng.standard_normal((64, 3)).astype(np.float32)
    b[32:] = c[32:]  # b == c → segment [a, b]
    c[48:] = a[48:]  # all equal → vertex a
    b[48:] = a[48:]
    return tuple(torch.from_numpy(x).to(device) for x in (a, b, c))


def hold_seed(grid, tris, bins, records, what):
    """The seed kernel (``cpt.seed_from_bins`` on the card) against its
    plain version on the CPU, all four outputs bit for bit; then its time
    by graph replay, the plain version's on the card (the eager chain the
    kernel replaced) and its bound. Returns (ms, plain ms, bound)."""
    import torch

    from mesh_to_sdf_tpu_torch.ops import cpt
    from mesh_to_sdf_tpu_torch.ops.kernels import seed as seed_k

    before = (seed_k.COUNT.kernel, seed_k.COUNT.plain)
    got = cpt.seed_from_bins(grid, *tris, bins, records)
    torch.cuda.synchronize()
    launched = (seed_k.COUNT.kernel - before[0],
                seed_k.COUNT.plain - before[1])
    host = cpt.SeedBins(*(torch.as_tensor(a).cpu() for a in bins[:3]),
                        bins.n_shift_rounds)
    want = seed_k.seed_from_bins_plain(grid, *(t.cpu() for t in tris), host)
    same = all(torch.equal(g.cpu().view(torch.int32), w.view(torch.int32))
               for g, w in zip(got, want))
    ms = graph_ms(lambda: cpt.seed_from_bins(grid, *tris, bins, records), 10)
    ev_ms = cuda_ms(lambda: cpt.seed_from_bins(grid, *tris, bins, records),
                    10)
    _, plain_ms = plain_once(
        lambda: seed_k.seed_from_bins_plain(grid, *tris, bins))
    work = roofline.cpt_seed_flops(bins, tris[0].shape[0])
    bnd = bound(work["flops"], work["hbm_bytes"])
    k, r = tuple(bins.entry_tri.shape)
    log(f"  seed {what} (K {k}, R {r}, {bins.n_shift_rounds} shift rounds, "
        f"{int((want[1] >= 0).sum())} cells seeded): one launch "
        f"{launched == (1, 0)}, bit-equal to the plain version {same}; "
        f"kernel {ms:.4f} ms (graph replay), {ev_ms:.4f} ms by events, "
        f"plain on the card {plain_ms:.2f} ms, bound {bnd[0]:.4f} ms "
        f"({bnd[1]}; {work['hbm_bytes'] / 1e6:.1f} MB, "
        f"{work['pairs']:.4g} pairs)")
    if launched != (1, 0) or not same:
        raise AssertionError(f"seed kernel disagrees: {what}")
    return ms, plain_ms, bnd


def _deepsdf_points(verts, faces, n, rng):
    """The near-surface cell's mix at n points: 47 % surface points with
    noise of variance 0.005, 47 % with 0.0005, 6 % uniform in [-1, 1]^3."""
    n_s = n * 47 // 100
    tri = verts[faces[rng.integers(0, len(faces), 2 * n_s)]]
    u, v = rng.random((2, 2 * n_s, 1))
    flip = u + v > 1
    u, v = np.where(flip, 1 - u, u), np.where(flip, 1 - v, v)
    p = tri[:, 0] + u * (tri[:, 1] - tri[:, 0]) + v * (tri[:, 2] - tri[:, 0])
    p[:n_s] += rng.normal(0, np.sqrt(0.005), (n_s, 3))
    p[n_s:] += rng.normal(0, np.sqrt(0.0005), (n_s, 3))
    far = rng.uniform(-1, 1, (n - 2 * n_s, 3))
    return np.concatenate([p, far]).astype(np.float32)


def phase_a_phase(dev):
    """CULLED phase A's kernel (``culled._phase_a_hier``) against its plain
    version on the card at the query cells' pass shapes on icosphere(6)
    (uniform: 1M queries, widen 53 248; near-surface: 500 000, widen
    9 216; st 64 / kg 32 and st 16 / kg 128) and at 1M queries on
    icosphere(8) (5 120 blocks): the gather engine's pair and the full
    triple bit for bit, one launch each, no plain call; the kernel's time
    (CUDA events over 10 calls), the plain version's (one call, its eager
    chunks) and the bound. Returns {shape: (ms, plain ms, bound)}."""
    import torch

    from mesh_to_sdf_tpu_torch.ops import culling
    from mesh_to_sdf_tpu_torch.ops.kernels import culled
    from mesh_to_sdf_tpu_torch.utils.meshgen import icosphere

    log("== phase A kernel vs plain (the query cells' passes, icosphere(8))")
    rng = np.random.default_rng(20)
    meshes = {6: icosphere(6), 8: icosphere(8)}
    index = {lvl: culled.build_block_index(
        *(v[f[:, k]] for k in range(3)), device=dev)
        for lvl, (v, f) in meshes.items()}
    near = _deepsdf_points(*meshes[6], 500_000, rng)
    cases = [
        ("uniform main", 6, rng.uniform(-1.3, 1.3, (1_000_000, 3)), 64, 32),
        ("uniform widen", 6, rng.uniform(-1.3, 1.3, (53_248, 3)), 16, 128),
        ("near_surface main", 6, near, 64, 32),
        ("near_surface widen", 6, near[rng.choice(len(near), 9_216)], 16,
         128),
        ("icosphere(8) main", 8, rng.uniform(-1.3, 1.3, (1_000_000, 3)), 64,
         32),
    ]
    count = culled.PHASE_A_COUNT
    shapes = {}
    for name, lvl, q_np, st, kg in cases:
        bi = index[lvl]
        q = torch.from_numpy(q_np.astype(np.float32)).to(dev)
        q = q[culling._morton_order(q)]
        q = culling._edge_pad(q, (-q.shape[0]) % (st * culling.GATHER_CHUNK))
        centers, _ = culled._sub_tiles(q, st)
        c = max(kg + 1, culled.HIER_C)
        before = (count.kernel, count.plain)
        got = culled._phase_a_topk(centers, bi, kg=kg)
        got_full = culled._phase_a_hier(centers, bi, c=c)
        torch.cuda.synchronize()
        launched = (count.kernel - before[0], count.plain - before[1])
        want_full, plain_ms = plain_once(
            lambda: culled._phase_a_hier_plain(centers, bi, c=c))
        want = culled._kg_tail(*want_full, kg)
        same = all(g.dtype == w.dtype and torch.equal(g, w)
                   for g, w in zip(got + got_full, want + want_full))
        ms = cuda_ms(lambda: culled._phase_a_topk(centers, bi, kg=kg), 10)
        work = roofline.phase_a_work(centers.shape[0], bi.n_blocks, bi.tb, c,
                                     kg)
        bnd = bound(work["flops"], work["hbm_bytes"])
        lb_c = want_full[0]
        log(f"  phase A {name}: {centers.shape[0]} sub-tiles x "
            f"{bi.n_blocks} blocks, st {st} kg {kg} window "
            f"{min(c, bi.n_blocks - 1)}; ties: {int((want_full[2] == 0).sum())}"
            f" lb_rest 0, {int((lb_c == 0).sum())} fine bounds 0; one launch "
            f"a mode {launched == (2, 0)}, bit-equal to the plain version "
            f"{same}; kernel {ms:.4f} ms, plain on the card {plain_ms:.2f} "
            f"ms, bound {bnd[0]:.4f} ms ({bnd[1]}; {work['pairs']:.4g} fine "
            f"pairs)")
        if launched != (2, 0) or not same:
            raise AssertionError(f"phase A kernel disagrees: {name}")
        shapes[name] = (ms, plain_ms, bnd)
    return shapes


def bound(flops, nbytes):
    """(bound ms, what bounds it) on this card (``roofline.bound`` at its
    FP32 rate)."""
    return roofline.bound(flops, nbytes, PEAK_FP32)


def clocks_during(fn):
    """(fn's result, "SM clock min/median MHz, power max W") sampled by
    nvidia-smi every 50 ms while fn runs (ending in a synchronize)."""
    import torch

    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "50"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        time.sleep(0.2)
        out = fn()
        torch.cuda.synchronize()
    finally:
        proc.terminate()
        text, _ = proc.communicate(timeout=30)
    rows = []
    for line in text.strip().splitlines():
        try:
            rows.append([float(x) for x in line.split(",")])
        except ValueError:  # "[N/A]" where the card does not report it
            continue
    if not rows:
        return out, "no samples"
    mhz = sorted(r[0] for r in rows)
    return out, (f"SM clock min {mhz[0]:.0f} / median "
                 f"{mhz[len(mhz) // 2]:.0f} MHz, power max "
                 f"{max(r[1] for r in rows):.1f} W over {len(rows)} samples")


#: Gradients card vs CPU (training phase): the backward's index_add_ adds
#: with atomics on the card, so each vertex's float32 sum of contributions
#: comes in another order there. Reordering n terms moves the sum by at most
#: about n x 2^-24 x the sum of their magnitudes; the bound used is
#: rtol 1e-4 plus atol 1e-4 x max |g| (each vertex sums at most a few
#: thousand contributions here).
GRAD_RTOL = 1e-4
GRAD_ATOL_SCALE = 1e-4


def close_grads(got, want, what):
    """Card gradient vs CPU gradient at GRAD_RTOL / GRAD_ATOL_SCALE;
    returns the max abs difference."""
    import torch

    want = want.to(got.device)
    atol = GRAD_ATOL_SCALE * float(want.abs().max())
    err = float((got - want).abs().max())
    ok = bool(((got - want).abs() <= atol + GRAD_RTOL * want.abs()).all())
    print(f"  {what}: max |card - CPU| {err:.3e} (max |g| "
          f"{float(want.abs().max()):.3e}; atol {atol:.3e}) within: {ok}",
          flush=True)
    if not ok:
        raise AssertionError(f"gradients differ: {what}")
    return err


def training_phase(dev, *, cells=256, cmp_cells=128, level=6,
                   dense_level=3, dense_cells=32, pts_level=4,
                   n_pts=65536, n_pts_cpu=4096, card="", timer=None):
    """The trainable SDF (``models.DifferentiableSDF``) on the card.

    1. The CPT engine on ``icosphere(level)`` at ``cells``³ (BASELINE.json:
       "~50k tris, 256³ grid ... + vertex-gradient fd-check"): 6 Adam steps
       at lr 5e-2 toward |SDF| of 1.15 x the mesh; the loss falls below 0.7
       x the first; 6 sweep launches per forward and no plain version; the
       step-0 forward never below the exact distance (the PALLAS route) by
       more than ATOL; stage times; finite differences.
    2. The CPT forward and backward at ``cmp_cells``³, card against CPU.
    3. The dense engine on ``icosphere(dense_level)`` at ``dense_cells``³,
       both signs: 3 steps on the card, each step's loss and gradient held
       against the CPU's at the same vertices; the dense parity kernel
       signs RAYCAST.
    4. ``sdf_at_points`` at ``n_pts`` queries on ``icosphere(pts_level)``,
       both signs; values and gradients card vs CPU on the first
       ``n_pts_cpu`` queries.

    Returns the kernels' launches on this path.
    """
    import torch

    import mesh_to_sdf_tpu_torch as tm
    from mesh_to_sdf_tpu_torch.models import sdf_layer
    from mesh_to_sdf_tpu_torch.ops import cpt, geometry
    from mesh_to_sdf_tpu_torch.ops.kernels import parity, sweep
    from mesh_to_sdf_tpu_torch.ops.kernels import sdf as sdf_k
    from mesh_to_sdf_tpu_torch.utils.meshgen import icosphere

    timer = timer or cuda_ms
    counts = {"sweep": sweep.COUNT, "records": sdf_k.RECORDS_COUNT,
              "dense": parity.DENSE_COUNT}
    launched = dict.fromkeys(counts, 0)

    def reset():
        torch.cuda.synchronize()
        for c in counts.values():
            c.reset()

    def read(what, expect=None):
        """Adds this run's launches to ``launched``; fails on any plain
        call on the card and on a count other than ``expect``."""
        torch.cuda.synchronize()
        got = {k: c.kernel for k, c in counts.items()}
        plain = sum(c.plain for c in counts.values())
        print(f"  launches in {what}: {got}; plain-version calls {plain}",
              flush=True)
        if plain:
            raise AssertionError(f"a plain version ran on the card: {what}")
        for k, n in (expect or {}).items():
            if got[k] != n:
                raise AssertionError(f"{what}: {k} launched {got[k]}, "
                                     f"expected {n}")
        for k in launched:
            launched[k] += got[k]

    # ------------------------------------------------ 1. CPT engine, full size
    print(f"== training: DifferentiableSDF(engine='cpt'), icosphere({level}), "
          f"{cells}^3, 6 Adam steps; {card}", flush=True)
    verts, faces = icosphere(level)
    faces64 = faces.astype(np.int64)
    topo = tm.Topology.triangle_list(faces.reshape(-1))
    grid = tm.Grid.from_bounding_box([-1.5] * 3, [1.5] * 3, [cells] * 3)
    shape = (cells,) * 3
    target = tm.generate_grid_sdf(
        torch.from_numpy(verts * np.float32(1.15)).to(dev), topo, grid,
        tm.SignMethod.NORMAL, device=dev).abs().reshape(shape)
    exact = tm.generate_grid_sdf(torch.from_numpy(verts).to(dev), topo, grid,
                                 tm.SignMethod.NORMAL,
                                 strategy=tm.Strategy.PALLAS,
                                 device=dev).abs().reshape(shape)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = sdf_layer.DifferentiableSDF(
        faces, grid, tm.SignMethod.NORMAL, learning_rate=5e-2, engine="cpt",
        vertices_example=verts)
    fn = model._cpt_fn
    t1 = time.perf_counter()
    state = model.init(verts, device=dev)
    print(f"  build (subdivision, weights): {t1 - t0:.3f} s; "
          f"{fn._host['parents'].numel()} sub-triangles; init (Adam, "
          f"upload) {time.perf_counter() - t1:.3f} s", flush=True)

    reset()
    d0, i0 = fn.forward(state.params)
    read("one forward", {"sweep": 6, "records": 1})
    # Never below the exact distance by more than ATOL, the bound path 3
    # holds the CPT grid route to: the sweep re-evaluates candidates with
    # the TPU kernel's division-free ladder, whose d² comes by
    # cancellation, and so does the PALLAS route's kernel (ROADMAP.md §3).
    under = float((exact - d0).max())
    cs = float(grid.cell_size[0])
    far = exact > 2 * cs
    rel = ((d0 - exact) / exact)[far]
    print(f"  step-0 CPT vs exact (PALLAS route): max undershoot "
          f"{under:.3e} (bound {ATOL:g}); beyond 2 cells relative error "
          f"max {float(rel.max()):.3e}, mean {float(rel.mean()):.3e}; "
          f"cells with no triangle {int((i0 < 0).sum())}", flush=True)
    if under > ATOL or bool((i0 < 0).any()):
        raise AssertionError("the CPT forward falls below the exact distance")

    # Finite differences of L = sum (f(v) - |target|)^2, summed in float64
    # (a float32 sum over the cells cancels what eps changes), on the mesh
    # before any step (as tests/test_cpt.py::test_cpt_grid_gradients_fd)
    # and after the steps, at rtol 5e-2. "held" keeps every cell's triangle
    # from the forward at v and evaluates the distances exactly at v ± eps:
    # that is the function the envelope gradient differentiates, and it
    # gates. "free" runs the whole forward at v ± eps and is printed only:
    # at 256³ the CPT forward jumps where a cell's triangle or the way its
    # distance was evaluated (seed or sweep ladder) changes under the move,
    # which moves it 0.3-8 % off the gradient (PERF.md §6). eps is 3e-5,
    # not the JAX test's 1e-3 at 10³: the nearest cell centres lie ~cs/2 =
    # 6e-3 from the surface, where the distance's curvature makes a central
    # difference of 1e-3 off by several per cent; the step is taken as the
    # float32 difference of the two vertices.
    centers = grid.all_cell_centers(dev).reshape(-1, 3)
    t64 = target.double()

    def fd_check(v, dist, idx, what):
        parents = fn._consts(v.device)["tri_idx"][fn._consts(v.device)[
            "parents"][idx.reshape(-1).long()]]

        def loss_free(vv):
            return float(((fn.forward(vv)[0].double() - t64) ** 2).sum())

        def loss_held(vv):
            a, b, c = (vv[parents[:, j]] for j in range(3))
            d = geometry.point_triangle_distance(centers, a, b, c)
            return float(((d.double().reshape(shape) - t64) ** 2).sum())

        grad = fn.vjp(v, dist, idx, 2.0 * (dist - target))
        rng = np.random.default_rng(5)
        eps, checked = 3e-5, 0
        for _ in range(6):  # the JAX test's six picks
            i, k = int(rng.integers(0, len(verts))), int(rng.integers(0, 3))
            vp, vm = v.clone(), v.clone()
            vp[i, k] += eps
            vm[i, k] -= eps
            h = float(vp[i, k]) - float(vm[i, k])
            free = (loss_free(vp) - loss_free(vm)) / h
            held = (loss_held(vp) - loss_held(vm)) / h
            an = float(grad[i, k])
            print(f"  fd {what}, vertex {i} coord {k}: analytic {an:.6e}, "
                  f"fd held {held:.6e} (rel {abs(an - held) / abs(held):.2e})"
                  f", fd free {free:.6e} (rel "
                  f"{abs(an - free) / abs(free):.2e})", flush=True)
            if abs(held) < 0.2:
                continue  # too small to difference reliably
            if abs(an - held) > 5e-2 * abs(held):
                raise AssertionError(f"vertex gradient fails the fd check "
                                     f"{what}: {an} vs {held}")
            checked += 1
        if checked < 3:
            raise AssertionError("fewer than 3 coordinates fd-checked")

    fd_check(state.params.detach(), d0, i0, "before the steps")

    reset()
    losses, step_s = [], []
    for _ in range(6):
        t0 = time.perf_counter()
        state, loss = model.train_step(state, target)
        losses.append(float(loss))
        step_s.append(time.perf_counter() - t0)
    read("6 train steps", {"sweep": 36, "records": 6})
    print(f"  losses {', '.join(f'{x:.6e}' for x in losses)}; last / first "
          f"{losses[-1] / losses[0]:.4f}", flush=True)
    print(f"  train_step host clock (s): "
          f"{', '.join(f'{t:.4f}' for t in step_s)}", flush=True)
    if not losses[-1] < 0.7 * losses[0]:
        raise AssertionError(f"the CPT fit does not converge: {losses}")
    v = state.params.detach()
    if not bool(torch.isfinite(v).all()):
        raise AssertionError("non-finite vertices")

    # Stage times of one step (CUDA events), on the final vertices.
    ta, tb, tc = fn.sub_triangles(v)
    seed = cpt._seed(grid, ta, tb, tc, cpt.SEED_SPAN)
    dist, idx = cpt.closest_point_grid(grid, ta, tb, tc, seed=seed)
    g = 2.0 * (dist - target) / dist.numel()
    opt_v = v.clone().requires_grad_(True)
    opt = model.optimizer(opt_v)
    opt_v.grad = torch.ones_like(opt_v)
    stages = {
        "sub-triangles": timer(lambda: fn.sub_triangles(v), 3),
        "seed (_seed)": timer(lambda: cpt._seed(grid, ta, tb, tc,
                                                cpt.SEED_SPAN), 3),
        "6 sweeps (closest_point_grid)": timer(
            lambda: cpt.closest_point_grid(grid, ta, tb, tc, seed=seed), 3),
        "loss": timer(lambda: torch.mean((dist - target) ** 2), 3),
        "backward (vjp)": timer(lambda: fn.vjp(v, dist, idx, g), 3),
        "optimizer step": timer(opt.step, 3),
    }
    print(f"  stage times per step (ms, CUDA events; {card}): "
          + "; ".join(f"{k} {t:.3f}" for k, t in stages.items()),
          flush=True)
    print(f"  peak device memory so far "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)

    fd_check(v, dist, idx, "after 6 steps")
    del target, t64, centers, exact, seed, dist, idx, g, d0, i0

    # ------------------------------------------ 2. card vs CPU at cmp_cells³
    print(f"== training: CPT forward and backward at {cmp_cells}^3, card vs "
          f"CPU, icosphere({level})", flush=True)
    grid_c = tm.Grid.from_bounding_box([-1.5] * 3, [1.5] * 3, [cmp_cells] * 3)
    fn_c = sdf_layer.DifferentiableSDF(
        faces, grid_c, engine="cpt", vertices_example=verts)._cpt_fn
    v_cpu = torch.from_numpy(verts)
    t0 = time.perf_counter()
    d_cpu, i_cpu = fn_c.forward(v_cpu)
    g_c = torch.from_numpy(np.random.default_rng(6).standard_normal(
        d_cpu.shape).astype(np.float32))
    gv_cpu = fn_c.vjp(v_cpu, d_cpu, i_cpu, g_c)
    t_cpu = time.perf_counter() - t0
    reset()
    d_dev, i_dev = fn_c.forward(v_cpu.to(dev))
    gv_dev = fn_c.vjp(v_cpu.to(dev), d_dev, i_dev, g_c.to(dev))
    read(f"forward at {cmp_cells}^3", {"sweep": 6, "records": 1})
    d_err = float((d_dev.cpu() - d_cpu).abs().max())
    ok = torch.allclose(d_dev.cpu(), d_cpu, rtol=RTOL, atol=ATOL)
    print(f"  distances: max |card - CPU| {d_err:.3e}, bit-equal "
          f"{torch.equal(d_dev.cpu(), d_cpu)}, ids equal "
          f"{torch.equal(i_dev.cpu(), i_cpu)} (CPU forward + backward "
          f"{t_cpu:.2f} s)", flush=True)
    if not ok:
        raise AssertionError("CPT distances differ between card and CPU")
    close_grads(gv_dev, gv_cpu, f"CPT vertex gradient at {cmp_cells}^3")
    del d_dev, i_dev, gv_dev, d_cpu, i_cpu, gv_cpu

    # ------------------------------------------ 3. dense engine, both signs
    dv, df = icosphere(dense_level)
    grid_d = tm.Grid.from_bounding_box([-1.4] * 3, [1.4] * 3,
                                       [dense_cells] * 3)
    for sign in (tm.SignMethod.RAYCAST, tm.SignMethod.NORMAL):
        print(f"== training: DifferentiableSDF(engine='dense', {sign.name}), "
              f"icosphere({dense_level}), {dense_cells}^3, 3 steps, card vs "
              f"CPU", flush=True)
        model_d = sdf_layer.DifferentiableSDF(df, grid_d, sign,
                                              learning_rate=5e-2, block=256)
        target_d = sdf_layer.sdf_grid(torch.from_numpy(dv * np.float32(1.15)),
                                      model_d.tri_idx, grid_d, sign,
                                      block=256)
        # Three train steps on the card; at each, the CPU's loss and
        # gradient at the card's current vertices. (Two trajectories would
        # part: Adam's first step moves each coordinate by lr·g/(|g| + eps),
        # so a gradient within the atomics' rounding of 0 moves by up to lr
        # either way.)
        st = model_d.init(dv, device=dev)
        tgt = target_d.to(dev)
        reset()
        for step in range(3):
            st.opt_state.zero_grad()
            loss = model_d.loss(st.params, tgt)
            loss.backward()
            read(f"dense {sign.name} step {step}",
                 {"dense": 3 if sign == tm.SignMethod.RAYCAST else 0})
            v_cpu = st.params.detach().cpu().requires_grad_(True)
            loss_cpu = model_d.loss(v_cpu, target_d)
            loss_cpu.backward()
            l_d, l_c = loss.item(), loss_cpu.item()
            print(f"  step {step}: loss card {l_d:.8e}, CPU {l_c:.8e}",
                  flush=True)
            if abs(l_d - l_c) > 1e-5 * abs(l_c):
                raise AssertionError("dense losses differ")
            close_grads(st.params.grad, v_cpu.grad,
                        f"dense {sign.name} step {step} gradient")
            st.opt_state.step()
            reset()

    # -------------------------------------------------- 4. sdf_at_points
    pv, pf = icosphere(pts_level)
    tri = torch.from_numpy(sdf_layer.pad_tri_idx(pf, 512))
    q = torch.from_numpy(np.random.default_rng(7).uniform(
        -1.3, 1.3, (n_pts, 3)).astype(np.float32))
    for sign in (tm.SignMethod.NORMAL, tm.SignMethod.RAYCAST):
        print(f"== training: sdf_at_points {sign.name}, {n_pts} queries, "
              f"icosphere({pts_level})", flush=True)

        def grads(where, n):
            vv = torch.from_numpy(pv).to(where).requires_grad_(True)
            qq = q[:n].to(where).requires_grad_(True)
            out = sdf_layer.sdf_at_points(vv, tri.to(where), qq, sign)
            torch.sum(out ** 2).backward()
            return out.detach(), vv.grad, qq.grad

        t0 = time.perf_counter()
        full = grads(dev, n_pts)
        torch.cuda.synchronize()
        t_full = time.perf_counter() - t0
        if not bool(torch.isfinite(full[0]).all()):
            raise AssertionError("non-finite sdf_at_points")
        r = q.to(dev).norm(dim=1)
        far = (r - 1.0).abs() > 0.05
        sign_ok = bool(torch.equal((full[0] < 0)[far], (r < 1.0)[far]))
        sub_dev = grads(dev, n_pts_cpu)
        sub_cpu = grads("cpu", n_pts_cpu)
        err = float((sub_dev[0].cpu() - sub_cpu[0]).abs().max())
        print(f"  {n_pts} queries forward + backward {t_full:.3f} s (host "
              f"clock, {card}); signs match the sphere beyond 0.05: "
              f"{sign_ok}; on {n_pts_cpu} queries max |card - CPU| {err:.3e}",
              flush=True)
        if not sign_ok or not torch.allclose(sub_dev[0].cpu(), sub_cpu[0],
                                             rtol=RTOL, atol=ATOL):
            raise AssertionError("sdf_at_points disagrees")
        if not torch.equal(full[0][:n_pts_cpu], sub_dev[0]):
            raise AssertionError("sdf_at_points depends on the batch")
        close_grads(sub_dev[1], sub_cpu[1], f"{sign.name} vertex gradient")
        close_grads(sub_dev[2], sub_cpu[2], f"{sign.name} query gradient")
    return launched


def streamed_phase(dev, *, cells=512, slab=64, level=5, normal_cells=128,
                   small=(64, 32, 32), small_slab=16, hold_slabs=(0, 3),
                   card=""):
    """Path 6: the slab-streamed grid (``gridgen_streamed``) on the card.

    1. ``generate_grid_sdf_streamed`` on ``icosphere(level)`` at
       ``cells``³, slab ``slab``, RAYCAST (``bench.py:177-200``): launches
       (8 sweeps per slab pass, 3 binned parity per slab, no plain version),
       the inside fraction in (0.37, 0.42), the analytic sphere, cold and
       warm times, CUDA-event stage times per pass, the fetch's overlap with
       the compute, host syncs per call.
    2. The sweep (six directions) and the binned parity (three axes, the
       padded tables) against their plain versions at the path's slab
       shapes, on slabs ``hold_slabs``; their times and bounds.
    3. The in-core CPT route at ``cells``³: signs equal and ≤ 2 % relative
       apart beyond 2 cells; peak device memory of both calls.
    4. NORMAL at ``normal_cells``³ against the in-core NORMAL route (≤ 1 %
       of the signs apart).
    5. The whole call at ``small`` (slab ``small_slab``), card against CPU.

    Returns the launches, and per kernel and axis (ms, plain ms, bound) at
    the path's slab shape, with the shape's name.
    """
    import warnings

    import torch

    import mesh_to_sdf_tpu_torch as tm
    from mesh_to_sdf_tpu_torch import gridgen
    from mesh_to_sdf_tpu_torch import gridgen_streamed as gs
    from mesh_to_sdf_tpu_torch.ops import cpt
    from mesh_to_sdf_tpu_torch.ops.kernels import parity, sweep
    from mesh_to_sdf_tpu_torch.ops.kernels import sdf as sdf_k
    from mesh_to_sdf_tpu_torch.ops.kernels import seed as seed_k
    from mesh_to_sdf_tpu_torch.ops.raycast import face_origins
    from mesh_to_sdf_tpu_torch.utils.meshgen import icosphere

    log(f"== path 6: generate_grid_sdf_streamed, icosphere({level}), "
        f"{cells}^3, slab {slab}, RAYCAST ({card})")
    verts, faces = icosphere(level)
    grid = tm.Grid.from_bounding_box([-1.1] * 3, [1.1] * 3, [cells] * 3)
    n, n_slabs = cells ** 3, cells // slab
    counters = (sweep.COUNT, parity.COUNT, parity.DENSE_COUNT,
                sdf_k.RECORDS_COUNT, sdf_k.RAYCAST_COUNT, sdf_k.NORMAL_COUNT,
                seed_k.COUNT)

    def run(sign=tm.SignMethod.RAYCAST, g=grid, s=slab, device=dev, **kw):
        return gs.generate_grid_sdf_streamed(verts, faces, g, sign,
                                             slab_nx=s, device=device, **kw)

    def peak_of(fn):
        """(fn's result, host seconds, the peak device bytes allocated
        during fn above those allocated before it)."""
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return (out, time.perf_counter() - t0,
                torch.cuda.max_memory_allocated() - before)

    gs._STREAM_PREP_CACHE.clear()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    for c in counters:
        c.reset()
    sdf, t_cold, peak_cold = peak_of(run)
    launches = {"sweep": sweep.COUNT.kernel, "parity": parity.COUNT.kernel,
                "records": sdf_k.RECORDS_COUNT.kernel,
                "seed": seed_k.COUNT.kernel}
    plain = sum(c.plain for c in counters)
    log(f"  launches: seed {launches['seed']} (one per slab pass), sweep "
        f"{launches['sweep']} ({2 * n_slabs} slab passes x 8), binned parity "
        f"{launches['parity']} ({n_slabs} slabs x 3), record packing "
        f"{launches['records']}, other kernels "
        f"{sum(c.kernel for c in counters) - sum(launches.values())}; "
        f"plain-version calls {plain}")
    # Records: packed once, for the prep; every slab pass's seed and
    # sweeps read those.
    if (launches["sweep"] != 16 * n_slabs or launches["parity"] != 3 * n_slabs
            or launches["records"] != 1 or launches["seed"] != 2 * n_slabs
            or plain):
        raise AssertionError("the streamed path did not run through its "
                             "kernels as planned")
    if sdf.device.type != "cpu" or sdf.shape != (n,):
        raise AssertionError(f"output {sdf.device} {tuple(sdf.shape)}")
    sdf_dev = sdf.to(dev)
    if not bool(torch.isfinite(sdf_dev).all()):
        raise AssertionError("non-finite distances")
    r = grid.all_cell_centers(dev).reshape(-1, 3).norm(dim=-1)
    inside = float((sdf_dev < 0).float().mean())
    err = float((sdf_dev - (r - 1.0)).abs().max())
    far = (r - 1.0).abs() > 2 * float(grid.cell_size[0])
    sign_ok = bool(torch.equal((sdf_dev < 0)[far], (r < 1.0)[far]))
    log(f"  inside fraction {inside:.5f}, max |sdf - (|c| - 1)| {err:.6f}, "
        f"sign matches the sphere beyond 2 cells: {sign_ok}")
    if not (0.37 < inside < 0.42) or err >= 0.05 or not sign_ok:
        raise AssertionError("streamed output is wrong")
    del r

    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    t_warm = statistics.median(times)
    log(f"  cold call (host prep included) {t_cold:.4f} s; warm "
        f"{', '.join(f'{t:.4f}' for t in times)} s; median {t_warm:.4f} s "
        f"= {n / t_warm:.4e} cells/s ({card})")

    # Stage times per pass (CUDA events), the fetch's copies and the host's
    # moves out of the pinned buffers, in one warm call.
    spans, fetches, moves, passes = [], [], [], [0]
    patched = []

    def patch(module, name, label):
        fn = getattr(module, name)
        patched.append((module, name, fn))

        def wrapper(*a, **k):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            if label == "pass":
                passes[0] += 1
            start.record()
            out = fn(*a, **k)
            end.record()
            spans.append((1 if passes[0] <= n_slabs else 2, label, start,
                          end))
            return out

        setattr(module, name, wrapper)

    class Fetch(gs._Fetch):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            fetches.append(self)

        @staticmethod
        def _drain(done, buf, rows):
            done.synchronize()
            t0 = time.perf_counter()
            rows.copy_(buf)
            moves.append(time.perf_counter() - t0)

    for module, name, label in (
            (gs, "_slab_pass", "pass"), (cpt, "seed_from_bins", "seed"),
            (cpt, "closest_point_grid", "sweeps"),
            (gs, "_x_sweeps", "x sweeps"), (gs, "_merge_edge", "edge merges"),
            (gs, "_slab_sign", "sign"),
            (parity, "grid_inside_mask", "parity + vote"),
            (parity, "line_parity_counts_binned", "parity")):
        patch(module, name, label)
    fetch_class, gs._Fetch = gs._Fetch, Fetch
    base = torch.cuda.Event(enable_timing=True)
    try:
        torch.cuda.synchronize()
        base.record()
        t0 = time.perf_counter()
        run()
        t_one = time.perf_counter() - t0
    finally:
        gs._Fetch = fetch_class
        for module, name, fn in patched:
            setattr(module, name, fn)
    stage = {}
    for p, label, s, e in spans:
        stage[(p, label)] = stage.get((p, label), 0.0) + s.elapsed_time(e)
    for p in (1, 2):
        parts = {k[1]: v for k, v in stage.items() if k[0] == p}
        if "parity + vote" in parts:
            parts["vote"] = parts.pop("parity + vote") - parts["parity"]
        log(f"  pass {p} ({n_slabs} slabs), CUDA events: "
            + ", ".join(f"{k} {v:.2f} ms" for k, v in parts.items()))
    # Overlap: the share of each device-to-host copy (its ready and done
    # events) that lies inside a slab pass or a signing on the compute
    # stream.
    busy = sorted((base.elapsed_time(s), base.elapsed_time(e))
                  for _, label, s, e in spans if label in ("pass", "sign"))
    copies = [(base.elapsed_time(a), base.elapsed_time(b))
              for a, b in fetches[0].copies]
    total = sum(b - a for a, b in copies)
    hidden = sum(max(0.0, min(b, e) - max(a, s)) for a, b in copies
                 for s, e in busy)
    log(f"  one warm call {t_one:.4f} s; fetch: {len(copies)} copies of "
        f"{4 * n // n_slabs / 2**20:.0f} MiB, {total:.2f} ms on the side "
        f"stream, {hidden / max(total, 1e-9):.3f} of it under compute; the "
        f"host's moves out of the pinned buffers {1e3 * sum(moves):.1f} ms "
        f"on the worker thread")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    log(f"  host syncs in one call (set_sync_debug_mode): {len(syncs)}")
    # What the fetch costs end to end: the warm calls above against warm
    # calls whose puts and final wait are no-ops (the result stays empty).
    put, wait = gs._Fetch.put, gs._Fetch.wait
    gs._Fetch.put = gs._Fetch.wait = lambda *a, **k: None
    try:
        _, no_fetch = warm_times(run, reps=3)
    finally:
        gs._Fetch.put, gs._Fetch.wait = put, wait
    log(f"  warm calls without the fetch "
        f"{', '.join(f'{t:.4f}' for t in no_fetch)} s: the fetch adds "
        f"{t_warm - statistics.median(no_fetch):.4f} s (medians)")

    def seed_stage(plain):
        """(whole warm call s, the seed's CUDA-event ms summed over the
        call's slab passes), with the seed's plain version (the eager chain
        the kernel replaced) in the kernel's place or not."""
        cpt_seed, kernel_seed = cpt.seed_from_bins, seed_k.seed_from_bins
        stage_ms = []

        def timed(*a, **k):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = cpt_seed(*a, **k)
            end.record()
            stage_ms.append((start, end))
            return out

        cpt.seed_from_bins = timed
        if plain:
            seed_k.seed_from_bins = (
                lambda grid, ta, tb, tc, bins, tris=None:
                seed_k.seed_from_bins_plain(grid, ta, tb, tc, bins))
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            t_call = time.perf_counter() - t0
        finally:
            cpt.seed_from_bins, seed_k.seed_from_bins = cpt_seed, kernel_seed
        return t_call, sum(s.elapsed_time(e) for s, e in stage_ms)

    before, after = seed_stage(True), seed_stage(False)
    log(f"  seed, plain version (before) -> kernel (after), one warm call "
        f"each: seed {before[1]:.2f} -> {after[1]:.2f} ms over "
        f"{2 * n_slabs} slab passes; whole call {before[0]:.4f} -> "
        f"{after[0]:.4f} s ({card})")

    # The kernels against their plain versions at the path's shapes.
    prep = next(iter(gs._STREAM_PREP_CACHE.values()))
    shapes = {}
    for i in hold_slabs:
        g = prep.slabs[i]
        ta, tb, tc = prep.tris
        seed_shape = hold_seed(g, prep.tris, prep.seeds[i], prep.sweep_tris,
                               f"slab {i} {tuple(g.cell_count)}")
        if i == hold_slabs[-1]:
            shapes["seed"] = seed_shape
        state = cpt.sweep_state(g, cpt.seed_from_bins(g, ta, tb, tc,
                                                      prep.seeds[i]))
        for axis in (0, 1, 2):
            for rev in (False, True):
                args = (prep.sweep_tris, rev, g.first_cell, g.cell_size)
                want = sweep.sweep_axis_plain(*[t.clone() for t in state],
                                              *args, axis=axis)
                sweep.sweep_axis(*state, *args, axis=axis)
                torch.cuda.synchronize()
                if not all(torch.equal(a.view(torch.int32),
                                       b.view(torch.int32))
                           for a, b in zip(state, want)):
                    raise AssertionError(f"sweep kernel disagrees: slab {i} "
                                         f"axis {axis} reverse {rev}")
        for axis in range(3):
            origins, lshape = face_origins(g, axis, dev)
            iy, iz = (axis + 1) % 3, (axis + 2) % 3
            lb = prep.line_bins[i][axis]
            pargs = (origins[:, iy].contiguous(), origins[:, iz].contiguous(),
                     g.first_cell[axis], g.cell_size[axis], lb)
            pkw = dict(n_cells=g.cell_count[axis], n1=lshape[0],
                       n2=lshape[1])
            got, _ = parity.line_parity_counts_binned(*pargs, **pkw)
            (want, _), p_ms = plain_once(
                lambda: parity.line_parity_counts_binned_plain(*pargs, **pkw))
            if not torch.equal(got, want):
                raise AssertionError(f"binned parity disagrees: slab {i} "
                                     f"axis {axis}")
            k_ms = graph_ms(lambda: parity.line_parity_counts_binned(
                *pargs, **pkw), 5)
            pairs = int((lb.tbl != lb.n_blocks).sum()) * lb.tb * lb.tile ** 2
            b = bound(parity_flops(pairs, want),
                      sum(t.numel() * t.element_size()
                          for t in (pargs[0], pargs[1], lb.rows, lb.tbl))
                      + 4 * pargs[0].numel() * pkw["n_cells"])
            log(f"  slab {i} binned parity axis {axis} ({lshape[0]}x"
                f"{lshape[1]} lines x {pkw['n_cells']} cells, "
                f"{lb.tbl.shape[1]} slots, {pairs} pairs): equal to plain; "
                f"kernel {k_ms:.4f} ms (graph replay), plain {p_ms:.1f} ms, "
                f"bound {b[0]:.4f} ms ({b[1]})")
            if i == hold_slabs[-1]:
                shapes[f"parity axis {axis}"] = (k_ms, p_ms, b)
        log(f"  slab {i} ({tuple(g.cell_count)}): sweep bit-equal to plain "
            f"in all six directions")
        if i == hold_slabs[-1]:
            work = [t.clone() for t in state]
            copy_ms = cuda_ms(
                lambda: [d.copy_(s) for d, s in zip(work, state)], 5)

            def one(fn, axis, rev):
                def go():
                    for d, s in zip(work, state):
                        d.copy_(s)
                    fn(*work, prep.sweep_tris, rev, g.first_cell,
                       g.cell_size, axis=axis)
                return go

            cells_slab = g.cell_count[0] * g.cell_count[1] * g.cell_count[2]
            b_s = bound(roofline.sweep_flops(cells_slab),
                        roofline.sweep_bytes(cells_slab,
                                             prep.sweep_tris.rec.shape[0]))
            for axis in (0, 1, 2):
                ms = {rev: cuda_ms(one(sweep.sweep_axis, axis, rev), 3)
                      - copy_ms for rev in (False, True)}
                _, p_ms = plain_once(one(sweep.sweep_axis_plain, axis, False))
                shapes[f"sweep axis {axis}"] = (ms[False], p_ms - copy_ms,
                                                b_s)
                log(f"  slab sweep axis {axis}: kernel {ms[False]:.3f} / "
                    f"{ms[True]:.3f} ms (forward / reverse), plain "
                    f"{p_ms - copy_ms:.1f} ms, bound {b_s[0]:.3f} ms "
                    f"({b_s[1]})")
        del state

    # The in-core CPT route on the same grid.
    topo = tm.Topology.triangle_list(faces.reshape(-1))
    verts_dev = torch.from_numpy(verts).to(dev)

    def in_core(sign=tm.SignMethod.RAYCAST, g=grid):
        out = tm.generate_grid_sdf(verts_dev, topo, g, sign,
                                   strategy=tm.Strategy.CPT)
        torch.cuda.synchronize()
        return out

    _, _, peak_warm = peak_of(run)
    gs._STREAM_PREP_CACHE.clear()
    torch.cuda.empty_cache()
    ref, t_in_cold, peak_in_cold = peak_of(in_core)
    _, _, peak_in_warm = peak_of(in_core)
    _, in_times = warm_times(in_core, reps=2)
    r = grid.all_cell_centers(dev).reshape(-1, 3).norm(dim=-1)
    far = (r - 1.0).abs() > 2 * float(grid.cell_size[0])
    err_in = float((ref - (r - 1.0)).abs().max())
    at = int((sdf_dev - (r - 1.0)).abs().argmax())
    log(f"  streamed max |sdf - (|c| - 1)| at |c| - 1 = "
        f"{float(r[at]) - 1.0:.4f} (sdf {float(sdf_dev[at]):.6f}, in-core "
        f"{float(ref[at]):.6f}); in-core max |sdf - (|c| - 1)| {err_in:.6f}")
    del r
    signs = bool(torch.equal((sdf_dev < 0)[far], (ref < 0)[far]))
    rel = float(((sdf_dev.abs() - ref.abs()).abs() / ref.abs())[far].max())
    diff = float((sdf_dev.abs() - ref.abs()).abs().max())
    log(f"  in-core CPT {cells}^3: cold {t_in_cold:.4f} s, warm "
        f"{', '.join(f'{t:.4f}' for t in in_times)} s; streamed vs in-core: "
        f"max abs {diff:.3e}, max relative beyond 2 cells {rel:.5f}, signs "
        f"equal beyond 2 cells {signs}")
    log(f"  peak device memory above what was allocated before the call "
        f"(max_memory_allocated): streamed {peak_cold / 2**30:.3f} GiB cold "
        f"(prep kept on the device included), {peak_warm / 2**30:.3f} GiB "
        f"warm; in-core {peak_in_cold / 2**30:.3f} GiB cold, "
        f"{peak_in_warm / 2**30:.3f} GiB warm ({card})")
    if not signs or rel > 0.02:
        raise AssertionError("the streamed grid breaks the CPT contract "
                             "against the in-core route")
    del ref, sdf_dev, far, verts_dev
    gridgen._CPT_PREP_CACHE.clear()
    torch.cuda.empty_cache()

    # NORMAL at normal_cells³ against the in-core NORMAL route.
    g_n = tm.Grid.from_bounding_box([-1.1] * 3, [1.1] * 3, [normal_cells] * 3)
    verts_dev = torch.from_numpy(verts).to(dev)
    got = run(tm.SignMethod.NORMAL, g_n, min(slab, normal_cells)).to(dev)
    want = in_core(tm.SignMethod.NORMAL, g_n)
    apart = float((torch.signbit(got) != torch.signbit(want)).float().mean())
    log(f"  NORMAL {normal_cells}^3: signs apart from the in-core route "
        f"{apart:.5f} (limit 0.01), max | |d| - |d_in| | "
        f"{float((got.abs() - want.abs()).abs().max()):.3e}")
    if apart > 0.01:
        raise AssertionError("streamed NORMAL signs disagree")
    del verts_dev, got, want
    gs._STREAM_PREP_CACHE.clear()
    gridgen._CPT_PREP_CACHE.clear()

    # Card against CPU, the whole call at a small size.
    g_s = tm.Grid.from_bounding_box([-1.1] * 3, [1.1] * 3, list(small))
    for c in counters:
        c.reset()
    card_out = run(g=g_s, s=small_slab)
    k_launch = (sweep.COUNT.kernel, parity.COUNT.kernel)
    t0 = time.perf_counter()
    cpu_out = run(g=g_s, s=small_slab, device="cpu")
    t_cpu = time.perf_counter() - t0
    same = torch.equal(card_out.view(torch.int32), cpu_out.view(torch.int32))
    gap = float((card_out - cpu_out).abs().max())
    n_diff = int((card_out.view(torch.int32) != cpu_out.view(torch.int32))
                 .sum())
    log(f"  {small} slab {small_slab}, card vs CPU ({t_cpu:.1f} s): "
        f"bit-equal {same}, {n_diff} cells differ, max abs {gap:.3e}, signs "
        f"equal {torch.equal(torch.signbit(card_out), torch.signbit(cpu_out))}"
        f"; card launches sweep {k_launch[0]}, parity {k_launch[1]}")
    if (not torch.equal(torch.signbit(card_out), torch.signbit(cpu_out))
            or not torch.allclose(card_out, cpu_out, rtol=RTOL, atol=ATOL)):
        raise AssertionError("streamed grid: card and CPU disagree")
    gs._STREAM_PREP_CACHE.clear()
    torch.cuda.empty_cache()
    return {"launches": launches, "shapes": shapes,
            "shape": f"slab {slab}x{cells}x{cells} of {cells}^3"}


def _counters():
    """The kernel counters of the sharded phase, by kernel row."""
    from mesh_to_sdf_tpu_torch.ops.kernels import culled, parity, sweep
    from mesh_to_sdf_tpu_torch.ops.kernels import sdf as sdf_k
    from mesh_to_sdf_tpu_torch.ops.kernels import seed as seed_k

    return {"sweep": sweep.COUNT, "parity": parity.COUNT,
            "dense": parity.DENSE_COUNT, "raycast": sdf_k.RAYCAST_COUNT,
            "normal": sdf_k.NORMAL_COUNT, "culled": culled.COUNT,
            "records": sdf_k.RECORDS_COUNT, "seed": seed_k.COUNT,
            "phase_a": culled.PHASE_A_COUNT}


def _read_counts() -> dict:
    return {k: (c.kernel, c.plain) for k, c in _counters().items()}


def _reset_counts() -> None:
    for c in _counters().values():
        c.reset()


def _launched(count) -> int:
    """Kernel launches of a (kernel, plain) count pair."""
    return count[0]


def _plain(count) -> int:
    """Plain-version calls of a (kernel, plain) count pair."""
    return count[1]


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _sharded_rank(rank, world, store, out_dir, cfg):
    """One spawned rank of the sharded phase's several-rank part (gloo;
    every rank on the one card): the x-slab CPT grid at ``cfg["cells"]``³
    on cells = ``world``, the same call at ``cfg["small"]`` on the card and
    on the CPU, cells 2 x tris 2 ``generate_sdf_sharded`` at
    ``cfg["n_queries"]`` queries, both signs, and the weak-scaling report.
    Writes its results and its launches under ``out_dir``."""
    sys.path.insert(0, str(ROOT))
    import torch
    import torch.distributed as dist

    torch.set_num_threads(max(1, (os.cpu_count() or 1) // (world + 1)))
    import mesh_to_sdf_tpu_torch as tm
    from mesh_to_sdf_tpu_torch.parallel import grid_sharded as gsh
    from mesh_to_sdf_tpu_torch.parallel import mesh as pmesh
    from mesh_to_sdf_tpu_torch.parallel import scaling, sharding
    from mesh_to_sdf_tpu_torch.utils.meshgen import icosphere

    dev_type = cfg["device_type"]
    pmesh.initialize_distributed(f"file://{store}", world, rank,
                                 device_type=dev_type)
    dev = sharding._rank_device(dev_type)
    out = {"backend": dist.get_backend(), "device": str(dev)}
    verts, faces = icosphere(cfg["level"])
    box = ([-1.1] * 3, [1.1] * 3)
    mesh = pmesh.make_sdf_mesh(world, 1, device_type=dev_type)
    mesh22 = pmesh.make_sdf_mesh(2, 2, device_type=dev_type)
    grid = tm.Grid.from_bounding_box(*box, [cfg["cells"]] * 3)
    small = tm.Grid.from_bounding_box(*box, cfg["small"])
    q = np.random.default_rng(1).uniform(
        -1.3, 1.3, (cfg["n_queries"], 3)).astype(np.float32)

    def grid_call(g, device=dev):
        r = gsh.generate_grid_sdf_sharded_cpt(verts, faces, g, mesh,
                                              tm.SignMethod.RAYCAST,
                                              device=device)
        _sync(r.device)
        return r

    try:
        dist.barrier()
        _reset_counts()
        t0 = time.perf_counter()
        big = grid_call(grid)
        out["t_cold"] = time.perf_counter() - t0
        out["launches_grid"] = _read_counts()
        warm = []
        for _ in range(3):
            dist.barrier()
            t0 = time.perf_counter()
            grid_call(grid)
            warm.append(time.perf_counter() - t0)
        out["t_warm"] = warm
        _reset_counts()
        card_small = grid_call(small)
        queries = {}
        for sign in tm.SignMethod:
            r = sharding.generate_sdf_sharded(verts, faces.astype(np.int32),
                                              q, mesh22, sign, device=dev)
            _sync(dev)
            queries[sign.value] = r.cpu().numpy()
        out["launches_small_queries"] = _read_counts()
        _reset_counts()
        out["report"] = scaling.measure_weak_scaling(
            device_counts=[1, 2, 4], device=dev, **cfg["scaling"])
        out["launches_scaling"] = _read_counts()
        cpu_small = grid_call(small, device="cpu")
    finally:
        dist.destroy_process_group()
    if rank == 0:
        np.save(Path(out_dir) / "big.npy", big.cpu().numpy())
        out["small_card"] = card_small.cpu().numpy()
        out["small_cpu"] = cpu_small.numpy()
        out["queries"] = queries
    with open(Path(out_dir) / f"rank{rank}.json", "w") as fh:
        json.dump({k: v for k, v in out.items()
                   if k not in ("small_card", "small_cpu", "queries")}, fh)
    if rank == 0:
        np.savez(Path(out_dir) / "rank0.npz", small_card=out["small_card"],
                 small_cpu=out["small_cpu"], **{
                     f"q_{k}": v for k, v in out["queries"].items()})


def _spawn_ranks(world, cfg, out_dir, timeout_s=600):
    """Run :func:`_sharded_rank` on ``world`` spawned processes and wait;
    a rank that fails raises here, and no rank outlives the call."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(
        _sharded_rank, args=(world, str(Path(out_dir) / "store"),
                             str(out_dir), cfg),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"ranks still running after {timeout_s} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
                proc.join(30)


def sharded_phase(dev, *, cells=512, level=5, halo_rounds=2,
                  n_queries=1_000_000, culled_level=6, fit_level=4,
                  fit_cells=64, fit_steps=3, world=4, rank_cells=256,
                  small=(64, 32, 32), rank_queries=65_536, hold_q=16_384,
                  scaling_kw=None, card=""):
    """Path 7: ``parallel/`` (the sharded query, grid and training paths).

    World of 1 on NCCL, in this process: ``generate_grid_sdf_sharded_cpt``
    on ``icosphere(level)`` at ``cells``³ (RAYCAST, ``halo_rounds``) held
    to the sphere and to the in-core CPT route at ``cells``³;
    ``generate_sdf_sharded`` at ``n_queries``, both signs, bit-equal to
    ``generate_sdf(..., PALLAS)``; ``generate_sdf_sharded_culled`` on
    ``icosphere(culled_level)`` (cold: its sign grid's dense parity) against
    single-device CULLED; ``sharded_fit_step_fn`` (NORMAL) on
    ``icosphere(fit_level)`` at ``fit_cells``³, its gradient against
    ``signed_champion_distances``. Then ``world`` spawned gloo ranks on the
    one card (:func:`_sharded_rank`). Then every kernel of the path against
    its plain version at the path's shapes.

    Returns per kernel row the launches on the path, and the kernel's
    (ms, plain ms, bound) at this path's shape, with the shape's name.
    """
    import tempfile

    import torch
    import torch.distributed as dist

    import mesh_to_sdf_tpu_torch as tm
    from mesh_to_sdf_tpu_torch import gridgen, query
    from mesh_to_sdf_tpu_torch.models.sdf_layer import pad_tri_idx, sdf_grid
    from mesh_to_sdf_tpu_torch.ops import autodiff, cpt, culling
    from mesh_to_sdf_tpu_torch.ops.keyed import combine_champions
    from mesh_to_sdf_tpu_torch.ops.kernels import culled, parity, sweep
    from mesh_to_sdf_tpu_torch.ops.kernels import sdf as sdf_k
    from mesh_to_sdf_tpu_torch.ops.raycast import face_origins
    from mesh_to_sdf_tpu_torch.parallel import grid_sharded as gsh
    from mesh_to_sdf_tpu_torch.parallel import mesh as pmesh
    from mesh_to_sdf_tpu_torch.parallel import scaling, sharding
    from mesh_to_sdf_tpu_torch.utils.meshgen import icosphere

    log(f"== path 7: parallel/ on a world of 1 (NCCL), icosphere({level}) "
        f"({card})")
    pmesh.initialize_distributed(device_type=dev.type)
    backend = dist.get_backend()
    mesh = pmesh.make_sdf_mesh(1, 1, device_type=dev.type)
    log(f"  process group: world {dist.get_world_size()}, backend {backend}")
    if dev.type == "cuda" and backend != "nccl":
        raise AssertionError("a world of 1 on a card must take NCCL")
    launches = {k: 0 for k in _counters()}

    def add(counts):
        """Add a main-path window's launches; it ran no plain version."""
        if any(_plain(c) for c in counts.values()):
            raise AssertionError(f"the main path ran a plain version: "
                                 f"{counts}")
        for k, c in counts.items():
            launches[k] += _launched(c)

    verts, faces = icosphere(level)
    faces64 = faces.astype(np.int64)
    topo = tm.Topology.triangle_list(faces.reshape(-1))
    verts_dev = torch.from_numpy(verts).to(dev)
    ra, rb, rc = (torch.from_numpy(np.ascontiguousarray(
        verts[faces[:, k]])).to(dev) for k in range(3))
    box = ([-1.1] * 3, [1.1] * 3)

    def peak_of(fn):
        _sync(dev)
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn()
        _sync(dev)
        return (out, time.perf_counter() - t0,
                torch.cuda.max_memory_allocated() - before)

    def hold_grid(got, g, what):
        """``got`` against the sphere and the in-core CPT route on ``g``:
        signs equal and <= 2 % apart beyond 2 cells. The extra ±x sweeps
        of the halo rounds can only bring a value closer to the exact
        distance, so it may lie below the in-core one; where ``got`` lies
        below it by more than ATOL, it is not below the exact distance by
        more than ATOL: the brute force over every triangle by projection
        (``Strategy.XLA``), as the tests' CPT contract holds it."""
        n = g.total_cell_count
        if got.shape != (n,) or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{what}: output {tuple(got.shape)}")
        centres = g.all_cell_centers(dev).reshape(-1, 3)
        r = centres.norm(dim=-1)
        inside = float((got < 0).float().mean())
        err = float((got - (r - 1.0)).abs().max())
        far = (r - 1.0).abs() > 2 * float(g.cell_size[0])
        sphere_ok = bool(torch.equal((got < 0)[far], (r < 1.0)[far]))
        ref = tm.generate_grid_sdf(verts_dev, topo, g, tm.SignMethod.RAYCAST,
                                   strategy=tm.Strategy.CPT)
        signs = bool(torch.equal((got < 0)[far], (ref < 0)[far]))
        rel = float(((got.abs() - ref.abs()).abs() / ref.abs())[far].max())
        low = torch.nonzero(got.abs() < ref.abs() - ATOL).reshape(-1)
        under = 0.0
        if low.numel():
            exact = tm.generate_sdf(verts_dev, topo, centres[low],
                                    tm.Strategy.XLA,
                                    sign_method=tm.SignMethod.NORMAL)
            under = float((exact.abs() - got[low].abs()).max())
        log(f"  {what}: inside fraction {inside:.5f}, max |sdf - (|c| - 1)| "
            f"{err:.6f}, sign = sphere beyond 2 cells {sphere_ok}; against "
            f"in-core CPT: signs equal beyond 2 cells {signs}, max relative "
            f"beyond 2 cells {rel:.5f}, max abs "
            f"{float((got.abs() - ref.abs()).abs().max()):.3e}, "
            f"{low.numel()} cells below it by more than {ATOL}, those at "
            f"most {under:.3e} below the exact distance (bound {ATOL})")
        if (not (0.37 < inside < 0.42) or err >= 0.05 or not sphere_ok
                or not signs or rel > 0.02 or under > ATOL):
            raise AssertionError(f"{what}: breaks the CPT contract")
        del ref, centres, r, far

    def hold_slab(prep, directions, parity_axes, what):
        """The sweep kernel in ``directions`` (in turn, on the slab's
        seeded state) and the binned parity kernel on ``parity_axes``, each
        bit-equal to its plain version on ``prep``'s slab. Returns the
        first direction's and the first parity axis's (ms, plain ms, bound,
        shape)."""
        slab = prep.slab
        shape = "x".join(map(str, slab.cell_count))
        state = cpt.sweep_state(slab, cpt.seed_from_bins(slab, *prep.tris,
                                                         prep.seed))
        out = {}
        for axis, rev in directions:
            args = (prep.sweep_tris, rev, slab.first_cell, slab.cell_size)
            if not out:
                work = [t.clone() for t in state]
                copy_ms = cuda_ms(lambda: [d.copy_(s) for d, s in
                                           zip(work, state)], 3)

                def go():
                    for d, s in zip(work, state):
                        d.copy_(s)
                    sweep.sweep_axis(*work, *args, axis=axis)

                s_ms = cuda_ms(go, 3) - copy_ms
                del work
            clone = [t.clone() for t in state]
            want, p_ms = plain_once(lambda: sweep.sweep_axis_plain(
                *clone, *args, axis=axis))
            sweep.sweep_axis(*state, *args, axis=axis)
            _sync(dev)
            if not all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                       for a, b in zip(state, want)):
                raise AssertionError(f"sweep kernel disagrees at the {what} "
                                     f"{shape}: axis {axis} reverse {rev}")
            if not out:
                out["sweep"] = (s_ms, p_ms, bound(
                    roofline.sweep_flops(slab.total_cell_count),
                    roofline.sweep_bytes(slab.total_cell_count,
                                         prep.sweep_tris.rec.shape[0])),
                    f"{'-' if rev else '+'}{'xyz'[axis]}, {what} {shape}")
            del clone, want
        del state
        for axis in parity_axes:
            origins, lshape = face_origins(slab, axis, dev)
            iy, iz = (axis + 1) % 3, (axis + 2) % 3
            lb = prep.line_bins[axis]
            pargs = (origins[:, iy].contiguous(), origins[:, iz].contiguous(),
                     slab.first_cell[axis], slab.cell_size[axis], lb)
            pkw = dict(n_cells=slab.cell_count[axis], n1=lshape[0],
                       n2=lshape[1])
            got, _ = parity.line_parity_counts_binned(*pargs, **pkw)
            (want, _), p_ms = plain_once(
                lambda: parity.line_parity_counts_binned_plain(*pargs, **pkw))
            if not torch.equal(got, want):
                raise AssertionError(f"binned parity disagrees at the {what} "
                                     f"{shape}: axis {axis}")
            if "parity" not in out:
                k_ms = graph_ms(lambda: parity.line_parity_counts_binned(
                    *pargs, **pkw), 5)
                pairs = (int((lb.tbl != lb.n_blocks).sum()) * lb.tb
                         * lb.tile ** 2)
                out["parity"] = (k_ms, p_ms, bound(
                    parity_flops(pairs, want),
                    sum(t.numel() * t.element_size()
                        for t in (pargs[0], pargs[1], lb.rows, lb.tbl))
                    + 4 * pargs[0].numel() * pkw["n_cells"]),
                    f"axis {axis}, {what} {shape}")
            del got, want, origins
        sw, pa = out["sweep"], out["parity"]
        log(f"  sweep at the {what} {shape}: bit-equal to plain in "
            f"{len(directions)} directions "
            f"{[('-' if r else '+') + 'xyz'[a] for a, r in directions]}; "
            f"{sw[3].split(',')[0]} kernel {sw[0]:.3f} ms, plain "
            f"{sw[1]:.1f} ms, bound {sw[2][0]:.3f} ms ({sw[2][1]})")
        log(f"  binned parity at the {what} {shape}: equal to plain on axes "
            f"{list(parity_axes)}; {pa[3].split(',')[0]} kernel "
            f"{pa[0]:.4f} ms (graph replay), plain {pa[1]:.1f} ms, bound "
            f"{pa[2][0]:.4f} ms ({pa[2][1]})")
        return out

    # 1. The x-slab CPT grid at cells³ (one slab).
    grid = tm.Grid.from_bounding_box(*box, [cells] * 3)

    def cpt_call():
        out = gsh.generate_grid_sdf_sharded_cpt(verts, faces, grid, mesh,
                                                tm.SignMethod.RAYCAST,
                                                halo_rounds=halo_rounds)
        _sync(dev)
        return out

    gsh._SHARDED_PREP_CACHE.clear()
    torch.cuda.empty_cache()
    _reset_counts()
    sdf, t_cold, peak_cold = peak_of(cpt_call)
    c_cpt = _read_counts()
    add(c_cpt)
    log(f"  sharded CPT {cells}^3: launches {c_cpt} (kernel, plain); cold "
        f"{t_cold:.4f} s")
    want_sweeps = 6 + 2 * halo_rounds
    if (_launched(c_cpt["sweep"]) != want_sweeps
            or _launched(c_cpt["parity"]) != 3):
        raise AssertionError("the sharded CPT call did not run through its "
                             "kernels as planned")
    _, warm = warm_times(cpt_call, reps=3)
    _, _, peak_warm = peak_of(cpt_call)
    log(f"  warm {', '.join(f'{t:.4f}' for t in warm)} s; median "
        f"{statistics.median(warm):.4f} s = "
        f"{cells ** 3 / statistics.median(warm):.4e} cells/s; peak device "
        f"memory above the call's start {peak_cold / 2**30:.3f} GiB cold, "
        f"{peak_warm / 2**30:.3f} GiB warm ({card})")
    spans, patched = [], []

    def patch(module, name, label):
        fn = getattr(module, name)
        patched.append((module, name, fn))

        def wrapper(*a, **k):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **k)
            end.record()
            spans.append((label, start, end))
            return out

        setattr(module, name, wrapper)

    for module, name, label in (
            (cpt, "seed_from_bins", "seed"),
            (cpt, "closest_point_grid", "sweeps"),
            (gsh, "_halo_round", "halo rounds"), (gsh, "_sign", "sign"),
            (gsh, "_all_gather", "gather")):
        patch(module, name, label)
    try:
        cpt_call()
    finally:
        for module, name, fn in patched:
            setattr(module, name, fn)
    stage = {}
    for label, s, e in spans:
        stage[label] = stage.get(label, 0.0) + s.elapsed_time(e)
    log("  stages of one warm call (CUDA events): "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in stage.items()))
    # The world of 1's one slab is the whole grid: a y and a z sweep (every
    # tile of a cells² plane walking cells slices) and axis-0 parity over
    # cells² lines, at this shape, against their plain versions.
    world1 = hold_slab(gsh._slab_prep(grid, 1, 0, verts, faces64, True, dev),
                       [(1, False), (2, False)], (0,), "world of 1")
    torch.cuda.empty_cache()
    hold_grid(sdf, grid, f"sharded CPT {cells}^3")
    del sdf
    gsh._SHARDED_PREP_CACHE.clear()
    gridgen._CPT_PREP_CACHE.clear()
    torch.cuda.empty_cache()

    # 2. Sharded queries, both signs, against PALLAS.
    q = np.random.default_rng(0).uniform(-1.3, 1.3,
                                         (n_queries, 3)).astype(np.float32)
    faces32 = faces.astype(np.int32)
    for sign in tm.SignMethod:
        def sharded_q(sign=sign):
            out = sharding.generate_sdf_sharded(verts, faces32, q, mesh,
                                                sign)
            _sync(dev)
            return out

        def pallas_q(sign=sign):
            out = tm.generate_sdf(verts, topo, q, tm.Strategy.PALLAS,
                                  sign_method=sign, device=dev)
            _sync(dev)
            return out

        _reset_counts()
        got = sharded_q()
        c_q = _read_counts()
        add(c_q)
        want = pallas_q()
        same = torch.equal(got.view(torch.int32), want.view(torch.int32))
        _, t_s = warm_times(sharded_q)
        _, t_p = warm_times(pallas_q)
        log(f"  generate_sdf_sharded {n_queries} queries, {sign.value}: "
            f"bit-equal to PALLAS {same}; warm sharded "
            f"{', '.join(f'{t:.4f}' for t in t_s)} s, PALLAS "
            f"{', '.join(f'{t:.4f}' for t in t_p)} s; launches {c_q}")
        key = "raycast" if sign == tm.SignMethod.RAYCAST else "normal"
        if not same or _launched(c_q[key]) != 1:
            raise AssertionError(f"sharded queries ({sign.value}) differ "
                                 f"from PALLAS or missed the kernel")

    # 3. Sharded CULLED, cold, against single-device CULLED.
    verts6, faces6 = icosphere(culled_level)
    topo6 = tm.Topology.triangle_list(faces6.reshape(-1))
    recorded = {}

    def recorder(module, name):
        fn = getattr(module, name)

        def wrapper(*a, **k):
            recorded.setdefault(name, (a, k))
            return fn(*a, **k)

        setattr(module, name, wrapper)
        return fn

    def sharded_culled():
        out = sharding.generate_sdf_sharded_culled(verts6, faces6, q, mesh)
        _sync(dev)
        return out

    for cache in (query._SIGN_GRID_CACHE, query._BLOCK_INDEX_CACHE,
                  query._PARITY_BINS_CACHE):
        cache.clear()
    _reset_counts()
    originals = [(culled, "culled_blocks", recorder(culled, "culled_blocks")),
                 (parity, "line_parity_counts",
                  recorder(parity, "line_parity_counts"))]
    try:
        t0 = time.perf_counter()
        got6 = sharded_culled()
        t_c_cold = time.perf_counter() - t0
    finally:
        for module, name, fn in originals:
            setattr(module, name, fn)
    c_c = _read_counts()
    add(c_c)
    _, t_c = warm_times(sharded_culled)
    culling.LAST_CULLED_STATS.clear()
    want6 = tm.generate_sdf(verts6, topo6, q)
    _sync(dev)
    if culling.LAST_CULLED_STATS.get("tris") != len(faces6):
        raise AssertionError("single-device AUTO did not take CULLED")
    n_sign = int((torch.signbit(got6) != torch.signbit(want6)).sum())
    ok = bool(torch.allclose(got6.abs(), want6.abs(), rtol=2e-4, atol=1e-5))
    log(f"  generate_sdf_sharded_culled icosphere({culled_level}) x "
        f"{n_queries}: cold {t_c_cold:.4f} s, warm "
        f"{', '.join(f'{t:.4f}' for t in t_c)} s; against single-device "
        f"CULLED max abs {float((got6.abs() - want6.abs()).abs().max()):.3e}"
        f" (within rtol 2e-4 / atol 1e-5: {ok}), signs apart {n_sign} "
        f"(limit {n_queries // 10_000}); launches {c_c}")
    if (not ok or n_sign > n_queries // 10_000
            or _launched(c_c["culled"]) < 1 or _launched(c_c["dense"]) != 3):
        raise AssertionError("sharded CULLED disagrees or missed a kernel")

    # 4. The sharded training step (NORMAL) and its gradient.
    v_fit, f_fit = icosphere(fit_level, radius=0.8)
    v_tgt, _ = icosphere(fit_level, radius=1.0)
    g_fit = tm.Grid.from_bounding_box([-1.4] * 3, [1.4] * 3, [fit_cells] * 3)
    tri_pad = torch.from_numpy(pad_tri_idx(f_fit.astype(np.int32),
                                           256)).to(dev)
    target = sdf_grid(torch.from_numpy(v_tgt).to(dev), tri_pad, g_fit,
                      tm.SignMethod.NORMAL, block=256).reshape(-1)
    v = torch.from_numpy(v_fit).to(dev).requires_grad_(True)
    opt = torch.optim.Adam([v], lr=2e-2)
    step, pad_target = sharding.sharded_fit_step_fn(
        mesh, f_fit.astype(np.int32), g_fit, opt, tm.SignMethod.NORMAL)
    shard = pad_target(target.cpu().numpy())
    v0 = v.detach().clone()
    _reset_counts()
    losses, step_s = [], []
    for _ in range(fit_steps):
        t0 = time.perf_counter()
        losses.append(float(step(shard)))
        _sync(dev)
        step_s.append(time.perf_counter() - t0)
        if len(losses) == 1:
            g_sharded = v.grad.detach().clone()
    c_t = _read_counts()
    add(c_t)
    vs = v0.clone().requires_grad_(True)
    centres = g_fit.all_cell_centers(dev).reshape(-1, 3)
    mp_, mn_ = autodiff.signed_champion_distances(vs, tri_pad, centres, 256)
    err = combine_champions(mp_, mn_) - target
    (torch.sum(err * err) / err.numel()).backward()
    g_err = float((g_sharded - vs.grad).abs().max())
    g_ok = bool(torch.allclose(g_sharded, vs.grad, atol=1e-5, rtol=1e-4))
    log(f"  sharded_fit_step_fn icosphere({fit_level}) at {fit_cells}^3, "
        f"NORMAL: losses {', '.join(f'{x:.6f}' for x in losses)}; steps "
        f"{', '.join(f'{t:.4f}' for t in step_s)} s; vertex gradient vs "
        f"single-device signed_champion_distances max abs {g_err:.3e} "
        f"(max |g| {float(vs.grad.abs().max()):.3e}; within atol 1e-5 / "
        f"rtol 1e-4: {g_ok}); launches {c_t}")
    if not losses[-1] < losses[0] or not g_ok:
        raise AssertionError("the sharded training step is wrong")
    del target, centres, v, vs, opt

    # 5. Several ranks on the one card (gloo).
    log(f"== path 7: {world} spawned ranks on one card (gloo): "
        f"{rank_cells}^3 on cells {world}, cells 2 x tris 2 at "
        f"{rank_queries} queries, weak scaling")
    cfg = {"device_type": dev.type, "level": level, "cells": rank_cells,
           "small": list(small), "n_queries": rank_queries,
           "scaling": scaling_kw or {}}
    with tempfile.TemporaryDirectory(prefix="m2s_ranks_") as tmp:
        t0 = time.perf_counter()
        _spawn_ranks(world, cfg, tmp)
        t_spawn = time.perf_counter() - t0
        ranks = []
        for r in range(world):
            with open(Path(tmp) / f"rank{r}.json") as fh:
                ranks.append(json.load(fh))
        big = torch.from_numpy(np.load(Path(tmp) / "big.npy")).to(dev)
        arrays = dict(np.load(Path(tmp) / "rank0.npz"))
    log(f"  ranks: {[r['backend'] for r in ranks]} on "
        f"{[r['device'] for r in ranks]}; spawn to join {t_spawn:.1f} s")
    if any(r["backend"] != "gloo" for r in ranks):
        raise AssertionError("ranks sharing a card must take gloo")
    for key in ("launches_grid", "launches_small_queries",
                "launches_scaling"):
        total = {k: [sum(r[key][k][i] for r in ranks) for i in (0, 1)]
                 for k in launches}
        log(f"  {key.split('_', 1)[1]}: (launches, plain calls) over the "
            f"ranks {total}")
        add(total)
    per_rank = ranks[0]["launches_grid"]
    if (_launched(per_rank["sweep"]) != 6 + 2 * 2
            or _launched(per_rank["parity"]) != 3):
        raise AssertionError("the ranks' CPT call missed its kernels")
    log(f"  {rank_cells}^3 on {world} ranks: cold "
        f"{', '.join(f'{r['t_cold']:.3f}' for r in ranks)} s; warm (rank 0) "
        f"{', '.join(f'{t:.4f}' for t in ranks[0]['t_warm'])} s")
    hold_grid(big, tm.Grid.from_bounding_box(*box, [rank_cells] * 3),
              f"{world} ranks, {rank_cells}^3")
    card_s, cpu_s = arrays["small_card"], arrays["small_cpu"]
    same = np.array_equal(card_s.view(np.int32), cpu_s.view(np.int32))
    log(f"  {tuple(small)} on {world} ranks, card vs CPU: bit-equal {same}, "
        f"max abs {float(np.abs(card_s - cpu_s).max()):.3e}")
    if not same:
        raise AssertionError("the ranks' grid: card and CPU differ")
    q4 = np.random.default_rng(1).uniform(
        -1.3, 1.3, (rank_queries, 3)).astype(np.float32)
    for sign in tm.SignMethod:
        want = sharding.generate_sdf_sharded(verts, faces32, q4, mesh, sign)
        same = np.array_equal(arrays[f"q_{sign.value}"].view(np.int32),
                              want.cpu().numpy().view(np.int32))
        log(f"  cells 2 x tris 2, {rank_queries} queries, {sign.value}: "
            f"bit-equal to the world of 1 {same}")
        if not same:
            raise AssertionError("cells 2 x tris 2 differs from world 1")
    report = ranks[0]["report"]
    log("  " + scaling.format_report(report).replace("\n", "\n  "))
    log(f"  weak scaling report: {json.dumps(report)}")
    if report["non_predictive"] is not True or len(report["rows"]) != 3:
        raise AssertionError("the weak-scaling report is wrong")
    del big
    log(f"  launches on path 7 (world of 1 and the ranks): {launches}")
    for k in ("sweep", "parity", "dense", "raycast", "normal", "culled"):
        if not launches[k]:
            raise AssertionError(f"path 7 never launched the {k} kernel")

    # 6. The kernels against their plain versions at the path's shapes.
    log("== path 7: kernels vs plain at the path's shapes")
    g_r = tm.Grid.from_bounding_box(*box, [rank_cells] * 3)
    shapes = hold_slab(gsh._slab_prep(g_r, world, 1, verts, faces64, True,
                                      dev),
                       [(a, r) for a in (0, 1, 2) for r in (False, True)],
                       (0, 1, 2), f"rank slab of {rank_cells}^3")
    gsh._SHARDED_PREP_CACHE.clear()

    (dargs, dkw) = recorded["line_parity_counts"]
    got, _ = parity.line_parity_counts(*dargs, **dkw)
    (want, _), d_p = plain_once(lambda: parity.line_parity_counts_plain(
        *dargs, **dkw))
    if not torch.equal(got, want):
        raise AssertionError("dense parity disagrees at the sign grid")
    d_k = graph_ms(lambda: parity.line_parity_counts(*dargs, **dkw), 3)
    L, T = dargs[0].numel(), dargs[4][0].shape[0]
    shapes["dense"] = (d_k, d_p, bound(
        parity_flops(L * T, want), 8 * L + 36 * T + 4 * L * dkw["n_cells"]),
        f"sign grid axis 0, {L} lines x {T} triangles")
    log(f"  dense parity at the sign grid ({L} lines x {T} triangles): equal "
        f"to plain; kernel {d_k:.4f} ms, plain {d_p:.1f} ms, bound "
        f"{shapes['dense'][2][0]:.4f} ms")

    # The raycast and normal kernels on the shard's first hold_q queries,
    # the triangles with pad rows at _FAR added: equal to the plain version
    # and to the kernel without pad rows.
    qh = torch.from_numpy(q[:hold_q]).to(dev)
    far = torch.full((100, 3), sharding._FAR, device=dev)
    pa, pb, pc = (torch.cat([t, far]) for t in (ra, rb, rc))
    for key, k_fn, p_fn in (
            ("raycast",
             lambda *t: sdf_k.raycast_raw(qh, *t, raycast_axes=3),
             lambda *t: sdf_k.raycast_raw_plain(qh, *t, raycast_axes=3)),
            ("normal", lambda *t: sdf_k.normal_raw(qh, *t),
             lambda *t: sdf_k.normal_raw_plain(qh, *t))):
        got = k_fn(pa, pb, pc)
        without = k_fn(ra, rb, rc)
        want, p_ms = plain_once(lambda: p_fn(pa, pb, pc))
        same = all(torch.equal(g.view(torch.int32), w.view(torch.int32))
                   and torch.equal(g.view(torch.int32), x.view(torch.int32))
                   for g, w, x in zip(got, want, without))
        log(f"  {key} kernel, {hold_q} queries x {len(faces)} triangles + "
            f"100 pad rows: bit-equal to plain and to no pad rows {same}; "
            f"plain {p_ms:.1f} ms")
        if not same:
            raise AssertionError(f"{key}: pad rows change the result")

    (cargs, ckw) = recorded["culled_blocks"]
    group = ckw["group"]
    n_g = min(max(1, 65_536 // group), cargs[2].shape[0])
    sub_a = (cargs[0][:n_g * group], cargs[1], cargs[2][:n_g])
    anchors = ckw.get("anchors")
    sub_k = dict(ckw, anchors=None if anchors is None
                 else anchors[:n_g * group])
    got = culled.culled_blocks(*sub_a, **sub_k)
    want, c_p = plain_once(lambda: culled.culled_blocks_plain(*sub_a,
                                                              **sub_k))
    if not all(g is None or torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError("culled kernel disagrees at the sharded shape")
    c_k = cuda_ms(lambda: culled.culled_blocks(*cargs, **ckw), 3)
    tbl = cargs[2]
    pairs = int((tbl != ckw["n_blocks"]).sum()) * cargs[1].shape[2] * group
    shapes["culled"] = (c_k, c_p, bound(
        pairs * (FLOPS["ladder"] + FLOPS["segment"]),
        sum(t.numel() * t.element_size() for t in cargs[:3])
        + 28 * cargs[0].shape[0]),
        f"union, group {group}, {tbl.shape[1]} slots, "
        f"{cargs[0].shape[0]} queries (plain on {n_g * group})")
    log(f"  culled kernel ({shapes['culled'][3]}): equal to plain; kernel "
        f"{c_k:.3f} ms, plain {c_p:.1f} ms, bound "
        f"{shapes['culled'][2][0]:.3f} ms ({shapes['culled'][2][1]})")
    dist.destroy_process_group()
    return {"launches": launches, "shapes": shapes, "world1": world1}


def _material_glb(path, verts, faces, rgba):
    """A GLB of one mesh with a base-colour material and no texture."""
    import struct

    v = np.ascontiguousarray(verts, np.float32)
    idx = np.ascontiguousarray(np.asarray(faces).reshape(-1), np.uint32)
    blob = v.tobytes() + idx.tobytes()
    blob += b"\0" * (-len(blob) % 4)
    doc = {
        "asset": {"version": "2.0"},
        "buffers": [{"byteLength": len(blob)}],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": v.nbytes},
            {"buffer": 0, "byteOffset": v.nbytes, "byteLength": idx.nbytes}],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": len(v),
             "type": "VEC3", "min": v.min(0).tolist(),
             "max": v.max(0).tolist()},
            {"bufferView": 1, "componentType": 5125, "count": len(idx),
             "type": "SCALAR"}],
        "materials": [{"pbrMetallicRoughness": {
            "baseColorFactor": list(rgba)}}],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0},
                                    "indices": 1, "material": 0}]}],
        "nodes": [{"mesh": 0}], "scenes": [{"nodes": [0]}], "scene": 0,
    }
    js = json.dumps(doc).encode()
    js += b" " * (-len(js) % 4)
    total = 12 + 8 + len(js) + 8 + len(blob)
    Path(path).write_bytes(
        struct.pack("<4sII", b"glTF", 2, total)
        + struct.pack("<I4s", len(js), b"JSON") + js
        + struct.pack("<I4s", len(blob), b"BIN\0") + blob)


def _sphere_mask(cam, dev):
    """(H, W) bool: the camera rays that hit the unit sphere."""
    o, d = cam.rays(dev)
    b = (o * d).sum(-1)
    c = (o * o).sum(-1) - 1.0
    disc = b * b - c
    return ((disc > 0) & (-b - disc.clamp_min(0).sqrt() > 0)).cpu().numpy()


def _png(path):
    from mesh_to_sdf_tpu_torch.io import png

    return png.decode(Path(path).read_bytes())


def _hold_to_sphere(img, mask, what, hit=None):
    """The image's hit mask (non-black pixels, or ``hit``) against the
    analytic sphere's: at most 1 % of the pixels differ."""
    if hit is None:
        hit = img.sum(-1) > 0
    off = float((hit != mask).mean())
    log(f"  {what}: {img.shape}, {int(hit.sum())} hit pixels, differs from "
        f"the analytic sphere on {100 * off:.3f} % of the pixels (limit 1 %)")
    if img.shape[2] != 3 or off > 0.01:
        raise AssertionError(f"{what}: image disagrees with the sphere")


def _hold_card_cpu(card_img, cpu_img, what):
    """Card against CPU: hit masks differ on at most 0.5 % of the pixels,
    and pixels both hit are within 2/255."""
    hc, hp = card_img.sum(-1) > 0, cpu_img.sum(-1) > 0
    off = float((hc != hp).mean())
    diff = np.abs(card_img.astype(int) - cpu_img.astype(int))[hc & hp]
    worst = int(diff.max(initial=0))
    log(f"  {what}: card vs CPU hit masks differ on {100 * off:.3f} % of "
        f"the pixels (limit 0.5 %), max |diff| on pixels both hit {worst}"
        f"/255 (limit 2)")
    if off > 0.005 or worst > 2:
        raise AssertionError(f"{what}: card and CPU images disagree")


#: Queries of a recorded raycast or normal call that are held against the
#: plain version (the kernel is timed on all of them).
HOLD_QUERIES = 65_536


def _recorders():
    """(module, name, shape key) of the kernel wrappers path 8 records. A
    key is (row key, shape...) and a size; a counted command's first call
    of each key is kept, or for raycast and normal the call with the most
    queries. The sweep's key is None above 128³ cells (path 1 holds the
    256³ sweeps on the same mesh) and for the x and reverse sweeps (one +y
    and one +z sweep per grid); the binned parity's is None above 128³
    cells (path 1 holds 256³)."""
    from mesh_to_sdf_tpu_torch.ops.kernels import parity, sweep
    from mesh_to_sdf_tpu_torch.ops.kernels import sdf as sdf_k

    def sweep_key(d1, i1, d2, i2, tris, rev, fc, cs, *, axis):
        if axis == 0 or rev or d1.numel() > 128 ** 3:
            return None, 0
        return ("sweep", tuple(d1.shape), axis), 0

    def binned_key(oy, oz, ox, cs, bins, *, n_cells, n1, n2):
        if n1 * n2 * n_cells > 128 ** 3:
            return None, 0
        return ("parity", n1, n2, n_cells), 0

    def dense_key(oy, oz, ox, cs, tri_rot, *, n_cells):
        return ("dense", oy.numel(), tri_rot[0].shape[0], n_cells), 0

    def raycast_key(q, ta, tb, tc, *, raycast_axes):
        return ("raycast", ta.shape[0], raycast_axes), q.shape[0]

    def normal_key(q, ta, tb, tc):
        return ("normal", ta.shape[0]), q.shape[0]

    return ((sweep, "sweep_axis", sweep_key),
            (parity, "line_parity_counts_binned", binned_key),
            (parity, "line_parity_counts", dense_key),
            (sdf_k, "raycast_raw", raycast_key),
            (sdf_k, "normal_raw", normal_key))


def _record_calls(recording, recorded, held=frozenset()):
    """Wrap each kernel wrapper of :func:`_recorders` so that, while
    ``recording[0]``, its calls go into ``recorded`` by shape key: the key's
    first call, or for raycast and normal its call with the most queries
    (the tensor arguments cloned). Calls whose key is in ``held`` are not
    recorded. Returns the originals (module, name, function) to put back."""
    import torch

    patched = []
    for module, name, key_of in _recorders():
        fn = getattr(module, name)
        patched.append((module, name, fn))

        def wrapper(*a, _fn=fn, _key_of=key_of, **k):
            if recording[0]:
                key, size_ = _key_of(*a, **k)
                if key is not None and key not in held and (
                        key not in recorded or size_ > recorded[key][2]):
                    recorded[key] = ([t.clone() if isinstance(t, torch.Tensor)
                                      else t for t in a], k, size_)
            return _fn(*a, **k)

        setattr(module, name, wrapper)
    return patched


def _hold_recorded(recorded):
    """Each call that path 8 or 9 recorded (:func:`_recorders`) against its
    plain version on the same inputs: the sweep bit-equal, both parity
    kernels equal, raycast d² within RTOL/ATOL with its counts equal and
    normal's champions bit-equal on the first HOLD_QUERIES queries. Times
    the kernel on all the inputs. Returns ({row key: [(ms, plain ms, bound,
    shape)]}, {row key: max abs error})."""
    import torch

    from mesh_to_sdf_tpu_torch.ops.kernels import parity, sweep
    from mesh_to_sdf_tpu_torch.ops.kernels import sdf as sdf_k

    shapes, errs = {}, {}
    for (key, *_), (a, k, _) in recorded.items():
        err = 0.0
        if key == "sweep":
            state, rest = a[:4], a[4:]
            src = [t.clone() for t in state]
            want, p_ms = plain_once(lambda: sweep.sweep_axis_plain(
                *src, *rest, **k))
            work = [t.clone() for t in state]
            sweep.sweep_axis(*work, *rest, **k)
            torch.cuda.synchronize()
            if not all(torch.equal(g.view(torch.int32), w.view(torch.int32))
                       for g, w in zip(work, want)):
                raise AssertionError(f"sweep disagrees at the recorded "
                                     f"{tuple(state[0].shape)}")
            copy_ms = cuda_ms(
                lambda: [d.copy_(t) for d, t in zip(work, state)], 5)

            def one():
                for d, t in zip(work, state):
                    d.copy_(t)
                sweep.sweep_axis(*work, *rest, **k)

            ms = cuda_ms(one, 5) - copy_ms
            n = state[0].numel()
            bnd = bound(roofline.sweep_flops(n),
                        roofline.sweep_bytes(n, rest[0].rec.shape[0]))
            shape = f"+{'xyz'[k['axis']]}, {tuple(state[0].shape)}"
        elif key in ("parity", "dense"):
            kernel, plain = ((parity.line_parity_counts_binned,
                              parity.line_parity_counts_binned_plain)
                             if key == "parity" else
                             (parity.line_parity_counts,
                              parity.line_parity_counts_plain))
            got, _ = kernel(*a, **k)
            (want, _), p_ms = plain_once(lambda: plain(*a, **k))
            if not torch.equal(got, want):
                raise AssertionError(f"{key} parity disagrees at a "
                                     f"recorded shape")
            ms = graph_ms(lambda: kernel(*a, **k), 5)
            L, n_cells = a[0].numel(), k["n_cells"]
            if key == "parity":
                lb = a[4]
                pairs = (int((lb.tbl != lb.n_blocks).sum()) * lb.tb
                         * lb.tile ** 2)
                nbytes = sum(t.numel() * t.element_size()
                             for t in (a[0], a[1], lb.rows, lb.tbl))
                shape = f"{k['n1']}x{k['n2']} lines x {n_cells} cells"
            else:
                T = a[4][0].shape[0]
                pairs, nbytes = L * T, 8 * L + 36 * T
                shape = f"{L} lines x {T} triangles x {n_cells} cells"
            bnd = bound(parity_flops(pairs, want),
                        nbytes + 4 * L * n_cells)
        else:
            q, tris = a[0], a[1:]
            sub = q[:HOLD_QUERIES]
            Q, T = q.shape[0], tris[0].shape[0]
            if key == "raycast":
                d_k, c_k = sdf_k.raycast_raw(sub, *tris, **k)
                (d_p, c_p), p_ms = plain_once(
                    lambda: sdf_k.raycast_raw_plain(sub, *tris, **k))
                if not torch.equal(c_k, c_p):
                    raise AssertionError("raycast counts differ at a "
                                         "recorded shape")
                torch.testing.assert_close(d_k, d_p, rtol=RTOL, atol=ATOL)
                err = float((d_k - d_p).abs().max())
                axes = k["raycast_axes"]
                d_all, c_all = sdf_k.raycast_raw(q, *tris, **k)
                ms = cuda_ms(lambda: sdf_k.raycast_raw(q, *tris, **k), 3)
                bnd = bound(raycast_flops(Q, T, axes, c_all),
                            12 * Q + 36 * T
                            + 4 * (d_all.numel() + c_all.numel()))
                shape = f"axes {axes}, "
            else:
                got = sdf_k.normal_raw(sub, *tris)
                want, p_ms = plain_once(
                    lambda: sdf_k.normal_raw_plain(sub, *tris))
                if not all(torch.equal(g.view(torch.int32),
                                       w.view(torch.int32))
                           for g, w in zip(got, want)):
                    raise AssertionError("normal kernel disagrees at a "
                                         "recorded shape")
                ms = cuda_ms(lambda: sdf_k.normal_raw(q, *tris), 3)
                bnd = bound(Q * T * (FLOPS["ladder"] + FLOPS["normal"]),
                            12 * Q + 36 * T + 8 * Q)
                shape = ""
            shape += (f"{Q} queries x {T} triangles (plain on "
                      f"{sub.shape[0]})")
        shapes.setdefault(key, []).append((ms, p_ms, bnd, shape))
        errs[key] = max(errs.get(key, 0.0), err)
        log(f"  {key} at {shape}: equal to plain (max abs {err:.3e}); "
            f"kernel {ms:.4f} ms, plain {p_ms:.1f} ms, bound {bnd[0]:.4f} ms "
            f"({bnd[1]})")
    return shapes, errs


def surface_phase(dev, *, cells=256, size=512, level=5, small_cells=64,
                  exact_cells=32, small_size=128, small_level=3,
                  n_queries=1_000_000, card=""):
    """Path 8: the user surface, the CLI's generate → info → render → bench
    path, through ``cli.main`` in this process and once through ``python -m
    mesh_to_sdf_tpu_torch``.

    On ``icosphere(level)`` written to a GLB by ``io.gltf.save_glb``:
    ``generate`` at ``cells``³ (bit-equal to ``generate_grid_sdf`` in this
    process; the sweep and binned parity kernels 6 and 3 times), also
    ``--format reference`` at ``small_cells``³ and ``--exact`` at
    ``exact_cells``³; ``info``;
    ``render`` at ``size``² in every mode, ``--view voxels``, and on the GLB
    ``--view model`` and ``--view model+sdf`` with shadows and
    ``--material`` on a GLB with a base-colour material, each image against
    the analytic sphere and, at ``small_cells``³ / ``small_size``², against
    the same call on the CPU (the mesh views in process, on
    ``icosphere(small_level)``: the CPU's O(pixels x triangles) passes);
    ``bench`` grid and query, both signs; ``calibrate_auto(force=True)`` in
    a temporary cache.

    The launches are the path's own: the rises across its commands (the
    CLI in this process and ``calibrate_auto``), never across the reference
    calls they are held to, and no command calls a plain version. Each
    kernel's calls there are recorded by shape (:func:`_recorders`) and
    held against the plain version afterwards (:func:`_hold_recorded`).
    Returns the launches per kernel row, those holds and the times.
    """
    import contextlib
    import io
    import tempfile

    import torch

    import mesh_to_sdf_tpu_torch as tm
    from mesh_to_sdf_tpu_torch import cli, gridgen
    from mesh_to_sdf_tpu_torch import render as tr
    from mesh_to_sdf_tpu_torch.io import gltf, serde
    from mesh_to_sdf_tpu_torch.utils.meshgen import icosphere

    log(f"== path 8: the CLI on icosphere({level}) at {cells}^3, "
        f"{size}x{size} images ({card})")
    # (kernel launches, plain calls) of the path's commands, and their
    # kernel calls by shape.
    counted = {k: [0, 0] for k in _counters()}
    recording, recorded = [False], {}

    def counting(fn):
        """``fn()`` with its launches and plain calls added to ``counted``
        and its kernel calls recorded."""
        before = _read_counts()
        recording[0] = True
        try:
            return fn()
        finally:
            recording[0] = False
            after = _read_counts()
            for k, c in counted.items():
                c[0] += _launched(after[k]) - _launched(before[k])
                c[1] += _plain(after[k]) - _plain(before[k])

    patched = _record_calls(recording, recorded)
    verts, faces = icosphere(level)
    topo = tm.Topology.triangle_list(faces.reshape(-1))
    wall = {}
    t_phase = time.perf_counter()
    # The CLI's own default is CUDA; a rehearsal on the CPU names its device.
    on = [] if dev.type == "cuda" else ["--device", str(dev)]

    def run(name, args, capture=False, device=on, count=True):
        """``cli.main(args)`` timed to the end of its device work; its
        standard output when ``capture``. ``count``: a command of the path
        (``counting``), not one run to compare with."""
        out = io.StringIO()
        _sync(dev)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out) if capture else (
                contextlib.nullcontext()):
            argv = [str(a) for a in args + device]
            rc = (counting(lambda: cli.main(argv)) if count
                  else cli.main(argv))
        _sync(dev)
        wall[name] = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"cli {name} exited {rc}")
        return out.getvalue()

    with tempfile.TemporaryDirectory(prefix="m2s_cli_") as tmp:
        tmp = Path(tmp)
        glb = tmp / f"ico{level}.glb"
        gltf.save_glb(glb, verts, faces)
        mat_glb = tmp / "material.glb"
        _material_glb(mat_glb, verts, faces, (0.9, 0.3, 0.1, 1.0))
        sv, sf = icosphere(small_level)
        sv_grid = cli._build_grid(sv.min(axis=0), sv.max(axis=0),
                                  small_cells, 1.1)
        sv_dist = tm.generate_grid_sdf(
            sv, tm.Topology.triangle_list(sf.reshape(-1)), sv_grid,
            flat=False, device=dev).cpu()
        sv_cam = tr.Camera.orbit(sv_grid, width=small_size,
                                 height=small_size)

        def small_view(name, device):
            """A mesh view of icosphere(small_level) on ``device``."""
            if name == "model":
                return tr.render_model(sv, sf, sv_cam, device=device)
            if name == "model+sdf":
                return tr.render_model_and_sdf(sv, sf, sv_dist, sv_grid,
                                               sv_cam, device=device)
            cube = tr.generate_cubemap(
                sv, sf, np.tile([0.9, 0.3, 0.1], (len(sv), 1)),
                device=device)
            return tr.render(sv_dist.to(device), sv_grid, sv_cam,
                             material=cube)

        # ---------------------------------------------------- generate
        g_path = tmp / "g.sdf"
        before = {k: c[0] for k, c in counted.items()}
        run("generate", ["generate", glb, "--cells", cells, "-o", g_path])
        rise = {k: counted[k][0] - before[k] for k in ("sweep", "parity")}
        sdf = serde.read_from_file(g_path)
        grid = cli._build_grid(verts.min(axis=0), verts.max(axis=0), cells,
                               1.1)
        want = tm.generate_grid_sdf(verts, topo, grid,
                                    device=dev).cpu().numpy()
        same = np.array_equal(sdf.distances.view(np.int32),
                              want.view(np.int32))
        inside = float((sdf.distances < 0).mean())
        log(f"  generate {cells}^3: {wall['generate']:.3f} s; file bit-equal "
            f"to generate_grid_sdf in process {same}; inside fraction "
            f"{inside:.4f} (limit (0.37, 0.42)); kernel launches sweep "
            f"+{rise['sweep']}, binned parity +{rise['parity']}")
        rounds = 2 if cells <= 128 else 1  # gridgen's sweep rounds
        if not same or not 0.37 < inside < 0.42 or rise != {
                "sweep": 6 * rounds, "parity": 3}:
            raise AssertionError("cli generate: wrong file or launches")
        small_path = tmp / "small.sdf"
        run("generate small", ["generate", glb, "--cells", small_cells,
                               "--format", "reference", "-o", small_path])
        small = serde.read_from_file(small_path)
        s_grid = cli._build_grid(verts.min(axis=0), verts.max(axis=0),
                                 small_cells, 1.1)
        want_s = tm.generate_grid_sdf(verts, topo, s_grid,
                                      device=dev).cpu().numpy()
        exact_path = tmp / "exact.sdf"
        run("generate exact", ["generate", glb, "--cells", exact_cells,
                               "--exact", "-o", exact_path])
        exact = serde.read_from_file(exact_path).distances
        dense = tm.generate_grid_sdf(
            verts, topo, cli._build_grid(verts.min(axis=0), verts.max(axis=0),
                                         exact_cells, 1.1),
            strategy=tm.Strategy.PALLAS, device=dev).cpu().numpy()
        n_sign = int((np.signbit(exact) != np.signbit(dense)).sum())
        log(f"  generate {small_cells}^3 --format reference: "
            f"{wall['generate small']:.3f} s, read back equal "
            f"{np.array_equal(small.distances, want_s)}; --exact at "
            f"{exact_cells}^3: "
            f"{wall['generate exact']:.3f} s, max |exact - PALLAS| "
            f"{float(np.abs(np.abs(exact) - np.abs(dense)).max()):.3e}, "
            f"sign disagreements {n_sign}")
        if (not np.array_equal(small.distances, want_s) or n_sign
                or not np.allclose(np.abs(exact), np.abs(dense), rtol=RTOL,
                                   atol=ATOL)):
            raise AssertionError("cli generate --format/--exact disagrees")

        # -------------------------------------------------------- info
        info = json.loads(run("info", ["info", g_path], capture=True,
                              device=[]).strip().splitlines()[-1])
        d = sdf.distances
        want_info = {"kind": "grid", "cell_count": [cells] * 3,
                     "first_cell": grid.first_cell.tolist(),
                     "cell_size": grid.cell_size.tolist(),
                     "iso_limits": [float(d.min()), float(d.max())],
                     "inside_fraction": float((d < 0).mean())}
        log(f"  info: {json.dumps(info)}; equal to the file's "
            f"{info == want_info}")
        if info != want_info:
            raise AssertionError("cli info disagrees with the file")

        # ------------------------------------------------------ render
        cam = tr.Camera.orbit(grid, width=size, height=size)
        mask = _sphere_mask(cam, dev)
        renders = [(m, ["--mode", m], g_path) for m in
                   ("snap", "trilinear", "tetrahedral", "snap_stylized")]
        renders += [("voxels", ["--view", "voxels"], g_path),
                    ("model", ["--view", "model"], glb),
                    ("model+sdf", ["--view", "model+sdf"], glb),
                    ("material", ["--material"], mat_glb)]
        dist_dev = torch.from_numpy(d).to(dev).reshape(grid.cell_count)
        for name, flags, src in renders:
            out = tmp / f"{name}.png"
            extra = ["--cells", cells] if src != g_path else []
            run(f"render {name}", ["render", src, "-o", out, "--width", size,
                                   "--height", size, *extra, *flags])
            img = _png(out)
            hit = None
            if name == "snap_stylized":  # shaded black where normals vanish
                hit = tr.trace(dist_dev, grid, *cam.rays(dev),
                               mode=tr.RaymarchMode.SNAP_STYLIZED)[2]
                hit = hit.cpu().numpy()
            _hold_to_sphere(img, mask, f"render {name} "
                            f"({wall[f'render {name}']:.3f} s)", hit)
            if name == "material":
                lit = img[img.sum(-1) > 0].astype(int)
                if not (lit[:, 0] >= lit[:, 2]).all():
                    raise AssertionError("material render lost its colour")
            # The same call on the card and on the CPU, small: the CLI on
            # the small file; the mesh views in process on
            # icosphere(small_level) and its grid (the CLI would regenerate
            # the grid on the CPU, ~10 s a view).
            t0 = time.perf_counter()
            if src == g_path:
                args = ["render", small_path, *flags, "--width", small_size,
                        "--height", small_size]
                run(f"small {name}", args + ["-o", tmp / "c.png"],
                    count=False)
                run(f"cpu {name}", args + ["-o", tmp / "p.png"],
                    device=["--device", "cpu"], count=False)
                card_img, cpu_img = _png(tmp / "c.png"), _png(tmp / "p.png")
            else:
                card_img, cpu_img = (tr.to_uint8(small_view(name, d))
                                     for d in (dev, torch.device("cpu")))
            _hold_card_cpu(card_img, cpu_img,
                           f"{name} at {small_cells}^3 / {small_size}^2 "
                           f"({time.perf_counter() - t0:.1f} s)")
        # __main__: one command as its own process, its PNG equal to the
        # in-process one.
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "mesh_to_sdf_tpu_torch", "render", g_path,
             "-o", tmp / "sub.png", "--mode", "trilinear", "--width",
             str(size), "--height", str(size), *on], cwd=ROOT,
            env=dict(os.environ, PYTHONPATH=str(ROOT)), capture_output=True,
            text=True, timeout=600)
        wall["python -m render"] = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"python -m mesh_to_sdf_tpu_torch: "
                                 f"{proc.stderr[-2000:]}")
        same_png = np.array_equal(_png(tmp / "sub.png"),
                                  _png(tmp / "trilinear.png"))
        log(f"  python -m mesh_to_sdf_tpu_torch render: "
            f"{wall['python -m render']:.2f} s, image equal to the "
            f"in-process one {same_png}")
        if not same_png:
            raise AssertionError("python -m render differs from cli.main")

        # ------------------------------------------------------- bench
        bench = []
        for mode, extra in (("grid", ["--cells", cells]),
                            ("query", ["--queries", n_queries])):
            for sign in ("raycast", "normal"):
                line = run(f"bench {mode} {sign}",
                           ["bench", "--mode", mode, "--sign", sign, *extra],
                           capture=True).strip().splitlines()[-1]
                bench.append(json.loads(line))
                log(f"  bench: {line} ({card})")

        # ------------------------------------------- calibrate_auto
        saved = {k: os.environ.get(k) for k in ("XDG_CACHE_HOME",
                                                "M2S_AUTO_CALIBRATE")}
        try:
            os.environ["XDG_CACHE_HOME"] = str(tmp / "cache")
            os.environ.pop("M2S_AUTO_CALIBRATE", None)
            gridgen._AUTO_CAL_CACHE.clear()
            n_tris = len(faces)
            routes = {}
            for n in (128, 256):
                routes[("default", n)] = gridgen._auto_route(n_tris, n ** 3,
                                                             dev).value
            t0 = time.perf_counter()
            cal = counting(lambda: gridgen.calibrate_auto(force=True,
                                                          device=dev))
            wall["calibrate_auto"] = time.perf_counter() - t0
            gridgen._AUTO_CAL_CACHE.clear()
            os.environ["M2S_AUTO_CALIBRATE"] = "1"
            for n in (128, 256):
                routes[("calibrated", n)] = counting(
                    lambda: gridgen._auto_route(n_tris, n ** 3, dev).value)
            log(f"  calibrate_auto {wall['calibrate_auto']:.2f} s: "
                f"(dense pairs/s, CPT overhead s, CPT cells/s) = "
                f"{tuple(f'{x:.4e}' for x in cal)}, defaults "
                f"{gridgen._AUTO_DEFAULTS['cuda']} ({card})")
            log(f"  AUTO routes on icosphere({level}) at 128^3 / 256^3: "
                f"defaults {routes[('default', 128)]} / "
                f"{routes[('default', 256)]}, M2S_AUTO_CALIBRATE=1 "
                f"{routes[('calibrated', 128)]} / "
                f"{routes[('calibrated', 256)]}")
            if not all(x > 0 for x in (cal[0], cal[2])) or cal[1] < 0:
                raise AssertionError(f"calibration out of range: {cal}")
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
            gridgen._AUTO_CAL_CACHE.clear()
        for module, name, fn in patched:
            setattr(module, name, fn)
        launches = {k: tuple(c) for k, c in counted.items()}
        log(f"  launches on path 8's commands (kernel, plain): {launches}")
        if any(_plain(c) for c in launches.values()):
            raise AssertionError("a command of path 8 called a plain "
                                 "version on the card")

        # ------------------------ kernels vs plain at path 8's shapes
        log("== path 8: kernels vs plain at the path's shapes")
        shapes, errs = _hold_recorded(recorded)
        del recorded
        for key in ("sweep", "parity", "dense", "raycast", "normal"):
            if key not in shapes:
                raise AssertionError(f"path 8 recorded no {key} call")

        # ------------------------------------------------ warm times
        def warm(fn):
            fn()
            _sync(dev)
            t0 = time.perf_counter()
            out = fn()
            _sync(dev)
            return time.perf_counter() - t0, out

        warm_s = {}
        warm_s["render trilinear, shadows"], img = warm(
            lambda: tr.render(dist_dev, grid, cam))
        warm_s["render_voxels, shadows"], vox = warm(
            lambda: tr.render_voxels(dist_dev, grid, cam))
        warm_s["render_model, shadows"], mod = warm(
            lambda: tr.render_model(verts, faces, cam, device=dev))
        warm_s["generate_cubemap res 256"], cm = warm(
            lambda: tr.generate_cubemap(verts, faces,
                                        np.ones_like(verts), device=dev))
        for name, x in (("render", img), ("voxels", vox), ("model", mod),
                        ("cubemap", cm.albedo)):
            if not bool(torch.isfinite(x).all()):
                raise AssertionError(f"{name}: non-finite values")
    log(f"  warm in-process times at {cells}^3 / {size}^2 / "
        f"{len(faces)} triangles ({card}): "
        + ", ".join(f"{k} {v:.4f} s" for k, v in warm_s.items()))
    log(f"  command wall times ({card}): "
        + ", ".join(f"{k} {v:.3f} s" for k, v in wall.items()))
    total = time.perf_counter() - t_phase
    log(f"  path 8: {total:.1f} s; launches on its commands "
        f"{ {k: _launched(v) for k, v in launches.items()} }")
    return {"launches": {k: _launched(v) for k, v in launches.items()},
            "shapes": shapes, "errs": errs, "wall": wall, "warm": warm_s,
            "bench": bench, "total": total}


#: Shape keys (:func:`_recorders`) of path 9's kernel calls that earlier
#: paths hold against the plain versions: the raycast kernel at path 2's 1M
#: x 20 480 and on path 4's 1 310 720 triangles (the CULLED fix-up and host
#: fallback), the dense parity at path 4's sign grid. The sweep and binned
#: parity keys already leave out 256³ and the 512³ slabs (paths 1 and 6).
HELD_SHAPES = {("raycast", 20_480, 3), ("raycast", 1_310_720, 3),
               ("dense", 128 * 128, 1_310_720, 128)}
#: Kernel rows that path 9 must launch.
BENCH_KERNELS = ("sweep", "parity", "dense", "raycast", "records", "culled")


def _walk(value, path=""):
    """(path, value) of every leaf of nested dicts."""
    if isinstance(value, dict):
        for k, v in value.items():
            yield from _walk(v, f"{path}/{k}")
    else:
        yield path, value


def bench_phase(dev, *, card=""):
    """Path 9: ``bench_torch.py``, bench.py's workloads at bench.py's sizes,
    through ``bench_torch.main`` in this process, from cold content caches
    (the CPT and streamed prep, CULLED's per-mesh structures and route
    choices), as a fresh process starts.

    Fails on a line whose keys or extra names are not bench.py's, on a
    failed workload (an ``"error: ..."`` string, ``"binary unavailable"``),
    without ``vs_1core_grid_measured``, on a roofline share above 100 %, on
    any plain call, and where one of the sweep, binned parity, dense
    parity, raycast, record packing and culled kernels never launched. The
    kernel calls at shapes no earlier path holds (not ``HELD_SHAPES``) are
    held against the plain versions (:func:`_hold_recorded`). Returns the
    launches per kernel row, those holds, the line and the phase's time.
    """
    import contextlib
    import io

    import bench_torch
    from mesh_to_sdf_tpu_torch import gridgen, gridgen_streamed, query
    from mesh_to_sdf_tpu_torch.ops import culling

    log(f"== path 9: bench_torch.py, bench.py's workloads ({card})")
    t_phase = time.perf_counter()
    for cache in (gridgen._CPT_PREP_CACHE,
                  gridgen_streamed._STREAM_PREP_CACHE,
                  query._SIGN_GRID_CACHE, query._PARITY_BINS_CACHE,
                  query._BLOCK_INDEX_CACHE, culling._ROUTE_CACHE,
                  culling.LAST_CULLED_STATS):
        cache.clear()
    recorded = {}
    patched = _record_calls([True], recorded, held=HELD_SHAPES)
    out = io.StringIO()
    # The bench's own default is CUDA; a rehearsal on the CPU names its
    # device.
    argv = [] if dev.type == "cuda" else ["--device", str(dev)]
    _sync(dev)
    before = _read_counts()
    try:
        with contextlib.redirect_stdout(out):
            result = bench_torch.main(argv)
    finally:
        for module, name, fn in patched:
            setattr(module, name, fn)
    _sync(dev)
    after = _read_counts()
    launches = {k: _launched(after[k]) - _launched(before[k]) for k in after}
    plain = {k: _plain(after[k]) - _plain(before[k]) for k in after}
    lines = out.getvalue().strip().splitlines()
    for line in lines:
        log(f"  bench_torch: {line}")
    log(f"  launches on path 9 (kernel): {launches}; plain calls {plain}")

    extra = result["extra"]
    want = bench_torch.BENCH_EXTRA | {"card"} | (
        bench_torch.BENCH_ASSET_EXTRA if os.path.isdir(bench_torch.ASSETS)
        else set())
    # A workload's entry is a dict; inside one, only failures are these
    # strings.
    failed = [f"{p}: {v}" for p, v in _walk(extra)
              if isinstance(v, str) and p != "/card" and (
                  p.count("/") == 1
                  or v.startswith(("error:", "not measured")))]
    over = [f"{p}: {v}" for p, v in _walk(extra)
            if p.endswith(("/pct_fp32_peak", "/pct_hbm_peak")) and v > 100]
    log(f"  bench_torch.main: {time.perf_counter() - t_phase:.1f} s")
    if len(lines) != 1 or json.loads(lines[0]) != result:
        raise AssertionError("bench_torch printed other than one line")
    if set(result) != bench_torch.BENCH_KEYS or set(extra) != want:
        raise AssertionError(f"bench_torch's keys differ from bench.py's: "
                             f"{sorted(result)}, {sorted(extra)}")
    metric = f"grid_cells_per_s_{bench_torch.CELLS}^3_raycast"
    if result["metric"] != metric or not 0 < result["value"] < float("inf"):
        raise AssertionError(f"bad headline {result['metric']} "
                             f"{result['value']}")
    if failed or "vs_1core_grid_measured" not in extra:
        raise AssertionError(f"bench_torch workloads failed: {failed}")
    if over:
        raise AssertionError(f"roofline shares above 100 %: {over}")
    if any(plain.values()):
        raise AssertionError("path 9 called a plain version on the card")
    for key in BENCH_KERNELS:
        if not launches[key]:
            raise AssertionError(f"path 9 never launched the {key} kernel")

    log(f"== path 9: kernels vs plain at shapes no earlier path holds: "
        f"{sorted(recorded) or 'none'}")
    shapes, errs = _hold_recorded(recorded) if recorded else ({}, {})
    total = time.perf_counter() - t_phase
    log(f"  path 9: {total:.1f} s with the holds")
    return {"launches": launches, "shapes": shapes, "errs": errs,
            "line": result, "total": total}


def tracing_phase(*, card=""):
    """Path 10: the host-sync markers against the card's own count.
    Runs ``tests/test_torch_tracing_cuda.py`` (in its own process, without
    tests/conftest.py, which imports JAX): for one warm call of the 256³
    CPT grid and of the gather-engine CULLED query (vertices on the card
    and on the host), the ``sync.*`` spans must be as many as the waits
    ``torch.cuda.set_sync_debug_mode("warn")`` reports, and the same in
    every call. Fails when they differ, so a wait that loses its marker, or
    a marker that loses its wait, stops the run. Returns the phase's time.
    """
    log(f"== path 10: host-sync markers against sync debug mode ({card})")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-p",
         "no:cacheprovider", "-q", "-m", "cuda",
         "tests/test_torch_tracing_cuda.py"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    tail = (proc.stdout + proc.stderr).strip().splitlines()[-12:]
    for line in tail:
        log(f"  {line}")
    if proc.returncode != 0:
        raise AssertionError(f"sync markers disagree with sync debug mode "
                             f"(pytest exit {proc.returncode})")
    return time.perf_counter() - t0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    global PEAK_FP32
    t_start = time.perf_counter()
    card = card_line()
    log(card)
    PEAK_FP32 = roofline.fp32_peak()
    log(f"FP32 rate for the bounds (SMs x 128 x max SM clock, unfused): "
        f"{PEAK_FP32:.4e} operations/s; HBM {PEAK_BYTES:.3e} B/s")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---------------------------------------------------------------- build
    t0 = time.perf_counter()
    subprocess.run(["make", "-C", str(ROOT / "native")], check=True,
                   capture_output=True, timeout=600)
    log(f"make -C native: {time.perf_counter() - t0:.2f} s")
    sys.path.insert(0, str(ROOT))
    import mesh_to_sdf_tpu_torch as tm
    from mesh_to_sdf_tpu_torch import gridgen, native
    from mesh_to_sdf_tpu_torch.ops import cpt
    from mesh_to_sdf_tpu_torch.ops.geometry import sqrt_f32
    from mesh_to_sdf_tpu_torch.ops.keyed import combine_champions
    from mesh_to_sdf_tpu_torch.ops.kernels import _build, parity, sweep
    from mesh_to_sdf_tpu_torch.ops.kernels import sdf as sdf_k
    from mesh_to_sdf_tpu_torch.ops.kernels import seed as seed_k
    from mesh_to_sdf_tpu_torch.utils.meshgen import icosphere, torus

    t0 = time.perf_counter()
    lib_path = _build.build()
    log(f"kernel build (nvcc sm_90a): {time.perf_counter() - t0:.2f} s "
        f"-> {lib_path.relative_to(ROOT)}")
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"  ptxas: {line.strip()}")
    _build.lib()
    log(f"native seed bins in use: {native.available()}")
    shape = parity.launch_shape()
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    log(f"parity hit pass: {shape['threads']} threads x "
        f"{shape['cta_lines'] // shape['threads']} lines per CTA, blocks of "
        f"{shape['block']} triangles; resident CTAs per SM: binned "
        f"{shape['binned_ctas_per_sm']}, dense {shape['dense_ctas_per_sm']} "
        f"({shape['dense_ctas_per_sm'] * shape['threads'] // 32} warps; the "
        f"launch bounds ask for {shape['min_ctas_per_sm']} CTAs)")
    if min(shape["binned_ctas_per_sm"],
           shape["dense_ctas_per_sm"]) * shape["threads"] // 32 <= 4:
        raise AssertionError("a parity hit pass keeps 4 warps or fewer "
                             "resident per SM")

    dev = torch.device("cuda")
    errs = {"sweep": 0.0, "parity": 0.0, "dense": 0.0, "raycast": 0.0,
            "normal": 0.0, "records": 0.0}

    def prep(verts, faces, lo, hi, shape):
        grid = tm.Grid.from_bounding_box(lo, hi, shape)
        v = verts[faces]
        tris, bins, line_bins = gridgen._cpt_prep(
            grid, v[:, 0], v[:, 1], v[:, 2], dev)
        return grid, tris, bins, line_bins

    def check_state(got, want, what):
        """Distances and ids of the kernel's state bit-equal to the plain
        version's. Returns the max abs distance error (0)."""
        same = all(torch.equal(g.view(torch.int32), w.view(torch.int32))
                   for g, w in zip(got, want))
        err = max(float((got[k] - want[k]).abs().max())
                  for k in range(0, len(got), 2))  # the distances
        log(f"  {what}: distances and ids bit-equal {same}")
        if not same:
            raise AssertionError(f"sweep kernel disagrees: {what}")
        return err

    def hold_sweeps(grid, tris, state, what):
        """The six directional sweeps from ``state`` in the orchestration's
        order, each from the kernel's previous result, kernel against the
        plain version. Returns the max abs error."""
        err = 0.0
        state = [t.clone() for t in state]
        for axis in (0, 1, 2):
            for rev in (False, True):
                args = (tris, rev, grid.first_cell, grid.cell_size)
                want = sweep.sweep_axis_plain(*[t.clone() for t in state],
                                              *args, axis=axis)
                sweep.sweep_axis(*state, *args, axis=axis)
                torch.cuda.synchronize()
                err = max(err, check_state(
                    state, want, f"{what} axis {axis} reverse {rev}"))
        return err

    # ----------------------------------------------- kernels vs plain: sweep
    log("== sweep kernel vs plain")
    for verts, faces, lo, hi, shape in (
        (*icosphere(3), [-1.3] * 3, [1.3] * 3, [48, 40, 36]),
        (*icosphere(3), [-1.3] * 3, [1.3] * 3, [64, 64, 64]),
    ):
        grid, tris, bins, _ = prep(verts, faces, lo, hi, shape)
        seed = cpt.seed_from_bins(grid, tris[0], tris[1], tris[2], bins)
        errs["sweep"] = max(errs["sweep"], hold_sweeps(
            grid, sweep.sweep_tris(*tris), cpt.sweep_state(grid, seed),
            str(tuple(shape))))
        # The whole Gauss-Seidel orchestration: kernel (CUDA tensors) vs the
        # plain version (the same call on CPU tensors).
        rounds = 2 if max(shape) <= 128 else 1
        d_k, i_k = cpt.closest_point_grid(grid, tris[0], tris[1], tris[2],
                                          seed=seed, rounds=rounds)
        d_p, i_p = cpt.closest_point_grid(
            grid, *(t.cpu() for t in tris), seed=[s.cpu() for s in seed],
            rounds=rounds)
        torch.cuda.synchronize()
        errs["sweep"] = max(errs["sweep"], check_state(
            (d_k.cpu(), i_k.cpu()), (d_p, i_p),
            f"closest_point_grid {tuple(shape)} rounds {rounds} vs CPU"))

    # ---------------------------------------------- kernels vs plain: parity
    log("== parity kernel vs plain")
    from mesh_to_sdf_tpu_torch.ops.raycast import face_origins

    def parity_inputs(grid, line_bins, axis):
        origins, lshape = face_origins(grid, axis, dev)
        iy, iz = (axis + 1) % 3, (axis + 2) % 3
        return ((origins[:, iy].contiguous(), origins[:, iz].contiguous(),
                 grid.first_cell[axis], grid.cell_size[axis],
                 line_bins[axis]),
                dict(n_cells=grid.cell_count[axis], n1=lshape[0],
                     n2=lshape[1]))

    for verts, faces, lo, hi, shape in (
        (*icosphere(3), [-1.3] * 3, [1.3] * 3, [64, 64, 64]),
        (*torus(1.0, 0.35, 48, 24), [-1.6] * 3, [1.6] * 3, [40, 72, 33]),
    ):
        grid, _, _, line_bins = prep(verts, faces, lo, hi, shape)
        for axis in range(3):
            args, kw = parity_inputs(grid, line_bins, axis)
            got, ovf = parity.line_parity_counts_binned(*args, **kw)
            want, _ = parity.line_parity_counts_binned_plain(*args, **kw)
            torch.cuda.synchronize()
            err = int((got - want).abs().max())
            log(f"  {tuple(shape)} axis {axis}: counts equal "
                f"{bool(torch.equal(got, want))}, crossings "
                f"{int(got[:, 0].sum())}, overflow {int(ovf.sum())}")
            if err or int(ovf.sum()):
                raise AssertionError(f"parity kernel disagrees: {err}")
            errs["parity"] = max(errs["parity"], float(err))
    torch.cuda.synchronize()

    # ------------------------------------------------ kernels vs plain: sdf
    log("== sdf kernels vs plain (65,536 queries)")
    verts5, faces5 = icosphere(5)
    soup5 = tuple(torch.from_numpy(np.ascontiguousarray(verts5[faces5[:, k]]))
                  .to(dev) for k in range(3))
    q64k = torch.from_numpy(np.random.default_rng(0).uniform(
        -1.3, 1.3, (65536, 3)).astype(np.float32)).to(dev)
    for name, tris in (
        ("icosphere(5), T=20480", soup5),
        ("degenerate soup, T=64", degenerate_soup(dev)),
        ("icosphere(5)[:12345], odd T", tuple(t[:12345].contiguous()
                                             for t in soup5)),
    ):
        for axes in (0, 1, 3):
            d_k, c_k = sdf_k.raycast_raw(q64k, *tris, raycast_axes=axes)
            d_p, c_p = sdf_k.raycast_raw_plain(q64k, *tris, raycast_axes=axes)
            torch.cuda.synchronize()
            torch.testing.assert_close(d_k, d_p, rtol=RTOL, atol=ATOL)
            err = float((d_k - d_p).abs().max())
            if not torch.equal(c_k, c_p):
                raise AssertionError(f"raycast counts differ: {name} {axes}")
            errs["raycast"] = max(errs["raycast"], err)
            log(f"  raycast {name}, axes {axes}: max |kernel - plain| d2 "
                f"{err:.3e}, counts equal, crossings {int(c_k.sum())}")
        got = sdf_k.normal_raw(q64k, *tris)
        want = sdf_k.normal_raw_plain(q64k, *tris)
        torch.cuda.synchronize()
        err = 0.0
        for g, w in zip(got, want):
            if not torch.equal(g.view(torch.int32), w.view(torch.int32)):
                raise AssertionError(f"normal kernel disagrees: {name}")
            err = max(err, float((g - w).abs().max()))
        signs_equal = torch.equal(
            torch.signbit(sdf_k.sdf_normal(q64k, *tris)),
            torch.signbit(combine_champions(*map(sqrt_f32, want))))
        if not signs_equal:
            raise AssertionError(f"normal signs differ: {name}")
        errs["normal"] = max(errs["normal"], err)
        log(f"  normal {name}: pos2, neg2 bit-equal to plain, signs equal")

    # ------------------------------------- kernels vs plain: packed records
    log("== packed triangle records vs plain")

    def hold_records(a, b, c, what, edges=False, normal=False):
        """The packing kernel against the plain packing, bit for bit."""
        got = sdf_k.tri_records(a, b, c, edges=edges, normal=normal)
        want = sdf_k.tri_records_plain(a, b, c, edges=edges, normal=normal)
        torch.cuda.synchronize()
        same = torch.equal(got.view(torch.int32), want.view(torch.int32))
        log(f"  records {what}: {tuple(got.shape)} bit-equal {same}")
        if not same:
            raise AssertionError(f"record packing disagrees: {what}")

    hold_records(*soup5, "icosphere(5), T=20480")
    hold_records(*degenerate_soup(dev), "degenerate soup, T=64")
    hold_records(*soup5, "normal kind, icosphere(5)", normal=True)
    hold_records(*degenerate_soup(dev), "normal kind, degenerate soup",
                 normal=True)

    # ------------------------------------------- kernels vs plain: phase A
    phase_a = phase_a_phase(dev)

    # ---------------------------------------- kernels vs plain: dense parity
    log("== dense parity kernel vs plain and vs the binned kernel")
    for verts, faces, lo, hi, shape in (
        (*icosphere(3), [-1.3] * 3, [1.3] * 3, [64, 64, 64]),
        (*torus(1.0, 0.35, 48, 24), [-1.6] * 3, [1.6] * 3, [40, 72, 33]),
    ):
        grid, _, _, line_bins = prep(verts, faces, lo, hi, shape)
        soup = tuple(torch.from_numpy(np.ascontiguousarray(verts[faces[:, k]]))
                     .to(dev) for k in range(3))
        for axis in range(3):
            args, kw = parity_inputs(grid, line_bins, axis)
            planes = parity.rotate_planes(*soup, axis)
            dargs = (*args[:4], planes)
            dkw = dict(n_cells=kw["n_cells"])
            got, ovf = parity.line_parity_counts(*dargs, **dkw)
            want, _ = parity.line_parity_counts_plain(*dargs, **dkw)
            binned, _ = parity.line_parity_counts_binned(*args, **kw)
            torch.cuda.synchronize()
            err = int((got - want).abs().max())
            log(f"  {tuple(shape)} axis {axis}: dense == plain "
                f"{bool(torch.equal(got, want))}, dense == binned "
                f"{bool(torch.equal(got, binned))}, crossings "
                f"{int(got[:, 0].sum())}, overflow {int(ovf.sum())}")
            if err or int(ovf.sum()) or not torch.equal(got, binned):
                raise AssertionError(f"dense parity kernel disagrees: {err}")
            errs["dense"] = max(errs["dense"], float(err))

    # ------------------------------------------------------------ main path
    log("== main path: generate_grid_sdf, icosphere(5), 256^3, RAYCAST")
    verts, faces = icosphere(5)
    topo = tm.Topology.triangle_list(faces.reshape(-1))
    grid = tm.Grid.from_bounding_box([-1.1] * 3, [1.1] * 3, [256] * 3)
    verts_dev = torch.from_numpy(verts).to(dev)

    def run():
        out = tm.generate_grid_sdf(verts_dev, topo, grid,
                                   tm.SignMethod.RAYCAST)
        torch.cuda.synchronize()
        return out

    gridgen._CPT_PREP_CACHE.clear()
    torch.cuda.synchronize()
    for c in (sweep.COUNT, parity.COUNT, sdf_k.RECORDS_COUNT, seed_k.COUNT):
        c.reset()
    t0 = time.perf_counter()
    sdf = run()
    t_cold = time.perf_counter() - t0
    launches = {"sweep": sweep.COUNT.kernel, "parity": parity.COUNT.kernel,
                "records": sdf_k.RECORDS_COUNT.kernel,
                "seed": seed_k.COUNT.kernel}
    plain_calls = (sweep.COUNT.plain + parity.COUNT.plain
                   + sdf_k.RECORDS_COUNT.plain + seed_k.COUNT.plain)
    log(f"  launches: seed {launches['seed']}, sweep {launches['sweep']} (6 "
        f"directional sweeps of 256 slices each: {launches['sweep'] / 6:g} "
        f"launch per sweep), parity {launches['parity']}, record packing "
        f"{launches['records']} (shared by the seed and the sweeps); "
        f"plain-version calls {plain_calls}")
    if min(launches.values()) == 0 or plain_calls:
        raise AssertionError("main path did not run through the kernels")
    if launches["sweep"] != 6 or launches["seed"] != 1:
        raise AssertionError("the sweep launched other than once per "
                             "directional sweep, or the seed other than "
                             "once a call")

    n = 256 ** 3
    if sdf.device.type != "cuda" or sdf.shape != (n,):
        raise AssertionError(f"output {sdf.device} {tuple(sdf.shape)}")
    if not bool(torch.isfinite(sdf).all()):
        raise AssertionError("non-finite distances")
    inside = float((sdf < 0).float().mean())
    r = grid.all_cell_centers(dev).reshape(-1, 3).norm(dim=-1)
    err = float((sdf - (r - 1.0)).abs().max())
    cs = float(grid.cell_size[0])
    far = (r - 1.0).abs() > 2 * cs
    sign_ok = bool(torch.equal((sdf < 0)[far], (r < 1.0)[far]))
    log(f"  inside fraction {inside:.5f}, max |sdf - (|c| - 1)| {err:.5f}, "
        f"sign matches the sphere beyond 2 cells: {sign_ok}")
    if not (0.37 < inside < 0.42) or err >= 0.05 or not sign_ok:
        raise AssertionError("main path output is wrong")

    # --------------------------------------------------------------- timing
    run()  # warm-up
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    t_warm = statistics.median(times)
    log(f"  cold call (host prep included): {t_cold:.4f} s")
    log(f"  warm calls: {', '.join(f'{t:.4f}' for t in times)} s; median "
        f"{t_warm:.4f} s = {n / t_warm:.4e} cells/s")

    # Stage times inside one warm call, by CUDA events around the stages.
    events = {}
    originals = {}

    def timed(module, name, label):
        fn = getattr(module, name)
        originals[(module, name)] = fn

        def wrapper(*a, **k):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **k)
            end.record()
            events[label] = (start, end)
            return out

        setattr(module, name, wrapper)

    timed(cpt, "seed_from_bins", "seed")
    timed(cpt, "closest_point_grid", "sweeps")
    timed(parity, "grid_inside_mask", "parity")
    # No relayout of the state: every sweep of the call runs in place on
    # the x-first volumes that sweep_state made, and closest_point_grid
    # returns two of them.
    made, swept = [], []
    sweep_state, sweep_axis = cpt.sweep_state, sweep.sweep_axis

    def recording_state(*a, **k):
        out = sweep_state(*a, **k)
        made.append([t.data_ptr() for t in out])
        return out

    def recording_sweep(*a, **k):
        swept.append([t.data_ptr() for t in a[:4]])
        return sweep_axis(*a, **k)

    # The parity stage split into the three wrapper calls (counts zeroed,
    # hit pass, scan) and the vote glue around them (face_origins, % 2,
    # unrotate_axis, the adds).
    binned_spans = []
    binned = parity.line_parity_counts_binned

    def binned_timed(*a, **k):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = binned(*a, **k)
        end.record()
        binned_spans.append((start, end))
        return out

    cpt.sweep_state, sweep.sweep_axis = recording_state, recording_sweep
    parity.line_parity_counts_binned = binned_timed
    try:
        t0 = time.perf_counter()
        out_one = run()
        t_one = time.perf_counter() - t0
    finally:
        cpt.sweep_state, sweep.sweep_axis = sweep_state, sweep_axis
        parity.line_parity_counts_binned = binned
        for (module, name), fn in originals.items():
            setattr(module, name, fn)
    stage = {k: s.elapsed_time(e) for k, (s, e) in events.items()}
    parity_calls = sum(s.elapsed_time(e) for s, e in binned_spans)
    log(f"  one warm call {t_one * 1e3:.2f} ms: seed {stage['seed']:.2f} ms, "
        f"sweeps {stage['sweeps']:.2f} ms (previous design 53.8 ms), parity "
        f"{stage['parity']:.3f} ms")
    log(f"  parity stage {stage['parity']:.3f} ms: {len(binned_spans)} "
        f"binned wrapper calls (counts zeroed, hit pass, scan) "
        f"{parity_calls:.3f} ms, vote glue (face_origins, % 2, "
        f"unrotate_axis, the adds) {stage['parity'] - parity_calls:.3f} ms")
    in_place = (len(made) == 1 and len(swept) == launches["sweep"]
                and all(p == made[0] for p in swept))
    log(f"  state relayouts in closest_point_grid: none (all {len(swept)} "
        f"sweeps on the x-first volumes sweep_state made): {in_place}")
    if not in_place:
        raise AssertionError("closest_point_grid moved the sweep state")
    del out_one

    # Device time by kernel inside one warm 256^3 call.
    from torch.profiler import ProfilerActivity, profile

    def self_device_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        t_prof = time.perf_counter() - t0
    rows = sorted(prof.key_averages(), key=lambda e: -self_device_us(e))
    busy = sum(self_device_us(e) for e in rows) / 1e3
    log(f"  profiled warm 256^3 call {t_prof * 1e3:.2f} ms; device time "
        f"(self, summed) {busy:.2f} ms; idle share "
        f"{max(0.0, 1 - busy / (t_prof * 1e3)):.3f}")
    for e in rows[:12]:
        if self_device_us(e) > 0:
            log(f"    {e.key[:60]:60s} {self_device_us(e) / 1e3:9.3f} ms"
                f"  x{e.count}")

    def kernel_times(cells):
        """Sweep and +x parity times at cells³ of icosphere(5): each
        directional sweep by the kernel (held bit-equal to the plain
        version in all six directions), the +x sweep's plain time, and one
        +x parity axis, kernel and plain."""
        g, tris, bins, line_bins = prep(verts, faces, [-1.1] * 3, [1.1] * 3,
                                        [cells] * 3)
        stris = sweep.sweep_tris(*tris)
        seed_ms = hold_seed(g, tris, bins, stris, f"{cells}^3")
        seed = cpt.seed_from_bins(g, tris[0], tris[1], tris[2], bins)
        state = cpt.sweep_state(g, seed)
        e_s = hold_sweeps(g, stris, state, f"{cells}^3")
        work = [t.clone() for t in state]
        copy_ms = cuda_ms(lambda: [d.copy_(s) for d, s in zip(work, state)],
                          5)

        def one_sweep(fn, axis, rev):
            def go():
                for dst, src in zip(work, state):
                    dst.copy_(src)
                fn(*work, stris, rev, g.first_cell, g.cell_size, axis=axis)
            return go

        s_dir = {(axis, rev): cuda_ms(one_sweep(sweep.sweep_axis, axis, rev),
                                      5) - copy_ms
                 for axis in (0, 1, 2) for rev in (False, True)}
        s_k = s_dir[(0, False)]
        s_p = cuda_ms(one_sweep(sweep.sweep_axis_plain, 0, False), 2) - copy_ms
        # Bounds: the sweep reads and writes its state (16 B per cell)
        # once, reads the records once, and evaluates 18 candidates per
        # cell.
        b_s = bound(roofline.sweep_flops(cells ** 3),
                    roofline.sweep_bytes(cells ** 3, stris.rec.shape[0]))
        log(f"  {cells}^3 sweeps, kernel ms by (axis, reverse): "
            + ", ".join(f"{k} {v:.3f}" for k, v in s_dir.items()))
        log(f"  {cells}^3 one +x sweep: kernel {s_k:.3f} ms (previous "
            f"{PREVIOUS_MS[f'sweep {cells}^3 +x']} ms), plain "
            f"{s_p:.3f} ms, bound {b_s[0]:.3f} ms ({b_s[1]})")
        # Binned parity on each axis: kernel bit-equal to the plain version
        # (at 128³ also with the chunk count forced to 1, 2 and 7); parity
        # tests every line of a tile against every real block of its table
        # row.
        par = {}
        for axis in range(3):
            args, pkw = parity_inputs(g, line_bins, axis)
            lb = line_bins[axis]
            call = lambda: parity.line_parity_counts_binned(*args, **pkw)
            c_ev = cuda_ms(call, 5)
            c_k = graph_ms(call, 5)
            (want_c, _), c_p = plain_once(
                lambda: parity.line_parity_counts_binned_plain(*args, **pkw))
            got_c, _ = parity.line_parity_counts_binned(*args, **pkw)
            same = {"planned": torch.equal(got_c, want_c)}
            if cells == 128:
                for k in (1, 2, 7):
                    parity.parity_chunks = lambda *a, k=k: k
                    try:
                        forced, _ = parity.line_parity_counts_binned(
                            *args, **pkw)
                    finally:
                        parity.parity_chunks = parity_rule
                    same[k] = torch.equal(forced, want_c)
            torch.cuda.synchronize()
            if not all(same.values()):
                raise AssertionError(f"parity kernel disagrees at {cells}^3 "
                                     f"axis {axis}: {same}")
            groups, n_chunks, per = parity.binned_launch(lb, n_sms)
            pairs = int((lb.tbl != lb.n_blocks).sum()) * lb.tb * lb.tile ** 2
            b_p = bound(parity_flops(pairs, want_c),
                        sum(t.numel() * t.element_size()
                            for t in (args[0], args[1], lb.rows, lb.tbl))
                        + 4 * args[0].numel() * cells)
            par[axis] = (c_k, c_p, b_p)
            prev = (f" (previous {PREVIOUS_MS[f'binned {cells}^3 +x']} ms)"
                    if axis == 0 else "")
            log(f"  {cells}^3 binned parity axis {axis}: kernel {c_k:.4f} ms"
                f" (graph replay), {c_ev:.4f} ms by events{prev}, plain "
                f"{c_p:.1f} ms, bound {b_p[0]:.4f} ms "
                f"({b_p[1]}); grid {groups} line groups x {n_chunks} chunks "
                f"of {per} slots ({groups * n_chunks} CTAs; {lb.t1 * lb.t2} "
                f"tiles, max_nb {lb.tbl.shape[1]}, {pairs} pairs, "
                f"{int(want_c[:, 0].sum())} crossings); equal to plain "
                f"{same}")
        c_k, c_p, b_p = par[0]
        return s_k, s_p, e_s, c_k, c_p, 0.0, b_s, b_p, seed_ms

    parity_rule = parity.parity_chunks
    log("== kernel times vs plain (CUDA events)")
    kernel_times(128)
    (s_k, s_p, e_s, c_k, c_p, e_p, b_sweep, b_parity,
     seed_256) = kernel_times(256)
    errs["sweep"] = max(errs["sweep"], e_s)
    errs["parity"] = max(errs["parity"], e_p)

    # ----------------------------------- path 2: generate_sdf at 1M queries
    log("== path 2: generate_sdf, icosphere(5) x 1,000,000 queries, PALLAS")
    q1m = torch.from_numpy(np.random.default_rng(0).uniform(
        -1.3, 1.3, (1_000_000, 3)).astype(np.float32)).to(dev)
    rq = q1m.norm(dim=-1)
    launches_q = {}
    for sign, count in ((tm.SignMethod.RAYCAST, sdf_k.RAYCAST_COUNT),
                        (tm.SignMethod.NORMAL, sdf_k.NORMAL_COUNT)):

        def run_q(sign=sign):
            out = tm.generate_sdf(verts, topo, q1m, tm.Strategy.PALLAS,
                                  sign_method=sign)
            torch.cuda.synchronize()
            return out

        torch.cuda.synchronize()
        sdf_k.RAYCAST_COUNT.reset()
        sdf_k.NORMAL_COUNT.reset()
        sdf_k.RECORDS_COUNT.reset()
        parity.DENSE_COUNT.reset()
        out = run_q()
        launches_q[sign] = count.kernel
        if sign == tm.SignMethod.RAYCAST:
            launches_q["records"] = sdf_k.RECORDS_COUNT.kernel
        plain_calls = (sdf_k.RAYCAST_COUNT.plain + sdf_k.NORMAL_COUNT.plain
                       + sdf_k.RECORDS_COUNT.plain + parity.DENSE_COUNT.plain)
        log(f"  {sign.name}: kernel launches {count.kernel} (record packing "
            f"{sdf_k.RECORDS_COUNT.kernel}), plain-version calls "
            f"{plain_calls}")
        if count.kernel == 0 or plain_calls or (
                sign == tm.SignMethod.RAYCAST and launches_q["records"] == 0):
            raise AssertionError(f"generate_sdf {sign} missed its kernel")
        if out.device.type != "cuda" or out.shape != (1_000_000,):
            raise AssertionError(f"output {out.device} {tuple(out.shape)}")
        if not bool(torch.isfinite(out).all()):
            raise AssertionError("non-finite distances")
        err = float((out - (rq - 1.0)).abs().max())
        sure = (rq - 1.0).abs() > 0.01
        sign_ok = bool(torch.equal((out < 0)[sure], (rq < 1.0)[sure]))
        log(f"  {sign.name}: max |sdf - (|q| - 1)| {err:.5f}, sign matches "
            f"the sphere where ||q| - 1| > 0.01: {sign_ok}")
        if err >= 0.05 or not sign_ok:
            raise AssertionError(f"generate_sdf {sign} output is wrong")
        (t_cold, times), clk = clocks_during(lambda: warm_times(run_q))
        t_q = statistics.median(times)
        log(f"  {sign.name}: during the timed calls {clk}")
        log(f"  {sign.name}: cold call {t_cold:.4f} s; warm calls "
            f"{', '.join(f'{t:.4f}' for t in times)} s; median "
            f"{t_q:.4f} s = {1e6 / t_q:.4e} queries/s")

    # Device time by kernel inside one warm RAYCAST call.
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tm.generate_sdf(verts, topo, q1m, tm.Strategy.PALLAS)
        torch.cuda.synchronize()
        t_prof = time.perf_counter() - t0

    rows = sorted(prof.key_averages(), key=lambda e: -self_device_us(e))
    device_us = sum(self_device_us(e) for e in rows)
    log(f"  profiled warm RAYCAST call {t_prof * 1e3:.2f} ms; device time "
        f"(self, summed) {device_us / 1e3:.2f} ms")
    for e in rows[:8]:
        if self_device_us(e) > 0:
            log(f"    {e.key[:60]:60s} {self_device_us(e) / 1e3:9.3f} ms"
                f"  x{e.count}")

    # -------------------------------- path 3: the dense grid route at 128³
    log("== path 3: generate_grid_sdf, icosphere(5), 128^3, PALLAS")
    grid128 = tm.Grid.from_bounding_box([-1.1] * 3, [1.1] * 3, [128] * 3)

    def run_grid(strategy):
        out = tm.generate_grid_sdf(verts_dev, topo, grid128,
                                   tm.SignMethod.RAYCAST, strategy=strategy)
        torch.cuda.synchronize()
        return out

    torch.cuda.synchronize()
    for c in (sdf_k.RAYCAST_COUNT, sdf_k.NORMAL_COUNT, sdf_k.RECORDS_COUNT,
              parity.DENSE_COUNT, parity.COUNT, sweep.COUNT):
        c.reset()
    dense = run_grid(tm.Strategy.PALLAS)
    launches_grid = {"raycast": sdf_k.RAYCAST_COUNT.kernel,
                     "records": sdf_k.RECORDS_COUNT.kernel,
                     "dense": parity.DENSE_COUNT.kernel}
    plain_calls = sum(c.plain for c in (sdf_k.RAYCAST_COUNT, sdf_k.NORMAL_COUNT,
                                        sdf_k.RECORDS_COUNT,
                                        parity.DENSE_COUNT))
    log(f"  launches: sdf raycast {launches_grid['raycast']}, record packing "
        f"{launches_grid['records']}, dense parity "
        f"{launches_grid['dense']}; plain-version calls {plain_calls}")
    if min(launches_grid.values()) == 0 or plain_calls:
        raise AssertionError("dense grid route did not run through kernels")
    r128 = grid128.all_cell_centers(dev).reshape(-1, 3).norm(dim=-1)
    cs128 = float(grid128.cell_size[0])
    far = (r128 - 1.0).abs() > 2 * cs128
    err = float((dense - (r128 - 1.0)).abs().max())
    sign_ok = bool(torch.equal((dense < 0)[far], (r128 < 1.0)[far]))
    log(f"  max |sdf - (|c| - 1)| {err:.5f}, sign matches the sphere beyond "
        f"2 cells: {sign_ok}")
    if (dense.shape != (128 ** 3,) or not bool(torch.isfinite(dense).all())
            or err >= 0.05 or not sign_ok):
        raise AssertionError("dense grid route output is wrong")
    cpt128 = run_grid(tm.Strategy.CPT)
    undershoot = float((dense.abs() - cpt128.abs()).max())
    excess = float(((cpt128.abs() - dense.abs()) / dense.abs())[far].max())
    signs_cpt = bool(torch.equal((cpt128 < 0)[far], (dense < 0)[far]))
    log(f"  CPT vs dense: max undershoot {undershoot:.3e}, max relative "
        f"excess beyond 2 cells {excess:.5f}, signs equal beyond 2 cells "
        f"{signs_cpt}")
    if undershoot > ATOL or excess > 0.02 or not signs_cpt:
        raise AssertionError("CPT breaks its contract against the dense route")
    t_cold, times = warm_times(lambda: run_grid(tm.Strategy.PALLAS))
    t_dense = statistics.median(times)
    _, times = warm_times(lambda: run_grid(tm.Strategy.CPT))
    t_cpt128 = statistics.median(times)
    log(f"  PALLAS 128^3: cold {t_cold:.4f} s, warm median {t_dense:.4f} s "
        f"= {128 ** 3 / t_dense:.4e} cells/s; CPT 128^3 warm median "
        f"{t_cpt128:.4f} s")
    # The AUTO cost model's constants (gridgen._AUTO_DEFAULTS["cuda"]):
    # dense pairs/s from the PALLAS route, CPT overhead and cells/s from
    # the CPT route at 128³ and 256³ (as calibrate_auto splits them).
    pairs_per_s = 128 ** 3 * len(faces5) / t_dense
    slope = max((t_warm - t_cpt128) / (256 ** 3 - 128 ** 3), 1e-12)
    log(f"  AUTO \"cuda\" constants: dense pairs/s {pairs_per_s:.4e}, CPT "
        f"overhead {max(t_cpt128 - 128 ** 3 * slope, 0.0):.4f} s, CPT "
        f"cells/s {1.0 / slope:.4e}")
    for cells in (128, 256):
        route = gridgen._auto_route(len(faces5), cells ** 3, dev)
        log(f"  AUTO at {cells}^3 on icosphere(5) (cuda): {route.name}")
        if route != tm.Strategy.CPT:
            raise AssertionError(f"AUTO no longer takes CPT at {cells}^3")

    # ------------------- new kernels vs plain at the paths' shapes, and times
    log("== sdf kernels vs plain at the paths' shapes (CUDA events)")
    ra, rb, rc = soup5
    centers128 = grid128.all_cell_centers(dev).reshape(-1, 3)

    def hold(key, q, axes, what):
        """The kernel against its plain version on the same queries: d²
        within tolerance, counts and normal signs equal. Returns the plain
        version's ms."""
        if key == "raycast":
            (d_k, c_k) = sdf_k.raycast_raw(q, ra, rb, rc, raycast_axes=axes)
            (d_p, c_p), p_ms = plain_once(lambda: sdf_k.raycast_raw_plain(
                q, ra, rb, rc, raycast_axes=axes))
            got, want = (d_k,), (d_p,)
            if not torch.equal(c_k, c_p):
                raise AssertionError(f"raycast counts differ: {what}")
        else:
            got = sdf_k.normal_raw(q, ra, rb, rc)
            want, p_ms = plain_once(
                lambda: sdf_k.normal_raw_plain(q, ra, rb, rc))
            if not all(torch.equal(g.view(torch.int32), w.view(torch.int32))
                       for g, w in zip(got, want)):
                raise AssertionError(f"normal kernel disagrees: {what}")
            if not torch.equal(
                    torch.signbit(combine_champions(*map(sqrt_f32, got))),
                    torch.signbit(combine_champions(*map(sqrt_f32, want)))):
                raise AssertionError(f"normal signs differ: {what}")
        err = 0.0
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL)
            err = max(err, float((g - w).abs().max()))
        errs[key] = max(errs[key], err)
        log(f"  {key} {what}: max |kernel - plain| d2 {err:.3e}, "
            f"{'counts' if key == 'raycast' else 'signs'} equal; plain "
            f"{p_ms:.1f} ms")
        return p_ms

    k_ms = {}
    counts_1m = sdf_k.raycast_raw(q1m, ra, rb, rc, raycast_axes=3)[1]
    for key, axes, k_fn, p_fn in (
        ("raycast", 3,
         lambda q: sdf_k.raycast_raw(q, ra, rb, rc, raycast_axes=3),
         lambda q: sdf_k.raycast_raw_plain(q, ra, rb, rc, raycast_axes=3)),
        ("normal", None, lambda q: sdf_k.normal_raw(q, ra, rb, rc),
         lambda q: sdf_k.normal_raw_plain(q, ra, rb, rc)),
    ):
        plain_1m = hold(key, q1m, axes, "at path 2's 1,000,000 queries")
        ms_1m = cuda_ms(lambda: k_fn(q1m), 3)
        ms_64k = cuda_ms(lambda: k_fn(q64k), 5)
        plain_64k = cuda_ms(lambda: p_fn(q64k), 2)
        pairs = q1m.shape[0] * ra.shape[0]
        flops = (raycast_flops(q1m.shape[0], ra.shape[0], 3, counts_1m)
                 if key == "raycast"
                 else pairs * (FLOPS["ladder"] + FLOPS["normal"]))
        out_bytes = 4 * q1m.shape[0] * (4 if key == "raycast" else 2)
        k_ms[key] = (ms_1m, plain_1m, bound(
            flops, 12 * q1m.shape[0] + 36 * ra.shape[0] + out_bytes))
        log(f"  {key}: bound {k_ms[key][2][0]:.3f} ms ({k_ms[key][2][1]})")
        log(f"  {key}: 1M kernel {ms_1m:.3f} ms "
            f"({1e6 * len(faces5) / (ms_1m / 1e3):.4e} pairs/s), plain "
            f"{plain_1m:.1f} ms; 65,536: kernel {ms_64k:.3f} ms, plain "
            f"{plain_64k:.3f} ms")
        prev_key = ("raycast 1M x 20,480, 3 axes" if key == "raycast"
                    else "normal 1M x 20,480")
        log(f"  {prev_key}: kernel {ms_1m:.3f} ms, previous "
            f"{PREVIOUS_MS[prev_key]} ms, bound {k_ms[key][2][0]:.3f} ms")
    plain_grid = hold("raycast", centers128, 0,
                      "axes 0 at path 3's 128^3 cell centres")
    ms_grid = cuda_ms(lambda: sdf_k.raycast_raw(
        centers128, ra, rb, rc, raycast_axes=0), 3)
    b_grid = bound(centers128.shape[0] * ra.shape[0] * FLOPS["ladder"],
                   16 * centers128.shape[0] + 36 * ra.shape[0])
    log(f"  raycast, axes 0, at the 128^3 cell centres: kernel "
        f"{ms_grid:.3f} ms, plain {plain_grid:.1f} ms, previous "
        f"{PREVIOUS_MS['raycast 128^3 centres, axes 0']} ms, bound "
        f"{b_grid[0]:.3f} ms ({b_grid[1]})")
    def hold_dense(g, tris, what, forced=()):
        """The dense parity kernel on each axis of ``g``'s lattice against
        ``tris``: bit-equal to the plain version at the planned chunk count
        and at each ``forced`` one. Returns {axis: (kernel ms, plain ms,
        bound)}."""
        out = {}
        for axis in range(3):
            origins, _ = face_origins(g, axis, dev)
            iy, iz = (axis + 1) % 3, (axis + 2) % 3
            dargs = (origins[:, iy].contiguous(), origins[:, iz].contiguous(),
                     g.first_cell[axis], g.cell_size[axis],
                     parity.rotate_planes(*tris, axis))
            n = g.cell_count[axis]
            call = lambda: parity.line_parity_counts(*dargs, n_cells=n)
            d_ev = cuda_ms(call, 5)
            d_k = graph_ms(call, 5)
            (want, _), d_p = plain_once(lambda: parity.line_parity_counts_plain(
                *dargs, n_cells=n))
            got, _ = parity.line_parity_counts(*dargs, n_cells=n)
            same = {"planned": torch.equal(got, want)}
            for k in forced:
                parity.parity_chunks = lambda *a, k=k: k
                try:
                    same[k] = torch.equal(parity.line_parity_counts(
                        *dargs, n_cells=n)[0], want)
                finally:
                    parity.parity_chunks = parity_rule
            torch.cuda.synchronize()
            if not all(same.values()):
                raise AssertionError(f"dense parity kernel disagrees: {what} "
                                     f"axis {axis}: {same}")
            L, T = dargs[0].numel(), tris[0].shape[0]
            b_d = bound(parity_flops(L * T, want),
                        8 * L + 36 * T + 4 * L * n)
            groups, n_chunks, per = parity.dense_launch(L, T, n_sms)
            out[axis] = (d_k, d_p, b_d)
            log(f"  {what} dense parity axis {axis}: kernel {d_k:.4f} ms "
                f"(graph replay; {L * T / (d_k / 1e3):.4e} pairs/s), "
                f"{d_ev:.4f} ms by events, plain {d_p:.1f} ms, "
                f"bound {b_d[0]:.4f} ms ({b_d[1]}); grid {groups} line "
                f"groups x {n_chunks} chunks of {per} blocks "
                f"({groups * n_chunks} CTAs; {int(want[:, 0].sum())} "
                f"crossings); equal to plain {same}")
        return out

    for cells in (128, 256):
        g = tm.Grid.from_bounding_box([-1.1] * 3, [1.1] * 3, [cells] * 3)
        dense_ms = hold_dense(g, (ra, rb, rc), f"{cells}^3 icosphere(5)",
                              forced=(1, 2, 7) if cells == 128 else ())
        k_ms["dense"] = dense_ms[0]
        log(f"  {cells}^3 one +x dense parity axis: kernel "
            f"{dense_ms[0][0]:.4f} ms (previous "
            f"{PREVIOUS_MS[f'dense {cells}^3 +x']} ms), bound "
            f"{dense_ms[0][2][0]:.4f} ms")

    # ------------------ path 4: CULLED generate_sdf, icosphere(8) x 1M
    log("== path 4: generate_sdf, icosphere(8) x 1,000,000 queries, AUTO "
        "(CULLED)")
    from mesh_to_sdf_tpu_torch import query
    from mesh_to_sdf_tpu_torch.ops import culling
    from mesh_to_sdf_tpu_torch.ops.kernels import culled

    t0 = time.perf_counter()
    verts8, faces8 = icosphere(8)
    topo8 = tm.Topology.triangle_list(faces8.reshape(-1))
    log(f"  icosphere(8): {len(faces8)} triangles ({time.perf_counter() - t0:.2f} "
        f"s to build)")
    qc = torch.from_numpy(np.random.default_rng(2).uniform(
        -1.3, 1.3, (1_000_000, 3)).astype(np.float32)).to(dev)
    rqc = qc.norm(dim=-1)
    counters = (culled.COUNT, sdf_k.RAYCAST_COUNT, sdf_k.NORMAL_COUNT,
                sdf_k.RECORDS_COUNT, parity.DENSE_COUNT, parity.COUNT,
                sweep.COUNT, culled.PHASE_A_COUNT)
    # The kernel's inputs as the path gives them: the first call of each
    # (group, slots, anchors) shape, held against the plain version below.
    recorded = {}
    culled_blocks = culled.culled_blocks

    def recording(*a, **k):
        key = (k["group"], a[2].shape[1], k.get("anchors") is not None)
        recorded.setdefault(key, (a, k))
        return culled_blocks(*a, **k)

    def check_sphere(out, what):
        if out.device.type != "cuda" or out.shape != (1_000_000,):
            raise AssertionError(f"{what}: output {out.device} "
                                 f"{tuple(out.shape)}")
        if not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{what}: non-finite distances")
        err = float((out - (rqc - 1.0)).abs().max())
        sure = (rqc - 1.0).abs() > 0.01
        sign_ok = bool(torch.equal((out < 0)[sure], (rqc < 1.0)[sure]))
        log(f"  {what}: max |sdf - (|q| - 1)| {err:.6f}, sign matches the "
            f"sphere where ||q| - 1| > 0.01: {sign_ok}")
        if err >= 0.05 or not sign_ok:
            raise AssertionError(f"{what}: output is wrong")

    def run_culled():
        out = tm.generate_sdf(verts8, topo8, qc)
        torch.cuda.synchronize()
        return out

    # The dense parity launches of the cold call's sign grid
    # (culling.build_sign_grid: 128 x 128 lines per axis against every
    # triangle), held against the plain version below.
    sign_calls = []
    dense_parity = parity.line_parity_counts

    def recording_dense(*a, **k):
        sign_calls.append((a, k))
        return dense_parity(*a, **k)

    def drive_culled():
        """The main path with counts at 0: cold call, checks, 3 warm
        calls. Returns (launches, cold s, warm median s, stats)."""
        engine = "gather"
        culling.LAST_CULLED_STATS.clear()
        torch.cuda.synchronize()
        for c in counters:
            c.reset()
        culled.culled_blocks = recording
        parity.line_parity_counts = recording_dense
        try:
            t0 = time.perf_counter()
            out = run_culled()
            t_cold = time.perf_counter() - t0
        finally:
            culled.culled_blocks = culled_blocks
            parity.line_parity_counts = dense_parity
        n_launch = culled.COUNT.kernel
        n_records = sdf_k.RECORDS_COUNT.kernel
        n_phase_a = culled.PHASE_A_COUNT.kernel
        plain_calls = sum(c.plain for c in counters)
        stats = dict(culling.LAST_CULLED_STATS)
        log(f"  {engine}: launches culled_blocks {n_launch}, phase A "
            f"{n_phase_a}, sdf raycast "
            f"{sdf_k.RAYCAST_COUNT.kernel}, record packing {n_records} "
            f"(cold call: the engine's block-index table and one per "
            f"raycast call), dense parity "
            f"{parity.DENSE_COUNT.kernel}; plain-version calls {plain_calls}")
        log(f"  {engine}: LAST_CULLED_STATS {json.dumps(stats)}")
        if (n_launch == 0 or n_records == 0 or n_phase_a == 0 or plain_calls
                or stats.get("engine") != engine):
            raise AssertionError(f"AUTO did not take CULLED ({engine}) "
                                 f"through the kernel")
        check_sphere(out, engine)
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            run_culled()
            times.append(time.perf_counter() - t0)
        t_warm = statistics.median(times)
        log(f"  {engine}: cold call {t_cold:.4f} s; warm calls "
            f"{', '.join(f'{t:.4f}' for t in times)} s; median "
            f"{t_warm:.4f} s = {1e6 / t_warm:.4e} queries/s")
        return (n_launch, n_records, n_phase_a), t_cold, t_warm, stats

    for cache in (query._SIGN_GRID_CACHE, query._PARITY_BINS_CACHE,
                  query._BLOCK_INDEX_CACHE, culling._ROUTE_CACHE):
        cache.clear()
    (launches_culled, launches_records, launches_phase_a), _, _, \
        stats_gather = drive_culled()

    # Device time by stage inside one warm call (CUDA events around
    # the wrapped functions; nested stages overlap their parents).
    stages = [(culling, "_morton_order", "Morton sorts"),
              (culled, "_phase_a_topk", "phase A"),
              (culled, "culled_blocks", "culled kernel"),
              (culling, "_culled_gather_signed_impl", "gather passes"),
              (culling, "_culled_signed_fixup_impl",
               "fused pass + widen + fix-up"),
              (sdf_k, "raycast_raw", "raycast kernel (fix-up, fallback)")]
    spans = {label: [] for _, _, label in stages}
    ray_calls = []  # (args, kwargs) of each raycast launch, in order
    saved = []
    for module, name, label in stages:
        fn = getattr(module, name)
        saved.append((module, name, fn))

        def span(*a, _fn=fn, _label=label, _ray=name == "raycast_raw",
                 **k):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = _fn(*a, **k)
            end.record()
            spans[_label].append((start, end))
            if _ray:
                ray_calls.append((a, k, out[1]))
            return out

        setattr(module, name, span)
    try:
        t0 = time.perf_counter()
        run_culled()
        t_one = time.perf_counter() - t0
    finally:
        for module, name, fn in saved:
            setattr(module, name, fn)
    log(f"  one warm gather call {t_one * 1e3:.1f} ms; by stage (ms, "
        f"calls): " + "; ".join(
            f"{label} {sum(a.elapsed_time(b) for a, b in ev):.1f} "
            f"x{len(ev)}" for label, ev in spans.items()))
    ray_label = "raycast kernel (fix-up, fallback)"
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    ray_launches = []
    for (a, k, cnt), (start, end) in zip(ray_calls, spans[ray_label]):
        nq, nt, ax = a[0].shape[0], a[1].shape[0], k["raycast_axes"]
        ray_launches.append((nq, start.elapsed_time(end)))
        b_l = bound(raycast_flops(nq, nt, ax, cnt),
                    12 * nq + 36 * nt + 4 * (1 + ax) * nq)
        log(f"  raycast launch: {nq} queries x {nt} triangles, axes {ax}, "
            f"{sdf_k.raycast_chunks(nq, nt, n_sms)} triangle chunks: "
            f"{ray_launches[-1][1]:.3f} ms (records and kernel), bound "
            f"{b_l[0]:.3f} ms ({b_l[1]})")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_culled()
        t_prof = time.perf_counter() - t0
    rows = sorted(prof.key_averages(), key=lambda e: -self_device_us(e))
    busy = sum(self_device_us(e) for e in rows) / 1e3
    log(f"  profiled warm gather call {t_prof * 1e3:.1f} ms; device time "
        f"(self, summed) {busy:.1f} ms; idle share "
        f"{max(0.0, 1 - busy / (t_prof * 1e3)):.3f}")
    for e in rows[:10]:
        if self_device_us(e) > 0:
            log(f"    {e.key[:60]:60s} {self_device_us(e) / 1e3:9.3f} ms"
                f"  x{e.count}")

    # The fix-up launch (k_fix queries on all 1.31M triangles, the
    # shape that leaves the card idle without the split), held against
    # one chunk bit for bit and on its first 512 queries against the
    # plain version.
    log("== raycast kernel at CULLED's fix-up shape")
    k_fix = stats_gather["k_fix"]
    fix_a, fix_k = next((a, k) for a, k, _ in ray_calls
                        if a[0].shape[0] == k_fix)
    q_fix, ra8, rb8, rc8 = fix_a
    axes8 = fix_k["raycast_axes"]
    n_chunks = sdf_k.raycast_chunks(k_fix, ra8.shape[0], n_sms)
    fd_s, fc_s = sdf_k.raycast_raw(*fix_a, raycast_axes=axes8)
    chunk_rule = sdf_k.raycast_chunks
    sdf_k.raycast_chunks = lambda *a: 1  # the same launch, unsplit
    try:
        fd_1, fc_1 = sdf_k.raycast_raw(*fix_a, raycast_axes=axes8)
        ms_one = cuda_ms(lambda: sdf_k.raycast_raw(
            *fix_a, raycast_axes=axes8), 1)
    finally:
        sdf_k.raycast_chunks = chunk_rule
    q512 = q_fix[:512].contiguous()
    fd_k, fc_k = sdf_k.raycast_raw(q512, ra8, rb8, rc8,
                                   raycast_axes=axes8)
    (fd_p, fc_p), fp_ms = plain_once(lambda: sdf_k.raycast_raw_plain(
        q512, ra8, rb8, rc8, raycast_axes=axes8))
    same_split = (torch.equal(fd_s.view(torch.int32),
                              fd_1.view(torch.int32))
                  and torch.equal(fc_s, fc_1))
    same_plain = (torch.equal(fd_k.view(torch.int32),
                              fd_p.view(torch.int32))
                  and torch.equal(fc_k, fc_p))
    ms_split = cuda_ms(lambda: sdf_k.raycast_raw(
        *fix_a, raycast_axes=axes8), 3)
    b_fix = bound(raycast_flops(k_fix, ra8.shape[0], axes8, fc_s),
                  12 * k_fix + 36 * ra8.shape[0] + 4 * (1 + axes8) * k_fix)
    log(f"  {k_fix} queries x {ra8.shape[0]} triangles, axes {axes8}: "
        f"split into {n_chunks} chunks == one chunk (d2 bits, counts) "
        f"{same_split}; first 512 queries == plain {same_plain} (plain "
        f"{fp_ms:.1f} ms)")
    log(f"  kernel {ms_split:.3f} ms split, {ms_one:.3f} ms in one "
        f"chunk; bound {b_fix[0]:.3f} ms ({b_fix[1]})")
    if not (same_split and same_plain):
        raise AssertionError("raycast kernel disagrees at the fix-up "
                             "shape")
    errs["raycast"] = max(errs["raycast"],
                          float((fd_k - fd_p).abs().max()))
    rec_ms = cuda_ms(lambda: sdf_k.tri_records(ra8, rb8, rc8), 5)
    (_, rec_plain_ms) = plain_once(
        lambda: sdf_k.tri_records_plain(ra8, rb8, rc8))
    b_rec = bound(40 * ra8.shape[0], (36 + 80) * ra8.shape[0])
    log(f"  record packing of {ra8.shape[0]} triangles: kernel "
        f"{rec_ms:.3f} ms, plain {rec_plain_ms:.3f} ms, bound "
        f"{b_rec[0]:.3f} ms ({b_rec[1]})")

    # The normal kernel at the same shape (the fallback of CULLED's
    # normal sign runs such batches): split against one chunk bit for
    # bit, and on the first 512 queries against the plain version.
    log("== normal kernel at the fix-up shape (split)")
    n_chunks_n = sdf_k.raycast_chunks(k_fix, ra8.shape[0], n_sms,
                                      sdf_k.NORMAL_CTA_QUERIES)
    ns = sdf_k.normal_raw(q_fix, ra8, rb8, rc8)
    sdf_k.raycast_chunks = lambda *a: 1
    try:
        n1 = sdf_k.normal_raw(q_fix, ra8, rb8, rc8)
        ms_one_n = cuda_ms(lambda: sdf_k.normal_raw(q_fix, ra8, rb8, rc8),
                           1)
    finally:
        sdf_k.raycast_chunks = chunk_rule
    nk = sdf_k.normal_raw(q512, ra8, rb8, rc8)
    np_, np_ms = plain_once(lambda: sdf_k.normal_raw_plain(
        q512, ra8, rb8, rc8))
    same_split_n = all(torch.equal(a.view(torch.int32),
                                   b.view(torch.int32))
                       for a, b in zip(ns, n1))
    same_plain_n = all(torch.equal(a.view(torch.int32),
                                   b.view(torch.int32))
                       for a, b in zip(nk, np_))
    ms_split_n = cuda_ms(lambda: sdf_k.normal_raw(q_fix, ra8, rb8, rc8),
                         3)
    b_fix_n = bound(k_fix * ra8.shape[0] * (FLOPS["ladder"]
                                            + FLOPS["normal"]),
                    12 * k_fix + 36 * ra8.shape[0] + 8 * k_fix)
    log(f"  normal {k_fix} x {ra8.shape[0]}: split into {n_chunks_n} "
        f"chunks == one chunk (pos2, neg2 bits) {same_split_n}; first "
        f"512 queries == plain {same_plain_n} (plain {np_ms:.1f} ms)")
    log(f"  normal kernel {ms_split_n:.3f} ms split, {ms_one_n:.3f} ms "
        f"in one chunk; bound {b_fix_n[0]:.3f} ms ({b_fix_n[1]})")
    if not (same_split_n and same_plain_n and n_chunks_n > 1):
        raise AssertionError("normal kernel disagrees at the split shape")

    # The sign grid's dense parity launches of the cold gather call.
    log("== dense parity kernel at CULLED's sign-grid shape (the cold "
        "call's launches)")
    gather_sign_calls = sign_calls[:]
    if len(gather_sign_calls) != 3:
        raise AssertionError(f"the cold CULLED call made "
                             f"{len(gather_sign_calls)} dense parity "
                             f"launches, not 3")
    sign_ms = {}
    for axis, (a, k) in enumerate(gather_sign_calls):
        L, T = a[0].numel(), a[4][0].shape[0]
        n = k["n_cells"]
        d_ev = cuda_ms(lambda: parity.line_parity_counts(*a, **k), 3)
        d_k = graph_ms(lambda: parity.line_parity_counts(*a, **k), 3)
        (want, _), d_p = plain_once(
            lambda: parity.line_parity_counts_plain(*a, **k))
        got, _ = parity.line_parity_counts(*a, **k)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"dense parity kernel disagrees at the "
                                 f"sign-grid shape, axis {axis}")
        b_d = bound(parity_flops(L * T, want), 8 * L + 36 * T + 4 * L * n)
        groups, n_chunks, per = parity.dense_launch(L, T, n_sms)
        sign_ms[axis] = (d_k, d_p, b_d)
        log(f"  axis {axis}: {L} lines x {T} triangles x {n} cells: "
            f"kernel {d_k:.3f} ms (graph replay; {L * T / (d_k / 1e3):.4e}"
            f" pairs/s), {d_ev:.3f} ms by events, plain {d_p:.1f} ms, "
            f"bound {b_d[0]:.3f} ms ({b_d[1]}); grid "
            f"{groups} line groups x {n_chunks} chunks of {per} blocks; "
            f"{int(want[:, 0].sum())} crossings; equal to plain")
        del want, got
    log(f"  sign grid, three axes: kernel "
        f"{sum(v[0] for v in sign_ms.values()):.3f} ms, bound "
        f"{sum(v[2][0] for v in sign_ms.values()):.3f} ms")
    del gather_sign_calls
    sign_calls.clear()

    # CULLED against PALLAS where PALLAS is affordable: icosphere(6).
    verts6, faces6 = icosphere(6)
    topo6 = tm.Topology.triangle_list(faces6.reshape(-1))
    culling.LAST_CULLED_STATS.clear()
    got6 = tm.generate_sdf(verts6, topo6, qc)
    if culling.LAST_CULLED_STATS.get("tris") != len(faces6):
        raise AssertionError("AUTO did not take CULLED on icosphere(6)")
    t0 = time.perf_counter()
    got6 = tm.generate_sdf(verts6, topo6, qc)
    torch.cuda.synchronize()
    t_c6 = time.perf_counter() - t0
    want6 = tm.generate_sdf(verts6, topo6, qc, tm.Strategy.PALLAS)

    def pallas6():
        t0 = time.perf_counter()
        out = tm.generate_sdf(verts6, topo6, qc, tm.Strategy.PALLAS)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    (want6, t_p6), clk6 = clocks_during(pallas6)
    torch.testing.assert_close(got6.abs(), want6.abs(), rtol=RTOL, atol=ATOL)
    n_sign = int((torch.signbit(got6) != torch.signbit(want6)).sum())
    log(f"  icosphere(6) x 1M: CULLED {t_c6:.4f} s, PALLAS {t_p6:.4f} s warm; "
        f"max |CULLED - PALLAS| {float((got6 - want6).abs().max()):.3e}; "
        f"sign disagreements {n_sign} (limit 100 = 1e-4 of the queries); "
        f"stats {json.dumps(culling.LAST_CULLED_STATS)}")
    ra6, rb6, rc6 = (torch.from_numpy(np.ascontiguousarray(
        verts6[faces6[:, k]])).to(dev) for k in range(3))
    ms6, clk6k = clocks_during(lambda: cuda_ms(lambda: sdf_k.raycast_raw(
        qc, ra6, rb6, rc6, raycast_axes=3), 3))
    log(f"  PALLAS call on icosphere(6): {clk6}; raycast kernel alone "
        f"{ms6:.3f} ms = {qc.shape[0] * ra6.shape[0] / (ms6 / 1e3):.4e} "
        f"pairs/s, {clk6k}")
    if n_sign > 100:
        raise AssertionError("CULLED signs disagree with PALLAS")

    # The kernel against its plain version at every shape the path gave it.
    log("== culled kernel vs plain at the path's shapes (CUDA events)")
    bi8 = next(v for k, v in query._BLOCK_INDEX_CACHE.items()
               if k[1][0] == len(faces8))
    for name, rows8 in (("rows", bi8.rows), ("gather_rows", bi8.gather_rows)):
        rec8 = culled.table_records(rows8)  # the tables the path packed
        p8 = rows8.permute(1, 0, 2).reshape(9, -1)
        want8 = sdf_k.tri_records_plain(p8[0:3].t(), p8[3:6].t(),
                                        p8[6:9].t(), edges=True)
        same = torch.equal(
            rec8.reshape(-1, len(sdf_k.RECORD_FIELDS)).view(torch.int32),
            want8.view(torch.int32))
        log(f"  icosphere(8) block-index records of {name} "
            f"{tuple(rec8.shape)}: bit-equal to the plain packing {same}")
        if not same:
            raise AssertionError(f"block-index records disagree: {name}")
        del p8, want8
    errs["culled"] = 0.0
    culled_row = None
    for (group, n_slots, signed), (a, k) in sorted(recorded.items()):
        q_in, rows_in, tbl = a
        anchors = k.get("anchors")
        what = (f"group {group}, {n_slots} slots, "
                f"{'anchors' if signed else 'no anchors'}, "
                f"{q_in.shape[0]} queries")
        d_ker, c_ker = culled_blocks(*a, **k)
        ms_full = cuda_ms(lambda: culled_blocks(*a, **k), 3)
        # The plain version on all groups of the gather pass; on the first
        # 65,536 queries' groups of the other shapes (their full plain runs
        # would take minutes).
        main_shape = (group, n_slots, signed) == (64, culling.DEFAULT_KG,
                                                  True)
        n_g = tbl.shape[0] if main_shape else max(1, 65536 // group)
        n_q = n_g * group
        sub_a = (q_in[:n_q], rows_in, tbl[:n_g])
        sub_k = dict(k, anchors=None if anchors is None else anchors[:n_q])
        (d_pl, c_pl), p_ms = plain_once(
            lambda: culled.culled_blocks_plain(*sub_a, **sub_k))
        err = float((d_ker[:n_q] - d_pl).abs().max())
        same = torch.equal(d_ker[:n_q], d_pl) and (
            c_ker is None or torch.equal(c_ker[:n_q], c_pl))
        ms_sub = cuda_ms(lambda: culled_blocks(*sub_a, **sub_k), 3)
        pairs = int((tbl[:n_g] != bi8.n_blocks).sum()) * rows_in.shape[2] * group
        b = bound(pairs * (FLOPS["ladder"] + (FLOPS["segment"] if signed
                                              else 0)),
                  sum(t.numel() * t.element_size()
                      for t in (sub_a[0], rows_in, sub_a[2]))
                  + (16 if signed else 4) * n_q
                  + (0 if anchors is None else 12 * n_q))
        pairs_all = int((tbl != bi8.n_blocks).sum()) * rows_in.shape[2] * group
        b_all = bound(pairs_all * (FLOPS["ladder"] + (FLOPS["segment"]
                                                      if signed else 0)),
                      sum(t.numel() * t.element_size()
                          for t in (q_in, rows_in, tbl))
                      + (16 if signed else 4) * q_in.shape[0]
                      + (0 if anchors is None else 12 * q_in.shape[0]))
        prev = PREVIOUS_MS.get(f"culled {group}x{n_slots}"
                               + (" anchors" if group > 64 and signed
                                  else ""))
        log(f"  {what}: d2 equal {same} (max abs err {err:.1e}); kernel "
            f"{ms_full:.3f} ms on all ("
            f"{'' if prev is None else f'previous {prev} ms; '}bound "
            f"{b_all[0]:.3f} ms, {b_all[1]}), {ms_sub:.3f} ms on {n_q} queries "
            f"({pairs / (ms_sub / 1e3):.3e} pairs/s), plain {p_ms:.1f} ms on "
            f"{n_q}; bound {b[0]:.3f} ms ({b[1]}) on {n_q}")
        if not same:
            raise AssertionError(f"culled kernel disagrees: {what}")
        errs["culled"] = max(errs["culled"], err)
        if main_shape:
            culled_row = (ms_full, p_ms, b_all)
    if culled_row is None:
        raise AssertionError("the gather pass never reached the kernel")
    log(f"  launches on the main path: gather {launches_culled}")

    # ------------------------------- path 5: the trainable SDF (training)
    torch.cuda.empty_cache()
    t_train = time.perf_counter()
    train = training_phase(dev, card=card)
    log(f"  training phase {time.perf_counter() - t_train:.1f} s; launches "
        f"{train}")

    log(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        f" GiB")

    # ------------------------------- path 6: the slab-streamed 512³ grid
    torch.cuda.empty_cache()
    t_stream = time.perf_counter()
    streamed = streamed_phase(dev, card=card)
    log(f"  streamed phase {time.perf_counter() - t_stream:.1f} s; launches "
        f"{streamed['launches']}")

    # ------------------------------- path 7: parallel/ (sharded paths)
    torch.cuda.empty_cache()
    t_shard = time.perf_counter()
    sharded = sharded_phase(dev, card=card)
    log(f"  sharded phase {time.perf_counter() - t_shard:.1f} s; launches "
        f"{sharded['launches']}")

    # ------------------------------- path 8: the CLI (the user surface)
    torch.cuda.empty_cache()
    surface = surface_phase(dev, card=card)
    for key, err in surface["errs"].items():
        errs[key] = max(errs[key], err)

    # ------------------------------- path 9: the bench (bench_torch.py)
    torch.cuda.empty_cache()
    bench = bench_phase(dev, card=card)
    for key, err in bench["errs"].items():
        errs[key] = max(errs[key], err)

    # ------------------------------- path 10: the host-sync markers
    torch.cuda.empty_cache()
    log(f"  tracing phase {tracing_phase(card=card):.1f} s")
    log(f"  whole run {time.perf_counter() - t_start:.1f} s")
    log(card)
    src = "mesh_to_sdf_tpu_torch/csrc/"

    def row(name, source, replaces, n_launch, err, ms, plain_ms, bnd):
        return {"name": name, "route": "cuda", "source": src + source,
                "replaces": "mesh_to_sdf_tpu/ops/kernels/" + replaces,
                "launches": int(n_launch), "max_abs_err": float(err),
                "ms": float(ms), "plain_ms": float(plain_ms),
                "bound_ms": float(bnd[0]), "bound_by": bnd[1],
                "library_ms": None}

    def on_slabs(key, n_launch):
        """The kernel at path 6's slab shape: its launches there and its
        times and bound."""
        ms, plain_ms, bnd = streamed["shapes"][key]
        return {"shape": f"{key}, {streamed['shape']}",
                "launches": int(n_launch), "ms": float(ms),
                "plain_ms": float(plain_ms), "bound_ms": float(bnd[0]),
                "bound_by": bnd[1]}

    def at(ms, plain_ms, bnd, shape):
        return {"shape": shape, "ms": float(ms), "plain_ms": float(plain_ms),
                "bound_ms": float(bnd[0]), "bound_by": bnd[1]}

    def on_sharded(key):
        """Path 7's launches of the kernel, and its times and bound at the
        path's own shapes where it has them (else the row's shape is the
        path's: the world of 1 runs path 2's 1M x 20,480): the rank slab,
        and for the sweep and binned parity also the world of 1's slab."""
        out = {"launches": int(sharded["launches"][key])}
        if key in sharded["shapes"]:
            out.update(at(*sharded["shapes"][key]))
        if key in sharded["world1"]:
            out["world_of_1"] = at(*sharded["world1"][key])
        return out

    s_launch = streamed["launches"]
    h_launch = sharded["launches"]
    kernel_rows = [
        row("sweep_axis", "sweep.cu", "pallas_sweep.py:142",
            launches["sweep"] + train["sweep"] + s_launch["sweep"],
            errs["sweep"], s_k, s_p, b_sweep),
        row("line_parity_counts_binned", "parity.cu", "pallas_parity.py:449",
            launches["parity"] + s_launch["parity"], errs["parity"], c_k,
            c_p, b_parity),
        row("line_parity_counts", "parity.cu", "pallas_parity.py:49",
            launches_grid["dense"] + train["dense"], errs["dense"],
            *k_ms["dense"]),
        row("sdf_raycast", "sdf.cu", "pallas_sdf.py:202",
            launches_q[tm.SignMethod.RAYCAST], errs["raycast"],
            *k_ms["raycast"]),
        row("sdf_normal", "sdf.cu", "pallas_sdf.py:241",
            launches_q[tm.SignMethod.NORMAL], errs["normal"],
            *k_ms["normal"]),
        row("culled_blocks", "culled.cu", "pallas_culled.py:516",
            launches_culled, errs["culled"], *culled_row),
        row("tri_records", "sdf.cu", "pallas_sdf.py:202",
            launches_records + train["records"] + s_launch["records"],
            errs["records"], rec_ms, rec_plain_ms, b_rec),
        row("seed_from_bins", "seed.cu", "none",
            launches["seed"] + s_launch["seed"], 0.0, *seed_256),
        row("phase_a_hier", "phase_a.cu", "none", launches_phase_a, 0.0,
            *phase_a["uniform main"]),
    ]
    # The seed and phase A replace XLA glue, no pallas_call.
    kernel_rows[-2]["replaces"] = "mesh_to_sdf_tpu/ops/cpt.py:421"
    kernel_rows[-1]["replaces"] = ("mesh_to_sdf_tpu/ops/kernels/"
                                   "pallas_culled.py:195")
    kernel_rows[-1]["shapes"] = [at(*v, name) for name, v in phase_a.items()]
    kernel_rows[0]["streamed"] = on_slabs("sweep axis 0", s_launch["sweep"])
    kernel_rows[1]["streamed"] = on_slabs("parity axis 0",
                                          s_launch["parity"])
    kernel_rows[-2]["streamed"] = on_slabs("seed", s_launch["seed"])
    u_launch = surface["launches"]
    b_launch = bench["launches"]
    for row, key in zip(kernel_rows, ("sweep", "parity", "dense", "raycast",
                                      "normal", "culled", "records",
                                      "seed", "phase_a")):
        row["launches"] += (int(h_launch[key]) + int(u_launch[key])
                            + int(b_launch[key]))
        row["sharded"] = on_sharded(key)
        row["surface"] = {"launches": int(u_launch[key]), "shapes": [
            at(*shape) for shape in surface["shapes"].get(key, [])]}
        row["bench"] = {"launches": int(b_launch[key]), "shapes": [
            at(*shape) for shape in bench["shapes"].get(key, [])]}
    for key in ("sweep", "parity", "dense", "raycast", "normal"):
        if not u_launch[key]:
            raise AssertionError(f"path 8 never launched the {key} kernel")
    print(json.dumps({"kernels": kernel_rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
