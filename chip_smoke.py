#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (mesh_to_sdf_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the native host library and the CUDA kernels from this checkout,
checks each kernel against its plain PyTorch version on the card (the
packed triangle records bit for bit), and drives three paths on
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
block-culled kernel), with the gather engine and with the union engine;
CULLED is also held against PALLAS on ``icosphere(6)``, the culled kernel
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

#: Distance tolerance kernel vs plain version (and index re-evaluation).
#: Both round every operation as written (-fmad=false, correctly rounded
#: sqrt), so they agree far inside it.
RTOL, ATOL = 2e-4, 1e-5

#: HBM bandwidth of the H100 SXM at 700 W (NVIDIA's data sheet). A
#: kernel's bound is the larger of its operations over the FP32 rate and its
#: bytes over this.
PEAK_BYTES = 3.35e12
#: FP32 operations/s outside the tensor cores, set in main() from this card:
#: SMs x 128 FP32 lanes x the max SM clock. The data sheet's 67 TFLOP/s
#: counts a fused multiply-add as two operations; every kernel here is built
#: with -fmad=false, so no multiply-add is fused and each lane retires at
#: most one operation per clock (about 33.5e12/s on a 132-SM H100 at 1.98
#: GHz).
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
#: FP32 operations per pair, counted from the CUDA sources: the distance
#: ladder (q - a, tri_record.cuh dist2 and the running min), one +axis
#: crossing test (sdf.cu crosses: its edges come from the record, and its
#: tail, "axis_tail", is needed only where the ray passes inside the
#: triangle), the normal-side dot product, the segment test (culled.cu
#: add_crossing), the parity hit test (parity.cu: the transverse offsets
#: and three edge functions of every pair, with ac - ab once per triangle;
#: its tail, "parity_tail", with the division and the bucket, only where the
#: line passes inside the triangle), and one sweep candidate (sweep.cu: the
#: same ladder on the candidate's record, with the merge's first compare in
#: place of the running min, and the square root; the per-triangle terms
#: come from the record).
FLOPS = {"ladder": 53, "axis": 13, "axis_tail": 10, "normal": 5,
         "segment": 43, "parity": 15, "parity_tail": 13,
         "sweep_candidate": 54}


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


def bound(flops, nbytes):
    """(bound ms, what bounds it) on one H100 at its published peaks."""
    t_ops, t_bytes = flops / PEAK_FP32, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), (
        "operations" if t_ops >= t_bytes else "bytes")


def fp32_peak() -> float:
    """SMs x 128 FP32 lanes x max SM clock (nvidia-smi), operations/s."""
    import torch

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True, timeout=60, check=True)
    mhz = float(out.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * 128 * mhz * 1e6


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


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


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
    from mesh_to_sdf_tpu_torch.ops.raycast import face_origins
    from mesh_to_sdf_tpu_torch.utils.meshgen import icosphere

    log(f"== path 6: generate_grid_sdf_streamed, icosphere({level}), "
        f"{cells}^3, slab {slab}, RAYCAST ({card})")
    verts, faces = icosphere(level)
    grid = tm.Grid.from_bounding_box([-1.1] * 3, [1.1] * 3, [cells] * 3)
    n, n_slabs = cells ** 3, cells // slab
    counters = (sweep.COUNT, parity.COUNT, parity.DENSE_COUNT,
                sdf_k.RECORDS_COUNT, sdf_k.RAYCAST_COUNT, sdf_k.NORMAL_COUNT)

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
                "records": sdf_k.RECORDS_COUNT.kernel}
    plain = sum(c.plain for c in counters)
    log(f"  launches: sweep {launches['sweep']} ({2 * n_slabs} slab passes "
        f"x 8), binned parity {launches['parity']} ({n_slabs} slabs x 3), "
        f"record packing {launches['records']}, other kernels "
        f"{sum(c.kernel for c in counters) - sum(launches.values())}; "
        f"plain-version calls {plain}")
    # Records: packed once for the prep, once per closest_point_grid.
    if (launches["sweep"] != 16 * n_slabs or launches["parity"] != 3 * n_slabs
            or launches["records"] != 2 * n_slabs + 1 or plain):
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

    # The kernels against their plain versions at the path's shapes.
    prep = next(iter(gs._STREAM_PREP_CACHE.values()))
    shapes = {}
    for i in hold_slabs:
        g = prep.slabs[i]
        ta, tb, tc = prep.tris
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
            b_s = bound(cells_slab * 18 * FLOPS["sweep_candidate"],
                        2 * sum(t.numel() * t.element_size() for t in state)
                        + prep.sweep_tris.rec.numel() * 4)
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    global PEAK_FP32
    t_start = time.perf_counter()
    card = card_line()
    log(card)
    PEAK_FP32 = fp32_peak()
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
    for c in (sweep.COUNT, parity.COUNT, sdf_k.RECORDS_COUNT):
        c.reset()
    t0 = time.perf_counter()
    sdf = run()
    t_cold = time.perf_counter() - t0
    launches = {"sweep": sweep.COUNT.kernel, "parity": parity.COUNT.kernel,
                "records": sdf_k.RECORDS_COUNT.kernel}
    plain_calls = (sweep.COUNT.plain + parity.COUNT.plain
                   + sdf_k.RECORDS_COUNT.plain)
    log(f"  launches: sweep {launches['sweep']} (6 directional sweeps of "
        f"256 slices each: {launches['sweep'] / 6:g} launch per sweep), "
        f"parity {launches['parity']}, record packing "
        f"{launches['records']}; plain-version calls {plain_calls}")
    if min(launches.values()) == 0 or plain_calls:
        raise AssertionError("main path did not run through the kernels")
    if launches["sweep"] != 6:
        raise AssertionError("the sweep launched other than once per "
                             "directional sweep")

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
        seed = cpt.seed_from_bins(g, tris[0], tris[1], tris[2], bins)
        state = cpt.sweep_state(g, seed)
        stris = sweep.sweep_tris(*tris)
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
        b_s = bound(cells ** 3 * 18 * FLOPS["sweep_candidate"],
                    2 * sum(t.numel() * t.element_size() for t in state)
                    + stris.rec.numel() * 4)
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
        return s_k, s_p, e_s, c_k, c_p, 0.0, b_s, b_p

    parity_rule = parity.parity_chunks
    log("== kernel times vs plain (CUDA events)")
    kernel_times(128)
    s_k, s_p, e_s, c_k, c_p, e_p, b_sweep, b_parity = kernel_times(256)
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
                sweep.COUNT)
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

    def drive_culled(engine):
        """The main path with counts at 0: cold call, checks, 3 warm
        calls. Returns (launches, cold s, warm median s, stats)."""
        os.environ["M2S_CULLED_ENGINE"] = engine
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
        plain_calls = sum(c.plain for c in counters)
        stats = dict(culling.LAST_CULLED_STATS)
        log(f"  {engine}: launches culled_blocks {n_launch}, sdf raycast "
            f"{sdf_k.RAYCAST_COUNT.kernel}, record packing {n_records} "
            f"(cold call: the engine's block-index table and one per "
            f"raycast call), dense parity "
            f"{parity.DENSE_COUNT.kernel}; plain-version calls {plain_calls}")
        log(f"  {engine}: LAST_CULLED_STATS {json.dumps(stats)}")
        if (n_launch == 0 or n_records == 0 or plain_calls
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
        return (n_launch, n_records), t_cold, t_warm, stats

    for cache in (query._SIGN_GRID_CACHE, query._PARITY_BINS_CACHE,
                  query._BLOCK_INDEX_CACHE, culling._ROUTE_CACHE):
        cache.clear()
    try:
        (launches_culled, launches_records), _, _, stats_gather = (
            drive_culled("gather"))

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

        (launches_union, _), _, _, _ = drive_culled("union")
    finally:
        os.environ.pop("M2S_CULLED_ENGINE", None)

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

    # The kernel against its plain version at every shape the path gave it,
    # and the union call without anchors (query_dist_culled_blocks).
    log("== culled kernel vs plain at the path's shapes (CUDA events)")
    bi8 = next(v for k, v in query._BLOCK_INDEX_CACHE.items()
               if k[3] == len(faces8))
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
    culled.culled_blocks = recording
    try:
        culling.query_dist_culled_blocks(qc, bi8)
    finally:
        culled.culled_blocks = culled_blocks
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
    log(f"  launches on the main path: gather {launches_culled}, union "
        f"{launches_union}")

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

    s_launch = streamed["launches"]
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
    ]
    kernel_rows[0]["streamed"] = on_slabs("sweep axis 0", s_launch["sweep"])
    kernel_rows[1]["streamed"] = on_slabs("parity axis 0",
                                          s_launch["parity"])
    print(json.dumps({"kernels": kernel_rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
