#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (mesh_to_sdf_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the native host library and the CUDA kernels from this checkout,
checks each kernel against its plain PyTorch version on the card, and drives
three paths on ``icosphere(5)`` (20 480 triangles), each checked against the
analytic sphere and timed:

- ``generate_grid_sdf`` with the raycast sign on a 256³ grid (AUTO, which
  takes the CPT route: sweep and binned parity kernels);
- ``generate_sdf`` through ``Strategy.PALLAS`` at 1 000 000 queries, both
  sign methods (the fused raycast and normal kernels);
- ``generate_grid_sdf`` through ``Strategy.PALLAS`` at 128³ (the raycast
  kernel for distances, the dense parity kernel for the sign), also held
  against the CPT route on the same grid; its times give the AUTO cost
  model's ``"cuda"`` constants.

Any failed phase raises, so the script exits non-zero and prints no result.
Its last two lines are one JSON object with a row per kernel (name, route,
source, launches on its path, error against the plain version, times) and
``{"ok": true, "device": {...}}``.

Exits non-zero without a CUDA device. Imports nothing of JAX.
"""
from __future__ import annotations

import json
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


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    log(card)
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

    dev = torch.device("cuda")
    errs = {"sweep": 0.0, "parity": 0.0, "dense": 0.0, "raycast": 0.0,
            "normal": 0.0}

    def prep(verts, faces, lo, hi, shape):
        grid = tm.Grid.from_bounding_box(lo, hi, shape)
        v = verts[faces]
        tris, bins, line_bins = gridgen._cpt_prep(
            grid, v[:, 0], v[:, 1], v[:, 2], dev)
        return grid, tris, bins, line_bins

    def oriented_centers(grid, comps, shape):
        """World x, y, z of every cell of a sweep-axis-first volume."""
        out = [None, None, None]
        for dim, comp in enumerate(comps):
            c = grid.axis_centers(comp, dev)
            view = [1, 1, 1]
            view[dim] = -1
            out[comp] = c.reshape(view).expand(shape)
        return out

    def check_state(got, want, grid, comps, what):
        """Distances within tolerance; where ids differ (ties), each
        side's carried triangle must achieve its distance at the cell."""
        err = 0.0
        n_diff = 0
        centers = oriented_centers(grid, comps, tuple(got[0].shape))
        for k in (0, 3):
            d, v, i = got[k], got[k + 1], got[k + 2]
            dw, vw, iw = want[k], want[k + 1], want[k + 2]
            torch.testing.assert_close(d, dw, rtol=RTOL, atol=ATOL)
            err = max(err, float((d - dw).abs().max()))
            differ = (i != iw) & (i >= 0) & (iw >= 0)
            n_diff += int(differ.sum())
            for dd, vv in ((d, v), (dw, vw)):
                d_re = sweep._pt_dist(*centers, vv.transpose(0, 1))
                torch.testing.assert_close(d_re[differ], dd[differ],
                                           rtol=RTOL, atol=ATOL)
        log(f"  {what}: max |kernel - plain| {err:.3e}, "
            f"tie-broken ids {n_diff}")
        return err

    # ----------------------------------------------- kernels vs plain: sweep
    log("== sweep kernel vs plain")
    for verts, faces, lo, hi, shape in (
        (*icosphere(3), [-1.3] * 3, [1.3] * 3, [48, 40, 36]),
        (*icosphere(3), [-1.3] * 3, [1.3] * 3, [64, 64, 64]),
    ):
        grid, tris, bins, _ = prep(verts, faces, lo, hi, shape)
        seed = cpt.seed_from_bins(grid, tris[0], tris[1], tris[2], bins)
        # Directional sweeps from the seeded state, in the orchestration's
        # order; each direction starts from the kernel's previous result.
        state = cpt.sweep_state(grid, tris[0], tris[1], tris[2], seed)
        for axis in (0, 1, 2):
            if axis:
                state = cpt._relayout(state, cpt._PERM3[axis],
                                      cpt._PERM4[axis])
            comps = cpt._COMPS[axis]
            for rev in (False, True):
                want = sweep.sweep_oriented_plain(
                    *[t.clone() for t in state], rev, grid.first_cell,
                    grid.cell_size, comp0=comps[0], comp1=comps[1],
                    comp2=comps[2])
                got = sweep.sweep_oriented(
                    *[t.clone() for t in state], rev, grid.first_cell,
                    grid.cell_size, comp0=comps[0], comp1=comps[1],
                    comp2=comps[2])
                torch.cuda.synchronize()
                errs["sweep"] = max(errs["sweep"], check_state(
                    got, want, grid, comps,
                    f"{tuple(shape)} axis {axis} reverse {rev}"))
                state = list(got)
            if axis:
                state = cpt._relayout(state, cpt._INV3[axis],
                                      cpt._INV4[axis])
        # The whole Gauss-Seidel orchestration: kernel (CUDA tensors) vs the
        # plain version (the same call on CPU tensors).
        rounds = 2 if max(shape) <= 128 else 1
        d_k, i_k = cpt.closest_point_grid(grid, tris[0], tris[1], tris[2],
                                          seed=seed, rounds=rounds)
        d_p, i_p = cpt.closest_point_grid(
            grid, *(t.cpu() for t in tris), seed=[s.cpu() for s in seed],
            rounds=rounds)
        torch.cuda.synchronize()
        torch.testing.assert_close(d_k.cpu(), d_p, rtol=RTOL, atol=ATOL)
        err = float((d_k.cpu() - d_p).abs().max())
        errs["sweep"] = max(errs["sweep"], err)
        log(f"  closest_point_grid {tuple(shape)} rounds {rounds}: max "
            f"|kernel - plain| {err:.3e}, ids equal "
            f"{float((i_k.cpu() == i_p).float().mean()):.6f}")

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
            torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL)
            err = max(err, float((g - w).abs().max()))
        signs_equal = torch.equal(
            torch.signbit(sdf_k.sdf_normal(q64k, *tris)),
            torch.signbit(combine_champions(*map(sqrt_f32, want))))
        if not signs_equal:
            raise AssertionError(f"normal signs differ: {name}")
        errs["normal"] = max(errs["normal"], err)
        log(f"  normal {name}: max |kernel - plain| d2 {err:.3e}, signs "
            f"equal")

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
    sweep.COUNT.reset()
    parity.COUNT.reset()
    t0 = time.perf_counter()
    sdf = run()
    t_cold = time.perf_counter() - t0
    launches = {"sweep": sweep.COUNT.kernel, "parity": parity.COUNT.kernel}
    plain_calls = sweep.COUNT.plain + parity.COUNT.plain
    log(f"  launches: sweep {launches['sweep']} calls, parity "
        f"{launches['parity']} calls; plain-version calls {plain_calls}")
    if min(launches.values()) == 0 or plain_calls:
        raise AssertionError("main path did not run through the kernels")

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
    try:
        t0 = time.perf_counter()
        run()
        t_one = time.perf_counter() - t0
    finally:
        for (module, name), fn in originals.items():
            setattr(module, name, fn)
    stage = {k: s.elapsed_time(e) for k, (s, e) in events.items()}
    log(f"  one warm call {t_one * 1e3:.2f} ms: seed {stage['seed']:.2f} ms, "
        f"sweeps {stage['sweeps']:.2f} ms, parity {stage['parity']:.2f} ms")

    def kernel_times(cells):
        """(sweep ms, plain ms, parity ms, plain ms) for one +x sweep and
        one +x parity axis of icosphere(5) at cells³."""
        g, tris, bins, line_bins = prep(verts, faces, [-1.1] * 3, [1.1] * 3,
                                        [cells] * 3)
        seed = cpt.seed_from_bins(g, tris[0], tris[1], tris[2], bins)
        state = cpt.sweep_state(g, tris[0], tris[1], tris[2], seed)
        kw = dict(comp0=0, comp1=1, comp2=2)
        work = [t.clone() for t in state]

        def k_sweep():
            for dst, src in zip(work, state):
                dst.copy_(src)
            sweep.sweep_oriented(*work, False, g.first_cell, g.cell_size,
                                 **kw)

        def p_sweep():
            for dst, src in zip(work, state):
                dst.copy_(src)
            sweep.sweep_oriented_plain(*work, False, g.first_cell,
                                       g.cell_size, **kw)

        copy_ms = cuda_ms(lambda: [d.copy_(s) for d, s in zip(work, state)],
                          5)
        s_k = cuda_ms(k_sweep, 5) - copy_ms
        s_p = cuda_ms(p_sweep, 2) - copy_ms
        # Same inputs, so the same answer: check it at this shape too.
        want = sweep.sweep_oriented_plain(*[t.clone() for t in state], False,
                                          g.first_cell, g.cell_size, **kw)
        got = sweep.sweep_oriented(*[t.clone() for t in state], False,
                                   g.first_cell, g.cell_size, **kw)
        e_s = check_state(got, want, g, (0, 1, 2), f"sweep {cells}^3 +x")
        args, pkw = parity_inputs(g, line_bins, 0)
        c_k = cuda_ms(lambda: parity.line_parity_counts_binned(*args, **pkw),
                      5)
        c_p = cuda_ms(
            lambda: parity.line_parity_counts_binned_plain(*args, **pkw), 2)
        got_c, _ = parity.line_parity_counts_binned(*args, **pkw)
        want_c, _ = parity.line_parity_counts_binned_plain(*args, **pkw)
        e_p = int((got_c - want_c).abs().max())
        if e_p:
            raise AssertionError(f"parity kernel disagrees at {cells}^3")
        log(f"  {cells}^3 one +x sweep: kernel {s_k:.3f} ms, plain "
            f"{s_p:.3f} ms; one +x parity axis: kernel {c_k:.3f} ms, "
            f"plain {c_p:.3f} ms")
        return s_k, s_p, e_s, c_k, c_p, float(e_p)

    log("== kernel times vs plain (CUDA events)")
    kernel_times(128)
    s_k, s_p, e_s, c_k, c_p, e_p = kernel_times(256)
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
        parity.DENSE_COUNT.reset()
        out = run_q()
        launches_q[sign] = count.kernel
        plain_calls = (sdf_k.RAYCAST_COUNT.plain + sdf_k.NORMAL_COUNT.plain
                       + parity.DENSE_COUNT.plain)
        log(f"  {sign.name}: kernel launches {count.kernel}, plain-version "
            f"calls {plain_calls}")
        if count.kernel == 0 or plain_calls:
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
        t_cold, times = warm_times(run_q)
        t_q = statistics.median(times)
        log(f"  {sign.name}: cold call {t_cold:.4f} s; warm calls "
            f"{', '.join(f'{t:.4f}' for t in times)} s; median "
            f"{t_q:.4f} s = {1e6 / t_q:.4e} queries/s")

    # Device time by kernel inside one warm RAYCAST call.
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tm.generate_sdf(verts, topo, q1m, tm.Strategy.PALLAS)
        torch.cuda.synchronize()
        t_prof = time.perf_counter() - t0
    def self_device_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

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
    for c in (sdf_k.RAYCAST_COUNT, sdf_k.NORMAL_COUNT, parity.DENSE_COUNT,
              parity.COUNT, sweep.COUNT):
        c.reset()
    dense = run_grid(tm.Strategy.PALLAS)
    launches_grid = {"raycast": sdf_k.RAYCAST_COUNT.kernel,
                     "dense": parity.DENSE_COUNT.kernel}
    plain_calls = sum(c.plain for c in (sdf_k.RAYCAST_COUNT, sdf_k.NORMAL_COUNT,
                                        parity.DENSE_COUNT))
    log(f"  launches: sdf raycast {launches_grid['raycast']}, dense parity "
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

    # ------------------- new kernels vs plain at the paths' shapes, and times
    log("== sdf kernels vs plain at the paths' shapes (CUDA events)")
    ra, rb, rc = soup5
    centers128 = grid128.all_cell_centers(dev).reshape(-1, 3)

    def plain_once(fn):
        """(result, device ms) of one call of a plain version."""
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end)

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
        k_ms[key] = (ms_1m, plain_1m)
        log(f"  {key}: 1M kernel {ms_1m:.3f} ms "
            f"({1e6 * len(faces5) / (ms_1m / 1e3):.4e} pairs/s), plain "
            f"{plain_1m:.1f} ms; 65,536: kernel {ms_64k:.3f} ms, plain "
            f"{plain_64k:.3f} ms")
    plain_grid = hold("raycast", centers128, 0,
                      "axes 0 at path 3's 128^3 cell centres")
    ms_grid = cuda_ms(lambda: sdf_k.raycast_raw(
        centers128, ra, rb, rc, raycast_axes=0), 3)
    log(f"  raycast, axes 0, at the 128^3 cell centres: kernel "
        f"{ms_grid:.3f} ms, plain {plain_grid:.1f} ms")
    for cells in (128, 256):
        g = tm.Grid.from_bounding_box([-1.1] * 3, [1.1] * 3, [cells] * 3)
        origins, _ = face_origins(g, 0, dev)
        dargs = (origins[:, 1].contiguous(), origins[:, 2].contiguous(),
                 g.first_cell[0], g.cell_size[0],
                 parity.rotate_planes(ra, rb, rc, 0))
        d_k = cuda_ms(lambda: parity.line_parity_counts(
            *dargs, n_cells=cells), 5)
        d_p = cuda_ms(lambda: parity.line_parity_counts_plain(
            *dargs, n_cells=cells), 2)
        got, _ = parity.line_parity_counts(*dargs, n_cells=cells)
        want, _ = parity.line_parity_counts_plain(*dargs, n_cells=cells)
        if not torch.equal(got, want):
            raise AssertionError(f"dense parity kernel disagrees at {cells}^3")
        k_ms["dense"] = (d_k, d_p)
        log(f"  {cells}^3 one +x dense parity axis: kernel {d_k:.3f} ms, "
            f"plain {d_p:.3f} ms")

    log(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        f" GiB")
    src = "mesh_to_sdf_tpu_torch/csrc/"
    print(json.dumps({"kernels": [
        {"name": "sweep_oriented", "route": "cuda",
         "source": src + "sweep.cu",
         "replaces": "mesh_to_sdf_tpu/ops/kernels/pallas_sweep.py:142",
         "launches": launches["sweep"], "max_abs_err": errs["sweep"],
         "ms": s_k, "plain_ms": s_p},
        {"name": "line_parity_counts_binned", "route": "cuda",
         "source": src + "parity.cu",
         "replaces": "mesh_to_sdf_tpu/ops/kernels/pallas_parity.py:449",
         "launches": launches["parity"], "max_abs_err": errs["parity"],
         "ms": c_k, "plain_ms": c_p},
        {"name": "line_parity_counts", "route": "cuda",
         "source": src + "parity.cu",
         "replaces": "mesh_to_sdf_tpu/ops/kernels/pallas_parity.py:49",
         "launches": launches_grid["dense"], "max_abs_err": errs["dense"],
         "ms": k_ms["dense"][0], "plain_ms": k_ms["dense"][1]},
        {"name": "sdf_raycast", "route": "cuda", "source": src + "sdf.cu",
         "replaces": "mesh_to_sdf_tpu/ops/kernels/pallas_sdf.py:202",
         "launches": launches_q[tm.SignMethod.RAYCAST],
         "max_abs_err": errs["raycast"],
         "ms": k_ms["raycast"][0], "plain_ms": k_ms["raycast"][1]},
        {"name": "sdf_normal", "route": "cuda", "source": src + "sdf.cu",
         "replaces": "mesh_to_sdf_tpu/ops/kernels/pallas_sdf.py:241",
         "launches": launches_q[tm.SignMethod.NORMAL],
         "max_abs_err": errs["normal"],
         "ms": k_ms["normal"][0], "plain_ms": k_ms["normal"][1]},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
