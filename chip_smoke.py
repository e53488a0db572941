#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (mesh_to_sdf_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the native host library and the CUDA kernels from this checkout,
checks each kernel against its plain PyTorch version on the card, drives the
main path (``generate_grid_sdf`` with the raycast sign on a 256³ grid around
``icosphere(5)``, 20 480 triangles) and checks its output against the
analytic sphere, then times it. Any failed phase raises, so the script exits
non-zero and prints no result. Its last two lines are one JSON object per
kernel run (name, route, source, launches on the main path, error against
the plain version, times) and ``{"ok": true, "device": {...}}``.

Exits non-zero without a CUDA device. Imports nothing of JAX.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: Distance tolerance kernel vs plain version (and index re-evaluation).
#: Both round every operation as written (-fmad=false, correctly rounded
#: sqrt), so they agree far inside it.
RTOL, ATOL = 2e-4, 1e-5


def log(msg: str) -> None:
    print(msg, flush=True)


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
    from mesh_to_sdf_tpu_torch.ops.kernels import _build, parity, sweep
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
    errs = {"sweep": 0.0, "parity": 0.0}

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

    def cuda_ms(fn, reps):
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

    log(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        f" GiB")
    print(json.dumps({"kernels": [
        {"name": "sweep_oriented", "route": "cuda",
         "source": "mesh_to_sdf_tpu_torch/csrc/sweep.cu",
         "replaces": "mesh_to_sdf_tpu/ops/kernels/pallas_sweep.py:142",
         "launches": launches["sweep"], "max_abs_err": errs["sweep"],
         "ms": s_k, "plain_ms": s_p},
        {"name": "line_parity_counts_binned", "route": "cuda",
         "source": "mesh_to_sdf_tpu_torch/csrc/parity.cu",
         "replaces": "mesh_to_sdf_tpu/ops/kernels/pallas_parity.py:449",
         "launches": launches["parity"], "max_abs_err": errs["parity"],
         "ms": c_k, "plain_ms": c_p},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
