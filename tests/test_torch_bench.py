"""bench_torch.py (the port's headline benchmark) on the CPU, against
bench.py.

- The whole script at shrunk workload sizes (``--device cpu``, with and
  without ``--quick``): one JSON line with bench.py's keys, metric name and
  extra names, no failed workload but the primary's roofline (AUTO takes
  XLA for small grids on the CPU), the repeat counts in ``timing_stats``.
- The roofline helper on a CPT prep made on the CPU.
- The inputs are bench.py's: both scripts' ``main`` at full size with the
  entry points, the mesh generator and the baseline binary replaced by
  recorders, every recorded argument equal bit for bit (bench.py imports
  JAX only inside its functions); ``_query_grid`` bit-equal to bench.py's;
  the baseline binary reads the port's ``Grid`` as it reads the JAX one.
- With ``jax``, ``jaxlib`` and ``mesh_to_sdf_tpu`` blocked, in a
  subprocess; and without a card, where the default device is CUDA: a
  non-zero exit with the CLI's message and no JSON.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import bench  # noqa: E402
import bench_torch  # noqa: E402
import mesh_to_sdf_tpu as jm  # noqa: E402
import mesh_to_sdf_tpu_torch as tm  # noqa: E402
from mesh_to_sdf_tpu import gridgen_streamed as jgs  # noqa: E402
from mesh_to_sdf_tpu.utils import baseline as jbl  # noqa: E402
from mesh_to_sdf_tpu.utils import meshgen as jmeshgen  # noqa: E402
from mesh_to_sdf_tpu_torch import gridgen, gridgen_streamed  # noqa: E402
from mesh_to_sdf_tpu_torch.utils import baseline as bl  # noqa: E402
from mesh_to_sdf_tpu_torch.utils import roofline  # noqa: E402
from mesh_to_sdf_tpu_torch.utils.meshgen import icosphere  # noqa: E402

#: bench.py's keys and extra names without the reference assets, as
#: bench_torch.py states them (held against bench.py's own line in
#: test_inputs_match_bench_py).
BENCH_EXTRA = bench_torch.BENCH_EXTRA
BENCH_KEYS = bench_torch.BENCH_KEYS
#: The shrunk workload: icosphere(2) at 16³, 2 000 queries, CULLED on
#: icosphere(3), the streamed grid at 32³.
SMALL = {"CELLS": 16, "QUICK_CELLS": 16, "SUBDIV": 2, "N_QUERIES": 2000,
         "CULLED_SUBDIV": 3, "STREAMED_CELLS": 32, "BASELINE_QUERIES": 1000}
#: Smaller still, for the run in a subprocess.
TINY = dict(SMALL, N_QUERIES=500, CULLED_SUBDIV=2, STREAMED_CELLS=16,
            BASELINE_QUERIES=200)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per worker (see tests/test_torch_autodiff.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def small(monkeypatch):
    for name, value in SMALL.items():
        monkeypatch.setattr(bench_torch, name, value)


def _errors(value, path=""):
    """The ``"error: ..."`` strings anywhere in ``value``, by path."""
    if isinstance(value, dict):
        return [e for k, v in value.items() for e in _errors(v, f"{path}/{k}")]
    if isinstance(value, str) and value.startswith("error:"):
        return [f"{path}: {value}"]
    return []


@pytest.mark.parametrize("quick", [False, True])
def test_bench_runs_on_cpu(small, capsys, quick):
    argv = ["--device", "cpu"] + (["--quick"] if quick else [])
    result = bench_torch.main(argv)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == result
    assert set(result) == BENCH_KEYS
    assert result["metric"] == "grid_cells_per_s_16^3_raycast"
    assert result["unit"] == "cells/s" and result["value"] > 0
    assert result["vs_baseline"] == round(
        result["value"] / bench_torch.BASELINE_CELLS_PER_S, 3)
    extra = result["extra"]
    assert extra["card"] == "no card: cpu"
    has_baseline = bl.available(build=True)
    want = {"roofline_primary_grid", "timing_stats"}
    if not quick:
        want = BENCH_EXTRA - (set() if has_baseline
                              else {"vs_1core_grid_measured"})
    assert set(extra) == want | {"card"}
    # On the CPU AUTO sends a 16³ grid to XLA: the roofline says so.
    assert extra["roofline_primary_grid"] == (
        "error: RuntimeError: AUTO took xla, not cpt")
    assert _errors({k: v for k, v in extra.items()
                    if k != "roofline_primary_grid"}) == []
    stats = extra["timing_stats"]
    assert stats["primary_grid"]["n"] == (3 if quick else 5)
    for s in stats.values():
        assert s["min_s"] <= s["median_s"] <= s["max_s"]
    if quick:
        return
    assert set(stats) == {"primary_grid", "queries_per_s_1M_20k_pallas",
                          "sdf_1.3M_tris_1M_scattered_culled"}
    assert stats["queries_per_s_1M_20k_pallas"]["n"] == 3
    assert stats["sdf_1.3M_tris_1M_scattered_culled"]["n"] == 3
    assert extra["queries_per_s_1M_20k_pallas"]["queries_per_s"] > 0
    culled = extra["sdf_1.3M_tris_1M_scattered_culled"]
    assert culled["tris"] == 1280 and culled["queries_per_s"] > 0
    streamed = extra["streamed_grid_512^3_raycast"]
    assert streamed["cells_per_s"] > 0
    if not has_baseline:
        assert extra["baseline_1core_measured"] == "binary unavailable"
        return
    one_core = extra["baseline_1core_measured"]["grid_16^3_cells_per_s_1core"]
    assert one_core > 0 and culled["qps_1core_measured"] > 0
    assert extra["vs_1core_grid_measured"] == round(result["value"]
                                                    / one_core, 2)


def test_grid_work_counts_the_timed_prep(monkeypatch):
    """The primary's roofline work comes from the prep of the call it
    looks up (by that call's key): a CPT call on the CPU."""
    verts, faces = icosphere(2)
    topo = tm.Topology.triangle_list(faces.reshape(-1))
    grid = tm.Grid.from_bounding_box([-1.1] * 3, [1.1] * 3, [16] * 3)
    monkeypatch.setattr(gridgen, "_CPT_PREP_CACHE", {})
    tm.generate_grid_sdf(verts, topo, grid, strategy=tm.Strategy.CPT,
                         device="cpu")
    other = tm.Grid.from_bounding_box([-1.1] * 3, [1.1] * 3, [24] * 3)
    tm.generate_grid_sdf(verts, topo, other, strategy=tm.Strategy.CPT,
                         device="cpu")
    (tris, seeds, lines), _ = gridgen._CPT_PREP_CACHE.values()
    want = roofline.grid_total_flops(16 ** 3, seeds, lines,
                                     n_tris=tris.shape[1])
    got = bench_torch.grid_work(torch.from_numpy(verts), topo, grid,
                                torch.device("cpu"))
    assert got == want and want["flops"] > 0 and want["hbm_bytes"] > 0
    with pytest.raises(LookupError):
        bench_torch.grid_work(verts, topo, grid, torch.device("cuda", 0))
    with pytest.raises(LookupError):
        bench_torch.grid_work(verts * np.float32(1.5), topo, grid,
                              torch.device("cpu"))
    acc = roofline.account(1e-5, **got, peak_flops=roofline.FP32_PEAK_H100)
    assert acc["pct_fp32_peak"] > 0 and acc["pct_hbm_peak"] > 0
    assert acc["bound"] in ("latency", "compute", "bandwidth")


def test_query_grid_matches_bench_py():
    rng = np.random.default_rng(11)
    verts = rng.uniform(-2.0, 3.0, (500, 3)).astype(np.float32)
    for radius, scale in ((0.25, 1.0), (0.1, 1.5), (10.0, 1.0)):
        got = bench_torch._query_grid(verts, radius, scale)
        want = bench._query_grid(verts, radius, scale)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))


def _as_np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _grid_fields(grid):
    """A grid as the baseline binary reads it (`utils/baseline.py`)."""
    return (np.asarray(grid.first_cell, np.float32).tobytes(),
            np.asarray(grid.cell_size, np.float32).tobytes(),
            np.asarray(grid.cell_count, np.uint32).tobytes())


def _recorders(calls, mesh, to_out):
    """Stand-ins for the entry points, the mesh generator and the baseline
    binary that append their arguments to ``calls``; ``to_out`` turns a
    numpy result into the package's."""
    inside = np.where(np.arange(1000) < 393, -1.0, 1.0).astype(np.float32)

    def ico(subdiv=2, **_):
        calls.append(("icosphere", subdiv))
        return mesh

    def grid_sdf(vertices, topology, grid, sign_method, **kw):
        calls.append(("generate_grid_sdf", _as_np(vertices),
                      topology.kind, topology.indices, _grid_fields(grid),
                      sign_method.name, sorted(kw)))
        return to_out(inside)

    def sdf(vertices, topology, query, acceleration, *, sign_method, **kw):
        calls.append(("generate_sdf", _as_np(vertices), topology.kind,
                      topology.indices, _as_np(query), acceleration.name,
                      sign_method.name, sorted(kw)))
        return to_out(np.zeros(len(query), np.float32))

    def streamed(vertices, faces, grid, sign_method, **kw):
        calls.append(("generate_grid_sdf_streamed", _as_np(vertices),
                      _as_np(faces), _grid_fields(grid), sign_method.name,
                      sorted(kw)))
        return to_out(inside)

    def run_grid(ta, tb, tc, grid):
        calls.append(("run_grid", ta, tb, tc, _grid_fields(grid)))
        return {"cells_per_s": 1.0}

    def run_query(ta, tb, tc, queries):
        calls.append(("run_query", ta, tb, tc, queries))
        return {"queries_per_s": 1.0}

    return ico, grid_sdf, sdf, streamed, run_grid, run_query


def _same(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (a.dtype == b.dtype and a.shape == b.shape
                and np.array_equal(a, b))
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("quick", [False, True])
def test_inputs_match_bench_py(monkeypatch, capsys, quick):
    """Both mains at full size, every entry point recorded: the same calls
    with the same inputs bit for bit, and the same line keys."""
    mesh = icosphere(2)
    jcalls, pcalls = [], []
    ico, grid_sdf, sdf, streamed, run_grid, run_query = _recorders(
        jcalls, mesh, lambda a: a)
    monkeypatch.setattr(jmeshgen, "icosphere", ico)
    monkeypatch.setattr(jm, "generate_grid_sdf", grid_sdf)
    monkeypatch.setattr(jm, "generate_sdf", sdf)
    monkeypatch.setattr(jgs, "generate_grid_sdf_streamed", streamed)
    monkeypatch.setattr(jbl, "available", lambda build=None: True)
    monkeypatch.setattr(jbl, "run_grid", run_grid)
    monkeypatch.setattr(jbl, "run_query", run_query)
    monkeypatch.setattr(sys, "argv", ["bench.py"] + (["--quick"] if quick
                                                     else []))
    bench.main()
    jline = json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    ico, grid_sdf, sdf, streamed, run_grid, run_query = _recorders(
        pcalls, mesh, torch.from_numpy)
    monkeypatch.setattr(bench_torch, "icosphere", ico)
    monkeypatch.setattr(tm, "generate_grid_sdf", grid_sdf)
    monkeypatch.setattr(tm, "generate_sdf", sdf)
    monkeypatch.setattr(gridgen_streamed, "generate_grid_sdf_streamed",
                        streamed)
    monkeypatch.setattr(bl, "available", lambda build=None: True)
    monkeypatch.setattr(bl, "run_grid", run_grid)
    monkeypatch.setattr(bl, "run_query", run_query)
    pline = bench_torch.main(["--device", "cpu"]
                             + (["--quick"] if quick else []))

    assert [c[0] for c in pcalls] == [c[0] for c in jcalls]
    for pc, jc in zip(pcalls, jcalls):
        assert len(pc) == len(jc)
        for i, (p, j) in enumerate(zip(pc, jc)):
            assert _same(p, j), (pc[0], i)
    assert set(pline) == set(jline) == BENCH_KEYS
    assert pline["metric"] == jline["metric"] == (
        f"grid_cells_per_s_{128 if quick else 256}^3_raycast")
    assert set(pline["extra"]) == set(jline["extra"]) | {"card"}
    if not quick:
        assert set(jline["extra"]) == BENCH_EXTRA
        names = {"icosphere", "generate_grid_sdf", "generate_sdf",
                 "generate_grid_sdf_streamed", "run_grid", "run_query"}
        assert {c[0] for c in pcalls} == names
        assert pline["extra"]["baseline_1core_measured"] == (
            jline["extra"]["baseline_1core_measured"])


def test_baseline_reads_the_port_grid():
    """The 1-core binary gives the same result on the port's Grid (torch
    tensors) as on the JAX package's."""
    if not bl.available(build=True):
        pytest.skip("baseline binary unavailable")
    verts, faces = icosphere(2)
    tris = (verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]])
    lo, hi, counts = [-1.1, -1.2, -1.3], [1.1, 1.2, 1.05], [12, 10, 9]
    pg = tm.Grid.from_bounding_box(lo, hi, counts)
    jg = jm.Grid.from_bounding_box(lo, hi, counts)
    assert _grid_fields(pg) == _grid_fields(jg)
    got, want = bl.run_grid(*tris, pg), jbl.run_grid(*tris, jg)
    assert got["cells"] == want["cells"] == 12 * 10 * 9
    assert got["checksum"] == want["checksum"]


def test_bench_imports_no_jax():
    """bench_torch runs with jax, jaxlib, mesh_to_sdf_tpu and bench.py
    blocked."""
    code = f"""
import json, sys
for name in ("jax", "jaxlib", "mesh_to_sdf_tpu", "bench"):
    sys.modules[name] = None
sys.path.insert(0, {str(ROOT)!r})
import bench_torch
for name, value in {TINY!r}.items():
    setattr(bench_torch, name, value)
out = bench_torch.main(["--device", "cpu"])
assert out["extra"]["queries_per_s_1M_20k_pallas"]["queries_per_s"] > 0
print("OK", sorted(out["extra"]))
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env=dict(os.environ, OMP_NUM_THREADS="1"),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1].startswith("OK")


def test_no_card_exits_with_the_cli_message():
    """The default device is CUDA: without a card the script exits
    non-zero with the CLI's message and prints no result."""
    proc = subprocess.run([sys.executable, str(ROOT / "bench_torch.py")],
                          cwd=ROOT,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "error: no CUDA device" in proc.stderr
    assert proc.stdout.strip() == ""


def test_card_line_reads_nvidia_smi(monkeypatch):
    """``extra["card"]`` on a card: nvidia-smi's first name and power-limit
    line."""
    seen = []

    def run(args, **kw):
        seen.append(args)
        return subprocess.CompletedProcess(
            args, 0, stdout="NVIDIA H100 80GB HBM3, 700.00 W\nother, 1 W\n")

    monkeypatch.setattr(roofline.subprocess, "run", run)
    assert roofline.card_line() == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert seen == [["nvidia-smi", "--query-gpu=name,power.limit",
                     "--format=csv,noheader"]]
