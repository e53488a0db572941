"""Fixtures of the benchmark's own tests: a tiny benchmark beside the real
one (its own ``BENCHMARK.json``, configurations and mixes, the real
metric readers), small enough for the CPU."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

BENCH = ROOT / "benchmark"

TINY_GRID = {
    "name": "tiny_grid", "mesh": {"kind": "icosphere", "subdiv": 2},
    "entry": "grid",
    "args": {"grid": {"lo": [-1.2] * 3, "hi": [1.2] * 3,
                      "cells": [20, 20, 20]}, "sign_method": "raycast"},
    "route": {"strategy": "CPT", "min_launches_per_call": {}},
    "precision": "float32",
    "guarantee": {"kind": "cpt_contract", "undershoot_max": 1e-5,
                  "band_cells": 1.5, "band_err_max": 1e-5,
                  "far_rel_max": 0.02, "sign_flips_max": 0,
                  "surface_eps": 1e-5},
    "check": {"calls": 2, "samples": 2048},
}
TINY_QUERY = {
    "name": "tiny_query", "mesh": {"kind": "icosphere", "subdiv": 3},
    "entry": "query", "args": {"sign_method": "raycast"},
    "route": {"strategy": "CULLED", "min_launches_per_call": {}},
    "precision": "float32",
    "guarantee": {"kind": "exact", "dist_err_max": 1e-5,
                  "sign_flips_max": 0, "surface_eps": 1e-5},
    "check": {"calls": 2, "samples": 1024},
}
TINY_NEAR = {"mesh": {"per_call": "same", "vertices": "host"},
             "points": {"count": 3000, "pool": 3, "components": [
                 {"kind": "surface_gaussian", "share": 0.47,
                  "variance": 0.005},
                 {"kind": "surface_gaussian", "share": 0.47,
                  "variance": 0.0005},
                 {"kind": "uniform_box", "share": 0.06,
                  "lo": [-1.0] * 3, "hi": [1.0] * 3}]},
             "output": "device"}
TINY_NEW = {"mesh": {"per_call": "new", "scale": [0.85, 1.0],
                     "meshes_per_second": 200, "warm_meshes": 2},
            "output": "host"}


def _metric(name, unit, cells, **kw):
    return {"name": name, "unit": unit, "better": "lower", "source":
            "host_clock", "workloads": cells, **kw}


def write_tiny(root: Path) -> Path:
    """A tiny benchmark at ``root``: a copy of the real one's metric
    readers, two configurations, two mixes, three cells."""
    bench = root / "benchmark"
    shutil.copytree(BENCH / "metrics", bench / "metrics")
    (bench / "configs").mkdir(parents=True)
    (bench / "traffic").mkdir()
    for cfg in (TINY_GRID, TINY_QUERY):
        (bench / "configs" / f"{cfg['name']}.json").write_text(
            json.dumps(cfg))
    (bench / "traffic" / "same_mesh.json").write_text(
        (BENCH / "traffic" / "same_mesh.json").read_text())
    (bench / "traffic" / "tiny_new.json").write_text(json.dumps(TINY_NEW))
    (bench / "traffic" / "tiny_near.json").write_text(json.dumps(TINY_NEAR))
    grids = ["tiny_grid.same_mesh", "tiny_grid.tiny_new"]
    manifest = {
        "command": ["python3", "benchmark/run.py"], "paths": ["benchmark"],
        "run_seconds": 1,
        "configs": [{"name": c["name"], "source": "https://example.org/x",
                     "file": f"benchmark/configs/{c['name']}.json",
                     "reduced": [], "why": "tiny"}
                    for c in (TINY_GRID, TINY_QUERY)],
        "workloads": [
            {"name": "tiny_grid.same_mesh", "config": "tiny_grid",
             "traffic": "same_mesh", "chips": 1, "why": "tiny"},
            {"name": "tiny_grid.tiny_new", "config": "tiny_grid",
             "traffic": "tiny_new", "chips": 1, "why": "tiny"},
            {"name": "tiny_query.tiny_near", "config": "tiny_query",
             "traffic": "tiny_near", "chips": 1, "why": "tiny"}],
        "end_to_end": [
            {"name": "setup_s", "unit": "s", "better": "lower",
             "bound": 0.25, "source": "host_clock"},
            {**_metric("cells_per_s", "cells/s", grids), "bound": 0.05,
             "better": "higher"},
            {**_metric("queries_per_s", "queries/s",
                       ["tiny_query.tiny_near"]), "bound": 0.05,
             "better": "higher"},
            {**_metric("call_p95_ms", "ms", grids), "bound": 0.05}],
        "per_layer": [
            _metric("host_prep_ms.grid", "ms", grids,
                    layer="host prep", moves="cells_per_s"),
            _metric("flag_pct.query", "%", ["tiny_query.tiny_near"],
                    layer="certificate", moves="queries_per_s")],
    }
    for m in manifest["per_layer"]:
        m["source"] = "program_span"
    (root / "BENCHMARK.json").write_text(json.dumps(manifest, indent=1))
    return bench


@pytest.fixture
def tiny(tmp_path):
    """(root, benchmark dir) of a fresh tiny benchmark."""
    return tmp_path, write_tiny(tmp_path)
