"""Whole runs of tiny cells on the CPU, the card's builds and route
checks skipped: a clean run is correct; the control and each fault the
cells can have (an answer altered where it is produced, a sign flipped)
come out not correct; and a configuration, a mix and a metric added as
files are found by name with no edit to a file already there."""
import hashlib
import json
import time

import pytest
import torch

import mesh_to_sdf_tpu_torch as tm
from benchmark.harness import cell as run
from benchmark.harness import manifest

CELLS = ["tiny_grid.same_mesh", "tiny_grid.tiny_new",
         "tiny_query.tiny_near"]


def _run(root, bench, name, trace=False, **kw):
    c = manifest.find_cell(manifest.load(root), name, bench)
    return run.run_cell(c, 2**31 + 99, 0.3, trace, t0=time.perf_counter(),
                        device="cpu", on_card=False, **kw)


@pytest.mark.parametrize("name", CELLS)
def test_clean_run_is_correct(tiny, name):
    r = _run(*tiny, name)
    assert r["correct"], r["check"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert list(r)[-1] == "check"
    assert "setup_s" in r["metrics"]
    assert ("cells_per_s" in r["metrics"]) != (
        "queries_per_s" in r["metrics"])


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(tiny, name):
    r = _run(*tiny, name, control=True)
    assert not r["correct"], r["check"]


def _altered(fn, how):
    def broken(*args, **kwargs):
        out = fn(*args, **kwargs).clone()
        flat = out.view(-1)
        if how == "offset":
            flat[::100] += 0.01
        else:
            flat[::100] *= -1.0
        return out
    return broken


@pytest.mark.parametrize("how", ["offset", "sign"])
@pytest.mark.parametrize("name", CELLS)
def test_altered_answers_are_not_correct(tiny, monkeypatch, name, how):
    for entry in ("generate_grid_sdf", "generate_sdf"):
        monkeypatch.setattr(tm, entry, _altered(getattr(tm, entry), how))
    r = _run(*tiny, name)
    assert not r["correct"], r["check"]


def test_a_failing_call_is_not_correct(tiny, monkeypatch):
    root, bench = tiny
    c = manifest.find_cell(manifest.load(root), "tiny_grid.same_mesh", bench)
    orig = tm.generate_grid_sdf
    calls = []

    def flaky(*args, **kwargs):
        calls.append(1)
        if len(calls) == 3:  # the window's first call
            raise RuntimeError("lost")
        return orig(*args, **kwargs)

    monkeypatch.setattr(tm, "generate_grid_sdf", flaky)
    r = run.run_cell(c, 5, 0.3, False, t0=time.perf_counter(), device="cpu",
                     on_card=False)
    assert r["failed"] == 1 and not r["correct"]


def _hashes(bench):
    return {str(p.relative_to(bench)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in bench.rglob("*") if p.is_file()}


def test_new_files_are_found_by_name(tiny):
    root, bench = tiny
    before = _hashes(bench)
    # A new configuration, mix and metric: files plus manifest entries.
    cfg = json.loads((bench / "configs" / "tiny_grid.json").read_text())
    cfg["args"]["grid"]["cells"] = [12, 14, 16]
    (bench / "configs" / "tiny_grid_b.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "tiny_new_b.json").write_text(json.dumps({
        "mesh": {"per_call": "new", "scale": [0.5, 0.6],
                 "meshes_per_second": 100},
        "output": "host"}))
    (bench / "metrics" / "calls_seen.py").write_text(
        "def read(ctx):\n    return ctx.n_calls\n")
    m = manifest.load(root)
    m["configs"].append({"name": "tiny_grid_b", "source": "https://x.org",
                         "file": "benchmark/configs/tiny_grid_b.json",
                         "reduced": [], "why": "added"})
    m["workloads"].append({"name": "tiny_grid_b.tiny_new_b",
                           "config": "tiny_grid_b", "traffic": "tiny_new_b",
                           "chips": 1, "why": "added"})
    for e in m["end_to_end"]:
        if e["name"] == "cells_per_s":
            e["workloads"].append("tiny_grid_b.tiny_new_b")
    m["end_to_end"].append({"name": "calls_seen", "unit": "calls",
                            "better": "higher", "bound": 0.05,
                            "source": "host_clock",
                            "workloads": ["tiny_grid_b.tiny_new_b"]})
    m["per_layer"][0]["workloads"].append("tiny_grid_b.tiny_new_b")
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    assert manifest.problems(m, root) == []
    r = _run(root, bench, "tiny_grid_b.tiny_new_b")
    assert r["correct"], r["check"]
    assert r["metrics"]["calls_seen"]["value"] == r["attempted"]
    assert r["metrics"]["cells_per_s"]["value"] > 0
    # Only files were added: none of the files already there changed.
    after = _hashes(bench)
    assert set(after) - set(before) == {"configs/tiny_grid_b.json",
                                        "traffic/tiny_new_b.json",
                                        "metrics/calls_seen.py"}
    assert all(after[p] == h for p, h in before.items())


def test_traced_run_reports_per_layer_metrics_it_can_read(tiny):
    root, bench = tiny
    r = _run(root, bench, "tiny_query.tiny_near", trace=True)
    assert r["correct"]
    assert set(r["metrics"]) <= {"flag_pct.query"}
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert "busy_s" in r["device"] and "window_s" in r["device"]
