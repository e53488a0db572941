"""The slab-streamed grid's cell (entry ``grid_streamed``, its mix and its
readers): a tiny cell of its own on the CPU, written beside a copy of the
real readers, is correct, and its control and answers altered through
``tm.generate_grid_sdf`` are not; each reader of the cell (the four
``*.stream`` ones and the grid's that the cell shares) reads its spans on
a hand-made trace, and each ``*.stream`` one gives None on a run without
the stream's spans (an older program, an untraced run, another route's
trace)."""
from __future__ import annotations

import json
import shutil
import time
import types

import pytest

import mesh_to_sdf_tpu_torch as tm
from benchmark.harness import cell as run
from benchmark.harness import manifest, trace

REAL = manifest.load(manifest.ROOT)
CELL = "grid512_streamed_1m.same_mesh_host"
READERS = sorted(m["name"] for m in REAL["per_layer"]
                 if CELL in m.get("workloads", [CELL]))
STREAM_READERS = [n for n in READERS if n.endswith(".stream")]
#: The grid's readers that read the stream's calls too: through
#: ``grid.entry`` and ``grid.soup``, and the wrapped ``cpt.seed_from_bins``
#: and ``parity.grid_inside_mask``, which the stream calls.
SHARED = ["device_idle_pct.grid", "host_syncs.grid", "intake_ms.grid",
          "seed_ms.grid", "sign_ms.grid"]
#: icosphere(3) on 22³ cells: with ``out=`` AUTO takes the stream (one
#: slab by the route's rule).
TINY = {
    "name": "tiny_stream", "mesh": {"kind": "icosphere", "subdiv": 3},
    "entry": "grid_streamed",
    "args": {"grid": {"lo": [-1.2] * 3, "hi": [1.2] * 3,
                      "cells": [22, 22, 22]}, "sign_method": "raycast"},
    "route": {"strategy": "CPT", "min_launches_per_call": {}},
    "precision": "float32",
    "guarantee": {"kind": "cpt_contract", "undershoot_max": 1e-5,
                  "band_cells": 1.5, "band_err_max": 1e-5,
                  "far_rel_max": 0.02, "sign_flips_max": 0,
                  "surface_eps": 1e-5},
    "check": {"calls": 2, "samples": 2048},
}
TINY_CELL = "tiny_stream.same_mesh_host"


def _write_tiny(root):
    bench = root / "benchmark"
    shutil.copytree(manifest.BENCH_DIR / "metrics", bench / "metrics")
    (bench / "configs").mkdir(parents=True)
    (bench / "traffic").mkdir()
    (bench / "configs" / "tiny_stream.json").write_text(json.dumps(TINY))
    shutil.copy(manifest.BENCH_DIR / "traffic" / "same_mesh_host.json",
                bench / "traffic")
    cells = [TINY_CELL]
    per_layer = [dict(m, workloads=cells) for m in REAL["per_layer"]
                 if m["name"] in READERS]
    m = {"command": REAL["command"], "paths": REAL["paths"],
         "run_seconds": 1,
         "configs": [{"name": "tiny_stream", "source": "https://x.org",
                      "file": "benchmark/configs/tiny_stream.json",
                      "reduced": [], "why": "tiny"}],
         "workloads": [{"name": TINY_CELL, "config": "tiny_stream",
                        "traffic": "same_mesh_host", "chips": 1,
                        "why": "tiny"}],
         "end_to_end": [dict(e, **({"workloads": cells} if "workloads" in e
                                   else {}))
                        for e in REAL["end_to_end"]
                        if e["name"] in ("setup_s", "cells_per_s",
                                         "call_p95_ms", "peak_mem_gib")],
         "per_layer": per_layer}
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    assert manifest.problems(m, root) == []
    return bench


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    root = tmp_path_factory.mktemp("tiny_stream")
    return root, _write_tiny(root)


def _run(root, bench, trace_on=False, **kw):
    c = manifest.find_cell(manifest.load(root), TINY_CELL, bench)
    return run.run_cell(c, 2**31 + 77, 0.05, trace_on,
                        t0=time.perf_counter(), device="cpu", on_card=False,
                        **kw)


@pytest.fixture(scope="module")
def traced(tiny):
    return _run(*tiny, trace_on=True)


def test_traced_tiny_cell_is_correct(traced):
    assert traced["correct"], traced["check"]
    assert traced["attempted"] >= 1 and traced["failed"] == 0
    # The host's readers read the CPU's trace; the device's need a card.
    assert {"host_prep_ms.stream", "intake_ms.grid",
            "host_syncs.grid"} <= set(traced["metrics"])
    assert traced["metrics"]["host_syncs.grid"]["value"] == 0.0


def test_tiny_cell_is_correct_and_reports_its_rate(tiny):
    r = _run(*tiny)
    assert r["correct"], r["check"]
    assert {"setup_s", "cells_per_s", "call_p95_ms"} <= set(r["metrics"])


def test_control_is_not_correct(tiny):
    r = _run(*tiny, control=True)
    assert not r["correct"], r["check"]


@pytest.mark.parametrize("how", ["offset", "sign"])
def test_altered_answers_are_not_correct(tiny, monkeypatch, how):
    fn = tm.generate_grid_sdf

    def broken(*args, **kwargs):
        out = fn(*args, **kwargs).clone()
        flat = out.view(-1)
        if how == "offset":
            flat[::100] += 0.01
        else:
            flat[::100] *= -1.0
        return out

    monkeypatch.setattr(tm, "generate_grid_sdf", broken)
    r = _run(*tiny)
    assert not r["correct"], r["check"]


def test_the_real_cell_lists_its_readers():
    c = manifest.find_cell(REAL, CELL)
    assert {m["name"] for m in c.end_to_end} == {
        "setup_s", "cells_per_s", "call_p95_ms", "peak_mem_gib"}
    assert {m["name"] for m in c.per_layer} == set(READERS)
    assert STREAM_READERS == ["edges_ms.stream", "fetch_wait_ms.stream",
                              "host_prep_ms.stream", "sweep_roofline.stream"]
    assert sorted(set(READERS) - set(STREAM_READERS)) == SHARED
    assert c.config["entry"] == "grid_streamed"
    assert c.traffic["mesh"] == {"per_call": "same", "vertices": "host"}


# A hand-made trace of two 1000 us stream calls: spans on the host thread,
# launches under them, kernels on the device.

def _x(cat, name, ts, dur, tid=1, pid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "pid": pid, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _span(name, ts, dur):
    return _x(trace.HOST_SPAN_CAT, name, ts, dur)


def _launch(ts, corr):
    return _x("cuda_runtime", "cudaLaunchKernel", ts, 5, corr=corr)


def _kernel(name, ts, dur, corr):
    return _x("kernel", name, ts, dur, pid=0, tid=7, corr=corr)


def stream_call(t, c):
    """intake 4 us on the host, seed [100, 150], sweep [200, 400], edges
    [410, 440], sign [450, 500], fetch's waits 30 us; 20 sign syncs and 3
    fetch syncs. ``seed`` and ``sign`` are the harness's wraps of
    ``cpt.seed_from_bins`` and ``parity.grid_inside_mask``."""
    return [
        _span(trace.CALL, t, 1000),
        _span("grid.entry", t + 1, 998),
        _span("grid.soup", t + 2, 4),
        _span("stream.entry", t + 8, 990),
        _span("stream.prep", t + 10, 25),
        _span("stream.prep.key", t + 11, 20),
        _span("stream.pass_two", t + 40, 950),
        _span("stream.seed", t + 50, 10), _span("seed", t + 51, 8),
        _launch(t + 55, c),
        _span("stream.sweep", t + 60, 20), _launch(t + 65, c + 1),
        _span("stream.edges", t + 80, 40), _launch(t + 90, c + 3),
        _span("stream.sign", t + 128, 44), _span("sign", t + 129, 42),
        _launch(t + 160, c + 2),
        *[_span("sync.grid.centers.first_cell", t + 131 + k, 1)
          for k in range(20)],
        _span("stream.fetch", t + 600, 50),
        _span("sync.stream.fetch.staging", t + 601, 10),
        _span("sync.stream.fetch.drain", t + 620, 10),
        _span("sync.stream.fetch.synchronize", t + 640, 10),
        _kernel("seed_cells", t + 100, 50, c),
        _kernel("sweep_axis", t + 200, 200, c + 1),
        _kernel("elementwise_kernel", t + 410, 30, c + 3),
        _kernel("parity_hits", t + 450, 50, c + 2),
    ]


def grid_call(t, c):
    """The in-core grid route's call, without the stream's spans."""
    return [
        _span(trace.CALL, t, 1000),
        _span("grid.entry", t + 1, 998),
        _span("grid.seed", t + 50, 10), _launch(t + 55, c),
        _span("sync.grid.centers.first_cell", t + 131, 1),
        _kernel("seed_cells", t + 100, 50, c),
    ]


def _summary(call):
    ev = [_x(trace.HOST_SPAN_CAT, trace.WINDOW, 0, 2000)]
    ev += call(0, 1) + call(1000, 11)
    return trace.reduce({"traceEvents": ev})


def _ctx(summary):
    cell = types.SimpleNamespace(config={"args": {"grid": {
        "cells": [512, 512, 512]}}})
    return types.SimpleNamespace(summary=summary, cell=cell,
                                 n_triangles=1_310_720)


def _read(name, summary):
    return manifest.load_metric(name).read(_ctx(summary))


def test_stream_readers_read_the_programs_spans():
    s = _summary(stream_call)
    # 128 sweeps of a 64 × 512 × 512 slab, each a sixth of the frozen
    # bound of one round, over 0.2 ms of sweeps a call.
    from benchmark import roofline_frozen

    bound_ms = 1e3 * 128 / 6 * roofline_frozen.sweep_bound_s(
        64 * 512 * 512, 1_310_720)
    assert _read("sweep_roofline.stream", s) == pytest.approx(
        100.0 * bound_ms / 0.2)
    want = {"host_prep_ms.stream": 0.025, "edges_ms.stream": 0.03,
            "fetch_wait_ms.stream": 0.03, "seed_ms.grid": 0.05,
            "sign_ms.grid": 0.05, "intake_ms.grid": 0.004,
            "host_syncs.grid": 23.0, "device_idle_pct.grid": 67.0}
    for name, value in want.items():
        assert _read(name, s) == pytest.approx(value), name
    assert set(want) | {"sweep_roofline.stream"} == set(READERS)


@pytest.mark.parametrize("summary", ["grid", "none"])
def test_stream_readers_give_none_without_the_spans(summary):
    s = _summary(grid_call) if summary == "grid" else None
    for name in STREAM_READERS if summary == "grid" else READERS:
        assert _read(name, s) is None, name
