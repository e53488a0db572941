"""The readers of the port's own spans, on hand-made traces in which the
program's spans sit inside ``bench.call`` and inside the benchmark's own
spans; and the benchmark's older readers, which give the same values with
and without the program's spans."""
import types

import pytest

from benchmark.harness import manifest, trace

NEW = ["host_syncs.grid", "host_syncs.query", "intake_ms.grid",
       "intake_ms.query", "phase_a_idle_ms.query"]


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


def query_call(t, c):
    """One 500 us query call from ``t`` (correlation ids from ``c``):
    kernels [100, 120] and [160, 180] under phase A, [390, 480] culled."""
    return [
        _span(trace.CALL, t, 500),
        _span("query.entry", t + 2, 493),
        _span("query.soup", t + 5, 40),
        _span("sync.query.vertices", t + 10, 10),
        _span("query.structures", t + 45, 10),
        _span("phase_a", t + 60, 140),
        _span("query.culled.phase_a", t + 61, 138),
        _launch(t + 70, c), _launch(t + 150, c + 1),
        _x(trace.HOST_OP_CAT, "aten::index", t + 130, 20),
        _span("sync.query.n_flag", t + 270, 30),
        _span("culled", t + 350, 35),
        _span("query.culled.kernel", t + 351, 33),
        _launch(t + 360, c + 2),
        _kernel("phase_a_op", t + 100, 20, c),
        _kernel("phase_a_op", t + 160, 20, c + 1),
        _kernel("culled_blocks", t + 390, 90, c + 2),
    ]


def grid_call(t, c):
    """One 500 us grid call from ``t``: a seed kernel [100, 200], a
    sweep kernel [250, 450]; three syncs."""
    return [
        _span(trace.CALL, t, 500),
        _span("grid.entry", t + 2, 493),
        _span("grid.soup", t + 5, 20),
        _span("sync.grid.vertices", t + 6, 10),
        _span("host_prep", t + 30, 30),
        _span("grid.prep", t + 31, 28),
        _span("grid.prep.key", t + 32, 20),
        _span("seed", t + 60, 50),
        _span("grid.seed", t + 61, 48),
        _span("sync.grid.seed.first_cell", t + 62, 4),
        _span("sync.grid.seed.cell_size", t + 67, 4),
        _launch(t + 80, c),
        _span("sweep", t + 220, 20),
        _span("grid.sweep", t + 221, 18),
        _launch(t + 225, c + 1),
        _kernel("seed_op", t + 100, 100, c),
        _kernel("sweep_axis", t + 250, 200, c + 1),
    ]


def _trace(call, program=True):
    ev = [_span(trace.WINDOW, 0, 1000)] + call(0, 1) + call(500, 11)
    if not program:
        ev = [e for e in ev if "." not in e["name"]
              or e["name"] in (trace.CALL, trace.WINDOW)]
    return {"traceEvents": ev}


def _read(name, summary):
    return manifest.load_metric(name).read(
        types.SimpleNamespace(summary=summary))


def test_the_query_cells_readers():
    s = trace.reduce(_trace(query_call))
    # Gaps of a call: [0, 100] mid 50 in query.structures; [120, 160]
    # mid 140 under query.culled.phase_a in aten::index; [180, 390] mid
    # 285 in sync.query.n_flag; [480, 600] mid 540 in the next call's
    # query.soup; [980, 1000] mid 990 in query.entry.
    assert s.idle_gaps == pytest.approx({
        "query.structures": 100e-6,
        "query.culled.phase_a / aten::index": 80e-6,
        "sync.query.n_flag": 420e-6, "query.soup": 120e-6,
        "query.entry": 20e-6})
    assert _read("host_syncs.query", s) == 2.0
    # (40 + 10) us of intake a call.
    assert _read("intake_ms.query", s) == pytest.approx(0.05)
    assert _read("phase_a_idle_ms.query", s) == pytest.approx(0.04)
    assert _read("host_syncs.grid", s) is None
    assert _read("intake_ms.grid", s) is None


def test_the_grid_cells_readers():
    s = trace.reduce(_trace(grid_call))
    assert _read("host_syncs.grid", s) == 3.0
    assert _read("intake_ms.grid", s) == pytest.approx(0.02)
    for name in ("host_syncs.query", "intake_ms.query",
                 "phase_a_idle_ms.query"):
        assert _read(name, s) is None


@pytest.mark.parametrize("call,readers", [
    (query_call, {"phase_a_ms.query": 0.04, "culled_ms.query": 0.09,
                  "device_idle_pct.query": 74.0}),
    (grid_call, {"host_prep_ms.grid": 0.03, "seed_ms.grid": 0.1,
                 "sign_ms.grid": None, "device_idle_pct.grid": 40.0})])
def test_older_readers_ignore_the_program_spans(call, readers):
    with_p = trace.reduce(_trace(call))
    without = trace.reduce(_trace(call, program=False))
    for name, want in readers.items():
        got = _read(name, with_p)
        assert got == (None if want is None else pytest.approx(want)), name
        assert _read(name, without) == got, name
    # A program without the spans (an older commit) reads nothing.
    for name in NEW:
        assert _read(name, without) is None
        assert _read(name, None) is None
