"""The trace reduction on a synthetic profiler trace, and the spans."""
import types

import pytest
import torch

from benchmark.harness import manifest, trace


def _x(cat, name, ts, dur, tid=1, pid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "pid": pid, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def synthetic():
    """A 1000 us window: two calls; kernels of the 'seed' span run 100 us
    and 50 us, one of 'sweep' 300 us, a copy outside any layer span."""
    ev = [
        _x("user_annotation", trace.WINDOW, 0, 1000),
        _x("user_annotation", trace.CALL, 0, 500),
        _x("user_annotation", "seed", 10, 30),
        _x("cuda_runtime", "cudaLaunchKernel", 20, 5, corr=1),
        _x("cuda_runtime", "cudaLaunchKernel", 30, 5, corr=2),
        _x("user_annotation", "sweep", 60, 20),
        _x("cuda_runtime", "cudaLaunchKernel", 65, 5, corr=3),
        _x("cpu_op", "aten::item", 400, 90),
        _x("user_annotation", trace.CALL, 500, 500),
        _x("cuda_runtime", "cudaMemcpyAsync", 510, 5, corr=4),
        # device work (another pid/tid: the card)
        _x("kernel", "seed_kernel", 100, 100, pid=0, tid=7, corr=1),
        _x("kernel", "seed_kernel", 200, 50, pid=0, tid=7, corr=2),
        _x("kernel", "sweep_axis", 250, 300, pid=0, tid=7, corr=3),
        _x("gpu_memcpy", "Memcpy DtoH", 600, 100, pid=0, tid=7, corr=4),
        # before the window: left out
        _x("kernel", "warm", -500, 100, pid=0, tid=7),
        # another thread's span does not count
        _x("user_annotation", "seed", 0, 1000, tid=2),
    ]
    return {"traceEvents": ev}


def test_busy_and_idle():
    s = trace.reduce(synthetic())
    assert s.window_s == pytest.approx(1e-3)
    # busy: [100, 550] and [600, 700] -> 550 us
    assert s.busy_s == pytest.approx(550e-6)
    ctx = types.SimpleNamespace(summary=s)
    for cells in ("grid", "query"):
        reader = manifest.load_metric(f"device_idle_pct.{cells}")
        assert reader.read(ctx) == pytest.approx(45.0)


@pytest.mark.parametrize("name,want", [
    ("seed_ms.grid", 0.075), ("sign_ms.grid", None),
    ("host_prep_ms.grid", None), ("culled_ms.query", None)])
def test_readers_read_their_spans_per_call(name, want):
    ctx = types.SimpleNamespace(summary=trace.reduce(synthetic()))
    got = manifest.load_metric(name).read(ctx)
    assert got == (None if want is None else pytest.approx(want))
    assert manifest.load_metric(name).read(
        types.SimpleNamespace(summary=None)) is None


def test_device_time_goes_to_the_launching_span():
    s = trace.reduce(synthetic())
    assert s.span_device_s("seed") == pytest.approx(150e-6)
    assert s.span_device_s("sweep") == pytest.approx(300e-6)
    assert s.span_device_s(trace.CALL) == pytest.approx(550e-6)
    assert s.span_count(trace.CALL) == 2
    assert s.span_host_s("seed") == pytest.approx(30e-6)
    assert s.span_device_s("absent") == 0.0


def test_breakdown_names_ops_and_gaps():
    s = trace.reduce(synthetic())
    b = s.breakdown()
    assert b["device_ops"][0] == ["sweep_axis", pytest.approx(300e-6)]
    assert dict(map(tuple, b["device_ops"]))["seed_kernel"] == \
        pytest.approx(150e-6)
    gaps = dict(map(tuple, b["idle_gaps"]))
    # [0, 100] mid 50: bench.call; [550, 600] mid 575: second call;
    # [700, 1000] mid 850: second call.
    assert gaps[trace.CALL] == pytest.approx(100e-6 + 50e-6 + 300e-6)
    assert sum(gaps.values()) == pytest.approx(450e-6)
    assert len(b["device_ops"]) <= trace.TOP


def test_gap_names_the_host_op():
    ev = synthetic()
    ev["traceEvents"] = [e for e in ev["traceEvents"]
                         if e["name"] != "Memcpy DtoH"]
    gaps = trace.reduce(ev).idle_gaps
    # [550, 1000] mid 775 lies in the second call, outside aten::item.
    assert gaps[trace.CALL] == pytest.approx(100e-6 + 450e-6)
    ev["traceEvents"].append(_x("cpu_op", "aten::nonzero", 700, 200))
    gaps = trace.reduce(ev).idle_gaps
    assert gaps[trace.CALL + " / aten::nonzero"] == pytest.approx(450e-6)


def test_a_trace_without_a_window_is_refused():
    with pytest.raises(ValueError):
        trace.reduce({"traceEvents": []})


def test_tracer_opens_spans_and_restores(tmp_path, monkeypatch):
    mod = types.ModuleType("bench_fake_layer")
    mod.f = lambda x: x + 1
    monkeypatch.setitem(__import__("sys").modules, "bench_fake_layer", mod)
    orig = mod.f
    monkeypatch.setattr(trace, "SECONDS", 1.0)
    tracer = trace.Tracer([("bench_fake_layer", "f", "fake")],
                          tmp_path / "t.json", cuda=False)
    assert mod.f is not orig
    tracer.start(clock=lambda: 0.0)
    for now in (0.5, 1.5, 2.5):  # the third call falls after the stop
        with torch.profiler.record_function(trace.CALL):
            assert mod.f(1) == 2
        tracer.after_call(now)
    s = tracer.finish()
    assert mod.f is orig
    assert s.span_count("fake") == 2 and s.calls == 2
