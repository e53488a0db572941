"""The port's spans (``utils/profiling.py``) on the CPU.

Without a profiler a span is a shared no-op, and the CPT grid and CULLED
query routes construct no ``record_function``; under
``torch.profiler.profile`` they open their span trees, nested in each
call's entry span, with the prep's and the structures' miss spans on a
cold cache only; the answers are bit-identical either way. Host-sync spans
(``sync.*``) mark waits on a card, so a CPU call opens none; the card test
(``test_torch_tracing_cuda.py``) counts them against PyTorch's sync debug
mode.
"""
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import mesh_to_sdf_tpu_torch as tm
from mesh_to_sdf_tpu_torch import gridgen, query
from mesh_to_sdf_tpu_torch.utils import profiling
from mesh_to_sdf_tpu_torch.utils.meshgen import icosphere

PORT = Path(tm.__file__).resolve().parent
REPO = PORT.parent

#: icosphere(3): 1 280 triangles, past CULLED's 2·k = 1 024 for its
#: per-mesh structures. 4 096 queries in 4 tight clusters near the surface,
#: so each Morton tile certifies on its candidates (no dense re-run).
MESH = icosphere(3)
TOPO = tm.Topology.triangle_list(MESH[1].reshape(-1))
_RNG = np.random.default_rng(20261018)
QUERIES = (MESH[0][_RNG.integers(0, len(MESH[0]), (4, 1))]
           + _RNG.normal(0.0, 0.02, (4, 1024, 3))).reshape(-1, 3).astype(
               np.float32)
GRID = tm.Grid.from_bounding_box([-1.2] * 3, [1.2] * 3, [8, 8, 8])

GRID_COLD = {"grid.entry", "grid.soup", "grid.prep", "grid.prep.key",
             "grid.prep.subdivide", "grid.prep.seed_bins",
             "grid.prep.line_bins", "grid.prep.upload", "grid.seed",
             "grid.sweep", "grid.sign", "grid.sign.axis"}
GRID_MISS = {"grid.prep.subdivide", "grid.prep.seed_bins",
             "grid.prep.line_bins", "grid.prep.upload"}
QUERY_COLD = {"query.entry", "query.soup", "query.structures",
              "query.structures.build"}


def _clear_caches(sign_grid: bool = True):
    """Empty the CPT prep cache and CULLED's structure caches; the sign
    grid's (dense parity at 128³, seconds on the CPU) only with
    ``sign_grid``."""
    gridgen._CPT_PREP_CACHE.clear()
    for cache in (query._PARITY_BINS_CACHE, query._BLOCK_INDEX_CACHE) + (
            (query._SIGN_GRID_CACHE,) if sign_grid else ()):
        cache.clear()


def _calls():
    """(grid field, query distances) of one CPT grid call and one CULLED
    query call on the CPU."""
    g = tm.generate_grid_sdf(MESH[0], TOPO, GRID, strategy=tm.Strategy.CPT,
                             device="cpu")
    d = tm.generate_sdf(MESH[0], TOPO, QUERIES, tm.Strategy.CULLED,
                        device="cpu")
    return g, d


def _profiled(path):
    """The calls under a CPU profiler: (answers, the trace's spans as
    (name, start, end))."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = _calls()
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
             for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation"]
    return out, spans


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Cold calls with no profiler (``record_function`` made to raise),
    then cold calls (the sign grid kept: the parity bins' build still
    misses) and warm calls under the profiler. Torch on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp("tracing")

    def refuse(*args, **kwargs):
        raise AssertionError("record_function constructed untraced")

    try:
        _clear_caches()
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(torch.autograd.profiler.record_function, "__init__",
                       refuse)
            off = _calls()
        _clear_caches(sign_grid=False)
        cold, cold_spans = _profiled(tmp / "cold.json")
        warm, warm_spans = _profiled(tmp / "warm.json")
    finally:
        _clear_caches()
        torch.set_num_threads(threads)
    return {"off": off, "cold": cold, "warm": warm,
            "cold_spans": cold_spans, "warm_spans": warm_spans}


def _names(spans):
    return {name for name, _, _ in spans}


def test_untraced_calls_construct_no_record_function(runs):
    """The fixture's untraced cold calls ran with ``record_function``'s
    constructor raising: both routes, misses included, made none."""
    g, d = runs["off"]
    assert g.shape == (8 * 8 * 8,) and d.shape == (len(QUERIES),)
    assert torch.isfinite(d).all()


@pytest.mark.parametrize("phase", ["cold", "warm"])
def test_answers_are_bit_identical_traced(runs, phase):
    for got, want in zip(runs[phase], runs["off"]):
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_cold_calls_open_the_span_tree(runs):
    names = _names(runs["cold_spans"])
    assert GRID_COLD | QUERY_COLD <= names
    # A CPU call waits on no card: no host-sync span.
    assert not any(n.startswith("sync.") for n in names)


def test_warm_calls_skip_the_miss_spans(runs):
    names = _names(runs["warm_spans"])
    assert (GRID_COLD - GRID_MISS) | (QUERY_COLD - {
        "query.structures.build"}) <= names
    assert not names & (GRID_MISS | {"query.structures.build"})


@pytest.mark.parametrize("phase", ["cold", "warm"])
def test_every_span_nests_in_its_call_entry(runs, phase):
    """Each span lies inside the entry span of its path: parentage is the
    nesting on the calling thread."""
    spans = runs[f"{phase}_spans"]
    entries = {n: (s, e) for n, s, e in spans
               if n in ("grid.entry", "query.entry")}
    assert set(entries) == {"grid.entry", "query.entry"}
    gs, ge = entries["grid.entry"]
    qs, qe = entries["query.entry"]
    assert ge <= qs  # the grid call ends before the query call starts
    for name, s, e in spans:
        lo, hi = entries["grid.entry"] if s < qs else entries["query.entry"]
        assert lo <= s and e <= hi, name


def test_span_is_a_shared_noop_without_a_profiler(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function constructed untraced")

    monkeypatch.setattr(torch.autograd.profiler.record_function, "__init__",
                        refuse)
    assert profiling.span("a.b") is profiling.span("a.c")
    assert profiling.sync_span("sync.a.b", "cuda") is profiling.span("a.b")
    with profiling.span("a.b"):
        pass

    @profiling.spanned("a.deco")
    def inc(x):
        return x + 1

    assert inc(1) == 2 and inc.__name__ == "inc"


def test_span_records_under_a_profiler():
    """Under a profiler a span is a ``record_function`` (also through a
    decorator applied before the profiler started)."""
    @profiling.spanned("a.deco")
    def inc(x):
        return x + 1

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert isinstance(profiling.span("a.ctx"),
                          torch.autograd.profiler.record_function)
        with profiling.span("a.ctx"):
            assert inc(1) == 2
    assert {"a.ctx", "a.deco"} <= {e.name for e in prof.events()}


_HOST = torch.zeros(3)


@pytest.mark.parametrize("places, waits", [
    (("cuda",), True),  # host data to the card, or a host read of it
    ((torch.device("cuda", 0),), True),
    (("cpu",), False),
    ((None,), False),  # x.to(None): stays on the host
    ((np.zeros(3),), False),  # numpy vertices: already on the host
    ((_HOST,), False),
    ((_HOST, "cuda"), True),  # a copy's source and destination
    (("cuda", _HOST), True),
    (("cuda", "cuda:0"), False),
    ((_HOST, "cpu"), False),
], ids=["card", "card-device", "cpu", "none", "numpy", "host-tensor",
        "host-to-card", "card-to-host", "card-to-card", "host-to-host"])
def test_sync_span_opens_where_the_host_waits(places, waits):
    """A sync span opens (one ``record_function``) exactly where its
    statement moves data between the host and a CUDA device."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.sync_span("sync.a.site", *places):
            pass
    assert ("sync.a.site" in {e.name for e in prof.events()}) == waits


#: Every literal span name in the port's source.
_SPAN_RE = re.compile(r"""(?:span|spanned)\(\s*["']([^"']+)["']""")
_SYNC_RE = re.compile(r"""["'](sync\.[a-z_.]+)["']""")


def _port_span_names():
    names = set()
    for path in PORT.rglob("*.py"):
        text = path.read_text()
        names |= set(_SPAN_RE.findall(text)) | set(_SYNC_RE.findall(text))
    return names


def test_span_names_are_dotted_and_apart_from_the_benchmarks():
    """A program span and a benchmark span of one name would merge in the
    trace's reduction."""
    from benchmark.harness import manifest, trace

    bench = {trace.CALL, trace.WINDOW}
    for reader in sorted((REPO / "benchmark" / "metrics").glob("*.py")):
        mod = manifest.load_metric(reader.stem, REPO / "benchmark")
        bench |= {span for _, _, span in getattr(mod, "SPANS", ())}
    names = _port_span_names()
    assert {"grid.entry", "query.entry", "query.culled.phase_a",
            "sync.query.n_flag", "sync.grid.vertices"} <= names
    for name in names:
        assert "." in name and name not in bench, name
        assert re.fullmatch(r"[a-z_]+(\.[a-z_]+)+", name), name
