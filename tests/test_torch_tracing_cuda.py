"""The port's host-sync spans against PyTorch's sync debug mode, on the
card. Every test here is marked ``cuda`` and skips without an NVIDIA GPU.
Run them on the GPU machine without tests/conftest.py (it imports JAX):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_tracing_cuda.py

For one warm call of each measured route, the waits that
``torch.cuda.set_sync_debug_mode("warn")`` reports (every warning kept:
``simplefilter("always")``) are as many as the ``sync.*`` spans the same
call opens under a profiler: each wait is marked, and each mark waits.
"""
import warnings

import numpy as np
import pytest
import torch

import mesh_to_sdf_tpu_torch as tm
from mesh_to_sdf_tpu_torch import gridgen, query
from mesh_to_sdf_tpu_torch.ops import culling
from mesh_to_sdf_tpu_torch.ops.kernels import culled
from mesh_to_sdf_tpu_torch.utils.meshgen import icosphere

pytestmark = pytest.mark.cuda

SYNC_WARNING = "called a synchronizing CUDA operation"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    yield torch.device("cuda")
    gridgen._CPT_PREP_CACHE.clear()
    for cache in (query._SIGN_GRID_CACHE, query._PARITY_BINS_CACHE,
                  query._BLOCK_INDEX_CACHE, culling._ROUTE_CACHE):
        cache.clear()


def _waits(call) -> int:
    """Sync-debug warnings of one call."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            call()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sum(SYNC_WARNING in str(w.message) for w in got)


def _sync_spans(call) -> list:
    """Names of the ``sync.*`` spans one profiled call opens."""
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        call()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.name.startswith("sync.")]


def _check(call):
    call()  # cold: builds the kernels and fills the caches
    call()
    spans = _sync_spans(call)
    assert spans and _waits(call) == len(spans), sorted(spans)
    assert _sync_spans(call) == spans  # the same waits in every call
    return spans


def test_cpt_grid_sync_spans_match_the_waits(cuda):
    """256³ CPT grid on icosphere(5), vertices on the card (the
    ``grid256_raycast.same_mesh`` cell's call)."""
    v, f = icosphere(5)
    verts = torch.from_numpy(v).to(cuda)
    topo = tm.Topology.triangle_list(f.reshape(-1))
    grid = tm.Grid.from_bounding_box([-1.1] * 3, [1.1] * 3, [256] * 3)
    spans = _check(lambda: tm.generate_grid_sdf(
        verts, topo, grid, strategy=tm.Strategy.CPT, device=cuda))
    assert "sync.grid.vertices" in spans


@pytest.mark.parametrize("vertices", ["card", "host"])
def test_culled_query_sync_spans_match_the_waits(cuda, vertices):
    """A gather-engine CULLED call: 65 536 queries uniform around
    icosphere(6) (81 920 triangles), vertices on the card or the host (the
    ``query_82k_raycast`` cells')."""
    v, f = icosphere(6)
    verts = torch.from_numpy(v).to(cuda) if vertices == "card" else v
    topo = tm.Topology.triangle_list(f.reshape(-1))
    q = torch.from_numpy(np.random.default_rng(20261018).uniform(
        -1.3, 1.3, (65_536, 3)).astype(np.float32)).to(cuda)

    def call():
        return tm.generate_sdf(verts, topo, q, tm.Strategy.CULLED,
                               sign_method=tm.SignMethod.RAYCAST,
                               device=cuda)

    spans = _check(call)
    launched = culled.COUNT.kernel
    call()
    assert culled.COUNT.kernel > launched
    assert culling.LAST_CULLED_STATS["engine"] == "gather"
    assert ("sync.query.vertices" in spans) == (vertices == "card")
