"""The port's weak-scaling harness (``parallel.scaling``) on four spawned
gloo ranks on the CPU, against tests/test_scaling.py's contract: the report's
keys and structure, ``non_predictive`` on the CPU, monotone rank counts,
positive times, a 100 % first row, and that the timed pipeline is the real
sharded CPT pipeline (its n = 2 workload against the JAX package's
single-device engine, tests/test_scaling.py's bounds)."""
import numpy as np
import pytest

import mesh_to_sdf_tpu as jm
from mesh_to_sdf_tpu.parallel import scaling as jscaling
from mesh_to_sdf_tpu.utils.meshgen import icosphere
from mesh_to_sdf_tpu_torch.parallel import scaling as tscaling
import torch_dist_ranks as R

#: The keys of the JAX package's report (its docstring) and of a row.
REPORT_KEYS = {"platform", "non_predictive", "cells_per_device", "tris",
               "sign_method", "repeats", "rows"}
ROW_KEYS = {"devices", "nx", "median_ms", "min_ms", "cells_per_s_per_device",
            "efficiency_pct"}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return R.run_ranks("scaling_cases", tmp_path_factory.mktemp("ranks"))


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8, 12])
def test_pow2_counts_match_the_jax_package(n):
    assert tscaling._pow2_counts(n) == jscaling._pow2_counts(n)


def test_report_contract(ranks):
    report = ranks[0]["report"]
    assert set(report) == REPORT_KEYS
    assert report["platform"] == "cpu"
    assert report["non_predictive"] is True
    assert report["cells_per_device"] == 8 * 16 * 16
    assert report["tris"] == 80 and report["repeats"] == 2
    assert report["sign_method"] == jm.SignMethod.RAYCAST.value
    rows = report["rows"]
    assert all(set(r) == ROW_KEYS for r in rows)
    assert [r["devices"] for r in rows] == [1, 2, 4]
    assert [r["nx"] for r in rows] == [8, 16, 32]
    assert rows[0]["efficiency_pct"] == 100.0
    for r in rows:
        assert r["median_ms"] > 0
        assert r["min_ms"] <= r["median_ms"] + 1e-9
        assert r["cells_per_s_per_device"] > 0
        assert 0 < r["efficiency_pct"] <= 200.0
    text = tscaling.format_report(report)
    assert "plumbing only" in text
    assert text.count("eff") == len(rows)


def test_every_rank_gets_rank_zeros_report(ranks):
    assert all(r["report"] == ranks[0]["report"] for r in ranks)


def test_workload_matches_single_device_engine(ranks):
    """The harness's n = 2 pipeline on the first two ranks against the JAX
    package's unsharded CPT engine."""
    verts, faces = icosphere(subdiv=1)
    grid = jm.Grid.from_bounding_box([-1.3] * 3, [1.3] * 3, [16, 16, 16])
    want = np.asarray(jm.generate_grid_sdf(
        verts, jm.Topology.triangle_list(faces.reshape(-1)), grid,
        jm.SignMethod.RAYCAST)).reshape(-1)
    got = ranks[0]["two_ranks"]
    np.testing.assert_array_equal(ranks[1]["two_ranks"], got)
    assert "two_ranks" not in ranks[2] and "two_ranks" not in ranks[3]
    assert (np.sign(got) == np.sign(want)).mean() > 0.995
    np.testing.assert_allclose(got, want, atol=3e-3)
