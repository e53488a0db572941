"""The port's roofline accounting (``utils/roofline.py``, written for the
H100): the JAX tests/test_roofline.py checks on the H100's peaks, the
sweep bounds PERF.md gives (0.487 ms at 256³, 0.061 ms at 128³ at
3.3454e13 FP32 operations/s), and chip_smoke.py taking its counts from the
module (one copy)."""
import ast
from pathlib import Path

import pytest
import torch

import mesh_to_sdf_tpu_torch as tm
from mesh_to_sdf_tpu_torch.ops import cpt
from mesh_to_sdf_tpu_torch.ops.kernels import parity
from mesh_to_sdf_tpu_torch.utils import roofline
from mesh_to_sdf_tpu_torch.utils.meshgen import icosphere

ROOT = Path(__file__).resolve().parent.parent
#: The FP32 rate of PERF.md's bounds (one H100 80GB HBM3, 132 SMs at
#: 1980 MHz).
PERF_MD_FP32 = 3.3454e13


def test_account_compute_bound():
    # 10 TFLOP in 0.5 s on a 33.454 TFLOP/s roof -> ~59.8% peak.
    out = roofline.account(0.5, flops=1e13, hbm_bytes=1e9)
    assert out["bound"] == "compute"
    assert abs(out["achieved_gflops"] - 20000.0) < 1.0
    assert 59.0 < out["pct_fp32_peak"] < 60.5
    assert "pct_vpu_fp32_peak" not in out


def test_account_bandwidth_bound():
    out = roofline.account(1.0, flops=1e10, hbm_bytes=2e12)
    assert out["bound"] == "bandwidth"
    assert 59.0 < out["pct_hbm_peak"] < 60.5


def test_account_latency_bound():
    out = roofline.account(1.0, flops=1e9, hbm_bytes=1e6)
    assert out["bound"] == "latency"


def test_query_pairs_model():
    m = roofline.pairs_query_flops(1000, 500, raycast_axes=3)
    assert m["pairs"] == 1000 * 500
    assert m["flops"] == m["pairs"] * (53 + 3 * 13)
    assert m["hbm_bytes"] == 1000 * 28 + 500 * 36
    assert roofline.pairs_query_flops(10, 10, 0)["flops"] == 100 * 53


def test_sweep_model_scales_with_rounds():
    one = roofline.cpt_sweep_flops(10**6)
    two = roofline.cpt_sweep_flops(10**6, rounds=2)
    assert one["evals_per_cell"] == 18 * 6
    assert two["flops"] == 2 * one["flops"]
    assert two["hbm_bytes"] == 2 * one["hbm_bytes"]
    assert one["hbm_bytes"] == 10**6 * 16 * 2 * 6
    recs = roofline.cpt_sweep_flops(10**6, n_records=101)
    assert recs["hbm_bytes"] == one["hbm_bytes"] + 6 * 101 * 80
    assert roofline.sweep_bytes(10**6, 101) * 6 == recs["hbm_bytes"]


@pytest.mark.parametrize("cells,want_ms", [(256, 0.487), (128, 0.061)])
def test_sweep_bound_reproduces_perf_md(cells, want_ms):
    """One directional sweep's bound: its operations over the card's FP32
    rate (the state's 32 B per cell and the records over HBM are far
    less)."""
    n = cells ** 3
    ms, by = roofline.bound(roofline.sweep_flops(n),
                            roofline.sweep_bytes(n, 20_481), PERF_MD_FP32)
    assert by == "operations"
    assert round(ms, 3) == want_ms
    per_sweep = roofline.cpt_sweep_flops(n, n_sweeps_per_round=1)
    assert roofline.bound(per_sweep["flops"], per_sweep["hbm_bytes"],
                          PERF_MD_FP32) == (ms, by)
    assert abs(roofline.FP32_PEAK_H100 - PERF_MD_FP32) / PERF_MD_FP32 < 1e-4


def test_kernel_counts():
    counts = torch.tensor([[2, 0], [1, 0], [0, 0]])
    assert roofline.raycast_flops(3, 4, 3, counts) == 12 * (53 + 39) + 30
    assert roofline.parity_flops(10, counts) == 10 * 15 + 13 * 3
    ms, by = roofline.bound(0.0, 3.35e9, PERF_MD_FP32)
    assert by == "bytes" and abs(ms - 1.0) < 1e-12


def test_grid_total_counts_from_real_structures():
    """The counting paths run on the port's own seed bins and line bins."""
    verts, faces = icosphere(1)
    ta, tb, tc = (verts[faces[:, k]] for k in range(3))
    grid = tm.Grid.from_bounding_box([-1.2] * 3, [1.2] * 3, [8, 8, 8])
    bins = cpt.build_seed_bins(grid, ta, tb, tc)
    lbs = tuple(parity.build_line_bins(grid, ax, ta, tb, tc, device="cpu")
                for ax in range(3))
    m = roofline.grid_total_flops(8**3, bins, lbs)
    sweeps = roofline.cpt_sweep_flops(8**3)
    assert m["flops"] > sweeps["flops"] and m["hbm_bytes"] > 0
    pb = roofline.parity_binned_flops(lbs)
    assert pb["pairs"] > 0 and pb["flops"] == pb["pairs"] * 15
    acct = roofline.account(0.01, **m)
    assert set(acct) >= {"achieved_gflops", "pct_fp32_peak", "bound"}


def test_chip_smoke_takes_counts_from_roofline():
    """chip_smoke.py defines no operation count or peak of its own: it
    imports them from utils/roofline.py."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    assigned = {t.id for node in tree.body if isinstance(node, ast.Assign)
                for t in node.targets if isinstance(t, ast.Name)}
    defined = {node.name for node in tree.body
               if isinstance(node, ast.FunctionDef)}
    assert not assigned & {"FLOPS", "PEAK_BYTES"}
    assert not defined & {"raycast_flops", "parity_flops", "fp32_peak"}
    imported = {a.name for node in tree.body
                if isinstance(node, ast.ImportFrom)
                and node.module == "mesh_to_sdf_tpu_torch.utils.roofline"
                for a in node.names}
    assert imported >= {"FLOPS", "PEAK_BYTES", "raycast_flops",
                        "parity_flops"}
