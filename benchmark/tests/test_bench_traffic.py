"""Every mix's inputs repeat exactly for a seed and differ between seeds,
with the same sizes for every seed."""
import json

import numpy as np
import pytest
import torch

from benchmark.harness import manifest, traffic

MIXES = sorted(p.stem for p in (manifest.BENCH_DIR / "traffic").glob(
    "*.json"))
MESH = {"kind": "icosphere", "subdiv": 3}
BIG = 2**31 + 12345


def _small(mix: str) -> dict:
    spec = json.loads((manifest.BENCH_DIR / "traffic"
                       / f"{mix}.json").read_text())
    if "points" in spec:
        spec["points"]["count"] = 4000
        spec["points"]["pool"] = 2
    return spec


def _inputs(spec, seed):
    feed = traffic.make_feed(spec, MESH, seed, "cpu", 0.5)
    verts = [np.asarray(feed.host_vertices(i)) for i in (-2, -1, 0, 1)]
    pts = [] if feed.pool is None else [q.numpy() for q in feed.pool]
    return verts, pts


@pytest.mark.parametrize("mix", MIXES)
def test_mix_repeats_for_a_seed(mix):
    spec = _small(mix)
    a, b = _inputs(spec, BIG), _inputs(spec, BIG)
    for x, y in zip(a[0] + a[1], b[0] + b[1]):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("mix", MIXES)
def test_mix_differs_between_seeds(mix):
    spec = _small(mix)
    (va, pa), (vb, pb) = _inputs(spec, 7), _inputs(spec, 8)
    assert [v.shape for v in va] == [v.shape for v in vb]
    assert [p.shape for p in pa] == [p.shape for p in pb]
    if pa:
        assert not np.array_equal(pa[0], pb[0])
    if spec["mesh"]["per_call"] == "new":
        assert not np.array_equal(va[2], vb[2])
        # No call sees another call's mesh, nor a warm-up's.
        assert len({v.tobytes() for v in va}) == len(va)


def test_the_real_mixes_make_their_sizes():
    near = json.loads((manifest.BENCH_DIR / "traffic"
                       / "near_surface.json").read_text())["points"]
    counts = traffic._counts(near["count"],
                             [c["share"] for c in near["components"]])
    assert counts == [235_000, 235_000, 30_000]


def test_new_meshes_are_rotated_scaled_copies():
    spec = _small("new_mesh")
    feed = traffic.make_feed(spec, MESH, 3, "cpu", 0.5)
    base = feed.base_vertices.astype(np.float64)
    r0 = np.linalg.norm(base, axis=1)
    for i in range(4):
        r = np.linalg.norm(feed.host_vertices(i).astype(np.float64), axis=1)
        s = r / r0
        assert 0.85 <= s.min() and s.max() <= 1.0 and np.ptp(s) < 1e-5
    with pytest.raises(traffic.OutOfInputs):
        feed.vertices(len(feed.mesh_vertices))


def test_near_surface_points_lie_near_the_mesh():
    spec = _small("near_surface")
    feed = traffic.make_feed(spec, MESH, 5, "cpu", 0.5)
    r = torch.linalg.norm(feed.pool[0].double(), dim=1)
    near = (r - 1.0).abs() < 0.35
    assert near.double().mean() > 0.9


def test_icosphere_is_closed_and_outward():
    v, f = traffic.icosphere(4)
    assert f.shape == (20 * 4**4, 3)
    e = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]])
    assert len({tuple(x) for x in e.tolist()}) == len(e)
    n = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
    assert (np.einsum("ij,ij->i", n, v[f[:, 0]]) > 0).all()
    np.testing.assert_allclose(np.linalg.norm(v, axis=1), 1.0, atol=1e-6)


def test_derive_takes_any_whole_number():
    seeds = {traffic.derive(s, "x") for s in (0, 1, -1, 2**31 + 5, 2**70)}
    assert len(seeds) == 5 and all(0 <= s < 2**63 for s in seeds)
