"""The plain reference against analytic answers at tiny sizes."""
import numpy as np
import pytest
import torch

from benchmark.harness import traffic
from benchmark.reference import exact


def _box(h=(1.0, 0.5, 0.25)):
    """An axis-aligned box of half extents ``h``, 12 outward triangles."""
    hx, hy, hz = h
    c = np.array([[x, y, z] for x in (-hx, hx) for y in (-hy, hy)
                  for z in (-hz, hz)], np.float32)
    quads = [(0, 1, 3, 2), (6, 7, 5, 4), (0, 4, 5, 1), (2, 3, 7, 6),
             (0, 2, 6, 4), (1, 5, 7, 3)]
    f = np.array([t for a, b, cc, d in quads for t in ((a, b, cc),
                                                       (a, cc, d))])
    return c[f]


def _box_sdf(p, h):
    q = np.abs(p) - np.asarray(h)
    out = np.linalg.norm(np.maximum(q, 0.0), axis=1)
    return out + np.minimum(q.max(axis=1), 0.0)


def test_box_is_exact():
    h = (1.0, 0.5, 0.25)
    rng = np.random.default_rng(0)
    p = rng.uniform(-1.6, 1.6, (3000, 3))
    s, d = exact.signed_distance(torch.from_numpy(p), torch.from_numpy(
        _box(h)))
    np.testing.assert_allclose(s.numpy(), _box_sdf(p, h), atol=1e-12)
    np.testing.assert_allclose(d.numpy(), np.abs(_box_sdf(p, h)),
                               atol=1e-12)


def test_sphere_within_its_facets():
    v, f = traffic.icosphere(3)
    rng = np.random.default_rng(1)
    p = rng.uniform(-1.5, 1.5, (2000, 3))
    s, _ = exact.signed_distance(torch.from_numpy(p), torch.from_numpy(
        v[f]))
    want = np.linalg.norm(p, axis=1) - 1.0
    # The facets lie inside the sphere by at most ~1 - cos(edge angle).
    assert np.abs(s.numpy() - want).max() < 5e-3
    away = np.abs(want) > 5e-3
    assert (np.sign(s.numpy()[away]) == np.sign(want[away])).all()


def test_triangle_regions():
    tri = torch.tensor([[[0.0, 0.0, 0.0], [1.0, 0.0, 0.0],
                         [0.0, 1.0, 0.0]]], dtype=torch.float64)
    p = torch.tensor([[0.2, 0.2, 0.5], [2.0, 0.0, 0.0], [0.5, -1.0, 0.0],
                      [-1.0, -1.0, 1.0], [1.0, 1.0, 0.0]])
    _, d = exact.signed_distance(p, tri)
    want = [0.5, 1.0, 1.0, np.sqrt(3.0), np.sqrt(0.5)]
    np.testing.assert_allclose(d.numpy(), want, atol=1e-12)


def test_blocks_do_not_change_the_answer(monkeypatch):
    v, f = traffic.icosphere(2)
    p = torch.from_numpy(np.random.default_rng(2).uniform(-1.2, 1.2,
                                                          (500, 3)))
    whole = exact.signed_distance(p, torch.from_numpy(v[f]))[0]
    monkeypatch.setattr(exact, "BLOCK_ELEMS", 7 * 320)
    np.testing.assert_array_equal(
        exact.signed_distance(p, torch.from_numpy(v[f]))[0].numpy(),
        whole.numpy())


def test_lower_precision_misses():
    v, f = traffic.icosphere(3)
    p = torch.from_numpy(np.random.default_rng(3).uniform(-1.3, 1.3,
                                                          (500, 3)))
    ref = exact.signed_distance(p, torch.from_numpy(v[f]))[0]
    low = exact.signed_distance(p, torch.from_numpy(v[f]),
                                dtype=torch.bfloat16)[0]
    assert (ref - low).abs().max() > 1e-3
    assert low.dtype == torch.float64
