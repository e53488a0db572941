"""The port's trusted pair math (``ops/geometry.py``, ``ops/keyed.py``)
against the JAX package's, on the same numpy inputs.

Inputs: random (point, triangle) pairs from a seed plus the degenerate soup
of tests/test_pallas.py:105-133 (segments and points). Distances and
coordinates: rtol=2e-4, atol=1e-5 (XLA fuses the float32 ladder differently
from eager PyTorch); masks and signs exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mesh_to_sdf_tpu.ops import geometry as jgeo
from mesh_to_sdf_tpu.ops import keyed as jkeyed
from mesh_to_sdf_tpu_torch.ops import geometry as tgeo
from mesh_to_sdf_tpu_torch.ops import keyed as tkeyed
from torch_port_helpers import ATOL, RTOL, to_jax, to_torch


def _pairs():
    """(p, a, b, c) float32 (N, 3): random pairs, then degenerate ones."""
    rng = np.random.default_rng(11)
    n = 1500
    p, a, b, c = (rng.standard_normal((n, 3)).astype(np.float32)
                  for _ in range(4))
    rng = np.random.default_rng(3)
    da = rng.standard_normal((64, 3)).astype(np.float32)
    db = da.copy()  # b == a → segment [a, c]
    dc = rng.standard_normal((64, 3)).astype(np.float32)
    db[32:] = dc[32:]  # b == c → segment [a, b]
    dc[48:] = da[48:]  # all equal → vertex a
    db[48:] = da[48:]
    dp = rng.uniform(-1.5, 1.5, (64, 3)).astype(np.float32)
    return tuple(np.concatenate(x) for x in ((p, dp), (a, da), (b, db),
                                             (c, dc)))


PAIRS = _pairs()

#: Geometry functions of (p, a, b, c) with float outputs.
FLOAT_FNS = ["closest_point_barycentric", "closest_point_on_triangle",
             "point_triangle_distance2", "point_triangle_distance",
             "point_triangle_signed_distance"]


@pytest.mark.parametrize("name", FLOAT_FNS)
def test_pair_function_matches_jax(name):
    want = np.asarray(getattr(jgeo, name)(*to_jax(*PAIRS)))
    got = getattr(tgeo, name)(*to_torch(*PAIRS))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    if name == "point_triangle_signed_distance":
        np.testing.assert_array_equal(np.signbit(got.numpy()),
                                      np.signbit(want))


@pytest.mark.parametrize("name", ["triangle_bounding_box", "triangle_normal"])
def test_triangle_function_matches_jax(name):
    tri = PAIRS[1:]
    want = getattr(jgeo, name)(*to_jax(*tri))
    got = getattr(tgeo, name)(*to_torch(*tri))
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)


def test_point_triangle_sign_matches_jax():
    p, a, b, c = PAIRS
    q = np.array(jgeo.closest_point_on_triangle(*to_jax(*PAIRS)))
    want = np.asarray(jgeo.point_triangle_sign(*to_jax(p, q, a, b, c)))
    got = tgeo.point_triangle_sign(*to_torch(p, q, a, b, c))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want > 0).any() and (want < 0).any()


@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("name", ["ray_triangle_aligned",
                                  "ray_triangle_aligned_2d"])
def test_ray_function_matches_jax(name, axis):
    # Origins near the triangles so that a fair share of rays hit.
    p, a, b, c = PAIRS
    o = (a + b + c) / 3 + 0.3 * p
    hit_j, t_j = (np.asarray(x) for x in getattr(jgeo, name)(
        *to_jax(o, a, b, c), axis))
    hit_t, t_t = getattr(tgeo, name)(*to_torch(o, a, b, c), axis)
    np.testing.assert_array_equal(hit_t.numpy(), hit_j)
    np.testing.assert_allclose(t_t.numpy()[hit_j], t_j[hit_j], rtol=RTOL,
                               atol=ATOL)
    assert hit_j.sum() > 50


def _signed_values():
    rng = np.random.default_rng(5)
    x = rng.uniform(-2, 2, (40, 30)).astype(np.float32)
    # Near-ties: magnitudes 1 ulp and 3 ulps apart, and within 1e-6.
    m = np.float32(0.75)
    ties = np.array([m, -np.nextafter(m, np.float32(1)), -m, 0.25,
                     -np.float32(0.25 + 5e-7), m * (1 + 3 * 2**-23)],
                    np.float32)
    x[:, :6] = ties
    return x


@pytest.mark.parametrize("case", ["approx_eq_f32", "signed_champions",
                                  "signed_champions_axis",
                                  "signed_champions_where",
                                  "combine_champions",
                                  "merge_champion_pairs",
                                  "compare_distances"])
def test_keyed_matches_jax(case):
    x = _signed_values()
    mag = np.abs(x)
    y = np.roll(x, 1, axis=1)
    where = (np.arange(x.size).reshape(x.shape) % 3) != 0
    calls = {
        "approx_eq_f32": ("approx_eq_f32", (mag, np.abs(y)), {}),
        "signed_champions": ("signed_champions", (x,), {}),
        "signed_champions_axis": ("signed_champions", (x,), {"axis": 1}),
        "signed_champions_where": ("signed_champions", (x,),
                                   {"axis": 1, "where": where}),
        "combine_champions": ("combine_champions", (mag, np.abs(y)), {}),
        "merge_champion_pairs": ("merge_champion_pairs",
                                 (mag, np.abs(y), np.abs(y[::-1]),
                                  mag[::-1]), {}),
        "compare_distances": ("compare_distances", (x, y), {}),
    }
    fn, args, kw = calls[case]
    want = getattr(jkeyed, fn)(*to_jax(*args), **{
        k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
        for k, v in kw.items()})
    got = getattr(tkeyed, fn)(*to_torch(*args), **{
        k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
        for k, v in kw.items()})
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
