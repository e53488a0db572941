"""The port's renderer (``mesh_to_sdf_tpu_torch.render``) against the JAX
package's, on the CPU: the JAX tests/test_render.py checks on the port, each
also held against the JAX function on the same inputs (a 24³ icosphere(3)
grid of distances computed once by the JAX package, 48×48 images, points
from ``np.random.default_rng``).

Tolerances: samplers and ``Camera.rays`` 1e-6; ``ordered_indices``,
``voxel_band``, ``surface_cells`` and ``to_uint8`` equal; ``trace`` /
``dda_trace`` / ``trace_mesh`` hit masks equal on ≥ 99.5 % of the rays, t
within 1e-5 and cells / triangle ids equal where both hit; images: hit masks
equal on ≥ 99.5 % of the pixels and within 2/255 where both hit.
"""
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from baselines import make_icosphere
from mesh_to_sdf_tpu import Grid, SignMethod, Topology, generate_grid_sdf
from mesh_to_sdf_tpu import render as jr
from mesh_to_sdf_tpu_torch import render as tr
from mesh_to_sdf_tpu_torch.io import png
from torch_port_helpers import port_grid

MASK_AGREE = 0.995
PIXEL_ATOL = 2.0 / 255.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per worker (see tests/test_torch_autodiff.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sphere_grid():
    """(JAX grid, port grid, distances (24, 24, 24) numpy)."""
    v, f = make_icosphere(subdiv=3)
    g = Grid.from_bounding_box([-1.3] * 3, [1.3] * 3, [24, 24, 24])
    d = generate_grid_sdf(
        v, Topology.triangle_list(f.reshape(-1)), g, SignMethod.RAYCAST,
        flat=False
    )
    return g, port_grid(g), np.array(d)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _jcam(cam):
    return jr.Camera(**cam.__dict__)


def _tmode(mode):
    return tr.RaymarchMode(mode.value)


def _same_image(got, want, mask_agree=MASK_AGREE):
    """Hit masks (non-background) agree on ≥ ``mask_agree`` of the pixels;
    where both hit, within PIXEL_ATOL."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    hg, hw = got.sum(-1) > 0, want.sum(-1) > 0
    assert (hg == hw).mean() >= mask_agree, (hg != hw).mean()
    both = hg & hw
    assert np.abs(got - want)[both].max(initial=0.0) <= PIXEL_ATOL


@pytest.mark.parametrize("mode", list(jr.RaymarchMode), ids=lambda m: m.value)
def test_samplers_agree_at_cell_centers(sphere_grid, mode):
    """All samplers return the stored value exactly at cell centers, and
    equal JAX's within 1e-6 at scattered points inside and outside."""
    g, tg, d = sphere_grid
    cells = np.array([[3, 4, 5], [10, 10, 10], [0, 0, 0], [23, 23, 23]])
    pts = tg.cell_center(torch.from_numpy(cells))
    want = d[cells[:, 0], cells[:, 1], cells[:, 2]]
    got = tr.sample(_t(d), tg, pts, _tmode(mode)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, err_msg=mode.value)
    q = np.random.default_rng(5).uniform(-1.6, 1.6, (4000, 3)).astype(
        np.float32)
    got = tr.sample(_t(d), tg, _t(q), _tmode(mode)).numpy()
    want = np.asarray(jr.sample(jnp.asarray(d), g, jnp.asarray(q), mode))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_trilinear_is_linear_between_centers(sphere_grid):
    _, tg, d = sphere_grid
    a = tg.cell_center(torch.tensor([5, 5, 5]))
    b = tg.cell_center(torch.tensor([6, 5, 5]))
    mid = ((a + b) * 0.5)[None]
    va, vb = d[5, 5, 5], d[6, 5, 5]
    for mode in (tr.RaymarchMode.TRILINEAR, tr.RaymarchMode.TETRAHEDRAL):
        got = float(tr.sample(_t(d), tg, mid, mode)[0])
        np.testing.assert_allclose(got, (va + vb) / 2, atol=1e-5)


def test_out_of_bounds_sentinel(sphere_grid):
    """Far outside (indices that would overflow an unclamped gather) and
    non-finite positions return the 100.0 sentinel, as in JAX."""
    g, tg, d = sphere_grid
    far = np.array([[99.0, 0.0, 0.0], [-3e9, 2e9, 0.0], [np.inf, 0.0, 0.0]],
                   np.float32)
    for mode in jr.RaymarchMode:
        got = tr.sample(_t(d), tg, _t(far), _tmode(mode)).numpy()
        want = np.asarray(jr.sample(jnp.asarray(d), g, jnp.asarray(far),
                                    mode))
        np.testing.assert_array_equal(got, 100.0)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cam", [
    dict(eye=(0.3, 0.2, 4.0)),
    dict(eye=(2.0, 2.0, 2.0), target=(0.1, -0.2, 0.0), width=40, height=24),
    dict(eye=(-3.0, 1.0, 0.5), fov_y_deg=60.0, width=17, height=33),
], ids=["front", "wide", "odd"])
def test_camera_rays_match_jax(sphere_grid, cam):
    """``Camera.rays`` within 1e-6 of JAX (the two linspaces may differ in
    the last ulp), and ``Camera.orbit`` the same camera."""
    g, tg, _ = sphere_grid
    for kw in (cam, None):
        if kw is None:
            c = tr.Camera.orbit(tg, azimuth_deg=40.0, elevation_deg=-10.0,
                                width=31, height=29)
            assert _jcam(c) == jr.Camera.orbit(g, azimuth_deg=40.0,
                                               elevation_deg=-10.0,
                                               width=31, height=29)
        else:
            c = tr.Camera(**kw)
        o, d = c.rays("cpu")
        jo, jd = _jcam(c).rays()
        assert o.shape == d.shape == (c.height, c.width, 3)
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=1e-6)
        np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=1e-6)


def _hold_trace(got, want, pos_atol=1e-5):
    (pg, dg, hg), (pw, dw, hw) = got, want
    hg, hw = hg.numpy(), np.asarray(hw)
    assert (hg == hw).mean() >= MASK_AGREE
    both = hg & hw
    np.testing.assert_allclose(pg.numpy()[both], np.asarray(pw)[both],
                               atol=pos_atol)
    return hg


def test_trace_hits_sphere(sphere_grid):
    g, tg, d = sphere_grid
    origins = np.array([[0.0, 0.0, 3.0], [3.0, 3.0, 3.0]], np.float32)
    dirs = -origins / np.linalg.norm(origins, axis=-1, keepdims=True)
    pos, dist, hit = tr.trace(_t(d), tg, _t(origins), _t(dirs))
    assert bool(hit[0]) and bool(hit[1])
    r = np.linalg.norm(pos.numpy(), axis=-1)
    np.testing.assert_allclose(r, 1.0, atol=0.15)
    # Every camera ray against JAX: hit masks, positions where both hit.
    cam = tr.Camera.orbit(tg, width=48, height=48)
    o, dd = cam.rays("cpu")
    for mode in jr.RaymarchMode:
        got = tr.trace(_t(d), tg, o, dd, mode=_tmode(mode))
        want = jr.trace(jnp.asarray(d), g, jnp.asarray(o.numpy()),
                        jnp.asarray(dd.numpy()), mode=mode)
        assert _hold_trace(got, want).any()


def test_trace_miss(sphere_grid):
    g, tg, d = sphere_grid
    origins = _t([[0.0, 0.0, 3.0], [5.0, 5.0, 5.0]])
    dirs = _t([[0.0, 0.0, 1.0], [1.0, 0.0, 0.0]])  # away from the grid
    _, dist, hit = tr.trace(_t(d), tg, origins, dirs)
    assert not hit.any()
    # Rays that never start keep the sentinel, as in JAX.
    _, jdist, _ = jr.trace(jnp.asarray(d), g, jnp.asarray(origins.numpy()),
                           jnp.asarray(dirs.numpy()))
    np.testing.assert_array_equal(dist.numpy()[1], np.asarray(jdist)[1])


def test_normals_point_outward(sphere_grid):
    g, tg, d = sphere_grid
    p = np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.5, 0.6, -0.62]],
                 np.float32)
    n = tr.estimate_normal(_t(d), tg, _t(p)).numpy()
    np.testing.assert_allclose(n[0], [1, 0, 0], atol=0.2)
    np.testing.assert_allclose(n[1], [0, 1, 0], atol=0.2)
    for mode in jr.RaymarchMode:
        got = tr.estimate_normal(_t(d), tg, _t(p), mode=_tmode(mode)).numpy()
        want = np.asarray(jr.estimate_normal(jnp.asarray(d), g,
                                             jnp.asarray(p), mode=mode))
        np.testing.assert_allclose(got, want, atol=1e-5)


def test_render_image(sphere_grid):
    g, tg, d = sphere_grid
    cam = tr.Camera.orbit(tg, width=48, height=48)
    img = tr.render(_t(d), tg, cam).numpy()
    assert img.shape == (48, 48, 3)
    hit_frac = (img.sum(-1) > 0).mean()
    assert 0.03 < hit_frac < 0.9
    assert img[24, 24].sum() > 0
    assert img[0, 0].sum() == 0
    _same_image(img, jr.render(jnp.asarray(d), g, _jcam(cam)))
    u8 = tr.to_uint8(img)
    assert u8.dtype == np.uint8
    np.testing.assert_array_equal(u8, jr.to_uint8(img))


@pytest.mark.parametrize("mode", list(jr.RaymarchMode), ids=lambda m: m.value)
def test_render_modes_match_jax(sphere_grid, mode):
    """Every mode, with shadows and with a light and background given."""
    g, tg, d = sphere_grid
    cam = tr.Camera.orbit(tg, azimuth_deg=-60.0, width=48, height=48)
    kw = dict(light_pos=(2.0, 3.0, -1.0), background=(0.1, 0.0, 0.2))
    got = tr.render(_t(d), tg, cam, 0.05, mode=_tmode(mode), **kw)
    want = jr.render(jnp.asarray(d), g, _jcam(cam), 0.05, mode=mode, **kw)
    bg = np.array(kw["background"], np.float32)
    got, want = got.numpy() - bg, np.asarray(want) - bg
    _same_image(np.abs(got), np.abs(want))


def test_render_snap_stylized_differs_from_snap(sphere_grid):
    """SNAP_STYLIZED is a distinct SHADING mode (`draw_raymarching.wgsl
    :302-306`): same silhouette as SNAP, green-dominant Phong."""
    _, tg, d = sphere_grid
    cam = tr.Camera.orbit(tg, width=64, height=64)
    snap = tr.render(_t(d), tg, cam, mode=tr.RaymarchMode.SNAP).numpy()
    styl = tr.render(_t(d), tg, cam,
                     mode=tr.RaymarchMode.SNAP_STYLIZED).numpy()
    assert styl.shape == snap.shape
    hit = styl.sum(-1) > 0
    assert hit.mean() > 0.003
    assert np.abs(styl - snap).max() > 0.05
    lit = styl[hit]
    assert (lit[:, 1] >= lit[:, 0] - 1e-6).all()
    assert (lit[:, 1] >= lit[:, 2] - 1e-6).all()
    assert lit[:, 1].mean() > lit[:, 0].mean() + 0.01


def test_ordered_indices_and_band(sphere_grid):
    """Equal to JAX: the stable order (ties keep index order), the band's
    bounds, the surface cells and the point cloud."""
    g, tg, d = sphere_grid
    # Ties: a tenth of the cells share one value.
    dt = d.copy().reshape(-1)
    dt[np.random.default_rng(7).choice(dt.size, dt.size // 10,
                                       replace=False)] = 0.05
    dt = dt.reshape(d.shape)
    order, sd = tr.ordered_indices(_t(dt))
    jorder, jsd = jr.ordered_indices(jnp.asarray(dt))
    assert order.dtype == torch.int32
    np.testing.assert_array_equal(order.numpy(), np.asarray(jorder))
    np.testing.assert_array_equal(sd.numpy(), np.asarray(jsd))
    assert (np.diff(sd.numpy()) >= 0).all()
    lo, hi = tr.iso_limits(_t(d))
    jlo, jhi = jr.iso_limits(jnp.asarray(d))
    assert (float(lo), float(hi)) == (float(jlo), float(jhi))
    assert float(lo) < 0 < float(hi)
    for iso, width in ((0.0, 2.6 / 24), (0.05, 0.05), (0.3, 0.01)):
        b0, b1 = tr.voxel_band(sd, iso, width)
        j0, j1 = jr.voxel_band(jsd, iso, width)
        assert (int(b0), int(b1)) == (int(j0), int(j1))
    b0, b1 = tr.voxel_band(sd, 0.0, 2.6 / 24)
    assert 0 < int(b1 - b0) < d.size
    cells = tr.surface_cells(tg, d)
    np.testing.assert_array_equal(cells, jr.surface_cells(g, d))
    vals = d[cells[:, 0], cells[:, 1], cells[:, 2]]
    assert np.abs(vals).max() <= 2.6 / 24 + 1e-6
    pc = tr.point_cloud(tg, _t(d))
    np.testing.assert_array_equal(pc, jr.point_cloud(g, d))
    assert np.abs(np.linalg.norm(pc, axis=1) - 1.0).max() < 0.2


def test_splat_render_matches_jax(sphere_grid):
    g, tg, d = sphere_grid
    cam = tr.Camera.orbit(tg, width=48, height=48)
    got = tr.render_sdf_points(tg, _t(d), cam, point_size=2)
    want = jr.render_sdf_points(g, d, _jcam(cam), point_size=2)
    assert got.sum() > 0
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------------ model pass
def _soups(subdiv=2):
    v, f = make_icosphere(subdiv=subdiv)
    return v, f, tuple(v[f[:, k]] for k in range(3))


def test_trace_mesh_sphere_hit():
    v, f, (ta, tb, tc) = _soups()
    o = _t([[3.0, 0.0, 0.0], [3.0, 0.0, 0.0]])
    d = _t([[-1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
    t, tri, u, vbar, hit = tr.trace_mesh(o, d, _t(ta), _t(tb), _t(tc))
    assert bool(hit[0]) and not bool(hit[1])
    assert abs(float(t[0]) - 2.0) < 0.05
    assert int(tri[0]) >= 0


@pytest.mark.parametrize("blocks", [(4096, 512), (100, 96)],
                         ids=["default", "small-chunks"])
def test_trace_mesh_matches_jax(blocks):
    """Camera rays and random rays from inside: hit masks, t within 1e-5,
    triangle ids and barycentrics where both hit — at any chunk and block
    size (the result does not depend on them)."""
    v, f, soup = _soups()
    chunk, tri_block = blocks
    box = port_grid(Grid.from_bounding_box([-1.3] * 3, [1.3] * 3, [8] * 3))
    cam = tr.Camera.orbit(box, width=48, height=48)
    o, d = cam.rays("cpu")
    rng = np.random.default_rng(11)
    o2 = rng.uniform(-0.5, 0.5, (500, 3)).astype(np.float32)
    d2 = rng.standard_normal((500, 3)).astype(np.float32)
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    for oo, dd in ((o, d), (_t(o2), _t(d2))):
        got = tr.trace_mesh(oo, dd, *map(_t, soup), tri_block=tri_block,
                            chunk=chunk)
        want = jr.trace_mesh(jnp.asarray(oo.numpy()), jnp.asarray(dd.numpy()),
                             *map(jnp.asarray, soup))
        hg, hw = got[4].numpy(), np.asarray(want[4])
        assert (hg == hw).mean() >= MASK_AGREE
        both = hg & hw
        assert both.any()
        np.testing.assert_allclose(got[0].numpy()[both],
                                   np.asarray(want[0])[both], atol=1e-5)
        np.testing.assert_array_equal(got[1].numpy()[both],
                                      np.asarray(want[1])[both])
        for k in (2, 3):
            np.testing.assert_allclose(got[k].numpy()[both],
                                       np.asarray(want[k])[both], atol=1e-5)
        occ = tr.trace_mesh(oo, dd, *map(_t, soup), any_hit=True)
        np.testing.assert_array_equal(occ[4].numpy(), hg)


def test_render_model_matches_sdf_silhouette(sphere_grid):
    g, tg, d = sphere_grid
    v, f, _ = _soups()
    cam = tr.Camera.orbit(tg, width=48, height=48)
    img_m = tr.render_model(v, f, cam, shadows=False, device="cpu").numpy()
    img_s = tr.render(_t(d), tg, cam, shadows=False).numpy()
    assert img_m.shape == (48, 48, 3)
    hit_m = img_m.sum(-1) > 0.01
    hit_s = img_s.sum(-1) > 0.01
    assert hit_m.any()
    inter = (hit_m & hit_s).sum()
    union = (hit_m | hit_s).sum()
    assert inter / union > 0.75, inter / union
    for shadows in (False, True):
        got = tr.render_model(v, f, cam, shadows=shadows, device="cpu")
        _same_image(got, jr.render_model(v, f, _jcam(cam), shadows=shadows))


def test_render_model_vertex_colors():
    v, f, _ = _soups()
    colors = np.where((v[:, 0] > 0)[:, None],
                      np.array([1.0, 0.0, 0.0], np.float32),
                      np.array([0.0, 0.0, 1.0], np.float32))
    g = Grid.from_bounding_box([-1.3] * 3, [1.3] * 3, [8] * 3)
    cam = tr.Camera.orbit(port_grid(g), azimuth_deg=90.0, elevation_deg=0.0,
                          width=32, height=32)
    img = tr.render_model(v, f, cam, vertex_colors=colors, shadows=False,
                          device="cpu").numpy()
    hit = img.sum(-1) > 0.01
    mean = img[hit].mean(axis=0)
    if cam.eye[0] > 0:
        assert mean[0] > mean[2], mean
    else:
        assert mean[2] > mean[0], mean
    _same_image(img, jr.render_model(v, f, _jcam(cam), vertex_colors=colors,
                                     shadows=False))


def test_render_model_and_sdf_composite(sphere_grid):
    g, tg, d = sphere_grid
    v, f, _ = _soups()
    cam = tr.Camera.orbit(tg, width=40, height=40)
    img = tr.render_model_and_sdf(v, f, _t(d), tg, cam, shadows=False).numpy()
    assert img.shape == (40, 40, 3)
    assert (img.sum(-1) > 0.01).any()
    assert img[20, 20].sum() > 0.05
    for shadows in (False, True):
        got = tr.render_model_and_sdf(v, f, _t(d), tg, cam, shadows=shadows)
        want = jr.render_model_and_sdf(v, f, jnp.asarray(d), g, _jcam(cam),
                                       shadows=shadows)
        _same_image(got, want)


# ------------------------------------------------------------------ voxel pass
def test_voxel_band_occupancy_matches_surface_cells(sphere_grid):
    g, tg, d = sphere_grid
    occ = tr.band_occupancy(_t(d), tg).numpy()
    cells = tr.surface_cells(tg, d)
    ref = np.zeros(tg.cell_count, bool)
    ref[cells[:, 0], cells[:, 1], cells[:, 2]] = True
    np.testing.assert_array_equal(occ, ref)
    for iso, scale in ((0.0, 1.0), (0.1, 0.5)):
        np.testing.assert_array_equal(
            tr.band_occupancy(_t(d), tg, iso, scale).numpy(),
            np.asarray(jr.band_occupancy(jnp.asarray(d), g, iso, scale)))


def test_voxel_dda_hits_are_exact_cube_faces(sphere_grid):
    """Every DDA hit lies on a face of its cell's cube with an axis-aligned
    unit normal opposing the ray; and the walk equals JAX's."""
    g, tg, d = sphere_grid
    occ = tr.band_occupancy(_t(d), tg)
    cam = tr.Camera.orbit(tg, width=32, height=32)
    o, dirs = cam.rays("cpu")
    hit, t_hit, cell, normal = tr.dda_trace(occ, tg, o, dirs)
    hit = hit.numpy()
    assert hit.any()
    pos = (o + t_hit[..., None] * dirs).numpy()[hit]
    cc = tg.cell_center(cell).numpy()[hit]
    nrm = normal.numpy()[hit]
    half = np.abs(tg.cell_size.numpy()) * 0.5
    off = np.abs(pos - cc) - half[None]
    assert off.max() < 1e-3
    face_axis = np.argmax(np.abs(nrm), axis=1)
    on_face = np.abs(np.take_along_axis(off, face_axis[:, None], axis=1))
    assert on_face.max() < 1e-3
    assert np.allclose(np.linalg.norm(nrm, axis=1), 1.0)
    assert (np.sum(nrm * dirs.numpy()[hit], axis=1) < 0).all()

    jhit, jt, jcell, jn = jr.dda_trace(jnp.asarray(occ.numpy()), g,
                                       jnp.asarray(o.numpy()),
                                       jnp.asarray(dirs.numpy()))
    jhit = np.asarray(jhit)
    assert (hit == jhit).mean() >= MASK_AGREE
    both = hit & jhit
    np.testing.assert_allclose(t_hit.numpy()[both], np.asarray(jt)[both],
                               atol=1e-5)
    np.testing.assert_array_equal(cell.numpy()[both], np.asarray(jcell)[both])
    np.testing.assert_array_equal(normal.numpy()[both], np.asarray(jn)[both])


def test_render_voxels_image(sphere_grid):
    g, tg, d = sphere_grid
    cam = tr.Camera.orbit(tg, width=48, height=48)
    img = tr.render_voxels(_t(d), tg, cam).numpy()
    assert img.shape == (48, 48, 3)
    vox_hit = img.sum(-1) > 0
    assert img[0, 0].sum() == 0
    assert img[24, 24].sum() > 0
    ray_hit = tr.render(_t(d), tg, cam).numpy().sum(-1) > 0
    inter = (vox_hit & ray_hit).sum()
    union = (vox_hit | ray_hit).sum()
    assert inter / union > 0.7, inter / union
    _same_image(img, jr.render_voxels(jnp.asarray(d), g, _jcam(cam)))


def test_render_voxels_shadows_darken(sphere_grid):
    g, tg, d = sphere_grid
    cam = tr.Camera.orbit(tg, width=32, height=32)
    lp = (0.0, -50.0, 0.0)
    img_s = tr.render_voxels(_t(d), tg, cam, light_pos=lp,
                             shadows=True).numpy()
    img_n = tr.render_voxels(_t(d), tg, cam, light_pos=lp,
                             shadows=False).numpy()
    hit = img_n.sum(-1) > 0
    assert img_s[hit].mean() < img_n[hit].mean()
    _same_image(img_s, jr.render_voxels(jnp.asarray(d), g, _jcam(cam),
                                        light_pos=lp, shadows=True))


# --------------------------------------------------------------------- images
def test_to_uint8_and_png_equal_jax(tmp_path):
    """``to_uint8`` equals JAX's on values around every rounding edge and
    out of range; ``save_png`` (no PIL) decodes, by PIL and by the port's
    decoder, to exactly those bytes; uint8 input is written as it is."""
    from PIL import Image

    rng = np.random.default_rng(3)
    img = rng.uniform(-0.2, 1.2, (19, 23, 3)).astype(np.float32)
    img[0, :, 0] = (np.arange(23) + 0.5) / 255.0  # the .5 edges
    np.testing.assert_array_equal(tr.to_uint8(img), jr.to_uint8(img))
    np.testing.assert_array_equal(tr.to_uint8(_t(img)), jr.to_uint8(img))
    path = tmp_path / "a.png"
    tr.save_png(path, _t(img))
    want = jr.to_uint8(img)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), want)
    np.testing.assert_array_equal(png.decode(path.read_bytes()), want)
    jpath = tmp_path / "j.png"
    jr.save_png(jpath, img)
    np.testing.assert_array_equal(png.decode(jpath.read_bytes()), want)
    tr.save_png(path, want)
    np.testing.assert_array_equal(np.asarray(Image.open(
        io.BytesIO(path.read_bytes()))), want)
