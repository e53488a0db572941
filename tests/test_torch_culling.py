"""The port's CULLED route against the JAX package, stage by stage.

The same numpy inputs as tests/test_culling.py — ``icosphere(4)`` (5 120
triangles, 20 blocks of 256) and at most 2 000 queries from a seeded numpy
generator — go through both packages. The JAX side runs on the CPU: the
union kernel ``culled_dist_pallas`` in interpret mode, the gather engine and
the rest as XLA. The port runs the block-culled kernel's plain version
(``culled.culled_blocks_plain``) there. Each stage can start from the JAX
package's own state (``port_block_index``, ``port_sign_grid``).

Tolerances: distances rtol=2e-4, atol=1e-5 (the frameworks fuse the float32
ladder differently, so they differ by ulps); block tables, crossing counts,
flags, flag counts and signs exactly; phase-A bounds rtol=1e-6 (roots of
the same sums, both correctly rounded).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mesh_to_sdf_tpu as jm
import mesh_to_sdf_tpu_torch as tm
from baselines import make_icosphere
from mesh_to_sdf_tpu.ops import culling as jculling
from mesh_to_sdf_tpu.ops.kernels import pallas_culled as jculled
from mesh_to_sdf_tpu.query import prepare_triangles as jprepare
from mesh_to_sdf_tpu_torch.ops import culling as tculling
from mesh_to_sdf_tpu_torch.ops.kernels import culled as tculled
from mesh_to_sdf_tpu_torch.ops.kernels import sdf as tsdf
from mesh_to_sdf_tpu_torch.intake import prepare_triangles as tprepare
from torch_port_helpers import (ATOL, RTOL, assert_same_field, port_grid,
                                port_sign_grid, soup, to_torch)
from torch_static_widen import static_widen

MESH = make_icosphere(subdiv=4)
SOUP = soup(*MESH)
RNG = np.random.default_rng(20261016)
SCATTERED = RNG.uniform(-1.3, 1.3, (1500, 3)).astype(np.float32)
#: Clustered queries: tight Morton tiles, few candidate blocks each.
CLUSTERED = (RNG.uniform(-1.2, 1.2, (12, 1, 3))
             + RNG.normal(0, 0.03, (12, 128, 3))).astype(np.float32).reshape(
                 -1, 3)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The plain versions issue many mid-sized ops; with several test
    processes on the host, torch's thread pool per process oversubscribes
    the cores and its barriers stall (7× slower measured). One thread here,
    restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clear_route_caches():
    """Each package's self-tuned route cache is cleared after every test,
    so one test's recorded decision never reroutes another."""
    yield
    tculling._ROUTE_CACHE.clear()
    jculling._ROUTE_CACHE.clear()


@pytest.fixture(scope="module")
def state():
    """Both packages' triangles, block index and sign grid (res 24)."""
    topo_j = jm.Topology.triangle_list(MESH[1].reshape(-1))
    topo_t = tm.Topology.triangle_list(MESH[1].reshape(-1))
    jtris = jprepare(MESH[0], topo_j, 512)
    ttris = tprepare(MESH[0], topo_t, 512, "cpu")
    jbi = jculled.build_block_index(*SOUP)
    jsg = jculling.build_sign_grid(*jtris[:4], res=24)
    return {"jtris": jtris, "ttris": ttris, "jbi": jbi, "jsg": jsg,
            "tbi": tculled.build_block_index(*SOUP, device="cpu"),
            "tsg": port_sign_grid(jsg)}


def _jq(q):
    return jnp.asarray(q)


def _tq(q):
    return torch.from_numpy(np.ascontiguousarray(q))


def _xla_port(q, sign=tm.SignMethod.RAYCAST):
    return tm.generate_sdf(MESH[0], tm.Topology.triangle_list(
        MESH[1].reshape(-1)), q, tm.Strategy.XLA, sign_method=sign,
        device="cpu").numpy()


def _assert_signed(got, want):
    assert_same_field(np.asarray(got), np.asarray(want))


# ------------------------------------------------------------- block index
@pytest.mark.parametrize("drop", [0, 7], ids=["T=5120", "T=5113"])
def test_block_index_byte_equal(drop):
    """rows, planes9, lo, hi and content_key equal the JAX package's; 5 113
    triangles (not a multiple of 256) exercise the pad row."""
    tris = tuple(t[:len(t) - drop] for t in SOUP)
    jbi = jculled.build_block_index(*tris)
    tbi = tculled.build_block_index(*tris, device="cpu")
    assert (tbi.n_blocks, tbi.tb) == (jbi.n_blocks, jbi.tb)
    assert tbi.rows.shape == (jbi.n_blocks + 1, 9, jbi.tb)
    assert tbi.rows.numpy().tobytes() == np.asarray(jbi.rows).tobytes()
    for name in ("planes9", "lo", "hi"):
        assert (getattr(tbi, name).numpy().tobytes()
                == np.asarray(getattr(jbi, name)).tobytes()), name
    assert tbi.content_key == jbi.content_key
    # The gather engine's edges, b − a and c − a from planes9 with the
    # PAD_COORD block appended (culling.py:456-476).
    p9 = np.asarray(jbi.planes9).reshape(9, jbi.n_blocks, jbi.tb)
    p9 = np.concatenate([p9, np.full((9, 1, jbi.tb), 1e18, np.float32)], 1)
    want = np.concatenate([p9[0:3], p9[3:6] - p9[0:3], p9[6:9] - p9[0:3]])
    np.testing.assert_array_equal(tbi.gather_rows.numpy(),
                                  want.transpose(1, 0, 2))


# ----------------------------------------------------------------- phase A
def _sorted_padded(q, mult):
    order = np.asarray(jculling._morton_order(_jq(q)))
    np.testing.assert_array_equal(
        tculling._morton_order(_tq(q)).numpy(), order)
    qs = q[order]
    pad = (-len(qs)) % mult
    return np.concatenate([qs, np.repeat(qs[-1:], pad, axis=0)])


#: (branch, qt, st, nb_sub, nb_table): static arguments no other test gives
#: the JAX ``select_blocks``, so its jit traces afresh and reads the
#: monkeypatched HIER_* globals (tests/test_culling.py:407-448).
SELECT = [("flat", 256, 32, 10, 40), ("hier", 256, 16, 5, 30)]


@pytest.mark.parametrize("case", SELECT, ids=[c[0] for c in SELECT])
def test_select_blocks_matches_jax(case, state, monkeypatch):
    branch, qt, st, nb_sub, nb_table = case
    if branch == "hier":
        for mod in (jculled, tculled):
            monkeypatch.setattr(mod, "HIER_MIN_BLOCKS", 8)
            monkeypatch.setattr(mod, "HIER_C", 6)
    q_pad = _sorted_padded(CLUSTERED, qt)
    jt, jl, jc = jculled.select_blocks(_jq(q_pad), state["jbi"],
                                       nb_sub=nb_sub, st=st, qt=qt,
                                       nb_table=nb_table)
    tt, tl, tc = tculled.select_blocks(_tq(q_pad), state["tbi"],
                                       nb_sub=nb_sub, st=st, qt=qt,
                                       nb_table=nb_table)
    assert tt.dtype == torch.int32
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-6)
    n_real = (tt.numpy() != state["jbi"].n_blocks).sum(axis=1)
    assert (n_real >= 1).all() and (n_real < state["jbi"].n_blocks).any()


@pytest.mark.parametrize("case", [("flat", 8, None), ("all", 32, None),
                                  ("hier", 4, 4)], ids=lambda c: c[0])
def test_phase_a_topk_matches_jax(case, state, monkeypatch):
    """The gather engine's front end on every branch: all blocks (B ≤ kg),
    flat csphere bounds, hierarchical (HIER_C patched in both packages;
    called outside jit, so JAX reads it at once)."""
    _, kg, hier_c = case
    if hier_c:
        for mod in (jculled, tculled):
            monkeypatch.setattr(mod, "HIER_C", hier_c)
    q_pad = _sorted_padded(SCATTERED, 32)
    tcen, _ = tculled._sub_tiles(_tq(q_pad), 32)
    subs = q_pad.reshape(-1, 32, 3)
    jcen = (subs.min(1) + subs.max(1)) * np.float32(0.5)
    np.testing.assert_array_equal(tcen.numpy(), jcen)
    ji, jl = jculled._phase_a_topk(_jq(jcen), None, state["jbi"], kg=kg)
    ti, tl = tculled._phase_a_topk(tcen, state["tbi"], kg=kg)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-6)


@pytest.mark.parametrize("drop", [0, 7], ids=["T=5120", "T=5113"])
def test_csphere_table_matches_csphere(drop):
    """The packed fine-bound table ``BlockIndex.csphere`` (B·tb, 4) holds
    ``_csphere``'s centroid planes and radii bit for bit, pad triangles
    included, and is built once per index."""
    tris = tuple(t[:len(t) - drop] for t in SOUP)
    tbi = tculled.build_block_index(*tris, device="cpu")
    cen, rad = tculled._csphere(tbi)
    table = tbi.csphere
    assert table.shape == (tbi.n_blocks * tbi.tb, 4)
    assert table.dtype == torch.float32 and table.is_contiguous()
    want = torch.cat([cen, rad[None]]).t()
    assert torch.equal(table.view(torch.int32), want.view(torch.int32))
    assert tbi.csphere is table


@pytest.mark.parametrize("kg", [None, 1, 3, 4])
def test_phase_a_hier_cpu_is_plain(kg, state):
    """On the CPU ``_phase_a_hier`` is the plain version (one plain call,
    no launch); with ``kg`` it returns the gather engine's pair of the full
    triple: the first kg ids as int32 and min(lb_c[:, kg], lb_rest)."""
    q_pad = _sorted_padded(SCATTERED, 32)
    cen, _ = tculled._sub_tiles(_tq(q_pad), 32)
    bi = state["tbi"]
    count = tculled.PHASE_A_COUNT
    before = (count.kernel, count.plain)
    got = tculled._phase_a_hier(cen, bi, c=5, kg=kg)
    assert (count.kernel, count.plain) == (before[0], before[1] + 1)
    lb_c, idx_c, lb_rest = tculled._phase_a_hier_plain(cen, bi, c=5)
    assert lb_c.shape == idx_c.shape == (cen.shape[0], 5)
    assert idx_c.dtype == torch.int64
    assert bool((lb_c[:, 1:] >= lb_c[:, :-1]).all())
    if kg is None:
        want = (lb_c, idx_c, lb_rest)
    else:
        want = (idx_c[:, :kg].to(torch.int32),
                torch.minimum(lb_c[:, kg], lb_rest))
        assert got[0].dtype == torch.int32 and got[0].is_contiguous()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# ------------------------------------------------------------------ kernel
@pytest.mark.parametrize("with_sign", [False, True],
                         ids=["distance", "anchors"])
def test_kernel_plain_matches_pallas(with_sign, state):
    """``culled_dist`` (the plain version on the CPU) against
    ``culled_dist_pallas(interpret=True)`` on the same table: distances
    within 2e-4/1e-5, crossing counts equal."""
    q_pad = _sorted_padded(SCATTERED, 1024)
    tbl, _, _ = jculled.select_blocks(_jq(q_pad), state["jbi"], nb_sub=48,
                                      st=16, qt=1024, nb_table=256)
    anchors = q_pad[::-1] * np.float32(0.7) if with_sign else None
    kw = {} if anchors is None else {"anchors": _jq(anchors)}
    want = jculled.culled_dist_pallas(_jq(q_pad), state["jbi"], tbl,
                                      qt=1024, interpret=True, **kw)
    kw = {} if anchors is None else {"anchors": _tq(anchors)}
    before = tculled.COUNT.plain
    got = tculled.culled_dist(_tq(q_pad), state["tbi"],
                              torch.from_numpy(np.array(tbl)), qt=1024,
                              **kw)
    assert tculled.COUNT.plain == before + 1
    if with_sign:
        (got, got_c), (want, want_c) = got, want
        np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
        assert int(got_c.sum()) > 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_kernel_wrapper_validates_inputs(state):
    bi = state["tbi"]
    q = torch.zeros((64, 3))
    tbl = torch.zeros((4, 2), dtype=torch.int32)
    kw = dict(group=16, n_blocks=bi.n_blocks)
    with pytest.raises(ValueError, match="groups of"):
        tculled.culled_blocks(q[:60], bi.rows, tbl, **kw)
    with pytest.raises(ValueError, match="tbl"):
        tculled.culled_blocks(q, bi.rows, tbl.long(), **kw)
    with pytest.raises(ValueError, match="rows"):
        tculled.culled_blocks(q, bi.rows[:-1], tbl, **kw)
    with pytest.raises(ValueError, match="anchors"):
        tculled.culled_blocks(q, bi.rows, tbl, anchors=q[:32], **kw)
    with pytest.raises(ValueError, match="no kernel"):
        tculled.culled_blocks(q.to("meta"), bi.rows.to("meta"),
                              tbl.to("meta"), **kw)


# ----------------------------------------------------------------- engines
@pytest.mark.parametrize("case", [("flat-kg8", 32, 8, None),
                                  ("all-blocks-kg32", 32, 32, None),
                                  ("hier-kg4", 16, 4, 4)],
                         ids=lambda c: c[0])
def test_gather_signed_impl_matches_jax(case, state, monkeypatch):
    """Signed values, flags and the work fraction of the gather engine,
    from the same block index and sign grid."""
    _, st, kg, hier_c = case
    if hier_c:
        for mod in (jculled, tculled):
            monkeypatch.setattr(mod, "HIER_C", hier_c)
    js, jf, jw = jculling._culled_gather_signed_impl(
        _jq(SCATTERED), state["jbi"], state["jsg"].inside, state["jsg"].grid,
        st=st, kg=kg)
    ts, tf, tw = tculling._culled_gather_signed_impl(
        _tq(SCATTERED), state["tbi"], state["tsg"].inside, state["tsg"].grid,
        st=st, kg=kg)
    _assert_signed(ts.numpy(), js)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    assert tw == float(jw)
    if kg < state["jbi"].n_blocks:
        assert tf.any()  # the bounds leave something to certify


@pytest.mark.parametrize("engine", ["gather", "union"])
def test_query_sdf_culled_matches_jax_and_brute(engine, state, monkeypatch):
    """gather: the whole fused route of one card — the gather engine, its
    widen round and the dense fix-up (``_culled_signed_fixup_impl``) —
    against JAX with the same telemetry (n_flagged, work_frac, k_fix, st)
    and against the port's brute-force engine. It runs at kg = 8 in both
    packages, so queries are flagged and widened (at the default kg = 32
    every one of the 20 blocks is a candidate and nothing is flagged).

    union: the sharded path's pass (``_culled_blocks_signed_impl``) against
    the JAX package's own, at 4 candidate blocks per sub-tile so queries
    are flagged: signed values, flags and the work fraction; the queries
    it leaves unflagged against the brute-force engine."""
    if engine == "union":
        kw = dict(qt=1024, st=32, nb_sub=4, nb_table=64)
        js, jf, jw = jculling._culled_blocks_signed_impl(
            _jq(SCATTERED), state["jbi"], state["jsg"].inside,
            state["jsg"].grid, interpret=True, **kw)
        ts, tf, tw = tculling._culled_blocks_signed_impl(
            _tq(SCATTERED), state["tbi"], state["tsg"].inside,
            state["tsg"].grid, **kw)
        _assert_signed(ts.numpy(), js)
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
        assert tw == float(jw)
        ok = ~tf.numpy()
        assert ok.any() and not ok.all()
        _assert_signed(ts.numpy()[ok], _xla_port(SCATTERED)[ok])
        return
    for mod in (jculling, tculling):
        monkeypatch.setattr(mod, "DEFAULT_KG", 8)
    tt, jt = state["ttris"], state["jtris"]
    want = jculling.query_sdf_culled(
        _jq(SCATTERED), *jt[:4], sign_method=jm.SignMethod.RAYCAST,
        sign_grid=state["jsg"], block_index=state["jbi"])
    got = tculling.query_sdf_culled(
        _tq(SCATTERED), *tt[:4], sign_method=tm.SignMethod.RAYCAST,
        sign_grid=state["tsg"], block_index=state["tbi"])
    _assert_signed(got.numpy(), want)
    _assert_signed(got.numpy(), _xla_port(SCATTERED))
    assert tculling.LAST_CULLED_STATS == jculling.LAST_CULLED_STATS
    assert tculling.LAST_CULLED_STATS["engine"] == "gather"
    _, flag, _ = tculling._culled_gather_signed_impl(
        _tq(SCATTERED), state["tbi"], state["tsg"].inside,
        state["tsg"].grid, st=32, kg=8)
    assert flag.any()  # the widen round had work


@pytest.mark.parametrize("engine", ["gather"])
def test_host_fallback_is_exact(engine, state, monkeypatch):
    """More flagged queries than k_fix: the host path recomputes every
    flagged query of the first pass, so the result stays exact. A tiny
    k_fix floor and tiny candidate budgets force it."""
    monkeypatch.setattr(tculling, "K_FIX_MIN", 1)
    monkeypatch.setattr(tculling, "DEFAULT_KG", 2)
    monkeypatch.setattr(tculling, "DEFAULT_KG_WIDE", 2)
    got = tculling.query_sdf_culled(
        _tq(SCATTERED), *state["ttris"][:4],
        sign_method=tm.SignMethod.RAYCAST, sign_grid=state["tsg"],
        block_index=state["tbi"])
    stats = tculling.LAST_CULLED_STATS
    assert stats["engine"] == engine and stats["n_flagged"] > stats["k_fix"]
    _assert_signed(got.numpy(), _xla_port(SCATTERED))


#: k_wide per case, from the first pass's flag count n (722 here at kg 8;
#: none at kg 32, where all 20 blocks are candidates).
WIDEN_CASES = {"none-flagged": lambda n: 64, "gap-7": lambda n: n + 7,
               "gap-32": lambda n: n + 32, "gap-100": lambda n: n + 100,
               "capped": lambda n: n - 50}


@pytest.mark.parametrize("case", WIDEN_CASES)
def test_widen_on_the_flag_count_matches_static_size(case, state,
                                                     monkeypatch):
    """The widen round on the first pass's flagged queries (padded with
    16-31 copies of query Q−1 where k_wide leaves room) against the static
    size (``torch_static_widen``): the values and flags it returns, the
    route's signed output, n_flagged and ``LAST_CULLED_STATS`` bit-equal,
    for n = 0, k_wide − n < 32, k_wide − n ≥ 32 and n > k_wide. kg_wide 12
    of the 20 blocks makes each answer depend on its sub-tile's members;
    k_fix 1 024 keeps the fix-up small and the fallback out."""
    kg = 32 if case == "none-flagged" else 8
    monkeypatch.setattr(tculling, "DEFAULT_KG", kg)
    monkeypatch.setattr(tculling, "DEFAULT_KG_WIDE", 12)
    monkeypatch.setattr(tculling, "K_FIX_MIN", 1024)
    q, tsg = _tq(SCATTERED), state["tsg"]
    _, flag, _ = tculling._culled_gather_signed_impl(
        q, state["tbi"], tsg.inside, tsg.grid, st=32, kg=kg)
    n = int(flag.sum())
    assert (n == 0) == (case == "none-flagged")
    k_wide = WIDEN_CASES[case](n)
    monkeypatch.setattr(tculling, "K_WIDE_MIN", k_wide)
    monkeypatch.setattr(tculling, "K_WIDE_MAX", k_wide)

    def run(widen):
        rounds = []

        def recorded(*a):
            out = widen(*a)
            rounds.append(tuple(t.clone() for t in out))
            return out

        monkeypatch.setattr(tculling, "_widen", recorded)
        tculling._ROUTE_CACHE.clear()
        out = tculling.query_sdf_culled(
            q, *state["ttris"][:4], sign_method=tm.SignMethod.RAYCAST,
            sign_grid=tsg, block_index=state["tbi"])
        assert len(rounds) == 1
        return out, rounds[0], dict(tculling.LAST_CULLED_STATS)

    tculling.LAST_WIDEN_STATS.clear()
    got, (gs, gf), gstats = run(tculling._widen)
    widen = dict(tculling.LAST_WIDEN_STATS)
    want, (ws, wf), wstats = run(static_widen)
    for a, b in ((got, want), (gs, ws)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert torch.equal(gf, wf)
    assert gstats == wstats
    widened = min(n, k_wide)
    assert widen["flagged"] == n and widen["widened"] == widened
    assert widen["k_wide"] == k_wide
    if case == "none-flagged":
        assert widen["rows"] == 0
    elif case == "capped":
        assert widen["rows"] == -(-k_wide // 1024) * 1024
    else:
        assert widened < widen["rows"] < widened + 1024 + 32
    if case in ("gap-32", "gap-100"):  # the widen round changed answers
        assert not torch.equal(gf, flag)


def test_route_cache_decision_matches_jax(state):
    """1 500 scattered queries over 20 blocks: the measured work fraction
    says culling cannot pay; the port records the decision JAX's
    ``_record_route`` makes from the same measurement, under the same key,
    and the repeat call takes the fused raycast kernel (its plain version
    here), still exact."""
    kw = dict(sign_grid=state["tsg"], block_index=state["tbi"],
              sign_method=tm.SignMethod.RAYCAST)
    Q = len(SCATTERED)
    first = tculling.query_sdf_culled(_tq(SCATTERED), *state["ttris"][:4],
                                      **kw)
    stats = tculling.LAST_CULLED_STATS
    jculling._record_route(state["jbi"], Q, stats["work_frac"],
                           st=stats["st"], k_fix_frac=stats["k_fix"] / Q)
    key = tculling._route_key(state["tbi"], Q)
    assert tculling._ROUTE_CACHE == jculling._ROUTE_CACHE == {key: True}
    culled_calls = tculled.COUNT.plain
    raycast_calls = tsdf.RAYCAST_COUNT.plain
    second = tculling.query_sdf_culled(_tq(SCATTERED), *state["ttris"][:4],
                                       **kw)
    assert tculled.COUNT.plain == culled_calls
    assert tsdf.RAYCAST_COUNT.plain == raycast_calls + 1
    _assert_signed(second.numpy(), first.numpy())


# ------------------------------------------------------- per-tile routes
def test_query_culled_small_k_matches_jax(state):
    """The per-tile path without a block index: a tiny k overflows tiles,
    which are flagged alike and recomputed densely (normal sign)."""
    jt, tt = state["jtris"], state["ttris"]
    q = SCATTERED[:600]
    _, jo = jculling._query_culled_dist(_jq(q), *jt[:4],
                                        sign_method=jm.SignMethod.NORMAL,
                                        k=8, tile=256)
    td, to = tculling._query_culled_dist(_tq(q), *tt[:4],
                                         sign_method=tm.SignMethod.NORMAL,
                                         k=8, tile=256)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    assert to.any()
    want = jculling.query_sdf_culled(_jq(q), *jt[:4],
                                     sign_method=jm.SignMethod.NORMAL, k=8,
                                     tile=256)
    got = tculling.query_sdf_culled(_tq(q), *tt[:4],
                                    sign_method=tm.SignMethod.NORMAL, k=8,
                                    tile=256)
    _assert_signed(got.numpy(), want)
    _assert_signed(got.numpy(), _xla_port(q, tm.SignMethod.NORMAL))


def test_sign_structures_match_jax(state):
    """Sign grid mask, its transfer with the near-shell fallback, and the
    2-D parity bins with their crossing counts."""
    jt, tt = state["jtris"], state["ttris"]
    n = tt[4]
    tsg = tculling.build_sign_grid(*tt[:4], res=24)
    np.testing.assert_array_equal(tsg.inside.numpy(),
                                  np.asarray(state["jsg"].inside))
    q = RNG.uniform(-1.4, 1.4, (2000, 3)).astype(np.float32)
    d = _xla_port(q, tm.SignMethod.RAYCAST)
    d = np.abs(d)
    want = jculling.signs_from_grid(_jq(q), jnp.asarray(d), state["jsg"],
                                    *jt[:4])
    got = tculling.signs_from_grid(_tq(q), _tq(d), tsg, *tt[:4])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    counts = tculling._ray_parity_counts(_tq(q), *tt[:4], 3)
    np.testing.assert_array_equal(
        counts.numpy(), np.asarray(jculling._ray_parity_counts(
            _jq(q), *jt[:4], 3)))
    for axis in range(3):
        jb = jculling.build_parity_bins(*SOUP, axis)
        tb = tculling.build_parity_bins(*SOUP, axis)
        for a, b in zip(tb[:3], jb[:3]):
            assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    bins = tuple(tculling.build_parity_bins(*SOUP, axis) for axis in range(3))
    binned = tculling.binned_parity_counts(_tq(q), *tt[:3], bins, n_valid=n)
    np.testing.assert_array_equal(binned.numpy(), counts.numpy())


# ------------------------------------------------------------ entry points
@pytest.mark.parametrize("acceleration", [
    tm.AccelerationMethod.rtree_bvh(), tm.AccelerationMethod.rtree()],
    ids=["rtree_bvh-RAYCAST", "rtree-NORMAL"])
def test_generate_sdf_culled_matches_jax(acceleration):
    """Strategy.CULLED through the public API, both signs (1 200 queries:
    the per-tile path with the sign grid built per call, as on JAX's CPU
    route), against JAX and against the port's brute-force engine."""
    q = SCATTERED[:1200]
    v, f = MESH
    want = np.asarray(jm.generate_sdf(
        v, jm.Topology.triangle_list(f.reshape(-1)), q,
        jm.AccelerationMethod(jm.Strategy.CULLED,
                              jm.SignMethod[acceleration.sign_method.name])))
    got = tm.generate_sdf(v, tm.Topology.triangle_list(f.reshape(-1)), q,
                          acceleration, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (1200,)
    _assert_signed(got.numpy(), want)
    _assert_signed(got.numpy(), _xla_port(q, acceleration.sign_method))


@pytest.mark.parametrize("kwargs", [
    {"strategy": tm.Strategy.CULLED},
    {"strategy": tm.AccelerationMethod.rtree()},
    {"exact": True},
    {"exact": True, "sign_method": tm.SignMethod.NORMAL},
], ids=["CULLED", "rtree", "exact", "exact-NORMAL"])
def test_generate_grid_sdf_culled_matches_jax(kwargs):
    """The CULLED grid route (8³-cell tiles, top-512 triangles of 5 120),
    reached directly or through ``exact=True``, against JAX and against the
    port's XLA route. Even counts: no grid line runs through the mesh's
    vertices on a mid-plane."""
    v, f = MESH
    jg = jm.Grid.from_bounding_box([-1.3] * 3, [1.3] * 3, [12, 14, 10])
    jkw = {}
    for k, val in kwargs.items():
        if isinstance(val, tm.AccelerationMethod):
            val = jm.AccelerationMethod(jm.Strategy[val.strategy.name],
                                        jm.SignMethod[val.sign_method.name])
        elif isinstance(val, (tm.Strategy, tm.SignMethod)):
            val = getattr(jm, type(val).__name__)[val.name]
        jkw[k] = val
    want = np.asarray(jm.generate_grid_sdf(
        v, jm.Topology.triangle_list(f.reshape(-1)), jg, **jkw))
    topo = tm.Topology.triangle_list(f.reshape(-1))
    got = tm.generate_grid_sdf(v, topo, port_grid(jg), device="cpu",
                               **kwargs)
    assert_same_field(got.numpy(), want)
    sign = kwargs.get("sign_method", getattr(kwargs.get("strategy"),
                                             "sign_method",
                                             tm.SignMethod.RAYCAST))
    xla = tm.generate_grid_sdf(v, topo, port_grid(jg), sign,
                               strategy=tm.Strategy.XLA, device="cpu")
    assert_same_field(got.numpy(), xla.numpy())


def test_grid_culled_small_k_retry_matches_jax(state):
    """A tiny k overflows every tile; the one retry at the measured count
    is exact (tests/test_culling.py:91-111)."""
    jg = jm.Grid.from_bounding_box([-1.2] * 3, [1.2] * 3, [9, 9, 9])
    want = jculling.grid_distance_culled(jg, *state["jtris"][:4],
                                         sign=jm.SignMethod.RAYCAST, k=4)
    got = tculling.grid_distance_culled(port_grid(jg), *state["ttris"][:4],
                                        sign=tm.SignMethod.RAYCAST, k=4)
    assert got.shape == (9, 9, 9)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_select_candidates_bound_semantics():
    """Triangles beyond the bound are prunable; those within it are
    counted (tests/test_culling.py:114-136)."""
    ta = np.array([[0.0, 0, 0], [10, 0, 0], [11, 0, 0], [12, 0, 0]],
                  np.float32)
    tris = to_torch(ta, ta + np.float32([0.1, 0, 0]),
                    ta + np.float32([0, 0.1, 0]))
    valid = torch.ones(4, dtype=torch.bool)
    centers = torch.zeros((1, 3))
    idx, ovf, n_within = tculling.select_candidates(
        centers, torch.tensor(0.05), *tris, valid, k=2)
    assert int(idx[0, 0]) == 0 and not bool(ovf[0]) and int(n_within[0]) == 1
    _, ovf, n_within = tculling.select_candidates(
        centers, torch.tensor(100.0), *tris, valid, k=2)
    assert bool(ovf[0]) and int(n_within[0]) == 4
