"""The packed per-triangle records and the raycast kernel's triangle split,
on the CPU.

The records (``sdf.tri_records``, ``csrc/tri_record.cuh``) carry every
per-triangle term the raycast and culled kernels read. Their plain packing
must give, bit for bit, what the plain ladder (``sdf.closest_point_vw``) and
the JAX package's ``pallas_sdf._safe_recip`` give on the same triangles, so
that a kernel reading records computes what the plain versions compute. The
block index's record tables must unpack to its rows. The split rule gives
one chunk when the query tiles fill the card and several when they do not,
and combining per-chunk minima and counts reproduces the unsplit result.

Tolerances: none; every comparison is exact (int32 views of the floats).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from baselines import make_icosphere
from mesh_to_sdf_tpu.ops.kernels import pallas_sdf
from mesh_to_sdf_tpu_torch.ops.kernels import culled as tculled
from mesh_to_sdf_tpu_torch.ops.kernels import sdf as tsdf
from torch_port_helpers import soup, to_torch

F = {name: k for k, name in enumerate(tsdf.RECORD_FIELDS)}


def _degenerate():
    """Segment and point triangles (tests/test_pallas.py:105-113)."""
    rng = np.random.default_rng(3)
    a = rng.standard_normal((64, 3)).astype(np.float32)
    b = a.copy()  # b == a → segment [a, c]
    c = rng.standard_normal((64, 3)).astype(np.float32)
    b[32:] = c[32:]  # b == c → segment [a, b]
    c[48:] = a[48:]  # all equal → vertex a
    b[48:] = a[48:]
    return a, b, c


def _pad_rows():
    """The block index's pad triangles: a = PAD_COORD, zero edges."""
    a = np.full((8, 3), tculled.PAD_COORD, np.float32)
    return a, a.copy(), a.copy()


SOUPS = {
    "icosphere": lambda: soup(*make_icosphere(subdiv=2)),
    "degenerate": _degenerate,
    "pad": _pad_rows,
    "scattered": lambda: tuple(
        np.random.default_rng(7).uniform(-2, 2, (300, 3)).astype(np.float32)
        for _ in range(3)),
}


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("kind", ["raycast", "normal"])
@pytest.mark.parametrize("name", SOUPS)
def test_plain_records_match_the_ladder(name, kind):
    """a, ab, ac, A, B, C as ``closest_point_vw`` computes them, the four
    reciprocals as JAX's ``_safe_recip``, ac − ab (or, in a normal record,
    the normal as the normal kernel's stage computed it), and the
    degenerate flags as the ladder's masks."""
    ta, tb, tc = SOUPS[name]()
    a, b, c = to_torch(ta, tb, tc)
    before = tsdf.RECORDS_COUNT.plain
    rec = tsdf.tri_records(a, b, c, normal=kind == "normal")
    assert tsdf.RECORDS_COUNT.plain == before + 1
    assert rec.shape == (len(ta), len(F)) and rec.dtype == torch.float32
    r = rec.numpy()
    ab, ac = b - a, c - a
    zero = torch.zeros((len(ta), 1))
    *_, A, B, C = tsdf.closest_point_vw(
        zero, zero, zero, *(ab[None, :, k] for k in range(3)),
        *(ac[None, :, k] for k in range(3)))
    want = {"ax": a[:, 0], "ay": a[:, 1], "az": a[:, 2],
            "abx": ab[:, 0], "aby": ab[:, 1], "abz": ab[:, 2],
            "acx": ac[:, 0], "acy": ac[:, 1], "acz": ac[:, 2],
            "A": A[0], "B": B[0], "C": C[0]}
    if kind == "normal":
        # The operation order of the normal kernel's former stage
        # (sdf.cu) and of normal_raw_plain.
        want.update(nx=ab[:, 1] * ac[:, 2] - ab[:, 2] * ac[:, 1],
                    ny=ab[:, 2] * ac[:, 0] - ab[:, 0] * ac[:, 2],
                    nz=ab[:, 0] * ac[:, 1] - ab[:, 1] * ac[:, 0])
        assert tsdf.NORMAL_RECORD_FIELDS[:16] == tsdf.RECORD_FIELDS[:16]
        fields = {f: k for k, f in enumerate(tsdf.NORMAL_RECORD_FIELDS)}
    else:
        want.update(e12x=ac[:, 0] - ab[:, 0], e12y=ac[:, 1] - ab[:, 1],
                    e12z=ac[:, 2] - ab[:, 2])
        fields = F
    for field, w in want.items():
        np.testing.assert_array_equal(_bits(r[:, fields[field]]), _bits(w),
                                      err_msg=field)
    jA, jB, jC = (jnp.asarray(x[0].numpy()) for x in (A, B, C))
    for field, x in (("inv_a", jA), ("inv_c", jC),
                     ("inv_bc", jA - 2.0 * jB + jC),
                     ("inv_den", jA * jC - jB * jB)):
        np.testing.assert_array_equal(_bits(r[:, F[field]]),
                                      _bits(pallas_sdf._safe_recip(x)),
                                      err_msg=field)
    eq_ab = (ab == 0).all(1).numpy()
    eq_ac = (ac == 0).all(1).numpy()
    eq_bc = (ab == ac).all(1).numpy()
    flags = ((eq_bc | eq_ac) * 1 + eq_ab * 2 + (eq_ab & eq_bc) * 4)
    np.testing.assert_array_equal(_bits(r[:, F["flags"]]), flags)
    if name in ("degenerate", "pad"):
        assert flags.any()


def test_records_from_edges_equal_records_from_vertices():
    """``edges=True`` on (a, b − a, c − a) packs what the vertices pack,
    also from strided plane views like the block index's."""
    ta, tb, tc = SOUPS["scattered"]()
    a, b, c = to_torch(ta, tb, tc)
    want = tsdf.tri_records(a, b, c)
    planes = torch.cat([a.t(), (b - a).t(), (c - a).t()]).contiguous()
    got = tsdf.tri_records(planes[0:3].t(), planes[3:6].t(),
                           planes[6:9].t(), edges=True)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("table", ["rows", "gather_rows"])
@pytest.mark.parametrize("drop", [0, 7], ids=["T=5120", "T=5113"])
def test_block_index_records_unpack_to_rows(table, drop):
    """Both cached tables hold their rows exactly (a, ab, ac of every
    triangle, the pad block included) and the pad block packs as a vertex
    at PAD_COORD."""
    tris = tuple(t[:len(t) - drop] for t in soup(*make_icosphere(subdiv=4)))
    bi = tculled.build_block_index(*tris, device="cpu")
    rows = getattr(bi, table)
    rec = tculled.table_records(rows)
    assert rec.shape == (bi.n_blocks + 1, bi.tb, len(F))
    assert tculled.table_records(getattr(bi, table)) is rec
    fields = [F[f] for f in ("ax", "ay", "az", "abx", "aby", "abz",
                             "acx", "acy", "acz")]
    back = rec[:, :, fields].permute(0, 2, 1)
    assert torch.equal(back.contiguous().view(torch.int32),
                       rows.view(torch.int32))
    pad = rec[-1].numpy()
    assert (_bits(pad[:, F["flags"]]) == 7).all()
    for field in ("A", "B", "C", "inv_a", "inv_c", "inv_bc", "inv_den"):
        assert (pad[:, F[field]] == 0).all(), field


def test_table_records_follow_their_table():
    """A table's records are packed once and kept while the table lives;
    a table written in place, or another table of the same content, is
    packed anew; the entry goes with its table."""
    tris = soup(*make_icosphere(subdiv=3))
    rows = tculled.build_block_index(*tris, device="cpu").rows.clone()
    before = tsdf.RECORDS_COUNT.plain
    rec = tculled.table_records(rows)
    assert tculled.table_records(rows) is rec
    assert tsdf.RECORDS_COUNT.plain == before + 1
    twin = rows.clone()
    assert tculled.table_records(twin) is not rec
    key = id(rows)
    rows[0, 0, 0] += 1.0
    moved = tculled.table_records(rows)
    assert moved is not rec and not torch.equal(moved, rec)
    assert moved[0, 0, F["ax"]] == rows[0, 0, 0]
    assert tsdf.RECORDS_COUNT.plain == before + 3
    del rows, moved
    assert key not in tculled._TABLE_RECORDS


def test_tri_records_wrapper_validates_inputs():
    a, b, c = to_torch(*SOUPS["scattered"]())
    with pytest.raises(ValueError, match="b: want"):
        tsdf.tri_records(a, b[:5], c)
    with pytest.raises(ValueError, match="strides"):
        tsdf.tri_records(a, b.t().contiguous().t(), c)
    with pytest.raises(ValueError, match="float32"):
        tsdf.tri_records(a.double(), b, c)
    with pytest.raises(ValueError, match="no kernel"):
        tsdf.tri_records(a.to("meta"), b.to("meta"), c.to("meta"))


@pytest.mark.parametrize("case", [
    # (queries, triangles, SMs, chunks): the paths' shapes on 132 SMs.
    (1_000_000, 20_480, 132, 1),       # PALLAS 1M queries
    (2_097_152, 20_480, 132, 1),       # 128³ cell centres
    (800_000, 1_310_720, 132, 1),      # CULLED host fallback
    (4_577, 1_310_720, 132, 59),       # CULLED fix-up (k_fix)
    (65_536, 20_480, 132, 5),
    (1, 81_920, 132, 160),             # capped by the chunk floor of 512
    (37, 64, 132, 1),                  # too few triangles to split
    (0, 100, 132, 1),
], ids=lambda c: f"Q{c[0]}-T{c[1]}")
def test_raycast_chunk_rule(case):
    Q, T, sms, want = case
    chunks = tsdf.raycast_chunks(Q, T, sms)
    assert chunks == want
    length = tsdf._chunk_len(T, chunks)
    assert length % tsdf.RAYCAST_TILE == 0
    assert -(-T // length) <= chunks and length * chunks >= T
    if chunks > 1:
        assert length >= tsdf.RAYCAST_MIN_CHUNK


@pytest.mark.parametrize("chunks", [2, 3, 7])
def test_split_combination_is_exact(chunks):
    """The kernel's split: each chunk's minimum d² and counts, combined by
    min (of the int bits of non-negative floats) and sum, equal the
    unsplit plain result."""
    ta, tb, tc = to_torch(*soup(*make_icosphere(subdiv=2)))
    q = torch.from_numpy(np.random.default_rng(chunks).uniform(
        -1.5, 1.5, (200, 3)).astype(np.float32))
    want_d, want_c = tsdf.raycast_raw(q, ta, tb, tc, raycast_axes=3)
    length = tsdf._chunk_len(ta.shape[0], chunks)
    bits = torch.full((200,), np.float32(3.4028235e38).view(np.int32).item(),
                      dtype=torch.int32)
    counts = torch.zeros_like(want_c)
    n = 0
    for s in range(0, ta.shape[0], length):
        d, cnt = tsdf.raycast_raw_plain(q, ta[s:s + length], tb[s:s + length],
                                        tc[s:s + length], raycast_axes=3)
        assert not torch.signbit(d).any()
        bits = torch.minimum(bits, d.view(torch.int32))
        counts += cnt
        n += 1
    assert n > 1
    assert torch.equal(bits, want_d.view(torch.int32))
    assert torch.equal(counts, want_c)


@pytest.mark.parametrize("name", ["icosphere", "degenerate", "scattered"])
def test_normal_from_records_matches_plain(name):
    """What the normal kernel computes from a normal record (the ladder on
    its a, ab, ac, the side from its n) equals ``normal_raw_plain`` bit for
    bit, with each side's minimum taken as the kernel takes it."""
    ta, tb, tc = to_torch(*SOUPS[name]())
    q = torch.from_numpy(np.random.default_rng(5).uniform(
        -2.0, 2.0, (300, 3)).astype(np.float32))
    rec = tsdf.tri_records(ta, tb, tc, normal=True)
    fields = {f: k for k, f in enumerate(tsdf.NORMAL_RECORD_FIELDS)}

    def col(*names):
        return tuple(rec[None, :, fields[n]] for n in names)

    a = col("ax", "ay", "az")
    ap = tuple(q[:, k:k + 1] - a[k] for k in range(3))
    d2 = tsdf.dist2(*ap, *tsdf.closest_point_vw(
        *ap, *col("abx", "aby", "abz"), *col("acx", "acy", "acz")))
    n = col("nx", "ny", "nz")
    pos = ap[0] * n[0] + ap[1] * n[1] + ap[2] * n[2] > 0.0
    big = torch.tensor(np.float32(3.4028235e38))
    want_pos, want_neg = tsdf.normal_raw_plain(q, ta, tb, tc)
    assert torch.equal(torch.where(pos, d2, big).amin(1).view(torch.int32),
                       want_pos.view(torch.int32))
    assert torch.equal(torch.where(pos, big, d2).amin(1).view(torch.int32),
                       want_neg.view(torch.int32))


@pytest.mark.parametrize("case", [
    # (queries, triangles, SMs, chunks) of the normal kernel (512 queries
    # per CTA): PALLAS 1M, the 4 577-query fallback shape, 65 536, tiny.
    (1_000_000, 20_480, 132, 1),
    (4_577, 1_310_720, 132, 118),
    (65_536, 20_480, 132, 9),
    (37, 64, 132, 1),
], ids=lambda c: f"Q{c[0]}-T{c[1]}")
def test_normal_chunk_rule(case):
    Q, T, sms, want = case
    chunks = tsdf.raycast_chunks(Q, T, sms, tsdf.NORMAL_CTA_QUERIES)
    assert chunks == want
    length = tsdf._chunk_len(T, chunks)
    assert -(-T // length) <= chunks and length * chunks >= T
