"""The port's IVF probe vs tpuvdb.kernels.pallas_ivf.

* The plain twins of the two CUDA kernels (`ivf_candidates_plain`,
  `ivf_candidates_packed_plain`, reached through the wrappers on CPU
  tensors) are held against `pallas_ivf_candidates` and
  `pallas_ivf_candidates_packed` in interpret mode on the same chunk lists,
  segments and offsets, in f32 and bf16: candidate ids identical, candidate
  scores within rtol 1e-4 (products are exact in f32 in both; only the
  summation order differs), plus atol 1e-5 for a score near 0, where 2 q.x
  and ||x||^2 of size ~d cancel. The inputs hold exact ties: chunks that are
  copies of chunk 0 land in chunk 0's slots, and the lowest row must win in
  both, also where the lower copy is dead.
* `ivf_probe_search` is held against `pallas_ivf_search(interpret=True)`
  in both forms at k=10 and k=200, with spill rows and deleted rows: ids
  identical, distances within rtol 1e-5 plus atol 1e-4 (||q||^2 - (2 q.x -
  ||x||^2) cancels to a few f32 ulps of ||x||^2 ~ 1e2 for near neighbours).

The CUDA kernels cannot run here; `test_kernel_matches_plain_on_card` holds
them against the plain twins when a card is present. The card tests need
no JAX (only the `ref` fixture imports it), so they run there with no
conftest:

    python -m pytest --noconftest -q -m cuda tests/test_torch_ivf_probe.py
"""

import types

import numpy as np
import pytest
import torch

from tpuvdb_torch.kernels import ivf_probe

NEG_INF = ivf_probe.NEG_INF
SCORE_RTOL, SCORE_ATOL = 1e-4, 1e-5


@pytest.fixture()
def ref():
    """The JAX reference: jax.numpy and tpuvdb.kernels.pallas_ivf."""
    import jax.numpy as jnp

    from tpuvdb.index.ivf import IVFIndex
    from tpuvdb.kernels import pallas_ivf

    assert pallas_ivf.NEG_INF == NEG_INF
    return types.SimpleNamespace(jnp=jnp, ivf=pallas_ivf, IVFIndex=IVFIndex)


def _cells_inputs(rng, n_chunks=24, d=24, n_dead=40):
    """A grouped array whose chunks 8, 16 are copies of chunk 0 (exact
    ties in one slot in both forms' segment rules), one dead copy below a
    live one, and ~n_dead other dead rows."""
    n = n_chunks * 128
    grouped = rng.standard_normal((n, d)).astype(np.float32)
    for c in (8, 16):
        grouped[c * 128:(c + 1) * 128] = grouped[:128]
    mask = np.zeros(n, np.float32)
    mask[rng.choice(np.arange(128, n), n_dead, replace=False)] = NEG_INF
    mask[5] = NEG_INF            # chunk 0 row 5 dead: chunk 8's copy wins
    mask[8 * 128 + 5] = 0.0
    sq = np.einsum("nd,nd->n", grouped, grouped).astype(np.float32)
    return grouped, sq, mask


def _expanded_lists(rng, tiles, n_chunks, width, n_segments):
    """Per tile: sorted chunk ids (all of 0..n_chunks-1 plus random
    repeats) and the reference's segments, rank among distinct mod S."""
    cells = []
    for _ in range(tiles):
        extra = rng.integers(0, n_chunks, width - n_chunks)
        cells.append(np.sort(np.concatenate([np.arange(n_chunks), extra])))
    cells = np.asarray(cells, np.int32)
    distinct = np.ones_like(cells, bool)
    distinct[:, 1:] = cells[:, 1:] != cells[:, :-1]
    segs = (np.cumsum(distinct, axis=1) - 1) % n_segments
    return cells, segs.astype(np.int32)


def _to(a, dtype=None):
    t = torch.from_numpy(np.array(a))  # a writable copy
    return t if dtype is None else t.to(dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_expanded_plain_matches_pallas(rng, ref, dtype):
    jnp = ref.jnp
    n_chunks, qt, tiles, n_seg = 24, 4, 2, 4
    grouped, sq, mask = _cells_inputs(rng, n_chunks)
    cells, segs = _expanded_lists(rng, tiles, n_chunks, 32, n_seg)
    q = rng.standard_normal((tiles * qt, grouped.shape[1])).astype(np.float32)
    q[0] = grouped[3]  # its best rows tie across the copies of chunk 0
    q[1] = grouped[5]  # ... where the lowest copy is dead
    val, idx = ivf_probe.ivf_candidates(
        _to(q), _to(cells), _to(segs), _to(grouped, getattr(torch, dtype)),
        _to(sq), _to(mask), n_segments=n_seg, query_tile=qt)
    jval, jidx = ref.ivf.pallas_ivf_candidates(
        jnp.asarray(q), jnp.asarray(cells), jnp.asarray(segs),
        jnp.asarray(grouped, getattr(jnp, dtype)), jnp.asarray(sq)[None],
        jnp.asarray(mask)[None], cell_pad=128, n_buckets=128,
        query_tile=qt, n_segments=n_seg, cps=1, interpret=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(val.numpy(), np.asarray(jval),
                               rtol=SCORE_RTOL, atol=SCORE_ATOL)
    _check_ties(idx.numpy(), mask)


def _check_ties(ids, mask):
    """Chunks 8 and 16 copy chunk 0 and share its slots: the lowest live
    copy wins."""
    assert (ids[0] == 3).any()
    assert not np.isin(ids, [8 * 128 + 3, 16 * 128 + 3]).any()
    assert not (ids == 5).any() and (ids[1] == 8 * 128 + 5).any()
    assert not (ids == 16 * 128 + 5).any()
    assert not np.isin(ids, np.flatnonzero(mask < 0)).any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compact_plain_matches_pallas(rng, ref, dtype):
    jnp = ref.jnp
    n_chunks, qt, tiles, n_seg, w128 = 24, 4, 2, 8, 3
    grouped, sq, mask = _cells_inputs(rng, n_chunks)
    # 12 cells, one every 2 chunks: windows of 3 chunks over-scan into the
    # next cell (a chunk reached from two cells) and clamp at the last one
    nlist = 12
    off128 = np.arange(0, 2 * nlist, 2, dtype=np.int32)
    cells = np.sort(np.concatenate(
        [np.tile(np.arange(nlist), (tiles, 1)),
         rng.integers(0, nlist, (tiles, 4))], axis=1), axis=1)
    cells = cells.astype(np.int32)
    q = rng.standard_normal((tiles * qt, grouped.shape[1])).astype(np.float32)
    q[0] = grouped[3]
    q[1] = grouped[5]
    val, idx = ivf_probe.ivf_candidates_packed(
        _to(q), _to(cells), _to(off128), _to(grouped, getattr(torch, dtype)),
        _to(sq), _to(mask), w128=w128, n_segments=n_seg, query_tile=qt)
    jval, jidx = ref.ivf.pallas_ivf_candidates_packed(
        jnp.asarray(q), jnp.asarray(cells), jnp.asarray(off128),
        jnp.asarray(grouped, getattr(jnp, dtype)), jnp.asarray(sq)[None],
        jnp.asarray(mask)[None], w128=w128, n_buckets=128, query_tile=qt,
        n_segments=n_seg, cps=1, interpret=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(val.numpy(), np.asarray(jval),
                               rtol=SCORE_RTOL, atol=SCORE_ATOL)
    _check_ties(idx.numpy(), mask)


def _clustered_index(ref, rng, n_clusters=8, per=160, d=16, **build):
    centers = rng.standard_normal((n_clusters, d)) * 2
    data = np.concatenate([
        centers[i] + 0.3 * rng.standard_normal((per, d))
        for i in range(n_clusters)]).astype(np.float32)
    valid = np.ones(len(data), bool)
    idx = ref.IVFIndex.build(data, valid, nlist=n_clusters,
                             nprobe=n_clusters, kmeans_iters=6, **build)
    return data, idx


@pytest.mark.parametrize("force_compact", [False, True])
@pytest.mark.parametrize("k", [10, 200])
def test_probe_search_matches_pallas_ivf_search(rng, ref, force_compact, k):
    jnp = ref.jnp
    # no bisection and a median cap: the larger cells spill
    data, j = _clustered_index(ref, rng, split_oversized=False,
                               cell_cap_quantile=0.5)
    assert j.stats().spill_rows > 0
    j.invalidate_rows(np.arange(0, len(data), 13))
    q = data[rng.choice(len(data), 10, replace=False)] + 0.05 * \
        rng.standard_normal((10, data.shape[1])).astype(np.float32)
    args = dict(cell_pad=j.cell_pad, k=k, nprobe=3, query_tile=8,
                force_compact=force_compact)
    jd, jg = ref.ivf.pallas_ivf_search(
        jnp.asarray(q), j.centroids, j.grouped, j.grouped_sq,
        j.grouped_valid, interpret=True, cell_offsets=j.cell_offsets,
        spill=j.spill, spill_sq=j.spill_sq, spill_valid=j.spill_valid,
        **args)
    td, tg = ivf_probe.ivf_probe_search(
        _to(q), _to(np.asarray(j.centroids)), _to(np.asarray(j.grouped)),
        _to(np.asarray(j.grouped_sq)), _to(np.asarray(j.grouped_valid)),
        _to(np.asarray(j.cell_offsets)), spill=_to(np.asarray(j.spill)),
        spill_sq=_to(np.asarray(j.spill_sq)),
        spill_valid=_to(np.asarray(j.spill_valid)), **args)
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-4)
    ids = tg.numpy()
    n_g = j.grouped.shape[0]
    assert (ids >= n_g).any()                       # spill rows served
    dead = np.flatnonzero(~np.asarray(j.grouped_valid))
    assert not np.isin(ids, dead).any()
    live = ids[0][ids[0] >= 0]
    assert len(set(live.tolist())) == len(live)     # no duplicates


def test_plan_picks_form_by_size():
    """Expanded while Q_pad * nprobe * w128 <= 2**20, compact above it or
    when forced; compact doubles the segments."""
    cents = torch.eye(4, 8)
    offs = torch.tensor([0, 256, 512, 768], dtype=torch.int32)
    q = torch.ones((3, 8))
    p = ivf_probe.probe_plan(q, cents, offs, cell_pad=256, k=10, nprobe=2)
    assert not p.compact and p.query_tile == 3 and p.n_segments == 4
    assert p.cells.shape == (1, 3 * 2 * 2)
    p = ivf_probe.probe_plan(q, cents, offs, 256, 10, 2, force_compact=True)
    assert p.compact and p.n_segments == 8 and p.cells.shape == (1, 6)
    # 8 * 4 * 2 = 64 entries per tile: 2**14 tiles reach 2**20 exactly
    at = ivf_probe.probe_plan(torch.ones((1 << 17, 8)), cents, offs, 256,
                              300, 4)
    assert not at.compact and at.n_segments == 5
    above = ivf_probe.probe_plan(torch.ones(((1 << 17) + 8, 8)), cents,
                                 offs, 256, 300, 4)
    assert above.compact and above.n_segments == 2 * 5
    with pytest.raises(ValueError, match="empty query batch"):
        ivf_probe.probe_plan(torch.zeros((0, 8)), cents, offs, 256, 10, 2)


def test_wrappers_reject_what_the_kernels_do_not_take():
    x = torch.zeros((128, 4), dtype=torch.int8, device="meta")
    z = torch.zeros(128, device="meta")
    cells = torch.zeros((1, 1), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ivf_probe.ivf_candidates(torch.zeros((8, 4), device="meta"), cells,
                                 cells, x, z, z, 4, 8)


ON_BOTH = pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])


def _skip_without_card(device):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the IVF probe kernels have no CPU "
                    "mode")


@pytest.mark.parametrize("case,match", [
    ("tiles", "one row per tile"),
    ("segs_shape", "shape of cells"),
    ("off128_dim", "off128 must be 1-D"),
])
@ON_BOTH
def test_wrappers_reject_malformed_lists(case, match, device):
    """The kernels index the queries and the outputs by tile, so both
    wrappers raise on lists of the wrong shape, on either device."""
    _skip_without_card(device)
    d, n_seg, qt = 4, 4, 8
    grouped = torch.zeros((256, d), device=device)
    z = torch.zeros(256, device=device)
    q = torch.zeros((16, d), device=device)         # two tiles
    cells = torch.zeros((2, 3), dtype=torch.int32, device=device)
    segs = torch.zeros((2, 3), dtype=torch.int32, device=device)
    off128 = torch.zeros(2, dtype=torch.int32, device=device)
    if case == "off128_dim":
        with pytest.raises(ValueError, match=match):
            ivf_probe.ivf_candidates_packed(q, cells, off128[None], grouped,
                                            z, z, 1, n_seg, qt)
        return
    if case == "tiles":
        q = torch.zeros((8, d), device=device)
    else:
        segs = torch.zeros((2, 2), dtype=torch.int32, device=device)
    with pytest.raises(ValueError, match=match):
        ivf_probe.ivf_candidates(q, cells, segs, grouped, z, z, n_seg, qt)


@pytest.mark.parametrize("case", [
    "segment_high", "segment_negative", "cell_high", "cell_negative"])
@ON_BOTH
def test_out_of_range_entries_score_nothing(case, device):
    """An entry whose segment (expanded) or cell id (compact) is out of
    range is skipped, in the kernel and in the plain twin alike: the result
    equals that of the same probe with the entry's rows dead or the entry
    left out, and nothing outside the arrays is touched."""
    _skip_without_card(device)
    rng = np.random.default_rng(7)
    n_chunks, d, qt, tiles, n_seg = 8, 16, 4, 2, 4
    grouped = rng.standard_normal((n_chunks * 128, d)).astype(np.float32)
    sq = np.einsum("nd,nd->n", grouped, grouped).astype(np.float32)
    q = rng.standard_normal((tiles * qt, d)).astype(np.float32)
    g, sq_t, q_t = (_to(a).to(device) for a in (grouped, sq, q))
    mask = torch.zeros(n_chunks * 128, device=device)

    def i32(a):
        return torch.tensor(a, dtype=torch.int32, device=device)

    if case.startswith("segment"):
        cells = i32([list(range(n_chunks))] * tiles)
        segs = i32([[c % n_seg for c in range(n_chunks)]] * tiles)
        bad = segs.clone()
        bad[:, 3] = n_seg if case == "segment_high" else -1
        dead = mask.clone()
        dead[3 * 128:4 * 128] = NEG_INF
        got = ivf_probe.ivf_candidates(q_t, cells, bad, g, sq_t, mask, n_seg,
                                       qt)
        want = ivf_probe.ivf_candidates(q_t, cells, segs, g, sq_t, dead,
                                        n_seg, qt)
    else:
        off128 = i32([0, 2, 4, 6])
        extra = 4 if case == "cell_high" else -1
        cells = i32([[0, 1, 2, 3]] * tiles)
        bad = i32([sorted([0, 1, 2, 3, extra])] * tiles)
        got = ivf_probe.ivf_candidates_packed(q_t, bad, off128, g, sq_t, mask,
                                              2, n_seg, qt)
        want = ivf_probe.ivf_candidates_packed(q_t, cells, off128, g, sq_t,
                                               mask, 2, n_seg, qt)
    assert (want[1] >= 0).any()
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("nq", [1, 7, 37, 64, 200])
@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("dtype,d,offset", [
    (torch.float32, 128, 0), (torch.float32, 100, 0),
    (torch.bfloat16, 128, 0), (torch.bfloat16, 100, 0),
    # off TMA's layouts: a row stride off 16 bytes (f32 d = 99) and a base
    # `offset` elements past a 16-byte boundary
    (torch.float32, 99, 0), (torch.float32, 128, 1),
    (torch.bfloat16, 96, 1),
])
def test_kernel_matches_plain_on_card(nq, compact, dtype, d, offset):
    """Q = 1 and 7 walk one tile's list (width-8 product); 37, 64 and 200
    go in groups of 5, 8 and 16 tiles through the group table (products
    64, 64 and 128 wide; 200 leaves a last group of 9 tiles)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the IVF probe kernels have no CPU "
                    "mode")
    gen = torch.Generator(device="cuda").manual_seed(0)
    nlist, cell_pad = 64, 256
    n_g = nlist * cell_pad + cell_pad
    flat = torch.randn(n_g * d + offset, generator=gen,
                       device="cuda").to(dtype)
    grouped = flat[offset:].view(n_g, d)
    sq = grouped.float().pow(2).sum(dim=1)
    valid = torch.rand(n_g, generator=gen, device="cuda") >= 0.01
    cents = torch.randn((nlist, d), generator=gen, device="cuda")
    offs = torch.arange(nlist, dtype=torch.int32, device="cuda") * cell_pad
    q = torch.randn((nq, d), generator=gen, device="cuda")
    mask = torch.zeros(n_g, device="cuda").masked_fill_(~valid, NEG_INF)
    plan = ivf_probe.probe_plan(q, cents, offs, cell_pad, k=10, nprobe=8,
                                force_compact=compact)
    launches = (ivf_probe.LAUNCHES_COMPACT if compact
                else ivf_probe.LAUNCHES_EXPANDED)
    val, idx = ivf_probe.plan_candidates(plan, grouped, sq, mask)
    after = (ivf_probe.LAUNCHES_COMPACT if compact
             else ivf_probe.LAUNCHES_EXPANDED)
    assert after == launches + 1
    pval, pidx = ivf_probe.plan_candidates(plan, grouped, sq, mask,
                                           plain=True)
    torch.cuda.synchronize()
    assert (idx == pidx).float().mean().item() >= 0.999
    torch.testing.assert_close(val, pval, rtol=1e-5, atol=1e-3)
