"""The port's IVF-PQ probe vs tpuvdb.kernels.pallas_pq (on the CPU).

`pq_probe_search` (through the plain twin `pq_candidates_plain`, which the
wrapper takes on CPU tensors) is held against
`pallas_pq_search(..., interpret=True)` on an `IVFIndex` built by the JAX
package and handed to the port with `IVFIndex.from_numpy`: the 8-bit tier,
the 4-bit tier, OPQ, spill rows, deleted rows, a tile under 8 queries
(Q = 3), a padded batch (Q = 20), k = 10 and the PQ rescore window k = 640.

Tolerances. Both sum the same bf16-rounded LUT entries in f32, but the
reference contracts a one-hot in one dot and the port adds the subspaces in
ascending order, and the two frameworks order the f32 sums of the coarse
product and of the LUT build differently. Distances (up to a few hundred)
therefore agree within DIST_ATOL = 2e-3, not bit for bit, with one
exception: a LUT entry that lies on a bf16 rounding boundary may round to
either side, which moves every distance through that entry by one bf16 ulp
of it (2**-8 of the entry, entries stay below 16). At most FLIP_SHARE of
the distances may differ by more than DIST_ATOL, and none by more than
FLIP_ATOL = 2**-4. Ids must be equal except at near-ties: a position may
differ only where the reference's distance for the port's id lies within
the row's largest distance difference plus NEAR_TIE of the distance at that
position (or the id fell past the cut after the kth candidate). The
reconstruction `_recon_dist` (numpy, f32 codebooks) must lie within the
rounding bound of the bf16 LUT: 2**-8 of the largest entry of each
subspace, summed over the subspaces.

The kernel's layout is held here by a numpy emulation (`_emulate_kernel`):
its interleaved table ([m][code][query of the block's group]), read a
group's entries a load and summed in the kernel's order, gives the twin's
candidates bit for bit, for 256 and 16 codes and groups of 8, 4, 2 and 1,
and in place of the wrapper it holds pallas_pq_search's results at the
tolerances above; `lut_group` picks the widest group whose table fits in a
block's shared memory.

The CUDA kernel cannot run here; `test_pq_kernel_matches_plain_on_card`
holds it against the twin, bit for bit, when a card is present:

    python -m pytest --noconftest -q -m cuda tests/test_torch_pq_probe.py
"""

import types

import numpy as np
import pytest
import torch

from tpuvdb_torch.index.ivf import IVFIndex as TorchIVFIndex
from tpuvdb_torch.kernels import ivf_probe, pq_probe
from tpuvdb_torch.kernels import pq as tpq

NEG_INF = ivf_probe.NEG_INF
DIST_ATOL = 2e-3
NEAR_TIE = 4e-3
FLIP_ATOL = 2.0 ** -4
FLIP_SHARE = 0.005


@pytest.fixture()
def ref():
    """The JAX reference: jax.numpy, its IVFIndex and pallas_pq_search."""
    import jax.numpy as jnp

    from tpuvdb.index.ivf import IVFIndex
    from tpuvdb.kernels.pallas_pq import pallas_pq_search

    return types.SimpleNamespace(jnp=jnp, IVFIndex=IVFIndex,
                                 search=pallas_pq_search)


def _clustered(rng, n, d, n_clusters=32, noise=0.3):
    cents = rng.standard_normal((n_clusters, d)).astype(np.float32) * 3.0
    who = rng.integers(0, n_clusters, n)
    return (cents[who] + noise * rng.standard_normal((n, d))).astype(
        np.float32)


def port_index(idx, device="cpu") -> TorchIVFIndex:
    """The port's IVFIndex over a JAX IVF-PQ index's arrays."""
    a = np.asarray
    return TorchIVFIndex.from_numpy(
        centroids=a(idx.centroids), grouped=a(idx.grouped),
        grouped_sq=a(idx.grouped_sq), grouped_valid=a(idx.grouped_valid),
        row_ids=a(idx.row_ids), spill=a(idx.spill), spill_sq=a(idx.spill_sq),
        spill_valid=a(idx.spill_valid), spill_row_ids=a(idx.spill_row_ids),
        cell_offsets=a(idx.cell_offsets), cell_lens=a(idx.cell_lens),
        cell_pad=idx.cell_pad, nprobe=idx.nprobe, device=device,
        pq_codebooks=a(idx.pq_codebooks), spill_cells=a(idx.spill_cells),
        pq_rotation=(a(idx.pq_rotation) if idx.pq_rotation is not None
                     else None),
        pq_err=idx.pq_err)


def _ref_search(ref, idx, q, k, nprobe):
    dist, gid = ref.search(
        ref.jnp.asarray(q), idx.centroids, idx.grouped, idx.pq_codebooks,
        idx.grouped_sq, idx.grouped_valid, idx.spill, idx.spill_cells,
        idx.spill_sq, idx.spill_valid, idx.cell_offsets,
        cell_pad=idx.cell_pad, k=k, nprobe=nprobe, rotation=idx.pq_rotation,
        query_tile=8, cps=4, interpret=True)
    return np.asarray(dist), np.asarray(gid)


def _port_search(port, q, k, nprobe):
    dist, gid = pq_probe.pq_probe_search(
        torch.from_numpy(q), port.centroids, port.grouped, port.pq_codebooks,
        port.grouped_sq, port.grouped_valid, port.spill, port.spill_cells,
        port.spill_sq, port.spill_valid, port.cell_offsets,
        cell_pad=port.cell_pad, k=k, nprobe=nprobe,
        rotation=port.pq_rotation)
    return dist.numpy(), gid.numpy()


def _hold(want_d, want_g, got_d, got_g):
    """Distances within DIST_ATOL; ids equal except at near-ties."""
    assert want_d.shape == got_d.shape
    assert np.array_equal(np.isfinite(want_d), np.isfinite(got_d))
    fin = np.isfinite(want_d)
    diff = np.where(fin, np.abs(got_d - want_d), 0.0)
    assert diff.max() <= FLIP_ATOL, diff.max()
    assert (diff > DIST_ATOL).mean() <= FLIP_SHARE, (diff > DIST_ATOL).mean()
    assert np.array_equal(want_g[~fin], got_g[~fin])  # -1 both
    differ = fin & (want_g != got_g)
    for qi, pos in zip(*np.nonzero(differ)):
        # the id the port put here sits, in the reference's row, at a
        # distance close to this position's (or past the cut)
        d_here = want_d[qi, pos]
        where = np.flatnonzero(want_g[qi] == got_g[qi, pos])
        other = want_d[qi, where[0]] if len(where) else want_d[qi][
            np.isfinite(want_d[qi])].max()
        gap = diff[qi].max() + NEAR_TIE
        assert abs(other - d_here) <= gap, (qi, pos, d_here, other)
    assert differ.mean() < 0.02, differ.mean()


def _recon_dist(port, queries, grouped_rows):
    """Numpy oracle for the reconstructed distance of grouped rows:
    ||q - (c_cell + r_hat)||^2 from the stored codes and codebooks (as
    tests/test_pallas_pq.py:_recon_dist)."""
    cb = port.pq_codebooks_np()
    r_hat = tpq.decode_pq(port.grouped.numpy()[grouped_rows], cb,
                          rotation=port.pq_rotation_np())
    cell_of = np.searchsorted(port.cell_offsets_np, grouped_rows,
                              side="right") - 1
    x_hat = port.centroids_np()[cell_of] + r_hat
    return np.sum((queries[:, None, :] - x_hat[None]) ** 2, axis=-1)


CASES = {
    "8bit": dict(pq_subq=8, nlist=48, nprobe=16, seed=2),
    "4bit": dict(pq_subq=4, pq_bits=4, nlist=32, nprobe=16, seed=3),
    "opq": dict(pq_subq=8, opq=True, nlist=48, nprobe=16, seed=2),
    "spill": dict(pq_subq=8, nlist=8, nprobe=8, seed=4,
                  split_oversized=False, cell_cap_quantile=0.5),
}


def _built(ref, rng, case):
    kw = dict(CASES[case])
    n = 3072 if case == "spill" else 6144
    x = _clustered(rng, n, 32, n_clusters=8 if case == "spill" else 32)
    idx = ref.IVFIndex.build(x, np.ones(n, bool), kmeans_iters=6, **kw)
    return x, idx


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("nq,k", [(3, 10), (20, 640)])
def test_plain_probe_matches_pallas_pq_search(rng, ref, case, nq, k):
    x, idx = _built(ref, rng, case)
    if case == "spill":
        assert idx.stats().spill_rows > 0
    # deleted rows: every 7th row of the corpus, before the hand-over
    idx.invalidate_rows(np.arange(0, len(x), 7))
    port = port_index(idx)
    assert port.pq and port.grouped.dtype == torch.uint8
    q = x[rng.choice(len(x), nq, replace=False)].copy()
    nprobe = CASES[case]["nprobe"]
    want_d, want_g = _ref_search(ref, idx, q, k, nprobe)
    got_d, got_g = _port_search(port, q, k, nprobe)
    _hold(want_d, want_g, got_d, got_g)
    n_g = port.grouped.shape[0]
    if case == "spill":
        assert (got_g >= n_g).any()  # spill candidates surface
    # no deleted row comes back
    g = got_g[(got_g >= 0) & (got_g < n_g)]
    assert not (port.row_ids[g] % 7 == 0).any()
    # against the numpy reconstruction, within the bf16 LUT's rounding
    # bound (plus 1e-3 for the f32 sums)
    lut = tpq.pq_lut(torch.from_numpy(q), port.pq_codebooks,
                     port.pq_rotation).numpy()
    bound = np.abs(lut).max(axis=2).sum(axis=1) * 2.0 ** -8 + 1e-3
    for i in range(min(nq, 4)):
        sel = (got_g[i] >= 0) & (got_g[i] < n_g)
        rows = got_g[i][sel][:20]
        want = _recon_dist(port, q[i:i + 1], rows)[0]
        np.testing.assert_allclose(got_d[i][sel][:20], want, rtol=0,
                                   atol=bound[i])


def test_index_search_matches_the_probe(rng, ref):
    """IVFIndex.search on PQ cells goes through pq_probe_search and maps
    grouped and spill ids back to physical rows."""
    x, idx = _built(ref, rng, "spill")
    port = port_index(idx)
    q = x[:5].copy()
    dist, gid = _port_search(port, q, 20, 8)
    got_d, got_r = port.search(q, 20, nprobe=8)
    np.testing.assert_array_equal(got_d, dist)
    n_g = port.grouped.shape[0]
    want_r = np.where(gid >= n_g, port.spill_row_ids[np.maximum(gid - n_g, 0)],
                      port.row_ids[np.minimum(gid, n_g - 1)])
    np.testing.assert_array_equal(got_r, np.where(gid < 0, -1, want_r))
    assert (got_r[:, 0] == np.arange(5)).all()


def _synthetic(mb, n_codes, k, nq, device, gen, unaligned=False):
    """Seeded codes, codebooks, centroids and equal cells: the inputs of
    pq_candidates without a build."""
    nlist, cell_pad, dsub = 64, 256, 2
    m2 = mb if n_codes == 256 else 2 * mb
    d = m2 * dsub
    n_g = nlist * cell_pad + cell_pad
    flat = torch.randint(0, 256, (n_g * mb + 1,), generator=gen,
                         device=device, dtype=torch.uint8)
    codes = flat[1:] if unaligned else flat[:-1]
    codes = codes.view(n_g, mb)
    valid = torch.rand(n_g, generator=gen, device=device) >= 0.01
    valid[-cell_pad:] = False
    sq = torch.rand(n_g, generator=gen, device=device) * 50.0
    cb = torch.randn((m2, n_codes, dsub), generator=gen, device=device)
    cents = torch.randn((nlist, d), generator=gen, device=device) * 3
    offs = torch.arange(nlist, dtype=torch.int32, device=device) * cell_pad
    q = torch.randn((nq, d), generator=gen, device=device)
    plan, lut, cellof, bias = pq_probe.pq_probe_inputs(
        q, cents, cb, valid, sq, offs, cell_pad, k, 8, n_g)
    return plan, lut, cellof, bias, codes


def test_twin_is_the_direct_sum():
    """The twin's fold equals a direct max over the scored rows: per slot
    the best score, the lowest row on a tie, dead rows never."""
    gen = torch.Generator().manual_seed(0)
    plan, lut, cellof, bias, codes = _synthetic(4, 16, 10, 5, "cpu", gen)
    # chunk 9 copies chunk 1 (codes and bias): exact ties where both land
    codes[9 * 128:10 * 128] = codes[128:256]
    bias[9 * 128:10 * 128] = bias[128:256]
    val, idx = pq_probe.pq_candidates(lut, plan.qc2, plan.cells, plan.segs,
                                      cellof, codes, bias, plan.n_segments,
                                      plan.query_tile)
    m2 = 8
    lut3 = lut.float().reshape(-1, m2, 16)
    qt = plan.query_tile
    for t in range(plan.cells.shape[0]):
        chunks, first = np.unique(plan.cells[t].numpy(), return_index=True)
        for qi in range(t * qt, (t + 1) * qt):
            best = {}
            for c, f in zip(chunks, first):
                seg = int(plan.segs[t, f])
                cell = int(cellof[t, f])
                rows = torch.arange(c * 128, (c + 1) * 128)
                s = (tpq.adc_scores(lut3[qi:qi + 1], codes[rows])[0]
                     + plan.qc2[qi, cell] + bias[rows])
                for j in range(128):
                    if s[j] <= NEG_INF:
                        continue
                    slot = seg * 128 + j
                    cand = (float(s[j]), -int(rows[j]))
                    if slot not in best or cand > best[slot]:
                        best[slot] = cand
            for slot, (score, neg_row) in best.items():
                assert int(idx[qi, slot]) == -neg_row
                # adc_scores sums in another order than the twin's loop
                assert abs(float(val[qi, slot]) - score) < 1e-4
            empty = np.setdiff1d(np.arange(val.shape[1]), list(best))
            assert (idx[qi, empty] == -1).all()
            assert (val[qi, empty] == NEG_INF).all()


def _bf16_bits_to_f32(bits):
    """bf16 bits (uint16) widened as the kernel widens them: the high half
    of an f32."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _emulate_kernel(lut, qc2, cells, segs, cellof, codes, bias, n_seg, qt,
                    group):
    """numpy emulation of csrc/pq_probe.cu: per tile, blocks of `group`
    queries; each stages the interleaved table [m * J + code][group] from
    the LUT's bf16 bits, reads a code's `group` entries at once and adds
    each into its query's f32 sum, subspaces ascending from +0, then
    + qc2 of the entry's cell, then + bias; the fold keeps the best score
    of a slot and the lowest row on a tie. Entries the kernel skips
    (repeats, chunk, segment or cell out of range) score nothing."""
    bits = lut.view(torch.int16).numpy().view(np.uint16)
    qp, lut_w = bits.shape
    mb = codes.shape[1]
    n_codes = 256 if lut_w == mb * 256 else 16
    codes_np, bias_np, qc2_np = codes.numpy(), bias.numpy(), qc2.numpy()
    n_chunks = codes_np.shape[0] // 128
    nlist = qc2_np.shape[1]
    val = np.full((qp, 128 * n_seg), NEG_INF, np.float32)
    idx = np.full((qp, 128 * n_seg), -1, np.int64)
    for t in range(cells.shape[0]):
        c, sg, cl = (a[t].numpy() for a in (cells, segs, cellof))
        first = np.ones(len(c), bool)
        first[1:] = c[1:] != c[:-1]
        ok = (first & (c >= 0) & (c < n_chunks) & (sg >= 0) & (sg < n_seg)
              & (cl >= 0) & (cl < nlist))
        rows = (c[ok][:, None] * 128 + np.arange(128)).reshape(-1)
        slots = (sg[ok][:, None] * 128 + np.arange(128)).reshape(-1)
        cell = np.repeat(cl[ok], 128)
        code = codes_np[rows].astype(np.int64)            # (R, Mb)
        for j0 in range(0, qt, group):
            ng = min(group, qt - j0)
            q0 = t * qt + j0
            staged = np.zeros((lut_w, group), np.uint16)
            staged[:, :ng] = bits[q0:q0 + ng].T
            acc = np.zeros((len(rows), group), np.float32)
            for b in range(mb):
                if n_codes == 256:
                    picks = [b * 256 + code[:, b]]
                else:  # low nibble: subspace 2b, high: 2b + 1
                    picks = [2 * b * 16 + (code[:, b] & 15),
                             (2 * b + 1) * 16 + (code[:, b] >> 4)]
                for i in picks:    # one load: the group's entries of i
                    acc = acc + _bf16_bits_to_f32(staged[i])
            for j in range(ng):
                score = (acc[:, j] + qc2_np[q0 + j, cell]) + bias_np[rows]
                live = score > NEG_INF
                s, r, sl = score[live], rows[live], slots[live]
                order = np.lexsort((r, -s, sl))
                s, r, sl = s[order], r[order], sl[order]
                head = np.ones(len(sl), bool)
                head[1:] = sl[1:] != sl[:-1]
                val[q0 + j, sl[head]] = s[head]
                idx[q0 + j, sl[head]] = r[head]
    return torch.from_numpy(val), torch.from_numpy(idx.astype(np.int32))


@pytest.mark.parametrize("n_codes,mb", [(256, 8), (256, 5), (16, 4)])
@pytest.mark.parametrize("nq,group", [(37, 8), (37, 4), (20, 2), (3, 4),
                                      (3, 1)])
def test_interleaved_lut_emulation_equals_the_twin(n_codes, mb, nq, group):
    """The kernel's interleaved table, read `group` entries a load and
    summed in its order, gives the twin's candidates bit for bit (for 4-bit
    codes too, nibble order included), with exact ties (a chunk copying
    another), dead rows, an owning cell out of range and a last block of
    fewer queries than the group."""
    gen = torch.Generator().manual_seed(7)
    plan, lut, cellof, bias, codes = _synthetic(mb, n_codes, 640, nq, "cpu",
                                                gen)
    codes[9 * 128:10 * 128] = codes[128:256]
    bias[9 * 128:10 * 128] = bias[128:256]
    cellof = cellof.clone()
    cellof[0, 5] = 10 ** 6
    args = (lut, plan.qc2, plan.cells, plan.segs, cellof, codes, bias,
            plan.n_segments, plan.query_tile)
    want_v, want_i = pq_probe.pq_candidates_plain(*args)
    got_v, got_i = _emulate_kernel(*args, group)
    torch.testing.assert_close(got_i, want_i, rtol=0, atol=0)
    torch.testing.assert_close(got_v, want_v, rtol=0, atol=0)
    assert (want_i >= 0).float().mean() > 0.5


@pytest.mark.parametrize("case", ["8bit", "4bit"])
def test_interleaved_lut_emulation_matches_pallas_pq_search(rng, ref,
                                                            monkeypatch,
                                                            case):
    """The emulated kernel in place of the wrapper, through
    pq_probe_search, against pallas_pq_search(interpret=True) on the JAX
    package's index, at the module's tolerances (the reference contracts a
    one-hot in one dot, so the two agree within DIST_ATOL, not bit for
    bit)."""
    x, idx = _built(ref, rng, case)
    port = port_index(idx)
    q = x[rng.choice(len(x), 20, replace=False)].copy()

    def emulated(lut, qc2, cells, segs, cellof, codes, bias, n_seg, qt):
        m2, n_codes = pq_probe._geometry("emulated", lut, codes)
        return _emulate_kernel(lut, qc2, cells, segs, cellof, codes, bias,
                               n_seg, qt, pq_probe.lut_group(m2, n_codes, qt))

    monkeypatch.setattr(pq_probe, "pq_candidates", emulated)
    nprobe = CASES[case]["nprobe"]
    want_d, want_g = _ref_search(ref, idx, q, 640, nprobe)
    got_d, got_g = _port_search(port, q, 640, nprobe)
    _hold(want_d, want_g, got_d, got_g)


@pytest.mark.parametrize("m2,n_codes,qt,want", [
    (56, 256, 8, 8), (57, 256, 8, 4), (64, 256, 8, 4), (96, 256, 8, 4),
    (113, 256, 8, 4), (114, 256, 8, 2), (227, 256, 8, 2), (228, 256, 8, 1),
    (454, 256, 8, 1), (192, 16, 8, 8), (64, 256, 3, 4), (8, 256, 3, 4),
    (8, 256, 2, 2), (8, 256, 1, 1), (96, 256, 1, 1), (8, 256, 5, 8)])
def test_lut_group_fits_the_shared_memory(m2, n_codes, qt, want):
    """A block serves the widest group whose interleaved table (M2 x J x G
    bf16) fits in the 227 KB a block can have, and no wider than the
    smallest power of two that holds the tile."""
    g = pq_probe.lut_group(m2, n_codes, qt)
    assert g == want
    assert m2 * n_codes * g * 2 <= pq_probe.SMEM_MAX
    if g < min(8, 1 << (qt - 1).bit_length()):
        assert m2 * n_codes * 2 * g * 2 > pq_probe.SMEM_MAX


def test_a_table_that_fits_at_no_group_raises():
    """One query's table above 227 KB (455 x 256 bf16 entries) fits in no
    block; the wrapper says so before any launch."""
    with pytest.raises(ValueError, match="more than the 232448"):
        pq_probe.lut_group(455, 256, 8)
    with pytest.raises(ValueError, match="more than the 232448"):
        pq_probe.lut_group(455, 256, 1)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    gen = torch.Generator().manual_seed(1)
    plan, lut, cellof, bias, codes = _synthetic(4, 256, 10, 8, "cpu", gen)
    args = (plan.qc2, plan.cells, plan.segs, cellof, codes, bias,
            plan.n_segments, plan.query_tile)
    with pytest.raises(ValueError, match="bfloat16"):
        pq_probe.pq_candidates(lut.float(), *args)
    with pytest.raises(ValueError, match="fits neither"):
        pq_probe.pq_candidates(lut[:, :100], *args)
    with pytest.raises(ValueError, match="uint8"):
        pq_probe.pq_candidates(lut, plan.qc2, plan.cells, plan.segs, cellof,
                               codes.to(torch.int8), bias, plan.n_segments,
                               plan.query_tile)
    with pytest.raises(ValueError, match="cellof"):
        pq_probe.pq_candidates(lut, plan.qc2, plan.cells, plan.segs,
                               cellof[:, :-1], codes, bias, plan.n_segments,
                               plan.query_tile)
    with pytest.raises(ValueError, match="unsupported device"):
        pq_probe.pq_candidates(*(t.to("meta") if isinstance(t, torch.Tensor)
                                 else t for t in (lut,) + args))
    # an owning cell out of range scores nothing, it does not raise
    bad = torch.full_like(cellof, 10 ** 6)
    val, idx = pq_probe.pq_candidates(lut, plan.qc2, plan.cells, plan.segs,
                                      bad, codes, bias, plan.n_segments,
                                      plan.query_tile)
    assert (idx == -1).all() and (val == NEG_INF).all()


def test_the_pq_plan_is_expanded_at_every_size():
    """probe_plan switches to the compact form above 2**20 entries; asked
    for the PQ probe's form it stays expanded, and clamps the chunk ids."""
    nlist, cell_pad, nq = 64, 256, 8
    gen = torch.Generator().manual_seed(2)
    q = torch.randn((nq, 4), generator=gen)
    cents = torch.randn((nlist, 4), generator=gen)
    offs = torch.arange(nlist, dtype=torch.int32) * cell_pad
    old = ivf_probe.EXPANDED_MAX
    ivf_probe.EXPANDED_MAX = 16
    try:
        assert ivf_probe.probe_plan(q, cents, offs, cell_pad, 10, 8).compact
        n_chunks = nlist * cell_pad // 128 - 1   # one chunk short
        plan = ivf_probe.probe_plan(q, cents, offs, cell_pad, 10, 64,
                                    expanded_chunks=n_chunks)
    finally:
        ivf_probe.EXPANDED_MAX = old
    assert not plan.compact and plan.segs is not None
    assert int(plan.cells.max()) == n_chunks - 1
    assert plan.n_segments == 4
    assert ivf_probe.probe_plan(q, cents, offs, cell_pad, 640, 8,
                                expanded_chunks=n_chunks).n_segments == 10


def test_a_newer_header_rebuilds_the_library(tmp_path, monkeypatch):
    """Both probe sources include csrc/probe_common.cuh: a library older
    than the header is out of date even when its own source is older."""
    import os

    from tpuvdb_torch.kernels import cuda_build

    monkeypatch.setattr(cuda_build, "CSRC_DIR", str(tmp_path))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path))
    paths = {n: str(tmp_path / n) for n in ("k.cu", "h.cuh", "libk.so")}
    for p in paths.values():
        open(p, "w").close()
    lib = cuda_build.CudaLibrary("k.cu", "libk.so", lambda _: None,
                                 headers=("h.cuh",))
    os.utime(paths["k.cu"], (100, 100))
    os.utime(paths["h.cuh"], (100, 100))
    os.utime(paths["libk.so"], (200, 200))
    assert lib.up_to_date()
    os.utime(paths["h.cuh"], (300, 300))
    assert not lib.up_to_date()
    os.utime(paths["h.cuh"], (100, 100))
    os.utime(paths["k.cu"], (300, 300))
    assert not lib.up_to_date()
    os.unlink(paths["libk.so"])
    assert not lib.up_to_date()
    for mod, headers in ((ivf_probe, ["probe_common.cuh", "hopper_mma.cuh",
                                      "device_guard.cuh"]),
                         (pq_probe, ["probe_common.cuh", "device_guard.cuh"])):
        assert [os.path.basename(h) for h in mod.LIBRARY.headers] == headers
        assert all(os.path.exists(h) for h in mod.LIBRARY.headers)


@pytest.mark.cuda
@pytest.mark.parametrize("mb", [8, 50, 64, 96, 128])
@pytest.mark.parametrize("n_codes", [256, 16])
@pytest.mark.parametrize("k", [10, 640])
@pytest.mark.parametrize("nq", [3, 37])
def test_pq_kernel_matches_plain_on_card(mb, n_codes, k, nq):
    """Kernel and twin agree bit for bit: the same bf16 entries added in
    the same order, each f32 addition rounded once in both. Mb = 8 and 50
    take the kernel's byte loads (50 from a base off 16 bytes), 64, 96 and
    128 its 16-byte loads; k = 640 is the PQ rescore window (10 segments).
    A block serves G queries of a tile from its interleaved table: with
    256 codes G = 8 at Mb = 8 and 50, 4 at 64 and 96, 2 at 128; with 16
    codes 8; a tile of 3 queries (nq = 3) takes G = 4 at most, and its
    last block serves fewer queries than G."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the PQ probe kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(0)
    plan, lut, cellof, bias, codes = _synthetic(
        mb, n_codes, k, nq, "cuda", gen, unaligned=(mb == 50))
    assert plan.n_segments == (4 if k == 10 else 10)
    m2 = mb if n_codes == 256 else 2 * mb
    want_g = 8 if n_codes == 16 or mb <= 50 else 4 if mb <= 96 else 2
    assert pq_probe.lut_group(m2, n_codes, plan.query_tile) == min(
        want_g, 4 if nq == 3 else 8)
    assert (codes.data_ptr() % 16 != 0) == (mb == 50)
    args = (lut, plan.qc2, plan.cells, plan.segs, cellof, codes, bias,
            plan.n_segments, plan.query_tile)
    launches = pq_probe.LAUNCHES_PQ
    val, idx = pq_probe.pq_candidates(*args)
    assert pq_probe.LAUNCHES_PQ == launches + 1
    pval, pidx = pq_probe.pq_candidates_plain(*args)
    torch.cuda.synchronize()
    assert (idx >= 0).any() and not (idx >= codes.shape[0] - 256).any()
    torch.testing.assert_close(idx, pidx, rtol=0, atol=0)
    torch.testing.assert_close(val, pval, rtol=0, atol=0)
