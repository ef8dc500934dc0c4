"""tpuvdb_torch.kernels.pq vs tpuvdb.kernels.pq (on the CPU), and the PQ
branches of the port's IVFIndex vs the reference's.

Inputs come from a numpy seed and go through both packages. Tolerances:
* host helpers (nibble packing, `decode_pq`, `calibrate_pq_err`) are numpy
  copies: equal.
* `pq_lut`: within 1e-5 relative of the largest entry (f32 products summed
  in another order), with and without a rotation.
* encodes with the reference's codebooks: codes equal except at exact
  distance ties, which the test identifies by the two codewords' distances
  (gap within 1e-5 relative); stored norms within 1e-5 relative.
* `pq_topk` against `numpy_adc_oracle` (float64): distances within the
  rounding bound of the bf16 LUT, 2**-8 of each subspace's largest entry
  summed; ids equal except at gaps inside that bound.
* `train_pq`: with the shared numpy init, iteration 0 (no Lloyd step) is
  equal, and one step gives the same codewords (1e-4) for at least 90% of
  them, the rest being near-ties between jittered duplicates of the init;
  Lloyd in two frameworks drifts after a few iterations, so the final
  codebooks are held to quality, a reconstruction error within 5% of the
  reference's. `train_opq` returns an
  orthogonal rotation that does not lose to plain PQ on correlated data.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpuvdb.index.ivf import IVFIndex as JaxIVFIndex
from tpuvdb.kernels import pq as jpq
from tpuvdb_torch.index.ivf import IVFIndex
from tpuvdb_torch.kernels import pq as tpq

T = torch.from_numpy


def _clustered(rng, n, d, n_clusters=32, noise=0.3):
    cents = rng.standard_normal((n_clusters, d)).astype(np.float32) * 3.0
    return (cents[rng.integers(0, n_clusters, n)]
            + noise * rng.standard_normal((n, d))).astype(np.float32)


def _correlated(rng, n, d):
    """Anisotropic gaussian with a random (not axis-aligned) covariance."""
    a = rng.standard_normal((d, d)).astype(np.float32)
    scales = np.linspace(2.0, 0.1, d).astype(np.float32)
    return (rng.standard_normal((n, d)).astype(np.float32) * scales) @ a


def _recon_err(x, cb, rotation=None, encode=tpq.encode_pq, **kw):
    codes, _ = encode(x, cb, rotation=rotation, **kw)
    return float(np.mean((x - tpq.decode_pq(codes, cb, rotation)) ** 2))


def _assert_codes_equal_up_to_ties(x_sub, cb, got, want):
    """got / want: (n, M) per-subspace codes; where they differ the two
    codewords are equally near (an exact tie up to f32 rounding)."""
    diff = np.argwhere(got != want)
    for r, m in diff:
        dg = np.sum((x_sub[r, m] - cb[m, got[r, m]]) ** 2)
        dw = np.sum((x_sub[r, m] - cb[m, want[r, m]]) ** 2)
        assert abs(dg - dw) <= 1e-5 * max(dg, dw, 1.0), (r, m, dg, dw)
    assert len(diff) <= 0.001 * got.size


# ----------------------------------------------------------- host helpers


def test_nibble_packing_matches_the_reference(rng):
    codes = rng.integers(0, 16, (50, 12)).astype(np.uint8)
    packed = tpq.pack_nibbles_np(codes)
    np.testing.assert_array_equal(packed, jpq.pack_nibbles_np(codes))
    np.testing.assert_array_equal(tpq.unpack_nibbles_np(packed), codes)
    np.testing.assert_array_equal(jpq.unpack_nibbles_np(packed), codes)
    # even subspace = low nibble
    assert packed[0, 0] == codes[0, 0] | (codes[0, 1] << 4)
    # torch twins, with leading dimensions
    np.testing.assert_array_equal(tpq.pack_nibbles(T(codes)).numpy(), packed)
    un = tpq.unpack_nibbles(T(packed).reshape(5, 10, 6))
    assert un.dtype == torch.int64
    np.testing.assert_array_equal(un.numpy().reshape(50, 12), codes)
    np.testing.assert_array_equal(
        np.asarray(jpq._unpack_nibbles(jnp.asarray(packed))), codes)
    assert tpq.maybe_pack(T(codes), 16).shape == (50, 6)
    assert tpq.maybe_pack(T(codes), 256).dtype == torch.uint8
    # a code byte >= 128 stays unsigned on the way back
    big = np.full((2, 3), 200, np.uint8)
    assert (tpq.maybe_unpack(T(big), 256) == 200).all()


def test_code_geometry():
    cb8 = np.zeros((8, 256, 4), np.float32)
    cb4 = np.zeros((16, 16, 2), np.float32)
    assert tpq.pq_n_codes(cb8) == 256 and tpq.pq_code_bytes(cb8) == 8
    assert tpq.pq_n_codes(cb4) == 16 and tpq.pq_code_bytes(cb4) == 8
    assert tpq.pq_code_bytes(T(cb4)) == jpq.pq_code_bytes(cb4)
    with pytest.raises(ValueError, match="even"):
        tpq.pq_code_bytes(np.zeros((3, 16, 2), np.float32))
    with pytest.raises(ValueError, match="divide"):
        tpq.train_pq(np.zeros((4, 30), np.float32), 7, device="cpu")
    with pytest.raises(ValueError, match="empty"):
        tpq.train_pq(np.zeros((0, 32), np.float32), 8, device="cpu")


@pytest.mark.parametrize("n_codes", [256, 16])
@pytest.mark.parametrize("rotated", [False, True])
def test_decode_and_calibrate_equal_the_reference(rng, n_codes, rotated):
    d, m = 32, 8
    m2 = m if n_codes == 256 else 2 * m
    cb = rng.standard_normal((m2, n_codes, d // m2)).astype(np.float32)
    rot = (np.linalg.qr(rng.standard_normal((d, d)))[0].astype(np.float32)
           if rotated else None)
    codes = rng.integers(0, 256, (40, m)).astype(np.uint8)
    np.testing.assert_array_equal(tpq.decode_pq(codes, cb, rot),
                                  jpq.decode_pq(codes, cb, rot))
    res = rng.standard_normal((3000, d)).astype(np.float32)
    assert tpq.calibrate_pq_err(res, cb, rot, seed=3) == \
        jpq.calibrate_pq_err(res, cb, rot, seed=3)
    assert tpq.calibrate_pq_err(res[:0], cb) == 0.0


@pytest.mark.parametrize("rotated", [False, True])
def test_pq_lut_matches_the_reference(rng, rotated):
    d, m = 32, 8
    cb = rng.standard_normal((m, 256, d // m)).astype(np.float32)
    rot = (np.linalg.qr(rng.standard_normal((d, d)))[0].astype(np.float32)
           if rotated else None)
    q = rng.standard_normal((9, d)).astype(np.float32) * 3
    want = np.asarray(jpq._pq_lut(
        jnp.asarray(q), jnp.asarray(cb),
        jnp.asarray(rot) if rotated else None))
    got = tpq.pq_lut(T(q), T(cb), T(rot) if rotated else None).numpy()
    assert got.shape == (9, m, 256)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


# ---------------------------------------------------------------- encoding


@pytest.mark.parametrize("n_codes", [256, 16])
@pytest.mark.parametrize("rotated", [False, True])
def test_encode_pq_matches_the_reference(rng, n_codes, rotated):
    n, d, m = 1500, 32, 8
    m2 = m if n_codes == 256 else 2 * m
    x = _clustered(rng, n, d)
    rot = (np.linalg.qr(rng.standard_normal((d, d)))[0].astype(np.float32)
           if rotated else None)
    cb = jpq.train_pq(x if rot is None else x @ rot, m2, iters=4, seed=1,
                      n_codes=n_codes)
    want_c, want_sq = jpq.encode_pq(x, cb, rotation=rot)
    got_c, got_sq = tpq.encode_pq(x, cb, block=400, rotation=rot,
                                  device="cpu")   # ragged last block
    assert got_c.dtype == np.uint8 and got_c.shape == (n, m)
    y = (x if rot is None else x @ rot).reshape(n, m2, d // m2)
    if n_codes == 16:
        got_u, want_u = (tpq.unpack_nibbles_np(c) for c in (got_c, want_c))
    else:
        got_u, want_u = got_c, want_c
    _assert_codes_equal_up_to_ties(y, cb, got_u, want_u)
    same = (got_u == want_u).all(axis=1)
    np.testing.assert_allclose(got_sq[same], want_sq[same], rtol=1e-5)
    e_c, e_sq = tpq.encode_pq(x[:0], cb, device="cpu")
    assert e_c.shape == (0, m) and e_sq.shape == (0,)


@pytest.mark.parametrize("n_codes", [256, 16])
@pytest.mark.parametrize("rotated", [False, True])
def test_residual_encode_matches_the_reference(rng, n_codes, rotated):
    """The IVF-PQ encode: codes of x - c_assign (rotated under OPQ), norms
    of the full reconstruction c + r_hat."""
    n, d, m, nlist = 1200, 32, 8, 16
    m2 = m if n_codes == 256 else 2 * m
    x = _clustered(rng, n, d)
    cents = x[rng.choice(n, nlist, replace=False)]
    assign = np.argmin(((x[:, None] - cents[None]) ** 2).sum(-1), axis=1)
    res = x - cents[assign]
    rot = (np.linalg.qr(rng.standard_normal((d, d)))[0].astype(np.float32)
           if rotated else None)
    cb = jpq.train_pq(res if rot is None else res @ rot, m2, iters=4, seed=1,
                      n_codes=n_codes)
    want_c, want_sq = jpq.encode_pq_residual_chunked(
        x, assign, cents, cb, chunk=512, rotation=rot)
    got_c, got_sq = tpq.encode_pq_residual_chunked(
        x, assign, cents, cb, chunk=500, rotation=rot, device="cpu")
    y = (res if rot is None else res @ rot).reshape(n, m2, d // m2)
    if n_codes == 16:
        got_u, want_u = (tpq.unpack_nibbles_np(c) for c in (got_c, want_c))
    else:
        got_u, want_u = got_c, want_c
    _assert_codes_equal_up_to_ties(y, cb, got_u, want_u)
    same = (got_u == want_u).all(axis=1)
    np.testing.assert_allclose(got_sq[same], want_sq[same], rtol=1e-5)
    # the norm is the full reconstruction's
    recon = cents[assign] + tpq.decode_pq(got_c, cb, rot)
    np.testing.assert_allclose(got_sq, (recon ** 2).sum(1), rtol=1e-4)
    # tensors given as tensors stay where they are
    c2, _ = tpq.encode_pq_residual_chunked(x, assign, T(cents), T(cb),
                                           rotation=None if rot is None
                                           else T(rot))
    np.testing.assert_array_equal(c2, got_c)


@pytest.mark.parametrize("rotated", [False, True])
def test_per_row_centroid_encode_waits_for_the_mesh(rng, rotated):
    """The per-row centroid form (assign=None), which the mesh's PQ build
    and append use: row i coded against centroids[i]. It equals the
    assignment form on the same rows bit for bit, and the reference's own
    per-row form up to exact ties."""
    n, d, m, nlist = 1200, 32, 8, 16
    x = _clustered(rng, n, d)
    cents = x[rng.choice(n, nlist, replace=False)]
    assign = rng.integers(0, nlist, n)
    res = x - cents[assign]
    rot = (np.linalg.qr(rng.standard_normal((d, d)))[0].astype(np.float32)
           if rotated else None)
    cb = jpq.train_pq(res if rot is None else res @ rot, m, iters=3, seed=2)
    per_row = tpq.encode_pq_residual_chunked(
        x, None, cents[assign], cb, chunk=300, rotation=rot, device="cpu")
    by_cell = tpq.encode_pq_residual_chunked(
        x, assign, cents, cb, chunk=300, rotation=rot, device="cpu")
    np.testing.assert_array_equal(per_row[0], by_cell[0])
    np.testing.assert_array_equal(per_row[1], by_cell[1])
    want_c, want_sq = jpq.encode_pq_residual_chunked(
        x, None, cents[assign], cb, chunk=256, rotation=rot)
    y = (res if rot is None else res @ rot).reshape(n, m, d // m)
    _assert_codes_equal_up_to_ties(y, cb, per_row[0], want_c)
    same = (per_row[0] == want_c).all(axis=1)
    np.testing.assert_allclose(per_row[1][same], want_sq[same], rtol=1e-5)


# --------------------------------------------------------------------- ADC


def test_adc_scores_is_the_table_sum(rng):
    q_n, m2, r_n = 5, 6, 300
    lut = rng.standard_normal((q_n, m2, 16)).astype(np.float32)
    codes = rng.integers(0, 256, (r_n, 3)).astype(np.uint8)  # packed
    un = tpq.unpack_nibbles_np(codes)
    want = np.zeros((q_n, r_n), np.float32)
    for m in range(m2):
        want += lut[:, m, :][:, un[:, m]]
    got = tpq.adc_scores(T(lut), T(codes)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # in row blocks
    old = tpq.ADC_GATHER_ELEMS
    tpq.ADC_GATHER_ELEMS = 7 * q_n * m2   # blocks of 7 rows
    try:
        got_b = tpq.adc_scores(T(lut), T(codes)).numpy()
    finally:
        tpq.ADC_GATHER_ELEMS = old
    # torch sums a block's subspaces in an order that follows its shape
    np.testing.assert_allclose(got_b, got, rtol=1e-5, atol=1e-5)
    # the reference's formulations compute this function, on per-query
    # copies of the candidates
    per_q = np.stack([codes] * q_n)
    for fn in (jpq.adc_scores_gathered, jpq.adc_scores_grouped,
               jpq.adc_scores_gathered_onehot):
        ref = np.asarray(fn(jnp.asarray(lut), jnp.asarray(per_q)))
        np.testing.assert_allclose(ref, want, rtol=2e-2, atol=0.1)  # bf16


@pytest.mark.parametrize("n_codes", [256, 16])
@pytest.mark.parametrize("rotated", [False, True])
def test_pq_topk_matches_the_oracle(rng, n_codes, rotated):
    n, d, m, k = 3001, 32, 8, 10     # n is no multiple of the block
    m2 = m if n_codes == 256 else 2 * m
    x = _clustered(rng, n, d)
    rot = (np.linalg.qr(rng.standard_normal((d, d)))[0].astype(np.float32)
           if rotated else None)
    cb = tpq.train_pq(x if rot is None else x @ rot, m2, iters=4, seed=1,
                      n_codes=n_codes, device="cpu")
    codes, rsq = tpq.encode_pq(x, cb, rotation=rot, device="cpu")
    valid = rng.random(n) >= 0.05
    q = x[rng.choice(n, 6, replace=False)] + 0.01
    want_d, want_i = tpq.numpy_adc_oracle(q, codes, cb, rsq, valid, k, rot)
    ref_d, ref_i = jpq.numpy_adc_oracle(q, codes, cb, rsq, valid, k, rot)
    np.testing.assert_array_equal(want_i, ref_i)
    np.testing.assert_array_equal(want_d, ref_d)
    got_d, got_i = tpq.pq_topk(T(q), T(codes), T(cb), T(rsq), T(valid), k,
                               block=512,
                               rotation=None if rot is None else T(rot))
    got_d, got_i = got_d.numpy(), got_i.numpy()
    lut = tpq.pq_lut(T(q), T(cb), None if rot is None else T(rot)).numpy()
    bound = np.abs(lut).max(axis=2).sum(axis=1) * 2.0 ** -8 + 1e-3
    assert not np.isin(got_i, np.flatnonzero(~valid)).any()
    for i in range(len(q)):
        np.testing.assert_allclose(got_d[i], want_d[i], rtol=0,
                                   atol=bound[i])
        for pos in np.flatnonzero(got_i[i] != want_i[i]):
            # the oracle's distance of the row the port put here
            recon = tpq.decode_pq(codes[got_i[i, pos]][None], cb, rot)[0]
            d_port = float(np.sum((q[i] - recon) ** 2))
            assert abs(d_port - want_d[i, pos]) <= 2 * bound[i]
    # fewer live rows than k: +inf / -1 fill the tail
    few = np.zeros(n, bool)
    few[:3] = True
    d_f, i_f = tpq.pq_topk(T(q), T(codes), T(cb), T(rsq), T(few), k)
    assert (i_f[:, 3:] == -1).all() and torch.isinf(d_f[:, 3:]).all()
    assert set(i_f[0, :3].tolist()) == {0, 1, 2}


# ---------------------------------------------------------------- training


@pytest.mark.parametrize("n_codes", [256, 16])
def test_train_pq_starts_where_the_reference_starts(rng, n_codes):
    x = _clustered(rng, 2000, 32)
    m2 = 8 if n_codes == 256 else 16
    want0 = jpq.train_pq(x, m2, iters=0, seed=5, n_codes=n_codes)
    got0 = tpq.train_pq(x, m2, iters=0, seed=5, n_codes=n_codes,
                        device="cpu")
    np.testing.assert_array_equal(got0, want0)      # the shared init
    # one Lloyd step: the same means, except where a row sits between two
    # draws of the same sample row (they differ by the 1e-5 jitter, and the
    # near-tie goes either way)
    want1 = jpq.train_pq(x, m2, iters=1, seed=5, n_codes=n_codes)
    got1 = tpq.train_pq(x, m2, iters=1, seed=5, n_codes=n_codes,
                        device="cpu", block=700)
    close = np.isclose(got1, want1, rtol=1e-4, atol=1e-4).all(axis=-1)
    assert close.mean() >= 0.9, close.mean()
    # a warm start of the right shape is taken, another shape is not
    warm = tpq.train_pq(x, m2, iters=0, init=want1, n_codes=n_codes,
                        device="cpu")
    np.testing.assert_array_equal(warm, want1)
    cold = tpq.train_pq(x, m2, iters=0, seed=5, init=want1[:, :, :1],
                        n_codes=n_codes, device="cpu")
    np.testing.assert_array_equal(cold, want0)


@pytest.mark.parametrize("n_codes", [256, 16])
def test_train_pq_quality_matches_the_reference(rng, n_codes):
    x = _clustered(rng, 4000, 32)
    m2 = 8 if n_codes == 256 else 16
    want = jpq.train_pq(x, m2, seed=2, n_codes=n_codes)
    got = tpq.train_pq(x, m2, seed=2, n_codes=n_codes, device="cpu")
    assert got.shape == want.shape and got.dtype == np.float32
    e_want = _recon_err(x, want, device="cpu")
    e_got = _recon_err(x, got, device="cpu")
    assert e_got <= 1.05 * e_want, (e_got, e_want)
    # an empty codeword keeps its value: more codes than distinct rows
    tiny = np.repeat(rng.standard_normal((3, 8)).astype(np.float32), 4, 0)
    cb = tpq.train_pq(tiny, 2, iters=3, seed=0, n_codes=16, device="cpu")
    assert np.isfinite(cb).all()


def test_train_opq_is_orthogonal_and_does_not_lose(rng):
    d, m = 32, 8
    x = _correlated(rng, 3000, d)
    cb, rot = tpq.train_opq(x, m, iters=6, opq_iters=4, seed=0, device="cpu")
    assert rot.shape == (d, d) and cb.shape == (m, 256, d // m)
    np.testing.assert_allclose(rot @ rot.T, np.eye(d), atol=1e-4)
    plain = tpq.train_pq(x, m, iters=6, seed=0, device="cpu")
    e_opq = _recon_err(x, cb, rotation=rot, device="cpu")
    e_pq = _recon_err(x, plain, device="cpu")
    assert e_opq <= 1.02 * e_pq, (e_opq, e_pq)
    jcb, jrot = jpq.train_opq(x, m, iters=6, opq_iters=4, seed=0)
    e_ref = _recon_err(x, jcb, rotation=jrot, device="cpu")
    assert e_opq <= 1.05 * e_ref, (e_opq, e_ref)
    # one round is plain PQ under the identity
    cb1, rot1 = tpq.train_opq(x, m, iters=2, opq_iters=1, seed=0,
                              device="cpu")
    np.testing.assert_array_equal(rot1, np.eye(d, dtype=np.float32))


# ------------------------------------------------- the index's PQ branches


def _jax_arrays(idx):
    rot = idx.pq_rotation
    return dict(centroids=np.asarray(idx.centroids),
                pq_codebooks=np.asarray(idx.pq_codebooks),
                pq_rotation=None if rot is None else np.asarray(rot))


@pytest.mark.parametrize("tier", [dict(pq_subq=8), dict(pq_subq=8, pq_bits=4),
                                  dict(pq_subq=8, opq=True)])
def test_build_packs_the_reference_codes(rng, tier):
    """Given the reference's centroids, codebooks and rotation, the port's
    build assigns, encodes and packs the same cells, spill rows included
    (the no-split layout, where the given centroids are the final ones)."""
    n, d = 3072, 32
    x = _clustered(rng, n, d, n_clusters=8)
    kw = dict(nprobe=8, seed=4, split_oversized=False, cell_cap_quantile=0.5,
              **tier)
    ref = JaxIVFIndex.build(x, np.ones(n, bool), nlist=8, kmeans_iters=6,
                            **kw)
    assert ref.stats().spill_rows > 0
    port = IVFIndex.build(x, np.ones(n, bool), device="cpu",
                          **_jax_arrays(ref), **kw)
    assert port.pq and port.cell_pad == ref.cell_pad
    np.testing.assert_array_equal(port.row_ids, ref.row_ids)
    np.testing.assert_array_equal(port.spill_row_ids, ref.spill_row_ids)
    np.testing.assert_array_equal(port.cell_offsets_np,
                                  np.asarray(ref.cell_offsets))
    np.testing.assert_array_equal(port.spill_cells.numpy(),
                                  np.asarray(ref.spill_cells))
    for name in ("grouped", "spill"):
        got = getattr(port, name).numpy()
        want = np.asarray(getattr(ref, name))
        assert got.dtype == np.uint8 and got.shape == want.shape
        assert (got != want).any(axis=1).mean() <= 0.001  # exact ties only
        np.testing.assert_allclose(
            getattr(port, name + "_sq").numpy(),
            np.asarray(getattr(ref, name + "_sq")), rtol=1e-4, atol=1e-4)
    # the warm calibration is kept, not measured again
    assert IVFIndex.build(x, np.ones(n, bool), device="cpu", pq_err=1.25,
                          **_jax_arrays(ref), **kw).pq_err == 1.25
    # appends code against the assigned cell, as the reference's
    extra = _clustered(rng, 200, d, n_clusters=8)
    assert ref.append_rows(np.arange(n, n + 200), extra)
    assert port.append_rows(np.arange(n, n + 200), extra)
    np.testing.assert_array_equal(port.row_ids, ref.row_ids)
    np.testing.assert_array_equal(port.spill_cells.numpy(),
                                  np.asarray(ref.spill_cells))
    assert (port.grouped.numpy() != np.asarray(ref.grouped)).any(
        axis=1).mean() <= 0.001
    assert (port.spill.numpy() != np.asarray(ref.spill)).any(
        axis=1).mean() <= 0.001


@pytest.mark.parametrize("tier", [dict(pq_subq=8), dict(pq_subq=8, pq_bits=4),
                                  dict(pq_subq=8, opq=True)])
def test_build_trains_what_the_reference_trains(rng, tier):
    """From scratch, with bisection: the same cell count and window, a
    calibration within 5% of the reference's, rows re-encoded after their
    cell was split, appended rows found, deleted rows gone."""
    n, d = 4096, 32
    x = _clustered(rng, n, d)
    kw = dict(nlist=32, nprobe=16, kmeans_iters=5, seed=4, **tier)
    ref = JaxIVFIndex.build(x, np.ones(n, bool), **kw)
    port = IVFIndex.build(x, np.ones(n, bool), device="cpu", **kw)
    assert port.nlist == ref.nlist > 32 and port.cell_pad == ref.cell_pad
    assert port.pq_err == pytest.approx(ref.pq_err, rel=0.05)
    assert (port.pq_rotation is not None) == ("opq" in tier)
    # every grouped row's stored norm is that of c_cell + r_hat with the
    # final centroids: rows of bisected cells were encoded again
    g = np.flatnonzero(port.grouped_valid.numpy())
    cell = np.searchsorted(port.cell_offsets_np, g, side="right") - 1
    recon = port.centroids_np()[cell] + tpq.decode_pq(
        port.grouped.numpy()[g], port.pq_codebooks_np(),
        port.pq_rotation_np())
    np.testing.assert_allclose(port.grouped_sq.numpy()[g],
                               (recon ** 2).sum(1), rtol=1e-4)
    err = np.mean((recon - x[port.row_ids[g]]) ** 2)
    rg = np.flatnonzero(np.asarray(ref.grouped_valid))
    rcell = np.searchsorted(np.asarray(ref.cell_offsets), rg,
                            side="right") - 1
    rrot = ref.pq_rotation
    ref_recon = np.asarray(ref.centroids)[rcell] + tpq.decode_pq(
        np.asarray(ref.grouped)[rg], np.asarray(ref.pq_codebooks),
        None if rrot is None else np.asarray(rrot))
    ref_err = np.mean((ref_recon - x[ref.row_ids[rg]]) ** 2)
    assert err <= 1.05 * ref_err, (err, ref_err)
    _, rows = port.search(x[:64], k=5)
    assert np.mean(rows[:, 0] == np.arange(64)) >= 0.9
    extra = _clustered(rng, 64, d)
    assert port.append_rows(np.arange(n, n + 64), extra)
    _, rows = port.search(extra[:16], k=5)
    assert np.mean([(n + i) in rows[i] for i in range(16)]) >= 0.9
    port.invalidate_rows(np.asarray([n + 3]))
    _, rows = port.search(extra[3:4], k=5)
    assert (n + 3) not in rows[0]
    with pytest.raises(ValueError, match="one form"):
        port.search(extra[:1], k=5, force_compact=True)


def test_pq_window_is_clamped(rng):
    """pq_max_cell clamps the scan window: a modest nlist over many rows
    bisects into more cells instead of widening every probe."""
    n, d = 4096, 16
    x = rng.standard_normal((n, d)).astype(np.float32)
    kw = dict(nlist=4, nprobe=4, kmeans_iters=3, seed=0, pq_subq=4,
              device="cpu")
    wide = IVFIndex.build(x, np.ones(n, bool), **kw)
    tight = IVFIndex.build(x, np.ones(n, bool), pq_max_cell=256, **kw)
    assert wide.cell_pad > 256 and tight.cell_pad == 256
    assert tight.nlist > wide.nlist
    ref = JaxIVFIndex.build_streaming(
        __import__("tpuvdb.index.ivf", fromlist=["x"]).ArrayRowSource(x),
        np.ones(n, bool), nlist=4, nprobe=4, kmeans_iters=3, seed=0,
        pq_subq=4, pq_max_cell=256)
    assert ref.cell_pad == tight.cell_pad


def test_stale_warm_state_retrains(rng):
    """Warm codebooks of the other bit tier, codebooks without their
    rotation under OPQ, and a rotation of the wrong shape retrain; a
    rotation without OPQ is dropped."""
    n, d = 2048, 32
    x = _clustered(rng, n, d)
    cb8 = tpq.train_pq(x, m_subq=8, iters=2, seed=0, device="cpu")
    kw = dict(nlist=16, nprobe=8, kmeans_iters=4, seed=1, device="cpu")
    idx = IVFIndex.build(x, np.ones(n, bool), pq_subq=8, pq_bits=4,
                         pq_codebooks=cb8, **kw)
    assert tuple(idx.pq_codebooks.shape) == (16, 16, 2)
    idx = IVFIndex.build(x, np.ones(n, bool), pq_subq=8, opq=True,
                         pq_codebooks=cb8, **kw)
    assert idx.pq_rotation is not None
    assert not np.array_equal(idx.pq_codebooks_np(), cb8)
    idx = IVFIndex.build(x, np.ones(n, bool), pq_subq=8, opq=True,
                         pq_codebooks=cb8,
                         pq_rotation=np.eye(16, dtype=np.float32), **kw)
    assert tuple(idx.pq_rotation.shape) == (d, d)
    idx = IVFIndex.build(x, np.ones(n, bool), pq_subq=8,
                         pq_rotation=np.eye(d, dtype=np.float32), **kw)
    assert idx.pq_rotation is None
    # codebooks alone give the byte width
    idx = IVFIndex.build(x, np.ones(n, bool), pq_codebooks=cb8, **kw)
    assert idx.pq and idx.grouped.shape[1] == 8
    np.testing.assert_array_equal(idx.pq_codebooks_np(), cb8)
    with pytest.raises(ValueError, match="exclusive"):
        IVFIndex.build(x, np.ones(n, bool), pq_subq=8, dtype=torch.int8,
                       **kw)
    with pytest.raises(ValueError, match="must be 8 or 4"):
        IVFIndex.build(x, np.ones(n, bool), pq_subq=8, pq_bits=2, **kw)
    with pytest.raises(ValueError, match="subspaces"):
        IVFIndex.build(x, np.ones(n, bool), pq_subq=5, **kw)


def test_packed_state_round_trips_both_ways(rng):
    """packed_capture / packed_fetch / from_packed: the port's packed state
    rebuilds the reference's index and the reference's the port's, with the
    same search results; a write between capture and fetch raises."""
    n, d = 2048, 32
    x = _clustered(rng, n, d)
    port = IVFIndex.build(x, np.ones(n, bool), nlist=16, nprobe=8,
                          kmeans_iters=4, seed=1, pq_subq=8, opq=True,
                          device="cpu")
    st = IVFIndex.packed_fetch(port.packed_capture())
    assert st["grouped"].dtype == np.uint8 and "_dev" not in st
    again = IVFIndex.from_packed(st, device="cpu")
    q = x[:9]
    want = port.search(q, 10)
    got = again.search(q, 10)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert again.pq_err == port.pq_err and again.nprobe == port.nprobe
    # the engine adds this key when it writes the file, beside phys_cap and
    # dim: the reference requires it, the port's index does not hold it
    st["recall_target"] = np.float64(0.95)
    jidx = JaxIVFIndex.from_packed(st)     # the reference takes the file
    assert jidx.pq and jidx.pq_rotation is not None
    jst = JaxIVFIndex.packed_fetch(jidx.packed_capture())
    assert set(jst) == set(st)
    for key in st:
        assert np.asarray(jst[key]).dtype == np.asarray(st[key]).dtype, key
    back = IVFIndex.from_packed(jst, device="cpu")
    np.testing.assert_array_equal(back.search(q, 10)[1], want[1])
    cap = port.packed_capture()
    port.invalidate_rows(np.asarray([3]))
    with pytest.raises(RuntimeError, match="written in place"):
        IVFIndex.packed_fetch(cap)


def test_pq_cells_reject_what_they_do_not_take(rng):
    z8 = torch.zeros((128, 4), dtype=torch.uint8)
    zf = torch.zeros(128)
    zb = torch.zeros(128, dtype=torch.bool)
    base = dict(centroids=np.zeros((1, 16), np.float32), grouped_sq=zf,
                grouped_valid=zb, row_ids=np.full(128, -1), spill_sq=zf,
                spill_valid=zb, spill_row_ids=np.full(128, -1), cell_pad=128,
                cell_offsets=np.zeros(1, np.int32),
                cell_lens=np.zeros(1, np.int32))
    cb = np.zeros((4, 256, 4), np.float32)
    idx = IVFIndex(grouped=z8, spill=z8, pq_codebooks=cb, **base)
    assert idx.pq and idx.spill_cells.shape == (128,)
    with pytest.raises(ValueError, match="uint8"):
        IVFIndex(grouped=z8.float(), spill=z8.float(), pq_codebooks=cb,
                 **base)
    with pytest.raises(ValueError, match="do not code"):
        IVFIndex(grouped=z8, spill=z8,
                 pq_codebooks=np.zeros((8, 256, 2), np.float32), **base)
    with pytest.raises(ValueError, match="no int8 scales"):
        IVFIndex(grouped=z8, spill=z8, pq_codebooks=cb, cell_scales=zf,
                 spill_scales=zf, **base)
