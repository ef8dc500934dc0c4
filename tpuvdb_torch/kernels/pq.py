"""Product quantization (PQ), the capacity tier below int8: the port of
tpuvdb/kernels/pq.py in torch ops on an explicit device.

A d-dim row becomes Mb bytes: one code per subspace against a
(M2, J, d / M2) codebook. J = 256 is the 8-bit tier (M2 = Mb); J = 16 the
4-bit tier, two half-width subspaces per byte (M2 = 2 Mb, even subspace =
low nibble). The codebook shape tells the tiers apart everywhere.

  * Training is batched Lloyd over all subspaces at once: the assignment is
    one einsum, the update a segment sum (`kmeans.segment_add_`,
    deterministic on the card) over combined (subspace, code) ids (the
    reference's `segment_sum`); an empty codeword keeps its value.
    The initial codewords are drawn with `np.random.default_rng(seed)`
    exactly as the reference draws them, so both packages start Lloyd from
    the same codebooks. `train_opq` alternates it with an orthogonal
    Procrustes step whose (d, d) SVD runs on the host, as in the reference.
  * Encoding is the same assignment, blockwise. The plain encode stores
    ||x_hat||^2; the residual encode of IVF-PQ codes x - c_cell (rotated
    under OPQ) and stores ||c + r_hat||^2 of the full reconstruction.
  * Asymmetric distance: 2 q . x_hat = sum_m LUT[q, m, code[r, m]] with
    LUT[q, m, j] = 2 q_m . codebook[m, j] (`pq_lut`; under OPQ the query is
    rotated first).

One ADC function, not three. The reference carries three formulations of
that sum (`adc_scores_gathered`, `adc_scores_grouped`,
`adc_scores_gathered_onehot`) because a TPU cannot gather: two of them
expand the codes to one-hot operands of a matrix product. A GPU gathers, so
the port has the function once, `adc_scores`, a `torch.gather` over the
table; the caller rounds the LUT to bf16 first where the reference does.
The IVF probe's hot path is the hand-written kernel of
kernels/pq_probe.py, not this function.

The reference pads rows to fixed block shapes so that one compiled XLA
program serves every size; the port runs eagerly and takes the ragged tail
as it is. The per-row centroid form of the residual encode (a mesh append,
`assign=None`) comes with the mesh.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from tpuvdb_torch import device as _device  # noqa: F401  (TF32 off)
from tpuvdb_torch.device import resolve_device
from tpuvdb_torch.kernels import topk as tk
from tpuvdb_torch.kernels.kmeans import segment_add_

ADC_GATHER_ELEMS = 1 << 24  # looked-up entries per adc_scores block


def _check_dims(d: int, m_subq: int) -> int:
    if m_subq <= 0 or d % m_subq != 0:
        raise ValueError(f"m_subq={m_subq} must divide dim={d}")
    return d // m_subq


# --------------------------------------------------------- nibble packing


def pq_n_codes(codebooks) -> int:
    return int(codebooks.shape[1])


def pq_code_bytes(codebooks) -> int:
    """Stored bytes per row for this codebook shape."""
    m2, j = int(codebooks.shape[0]), int(codebooks.shape[1])
    if j == 16:
        if m2 % 2:
            raise ValueError("4-bit codebooks need an even subspace count")
        return m2 // 2
    return m2


def pack_nibbles_np(codes: np.ndarray) -> np.ndarray:
    """(n, 2M) per-subspace 4-bit codes -> (n, M) packed bytes."""
    lo = codes[:, 0::2].astype(np.uint8)
    hi = codes[:, 1::2].astype(np.uint8)
    return (lo | (hi << 4)).astype(np.uint8)


def unpack_nibbles_np(packed: np.ndarray) -> np.ndarray:
    """(n, M) packed bytes -> (n, 2M) per-subspace codes."""
    p = np.asarray(packed, np.uint8)
    out = np.empty(p.shape[:-1] + (2 * p.shape[-1],), np.uint8)
    out[..., 0::2] = p & 15
    out[..., 1::2] = p >> 4
    return out


def pack_nibbles(codes: torch.Tensor) -> torch.Tensor:
    """torch twin of pack_nibbles_np; codes (..., 2M) int -> (..., M) u8."""
    c = codes.to(torch.int32)
    return (c[..., 0::2] | (c[..., 1::2] << 4)).to(torch.uint8)


def unpack_nibbles(packed: torch.Tensor) -> torch.Tensor:
    """(..., M) u8 -> (..., 2M) int64 in subspace order."""
    p = packed.to(torch.int64)
    return torch.stack([p & 15, p >> 4], dim=-1).reshape(
        p.shape[:-1] + (2 * p.shape[-1],))


def maybe_pack(codes: torch.Tensor, n_codes: int) -> torch.Tensor:
    return pack_nibbles(codes) if n_codes == 16 else codes.to(torch.uint8)


def maybe_unpack(codes: torch.Tensor, n_codes: int) -> torch.Tensor:
    return unpack_nibbles(codes) if n_codes == 16 else codes.to(torch.int64)


# ---------------------------------------------------------------- training


def pq_assign(chunk_sub: torch.Tensor, codebooks: torch.Tensor,
              c_sq: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, M) nearest-codeword ids (int64) of chunk_sub (B, M, dsub): the
    argmax of 2 x.c - ||c||^2, the first (lowest) code on a tie."""
    if c_sq is None:
        c_sq = (codebooks * codebooks).sum(dim=-1)  # (M, J)
    scores = 2.0 * torch.einsum("bms,mjs->bmj", chunk_sub, codebooks) - c_sq
    return scores.argmax(dim=-1)


def _lloyd_step(data_sub: torch.Tensor, codebooks: torch.Tensor,
                block: int) -> Tuple[torch.Tensor, float]:
    """One Lloyd iteration over all subspaces. data_sub: (n, M, dsub).
    Returns (new_codebooks, mean_shift)."""
    n, m_subq, dsub = data_sub.shape
    n_codes = codebooks.shape[1]
    nseg = m_subq * n_codes
    seg_base = torch.arange(m_subq, device=data_sub.device) * n_codes
    sums = torch.zeros((nseg, dsub), dtype=torch.float32,
                       device=data_sub.device)
    counts = torch.zeros(nseg, dtype=torch.float32, device=data_sub.device)
    c_sq = (codebooks * codebooks).sum(dim=-1)
    for lo in range(0, n, block):
        chunk = data_sub[lo:lo + block]
        seg = (pq_assign(chunk, codebooks, c_sq) + seg_base).reshape(-1)
        segment_add_(sums, seg, chunk.reshape(-1, dsub))
        segment_add_(counts, seg, torch.ones_like(seg, dtype=torch.float32))
    sums = sums.reshape(m_subq, n_codes, dsub)
    counts = counts.reshape(m_subq, n_codes)
    new = torch.where(counts[:, :, None] > 0,
                      sums / counts.clamp(min=1.0)[:, :, None], codebooks)
    shift = float(torch.linalg.norm(new - codebooks, dim=-1).mean())
    return new, shift


def init_codebooks(sample: np.ndarray, m_subq: int, n_codes: int,
                   rng: np.random.Generator) -> np.ndarray:
    """The reference's Lloyd start: random sample rows per subspace
    (independent draws), jittered so duplicates can separate."""
    n, d = sample.shape
    dsub = d // m_subq
    take = rng.integers(0, n, size=(m_subq, n_codes))
    cents = sample.reshape(n, m_subq, dsub)[take,
                                            np.arange(m_subq)[:, None], :]
    return cents + rng.standard_normal(cents.shape).astype(np.float32) * 1e-5


def train_pq(
    sample: np.ndarray,
    m_subq: int,
    iters: int = 15,
    block: int = 4096,
    seed: int = 0,
    init: Optional[np.ndarray] = None,
    n_codes: int = 256,
    device=None,
) -> np.ndarray:
    """Train per-subspace codebooks on a sample, on `device` (None = cuda).
    Returns (M, n_codes, dsub) f32: n_codes 256 for the 8-bit tier, 16 for
    the 4-bit tier (where m_subq = 2 * bytes/row). `init` warm-starts Lloyd
    from existing codebooks (the OPQ alternation refines, not retrains)."""
    dev = resolve_device(device)
    sample = np.asarray(sample, np.float32)
    n, d = sample.shape
    dsub = _check_dims(d, m_subq)
    if n == 0:
        raise ValueError("train_pq on empty sample")
    rng = np.random.default_rng(seed)
    if init is not None and init.shape == (m_subq, n_codes, dsub):
        cents = np.asarray(init, np.float32)
    else:
        cents = init_codebooks(sample, m_subq, n_codes, rng)
    data_sub = torch.from_numpy(
        np.ascontiguousarray(sample).reshape(n, m_subq, dsub)).to(dev)
    codebooks = torch.from_numpy(
        np.ascontiguousarray(cents, np.float32)).to(dev)
    for _ in range(iters):
        codebooks, shift = _lloyd_step(data_sub, codebooks, block)
        if shift < 1e-7:
            break
    return codebooks.cpu().numpy()


def train_opq(
    sample: np.ndarray,
    m_subq: int,
    iters: int = 15,
    opq_iters: int = 8,
    block: int = 4096,
    seed: int = 0,
    n_codes: int = 256,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """OPQ: learn an orthogonal rotation R that aligns the data with the PQ
    subspace grid before coding. Returns (codebooks (M, n_codes, dsub),
    rotation (d, d)); the codebooks live in the rotated space: encode rows
    as x @ R, build query LUTs from q @ R.

    Non-parametric alternation (Ge et al., CVPR'13), as the reference:
      1. fix R: refine the codebooks on Y = X @ R (warm-started Lloyd);
      2. fix the codebooks: encode Y -> Y_hat and solve the orthogonal
         Procrustes problem min_R ||X R - Y_hat||_F by the SVD of
         X^T Y_hat = U S V^T, R = U V^T.
    The products run on `device`; the (d, d) SVD runs on the host."""
    dev = resolve_device(device)
    x = np.asarray(sample, np.float32)
    n, d = x.shape
    _check_dims(d, m_subq)
    if n == 0:
        raise ValueError("train_opq on empty sample")
    x_t = torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    rot = np.eye(d, dtype=np.float32)
    codebooks = None
    rounds = max(1, opq_iters)
    for it in range(rounds):
        y = (x_t @ torch.from_numpy(rot).to(dev)).cpu().numpy()
        # the first round trains from scratch; later rounds take a few
        # steps from the previous codebooks
        codebooks = train_pq(y, m_subq, iters=(iters if it == 0 else 4),
                             block=block, seed=seed, init=codebooks,
                             n_codes=n_codes, device=dev)
        if it == rounds - 1:
            break
        codes, _ = encode_pq(y, codebooks, device=dev)
        y_hat = decode_pq(codes, codebooks)
        cov = (x_t.T @ torch.from_numpy(y_hat).to(dev)).cpu().numpy()
        u, _, vt = np.linalg.svd(cov)
        rot = (u @ vt).astype(np.float32)
    return np.asarray(codebooks), rot


# ---------------------------------------------------------------- encoding


def _f32(a, dev) -> Optional[torch.Tensor]:
    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        return a.to(device=dev, dtype=torch.float32)
    return torch.from_numpy(np.array(a, np.float32)).to(dev)  # own copy


def encode_pq(
    data: np.ndarray,
    codebooks: np.ndarray,
    block: int = 16384,
    rotation: Optional[np.ndarray] = None,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Encode rows -> (codes (n, Mb) uint8, recon_sq (n,) f32), on `device`
    (None = cuda). recon_sq is ||x_hat||^2 of the reconstruction, the sum of
    the chosen codewords' norms (subspaces are orthogonal coordinate
    blocks), which the ADC scan ranks against. With an OPQ `rotation` the
    codes quantize x @ R; rotations preserve norms, so recon_sq needs no
    correction."""
    dev = resolve_device(device)
    data = np.asarray(data, np.float32)
    n, d = data.shape
    m_subq, n_codes = codebooks.shape[0], codebooks.shape[1]
    _check_dims(d, m_subq)
    width = pq_code_bytes(codebooks)
    codes = np.empty((n, width), np.uint8)
    rsq = np.empty(n, np.float32)
    cb = _f32(codebooks, dev)
    rot = _f32(rotation, dev)
    c_sq = (cb * cb).sum(dim=-1)  # (M, J)
    m_idx = torch.arange(m_subq, device=dev)[None, :]
    for lo in range(0, n, block):
        chunk = torch.from_numpy(
            np.ascontiguousarray(data[lo:lo + block])).to(dev)
        if rot is not None:
            chunk = chunk @ rot
        assign = pq_assign(chunk.reshape(chunk.shape[0], m_subq, -1), cb,
                           c_sq)
        codes[lo:lo + block] = maybe_pack(assign, n_codes).cpu().numpy()
        rsq[lo:lo + block] = c_sq[m_idx, assign].sum(dim=-1).cpu().numpy()
    return codes, rsq


def encode_residual(
    data: torch.Tensor,       # (n, d) f32
    assign: torch.Tensor,     # (n,) integer cell of each row
    centroids: torch.Tensor,  # (nlist, d) f32
    codebooks: torch.Tensor,  # (M2, J, dsub) f32
    rotation: Optional[torch.Tensor] = None,  # (d, d)
    block: int = 16384,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Residual encode for IVF-PQ, tensors in and out on one device: the
    codes quantize x - c_assign, and the stored norm is the full
    reconstruction's ||c + r_hat||^2, so the probe's distance
    ||q||^2 - 2 q.c - 2 q.r_hat + norm is exact to the reconstruction. With
    an OPQ rotation the codes quantize (x - c) @ R and the norm unrotates
    the decoded residual first. Returns (codes (n, Mb) u8, recon_sq (n,))."""
    n, d = data.shape
    m_subq, n_codes, dsub = codebooks.shape
    codes = torch.empty((n, pq_code_bytes(codebooks)), dtype=torch.uint8,
                        device=data.device)
    rsq = torch.empty(n, dtype=torch.float32, device=data.device)
    c_sq = (codebooks * codebooks).sum(dim=-1)
    m_idx = torch.arange(m_subq, device=data.device)[None, :]
    for lo in range(0, n, block):
        cents = centroids[assign[lo:lo + block].long()]     # (B, d)
        res = data[lo:lo + block] - cents
        if rotation is not None:
            res = res @ rotation
        c = pq_assign(res.reshape(res.shape[0], m_subq, dsub), codebooks,
                      c_sq)                                 # (B, M2)
        r_flat = codebooks[m_idx, c].reshape(res.shape[0], d)
        if rotation is not None:  # back to the original space for the norm
            r_flat = r_flat @ rotation.T
        recon = cents + r_flat
        codes[lo:lo + block] = maybe_pack(c, n_codes)
        rsq[lo:lo + block] = (recon * recon).sum(dim=-1)
    return codes, rsq


def encode_pq_residual_chunked(
    vecs: np.ndarray,
    assign: Optional[np.ndarray],
    centroids,
    codebooks,
    chunk: int = 16384,
    rotation=None,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Residual encode of host rows in chunks (the append path): numpy in
    and out; `centroids`, `codebooks` and `rotation` may already be tensors
    (then the work runs on their device, else on `device`). assign=None means `centroids` is a per-row (m, d) array,
    row i coded against centroids[i] (a mesh build or append: each row's
    centroid comes from its own slot's table)."""
    on = [a.device for a in (centroids, codebooks)
          if isinstance(a, torch.Tensor)]
    dev = on[0] if on else resolve_device(device)
    vecs = np.asarray(vecs, np.float32)
    m = vecs.shape[0]
    per_row = assign is None
    cb, rot = _f32(codebooks, dev), _f32(rotation, dev)
    cents = None if per_row else _f32(centroids, dev)
    codes = np.empty((m, pq_code_bytes(cb)), np.uint8)
    rsq = np.empty(m, np.float32)
    for lo in range(0, m, chunk):
        part = torch.from_numpy(
            np.ascontiguousarray(vecs[lo:lo + chunk])).to(dev)
        if per_row:  # the chunk's own centroid rows, in order
            table = _f32(centroids[lo:lo + chunk], dev)
            a = torch.arange(part.shape[0], device=dev)
        else:
            table = cents
            a = torch.from_numpy(
                np.asarray(assign[lo:lo + chunk], np.int64)).to(dev)
        c, r = encode_residual(part, a, table, cb, rot, block=chunk)
        codes[lo:lo + chunk] = c.cpu().numpy()
        rsq[lo:lo + chunk] = r.cpu().numpy()
    return codes, rsq


def calibrate_pq_err(residuals: np.ndarray, codebooks: np.ndarray,
                     rotation: Optional[np.ndarray] = None,
                     quantile: float = 0.999, max_sample: int = 2048,
                     seed: int = 0) -> float:
    """Quantile of the per-row reconstruction error norm ||r - r_hat|| over
    sample residuals: the calibration constant behind the adaptive exact
    rescore window (engine._rescore_adaptive).

    The ADC probe scores a candidate by d_adc = ||q - x_hat||^2, so the true
    distance obeys d_exact >= (sqrt(d_adc) - ||e||)^2 with e = x - x_hat. A
    candidate whose bound sits above the running kth exact distance cannot
    enter the top-k (up to the quantile's tail mass), and the host re-rank
    skips it. Pure numpy on a small subsample, as the reference. A rotation
    preserves norms, so the rotated-space error norm is the original's."""
    r = np.asarray(residuals, np.float32)
    if len(r) == 0:
        return 0.0
    if len(r) > max_sample:
        keep = np.random.default_rng(seed).choice(
            len(r), size=max_sample, replace=False)
        r = r[keep]
    cb = np.asarray(codebooks, np.float32)
    if rotation is not None:
        r = r @ np.asarray(rotation, np.float32)
    m, _, dsub = cb.shape
    x = r.reshape(len(r), m, dsub)
    dots = np.einsum("smd,mjd->smj", x, cb)
    csq = np.einsum("mjd,mjd->mj", cb, cb)
    code = np.argmax(2.0 * dots - csq[None], axis=2)     # (S, m)
    r_hat = cb[np.arange(m)[None, :], code]              # (S, m, dsub)
    err = r - r_hat.reshape(len(r), -1)
    nrm = np.sqrt(np.einsum("sd,sd->s", err, err))
    return float(np.quantile(nrm, quantile))


def decode_pq(codes: np.ndarray, codebooks: np.ndarray,
              rotation: Optional[np.ndarray] = None) -> np.ndarray:
    """Reconstruct (n, d) f32 rows from codes: a host helper for tests and
    OPQ training (the hot path never decodes). With an OPQ rotation the
    decoded rotated-space row is unrotated. 4-bit codebooks take packed
    byte codes (pack_nibbles_np layout)."""
    codes = np.asarray(codes)
    if pq_n_codes(codebooks) == 16:
        codes = unpack_nibbles_np(codes)
    n, m_subq = codes.shape
    recon = codebooks[np.arange(m_subq)[None, :], codes.astype(np.int64), :]
    out = recon.reshape(n, -1).astype(np.float32)
    if rotation is not None:
        out = out @ np.asarray(rotation, np.float32).T
    return out


# --------------------------------------------------------------------- ADC


def pq_lut(queries: torch.Tensor, codebooks: torch.Tensor,
           rotation: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(Q, M, J) f32: LUT[q, m, j] = 2 q_m . codebook[m, j]. With an OPQ
    rotation the query rotates first (q @ R), so LUT sums recover
    2 q . x_hat in the original space."""
    q = queries.to(torch.float32)
    if rotation is not None:
        q = q @ rotation
    m_subq, _, dsub = codebooks.shape
    q_sub = q.reshape(q.shape[0], m_subq, dsub)
    return 2.0 * torch.einsum("qms,mjs->qmj", q_sub, codebooks)


def adc_scores(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """(Q, R) f32 scores sum_m LUT[q, m, code[r, m]] = 2 q . x_hat.

    lut: (Q, M2, J) f32 (round it to bf16 and back first where the scores
    must match the probe's). codes: (R, Mb) uint8, scored by every query;
    packed bytes when J = 16. The gather runs in row blocks of at most
    ADC_GATHER_ELEMS looked-up entries."""
    qn, m2, n_codes = lut.shape
    c = maybe_unpack(codes, n_codes)                 # (R, M2) int64
    r_n = c.shape[0]
    out = torch.empty((qn, r_n), dtype=torch.float32, device=lut.device)
    step = max(1, ADC_GATHER_ELEMS // max(qn * m2, 1))
    for lo in range(0, r_n, step):
        idx = c[lo:lo + step].T.unsqueeze(0).expand(qn, -1, -1)  # (Q,M2,R')
        out[:, lo:lo + step] = torch.gather(lut, 2, idx).sum(dim=1)
    return out


def pq_topk(
    queries: torch.Tensor,    # (Q, d) f32
    codes: torch.Tensor,      # (N, Mb) uint8
    codebooks: torch.Tensor,  # (M2, J, dsub) f32
    recon_sq: torch.Tensor,   # (N,) f32 reconstruction norms
    valid: torch.Tensor,      # (N,) bool
    k: int,
    block: int = 8192,
    rotation: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Streaming ADC top-k over the whole code array (the flat ADC scan):
    (dist, idx), dist the squared L2 to the reconstruction, ascending;
    empty slots +inf / -1. The LUT is rounded to bf16 as in the reference;
    `rotation` pairs with codes from encode_pq(..., rotation=R)."""
    n = codes.shape[0]
    q = queries.to(torch.float32)
    q_sq = (q * q).sum(dim=-1, keepdim=True)
    lut = pq_lut(q, codebooks, rotation).to(torch.bfloat16).to(torch.float32)
    neg, idx = tk.empty_topk(q.shape[0], k, device=q.device)
    for lo in range(0, n, block):
        hi = min(lo + block, n)
        scores = adc_scores(lut, codes[lo:hi]) - recon_sq[None, lo:hi]
        scores = tk.mask_scores(scores, valid[None, lo:hi])
        gidx = torch.arange(lo, hi, dtype=torch.int32, device=q.device)
        neg, idx = tk.merge_topk(neg, idx, scores,
                                 gidx.expand(q.shape[0], -1), k)
    idx = torch.where(neg == float("-inf"), torch.full_like(idx, -1), idx)
    dist = torch.where(idx >= 0, q_sq - neg,
                       torch.full_like(neg, float("inf")))
    return dist, idx


def numpy_adc_oracle(queries, codes, codebooks, recon_sq, valid, k,
                     rotation=None):
    """Exact ADC in float64 numpy: the correctness bar for pq_topk."""
    queries = np.asarray(queries, np.float64)
    recon = decode_pq(codes, np.asarray(codebooks),
                      rotation=rotation).astype(np.float64)
    d2 = (np.sum(queries ** 2, axis=1)[:, None]
          - 2.0 * queries @ recon.T
          + np.asarray(recon_sq, np.float64)[None, :])
    d2 = np.where(np.asarray(valid, bool)[None, :], d2, np.inf)
    idx = np.argsort(d2, axis=1, kind="stable")[:, :k]
    dist = np.take_along_axis(d2, idx, axis=1)
    idx = np.where(np.isinf(dist), -1, idx)
    return dist, idx
