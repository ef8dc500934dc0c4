"""K-means, the IVF coarse quantizer trainer: the port of
tpuvdb/kernels/kmeans.py in torch ops on an explicit device.

The assignment step is the same GEMM shape as search (block x centroids),
streamed over the rows in blocks so memory stays O(block * nlist); centroid
updates are segment sums (`segment_add_`: deterministic on the card, so
two runs or two processes train the same table bit for bit). Empty clusters keep their previous centroid
(standard Lloyd fallback). The initial centroids are drawn with
`np.random.default_rng(seed)` exactly as the reference draws them, so both
packages start from the same centroids; the reference pads the rows to a
multiple of the block (a compile-shape rule) with rows that carry no
weight, which the port does not need.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from tpuvdb_torch import device as _device  # noqa: F401  (TF32 off)


def assign_blockwise(
    data: torch.Tensor,        # (n, d) f32
    centroids: torch.Tensor,   # (k, d) f32, same device
    block_size: int = 65536,
) -> torch.Tensor:
    """Nearest-centroid id per row (int32): argmax 2 x.c - ||c||^2, the
    first (lowest) centroid on a tie, as jnp.argmax."""
    c_sq = (centroids * centroids).sum(dim=-1)
    out = torch.empty(data.shape[0], dtype=torch.int32, device=data.device)
    for lo in range(0, data.shape[0], block_size):
        chunk = data[lo:lo + block_size]
        scores = 2.0 * (chunk @ centroids.T) - c_sq[None, :]
        out[lo:lo + block_size] = scores.argmax(dim=-1).to(torch.int32)
    return out


def segment_add_(out: torch.Tensor, index: torch.Tensor,
                 values: torch.Tensor) -> torch.Tensor:
    """out[index[i]] += values[i], in place. On the card a sorted
    accumulation (`index_put_` with accumulate), whose sums come out the
    same in every run: `index_add_` adds there with atomics, in an order
    that changes between runs and processes. On the host `index_add_`,
    whose sequential sums match the reference's bit for bit."""
    if out.is_cuda:
        return out.index_put_((index,), values, accumulate=True)
    return out.index_add_(0, index, values)


def _kmeans_step(data: torch.Tensor, weight: torch.Tensor,
                 centroids: torch.Tensor,
                 block_size: int) -> Tuple[torch.Tensor, float]:
    """One Lloyd iteration. Returns (new_centroids, shift), shift being
    the mean centroid movement (for convergence monitoring)."""
    nlist = centroids.shape[0]
    sums = torch.zeros_like(centroids)
    counts = torch.zeros(nlist, dtype=torch.float32, device=data.device)
    assign = assign_blockwise(data, centroids, block_size).long()
    for lo in range(0, data.shape[0], block_size):
        a = assign[lo:lo + block_size]
        w = weight[lo:lo + block_size]
        segment_add_(sums, a, data[lo:lo + block_size] * w[:, None])
        segment_add_(counts, a, w)
    new = torch.where(counts[:, None] > 0,
                      sums / counts.clamp(min=1)[:, None], centroids)
    shift = float(torch.linalg.norm(new - centroids, dim=-1).mean())
    return new, shift


def kmeans(
    data: np.ndarray,
    valid: np.ndarray,
    nlist: int,
    iters: int = 12,
    block_size: int = 65536,
    seed: int = 0,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Train nlist centroids on `device` (None = cuda); returns (centroids
    (nlist, d) f32, assignments (n,) i32) as numpy. Rows where valid=False
    get assignment -1."""
    from tpuvdb_torch.device import resolve_device

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    valid_idx = np.flatnonzero(valid)
    if len(valid_idx) == 0:
        raise ValueError("kmeans on empty data")
    take = rng.choice(valid_idx, size=min(nlist, len(valid_idx)),
                      replace=False)
    cents = np.asarray(data[take], np.float32)
    if len(take) < nlist:  # fewer points than lists: tile + jitter
        reps = -(-nlist // len(take))
        cents = np.tile(cents, (reps, 1))[:nlist]
        cents += rng.standard_normal(cents.shape).astype(np.float32) * 1e-4

    data_t = torch.from_numpy(np.ascontiguousarray(data, np.float32)).to(dev)
    weight = torch.from_numpy(np.asarray(valid, np.float32)).to(dev)
    centroids = torch.from_numpy(cents).to(dev)
    for _ in range(iters):
        centroids, shift = _kmeans_step(data_t, weight, centroids, block_size)
        if shift < 1e-6:
            break
    assign = assign_blockwise(data_t, centroids, block_size).cpu().numpy()
    assign = np.where(valid, assign, -1).astype(np.int32)
    return centroids.cpu().numpy(), assign
