"""Device-resident exact index: the port of tpuvdb.index.exact.

Holds the stacked shard row space on the device: vectors, squared norms and
the validity mask, as torch tensors on `device` (None = "cuda"). Row ids are
the reference's (`StackedLayout`: row = shard * phys_cap + slot), so a JAX
index's arrays load 1:1 through `from_numpy`.

Updates are in-place `index_copy_` scatters. The reference donates its
buffers to jitted scatters, so a search still holding an old buffer fails
and retries; an in-place scatter raises nothing. Instead:

  * every scatter bumps `version` (the engine runs scatters under its
    flush lock); a search that sees `version` change while it ran retries;
  * inside one scatter, vectors and sqnorms are written before `valid`, so
    a concurrent scan sees a half-written row only as masked.

Rows outside [0, total_rows) are dropped, so callers may pad update batches
(the reference pads to fixed 4096-row buckets to avoid XLA recompiles; the
port needs no fixed shape and applies each batch in one scatter).

Not ported yet: int8 storage (quantize-on-scatter, fused rescore) and the
mesh paths; they wait for the int8 tier and multi-GPU items of ROADMAP.md.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from tpuvdb_torch.device import resolve_device
from tpuvdb_torch.index.layout import ShardMirror, StackedLayout
from tpuvdb_torch.kernels.distance import l2sq_topk

_DTYPES = (torch.float32, torch.bfloat16)


class DeviceExactIndex:
    def __init__(
        self,
        layout: StackedLayout,
        dtype=torch.float32,
        block_size: int = 8192,
        search_mode: str = "approx",
        recall_target: float = 0.95,
        device=None,
    ):
        if dtype not in _DTYPES:
            raise NotImplementedError(
                f"storage dtype {dtype}: int8 storage waits for the int8 "
                "tier (ROADMAP.md queue 1, item 6)")
        self.device = resolve_device(device)
        self.layout = layout
        self.dtype = dtype
        self.block_size = block_size
        self.search_mode = search_mode
        self.recall_target = recall_target  # the largest k the scan serves
        n, d = layout.total_rows, layout.dim
        self.vectors = torch.zeros((n, d), dtype=dtype, device=self.device)
        self.sqnorms = torch.zeros(n, dtype=torch.float32, device=self.device)
        self.valid = torch.zeros(n, dtype=torch.bool, device=self.device)
        self.version = 0  # bumped by every scatter

    # ------------------------------------------------------------------ build

    @classmethod
    def build(
        cls,
        mirrors: List[ShardMirror],
        dtype=torch.float32,
        block_size: int = 8192,
        search_mode: str = "approx",
        recall_target: float = 0.95,
        device=None,
    ) -> "DeviceExactIndex":
        """Upload the mirrors' written prefixes shard by shard (no stacked
        host copy of the corpus). sqnorms come from the mirrors, as the
        reference's `layout.stack` takes them."""
        layout = StackedLayout.for_mirrors(mirrors, block=block_size)
        idx = cls(layout, dtype=dtype, block_size=block_size,
                  search_mode=search_mode, recall_target=recall_target,
                  device=device)
        for s, m in enumerate(mirrors):
            vec, sq, valid = m.prefix_f32()
            r0 = layout.row_of(s, 0)
            r1 = r0 + vec.shape[0]
            idx.vectors[r0:r1] = torch.from_numpy(np.ascontiguousarray(vec))
            idx.sqnorms[r0:r1] = torch.from_numpy(np.ascontiguousarray(sq))
            idx.valid[r0:r1] = torch.from_numpy(np.ascontiguousarray(valid))
        return idx

    @classmethod
    def from_numpy(
        cls,
        layout: StackedLayout,
        vectors: np.ndarray,       # (total_rows, dim)
        sqnorms: np.ndarray,       # (total_rows,) f32
        valid: np.ndarray,         # (total_rows,) bool
        dtype=None,
        block_size: int = 8192,
        search_mode: str = "approx",
        recall_target: float = 0.95,
        device=None,
    ) -> "DeviceExactIndex":
        """An index holding given arrays, e.g. a JAX index's
        (`np.asarray(jax_index.vectors)`, ...). dtype None keeps the
        vectors' own dtype (float32, or bfloat16 given as float32 values)."""
        vectors = np.asarray(vectors)
        if vectors.shape != (layout.total_rows, layout.dim):
            raise ValueError(f"vectors {vectors.shape} do not match layout "
                             f"({layout.total_rows}, {layout.dim})")
        idx = cls(layout, dtype=torch.float32 if dtype is None else dtype,
                  block_size=block_size, search_mode=search_mode,
                  recall_target=recall_target, device=device)
        idx.vectors.copy_(torch.from_numpy(vectors.astype(np.float32)))
        idx.sqnorms.copy_(torch.from_numpy(np.array(sqnorms, np.float32)))
        idx.valid.copy_(torch.from_numpy(np.array(valid, bool)))
        return idx

    def needs_rebuild(self, mirrors: List[ShardMirror]) -> bool:
        """True when a mirror outgrew the common physical capacity."""
        return any(m.phys_cap > self.layout.phys_cap for m in mirrors) or (
            len(mirrors) != self.layout.num_shards)

    # ---------------------------------------------------------------- updates

    def _in_range(self, rows: np.ndarray) -> np.ndarray:
        rows = np.asarray(rows, np.int64)
        return (rows >= 0) & (rows < self.layout.total_rows)

    def apply_updates(
        self,
        rows: np.ndarray,          # (n,) physical rows
        vecs: np.ndarray,          # (n, dim) float32
        valid_vals: np.ndarray,    # (n,) bool
    ):
        """Scatter a batch of slot writes in one go; out-of-range rows are
        dropped. sqnorms are recomputed from the f32 rows, as the
        reference's scatter does."""
        keep = self._in_range(rows)
        if not keep.any():
            return
        dev = self.device
        r = torch.from_numpy(np.asarray(rows, np.int64)[keep]).to(dev)
        v = torch.from_numpy(
            np.ascontiguousarray(np.asarray(vecs, np.float32)[keep])).to(dev)
        ok = torch.from_numpy(np.asarray(valid_vals, bool)[keep]).to(dev)
        self.version += 1
        self.vectors.index_copy_(0, r, v.to(self.dtype))
        self.sqnorms.index_copy_(0, r, (v * v).sum(dim=-1))
        self.valid.index_copy_(0, r, ok)

    def apply_deletes(self, rows: np.ndarray):
        keep = self._in_range(rows)
        if not keep.any():
            return
        r = torch.from_numpy(np.asarray(rows, np.int64)[keep]).to(self.device)
        self.version += 1
        self.valid.index_fill_(0, r, False)

    # ----------------------------------------------------------------- search

    def search(self, queries: np.ndarray, k: int,
               valid: torch.Tensor = None) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k over all live rows (or over `valid`, a device bool mask
        that replaces `self.valid`). Returns (dists, rows) as numpy, dists
        ascending squared-L2; empty slots are +inf / -1."""
        q = torch.from_numpy(
            np.ascontiguousarray(queries, np.float32)).to(self.device)
        dist, rows = l2sq_topk(
            q, self.vectors, self.sqnorms,
            self.valid if valid is None else valid,
            k=k, block_size=self.block_size, mode=self.search_mode,
            recall_target=self.recall_target)
        return dist.cpu().numpy(), rows.cpu().numpy()

    def nbytes(self) -> int:
        return (self.vectors.numel() * self.vectors.element_size()
                + self.sqnorms.numel() * 4 + self.valid.numel())
