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

dtype=torch.int8 stores per-row quantized rows with their dequant scales
(`row_scales`; see kernels/quant.py). sqnorms stay those of the original
rows. int8 mirrors upload their codes and scales bit-exactly; f32 mirrors
are quantized per row on the host at build (`quantize_rows_np`), scattered
updates on the device (`quantize_rows`), as the reference does each. Search
is the int8 scan, with an exact re-rank of `rescore_fetch` dequantized
candidates fused in when that is > 0 (the engine's rescore_mode="device").

Not ported yet: the mesh paths (ROADMAP.md, multi-GPU).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from tpuvdb_torch.device import resolve_device
from tpuvdb_torch.index.layout import ShardMirror, StackedLayout
from tpuvdb_torch.kernels.distance import l2sq_topk
from tpuvdb_torch.kernels.quant import (l2sq_topk_int8,
                                        l2sq_topk_int8_rescored,
                                        quantize_rows, quantize_rows_np)

_DTYPES = (torch.float32, torch.bfloat16, torch.int8)
_QUANTIZE_ROWS = 1 << 16  # f32 rows quantized at once at build


class DeviceExactIndex:
    def __init__(
        self,
        layout: StackedLayout,
        dtype=torch.float32,
        block_size: int = 8192,
        search_mode: str = "approx",
        recall_target: float = 0.95,
        rescore_fetch: int = 0,
        device=None,
    ):
        if dtype not in _DTYPES:
            raise ValueError(f"storage dtype {dtype} not in {_DTYPES}")
        self.device = resolve_device(device)
        self.layout = layout
        self.dtype = dtype
        self.block_size = block_size
        self.search_mode = search_mode
        self.recall_target = recall_target  # the largest k the scan serves
        # int8 only: > 0 fuses an exact re-rank of this many dequantized
        # candidates into the search (kernels/quant.py)
        self.rescore_fetch = rescore_fetch
        self.quantized = dtype == torch.int8
        n, d = layout.total_rows, layout.dim
        self.vectors = torch.zeros((n, d), dtype=dtype, device=self.device)
        # per-row dequant scales (int8 storage only)
        self.row_scales = (torch.ones(n, dtype=torch.float32,
                                      device=self.device)
                           if self.quantized else None)
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
        rescore_fetch: int = 0,
        device=None,
    ) -> "DeviceExactIndex":
        """Upload the mirrors' written prefixes shard by shard (no stacked
        host copy of the corpus). sqnorms come from the mirrors, as the
        reference's `layout.stack` takes them. An int8 index takes int8
        mirrors' codes and scales as they are, and quantizes f32 rows per
        row on the host, a block at a time."""
        layout = StackedLayout.for_mirrors(mirrors, block=block_size)
        idx = cls(layout, dtype=dtype, block_size=block_size,
                  search_mode=search_mode, recall_target=recall_target,
                  rescore_fetch=rescore_fetch, device=device)
        raw = idx.quantized and all(m.quantized for m in mirrors)
        for s, m in enumerate(mirrors):
            if raw:
                vec, scale, sq, valid = m.prefix_raw()
            else:
                vec, sq, valid = m.prefix_f32()
            r0 = layout.row_of(s, 0)
            r1 = r0 + vec.shape[0]
            if idx.quantized and not raw:
                for lo in range(0, vec.shape[0], _QUANTIZE_ROWS):
                    qv, scale = quantize_rows_np(vec[lo:lo + _QUANTIZE_ROWS])
                    b0, b1 = r0 + lo, r0 + lo + len(qv)
                    idx.vectors[b0:b1] = torch.from_numpy(qv)
                    idx.row_scales[b0:b1] = torch.from_numpy(scale)
            else:
                idx.vectors[r0:r1] = torch.from_numpy(
                    np.ascontiguousarray(vec))
                if raw:
                    idx.row_scales[r0:r1] = torch.from_numpy(
                        np.ascontiguousarray(scale))
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
        rescore_fetch: int = 0,
        row_scales: Optional[np.ndarray] = None,  # (total_rows,) f32, int8
        device=None,
    ) -> "DeviceExactIndex":
        """An index holding given arrays, e.g. a JAX index's
        (`np.asarray(jax_index.vectors)`, ...). dtype None keeps the
        vectors' own dtype (float32, bfloat16 given as float32 values, or
        int8 codes, which need their `row_scales`)."""
        vectors = np.asarray(vectors)
        if vectors.shape != (layout.total_rows, layout.dim):
            raise ValueError(f"vectors {vectors.shape} do not match layout "
                             f"({layout.total_rows}, {layout.dim})")
        if dtype is None:
            dtype = (torch.int8 if vectors.dtype == np.int8
                     else torch.float32)
        if (dtype == torch.int8) != (row_scales is not None) or (
                dtype == torch.int8 and vectors.dtype != np.int8):
            raise ValueError("int8 storage takes int8 codes with their "
                             "row_scales, other dtypes take neither")
        idx = cls(layout, dtype=dtype, block_size=block_size,
                  search_mode=search_mode, recall_target=recall_target,
                  rescore_fetch=rescore_fetch, device=device)
        if idx.quantized:
            idx.vectors.copy_(torch.from_numpy(np.array(vectors)))
            idx.row_scales.copy_(torch.from_numpy(
                np.array(row_scales, np.float32)))
        else:
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
        reference's scatter does; int8 storage quantizes the rows here."""
        keep = self._in_range(rows)
        if not keep.any():
            return
        dev = self.device
        r = torch.from_numpy(np.asarray(rows, np.int64)[keep]).to(dev)
        v = torch.from_numpy(
            np.ascontiguousarray(np.asarray(vecs, np.float32)[keep])).to(dev)
        ok = torch.from_numpy(np.asarray(valid_vals, bool)[keep]).to(dev)
        self.version += 1
        if self.quantized:
            qv, scales = quantize_rows(v)
            self.vectors.index_copy_(0, r, qv)
            self.row_scales.index_copy_(0, r, scales)
        else:
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
               valid: torch.Tensor = None,
               rescore: bool = True) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k over all live rows (or over `valid`, a device bool mask
        that replaces `self.valid`). Returns (dists, rows) as numpy, dists
        ascending squared-L2; empty slots are +inf / -1. rescore=False
        leaves out the re-rank that `rescore_fetch` fuses into an int8
        search."""
        q = torch.from_numpy(
            np.ascontiguousarray(queries, np.float32)).to(self.device)
        valid = self.valid if valid is None else valid
        if self.quantized and self.rescore_fetch > 0 and rescore:
            dist, rows = l2sq_topk_int8_rescored(
                q, self.vectors, self.row_scales, self.sqnorms, valid, k=k,
                fetch=max(self.rescore_fetch, k))
        elif self.quantized:
            dist, rows = l2sq_topk_int8(
                q, self.vectors, self.row_scales, self.sqnorms, valid, k=k)
        else:
            dist, rows = l2sq_topk(
                q, self.vectors, self.sqnorms, valid,
                k=k, block_size=self.block_size, mode=self.search_mode,
                recall_target=self.recall_target)
        return dist.cpu().numpy(), rows.cpu().numpy()

    def nbytes(self) -> int:
        return (self.vectors.numel() * self.vectors.element_size()
                + self.sqnorms.numel() * 4 + self.valid.numel()
                + (self.row_scales.numel() * 4 if self.quantized else 0))
