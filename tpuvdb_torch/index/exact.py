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

With a mesh (`mesh/`), the row space splits over `mesh_axis`:
slot s at position p of that axis holds rows [p * R, (p + 1) * R) in its
own tensors on its own device, so `vectors`, `row_scales`, `sqnorms` and
`valid` are lists over the mesh's flat slots (None at another process's
slot); a 2-D (repl, shards) mesh holds each shard once per replica group.
Updates route each row to the slots that own it (`row // R`), search is
`mesh/sharded.sharded_search` (or `mesh/replicated.replicated_search`,
the batch padded to a multiple of the replica groups and the pad cut off),
and `nbytes()` sums the slots. A mesh of one slot takes the single-device
path on that slot's device, as the reference's does.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from tpuvdb_torch.device import resolve_device
from tpuvdb_torch.index.layout import ShardMirror, StackedLayout
from tpuvdb_torch.kernels.quant import quantize_rows, quantize_rows_np
from tpuvdb_torch.mesh.mesh import Mesh, sum_over_processes
from tpuvdb_torch.mesh.replicated import pad_to_groups, replicated_search
from tpuvdb_torch.mesh.sharded import local_topk, sharded_search

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
        mesh: Optional[Mesh] = None,
        mesh_axis: str = "shards",
    ):
        if dtype not in _DTYPES:
            raise ValueError(f"storage dtype {dtype} not in {_DTYPES}")
        if mesh is not None and mesh.size == 1:
            device, mesh = mesh.flat_devices()[0], None
        self.mesh = mesh
        self.mesh_axis = mesh_axis
        self.layout = layout
        self.dtype = dtype
        self.block_size = block_size
        self.search_mode = search_mode
        self.recall_target = recall_target  # the largest k the scan serves
        # int8 only: > 0 fuses an exact re-rank of this many dequantized
        # candidates into the search (kernels/quant.py)
        self.rescore_fetch = rescore_fetch
        self.quantized = dtype == torch.int8
        n = layout.total_rows
        if mesh is None:
            self.device = resolve_device(device)
            (self.vectors, self.row_scales, self.sqnorms,
             self.valid) = self._alloc(n, self.device)
        else:
            nshards = mesh.shape[mesh_axis]
            if n % nshards != 0:
                raise ValueError(f"rows {n} not divisible by mesh size "
                                 f"{nshards}")
            self.rows_per_slot = n // nshards
            self._grid = mesh.slot_grid(mesh_axis)
            devs = mesh.flat_devices()
            parts = [self._alloc(self.rows_per_slot, resolve_device(dev))
                     if mesh.is_local(s) else (None,) * 4
                     for s, dev in enumerate(devs)]
            self.vectors, self.row_scales, self.sqnorms, self.valid = (
                list(col) for col in zip(*parts))
            if not self.quantized:
                self.row_scales = None
            # the merge device of the first replica group
            self.device = devs[mesh.local_slots()[0]]
        self.version = 0  # bumped by every scatter

    def _alloc(self, n: int, dev: torch.device):
        """(vectors, row_scales | None, sqnorms, valid) of n empty rows."""
        return (torch.zeros((n, self.layout.dim), dtype=self.dtype,
                            device=dev),
                # per-row dequant scales (int8 storage only)
                torch.ones(n, dtype=torch.float32, device=dev)
                if self.quantized else None,
                torch.zeros(n, dtype=torch.float32, device=dev),
                torch.zeros(n, dtype=torch.bool, device=dev))

    def _part(self, name: str, slot: Optional[int]) -> torch.Tensor:
        """Storage tensor `name` of one slot (slot None: the single
        device's)."""
        t = getattr(self, name)
        return t if slot is None else t[slot]

    def _owners(self, pos: int) -> list:
        """This process's slots at shard position `pos` (every replica)."""
        return [s for s in self._grid[:, pos].tolist()
                if self.mesh.is_local(s)]

    def _route(self, rows: np.ndarray):
        """Split physical rows by owner: yields (positions in `rows`, the
        rows local to the owners, the owning slots; None = the single
        device)."""
        if self.mesh is None:
            yield np.arange(len(rows)), rows, [None]
            return
        per = self.rows_per_slot
        pos = rows // per
        for p in np.unique(pos).tolist():
            sel = np.flatnonzero(pos == p)
            yield sel, rows[sel] - p * per, self._owners(p)

    def _place(self, r0: int, **arrays):
        """Copy host rows [r0, r0 + n) of each named storage array into the
        device storage (mesh: into every slot that owns a row)."""
        n = len(next(iter(arrays.values())))
        if n == 0:
            return
        if self.mesh is None:
            spans = [(0, n, [None], r0)]
        else:
            per = self.rows_per_slot
            spans = []
            for p in range(r0 // per, (r0 + n - 1) // per + 1):
                lo, hi = max(r0, p * per), min(r0 + n, (p + 1) * per)
                spans.append((lo - r0, hi - r0, self._owners(p), lo - p * per))
        for lo, hi, slots, off in spans:
            for s in slots:
                for name, a in arrays.items():
                    self._part(name, s)[off:off + hi - lo] = (
                        torch.from_numpy(np.ascontiguousarray(a[lo:hi])))

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
        mesh: Optional[Mesh] = None,
        mesh_axis: str = "shards",
    ) -> "DeviceExactIndex":
        """Upload the mirrors' written prefixes shard by shard (no stacked
        host copy of the corpus). sqnorms come from the mirrors, as the
        reference's `layout.stack` takes them. An int8 index takes int8
        mirrors' codes and scales as they are, and quantizes f32 rows per
        row on the host, a block at a time. On a mesh the rows divide over
        the shard axis (the layout rounds them to a multiple of it)."""
        ndev = mesh.shape[mesh_axis] if mesh is not None else 1
        layout = StackedLayout.for_mirrors(mirrors, block=block_size,
                                           min_rows_multiple=ndev)
        idx = cls(layout, dtype=dtype, block_size=block_size,
                  search_mode=search_mode, recall_target=recall_target,
                  rescore_fetch=rescore_fetch, device=device, mesh=mesh,
                  mesh_axis=mesh_axis)
        raw = idx.quantized and all(m.quantized for m in mirrors)
        for s, m in enumerate(mirrors):
            if raw:
                vec, scale, sq, valid = m.prefix_raw()
            else:
                vec, sq, valid = m.prefix_f32()
            r0 = layout.row_of(s, 0)
            if idx.quantized and not raw:
                for lo in range(0, vec.shape[0], _QUANTIZE_ROWS):
                    qv, scale = quantize_rows_np(vec[lo:lo + _QUANTIZE_ROWS])
                    idx._place(r0 + lo, vectors=qv, row_scales=scale)
            elif raw:
                idx._place(r0, vectors=vec, row_scales=scale)
            else:
                idx._place(r0, vectors=vec)
            idx._place(r0, sqnorms=sq, valid=valid)
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
        mesh: Optional[Mesh] = None,
        mesh_axis: str = "shards",
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
                  rescore_fetch=rescore_fetch, device=device, mesh=mesh,
                  mesh_axis=mesh_axis)
        if idx.quantized:
            idx._place(0, vectors=vectors,
                       row_scales=np.asarray(row_scales, np.float32))
        else:
            idx._place(0, vectors=vectors.astype(np.float32))
        idx._place(0, sqnorms=np.asarray(sqnorms, np.float32),
                   valid=np.asarray(valid, bool))
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
        reference's scatter does; int8 storage quantizes the rows here. On
        a mesh each row goes to the slots that own it."""
        keep = self._in_range(rows)
        if not keep.any():
            return
        rows = np.asarray(rows, np.int64)[keep]
        vecs = np.ascontiguousarray(np.asarray(vecs, np.float32)[keep])
        valid_vals = np.asarray(valid_vals, bool)[keep]
        self.version += 1
        for sel, local, slots in self._route(rows):
            for s in slots:
                dev = self._part("valid", s).device
                r = torch.from_numpy(local).to(dev)
                v = torch.from_numpy(vecs[sel]).to(dev)
                ok = torch.from_numpy(valid_vals[sel]).to(dev)
                vectors = self._part("vectors", s)
                if self.quantized:
                    qv, scales = quantize_rows(v)
                    vectors.index_copy_(0, r, qv)
                    self._part("row_scales", s).index_copy_(0, r, scales)
                else:
                    vectors.index_copy_(0, r, v.to(self.dtype))
                self._part("sqnorms", s).index_copy_(0, r,
                                                     (v * v).sum(dim=-1))
                self._part("valid", s).index_copy_(0, r, ok)

    def apply_deletes(self, rows: np.ndarray):
        keep = self._in_range(rows)
        if not keep.any():
            return
        self.version += 1
        for _, local, slots in self._route(np.asarray(rows, np.int64)[keep]):
            for s in slots:
                valid = self._part("valid", s)
                valid.index_fill_(0, torch.from_numpy(local).to(valid.device),
                                  False)

    def masked_valid(self, rows: np.ndarray):
        """`valid` restricted to the given physical rows (the filter
        pushdown), in the form search(valid=...) takes."""
        rows = np.asarray(rows, np.int64)
        rows = rows[self._in_range(rows)]
        masks = ([torch.zeros_like(self.valid)] if self.mesh is None
                 else [None if v is None else torch.zeros_like(v)
                       for v in self.valid])
        for _, local, slots in self._route(rows):
            for s in slots:
                m = masks[0 if s is None else s]
                m[torch.from_numpy(local).to(m.device)] = True
        if self.mesh is None:
            return self.valid & masks[0]
        return [None if v is None else v & m
                for v, m in zip(self.valid, masks)]

    # ----------------------------------------------------------------- search

    def search(self, queries: np.ndarray, k: int,
               valid=None,
               rescore: bool = True) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k over all live rows (or over `valid`, a mask from
        masked_valid() that replaces `self.valid`). Returns (dists, rows)
        as numpy, dists ascending squared-L2; empty slots are +inf / -1.
        rescore=False leaves out the re-rank that `rescore_fetch` fuses
        into an int8 search."""
        valid = self.valid if valid is None else valid
        fetch = self.rescore_fetch if self.quantized and rescore else 0
        q = np.ascontiguousarray(queries, np.float32)
        if self.mesh is None:
            dist, rows = local_topk(
                torch.from_numpy(q).to(self.device), self.vectors,
                self.sqnorms, valid, k, self.block_size, self.search_mode,
                self.recall_target, scales=self.row_scales,
                rescore_fetch=fetch)
        elif len(self.mesh.axis_names) == 2:
            # 2-D (repl, shards) mesh: the replica groups split the batch
            repl_axis = next(a for a in self.mesh.axis_names
                             if a != self.mesh_axis)
            q, qn = pad_to_groups(q, self.mesh.shape[repl_axis])
            dist, rows = replicated_search(
                q, self.vectors, self.sqnorms, valid, k=k,
                block_size=self.block_size, mesh=self.mesh,
                repl_axis=repl_axis, shard_axis=self.mesh_axis,
                mode=self.search_mode, recall_target=self.recall_target,
                row_scales=self.row_scales, rescore_fetch=fetch)
            dist, rows = dist[:qn], rows[:qn]
        else:
            dist, rows = sharded_search(
                q, self.vectors, self.sqnorms, valid, k=k,
                block_size=self.block_size, mesh=self.mesh,
                axis=self.mesh_axis, mode=self.search_mode,
                recall_target=self.recall_target,
                row_scales=self.row_scales, rescore_fetch=fetch)
        return dist.cpu().numpy(), rows.cpu().numpy()

    def nbytes(self) -> int:
        """Device bytes of the index (on a mesh: the sum over every slot,
        every replica counted; across processes a collective that sums
        each process's slots)."""
        parts = [self.vectors, self.sqnorms, self.valid]
        if self.quantized:
            parts.append(self.row_scales)
        tensors = (parts if self.mesh is None
                   else [t for p in parts for t in p if t is not None])
        own = sum(t.numel() * t.element_size() for t in tensors)
        if self.mesh is None:
            return own
        return sum_over_processes(self.mesh, [own])[0]
