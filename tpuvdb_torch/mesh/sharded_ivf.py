"""Distributed IVF over the slots of a mesh: the port of
tpuvdb/mesh/sharded_ivf.py.

Each shard position of the mesh owns a row range of the corpus and builds
its own k-means cell structure over it (no global quantizer). A query goes
to every slot; each slot scores its own centroids, probes its nprobe
nearest cells plus its spill region, and the per-slot top-k candidates
merge on the group's first slot (mesh/sharded.groups_topk). On a 2-D
(repl, shards) mesh every replica group holds its own copy of the cells
and serves its slice of the batch.

The host build is the reference's, step for step: per-shard k-means with
`seed + shard` (or the checkpoint's warm table), `nl = min(nlist, live //
4)`, 1e30 centroid pads, PQ / OPQ codebooks trained on residuals pooled
across shards, one scan window for all shards from the pooled median cell
x 1.25 (at most 2048 rows for PQ), `split_oversized_cells` and
`pack_cells` per shard, a per-shard spill reserve for appends, and common
shapes across shards. Cell rows are f32 unless int8 or PQ, as in the
reference's mesh index (bf16 storage stacks f32 cells there too).

Each slot holds one `IVFIndex` (index/ivf.py) over its shard's cells and
serves its probe (`IVFIndex.probe`: the probe kernels, or the PQ probe, on
the slot's device). The row maps and the cells' fill live here, on the
host, once per shard: grouped ids encode `shard * (local_rows +
spill_rows) + position` and map back through `row_ids` / `spill_row_ids`.
A slot's IVFIndex carries no row map of its own. Appends and deletes write
every replica of the owning shard in place and bump `version`.

The reference's PQ cells take an XLA gather on its mesh; here they run the
same PQ probe kernel as the single-device index.

Across processes (the reference's one program over a global mesh) every
process builds the host tables of every shard and uploads only its own
slots. The tables must be equal everywhere, and two steps of the build are
float reductions in torch that nothing shows bit-reproducible between
processes: k-means, and PQ / OPQ training. So each shard's k-means runs in
one process (rank = shard mod world size, which spreads the work) and its
centroid table is broadcast; the codebooks train on rank 0 and are
broadcast. The rest (the bisection of oversized cells and the packing,
host numpy) is arithmetic on equal inputs in every process, plus torch
assignments and encodes, and a digest of every host table (and of
the PQ codes the replicas upload) is all-gathered at the end of the build:
a mismatch raises. Appends, deletes and filters update every process's host
maps alike and write this process's replicas only; `stats()` and
`nbytes()` sum over the processes (collectives: every process calls them).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from tpuvdb_torch.index.ivf import (IVFIndex, IVFStats, build_inverse_maps,
                                    lookup_inverse, pack_cells,
                                    split_oversized_cells)
from tpuvdb_torch.kernels import pq as pqk
from tpuvdb_torch.kernels.kmeans import assign_blockwise, kmeans
from tpuvdb_torch.kernels.quant import quantize_rows_np
from tpuvdb_torch.mesh.mesh import (Mesh, broadcast_from,
                                    check_same_everywhere, digest,
                                    sum_over_processes)
from tpuvdb_torch.mesh.replicated import pad_to_groups, replicated_topk

_NO_ROWS = np.empty(0, np.int64)  # a slot's IVFIndex keeps no row map
_PAD = 1e30  # centroid table pad: scores -inf, never the nearest cell


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _live_centroids(cents: np.ndarray) -> np.ndarray:
    return cents[:, 0] < 1e29  # 1e30 rows pad a centroid table


class ShardedIVFIndex:
    def __init__(self, mesh: Mesh, axis: str, slots: list,
                 centroids: np.ndarray, cell_offsets: np.ndarray,
                 cell_lens: np.ndarray, row_ids: np.ndarray,
                 spill_row_ids: np.ndarray, spill_cells: np.ndarray,
                 cell_pad: int, nprobe: int, recall_target: float,
                 rows_per_dev: int, cell_caps: np.ndarray,
                 repl_axis: Optional[str] = None,
                 pq_codebooks: Optional[np.ndarray] = None,
                 pq_rotation: Optional[np.ndarray] = None):
        self.mesh = mesh
        self.axis = axis
        # 2-D (repl, shards) mesh: the cells are copied to every replica
        # group and search splits the batch over them
        self.repl_axis = repl_axis
        self.slots = slots          # flat mesh slot -> IVFIndex | None
        self._grid = mesh.slot_grid(axis)
        self.rows_per_dev = rows_per_dev  # global-row ownership stride
        self.centroids = centroids        # (ndev, nlist, d) f32, 1e30 pads
        self.cell_offsets = cell_offsets  # (ndev, nlist) i32
        self.cell_lens = cell_lens        # (ndev, nlist) i32 live rows
        # (ndev, nlist) each cell's allocated span (clipped to the scan
        # window), fixed at build: the offset difference the single-device
        # append uses is wrong here, since pad centroids' offsets point at
        # the tail and can precede live ones
        self.cell_caps = cell_caps
        self.row_ids = row_ids            # (ndev, local_rows) -> phys row
        self.spill_row_ids = spill_row_ids  # (ndev, spill_rows)
        self.spill_cells = spill_cells    # (ndev, spill_rows) PQ cells
        self.cell_pad = cell_pad
        self.nprobe = nprobe
        self.recall_target = recall_target
        self._pq_codebooks = pq_codebooks
        self._pq_rotation = pq_rotation
        self.pq = pq_codebooks is not None
        self.quantized = self._first().quantized
        # the reference's mesh index calibrates no PQ error bound: the
        # engine rescores the full window
        self.pq_err = 0.0
        self._inv_g = self._inv_s = None
        self.version = 0  # bumped by every in-place device write

    def _first(self) -> IVFIndex:
        return next(s for s in self.slots if s is not None)

    def _replicas(self, dev: int) -> list:
        """The IVFIndex of every slot of this process holding shard
        `dev`."""
        return [self.slots[s] for s in self._grid[:, dev].tolist()
                if self.slots[s] is not None]

    def host_digest(self) -> str:
        """A hash of the host tables (centroids, cell offsets, lengths and
        caps, row maps, spill cells, PQ codebooks and rotation): equal on
        every process of a mesh."""
        return digest(self.centroids, self.cell_offsets, self.cell_lens,
                      self.cell_caps, self.row_ids, self.spill_row_ids,
                      self.spill_cells, self._pq_codebooks,
                      self._pq_rotation,
                      np.asarray([self.cell_pad, self.nprobe,
                                  self.rows_per_dev]))

    def centroids_np(self) -> np.ndarray:
        return self.centroids

    def pq_codebooks_np(self) -> Optional[np.ndarray]:
        return self._pq_codebooks

    def pq_rotation_np(self) -> Optional[np.ndarray]:
        return self._pq_rotation

    # ------------------------------------------------------------------ build

    @classmethod
    def build(
        cls,
        vectors: np.ndarray,   # (N, d): shard i owns rows [i*N/ndev, ...)
        valid: np.ndarray,
        mesh: Mesh,
        axis: str = "shards",
        nlist: int = 64,       # cells PER SHARD
        nprobe: int = 16,
        kmeans_iters: int = 8,
        dtype=torch.float32,
        seed: int = 0,
        recall_target: float = 0.95,
        centroids: Optional[np.ndarray] = None,  # (ndev, nl, d) warm start
        repl_axis: Optional[str] = None,  # 2-D mesh: the replica axis
        pq_subq: int = 0,                 # > 0: PQ code cells (IVF-PQ)
        pq_codebooks: Optional[np.ndarray] = None,  # warm codebooks
        opq: bool = False,                # learned OPQ residual rotation
        pq_rotation: Optional[np.ndarray] = None,   # warm rotation
        pq_bits: int = 8,                 # 8 | 4 (two codes a byte)
    ) -> "ShardedIVFIndex":
        ndev = mesh.shape[axis]
        n, d = vectors.shape
        if n % ndev != 0:
            raise ValueError(f"rows {n} % devices {ndev} != 0")
        per = n // ndev
        grid = mesh.slot_grid(axis)
        devs = mesh.flat_devices()
        # each shard's training and encodes run on its first local slot's
        # device (or this process's first slot's, where it holds none)
        local = mesh.local_slots()
        shard_dev = [next((devs[s] for s in grid[:, dev].tolist()
                           if mesh.is_local(s)),
                          devs[local[0] if local else 0])
                     for dev in range(ndev)]
        world = (int(mesh.slot_ranks.max()) + 1 if mesh.distributed else 1)
        if pq_codebooks is not None and not pq_subq:
            pq_subq = pqk.pq_code_bytes(pq_codebooks)
        if pq_subq:
            if pq_bits not in (8, 4):
                raise ValueError(f"pq_bits={pq_bits} must be 8 or 4")
            pq_m = pq_subq if pq_bits == 8 else 2 * pq_subq
            pq_j = 256 if pq_bits == 8 else 16
            if d % pq_m != 0:
                raise ValueError(
                    f"pq_subq={pq_subq} at pq_bits={pq_bits} needs "
                    f"{pq_m} subspaces to divide dim={d}")
            if dtype == torch.int8:
                raise ValueError("pq_subq and int8 cells are exclusive")
            if (pq_codebooks is not None
                    and pq_codebooks.shape != (pq_m, pq_j, d // pq_m)):
                pq_codebooks = None  # stale warm shape or tier: retrain
            if pq_rotation is not None and pq_rotation.shape != (d, d):
                pq_rotation = None
                pq_codebooks = None  # codebooks are tied to their rotation
            if opq and pq_codebooks is not None and pq_rotation is None:
                pq_codebooks = None  # un-rotated warm codebooks: retrain
            if not opq:
                pq_rotation = None
            # (codebooks train after the per-shard assignment below:
            # residual coding needs x - c_assign samples)
        warm = centroids
        if (warm is not None
                and (warm.ndim != 3 or warm.shape[0] != ndev
                     or warm.shape[2] != d)):
            warm = None  # partition geometry changed: retrain

        trained = []
        for dev in range(ndev):
            lo = dev * per
            part_vec = vectors[lo:lo + per]
            live = np.flatnonzero(valid[lo:lo + per])
            nl = max(1, min(nlist, max(1, len(live) // 4)))
            wc = None
            if warm is not None:
                wc = warm[dev][_live_centroids(warm[dev])]  # drop pads
            cents = None
            if len(live) == 0:
                # 1e30 pads, not zeros: a zero table saved for an empty
                # partition would pass the warm pad filter on a later
                # restart and collapse the shard into one degenerate cell
                cents = np.full((nlist, d), _PAD, np.float32)
            elif wc is not None and len(wc):
                # checkpoint warm start: this shard's trained centroids
                # skip its k-means run
                cents = np.asarray(wc, np.float32)
            elif dev % world == mesh.rank:
                cents, _ = kmeans(part_vec[live], np.ones(len(live), bool),
                                  nlist=nl, iters=kmeans_iters,
                                  block_size=4096, seed=seed + dev,
                                  device=shard_dev[dev])
            trained.append(cents)
        # each trainer's table in every process, once all have trained
        # (warm tables too: each process read its own checkpoint)
        trained = [broadcast_from(mesh, c, dev % world)
                   for dev, c in enumerate(trained)]

        parts = []
        for dev in range(ndev):
            lo = dev * per
            part_vec = vectors[lo:lo + per]
            part_val = valid[lo:lo + per]
            cents = trained[dev]
            if not part_val.any():
                assign = np.full(per, -1, np.int32)
            else:
                nl = len(cents)
                if nl < nlist:  # pad the centroid table to the common size
                    cents = np.concatenate(
                        [cents, np.full((nlist - nl, d), _PAD, np.float32)])
                dev_t = shard_dev[dev]
                assign = assign_blockwise(
                    torch.from_numpy(np.ascontiguousarray(
                        part_vec, np.float32)).to(dev_t),
                    torch.from_numpy(cents[:nl]).to(dev_t),
                    block_size=4096).cpu().numpy()
                assign = np.where(part_val, assign, -1).astype(np.int32)
            parts.append((part_vec, part_val, cents, assign, lo))

        if pq_subq and pq_codebooks is None and mesh.rank == 0:
            # residual codebooks trained on x - c_assign pooled across
            # shards (global codebooks over per-shard coarse structures;
            # pre-split assignments: the residual distribution barely moves
            # under bisection, and the encode below uses the final cells)
            rng_ = np.random.default_rng(seed)
            res_parts = []
            budget = 262_144
            for part_vec, part_val, cents, assign, _ in parts:
                live = np.flatnonzero(part_val & (assign >= 0))
                if not len(live):
                    continue
                take = (rng_.choice(live, min(len(live),
                                              budget // max(len(parts), 1)),
                                    replace=False)
                        if len(live) > budget // max(len(parts), 1)
                        else live)
                res_parts.append(part_vec[take] - cents[assign[take]])
            pooled_res = np.concatenate(res_parts).astype(np.float32)
            if opq:
                # one global rotation over the pooled residuals (the
                # codebooks are global, so the rotation must be)
                pq_codebooks, pq_rotation = pqk.train_opq(
                    pooled_res, m_subq=pq_m, seed=seed, n_codes=pq_j,
                    device=shard_dev[0])
            else:
                pq_codebooks = pqk.train_pq(pooled_res, m_subq=pq_m,
                                            seed=seed, n_codes=pq_j,
                                            device=shard_dev[0])
        if pq_subq:
            # rank 0's codebooks (trained or warm) in every process
            pq_codebooks, pq_rotation = broadcast_from(
                mesh, (pq_codebooks, pq_rotation), 0)

        # one scan window for every shard: pooled median x 1.25, then each
        # shard bisects its oversized cells and packs (index/ivf.py
        # pack_cells)
        pooled = []
        for _, part_val, _, assign, _ in parts:
            la = assign[assign >= 0]
            if len(la):
                pooled.append(np.bincount(la))
        pooled_sizes = (np.concatenate(pooled) if pooled
                        else np.asarray([1]))
        pooled_sizes = pooled_sizes[pooled_sizes > 0]
        cap = (int(np.quantile(pooled_sizes, 0.5) * 1.25)
               if len(pooled_sizes) else 1)
        if pq_subq:
            cap = min(cap, 2048)  # bound ADC candidates (index/ivf.py)
        cell_pad = max(_round_up(max(cap, 1), 128), 128)

        packed = []
        for dev, (part_vec, part_val, cents, assign, lo) in enumerate(parts):
            live_mask = part_val & (assign >= 0)
            if live_mask.any():
                cents2, assign2 = split_oversized_cells(
                    part_vec, assign, cents, cell_pad, seed=seed + dev)
            else:
                cents2, assign2 = cents, assign
            live = np.flatnonzero(part_val & (assign2 >= 0))
            gvec, gval_, grow, offs, lens, spill_local = pack_cells(
                part_vec, live, assign2[live], len(cents2), cell_pad)
            grow[grow >= 0] += lo          # local -> global physical rows
            spill_local = np.asarray(spill_local, np.int64)
            packed.append((cents2, gvec, gval_, grow, offs, lens,
                           (lo + spill_local).tolist(),
                           assign2[spill_local].astype(np.int32)))

        # common shapes across shards
        nlist_c = max(len(pk[0]) for pk in packed)
        local_rows = max(pk[1].shape[0] for pk in packed)
        spill_n = max(max((len(pk[6]) for pk in packed), default=1), 1)
        # per-shard spill reserve so append_rows can overflow full cells
        # without a rebuild (scaled down for small partitions)
        reserve = min(4096, max(128, per // 8))
        spill_rows = _round_up(spill_n + reserve, 128)

        cents_all = np.full((ndev, nlist_c, d), _PAD, np.float32)
        grouped = np.zeros((ndev, local_rows, d), np.float32)
        gval = np.zeros((ndev, local_rows), bool)
        row_ids = np.full((ndev, local_rows), -1, np.int64)
        offsets_all = np.zeros((ndev, nlist_c), np.int32)
        lens_all = np.zeros((ndev, nlist_c), np.int32)
        spill = np.zeros((ndev, spill_rows, d), np.float32)
        sval = np.zeros((ndev, spill_rows), bool)
        srow = np.full((ndev, spill_rows), -1, np.int64)
        scell = np.zeros((ndev, spill_rows), np.int32)
        for dev, (cents2, gvec, gval_, grow, offs, lens, spill_g,
                  spill_c) in enumerate(packed):
            nl, nr = len(cents2), gvec.shape[0]
            cents_all[dev, :nl] = cents2
            grouped[dev, :nr] = gvec
            gval[dev, :nr] = gval_
            row_ids[dev, :nr] = grow
            offsets_all[dev, :nl] = offs
            lens_all[dev, :nl] = lens
            # pad centroids' offsets point at the (always-invalid) tail
            offsets_all[dev, nl:] = max(local_rows - cell_pad, 0)
            ns = len(spill_g)
            if ns:
                spill[dev, :ns] = vectors[np.asarray(spill_g, np.int64)]
                sval[dev, :ns] = True
                srow[dev, :ns] = spill_g
            scell[dev, :len(spill_c)] = spill_c
        gsq = np.einsum("knd,knd->kn", grouped, grouped).astype(np.float32)
        ssq = np.einsum("knd,knd->kn", spill, spill).astype(np.float32)

        gscale = sscale = None
        if pq_subq:
            # residual PQ cells: each row codes x - c_cell; a grouped
            # position's cell comes from the packed offsets (searchsorted
            # over the ascending cell starts), spill rows carry their cell
            # ids. Padding rows code garbage against a zeroed centroid and
            # stay masked by their validity.
            gq = np.zeros(grouped.shape[:2] + (pq_subq,), np.uint8)
            sq8 = np.zeros(spill.shape[:2] + (pq_subq,), np.uint8)
            for dev in range(ndev):
                cents2 = packed[dev][0]
                offs = packed[dev][4]
                safe = np.where(np.abs(cents2) > 1e29, 0.0,
                                cents2).astype(np.float32)
                pos_cell = np.clip(
                    np.searchsorted(offs, np.arange(local_rows),
                                    side="right") - 1, 0, len(offs) - 1)
                gq[dev], gsq[dev] = pqk.encode_pq_residual_chunked(
                    grouped[dev], None, safe[pos_cell], pq_codebooks,
                    rotation=pq_rotation, device=shard_dev[dev])
                sq8[dev], ssq[dev] = pqk.encode_pq_residual_chunked(
                    spill[dev], None,
                    safe[np.clip(scell[dev], 0, len(safe) - 1)],
                    pq_codebooks, rotation=pq_rotation,
                    device=shard_dev[dev])
            grouped, spill = gq, sq8
        if dtype == torch.int8:
            # scaled int8 cells: per-row quantization, exact f32 norms
            gq = np.zeros(grouped.shape[:2] + (d,), np.int8)
            gscale = np.zeros(grouped.shape[:2], np.float32)
            sq8 = np.zeros(spill.shape[:2] + (d,), np.int8)
            sscale = np.zeros(spill.shape[:2], np.float32)
            for dev in range(ndev):
                gq[dev], gscale[dev] = quantize_rows_np(grouped[dev])
                sq8[dev], sscale[dev] = quantize_rows_np(spill[dev])
            grouped, spill = gq, sq8

        nprobe = min(nprobe, nlist_c)
        slots = [None] * mesh.size
        for g_slots in grid:
            for dev, s in enumerate(g_slots.tolist()):
                if not mesh.is_local(s):
                    continue
                slots[s] = IVFIndex.from_numpy(
                    centroids=cents_all[dev], grouped=grouped[dev],
                    grouped_sq=gsq[dev], grouped_valid=gval[dev],
                    row_ids=_NO_ROWS, spill=spill[dev], spill_sq=ssq[dev],
                    spill_valid=sval[dev], spill_row_ids=_NO_ROWS,
                    cell_offsets=offsets_all[dev], cell_lens=lens_all[dev],
                    cell_pad=cell_pad, nprobe=nprobe,
                    dtype=torch.int8 if dtype == torch.int8
                    else torch.float32,
                    device=devs[s],
                    cell_scales=None if gscale is None else gscale[dev],
                    spill_scales=None if sscale is None else sscale[dev],
                    pq_codebooks=pq_codebooks,
                    spill_cells=scell[dev] if pq_subq else None,
                    pq_rotation=pq_rotation)
        idx = cls(
            mesh, axis, slots,
            centroids=cents_all,
            cell_offsets=offsets_all,
            cell_lens=lens_all,
            row_ids=row_ids,
            spill_row_ids=srow,
            spill_cells=scell,
            cell_pad=cell_pad,
            nprobe=nprobe,
            recall_target=recall_target,
            rows_per_dev=per,
            cell_caps=np.minimum(
                _round_up(lens_all.astype(np.int64), 128), cell_pad),
            repl_axis=repl_axis,
            pq_codebooks=(None if pq_codebooks is None
                          else np.asarray(pq_codebooks, np.float32)),
            pq_rotation=(None if pq_rotation is None
                         else np.asarray(pq_rotation, np.float32)),
        )
        # the PQ codes come from torch encodes in each process: a replica
        # of a shard in another process must upload the same ones
        check_same_everywhere(
            mesh, "the sharded IVF index's host tables",
            idx.host_digest() + (digest(grouped, gsq, spill, ssq)
                                 if pq_subq else ""))
        return idx

    # ------------------------------------------------------------ accounting

    def stats(self) -> IVFStats:
        """Over one copy of the shards (a replica group): each shard is
        counted at its slot in the first group, by the process that owns
        it, and summed over the processes."""
        valid_g = total_g = valid_s = 0
        for s in self._grid[0].tolist():
            if self.slots[s] is not None:
                g = self.slots[s]
                valid_g += int(g.grouped_valid.sum())
                total_g += int(g.grouped_valid.numel())
                valid_s += int(g.spill_valid.sum())
        valid_g, total_g, valid_s = sum_over_processes(
            self.mesh, (valid_g, total_g, valid_s))
        return IVFStats(
            nlist=int(self.centroids.shape[0] * self.centroids.shape[1]),
            cell_pad=self.cell_pad,
            spill_rows=valid_s,
            grouped_rows=total_g,
            fill=valid_g / max(total_g, 1),
        )

    def nbytes(self) -> int:
        """Device bytes over every slot of the mesh, every replica
        counted (summed over the processes)."""
        return sum_over_processes(
            self.mesh, [sum(s.nbytes() for s in self.slots
                            if s is not None)])[0]

    # ------------------------------------------------------------- mutations

    def _inverse_maps(self):
        """phys row -> flat (shard * local + position) slot, built once:
        deletes are O(batch)."""
        if self._inv_g is None:
            self._inv_g, self._inv_s = build_inverse_maps(
                self.row_ids, self.spill_row_ids)
        return self._inv_g, self._inv_s

    def _split_hits(self, hits: np.ndarray, width: int):
        """Flat (shard * width + position) hits -> {shard: positions}."""
        dev = hits // width
        return {int(d): hits[dev == d] - d * width for d in np.unique(dev)}

    def invalidate_rows(self, physical_rows: np.ndarray):
        """Soft-delete by physical row (the engine's delete path): clears
        the validity of the rows' grouped and spill slots in every replica,
        in place."""
        phys = np.asarray(physical_rows, np.int64)
        if phys.size == 0:
            return
        g_hits, s_hits = lookup_inverse(*self._inverse_maps(), phys)
        self.version += 1
        for hits, width, name in (
                (g_hits, self.row_ids.shape[1], "grouped_valid"),
                (s_hits, self.spill_row_ids.shape[1], "spill_valid")):
            for dev, pos in self._split_hits(hits, width).items():
                for rep in self._replicas(dev):
                    t = getattr(rep, name)
                    t.index_fill_(0, torch.from_numpy(pos).to(t.device),
                                  False)

    def warm_append(self):
        """Run the append path's device work (the PQ encode) once at
        (re)build time, so the first append under the engine's lock does
        not load it; the reference compiles its scatter programs here."""
        if self.pq:
            dim = int(self.centroids.shape[-1])
            pqk.encode_pq_residual_chunked(
                np.zeros((1, dim), np.float32), None,
                np.zeros((1, dim), np.float32), self._first().pq_codebooks,
                rotation=self._first().pq_rotation)

    def append_rows(self, physical_rows: np.ndarray,
                    vectors: np.ndarray) -> bool:
        """Incremental appends (the contract of IVFIndex.append_rows): each
        row goes to its owning shard (physical row // rows_per_dev, the
        build-time split), to that shard's nearest existing centroid, and
        lands in the cell's free window slots or the shard's spill
        reserve. Allocation is planned in full before any write; False =
        some shard is out of room (the caller rebuilds)."""
        phys = np.asarray(physical_rows, np.int64)
        vecs = np.asarray(vectors, np.float32)
        m = len(phys)
        if m == 0:
            return True
        ndev, local_rows = self.row_ids.shape
        spill_rows = self.spill_row_ids.shape[1]
        dev_of = phys // self.rows_per_dev
        if (dev_of >= ndev).any() or (dev_of < 0).any():
            return False  # rows outside the built partition: rebuild
        offs_all = self.cell_offsets.astype(np.int64)
        lens_all = self.cell_lens.astype(np.int64).copy()
        spill_fill = (self.spill_row_ids >= 0).sum(axis=1)

        # ---- plan per shard (host nearest-centroid: the batch is small and
        # the shards' tables differ in live count)
        g_dev, g_pos, g_take = [], [], []
        s_dev, s_pos, s_take = [], [], []
        assign_global = np.zeros(m, np.int32)  # residual-PQ encode cells
        for dev in range(ndev):
            sel = np.flatnonzero(dev_of == dev)
            if not len(sel):
                continue
            cents = self.centroids[dev]
            live_c = _live_centroids(cents)
            if not live_c.any():
                return False
            cids = np.flatnonzero(live_c)
            sub = vecs[sel]
            d2 = (np.einsum("nd,nd->n", sub, sub)[:, None]
                  - 2.0 * (sub @ cents[cids].T)
                  + np.einsum("kd,kd->k", cents[cids], cents[cids])[None, :])
            assign = cids[np.argmin(d2, axis=1)]
            assign_global[sel] = assign
            caps = self.cell_caps[dev]
            fill = int(spill_fill[dev])
            for i, c in zip(sel.tolist(), assign.tolist()):
                if lens_all[dev, c] < caps[c]:
                    g_dev.append(dev)
                    g_pos.append(int(offs_all[dev, c] + lens_all[dev, c]))
                    lens_all[dev, c] += 1
                    g_take.append(i)
                elif fill < spill_rows:
                    s_dev.append(dev)
                    s_pos.append(fill)
                    fill += 1
                    s_take.append(i)
                else:
                    return False

        # ---- commit: host maps, then in-place writes to every replica
        # (rows and norms before validity, so a racing probe sees a
        # half-written row only as masked)
        if self.pq:
            # residual encode against each row's cell in its own shard's
            # table (the per-row centroid form)
            crows = self.centroids[dev_of, assign_global]
            payload, sq = pqk.encode_pq_residual_chunked(
                vecs, None, crows, self._first().pq_codebooks,
                rotation=self._first().pq_rotation)
        else:
            payload = vecs
            sq = np.einsum("nd,nd->n", vecs, vecs).astype(np.float32)
        qscales = None
        if self.quantized:
            payload, qscales = quantize_rows_np(vecs)
        self.version += 1
        self.cell_lens = lens_all.astype(np.int32)
        self._inv_g = self._inv_s = None  # the inverse maps grew
        for devs_, poss, take, ids, region in (
                (g_dev, g_pos, g_take, self.row_ids, "grouped"),
                (s_dev, s_pos, s_take, self.spill_row_ids, "spill")):
            if not take:
                continue
            devs_a = np.asarray(devs_, np.int64)
            pos_a = np.asarray(poss, np.int64)
            take_a = np.asarray(take, np.int64)
            ids[devs_a, pos_a] = phys[take_a]
            if region == "spill" and self.pq:
                self.spill_cells[devs_a, pos_a] = assign_global[take_a]
            for dev in np.unique(devs_a).tolist():
                here = devs_a == dev
                t, p = take_a[here], pos_a[here]
                for rep in self._replicas(dev):
                    self._write(rep, region, p, payload[t], sq[t],
                                None if qscales is None else qscales[t],
                                assign_global[t])
        return True

    def _write(self, rep: IVFIndex, region: str, pos: np.ndarray, payload,
               sq, scales, cells):
        """One replica's in-place write of appended rows at `pos` of its
        grouped or spill region."""
        dev = rep.device
        pt = torch.from_numpy(pos).to(dev)
        vec = getattr(rep, region)
        vec.index_copy_(0, pt, torch.from_numpy(
            np.ascontiguousarray(payload)).to(dev).to(vec.dtype))
        if scales is not None:
            scale_arr = (rep.cell_scales if region == "grouped"
                         else rep.spill_scales)
            scale_arr.index_copy_(0, pt, torch.from_numpy(scales).to(dev))
        getattr(rep, f"{region}_sq").index_copy_(
            0, pt, torch.from_numpy(sq).to(dev))
        if self.pq and region == "spill":
            # the cell a spill row's residual was coded against
            rep.spill_cells.index_copy_(
                0, pt, torch.from_numpy(cells.astype(np.int32)).to(dev))
        getattr(rep, f"{region}_valid").index_fill_(0, pt, True)

    def masked_valid(self, cand_phys: np.ndarray):
        """Per-slot validity restricted to `cand_phys` physical rows (the
        mesh half of the IVF filter pushdown; see IVFIndex.masked_valid):
        a list over the mesh's slots of (grouped_valid, spill_valid)."""
        g_hits, s_hits = lookup_inverse(
            *self._inverse_maps(), np.asarray(cand_phys, np.int64))
        g_by = self._split_hits(g_hits, self.row_ids.shape[1])
        s_by = self._split_hits(s_hits, self.spill_row_ids.shape[1])
        out = [None] * len(self.slots)
        for dev in range(self.row_ids.shape[0]):
            for s in self._grid[:, dev].tolist():
                rep = self.slots[s]
                if rep is None:
                    continue  # another process's slot
                masks = []
                for valid, pos in ((rep.grouped_valid, g_by.get(dev)),
                                   (rep.spill_valid, s_by.get(dev))):
                    m = torch.zeros_like(valid)
                    if pos is not None:
                        m[torch.from_numpy(pos).to(m.device)] = True
                    masks.append(valid & m)
                out[s] = tuple(masks)
        return out

    # ----------------------------------------------------------------- search

    def search(self, queries: np.ndarray, k: int,
               nprobe: Optional[int] = None,
               valid_override=None) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (dists, physical rows) as numpy, ascending squared L2;
        -1 rows for empty slots. valid_override: masked_valid()'s list.
        Every slot probes before the one host copy of the merged result."""
        nprobe = min(nprobe or self.nprobe, self.centroids.shape[1])
        local_rows = self.row_ids.shape[1]
        stride = local_rows + self.spill_row_ids.shape[1]
        q, qn = pad_to_groups(np.asarray(queries, np.float32),
                              len(self._grid))

        def search_slot(s, q_s, kk):
            return self.slots[s].probe(
                q_s, kk, nprobe,
                None if valid_override is None else valid_override[s])

        dist, gids = replicated_topk(self.mesh, self.axis,
                                     torch.from_numpy(q), stride, k,
                                     search_slot)
        dist, gids = dist[:qn], gids[:qn]  # the pad never reaches the host
        gids = gids.cpu().numpy()
        dist = dist.cpu().numpy()
        rows = np.full(gids.shape, -1, dtype=np.int64)
        ok = gids >= 0
        dev = np.where(ok, gids // stride, 0)
        loc = np.where(ok, gids % stride, 0)
        in_spill = ok & (loc >= local_rows)
        in_main = ok & ~in_spill
        rows[in_main] = self.row_ids[dev[in_main], loc[in_main]]
        rows[in_spill] = self.spill_row_ids[dev[in_spill],
                                            loc[in_spill] - local_rows]
        return dist, rows
