"""The database engine: the port of tpuvdb.engine.engine.

put / get / delete / search orchestration over host state (WAL, doc store,
shard mirrors) and one device index, torch tensors on `device` (None =
"cuda"): `DeviceExactIndex` (index_type="flat") or `IVFIndex`
(index_type="ivf"), with f32, bf16 or int8 rows (storage_dtype) or, for
IVF, PQ code cells (ivf_pq_subq > 0, IVF-PQ):

  * keys route to shards by MD5 (utils/sharding_utils.py);
  * an overwrite writes a fresh slot and soft-deletes the old one;
  * every mutation goes to the WAL, checkpoints follow a put cadence;
  * `get` reads the doc store and the host mirror, never the device;
  * mutations stage in the mirrors and scatter to the device in batches;
    staged and mid-scatter rows are served by a host delta scan, so a
    search never waits for small write sets;
  * search = device scan (+ host delta scan), key resolution, ascending
    sort; filters and thresholds are honoured.

The on-disk state (WAL segments, checkpoints) is the reference's, so a
`data_dir` written by either package opens in the other.

IVF keeps, as the reference does, a standing delta of flushed inserts
that are scanned exactly on the host until `ivf_delta_max` of them drain
into the clustered index (`IVFIndex.append_rows`, or a rebuild when the
cells and spill are full). A restart rebuilds by assignment against the
checkpointed centroids (`ivf_warm.npz`) unless the corpus drifted.

int8 storage is lossy, so its searches overfetch `rescore_overfetch * k`
candidates and re-rank them (`rescore_mode`): "exact" on the host from the
mirrors' rows, outside the engine lock; "device" inside the flat index's
scan (dequantized rows; IVF has no such scan and takes the host re-rank);
"none" serves the int8 scores as they are.

IVF-PQ ranks reconstructions, so it joins the rescore path with a deeper
window (`ivf_pq_rescore_overfetch * k`). With `ivf_pq_adaptive_rescore`
and a calibrated index (`IVFIndex.pq_err > 0`) the re-rank is error
bounded (`_rescore_adaptive`): it rescores the head of the ADC-ordered
candidates and then only those whose lower bound undercuts the running kth
exact distance. Its warm state adds the trained codebooks, the OPQ rotation
and the calibration; with `ivf_checkpoint_packed` a checkpoint also holds
the packed device index (`ivf_packed.npz`), and a restart uploads it and
appends only the WAL tail (`_restore_ivf_packed`) instead of encoding every
row again.

Host runtime (tpuvdb_torch/native, the reference's C++ library built with
g++ at first use). The default configuration runs the reference's default
host path: the native doc store (`docstore_backend="auto"`: native when
the library builds) with key resolution in one FFI crossing, the native
group-commit WAL writer, and the fused native exact rescore
(`ShardMirror.rescore_into`) on the lossy tiers; the numpy rescore forms
serve only an engine whose library did not build. `mirror_backend="mmap"`,
or `"auto"` with a `data_dir`, keeps the mirrors in mmap'd files under
`data_dir/mirrors`: checkpoints hardlink them, a restore adopts the
checkpoint's links, and compaction unlinks the files it swapped out.
`info()` names what each part took.

With `search_coalesce`, concurrent `search_batch` calls group-commit
(engine/coalesce.py): batches that arrive while a search is in flight
share the next one, stacked at their own row count (the reference pads a
stack to a power of two to bound XLA compiles; the port has none).

With a mesh (`mesh/`: slots of devices, a device may repeat), the flat
index splits its rows over the mesh's shard axis (`DBConfig.mesh_axis`)
and a 2-D (repl, shards) mesh adds replica groups that split each batch;
int8's "device" rescore runs inside each slot before the merge. IVF builds
a `ShardedIVFIndex` (per-shard cells, `ivf_nlist // shards` each) on a 1-D
or 2-D mesh, and its warm state is the (shards, nlist, d) centroid table;
the packed IVF-PQ checkpoint is single-device only, as in the reference.
The mesh's slots must be of the engine's device type.

Snapshot rule. The reference's scatters donate the buffers a concurrent
search holds, and that search retries on the "donated" error. The port's
scatters write in place and raise nothing, so a search instead:
  1. records `DeviceExactIndex.version` with its snapshot and retries if a
     scatter bumped it while the scan ran;
  2. drops any host-delta row whose row id the device scan also returned
     (a scatter enqueued just before the snapshot is already on the device
     while its batch is still in `_inflight`).
Together these keep a row from coming back twice. IVF follows the same
rule with `IVFIndex.version` (bumped by appends and deletes, which write in
place); an append also bumps the engine generation, as in the reference.
A search whose lock-free attempts all retried runs under `_flush_lock`,
which every in-place writer holds: the flat scatter, the IVF flush and
the compaction swap.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tpuvdb_torch import native
from tpuvdb_torch.core import errors
from tpuvdb_torch.core.config import DBConfig
from tpuvdb_torch.core.types import (
    Response,
    SearchHit,
    SearchRequest,
    SearchResult,
    VectorData,
)
from tpuvdb_torch.device import resolve_device
from tpuvdb_torch.index.exact import DeviceExactIndex
from tpuvdb_torch.index.ivf import IVFIndex, MirrorRowSource
from tpuvdb_torch.index.layout import ShardMirror, StackedLayout
from tpuvdb_torch.index.probe_graphs import STATS as GRAPH_STATS
from tpuvdb_torch.mesh.sharded_ivf import ShardedIVFIndex
from tpuvdb_torch.store.checkpoint import CheckpointManager
from tpuvdb_torch.store.kv import DocEntry, DocStore
from tpuvdb_torch.store.wal import WriteAheadLog
from tpuvdb_torch.utils.hostmem import memlog, trim_heap
from tpuvdb_torch.utils.logging import get_logger
from tpuvdb_torch.utils.sharding_utils import get_shard_id
from tpuvdb_torch.utils.tracing import StageTimer, span

logger = get_logger("tpuvdb_torch.engine")


def _sorted_top(d: np.ndarray, rows: np.ndarray, top: Optional[int]):
    """Ascending (d, rows), truncated to `top` columns when that is
    narrower than the input: callers consume only the caller-visible top,
    so partition first and sort just that slice."""
    if top is not None and top < d.shape[1]:
        part = np.argpartition(d, top - 1, axis=1)[:, :top]
        d = np.take_along_axis(d, part, 1)
        rows = np.take_along_axis(rows, part, 1)
    order = np.argsort(d, axis=1, kind="stable")
    return (np.take_along_axis(d, order, 1),
            np.take_along_axis(rows, order, 1))


def _check_mesh(mesh, device: torch.device) -> None:
    """A mesh's slots run on the engine's device type: no slot moves to
    the CPU under a CUDA engine, nor to a card under a CPU one."""
    if mesh is None:
        return
    for s in mesh.local_slots():
        dev = mesh.flat_devices()[s]
        if dev.type != device.type:
            raise ValueError(f"mesh slot {s} is on {dev}, the engine on "
                             f"{device.type}")


# why a lock-free search attempt was thrown away and run again (the stat
# search_retries_<cause>): no index at the second look ("no_index", a flush
# raced with a compaction); an in-place write to the index during the
# device call ("version"); an IVF append or a compaction before the
# rescore or the key resolution ("generation"); a compaction before a
# rescored search's key resolution ("slot_generation"); a search that still
# had to flush after the flush it asked for ("flush")
RETRY_CAUSES = ("no_index", "version", "generation", "slot_generation",
                "flush")


class VectorDBEngine:
    def __init__(
        self,
        config: Optional[DBConfig] = None,
        data_dir: Optional[str] = None,
        mesh=None,
        device=None,
    ):
        self.config = config or DBConfig()
        if data_dir is None:
            data_dir = self.config.data_dir  # None = in-memory
        self.device = resolve_device(device)
        _check_mesh(mesh, self.device)
        self.mesh = mesh
        self.data_dir = data_dir
        self._lock = threading.RLock()

        cfg = self.config
        self.docstore = DocStore(backend=cfg.docstore_backend)
        # the fused exact rescore: native when the library builds (the
        # reference's rule; an explicit native doc store has built it)
        self.rescore_backend = ("native" if native.rescore_available()
                                else "numpy")
        # mmap mirrors keep their vector files under data_dir/mirrors;
        # "auto" turns them on exactly when the engine is durable anyway
        mmap_on = (cfg.mirror_backend == "mmap"
                   or (cfg.mirror_backend == "auto" and data_dir is not None))
        if mmap_on and data_dir is None:
            raise ValueError("mirror_backend='mmap' requires a data_dir")
        self._mirror_dir = (os.path.join(data_dir, "mirrors")
                            if mmap_on else None)
        self.mirrors: List[ShardMirror] = [
            self._new_mirror(i) for i in range(cfg.shard_count)
        ]
        self.wal: Optional[WriteAheadLog] = None
        self.ckpts: Optional[CheckpointManager] = None
        self._index: Optional[DeviceExactIndex] = None
        # IVF state (index_type="ivf"): the clustered index + a delta of
        # fresh inserts scanned exactly on the host until they drain
        self._ivf: Optional[IVFIndex] = None
        self._ivf_layout: Optional[StackedLayout] = None
        self._ivf_delta: Dict[Tuple[int, int], np.ndarray] = {}
        # checkpoint warm state: (centroids, trained_live, mut_at_train)
        # to save, and the loaded one a restart consumes once
        self._ivf_train_state = None
        self._ivf_warm = None
        # IVF-PQ warm state: trained codebooks, OPQ rotation and rescore
        # calibration, to save (*_state) and to consume once (*_warm)
        self._ivf_pq_state = self._ivf_pq_warm = None
        self._ivf_opq_state = self._ivf_opq_warm = None
        self._ivf_pq_err = self._ivf_pq_err_warm = 0.0
        # packed-checkpoint bookkeeping: the epoch is bumped by every
        # mutation of the device index; saved_epoch is the epoch the
        # ivf_packed.npz at _ivf_packed_path was captured at. While they are
        # equal that file is current, and a checkpoint hard-links it instead
        # of fetching the code table again. An epoch, not a flag: a flush
        # racing the off-lock fetch can never be marked clean, because the
        # saved epoch it is compared with predates the bump.
        self._ivf_packed = None  # loaded packed state, consumed once
        self._ivf_packed_epoch = 0
        self._ivf_packed_saved_epoch = -1
        self._ivf_packed_path: Optional[str] = None

        # staged (shard, slot) writes/deletes not yet scattered to device
        self._staged_updates: List[Tuple[int, int]] = []
        self._staged_deletes: List[Tuple[int, int]] = []
        # batches mid-scatter: still served by the host delta scan until the
        # device write lands (read-your-writes across the async flush)
        self._inflight: Dict[int, Tuple[list, list]] = {}
        self._inflight_token = 0
        self._flush_lock = threading.Lock()  # serializes device scatters
        self._ckpt_lock = threading.Lock()   # serializes checkpoint writes
        # ops arriving while an online compaction rebuilds (replayed onto
        # the new state at swap time); None = no compaction running
        self._compact_journal: Optional[list] = None
        self._bg_flush_thread: Optional[threading.Thread] = None

        self.timers = StageTimer()
        # group commit for concurrent searches (engine/coalesce.py)
        self._search_coalescer = None
        if cfg.search_coalesce:
            from tpuvdb_torch.engine.coalesce import SearchCoalescer

            self._search_coalescer = SearchCoalescer(
                self._search_batch_direct,
                max_rows=cfg.search_coalesce_max,
                inflight=cfg.search_coalesce_inflight)
        # two epochs, as in the reference:
        #  _generation      device-result epoch: bumped by compaction and by
        #                   an IVF append (a search that snapshotted the
        #                   delta before it could score a row twice)
        #  _slot_generation slot identity: bumped by compaction only, which
        #                   reuses slots; all a rescored search re-checks
        self._generation = 0
        self._slot_generation = 0
        self._puts_since_ckpt = 0
        self._puts_since_compact = 0
        # accepted mutations (puts + deletes), saved with the IVF warm
        # state so a restart sees churn since k-means training
        self._mut_count = 0
        # high-water LSN of an existing WAL dir when the WAL is disabled
        # (checkpoints record it so a re-enabled WAL never replays a
        # stale tail over newer state)
        self._wal_floor = 0
        self.stats: Dict[str, int] = {
            "puts": 0, "gets": 0, "deletes": 0, "searches": 0,
            "flushes": 0, "compactions": 0, "checkpoints": 0,
            "wal_replayed": 0, "search_retries": 0,
            # the retries by cause (RETRY_CAUSES), summing to search_retries
            **{f"search_retries_{c}": 0 for c in RETRY_CAUSES},
            # query rows searched; calls that took _assemble_results' slow
            # path (a dead, padded or staged-deleted candidate)
            "search_queries": 0, "search_slow_path": 0,
            # rows the searches scored on the host (staged, in flight and
            # IVF's standing delta), summed over every snapshot
            "search_delta_rows": 0,
            # the IVF flush: rows appended into the cells (of them, into the
            # spill reserve), rows invalidated in place, and the standing
            # delta's high-water mark
            "ivf_appends": 0, "ivf_spill_appends": 0,
            "ivf_invalidated_rows": 0, "ivf_delta_rows_max": 0,
            # adaptive exact rescore: candidates re-ranked / skipped
            "rescored_rows": 0, "rescore_skipped_rows": 0,
        }

        if data_dir is not None:
            os.makedirs(data_dir, exist_ok=True)
            self.ckpts = CheckpointManager(
                os.path.join(data_dir, "checkpoints"), cfg.max_checkpoints)
            self.wal = WriteAheadLog(
                os.path.join(data_dir, "wal"),
                max_bytes=cfg.wal_max_bytes,
                retention_days=cfg.wal_retention_days,
                fsync=cfg.wal_fsync,
            ) if cfg.wal_enabled else None
            if self.wal is None and os.path.isdir(
                    os.path.join(data_dir, "wal")):
                self._wal_floor = WriteAheadLog(
                    os.path.join(data_dir, "wal"), backend="python").last_seq
            self._recover()
            logger.info("engine opened: %d docs, data_dir=%s, dtype=%s, "
                        "device=%s", len(self.docstore), data_dir,
                        cfg.storage_dtype, self.device)

    def _new_mirror(self, shard: int) -> ShardMirror:
        cfg = self.config
        return ShardMirror(cfg.vector_dim, cfg.shard_capacity,
                           init_cap=cfg.mirror_init_cap, block=128,
                           dtype=cfg.mirror_dtype,
                           path=(os.path.join(self._mirror_dir,
                                              f"shard_{shard}")
                                 if self._mirror_dir else None))

    # --------------------------------------------------------------- recovery

    def _gc_mirror_files(self):
        """Unlink orphaned mirror generations (a crash between a compaction
        swap and its unlink, or a restore replacing the initial empty
        files). Checkpoint hardlinks live in the checkpoint directories and
        keep their inodes."""
        if self._mirror_dir is None or not os.path.isdir(self._mirror_dir):
            return
        live = {os.path.basename(p)
                for m in self.mirrors for p in m.file_paths.values()}
        for name in os.listdir(self._mirror_dir):
            if name not in live:
                os.unlink(os.path.join(self._mirror_dir, name))

    def _recover(self):
        """Checkpoint restore + WAL tail replay. The checkpoint records the
        last WAL LSN it covers; only newer records replay."""
        wal_pos = 0
        restored = self.ckpts.load_latest(self.config,
                                          mirror_factory=self._new_mirror)
        if restored is not None:
            initial = self.mirrors
            self.docstore, self.mirrors, wal_pos = restored
            for m in initial:  # replaced before first use: drop their files
                m.unlink_files()
            if len(self.mirrors) != self.config.shard_count:
                raise errors.CheckpointError(
                    f"checkpoint has {len(self.mirrors)} shards, "
                    f"config wants {self.config.shard_count}")
        self._gc_mirror_files()
        if self.config.index_type == "ivf":
            self._ivf_warm = self.ckpts.load_ivf_warm()
            if self._ivf_warm is not None:
                cents0, live0, mut0, mut_ckpt, cb, rot, err = self._ivf_warm
                # trained PQ codebooks ride along (an IVF-PQ restart skips
                # codebook training as it skips k-means), with the OPQ
                # rotation and the rescore calibration that pair with them
                self._ivf_pq_warm = self._ivf_pq_state = cb
                self._ivf_opq_warm = self._ivf_opq_state = rot
                self._ivf_pq_err_warm = self._ivf_pq_err = err
                # WAL tail replay re-increments on top of the checkpoint
                self._mut_count = mut_ckpt
                # carried forward now: a checkpoint taken before the first
                # rebuild must not drop the warm state
                self._ivf_train_state = (cents0, live0, mut0)
                # packed device state: the first rebuild uploads it and
                # appends the WAL tail instead of encoding every row
                if self.config.ivf_checkpoint_packed:
                    self._ivf_packed = self.ckpts.load_ivf_packed()
                    if self._ivf_packed is not None:
                        # a restore with nothing to reconcile marks this
                        # file current, so the next checkpoint links it
                        self._ivf_packed_path = os.path.join(
                            self.ckpts.latest(), "ivf_packed.npz")
        if self.wal is None and self._wal_floor > wal_pos:
            logger.warning(
                "WAL disabled but %d unapplied record(s) exist beyond the "
                "checkpoint (seq %d..%d); this run's state supersedes them "
                "and the next checkpoint makes that durable",
                self._wal_floor - wal_pos, wal_pos + 1, self._wal_floor)
        for rec in (self.wal.replay(after_seq=wal_pos)
                    if self.wal is not None else ()):
            op = rec.get("op")
            if op == "put":
                vd = VectorData(key=rec["key"], vector=rec["vector"],
                                metadata=rec.get("metadata", {}),
                                timestamp=rec.get("timestamp", 0))
                r = self.put(vd, replay_mode=True)
                if not r.success:
                    logger.warning("WAL replay dropped put %s: %s",
                                   rec["key"], r.message)
            elif op == "delete":
                self.delete(rec["key"], replay_mode=True)
            self.stats["wal_replayed"] += 1

    # ------------------------------------------------------------------- puts

    def put(self, data: VectorData, replay_mode: bool = False) -> Response:
        try:
            vec = data.vector_np(self.config.vector_dim)
        except ValueError as e:
            return Response.fail(str(e))
        do_compact = do_ckpt = False
        with self._lock:
            try:
                self._put_one(data.key, vec, data.metadata, data.timestamp,
                              replay_mode)
            except errors.CapacityExceeded as e:
                return Response.fail(f"capacity exceeded: {e}")
            if not replay_mode:
                do_compact, do_ckpt = self._maintenance_due()
        self._run_maintenance(do_compact, do_ckpt)
        logger.debug("put %s", data.key)
        return Response.ok(f"put {data.key}")

    def put_batch(self, batch: Sequence[VectorData],
                  replay_mode: bool = False) -> Response:
        """Group-commit ingest: one WAL write+fsync for the whole batch."""
        try:
            vecs = [d.vector_np(self.config.vector_dim) for d in batch]
        except ValueError as e:
            return Response.fail(str(e))
        return self.put_rows(
            [d.key for d in batch],
            np.stack(vecs) if vecs else np.zeros((0, self.config.vector_dim),
                                                 np.float32),
            metadatas=[d.metadata for d in batch],
            timestamps=[d.timestamp for d in batch],
            replay_mode=replay_mode,
        )

    def put_rows(
        self,
        keys: Sequence[str],
        vectors: np.ndarray,
        metadatas: Optional[Sequence[Dict[str, str]]] = None,
        timestamps: Optional[Sequence[int]] = None,
        replay_mode: bool = False,
    ) -> Response:
        """Columnar bulk ingest: rows group by shard, slots allocate in one
        consecutive reservation per shard, the mirror write runs vectorized
        per shard, and the whole call is one WAL group commit. The batch is
        all-or-nothing on capacity. Timed as the `put_rows` stage, with
        `put_rows.route` (the MD5 routing) and `put_rows.write` (mirrors
        and doc store) inside it."""
        with self.timers.stage("put_rows"):
            return self._put_rows(keys, vectors, metadatas, timestamps,
                                  replay_mode)

    def _put_rows(self, keys, vectors, metadatas, timestamps, replay_mode):
        vecs = np.asarray(vectors, np.float32)
        if vecs.ndim != 2 or vecs.shape[1] != self.config.vector_dim:
            return Response.fail(
                f"expected (n, {self.config.vector_dim}) vectors, "
                f"got {vecs.shape}")
        n = vecs.shape[0]
        if len(keys) != n:
            return Response.fail(f"{len(keys)} keys for {n} vectors")
        empty_md: Dict[str, str] = {}
        with self._lock:
            with self.timers.stage("put_rows.route"):
                shard_ids = np.fromiter(
                    (get_shard_id(k, self.config.shard_count) for k in keys),
                    np.int32, n)
            counts = np.bincount(shard_ids,
                                 minlength=self.config.shard_count)
            for s in range(self.config.shard_count):
                c = int(counts[s])
                m = self.mirrors[s]
                if c and m.used() + c > m.capacity:
                    return Response.fail(
                        f"capacity exceeded: shard {s} needs {c} slots, "
                        f"{m.capacity - m.used()} free (no records applied)")
            applied = 0
            wal_records = []
            journal = self._compact_journal
            # columnar fast path on the native doc store: metadata-free,
            # timestamp-free, nothing to journal or log, one FFI crossing
            # a shard (durable and metadata ingest take the loop below)
            fast = (metadatas is None and timestamps is None
                    and journal is None
                    and (replay_mode or self.wal is None))
            with self.timers.stage("put_rows.write"):
                for s in range(self.config.shard_count):
                    idx = np.flatnonzero(shard_ids == s)
                    if not len(idx):
                        continue
                    mirror = self.mirrors[s]
                    first = mirror.alloc(len(idx))
                    mirror.write_batch(first, vecs[idx])
                    idx_list = idx.tolist()
                    res = (self.docstore.put_rows_bulk(
                        [keys[i] for i in idx_list], s, first)
                        if fast else None)
                    if res is not None:
                        prev_sh, prev_sl = res
                        self._staged_updates.extend(
                            (s, first + j) for j in range(len(idx_list)))
                        for t in np.flatnonzero(prev_sh >= 0).tolist():
                            p = (int(prev_sh[t]), int(prev_sl[t]))
                            self.mirrors[p[0]].mark_deleted(p[1])
                            self._staged_deletes.append(p)
                        applied += len(idx)
                        continue
                    entries = []
                    for j, i in enumerate(idx_list):
                        md = (metadatas[i] if metadatas is not None
                              else empty_md)
                        entries.append(DocEntry(
                            key=keys[i], shard=s, slot=first + j,
                            metadata=dict(md),
                            timestamp=(timestamps[i]
                                       if timestamps is not None else 0)))
                    prevs = self.docstore.put_many(entries)
                    self._staged_updates.extend(
                        (s, first + j) for j in range(len(idx_list)))
                    for j, (i, prev) in enumerate(zip(idx_list, prevs)):
                        if prev is not None:
                            # overwrite = fresh slot + soft-delete the old one
                            self.mirrors[prev[0]].mark_deleted(prev[1])
                            self._staged_deletes.append(prev)
                        e = entries[j]
                        if journal is not None:
                            journal.append(("put", e.key, vecs[i].copy(),
                                            dict(e.metadata), e.timestamp))
                        if not replay_mode and self.wal is not None:
                            wal_records.append({
                                "op": "put", "key": e.key, "vector": vecs[i],
                                "metadata": dict(e.metadata),
                                "timestamp": e.timestamp,
                            })
                    applied += len(idx)
            if self.wal is not None and wal_records:
                self.wal.append_batch(wal_records)
            self.stats["puts"] += applied
            self._mut_count += applied
            self._puts_since_ckpt += applied
            self._puts_since_compact += applied
            do_compact, do_ckpt = (self._maintenance_due() if not replay_mode
                                   else (False, False))
        self._run_maintenance(do_compact, do_ckpt)
        return Response.ok(f"put {n} records")

    def _put_one(self, key, vec, metadata, timestamp, replay_mode):
        shard = get_shard_id(key, self.config.shard_count)
        mirror = self.mirrors[shard]
        prev = self.docstore.get(key)
        # allocate the new slot BEFORE touching the old one: if alloc raises
        # CapacityExceeded on an overwrite, the existing record stays intact
        slot = mirror.alloc()
        mirror.write(slot, vec)
        if prev is not None:
            self.mirrors[prev.shard].mark_deleted(prev.slot)
            self._staged_deletes.append((prev.shard, prev.slot))
        if self.wal is not None and not replay_mode:
            self.wal.append("put", key, vector=vec, metadata=metadata,
                            timestamp=timestamp)
        self.docstore.put(DocEntry(key=key, shard=shard, slot=slot,
                                   metadata=dict(metadata),
                                   timestamp=timestamp))
        self._staged_updates.append((shard, slot))
        if self._compact_journal is not None:
            self._compact_journal.append(
                ("put", key, vec.copy(), dict(metadata), timestamp))
        self.stats["puts"] += 1
        self._mut_count += 1
        self._puts_since_ckpt += 1
        self._puts_since_compact += 1

    def _maintenance_due(self):
        """Check cadences under the lock; the work runs with the lock
        released (compact's swap takes _flush_lock before the engine lock)."""
        cfg = self.config
        do_compact = self._puts_since_compact >= cfg.compact_every_puts
        do_ckpt = (self.ckpts is not None
                   and self._puts_since_ckpt >= cfg.checkpoint_every_puts)
        return do_compact, do_ckpt

    def _run_maintenance(self, do_compact: bool, do_ckpt: bool):
        if do_compact:
            self.compact()
        if do_ckpt:
            self.save_checkpoint()

    # ---------------------------------------------------------------- get/del

    def get(self, key: str) -> Response:
        with self._lock:
            self.stats["gets"] += 1
            e = self.docstore.get(key)
            if e is None:
                return Response.fail(f"{errors.NOT_FOUND_PREFIX}: {key}")
            vec = self.mirrors[e.shard].vector_at(e.slot)
            return Response.ok(
                "ok",
                vector_data=VectorData(
                    key=key, vector=[float(x) for x in vec],
                    metadata=dict(e.metadata), timestamp=e.timestamp,
                ),
            )

    def delete(self, key: str, replay_mode: bool = False) -> Response:
        with self._lock:
            e = self.docstore.delete(key)
            if e is None:
                return Response.fail(f"{errors.NOT_FOUND_PREFIX}: {key}")
            self.mirrors[e.shard].mark_deleted(e.slot)
            self._staged_deletes.append((e.shard, e.slot))
            if self._compact_journal is not None:
                self._compact_journal.append(("delete", key, None, None, 0))
            if self.wal is not None and not replay_mode:
                self.wal.append("delete", key)
            self.stats["deletes"] += 1
            self._mut_count += 1
            logger.debug("delete %s", key)
            return Response.ok(f"deleted {key}")

    # ------------------------------------------------------------------ flush

    def flush(self):
        """Apply staged mirror writes/deletes to the device index."""
        if self.config.index_type == "ivf":
            # the flush lock first, as the flat scatter takes it: IVF writes
            # the index in place, and a search's serialized attempts
            # (_search_batch_direct) hold this lock so that no flush lands
            # inside their probe
            with self._flush_lock, self._lock, self.timers.stage("flush.ivf"):
                self._flush_ivf()
            return
        self._flush_flat()

    def _flush_flat(self):
        """The device scatter runs OUTSIDE the engine lock (serialized by
        _flush_lock) so puts/searches proceed during it; the batch being
        scattered stays visible to the host delta scan via _inflight until
        the scatter lands."""
        with self._lock:
            if self._index is None or self._index.needs_rebuild(self.mirrors):
                self._rebuild_device_index()
                return
            if not (self._staged_updates or self._staged_deletes):
                return
            ups = self._staged_updates
            dels = self._staged_deletes
            self._staged_updates = []
            self._staged_deletes = []
            self._inflight_token += 1
            token = self._inflight_token
            self._inflight[token] = (ups, dels)
            layout = self._index.layout
            index = self._index
            if ups:
                ups_arr = np.asarray(ups, np.int64)
                rows = ups_arr[:, 0] * layout.phys_cap + ups_arr[:, 1]
                vecs = np.empty((len(ups), layout.dim), np.float32)
                valid = np.empty(len(ups), bool)
                for s in np.unique(ups_arr[:, 0]).tolist():
                    m = ups_arr[:, 0] == s
                    slots = ups_arr[m, 1]
                    vecs[m] = self.mirrors[s].rows_f32(slots)
                    valid[m] = self.mirrors[s].valid[slots]
            if dels:
                dels_arr = np.asarray(dels, np.int64)
                del_rows = dels_arr[:, 0] * layout.phys_cap + dels_arr[:, 1]
        try:
            with self._flush_lock:
                if ups:
                    index.apply_updates(rows, vecs, valid)
                if dels:
                    index.apply_deletes(del_rows)
        finally:
            with self._lock:
                self._inflight.pop(token, None)
                self.stats["flushes"] += 1

    def _rebuild_device_index(self):
        # "device" rescore lives inside the index's search (a fused
        # dequantized re-rank; on a mesh each slot rescores its own
        # candidates before the merge); "exact" is applied by the search
        # path on the host instead
        device_rescore = (self.config.rescore_mode == "device"
                          and self.config.rescore_overfetch > 0)
        with self.timers.stage("index.build"):
            self._index = DeviceExactIndex.build(
                self.mirrors,
                dtype=self.config.torch_dtype(),
                block_size=self.config.block_size,
                search_mode=self.config.search_mode,
                recall_target=self.config.recall_target,
                rescore_fetch=(self.config.rescore_overfetch * 2
                               if device_rescore else 0),
                device=self.device,
                mesh=self.mesh,
                mesh_axis=self.config.mesh_axis,
            )
        self._staged_updates.clear()
        self._staged_deletes.clear()
        self.stats["flushes"] += 1

    def _consume_ivf_warm(self, live, ndim: int = 2,
                          lead: Optional[int] = None):
        """(warm_cents | None, trained_live, mut_at_train) for a rebuild.
        The checkpoint's warm state is consumed once, and accepted only
        when its geometry matches what the build takes (`ndim` 2: one
        (nlist, d) table; 3: a mesh's (lead = shards, nlist, d) tables),
        the live rows are within 2x of the training-time count, and the
        mutations since training stay under the training corpus size
        (delete N + insert N churn never moves the live ratio, so the
        count alone cannot see it)."""
        warm = self._ivf_warm
        self._ivf_warm = None
        if warm is None:
            return None, live, self._mut_count
        cents0, live0, mut0 = np.asarray(warm[0]), warm[1], warm[2]
        geom_ok = (cents0.ndim == ndim
                   and cents0.shape[-1] == self.config.vector_dim
                   and (lead is None or cents0.shape[0] == lead))
        ratio_ok = live0 > 0 and 0.5 <= live / live0 <= 2.0
        churn_ok = (self._mut_count - mut0) <= max(live0, 1)
        if geom_ok and ratio_ok and churn_ok:
            return cents0, live0, mut0
        return None, live, self._mut_count

    def _ivf_mesh_axes(self):
        """(on the mesh?, replica axis | None) for an IVF rebuild: a 1-D
        (shards,) or a 2-D (repl, shards) mesh; any other shape raises
        rather than clustering on one device."""
        mesh, axis = self.mesh, self.config.mesh_axis
        if mesh is None or mesh.size == 1:
            return False, None
        axes = mesh.axis_names
        if axis not in axes or len(axes) > 2:
            raise ValueError(f"IVF needs a 1-D ({axis},) or 2-D "
                             f"(repl, {axis}) mesh; got axes {axes}")
        return True, next((a for a in axes if a != axis), None)

    def _build_ivf_mesh(self, source, valid, live: int, ndev: int,
                        repl_axis):
        """The mesh branch of an IVF rebuild: per-shard cells over the
        stacked f32 rows, `ivf_nlist // ndev` cells a shard, warm from a
        checkpoint's (ndev, nlist, d) centroid table within the drift and
        churn bounds (a table of another shard count retrains)."""
        cfg = self.config
        nlist = max(1, min(cfg.ivf_nlist // ndev or 1,
                           max(1, live // (8 * ndev))))
        warm_cents, trained_live, mut_train = self._consume_ivf_warm(
            live, ndim=3, lead=ndev)
        nprobe = (cfg.ivf_nprobe if warm_cents is not None
                  else min(cfg.ivf_nprobe, nlist))
        warm_cb, self._ivf_pq_warm = self._ivf_pq_warm, None
        warm_rot, self._ivf_opq_warm = self._ivf_opq_warm, None
        self._ivf_pq_err_warm = 0.0  # the mesh index calibrates none
        self._ivf = ShardedIVFIndex.build(
            source.stack_f32(), valid, self.mesh, axis=cfg.mesh_axis,
            nlist=nlist, nprobe=nprobe, kmeans_iters=cfg.ivf_kmeans_iters,
            dtype=cfg.torch_dtype(), recall_target=cfg.recall_target,
            centroids=warm_cents, repl_axis=repl_axis,
            pq_subq=cfg.ivf_pq_subq, pq_codebooks=warm_cb, opq=cfg.ivf_opq,
            pq_rotation=warm_rot, pq_bits=cfg.ivf_pq_bits)
        self._ivf.warm_append()
        self._ivf_train_state = (self._ivf.centroids_np(), trained_live,
                                 mut_train)
        self._ivf_pq_state = self._ivf.pq_codebooks_np()
        self._ivf_opq_state = self._ivf.pq_rotation_np()
        self._ivf_pq_err = self._ivf.pq_err

    def _restore_ivf_packed(self, packed, source, valid, layout):
        """IVFIndex from the checkpoint's packed device state, reconciled
        with the WAL tail replayed after that checkpoint: rows now live in
        the mirrors but absent from the packed index are appended
        (assignment and encode over that delta only), rows in the index but
        no longer live are invalidated. Returns None, and the caller builds
        in full, on any mismatch: a changed configuration, grown mirrors
        (physical rows renumber under a larger phys_cap) or no room left
        for the appends."""
        cfg = self.config
        try:
            if (int(packed["dim"]) != cfg.vector_dim
                    or int(packed["phys_cap"]) != layout.phys_cap
                    or int(packed["pq_subq"]) != cfg.ivf_pq_subq
                    or int(packed["pq_bits"]) != cfg.ivf_pq_bits
                    # the OPQ toggle changes the code geometry (the codes
                    # were trained in the rotated space): restoring them
                    # without, or with, the rotation would serve wrong
                    # distances
                    or ("pq_rotation" in packed) != bool(cfg.ivf_opq)):
                return None
            idx = IVFIndex.from_packed(packed, device=self.device)
            # serving knobs follow the current config, not the values the
            # checkpoint baked in
            idx.nprobe = min(cfg.ivf_nprobe, idx.nlist)
            rows = idx.live_phys_rows()
            rows = rows[rows < layout.total_rows]
            in_idx = np.zeros(layout.total_rows, bool)
            in_idx[rows] = True
            to_del = rows[~valid[rows]]
            to_add = np.flatnonzero(valid & ~in_idx)
            if len(to_del):
                idx.invalidate_rows(to_del.astype(np.int64))
            # waves bound the host f32 transient; a False return (cells
            # and spill full) rebuilds in full
            for lo in range(0, len(to_add), 65536):
                add = to_add[lo:lo + 65536]
                if not idx.append_rows(add.astype(np.int64),
                                       source.gather_f32(add)):
                    return None
            # nothing to reconcile: the restored image is the checkpoint's,
            # and the next checkpoint can link the existing file
            if not (len(to_add) or len(to_del)):
                self._ivf_packed_saved_epoch = self._ivf_packed_epoch
            self.stats["ivf_packed_restores"] = (
                self.stats.get("ivf_packed_restores", 0) + 1)
            logger.info("IVF restored from packed checkpoint state (+%d "
                        "appended, -%d invalidated, %d cells)",
                        len(to_add), len(to_del), idx.nlist)
            return idx
        except Exception:
            logger.exception("packed IVF restore failed; full rebuild")
            return None

    def _rebuild_ivf(self):
        """Called under the engine lock: the IVF index built anew over
        the mirrors (on a mesh, from a checkpoint's packed state, or
        from scratch); the staged writes and the delta it absorbs are
        cleared."""
        cfg = self.config
        use_mesh, repl_axis = self._ivf_mesh_axes()
        ndev = self.mesh.shape[cfg.mesh_axis] if use_mesh else 1
        layout = StackedLayout.for_mirrors(self.mirrors, block=128,
                                           min_rows_multiple=ndev)
        source = MirrorRowSource(self.mirrors, layout)
        valid = source.valid_array()
        live = int(valid.sum())
        # any rebuild makes the last saved packed image stale; the
        # packed restore below marks it current again when the restored
        # state is the checkpoint's own (nothing to reconcile)
        self._ivf_packed_epoch += 1
        # the checkpoint's packed state is consumed once, whatever the
        # rebuild does with it: it is the corpus's codes
        packed, self._ivf_packed = self._ivf_packed, None
        if live == 0:
            self._ivf = None
        elif use_mesh:
            self._build_ivf_mesh(source, valid, live, ndev, repl_axis)
        else:
            nlist = max(1, min(cfg.ivf_nlist, live // 8 or 1))
            # the first rebuild after recovery reuses the checkpointed
            # centroids (assignment only, no k-means training) within
            # the drift/churn bounds of _consume_ivf_warm
            warm_cents, trained_live, mut_train = \
                self._consume_ivf_warm(live)
            # the PQ warm start rides along with the centroids
            # (consumed once; stale shapes retrain inside build)
            warm_cb, self._ivf_pq_warm = self._ivf_pq_warm, None
            warm_rot, self._ivf_opq_warm = self._ivf_opq_warm, None
            warm_err, self._ivf_pq_err_warm = self._ivf_pq_err_warm, 0.0
            # packed restore: the drift/churn guard just accepted the
            # checkpoint's clustering (warm_cents is its centroids), and
            # the packed file is that clustering's whole device image
            restored = None
            if packed is not None and warm_cents is not None:
                restored = self._restore_ivf_packed(packed, source,
                                                    valid, layout)
            self._ivf = restored or IVFIndex.build_streaming(
                source, valid, nlist=nlist,
                # nprobe follows the actual cell count: warm centroids
                # override nlist inside build
                nprobe=min(cfg.ivf_nprobe,
                           len(warm_cents) if warm_cents is not None
                           else nlist),
                kmeans_iters=cfg.ivf_kmeans_iters,
                train_sample=cfg.ivf_train_sample,
                dtype=cfg.torch_dtype(),
                centroids=warm_cents,
                device=self.device,
                pq_subq=cfg.ivf_pq_subq,
                pq_codebooks=warm_cb,
                opq=cfg.ivf_opq,
                pq_rotation=warm_rot,
                pq_bits=cfg.ivf_pq_bits,
                pq_err=warm_err,
            )
            self._ivf_train_state = (self._ivf.centroids_np(),
                                     trained_live, mut_train)
            self._ivf_pq_state = self._ivf.pq_codebooks_np()
            self._ivf_opq_state = self._ivf.pq_rotation_np()
            self._ivf_pq_err = self._ivf.pq_err
        self._ivf_layout = layout
        self._ivf_delta.clear()
        self._staged_updates.clear()
        self._staged_deletes.clear()
        # phase boundary: hand the build's transient heap back to the
        # OS (keep_malloc_warm turns automatic trimming off)
        trim_heap()
        memlog("engine: ivf rebuild done (trimmed)")

    def _flush_ivf(self):
        """Called under the engine lock. Staged inserts join the standing
        host delta; past ivf_delta_max they drain into the clustered index
        by append (or a rebuild when it is full); staged deletes clear
        validity in place. A missing or outgrown index rebuilds."""
        cfg = self.config
        needs_rebuild = (
            self._ivf is None
            or self._ivf_layout is None
            or any(m.phys_cap > self._ivf_layout.phys_cap
                   for m in self.mirrors))
        overflow = (len(self._ivf_delta) + len(self._staged_updates)
                    > cfg.ivf_delta_max)
        if not needs_rebuild and overflow:
            for s, sl in self._staged_updates:
                if self.mirrors[s].is_valid(sl):
                    self._ivf_delta[(s, sl)] = (
                        self.mirrors[s].vector_at(sl).copy())
            self._staged_updates.clear()
            self._note_ivf_delta()
            # staged deletes drain first: a put-then-deleted slot must not
            # take one of the fixed cell/spill append slots; deletes of rows
            # already in the index are invalidated after the append so the
            # rebuilt inverse maps include new rows
            del_rows = []
            for s, sl in self._staged_deletes:
                self._ivf_delta.pop((s, sl), None)
                del_rows.append(self._ivf_layout.row_of(s, sl))
            self._staged_deletes.clear()
            pairs = [((s, sl), v) for (s, sl), v in self._ivf_delta.items()
                     if self.mirrors[s].is_valid(sl)]
            appended = True
            if pairs:
                rows = np.asarray([self._ivf_layout.row_of(s, sl)
                                   for (s, sl), _ in pairs], np.int64)
                spilled = self._ivf_spill_used()
                with self.timers.span("ivf.append"):
                    appended = self._ivf.append_rows(
                        rows, np.stack([v for _, v in pairs]))
                if appended:
                    self.stats["ivf_spill_appends"] += (
                        self._ivf_spill_used() - spilled)
            if appended:
                self._ivf_delta.clear()
                if del_rows:
                    self._ivf_invalidate(del_rows)
                if pairs or del_rows:
                    self._ivf_packed_epoch += 1
                self.stats["ivf_appends"] += len(pairs)
                # an off-lock search that snapshotted the delta before this
                # append could score a row twice (delta + appended copy):
                # the generation bump makes it retry
                self._generation += 1
            else:
                needs_rebuild = True
        if needs_rebuild:
            with self.timers.stage("index.build"):
                self._rebuild_ivf()
        else:
            for s, sl in self._staged_updates:
                if self.mirrors[s].is_valid(sl):
                    self._ivf_delta[(s, sl)] = (
                        self.mirrors[s].vector_at(sl).copy())
            self._staged_updates.clear()
            if self._staged_deletes:
                rows = []
                for s, sl in self._staged_deletes:
                    self._ivf_delta.pop((s, sl), None)
                    rows.append(self._ivf_layout.row_of(s, sl))
                self._ivf_invalidate(rows)
                self._ivf_packed_epoch += 1
                self._staged_deletes.clear()
            self._note_ivf_delta()
        self.stats["flushes"] += 1

    def _note_ivf_delta(self):
        """The standing delta's high-water mark (stat ivf_delta_rows_max),
        taken when the staged inserts have joined it."""
        self.stats["ivf_delta_rows_max"] = max(
            self.stats["ivf_delta_rows_max"], len(self._ivf_delta))

    def _ivf_invalidate(self, rows: list):
        """The flush's in-place deletes of IVF rows (span ivf.invalidate,
        stat ivf_invalidated_rows)."""
        with self.timers.span("ivf.invalidate"):
            self._ivf.invalidate_rows(np.asarray(rows, np.int64))
        self.stats["ivf_invalidated_rows"] += len(rows)

    def _ivf_spill_used(self) -> int:
        """The IVF index's spill slots that hold a row (live or deleted)."""
        return int((np.asarray(self._ivf.spill_row_ids) >= 0).sum())

    # ----------------------------------------------------------------- search

    def search(self, req: SearchRequest) -> Response:
        try:
            q = req.query_np(self.config.vector_dim)
        except ValueError as e:
            return Response.fail(str(e))
        k = req.top_k if req.top_k > 0 else self.config.default_top_k
        hits = self.search_hits(q, k, filter_metadata=req.filter_metadata,
                                threshold=req.threshold)
        return Response.ok(f"{len(hits)} results",
                           search_result=SearchResult.from_hits(hits))

    def search_hits(
        self,
        query: np.ndarray,
        k: int,
        filter_metadata: Optional[Dict[str, str]] = None,
        threshold: float = 0.0,
    ) -> List[SearchHit]:
        if filter_metadata:
            return self._filtered_search(query, k, filter_metadata, threshold)
        dists, keys_rows = self.search_batch(query.reshape(1, -1), k,
                                             overfetch=threshold > 0)
        hits: List[SearchHit] = []
        # lock: docstore entry and mirror vector must come from the same
        # generation (a compaction swap between the two reads would mismatch)
        with self._lock:
            for key, score in zip(keys_rows[0], dists[0]):
                if key is None:
                    continue
                if threshold > 0 and score > threshold:
                    continue
                e = self.docstore.get(key)
                if e is None:
                    continue
                vec = self.mirrors[e.shard].vector_at(e.slot)
                hits.append(SearchHit(key=key, score=float(score),
                                      vector=[float(x) for x in vec],
                                      metadata=dict(e.metadata)))
                if len(hits) >= k:
                    break
        return hits

    # filtered sets above this size score on the device (masked scan)
    # instead of on the host
    _FILTER_DEVICE_MIN = 8192

    def _filtered_search(
        self, query: np.ndarray, k: int,
        filter_metadata: Dict[str, str], threshold: float,
    ) -> List[SearchHit]:
        """Filter pushdown via the metadata inverted index: score only the
        slots that match ALL filter terms. Small candidate sets score on
        the host; large ones run a device scan with the filter folded into
        the validity mask."""
        with self._lock:
            cands = self.docstore.find_by_metadata(filter_metadata)
            if not cands:
                return []
            pairs = [(s, sl) for (s, sl) in cands
                     if self.mirrors[s].is_valid(sl)]
            if not pairs:
                return []
            ivf_mode = self.config.index_type == "ivf"
            use_device = len(pairs) >= self._FILTER_DEVICE_MIN
        if use_device:
            # flush OUTSIDE the lock (flush takes the flush lock; taking it
            # while holding the engine lock would invert the lock order)
            with self._lock:
                if ivf_mode:
                    stale = (self._ivf is None or self._staged_updates
                             or self._staged_deletes)
                else:
                    stale = (self._index is None
                             or self._index.needs_rebuild(self.mirrors)
                             or self._staged_updates or self._staged_deletes)
            if stale:
                self.flush()
            with self._lock:
                if ivf_mode:
                    return self._filtered_search_device_ivf(
                        query, k, pairs, threshold)
                return self._filtered_search_device(query, k, pairs, threshold)
        with self._lock:
            mat = np.stack([self.mirrors[s].vector_at(sl) for s, sl in pairs])
            q = query.reshape(-1).astype(np.float32)
            d2 = np.sum((mat - q[None, :]) ** 2, axis=1)
            order = np.argsort(d2, kind="stable")[: max(k, 0)]
            hits: List[SearchHit] = []
            for i in order:
                score = float(d2[i])
                if threshold > 0 and score > threshold:
                    continue
                s, sl = pairs[i]
                key = self.docstore.key_at(s, sl)
                if key is None:
                    continue
                e = self.docstore.get(key)
                hits.append(SearchHit(key=key, score=score,
                                      vector=[float(x) for x in mat[i]],
                                      metadata=dict(e.metadata) if e else {}))
                if len(hits) >= k:
                    break
            self.stats["searches"] += 1
            self.stats["search_queries"] += 1
            return hits

    def _filtered_search_device(self, query, k, pairs, threshold):
        """Called under the engine lock, post-flush. Masked device scan:
        the filter is a bool mask ANDed with the index's validity on the
        device."""
        index = self._index
        if index is None:
            return []
        layout = index.layout
        rows = np.asarray([layout.row_of(s, sl) for s, sl in pairs],
                          np.int64)
        # a quantized index runs its int8 scan without the fused re-rank
        # here, as the reference does
        dists, idx = index.search(query.reshape(1, -1), k,
                                  valid=index.masked_valid(rows),
                                  rescore=False)
        hits: List[SearchHit] = []
        for score, r in zip(dists[0], idx[0]):
            if r < 0 or (threshold > 0 and score > threshold):
                continue
            s, sl = layout.shard_slot_of(int(r))
            key = self.docstore.key_at(s, sl)
            if key is None:
                continue
            e = self.docstore.get(key)
            vec = self.mirrors[s].vector_at(sl)
            hits.append(SearchHit(key=key, score=float(score),
                                  vector=[float(x) for x in vec],
                                  metadata=dict(e.metadata) if e else {}))
        self.stats["searches"] += 1
        self.stats["search_queries"] += 1
        return hits

    def _filtered_search_device_ivf(self, query, k, pairs, threshold):
        """Called under the engine lock, post-flush: the candidate set
        folds into the IVF probe's validity operand
        (IVFIndex.masked_valid); candidates still in the unclustered delta
        score exactly on the host and merge. Probe coverage bounds recall,
        as for unfiltered IVF."""
        if self._ivf is None:
            return []
        layout = self._ivf_layout
        delta_pairs = [p for p in pairs if p in self._ivf_delta]
        in_delta = set(delta_pairs)
        main_rows = np.asarray(
            [layout.row_of(s, sl) for s, sl in pairs
             if (s, sl) not in in_delta], np.int64)
        q = np.asarray(query, np.float32).reshape(1, -1)
        cand: List[Tuple[float, Tuple[int, int]]] = []
        if main_rows.size:
            override = self._ivf.masked_valid(main_rows)
            dists, rows = self._ivf.search(q, k, valid_override=override)
            for score, r in zip(dists[0], rows[0]):
                if r >= 0 and np.isfinite(score):
                    cand.append((float(score), layout.shard_slot_of(int(r))))
        if delta_pairs:
            mat = np.stack([self._ivf_delta[p] for p in delta_pairs])
            d2 = np.sum((mat - q.reshape(-1)[None, :]) ** 2, axis=1)
            cand.extend((float(d2[i]), delta_pairs[i])
                        for i in range(len(delta_pairs)))
        cand.sort(key=lambda t: t[0])
        hits: List[SearchHit] = []
        for score, (s, sl) in cand:
            if threshold > 0 and score > threshold:
                continue
            key = self.docstore.key_at(s, sl)
            if key is None:
                continue
            e = self.docstore.get(key)
            vec = self.mirrors[s].vector_at(sl)
            hits.append(SearchHit(key=key, score=score,
                                  vector=[float(x) for x in vec],
                                  metadata=dict(e.metadata) if e else {}))
            if len(hits) >= k:
                break
        self.stats["searches"] += 1
        self.stats["search_queries"] += 1
        return hits

    def search_batch(
        self, queries: np.ndarray, k: int, overfetch: bool = False
    ) -> Tuple[np.ndarray, List[List[Optional[str]]]]:
        """Raw batched search: returns (dists (Q, fetch_k), keys
        list-of-lists). With overfetch=True, fetches extra candidates so
        post-filters (metadata/threshold) can refill. With search_coalesce,
        concurrent callers share one direct search (engine/coalesce.py).
        While a profiler runs, the call is one `search.call` span."""
        with self.timers.span("search.call", root=True):
            q = np.atleast_2d(np.asarray(queries, np.float32))
            if not q.flags.writeable:
                # a decoded binary frame (core/wire.py) is read-only, and
                # torch.from_numpy takes no read-only array
                q = q.copy()
            if self._search_coalescer is not None and q.shape[0] > 0:
                return self._search_coalescer.search(q, k, overfetch)
            return self._search_batch_direct(q, k, overfetch)

    def warm_search(self, k: int, batch: int, overfetch: bool = False,
                    max_stack: Optional[int] = None) -> List[int]:
        """Run one search of each batch size a serving workload will hit:
        the batch itself and, with search_coalesce, the power-of-two ladder
        of stacks above it up to min(search_coalesce_max, max_stack), the
        reference's ladder. The port compiles nothing per shape: this loads
        the kernel libraries and primes the caching allocator. Returns the
        sizes run."""
        dim = self.config.vector_dim
        sizes = [batch]
        if self._search_coalescer is not None:
            cap = self.config.search_coalesce_max
            if max_stack is not None:
                cap = min(cap, max_stack)
            s = 1 << batch.bit_length()   # next power of two above batch
            while s <= cap:
                sizes.append(s)
                s <<= 1
        for s in sizes:
            self._search_batch_direct(
                np.zeros((s, dim), np.float32), k, overfetch)
        return sizes

    def _search_batch_direct(
        self, queries: np.ndarray, k: int, overfetch: bool = False
    ) -> Tuple[np.ndarray, List[List[Optional[str]]]]:
        for attempt in range(4):
            if attempt >= 2:
                # bounded backoff: let the flush/compaction churn that
                # invalidated the previous snapshots settle
                time.sleep(0.002 * attempt)
            status, res = self._try_search_batch(queries, k, overfetch)
            if status == "flush":
                with self.timers.stage("search.flush"):
                    self.flush()
                status, res = self._try_search_batch(queries, k, overfetch)
            if status == "ok":
                return res
            with self._lock:
                self.stats["search_retries"] += 1
                self.stats[f"search_retries_{res or status}"] += 1
        # every lock-free snapshot got invalidated: serialize against the
        # invalidators (scatters, IVF flushes and compaction swaps all hold
        # _flush_lock)
        for _ in range(3):
            with self.timers.stage("search.flush"):
                self.flush()
            with self._flush_lock:
                status, res = self._try_search_batch(queries, k, overfetch)
                if status == "ok":
                    return res
        raise RuntimeError("search retry limit exceeded (compaction storm)")

    def _try_search_batch(self, queries, k, overfetch):
        """One lock-free search attempt. Returns (status, result):
        "ok" — result is (dists, keys); "flush" — caller must flush and
        retry (no index yet / layout outgrown / staging buffer large);
        "retry" — a scatter or a compaction overlapped the scan, and the
        result is its cause (RETRY_CAUSES)."""
        with self.timers.span("search.snapshot"):
            with self._lock:
                ivf_mode = self.config.index_type == "ivf"
                no_index = (self._ivf is None if ivf_mode
                            else self._index is None)
                if no_index and sum(m.live() for m in self.mirrors) == 0:
                    # an empty engine never builds an index: empty results
                    q = np.atleast_2d(np.asarray(queries))
                    fetch = max(2 * k, k + 16) if overfetch else k
                    empty_d = np.full((q.shape[0], fetch), np.inf,
                                      dtype=np.float32)
                    empty_k = [[None] * fetch for _ in range(q.shape[0])]
                    self.stats["searches"] += 1
                    self.stats["search_queries"] += q.shape[0]
                    return "ok", (empty_d, empty_k)
                # flush only when unavoidable; small staged write sets are
                # served by the host-side delta scan so ingest never stalls
                # queries
                must_flush = (
                    no_index
                    or (not ivf_mode
                        and self._index.needs_rebuild(self.mirrors))
                    or len(self._staged_updates) + len(self._staged_deletes)
                    > self.config.flush_batch
                )
            if must_flush:
                return "flush", None
            with self._lock:
                index = self._ivf if ivf_mode else self._index
                if index is None:
                    return "retry", "no_index"  # flush raced a compaction
                layout = self._ivf_layout if ivf_mode else index.layout
                fetch_k = max(2 * k, k + 16) if overfetch else k
                # the host rescore runs for int8 unless disabled ("none") or
                # the fused device re-rank is wired into this index (flat,
                # single-device or mesh: each slot re-ranks before the merge):
                # "device" on IVF falls back to the exact host path rather
                # than serving raw int8 scores
                fused_device = not ivf_mode and index.rescore_fetch > 0
                # PQ cells rank reconstructions: without the exact re-rank the
                # served order is the ADC order, so IVF-PQ always joins the
                # rescore path beside int8
                pq_mode = ivf_mode and self.config.ivf_pq_subq > 0
                lossy = self.config.storage_dtype == "int8" or pq_mode
                rescore = (lossy
                           and self.config.rescore_overfetch > 0
                           and self.config.rescore_mode != "none"
                           and not fused_device)
                # caller-visible width: key resolution and the final sort are
                # bounded by out_k, not by the rescore window
                out_k = min(fetch_k, layout.total_rows)
                if rescore:
                    ovf = self.config.rescore_overfetch
                    if pq_mode:
                        # the ADC error is far above int8's: PQ re-ranks a
                        # deeper window
                        ovf = max(ovf, self.config.ivf_pq_rescore_overfetch)
                    fetch_k = max(fetch_k, ovf * k)
                fetch_k = min(fetch_k, layout.total_rows)
                # the adaptive rescore bound only means something where the
                # candidates are ADC-scored and the build left a calibration
                # (pq_err > 0; 0 = the full fixed window)
                rescore_err = 0.0
                if (rescore and pq_mode
                        and self.config.ivf_pq_adaptive_rescore):
                    rescore_err = float(index.pq_err or 0.0)
                self.stats["searches"] += 1
                self.stats["search_queries"] += queries.shape[0]
                gen = self._generation
                slot_gen = self._slot_generation
                version = index.version
                # host-delta snapshot: staged AND mid-scatter (inflight) slots,
                # so freshly-put vectors stay visible across the flush
                delta = []
                n_del = len(self._staged_deletes)
                pending = list(self._staged_updates)
                for ups, dels in self._inflight.values():
                    pending.extend(ups)
                    n_del += len(dels)
                for s, sl in pending:
                    if self.mirrors[s].is_valid(sl):
                        delta.append((layout.row_of(s, sl),
                                      self.mirrors[s].vector_at(sl).copy()))
                if ivf_mode:
                    # IVF's standing delta (flushed-but-unclustered inserts)
                    # joins the same host-side exact scan
                    for (s, sl), v in self._ivf_delta.items():
                        if self.mirrors[s].is_valid(sl):
                            delta.append((layout.row_of(s, sl), v))
                self.stats["search_delta_rows"] += len(delta)
        # the device call runs OUTSIDE the engine lock; slots are
        # append-only, so concurrent puts/deletes cannot corrupt it
        with self.timers.stage("search.device"):
            if ivf_mode:
                dists, rows = self._ivf_search_rows(
                    queries, fetch_k, index, delta, n_del, layout.total_rows)
            else:
                dists, rows = self._flat_search_rows(queries, fetch_k, index,
                                                     delta, n_del)
        if index.version != version:
            return "retry", "version"  # an in-place write overlapped
        with self.timers.stage("search.assemble"):
            return self._assemble_results(queries, dists, rows, gen,
                                          slot_gen, rescore, layout, out_k,
                                          n_del, rescore_err=rescore_err,
                                          k=k)

    def _assemble_results(self, queries, dists, rows, gen, slot_gen, rescore,
                          layout, out_k, n_del, rescore_err=0.0, k=0):
        """Resolve device rows to keys and compact live hits per row. Takes
        the engine lock only for the generation checks and key resolution;
        the exact re-rank runs outside it."""
        if rescore:
            # row payloads are immutable once written (slots are
            # append-only; an overwrite takes a fresh slot), so reading
            # them from a snapshot of the mirror list is race-free. Only
            # compaction invalidates slot identity: the re-check below
            # catches that and retries.
            with self._lock:
                if self._generation != gen:
                    return "retry", "generation"  # compacted or appended
                mirrors = list(self.mirrors)
            # the rescore consumes the full device window (recall lives
            # there) but returns only the caller-visible top plus slack:
            # headroom for staged-deleted candidates, so the slow path
            # below can still refill out_k live hits
            top_w = min(rows.shape[1], out_k + 32 + n_del)
            q32 = np.asarray(queries, np.float32)
            with self.timers.stage("search.rescore"):
                if rescore_err > 0.0 and k > 0:
                    dists, rows = self._rescore_adaptive(
                        q32, rows, np.asarray(dists, np.float32),
                        rescore_err, k, layout, mirrors, top=top_w)
                else:
                    dists, rows = self._rescore_exact(
                        q32, rows, layout, mirrors, top=top_w,
                        native=self.rescore_backend == "native")
        with self.timers.span("search.keys"):
            with self._lock:
                # a rescored search validates slot identity only: the device
                # epoch was certified before the rescore, and an IVF append
                # during the re-rank cannot invalidate rows already fetched
                # or the payloads read; only compaction (slot reuse) can
                stale = (self._slot_generation != slot_gen if rescore
                         else self._generation != gen)
                if stale:  # compacted (or, unrescored, appended)
                    return "retry", ("slot_generation" if rescore
                                     else "generation")
                # the scan returns the full width (fetch_k padded by the
                # staged-delete count): staged-deleted slots resolve to no key
                # here, so compact live hits to the front and truncate
                qn, width = rows.shape
                res_k = min(out_k, width)
                # fast path: every caller-visible row resolves live
                r_cut = np.ascontiguousarray(rows[:, :res_k]).reshape(-1)
                keys, n_missing = self.docstore.keys_rows(
                    r_cut, layout.phys_cap, row=res_k)
                if n_missing == 0:
                    out_d = np.asarray(dists, np.float32)[:, :res_k]
                    return "ok", (out_d, keys)
                # slow path: some candidate is dead / padded / staged-deleted
                self.stats["search_slow_path"] += 1
                flat = rows.reshape(-1)
                nn = flat >= 0
                live = np.zeros(flat.shape[0], bool)
                if nn.any():
                    live[nn] = self.docstore.slots_live(
                        flat[nn] // layout.phys_cap,
                        flat[nn] % layout.phys_cap)
                live = live.reshape(qn, width)
                order = np.argsort(~live, axis=1, kind="stable")
                live_sorted = np.take_along_axis(live, order,
                                                 axis=1)[:, :res_k]
                d_sorted = np.take_along_axis(
                    np.asarray(dists, np.float32), order, axis=1)[:, :res_k]
                r_sorted = np.take_along_axis(rows, order, axis=1)[:, :res_k]
                pad = res_k - r_sorted.shape[1]
                if pad:
                    live_sorted = np.pad(live_sorted, ((0, 0), (0, pad)))
                    d_sorted = np.pad(d_sorted, ((0, 0), (0, pad)))
                    r_sorted = np.pad(r_sorted, ((0, 0), (0, pad)),
                                      constant_values=-1)
                sel = live_sorted.reshape(-1)
                keys_flat: List[Optional[str]] = [None] * sel.shape[0]
                if sel.any():
                    rr = r_sorted.reshape(-1)[sel]
                    resolved = self.docstore.keys_at_bulk(
                        rr // layout.phys_cap, rr % layout.phys_cap)
                    for pos, key in zip(np.flatnonzero(sel).tolist(),
                                        resolved):
                        keys_flat[pos] = key
            out_d = np.where(live_sorted, d_sorted, np.inf).astype(np.float32)
            keys = [keys_flat[i * res_k:(i + 1) * res_k] for i in range(qn)]
            return "ok", (out_d, keys)

    @staticmethod
    def _rescore_exact(queries: np.ndarray, rows: np.ndarray, layout,
                       mirrors: list, top: Optional[int] = None,
                       native: bool = False):
        """Re-rank device candidates by exact f32 distance to the mirrors'
        rows (dequantized for int8 mirrors): lossy scanning trades score
        precision for device memory, and this epilogue restores the exact
        ordering over the overfetched candidates. Lock-free against the
        given snapshot of the mirror list.

        native=True runs the fused native epilogue (`rescore_into`): each
        candidate row streams through registers once and the mirror's
        precomputed ||v||^2 is reused, with no (n, d) f32 transient. The
        numpy form gathers the rows as f32 and takes the GEMM form
        |q|^2 - 2 q.v + |v|^2 batched per query, so no (Q, F, d)
        difference array exists."""
        q = np.ascontiguousarray(np.atleast_2d(queries), np.float32)
        qn, f = rows.shape
        if native:
            d = VectorDBEngine._exact_masked(
                q, rows, np.ones((qn, f), bool), layout, mirrors,
                native=True)
            return _sorted_top(d, rows, top)
        flat = rows.ravel()
        ok = flat >= 0
        qsq = np.einsum("qd,qd->q", q, q).astype(np.float32)
        vecs = np.zeros((flat.size, q.shape[1]), np.float32)
        if ok.any():
            shards = flat[ok] // layout.phys_cap
            slots = flat[ok] % layout.phys_cap
            pos = np.flatnonzero(ok)
            for s in range(len(mirrors)):
                m = shards == s
                if m.any():
                    vecs[pos[m]] = mirrors[s].rows_f32(slots[m])
        vmat = vecs.reshape(qn, f, -1)
        v_sq = np.einsum("qfd,qfd->qf", vmat, vmat)
        qv = np.matmul(vmat, q[:, :, None])[:, :, 0]  # batched matvec
        d = qsq[:, None] - 2.0 * qv + v_sq
        d = np.where(rows >= 0, d, np.inf).astype(np.float32)
        return _sorted_top(d, rows, top)

    def _rescore_adaptive(self, q: np.ndarray, rows: np.ndarray,
                          adc_d: np.ndarray, err: float, k: int, layout,
                          mirrors, top: Optional[int] = None):
        """Error-bounded exact re-rank (config.ivf_pq_adaptive_rescore).

        The PQ probe's candidates arrive ADC-ascending, and the ADC distance
        is exact to the reconstruction x_hat, so with the calibrated
        error-norm quantile E = index.pq_err the true distance is bounded:
        d_exact >= (sqrt(d_adc) - E)^2. Phase 1 rescores the first
        max(4k, 32) candidates exactly and takes the running kth exact
        distance D_k; phase 2 rescores only the remaining candidates whose
        bound undercuts D_k. The rest cannot, up to the calibration's tail,
        enter the top-k: they keep their ADC estimate, clamped to D_k so
        that a tail violation never displaces an exact top-k hit."""
        qn, f = rows.shape
        w0 = min(f, max(4 * k, 32))
        mask = np.zeros((qn, f), bool)
        mask[:, :w0] = True
        native = self.rescore_backend == "native"
        d = self._exact_masked(q, rows, mask, layout, mirrors, native=native)
        kk = min(k - 1, w0 - 1)
        dk = np.partition(d[:, :w0], kk, axis=1)[:, kk]     # (Q,) kth exact
        # d_exact = d_adc - ||e||^2 - 2 (q - x) . e with e the candidate's
        # reconstruction error. The worst case charges the full cross term
        # 2 sqrt(d) E; but q - x is independent of the error's direction,
        # so (q - x) . e concentrates at ||q - x|| ||e|| / sqrt(dim), and a
        # z = 4 normal tail buys a sqrt(dim) / 4 tighter cross term. E is
        # the calibrated 0.999 error-norm quantile (pq.calibrate_pq_err).
        z_over_sqrtd = 4.0 / np.sqrt(q.shape[1])
        # an empty slot carries +inf: inf - inf would be nan in the bound,
        # so clamp to a finite sentinel first (rows >= 0 excludes it anyway)
        adc_f = np.nan_to_num(adc_d, posinf=np.finfo(np.float32).max / 4)
        lb = (adc_f - err * err
              - 2.0 * np.sqrt(np.maximum(adc_f, 0.0)) * (err * z_over_sqrtd))
        mask2 = (~mask) & (rows >= 0) & (lb < dk[:, None])
        if mask2.any():
            d2 = self._exact_masked(q, rows, mask2, layout, mirrors,
                                    native=native)
            d = np.where(mask2, d2, d)
        done = (mask | mask2) & (rows >= 0)
        # unrescored candidates keep their ADC estimate, floored at D_k
        d = np.where(done, d,
                     np.where(rows >= 0,
                              np.maximum(adc_d, dk[:, None]), np.inf))
        n_done = int(done.sum())
        with self._lock:
            self.stats["rescored_rows"] += n_done
            self.stats["rescore_skipped_rows"] += (
                int((rows >= 0).sum()) - n_done)
        return _sorted_top(d.astype(np.float32), rows, top)

    @staticmethod
    def _exact_masked(q: np.ndarray, rows: np.ndarray, mask: np.ndarray,
                      layout, mirrors, native: bool = False) -> np.ndarray:
        """Exact f32 distances at the masked candidate positions only
        (np.inf elsewhere), from the mirrors' rows: the fused native
        epilogue with native=True, a numpy gather otherwise."""
        qn, f = rows.shape
        flat = rows.ravel()
        sel = mask.ravel() & (flat >= 0)
        out = np.full(qn * f, np.inf, np.float32)
        if not sel.any():
            return out.reshape(qn, f)
        qsq = np.einsum("qd,qd->q", q, q).astype(np.float32)
        shards = flat[sel] // layout.phys_cap
        slots = flat[sel] % layout.phys_cap
        pos = np.flatnonzero(sel)
        if native:
            for s in range(len(mirrors)):
                m = shards == s
                if m.any():
                    mirrors[s].rescore_into(q, qsq, f, slots[m], pos[m], out)
            return out.reshape(qn, f)
        vecs = np.zeros((len(pos), q.shape[1]), np.float32)
        for s in range(len(mirrors)):
            m = shards == s
            if m.any():
                vecs[np.flatnonzero(m)] = mirrors[s].rows_f32(slots[m])
        qrows = q[pos // f]
        out[pos] = (qsq[pos // f]
                    - 2.0 * np.einsum("nd,nd->n", qrows, vecs)
                    + np.einsum("nd,nd->n", vecs, vecs))
        return out.reshape(qn, f)

    def _flat_search_rows(self, queries: np.ndarray, k: int, index, delta,
                          n_del):
        """Device scan + host delta scan over staged-but-unflushed writes.

        Staged deletes need no masking: deletion already unmaps the old
        slot in the doc store, so stale device hits resolve to no key and
        are dropped at key resolution; the device fetch is padded by the
        staged-delete count to compensate. A delta row that the device
        scan also returned (its scatter landed before the scan) is dropped,
        so no row comes back twice.
        """
        dev_k = min(k + n_del, index.layout.total_rows)
        dists, rows = index.search(queries, dev_k)
        with self.timers.span("index.row_map"):
            return self._merge_delta(queries, dists, rows.astype(np.int64),
                                     delta, index.layout.total_rows)

    def _ivf_search_rows(self, queries: np.ndarray, k: int, ivf, delta,
                         n_del, total_rows):
        """IVF probe + host exact scan of the delta snapshot (staged
        writes and the standing unclustered delta), merged as in
        _flat_search_rows. The fetch is k + n_del wide; the reference's
        bf16 wire distances (an XLA relay workaround) are not carried
        over. On a mesh it is the reference's power-of-two width: its mesh
        program returns every column of that fetch (no out_w shrink,
        `tpuvdb/mesh/sharded_ivf.py` `search`), and a rescore ranks the
        whole window, so the width is part of the served answer (an IVF-PQ
        window of 64 x 10 ranks 1,024 candidates there)."""
        fetch = k + n_del
        if isinstance(ivf, ShardedIVFIndex):
            fetch = 1 << (fetch - 1).bit_length()
        dists, rows = ivf.search(queries, fetch)
        with self.timers.span("index.row_map"):
            return self._merge_delta(queries, dists, rows, delta, total_rows)

    @staticmethod
    def _merge_delta(queries, dists, rows, delta, total):
        """Merge the device top-k with the exact scores of the host delta
        rows, dropping a delta row the device also returned; full width."""
        if not delta:
            return dists, rows
        with span("index.delta_merge"):
            mat = np.stack([v for _, v in delta])
            q = np.asarray(queries, np.float32)
            d2 = (np.sum(q * q, axis=1, keepdims=True)
                  + np.einsum("nd,nd->n", mat, mat)[None, :]
                  - 2.0 * (q @ mat.T))
            drows = np.array([r for r, _ in delta], np.int64)
            qn = queries.shape[0]
            qoff = np.arange(qn, dtype=np.int64)[:, None] * total
            on_device = np.isin(qoff + drows[None, :],
                                (qoff + rows)[rows >= 0]).reshape(
                                    qn, len(delta))
            d2 = np.where(on_device, np.inf, d2)
            drows_q = np.where(on_device, -1, drows[None, :])
            all_d = np.concatenate([dists, d2], axis=1)
            all_r = np.concatenate([rows, drows_q], axis=1)
            order = np.argsort(all_d, axis=1, kind="stable")
            # full width returned (>= k + n_del): the caller drops rows whose
            # slot was staged-deleted, so truncating here would hand back
            # deleted slots in place of live candidates
            return (np.take_along_axis(all_d, order, axis=1),
                    np.take_along_axis(all_r, order, axis=1))

    # ---------------------------------------------------- background flushing

    def start_background_flush(self, interval_s: float = 0.05):
        """Drain staged writes to the device off the serving path."""
        if self._bg_flush_thread is not None:
            return
        self._bg_flush_stop = threading.Event()

        def loop():
            while not self._bg_flush_stop.wait(interval_s):
                try:
                    with self._lock:
                        if not (self._staged_updates or self._staged_deletes):
                            continue
                    with self.timers.stage("flush.background"):
                        self.flush()
                except Exception:
                    # keep draining: a failed flush leaves its rows staged
                    # for the next attempt or for the search path's flush
                    logger.exception("background flush failed")

        self._bg_flush_thread = threading.Thread(
            target=loop, daemon=True, name="tpuvdb-torch-flush")
        self._bg_flush_thread.start()

    def stop_background_flush(self):
        t = self._bg_flush_thread
        if t is not None:
            self._bg_flush_stop.set()
            t.join(timeout=2)
            self._bg_flush_thread = None

    # ------------------------------------------------------------ maintenance

    def compact(self, online: bool = True):
        """Rebuild mirrors densely, dropping soft-deleted slots.

        online=True (default): snapshot under a brief lock, rebuild OUTSIDE
        the locks while serving continues, journal interim ops, then swap
        and replay the journal. online=False is the fully-locked variant.
        Lock order: _flush_lock before the engine lock (as flush's scatter
        phase), so an in-flight scatter drains before slots move."""
        if not online:
            with self._flush_lock, self._lock:
                snap = self.docstore.export_snapshot()
                old_mirrors = self.mirrors
                new_mirrors, new_docstore = self._rebuild_dense(
                    snap, old_mirrors)
                self._swap_compacted(new_mirrors, new_docstore)
            for m in old_mirrors:  # mappings stay valid for live views
                m.unlink_files()
            return
        with self._lock:
            if self._compact_journal is not None:
                return  # a compaction is already in flight
            self._compact_journal = []
            snap = self.docstore.export_snapshot()
            old_mirrors = self.mirrors
        try:
            # written slots are immutable, so reading old mirror rows
            # races with nothing
            new_mirrors, new_docstore = self._rebuild_dense(snap, old_mirrors)
        except Exception:
            with self._lock:
                self._compact_journal = None
            raise
        with self._flush_lock, self._lock:
            journal = self._compact_journal
            self._compact_journal = None
            self._swap_compacted(new_mirrors, new_docstore)
            # replay ops that landed during the rebuild (already WAL'd and
            # already counted: the churn counter stays where it is)
            mut0 = self._mut_count
            for op, key, vec, metadata, ts in journal:
                if op == "put":
                    self._put_one(key, vec, metadata, ts, replay_mode=True)
                else:
                    e = self.docstore.delete(key)
                    if e is not None:
                        self.mirrors[e.shard].mark_deleted(e.slot)
                        self._staged_deletes.append((e.shard, e.slot))
            self._mut_count = mut0
        for m in old_mirrors:  # unlink the swapped-out vector files (the
            m.unlink_files()   # mappings stay valid for any live snapshot)

    def _rebuild_dense(self, snap, old_mirrors):
        """Columnar dense rebuild from an export_snapshot(): one gather and
        one write per shard in the stored dtype (bit-exact for int8), then
        the doc store: a packed native snapshot goes back through one FFI
        crossing with the remapped slots, entries through put_many."""
        shards, slots = DocStore.snapshot_shard_slots(snap)
        new_mirrors = [self._new_mirror(i)
                       for i in range(self.config.shard_count)]
        new_docstore = DocStore(backend=self.config.docstore_backend)
        n = len(shards)
        new_slots = np.empty(n, np.int64)
        for s in range(self.config.shard_count):
            idx = np.flatnonzero(shards == s)
            if not idx.size:
                continue
            vec, scale, sq = old_mirrors[s].rows_raw(slots[idx])
            first = new_mirrors[s].alloc(idx.size)
            new_mirrors[s].write_raw_batch(first, vec, scale, sq)
            new_slots[idx] = first + np.arange(idx.size, dtype=np.int64)
        if new_docstore.load_packed_remapped(snap, new_slots):
            return new_mirrors, new_docstore
        keys, shards_c, _, tss, mds = DocStore.snapshot_columns(snap)
        new_docstore.put_many([
            DocEntry(key=keys[i], shard=int(shards_c[i]),
                     slot=int(new_slots[i]), metadata=mds[i],
                     timestamp=int(tss[i]))
            for i in range(n)
        ])
        return new_mirrors, new_docstore

    def _swap_compacted(self, new_mirrors, new_docstore):
        self.mirrors = new_mirrors
        self.docstore = new_docstore
        self._generation += 1
        self._slot_generation += 1  # compaction reuses slots
        self._index = None
        self._ivf = None
        self._ivf_layout = None
        self._ivf_delta.clear()
        self._staged_updates.clear()
        self._staged_deletes.clear()
        # in-flight scatter batches reference pre-compaction slots; their
        # data is covered by the snapshot/journal, and leaving them visible
        # would alias reused slot numbers in the new mirrors
        self._inflight.clear()
        self._puts_since_compact = 0
        self.stats["compactions"] += 1
        logger.info("compacted: %d live docs", len(self.docstore))

    def save_checkpoint(self) -> Optional[str]:
        """Consistent snapshot under the lock (memory copies), disk writes
        with the lock released."""
        if self.ckpts is None:
            return None
        with self._ckpt_lock:  # one checkpoint at a time
            tmp = self.ckpts.begin()
            with self._lock:
                wal_pos = (self.wal.last_seq if self.wal is not None
                           else self._wal_floor)
                doc_blob = doc_rows = None
                if self.docstore.backend == "native":
                    # the C++ table serialized to memory under the lock
                    # (memcpy speed); the disk write happens off-lock
                    doc_blob = self.docstore.snapshot_native_mem()
                else:
                    doc_rows = [(e.key, e.shard, e.slot, e.metadata,
                                 e.timestamp)
                                for e in self.docstore.entries()]
                # views + a small validity copy: rows [:n) are immutable,
                # so the off-lock writer below reads them safely
                shard_snaps = [m.checkpoint_snapshot() for m in self.mirrors]
                ts_ = self._ivf_train_state
                ivf_warm = ((*ts_, self._mut_count, self._ivf_pq_state,
                             self._ivf_opq_state, self._ivf_pq_err)
                            if ts_ is not None else None)
                # packed IVF-PQ device state: captured by reference under
                # the lock (cheap), fetched and written off it below
                packed_cap = packed_clean_src = None
                cap_epoch = self._ivf_packed_epoch
                # single-device IVF-PQ only: the mesh index has no packed
                # form, as in the reference
                if (self.config.ivf_checkpoint_packed
                        and isinstance(self._ivf, IVFIndex) and self._ivf.pq
                        and self._ivf_layout is not None):
                    if (cap_epoch == self._ivf_packed_saved_epoch
                            and self._ivf_packed_path is not None
                            and os.path.exists(self._ivf_packed_path)):
                        # the index has not changed since the last packed
                        # save: link that file instead of fetching the
                        # code table again
                        packed_clean_src = self._ivf_packed_path
                    else:
                        packed_cap = (self._ivf.packed_capture(),
                                      self._ivf_layout.phys_cap)
                self._puts_since_ckpt = 0
            packed_written = self._write_ivf_packed(
                tmp, packed_clean_src, packed_cap, cap_epoch)
            if doc_blob is not None:
                try:
                    with open(os.path.join(tmp, "docstore.kv"), "wb") as f:
                        f.write(doc_blob.view())
                        f.flush()
                        os.fsync(f.fileno())
                finally:
                    doc_blob.release()
            path = self.ckpts.finish(tmp, self.config, doc_rows, shard_snaps,
                                     wal_pos, dim=self.config.vector_dim,
                                     ivf_warm=ivf_warm)
            if packed_written:
                # later clean checkpoints link from the newest copy (older
                # checkpoint directories are pruned by retention)
                self._ivf_packed_path = os.path.join(path, "ivf_packed.npz")
            if self.wal is not None:
                self.wal.truncate_through(wal_pos)
            with self._lock:
                self.stats["checkpoints"] += 1
            logger.info("checkpoint saved: %s", path)
            return path

    def _write_ivf_packed(self, tmp: str, clean_src: Optional[str],
                          packed_cap, cap_epoch: int) -> bool:
        """Put ivf_packed.npz into the checkpoint's staging directory, off
        the engine lock: a hard link (or a copy) of the current file, or a
        fresh fetch of the captured device state. Returns whether the file
        is there. A fetch that an in-place append or delete overlapped
        raises inside and the file is skipped for this checkpoint: the warm
        state still saves, and a restart then encodes the rows again."""
        dst = os.path.join(tmp, "ivf_packed.npz")
        if clean_src is not None:
            try:
                os.link(clean_src, dst)
                return True
            except OSError:
                try:
                    shutil.copyfile(clean_src, dst)
                    return True
                except OSError as e:
                    logger.warning("packed IVF reuse failed (%s); skipped "
                                   "this checkpoint", e)
            return False
        if packed_cap is None:
            return False
        try:
            cap, phys_cap = packed_cap
            arrs = IVFIndex.packed_fetch(cap)
            arrs["phys_cap"] = np.int64(phys_cap)
            arrs["dim"] = np.int64(self.config.vector_dim)
            arrs["pq_subq"] = np.int64(self.config.ivf_pq_subq)
            arrs["pq_bits"] = np.int64(self.config.ivf_pq_bits)
            # the reference's from_packed requires the key; the port's
            # search does not read it
            arrs["recall_target"] = np.float64(self.config.recall_target)
            np.savez(dst, **arrs)
            # saved at the captured epoch: a flush that wrote the index
            # after the fetch bumped the live epoch past it, so the next
            # checkpoint fetches again
            self._ivf_packed_saved_epoch = cap_epoch
            return True
        except (RuntimeError, OSError) as e:
            logger.warning("packed IVF state skipped this checkpoint: %s", e)
            if os.path.exists(dst):
                os.unlink(dst)
            return False

    # ------------------------------------------------------------------ admin

    def count(self) -> int:
        return len(self.docstore)

    def info(self) -> Dict:
        with self._lock:
            index = self._ivf if self._ivf is not None else self._index
            return {
                "docs": len(self.docstore),
                "shards": [
                    {"used": m.used(), "live": m.live(), "deleted": m.deleted,
                     "phys_cap": m.phys_cap}
                    for m in self.mirrors
                ],
                "index_type": self.config.index_type,
                "storage_dtype": self.config.storage_dtype,
                "quantized": bool(index.quantized) if index else False,
                "device": str(self.device),
                "device_rows": (self._index.layout.total_rows
                                if self._index else 0),
                "device_bytes": index.nbytes() if index else 0,
                "ivf": (dataclasses.asdict(self._ivf.stats())
                        if self._ivf else None),
                "ivf_delta": len(self._ivf_delta),
                "staged": len(self._staged_updates) + len(self._staged_deletes),
                "stats": {**self.stats, **self._ivf_graph_stats()},
                "latency": self.timers.snapshot(),
                # the last profiled session's spans (None before one)
                "spans": self.timers.spans(),
                # group commit: {batches-per-group: count}
                "search_groups": (dict(self._search_coalescer.group_sizes)
                                  if self._search_coalescer else None),
                # the host runtime each part took ("auto" resolved)
                "docstore_backend": self.docstore.backend,
                "wal_backend": (self.wal.backend if self.wal is not None
                                else None),
                "rescore_backend": self.rescore_backend,
                "fastlist": self.docstore.backend == "native",
                "mirror_backend": ("mmap" if self._mirror_dir is not None
                                   else "ram"),
            }

    def _ivf_graph_stats(self) -> Dict[str, int]:
        """The serving IVF index's probe-graph counts as ivf_graph_<name>
        (index/probe_graphs.py STATS; a rebuilt index counts anew); 0
        where no single-device IVF index serves."""
        graphs = getattr(self._ivf, "graphs", None)
        counts = graphs.stats() if graphs is not None else {}
        return {f"ivf_graph_{n}": counts.get(n, 0) for n in GRAPH_STATS}

    def close(self):
        # never hold the engine lock here: save_checkpoint takes
        # _ckpt_lock -> _lock, as cadence-triggered checkpoints do
        self.stop_background_flush()
        if self.ckpts is not None:
            self.save_checkpoint()
        if self.wal is not None:
            self.wal.close()
