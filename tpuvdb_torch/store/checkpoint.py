"""Checkpoint / restore: the port's copy of tpuvdb.store.checkpoint.

A checkpoint is `checkpoint_<ts>/` containing:
    config.json      — DBConfig used at save time
    docstore.msgpack — key -> (shard, slot, metadata, ts)   [python backend]
    docstore.kv      — the native KV's C++ binary snapshot  [native backend]
    shard_<i>.npz    — per-shard mirror metadata (+ inline raw-dtype rows,
                       scales and sqnorms for RAM mirrors; format 2)
    shard_<i>.vec/.scale/.sq — HARDLINKS of an mmap mirror's vector files
                       (slot rows are append-only and immutable, so linking
                       the live files and recording next_slot is a
                       crash-consistent snapshot without a copy)
    wal_pos.txt      — max WAL LSN covered by this checkpoint
    ivf_warm.npz     — IVF engines: trained centroids, the live-row count
                       and mutation count at training, the mutation count
                       at the checkpoint (a restart reuses the centroids);
                       IVF-PQ engines add the trained codebooks, the OPQ
                       rotation and the rescore calibration (`pq_codebooks`,
                       `pq_rotation`, `pq_err`, the last only when non-zero)
    ivf_packed.npz   — IVF-PQ engines with ivf_checkpoint_packed: the whole
                       packed device index (code cells, norms, validity,
                       slot maps, codebooks), written by the engine into the
                       staging directory; a restart uploads it instead of
                       encoding every row again
    MANIFEST.json    — shard count/dim/format + completeness marker
                       (written last, so a torn checkpoint never restores)

The layout is the reference's, so checkpoints restore across the two
packages, format-1 shards included. An mmap mirror of the same dtype and
geometry adopts a checkpoint's linked files by hardlinking them back in;
any other mirror reads them.

Retention keeps the newest `max_checkpoints`.
"""

from __future__ import annotations

import glob
import json
import os
import shutil
import time
import zipfile
from typing import Callable, List, Optional, Tuple

import msgpack
import numpy as np

from tpuvdb_torch.core import errors
from tpuvdb_torch.core.config import DBConfig
from tpuvdb_torch.index.layout import ShardMirror
from tpuvdb_torch.store.kv import DocStore


def _link_or_copy(src: str, dst: str) -> bool:
    """Hardlink src to dst (a copy across file systems); False when src is
    gone."""
    try:
        os.link(src, dst)
    except FileNotFoundError:
        return False
    except OSError:
        try:
            shutil.copyfile(src, dst)
        except FileNotFoundError:
            return False
    return True


def _link_mirror_files(tmp: str, i: int, snap: dict) -> Optional[dict]:
    """Hardlink shard i's mmap files into the staging directory after an
    msync; {part: file name}, or None when a concurrent compaction already
    unlinked the live files. The snapshot's row views stay valid then
    (store_ref pins the mapping), and the caller inlines the rows."""
    snap["store_ref"].flush_files()
    linked = {}
    for part, src in snap["mmap_paths"].items():
        dst = os.path.join(tmp, f"shard_{i}.{part}")
        if not _link_or_copy(src, dst):
            for name in linked.values():
                os.unlink(os.path.join(tmp, name))
            return None
        linked[part] = os.path.basename(dst)
    return linked


def _fsync_path(p: str) -> None:
    fd = os.open(p, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_tree(d: str) -> None:
    """fsync every file in d, then d itself: the engine truncates the
    covering WAL right after a checkpoint, so all of it must be on disk."""
    for name in os.listdir(d):
        _fsync_path(os.path.join(d, name))
    _fsync_path(d)


class CheckpointManager:
    def __init__(self, ckpt_dir: str, max_checkpoints: int = 3):
        self.ckpt_dir = ckpt_dir
        self.max_checkpoints = max_checkpoints
        os.makedirs(ckpt_dir, exist_ok=True)

    def _paths(self) -> List[str]:
        return sorted(glob.glob(os.path.join(self.ckpt_dir, "checkpoint_*")))

    def latest(self) -> Optional[str]:
        for path in reversed(self._paths()):
            if os.path.exists(os.path.join(path, "MANIFEST.json")):
                return path
        return None

    # ---------------------------------------------------------------- writing

    def begin(self) -> str:
        """Create and return the staging directory for the next checkpoint;
        torn staging dirs are GC'd, never restored."""
        ts = int(time.time() * 1000)
        path = os.path.join(self.ckpt_dir, f"checkpoint_{ts}")
        tmp = path + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        return tmp

    def finish(
        self,
        tmp: str,
        config: DBConfig,
        doc_rows: Optional[List[tuple]],  # None: docstore.kv already in tmp
        shard_snaps: List[dict],          # ShardMirror.checkpoint_snapshot()
        wal_pos: int,
        dim: int,
        ivf_warm=None,  # (centroids, trained_live, mut_at_train, mut_now
                        #  [, pq_codebooks, pq_rotation, pq_err])
    ) -> str:
        """Write and commit the checkpoint from snapshot descriptors that
        the caller captured under its lock; runs with the lock released.
        mmap shards hardlink their vector files, RAM shards inline their
        rows in the npz."""
        with open(os.path.join(tmp, "config.json"), "w") as f:
            f.write(config.to_json())
        if doc_rows is not None:
            blob = msgpack.packb({"docs": doc_rows}, use_bin_type=True)
            with open(os.path.join(tmp, "docstore.msgpack"), "wb") as f:
                f.write(blob)
                f.flush()
                os.fsync(f.fileno())
        for i, s in enumerate(shard_snaps):
            meta = dict(fmt=2, dtype=s["dtype"], n=np.int64(s["n"]),
                        deleted=np.int64(s["deleted"]), valid=s["valid"])
            linked = (_link_mirror_files(tmp, i, s)
                      if s["mmap_paths"] is not None else None)
            if linked is not None:
                np.savez(os.path.join(tmp, f"shard_{i}.npz"),
                         linked=json.dumps(linked),
                         file_rows=np.int64(s["store_ref"].valid.shape[0]),
                         **meta)
            else:
                extra = {"vectors": s["vec"], "sqnorms": s["sq"]}
                if s["scale"] is not None:
                    extra["scales"] = s["scale"]
                np.savez(os.path.join(tmp, f"shard_{i}.npz"), **extra,
                         **meta)
        with open(os.path.join(tmp, "wal_pos.txt"), "w") as f:
            f.write(str(int(wal_pos)))
        if ivf_warm is not None:
            cents, trained_live, mut_at_train, mut_now = ivf_warm[:4]
            extra = {}
            # IVF-PQ: the trained codebooks ride along, with the OPQ
            # rotation and the adaptive-rescore calibration that pair with
            # them (0 = uncalibrated, not stored)
            if len(ivf_warm) > 4 and ivf_warm[4] is not None:
                extra["pq_codebooks"] = np.asarray(ivf_warm[4], np.float32)
            if len(ivf_warm) > 5 and ivf_warm[5] is not None:
                extra["pq_rotation"] = np.asarray(ivf_warm[5], np.float32)
            if len(ivf_warm) > 6 and ivf_warm[6]:
                extra["pq_err"] = np.float64(ivf_warm[6])
            np.savez(os.path.join(tmp, "ivf_warm.npz"),
                     centroids=np.asarray(cents, np.float32),
                     trained_live=np.int64(trained_live),
                     mut_at_train=np.int64(mut_at_train),
                     mut_at_ckpt=np.int64(mut_now), **extra)
        with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
            json.dump({"num_shards": len(shard_snaps), "dim": dim,
                       "format": 2,
                       "docstore": "kv" if doc_rows is None else "msgpack",
                       "timestamp": int(os.path.basename(tmp)
                                        .split("_")[1].split(".")[0])}, f)
        _fsync_tree(tmp)
        path = tmp[: -len(".tmp")]
        os.replace(tmp, path)
        _fsync_path(self.ckpt_dir)
        self._gc()
        return path

    def _gc(self):
        paths = [p for p in self._paths() if os.path.exists(os.path.join(p, "MANIFEST.json"))]
        for p in paths[: -self.max_checkpoints]:
            shutil.rmtree(p, ignore_errors=True)
        for p in glob.glob(os.path.join(self.ckpt_dir, "*.tmp")):
            shutil.rmtree(p, ignore_errors=True)

    # ---------------------------------------------------------------- loading

    def load_latest(
        self,
        config: DBConfig,
        mirror_factory: Optional[Callable[[int], ShardMirror]] = None,
    ) -> Optional[Tuple[DocStore, List[ShardMirror], int]]:
        """Restore (docstore, mirrors, wal_pos) from the newest complete
        checkpoint, or None if there is none."""
        path = self.latest()
        if path is None:
            return None
        with open(os.path.join(path, "MANIFEST.json")) as f:
            manifest = json.load(f)
        if manifest["dim"] != config.vector_dim:
            raise errors.CheckpointError(
                f"checkpoint dim {manifest['dim']} != configured {config.vector_dim}")
        kv_path = os.path.join(path, "docstore.kv")
        if manifest.get("docstore") == "kv" or os.path.exists(kv_path):
            docstore = DocStore.load_native_file(
                kv_path, backend=config.docstore_backend)
        else:
            docstore = DocStore.load(os.path.join(path, "docstore.msgpack"),
                                     backend=config.docstore_backend)
        if mirror_factory is None:
            def mirror_factory(i, _cfg=config):
                return ShardMirror(dim=_cfg.vector_dim,
                                   capacity=_cfg.shard_capacity,
                                   init_cap=_cfg.mirror_init_cap, block=128,
                                   dtype=_cfg.mirror_dtype)
        mirrors = []
        for i in range(manifest["num_shards"]):
            m = mirror_factory(i)
            self._restore_shard(path, i, m)
            mirrors.append(m)
        with open(os.path.join(path, "wal_pos.txt")) as f:
            wal_pos = int(f.read().strip())
        return docstore, mirrors, wal_pos

    def _restore_shard(self, path: str, i: int, m: ShardMirror) -> None:
        z = np.load(os.path.join(path, f"shard_{i}.npz"), allow_pickle=False)
        if "fmt" not in z:  # format-1 checkpoint: f32 rows inline
            n = int(z["next_slot"])
            m.load_f32(z["vectors"], z["valid"], n, int(z["deleted"]))
            return
        n = int(z["n"])
        deleted = int(z["deleted"])
        valid = z["valid"]
        dtype = str(z["dtype"])
        if "linked" in z:
            # mmap mirrors: rows live in hardlinked files
            linked = json.loads(str(z["linked"]))
            srcs = {part: os.path.join(path, name)
                    for part, name in linked.items()}
            file_rows = int(z["file_rows"])
            if (dtype == m.dtype and m.mmap_backed
                    and m.valid.shape[0] == file_rows):
                # hardlink the files straight in: O(1) in corpus size
                m.adopt_checkpoint_files(srcs, n, deleted, valid)
                return
            # another dtype, geometry or a RAM mirror: read the files
            qdtype = np.int8 if dtype == "int8" else np.float32
            vec = np.memmap(srcs["vec"], dtype=qdtype, mode="r",
                            shape=(file_rows, m.dim))[:n]
            sq = np.memmap(srcs["sq"], dtype=np.float32, mode="r",
                           shape=(file_rows,))[:n]
            scale = (np.memmap(srcs["scale"], dtype=np.float32, mode="r",
                               shape=(file_rows,))[:n]
                     if "scale" in srcs else None)
        else:
            vec = z["vectors"]
            sq = z["sqnorms"]
            scale = z["scales"] if "scales" in z else None
        if dtype == m.dtype:
            m.load_raw(vec, scale, sq, valid, n, deleted)
        elif dtype == "int8":  # int8 checkpoint -> f32 mirror: dequantize
            f32 = (np.asarray(vec, np.float32)
                   * np.asarray(scale, np.float32)[:, None]) if n else vec
            m.load_f32(f32, valid, n, deleted)
        else:  # f32 checkpoint -> int8 mirror: vectorized quantize
            m.load_f32(np.asarray(vec, np.float32), valid, n, deleted)

    def load_ivf_packed(self):
        """The arrays of the newest checkpoint's ivf_packed.npz as a dict,
        or None. Loaded eagerly: an open NpzFile would pin a handle into
        the checkpoint directory past retention prunes."""
        path = self.latest()
        if path is None:
            return None
        p = os.path.join(path, "ivf_packed.npz")
        if not os.path.exists(p):
            return None
        try:
            with np.load(p) as z:
                return {k: z[k] for k in z.files}
        except (OSError, ValueError, KeyError, zipfile.BadZipFile):
            return None  # torn/corrupt extras never block recovery

    def load_ivf_warm(self):
        """(centroids, trained_live, mut_at_train, mut_at_ckpt,
        pq_codebooks | None, pq_rotation | None, pq_err) of the newest
        checkpoint, or None (no checkpoint, a flat engine's, or a torn
        file). Checkpoints without the mutation keys give 0 for them, and
        0.0 for a missing pq_err, as the reference reads them."""
        path = self.latest()
        if path is None:
            return None
        p = os.path.join(path, "ivf_warm.npz")
        if not os.path.exists(p):
            return None
        try:
            with np.load(p) as z:
                mt = int(z["mut_at_train"]) if "mut_at_train" in z else 0
                mc = int(z["mut_at_ckpt"]) if "mut_at_ckpt" in z else 0
                cb = np.array(z["pq_codebooks"]) if "pq_codebooks" in z \
                    else None
                rot = np.array(z["pq_rotation"]) if "pq_rotation" in z \
                    else None
                err = float(z["pq_err"]) if "pq_err" in z else 0.0
                return (np.array(z["centroids"]), int(z["trained_live"]),
                        mt, mc, cb, rot, err)
        except (OSError, ValueError, KeyError, zipfile.BadZipFile):
            return None  # torn/corrupt extras never block recovery
