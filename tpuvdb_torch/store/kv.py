"""Host document store: key -> (shard, slot, metadata, timestamp).

The port's copy of tpuvdb.store.kv. The forward map has two backends:
  * "python": a dict of DocEntry, with a dense per-shard slot->key list as
    the reverse map;
  * "native": the C++ open-addressing store (tpuvdb_torch.native.NativeKv),
    metadata packed as msgpack blobs in its arena, with its own (shard,
    slot) -> key table in C++ and key lists built by fastlist.
"auto" is native when the native library builds, python otherwise (the
reference's meaning); an explicit "native" raises NativeBuildError with
the compiler's output when it does not build. An inverted metadata index
serves filtered search on both.

Vector payloads live in the shard host mirrors (index/layout.py), not here,
so `get` reads host state only and never touches the device.

Snapshots are the reference's: `dump` writes docstore.msgpack,
`dump_native` / `snapshot_native_mem` the native binary docstore.kv, and
`load_native_file` reads docstore.kv through the C++ loader on the native
backend or a python reader of the same format otherwise.
"""

from __future__ import annotations

import dataclasses
import os
import struct
import threading
from typing import Dict, Iterator, List, Optional, Set, Tuple

import msgpack
import numpy as np


@dataclasses.dataclass
class DocEntry:
    key: str
    shard: int
    slot: int  # slot index within the shard
    metadata: Dict[str, str]
    timestamp: int


def _native_kv(backend: str):
    """A NativeKv for "native" (raising if the library does not build) or
    for "auto" when it builds; None for the python dict."""
    if backend not in ("python", "native", "auto"):
        raise ValueError(f"unknown docstore_backend: {backend!r}")
    if backend == "python":
        return None
    from tpuvdb_torch import native

    if backend == "auto" and not native.available():
        return None
    return native.NativeKv()


def _unpack_md(blob: bytes) -> Dict[str, str]:
    return msgpack.unpackb(blob, raw=False) if blob else {}


def _pack_md(md: Dict[str, str]) -> bytes:
    return msgpack.packb(md, use_bin_type=True) if md else b""


class DocStore:
    def __init__(self, backend: str = "auto"):
        self._lock = threading.RLock()
        self._native = _native_kv(backend)
        self._docs: Dict[str, DocEntry] = {}
        # reverse map (python backend): shard -> list where index==slot,
        # value==key or None
        self._slots: Dict[int, List[Optional[str]]] = {}
        # inverted metadata index: field -> value -> {(shard, slot)}
        self._meta: Dict[str, Dict[str, Set[Tuple[int, int]]]] = {}

    @property
    def backend(self) -> str:
        return "native" if self._native is not None else "python"

    # -------------------------------------------------- forward-map plumbing

    def _map_get(self, key: str) -> Optional[DocEntry]:
        if self._native is not None:
            got = self._native.get(key)
            if got is None:
                return None
            shard, slot, ts, blob = got
            return DocEntry(key=key, shard=shard, slot=slot,
                            metadata=_unpack_md(blob), timestamp=ts)
        return self._docs.get(key)

    def _map_iter(self) -> Iterator[DocEntry]:
        if self._native is not None:
            for key, shard, slot, ts, blob in self._native.items():
                yield DocEntry(key=key, shard=shard, slot=slot,
                               metadata=_unpack_md(blob), timestamp=ts)
        else:
            yield from self._docs.values()

    def _meta_add(self, e: DocEntry):
        for k, v in e.metadata.items():
            self._meta.setdefault(k, {}).setdefault(v, set()).add((e.shard, e.slot))

    def _meta_remove(self, e: DocEntry):
        for k, v in e.metadata.items():
            vals = self._meta.get(k)
            if not vals:
                continue
            s = vals.get(v)
            if s is not None:
                s.discard((e.shard, e.slot))
                if not s:
                    del vals[v]
            if not vals:
                self._meta.pop(k, None)

    # ------------------------------------------------------------------- ops

    def put(self, entry: DocEntry) -> Optional[DocEntry]:
        """Insert/overwrite. Returns the previous entry for this key, if any."""
        with self._lock:
            prev = self._map_get(entry.key)
            if self._native is not None:
                # the C++ store keeps its own (shard, slot) -> key table
                self._native.put(entry.key, entry.shard, entry.slot,
                                 entry.timestamp, _pack_md(entry.metadata))
            else:
                self._docs[entry.key] = entry
                slots = self._slots.setdefault(entry.shard, [])
                if entry.slot >= len(slots):
                    slots.extend([None] * (entry.slot + 1 - len(slots)))
                slots[entry.slot] = entry.key
            if prev is not None:
                self._meta_remove(prev)
                if (self._native is None
                        and (prev.shard, prev.slot) != (entry.shard, entry.slot)):
                    pslots = self._slots.get(prev.shard)
                    if pslots and prev.slot < len(pslots) and pslots[prev.slot] == entry.key:
                        pslots[prev.slot] = None
            self._meta_add(entry)
            return prev

    def put_many(self, entries: List[DocEntry]) -> List[Optional[Tuple[int, int]]]:
        """Bulk insert/overwrite; returns per entry the PREVIOUS (shard,
        slot) placement of its key, or None for new keys (the engine
        soft-deletes those slots). On the native backend with an empty
        metadata index and no key twice in the batch this is ONE FFI
        crossing for the whole batch."""
        with self._lock:
            dup_free = len({e.key for e in entries}) == len(entries)
            if self._native is not None and not self._meta and dup_free:
                prevs = self._native.put_many(
                    [e.key for e in entries], [e.shard for e in entries],
                    [e.slot for e in entries],
                    [e.timestamp for e in entries],
                    [_pack_md(e.metadata) for e in entries])
                # the index was empty, so no overwritten predecessor carried
                # metadata: only additions to index
                for e in entries:
                    if e.metadata:
                        self._meta_add(e)
                return [None if ps < 0 else (ps, pl) for ps, pl in prevs]
            out: List[Optional[Tuple[int, int]]] = []
            for e in entries:
                prev = self.put(e)
                out.append(None if prev is None else (prev.shard, prev.slot))
            return out

    def put_rows_bulk(self, keys: List[str], shard: int, first_slot: int):
        """Columnar ingest fast path: metadata-free entries at consecutive
        slots in one FFI crossing. Returns (prev_shards, prev_slots) with -1
        = new key, or None when the fast path does not apply (python
        backend, or a non-empty metadata index: an overwritten predecessor
        might carry metadata that must leave the index)."""
        with self._lock:
            if self._native is None or self._meta:
                return None
            n = len(keys)
            return self._native.put_many(
                keys, np.full(n, shard, np.int32),
                np.arange(first_slot, first_slot + n, dtype=np.int64),
                np.zeros(n, np.int64), values=None, raw=True)

    def get(self, key: str) -> Optional[DocEntry]:
        with self._lock:
            return self._map_get(key)

    def delete(self, key: str) -> Optional[DocEntry]:
        with self._lock:
            e = self._map_get(key)
            if e is not None:
                if self._native is not None:
                    self._native.delete(key)
                else:
                    del self._docs[key]
                    slots = self._slots.get(e.shard)
                    if slots and e.slot < len(slots) and slots[e.slot] == key:
                        slots[e.slot] = None
                self._meta_remove(e)
            return e

    def find_by_metadata(self, flt: Dict[str, str]) -> Optional[Set[Tuple[int, int]]]:
        """(shard, slot) set matching ALL field=value pairs; None = no filter."""
        if not flt:
            return None
        with self._lock:
            sets = []
            for k, v in flt.items():
                s = self._meta.get(k, {}).get(v)
                if not s:
                    return set()
                sets.append(s)
            sets.sort(key=len)
            out = set(sets[0])
            for s in sets[1:]:
                out &= s
            return out

    def slots_live(self, shards, slots) -> np.ndarray:
        """Bool array: does each (shard, slot) map to a live key? No
        strings materialize."""
        with self._lock:
            if self._native is not None:
                return self._native.slots_live(shards, slots)
            out = np.zeros(len(shards), bool)
            for i, (sh, sl) in enumerate(zip(shards, slots)):
                lst = self._slots.get(int(sh))
                out[i] = (lst is not None and sl < len(lst)
                          and lst[sl] is not None)
            return out

    def key_at(self, shard: int, slot: int) -> Optional[str]:
        """O(1) reverse lookup."""
        with self._lock:
            if self._native is not None:
                return self._native.key_at(shard, slot)
            slots = self._slots.get(shard)
            if slots is None or slot >= len(slots):
                return None
            return slots[slot]

    def export_snapshot(self):
        """Consistent snapshot of all entries for a caller holding the
        engine lock (compaction): ("packed", buffers) in one memcpy-speed
        FFI crossing on the native backend, ("entries", DocEntry list) on
        the python one. Decode with snapshot_columns() off the lock."""
        with self._lock:
            if self._native is not None:
                return ("packed", self._native.export_packed())
            return ("entries", list(self._docs.values()))

    @staticmethod
    def snapshot_columns(snap):
        """(keys list, shards i32, slots i64, tss i64, metadatas list) from
        an export_snapshot(), run OUTSIDE the engine lock."""
        kind, data = snap
        if kind == "packed":
            from tpuvdb_torch.native import NativeKv

            keys = NativeKv.decode_keys(data["keys_blob"], data["key_lens"])
            val_lens = data["val_lens"]
            n = len(keys)
            if int(val_lens.sum()) == 0:
                mds: List[Dict[str, str]] = [{} for _ in range(n)]
            else:
                blob = data["vals_blob"]
                offs = np.zeros(n + 1, np.int64)
                np.cumsum(val_lens, out=offs[1:])
                mds = [_unpack_md(blob[offs[i]:offs[i + 1]])
                       for i in range(n)]
            return (keys, data["shards"], data["slots"], data["tss"], mds)
        n = len(data)
        shards = np.fromiter((e.shard for e in data), np.int32, n)
        slots = np.fromiter((e.slot for e in data), np.int64, n)
        tss = np.fromiter((e.timestamp for e in data), np.int64, n)
        return ([e.key for e in data], shards, slots, tss,
                [e.metadata for e in data])

    @staticmethod
    def snapshot_shard_slots(snap):
        """(shards i32, slots i64) only: compaction plans the mirror copy
        without decoding a key."""
        kind, data = snap
        if kind == "packed":
            return data["shards"], data["slots"]
        n = len(data)
        return (np.fromiter((e.shard for e in data), np.int32, n),
                np.fromiter((e.slot for e in data), np.int64, n))

    def load_packed_remapped(self, snap, new_slots) -> bool:
        """Compaction fast path: reinsert a packed snapshot with remapped
        slots in ONE FFI crossing (the blobs pass through verbatim), then
        index the entries that carry metadata. False when it does not
        apply (python backend or an entry-list snapshot)."""
        kind, data = snap
        if kind != "packed" or self._native is None:
            return False
        with self._lock:
            self._native.put_packed(
                data["keys_blob"], data["key_lens"], data["shards"],
                new_slots, data["tss"], data["vals_blob"], data["val_lens"])
            val_lens = data["val_lens"]
            if int(val_lens.sum()):
                keys, shards, _, tss, mds = self.snapshot_columns(snap)
                for i in np.flatnonzero(val_lens).tolist():
                    self._meta_add(DocEntry(
                        key=keys[i], shard=int(shards[i]),
                        slot=int(new_slots[i]), metadata=mds[i],
                        timestamp=int(tss[i])))
        return True

    def keys_rows(self, rows, phys_cap: int, row: int = 0):
        """Liveness + key resolution over FLAT global row ids (shard = row
        // phys_cap, slot = row % phys_cap; negative = pad) in one lock
        acquisition, and on the native backend one FFI crossing. Returns
        (keys, n_missing); with row > 0 the keys come back as row-sized
        inner lists. n_missing == 0 certifies every row resolved live."""
        with self._lock:
            if self._native is not None:
                return self._native.rows_keys(rows, phys_cap, row)
            out: List[Optional[str]] = []
            miss = 0
            for r in rows:
                r = int(r)
                if r < 0:
                    out.append(None)
                    miss += 1
                    continue
                lst = self._slots.get(r // phys_cap)
                sl = r % phys_cap
                key = lst[sl] if lst is not None and sl < len(lst) else None
                if key is None:
                    miss += 1
                out.append(key)
            if row > 0 and len(out) % row == 0:
                out = [out[i:i + row] for i in range(0, len(out), row)]
            return out, miss

    def keys_at_bulk(self, shards, slots) -> List[Optional[str]]:
        """Vectorized key_at over parallel (shard, slot) sequences: one
        lock acquisition (and one FFI crossing on the native backend)."""
        with self._lock:
            if self._native is not None:
                return self._native.keys_at(shards, slots)
            out: List[Optional[str]] = []
            cache_sh = -1
            cache_lst: Optional[List[Optional[str]]] = None
            for sh, sl in zip(shards, slots):
                if sh != cache_sh:
                    cache_sh = sh
                    cache_lst = self._slots.get(sh)
                out.append(cache_lst[sl]
                           if cache_lst is not None and sl < len(cache_lst)
                           else None)
            return out

    def __len__(self) -> int:
        if self._native is not None:
            return len(self._native)
        return len(self._docs)

    def __contains__(self, key: str) -> bool:
        return self.get(key) is not None

    def keys(self) -> List[str]:
        with self._lock:
            return [e.key for e in self._map_iter()]

    def entries(self) -> Iterator[DocEntry]:
        with self._lock:
            return iter(list(self._map_iter()))

    # ---------------------------------------------------------- serialization

    def dump(self, path: str) -> None:
        with self._lock:
            payload = {
                "docs": [
                    (e.key, e.shard, e.slot, e.metadata, e.timestamp)
                    for e in self._map_iter()
                ]
            }
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(msgpack.packb(payload, use_bin_type=True))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str, backend: str = "auto") -> "DocStore":
        store = cls(backend=backend)
        with open(path, "rb") as f:
            payload = msgpack.unpackb(f.read(), raw=False)
        for key, shard, slot, metadata, ts in payload["docs"]:
            store.put(DocEntry(key=key, shard=shard, slot=slot,
                               metadata=dict(metadata), timestamp=ts))
        return store

    # ------------------------------------------------ native binary snapshots

    def dump_native(self, path: str) -> None:
        """C++ binary snapshot (docstore.kv) written straight to disk by
        the native store. Only valid on the native backend."""
        if self._native is None:
            raise RuntimeError("dump_native requires the native backend")
        with self._lock:
            if not self._native.dump(path):
                raise OSError(f"native docstore dump failed: {path}")

    def snapshot_native_mem(self):
        """Consistent in-memory snapshot of the native table (docstore.kv's
        format), at memory speed under the locks: the engine holds its
        serving lock only for the memcpy and writes the buffer off-lock.
        Returns a holder: write .view(), then .release()."""
        if self._native is None:
            raise RuntimeError(
                "snapshot_native_mem requires the native backend")
        with self._lock:
            return self._native.dump_mem()

    @classmethod
    def load_native_file(cls, path: str, backend: str = "auto") -> "DocStore":
        """Restore from a docstore.kv snapshot: the C++ loader parses it on
        the native backend, a python reader of the same format fills a
        python store otherwise (the reference's checkpoints restore with
        either)."""
        store = cls(backend=backend)
        if store._native is not None:
            if not store._native.load(path):
                raise OSError(f"native docstore load failed: {path}")
            # the C++ loader rebuilt its reverse table; only the metadata
            # index needs a python pass, when an entry carries metadata
            if store._native.nonempty_vals():
                with store._lock:
                    for e in store._map_iter():
                        if e.metadata:
                            store._meta_add(e)
            return store
        for key, shard, slot, ts, blob in _iter_kv_dump(path):
            store.put(DocEntry(key=key, shard=shard, slot=slot,
                               metadata=_unpack_md(blob), timestamp=ts))
        return store


def _iter_kv_dump(path: str):
    """Reader of the native KV snapshot format (native/src/tpuvdb_native.cpp
    kv_dump): [u64 count] then per entry [u32 klen][key][i32 shard]
    [i64 slot][i64 ts][u32 vlen][val]."""
    with open(path, "rb") as f:
        hdr = f.read(8)
        if len(hdr) < 8:
            return
        (count,) = struct.unpack("<Q", hdr)
        for _ in range(count):
            kl = f.read(4)
            if len(kl) < 4:
                return
            (klen,) = struct.unpack("<I", kl)
            key = f.read(klen).decode()
            rest = f.read(24)
            if len(rest) < 24:
                return
            shard, slot, ts, vlen = struct.unpack("<iqqI", rest)
            val = f.read(vlen)
            yield key, shard, slot, ts, val
