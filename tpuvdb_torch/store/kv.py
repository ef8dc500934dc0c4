"""Host document store: key -> (shard, slot, metadata, timestamp).

The port's copy of tpuvdb.store.kv with the python dict backend only. The
forward map is a dict, the reverse map a dense per-shard slot->key list,
and an inverted metadata index serves filtered search.

Vector payloads live in the shard host mirrors (index/layout.py), not here,
so `get` reads host state only and never touches the device.

`load_native_file` keeps the pure-python reader of the reference's native
KV snapshot (`docstore.kv`), so a reference checkpoint written with the
native doc store restores here.
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


class DocStore:
    backend = "python"

    def __init__(self):
        self._lock = threading.RLock()
        self._docs: Dict[str, DocEntry] = {}
        # reverse map: shard -> list where index==slot, value==key or None
        self._slots: Dict[int, List[Optional[str]]] = {}
        # inverted metadata index: field -> value -> {(shard, slot)}
        self._meta: Dict[str, Dict[str, Set[Tuple[int, int]]]] = {}

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
            prev = self._docs.get(entry.key)
            self._docs[entry.key] = entry
            slots = self._slots.setdefault(entry.shard, [])
            if entry.slot >= len(slots):
                slots.extend([None] * (entry.slot + 1 - len(slots)))
            slots[entry.slot] = entry.key
            if prev is not None:
                self._meta_remove(prev)
                if (prev.shard, prev.slot) != (entry.shard, entry.slot):
                    pslots = self._slots.get(prev.shard)
                    if pslots and prev.slot < len(pslots) and pslots[prev.slot] == entry.key:
                        pslots[prev.slot] = None
            self._meta_add(entry)
            return prev

    def put_many(self, entries: List[DocEntry]) -> List[Optional[Tuple[int, int]]]:
        """Bulk insert/overwrite; returns per entry the PREVIOUS (shard,
        slot) placement of its key, or None for new keys (the engine
        soft-deletes those slots)."""
        with self._lock:
            out: List[Optional[Tuple[int, int]]] = []
            for e in entries:
                prev = self.put(e)
                out.append(None if prev is None else (prev.shard, prev.slot))
            return out

    def get(self, key: str) -> Optional[DocEntry]:
        with self._lock:
            return self._docs.get(key)

    def delete(self, key: str) -> Optional[DocEntry]:
        with self._lock:
            e = self._docs.pop(key, None)
            if e is not None:
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
        """Bool array: does each (shard, slot) map to a live key?"""
        with self._lock:
            out = np.zeros(len(shards), bool)
            for i, (sh, sl) in enumerate(zip(shards, slots)):
                lst = self._slots.get(int(sh))
                out[i] = (lst is not None and sl < len(lst)
                          and lst[sl] is not None)
            return out

    def key_at(self, shard: int, slot: int) -> Optional[str]:
        """O(1) reverse lookup."""
        with self._lock:
            slots = self._slots.get(shard)
            if slots is None or slot >= len(slots):
                return None
            return slots[slot]

    def export_snapshot(self):
        """Consistent snapshot (the live DocEntry refs) for compaction;
        decode with snapshot_columns()."""
        with self._lock:
            return list(self._docs.values())

    @staticmethod
    def snapshot_columns(snap):
        """(keys list, shards i32, slots i64, tss i64, metadatas list)."""
        n = len(snap)
        shards = np.fromiter((e.shard for e in snap), np.int32, n)
        slots = np.fromiter((e.slot for e in snap), np.int64, n)
        tss = np.fromiter((e.timestamp for e in snap), np.int64, n)
        return ([e.key for e in snap], shards, slots, tss,
                [e.metadata for e in snap])

    @staticmethod
    def snapshot_shard_slots(snap):
        """(shards i32, slots i64) only."""
        n = len(snap)
        return (np.fromiter((e.shard for e in snap), np.int32, n),
                np.fromiter((e.slot for e in snap), np.int64, n))

    def keys_rows(self, rows, phys_cap: int, row: int = 0):
        """Liveness + key resolution over FLAT global row ids (shard = row
        // phys_cap, slot = row % phys_cap; negative = pad) in one lock
        acquisition. Returns (keys, n_missing); with row > 0 the keys come
        back as row-sized inner lists. n_missing == 0 certifies every row
        resolved live."""
        with self._lock:
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
        """Vectorized key_at over parallel (shard, slot) sequences."""
        with self._lock:
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
        return len(self._docs)

    def __contains__(self, key: str) -> bool:
        return self.get(key) is not None

    def keys(self) -> List[str]:
        with self._lock:
            return list(self._docs.keys())

    def entries(self) -> Iterator[DocEntry]:
        with self._lock:
            return iter(list(self._docs.values()))

    # ---------------------------------------------------------- serialization

    def dump(self, path: str) -> None:
        with self._lock:
            payload = {
                "docs": [
                    (e.key, e.shard, e.slot, e.metadata, e.timestamp)
                    for e in self._docs.values()
                ]
            }
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(msgpack.packb(payload, use_bin_type=True))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "DocStore":
        store = cls()
        with open(path, "rb") as f:
            payload = msgpack.unpackb(f.read(), raw=False)
        for key, shard, slot, metadata, ts in payload["docs"]:
            store.put(DocEntry(key=key, shard=shard, slot=slot,
                               metadata=dict(metadata), timestamp=ts))
        return store

    @classmethod
    def load_native_file(cls, path: str) -> "DocStore":
        """Restore from the reference's native KV snapshot (docstore.kv)."""
        store = cls()
        for key, shard, slot, ts, blob in _iter_kv_dump(path):
            md = msgpack.unpackb(blob, raw=False) if blob else {}
            store.put(DocEntry(key=key, shard=shard, slot=slot,
                               metadata=md, timestamp=ts))
        return store


def _iter_kv_dump(path: str):
    """Reader of the native KV snapshot format
    (tpuvdb/native/src/tpuvdb_native.cpp kv_dump): [u64 count] then per
    entry [u32 klen][key][i32 shard][i64 slot][i64 ts][u32 vlen][val]."""
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
