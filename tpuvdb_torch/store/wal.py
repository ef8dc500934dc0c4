"""Write-ahead log: the port's copy of tpuvdb.store.wal.

The segment format is byte-identical to the reference's, so a WAL written
by either package replays in the other: msgpack segments (`wal_*.wal`)
framed as [u32 LE length][u32 LE crc32][msgpack bytes], or JSON lines
(`wal_*.log`). Record schema: {op, key, vector?, dim?, metadata?,
timestamp, seq}. A truncated trailing frame (crash mid-write) is dropped;
a CRC mismatch mid-file raises WalCorruption.

Append-only writes with optional fsync, a per-log lock, 10 MB rotation,
7-day retention, last-op-per-key replay past a checkpoint's LSN.

Two writers: a python file handle, or the native group-commit writer
(tpuvdb_torch.native.NativeWalWriter: one C++ thread writes and fsyncs for
every producer). backend="auto" takes the native writer when the library
builds, "native" raises when it does not. Either way an append returns
only once its bytes are written (and fsynced when `fsync` is on): the
native writer waits for its ticket whether or not it fsyncs, so an
acknowledged record is as durable as the python writer makes it.
"""

from __future__ import annotations

import glob
import heapq
import json
import os
import shutil
import struct
import threading
import time
import zlib
from typing import Any, Dict, Iterator, List, Optional

import msgpack
import numpy as np

from tpuvdb_torch.core import errors


def _now_ms() -> int:
    return int(time.time() * 1000)


class WriteAheadLog:
    def __init__(
        self,
        wal_dir: str,
        max_bytes: int = 10 * 1024 * 1024,
        retention_days: int = 7,
        fsync: bool = True,
        codec: str = "msgpack",
        backend: str = "auto",
    ):
        if codec not in ("msgpack", "jsonl"):
            raise ValueError(f"unknown WAL codec: {codec}")
        if backend not in ("python", "native", "auto"):
            raise ValueError(f"unknown WAL backend: {backend!r}")
        self._native = None
        if backend != "python":
            from tpuvdb_torch import native

            if backend == "native" or native.available():
                native.load()  # raises with the compiler's output
                self._native = native
        self.wal_dir = wal_dir
        self.max_bytes = max_bytes
        self.retention_days = retention_days
        self.fsync = fsync
        self.codec = codec
        self._lock = threading.Lock()
        self._fh = None
        self._cur_path: Optional[str] = None
        self._cur_bytes = 0
        os.makedirs(wal_dir, exist_ok=True)
        # monotonic log sequence number; checkpoints record the last LSN they
        # cover so tail replay is exact even when client timestamps are stale
        self._next_seq = self._scan_last_seq() + 1

    @property
    def backend(self) -> str:
        return "native" if self._native is not None else "python"

    def _seq_marker_path(self) -> str:
        return os.path.join(self.wal_dir, "last_seq")

    def _write_seq_marker_locked(self):
        """Persist the high-water LSN, so truncating every segment after a
        checkpoint and restarting never reuses sequence numbers the
        checkpoint already covers."""
        tmp = self._seq_marker_path() + ".tmp"
        with open(tmp, "w") as f:
            f.write(str(self.last_seq))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._seq_marker_path())

    def _scan_last_seq(self) -> int:
        """Best-effort on open: a corrupt segment must not brick the log.
        The persisted marker is the floor."""
        last = 0
        try:
            with open(self._seq_marker_path()) as f:
                last = int(f.read().strip() or 0)
        except (OSError, ValueError):
            pass
        for path in self._segments():
            try:
                for rec in self._iter_segment(path):
                    last = max(last, rec.get("seq", 0))
            except errors.WalCorruption:
                continue
        return last

    @property
    def last_seq(self) -> int:
        return self._next_seq - 1

    # ------------------------------------------------------------------ write

    def _ext(self) -> str:
        return ".wal" if self.codec == "msgpack" else ".log"

    def _open_segment(self):
        ts = _now_ms()
        path = os.path.join(self.wal_dir, f"wal_{ts}{self._ext()}")
        i = 0
        while os.path.exists(path):  # two rotations within 1 ms
            i += 1
            path = os.path.join(self.wal_dir, f"wal_{ts}_{i}{self._ext()}")
        if self._native is not None:
            self._fh = self._native.NativeWalWriter(path, fsync=self.fsync)
        else:
            self._fh = open(path, "ab", buffering=0)
        self._cur_path = path
        self._cur_bytes = 0

    def _encode(self, rec: Dict[str, Any]) -> bytes:
        if self.codec == "msgpack":
            body = msgpack.packb(rec, use_bin_type=True)
            crc = zlib.crc32(body) & 0xFFFFFFFF
            return struct.pack("<II", len(body), crc) + body
        return (json.dumps(rec, separators=(",", ":")) + "\n").encode("utf-8")

    def append(
        self,
        op: str,
        key: str,
        vector: Optional[np.ndarray] = None,
        metadata: Optional[Dict[str, str]] = None,
        timestamp: Optional[int] = None,
    ) -> int:
        """Append one record; returns its timestamp (ms)."""
        ts = timestamp if timestamp is not None else _now_ms()
        rec: Dict[str, Any] = {"op": op, "key": key, "timestamp": ts}
        if vector is not None:
            if self.codec == "msgpack":
                v = np.asarray(vector, dtype=np.float32)
                rec["vector"] = v.tobytes()
                rec["dim"] = int(v.shape[-1])
            else:
                rec["vector"] = [float(x) for x in np.asarray(vector).reshape(-1)]
        if metadata:
            rec["metadata"] = dict(metadata)
        with self._lock:
            rec["seq"] = self._next_seq
            self._next_seq += 1
            data = self._encode(rec)
            if self._fh is None or self._cur_bytes + len(data) > self.max_bytes:
                self._rotate_locked()
            self._write_locked(data)
        return ts

    def append_batch(self, records: List[Dict[str, Any]]) -> None:
        """Group-commit: encode all records, one write + one fsync."""
        if not records:
            return
        blobs = []
        for rec in records:
            r = dict(rec)
            r.setdefault("timestamp", _now_ms())
            v = r.get("vector")
            if v is not None and self.codec == "msgpack" and not isinstance(v, bytes):
                v = np.asarray(v, dtype=np.float32)
                r["dim"] = int(v.shape[-1])
                r["vector"] = v.tobytes()
            blobs.append(r)
        with self._lock:
            out = []
            for r in blobs:
                r["seq"] = self._next_seq
                self._next_seq += 1
                out.append(self._encode(r))
            data = b"".join(out)
            if self._fh is None or self._cur_bytes + len(data) > self.max_bytes:
                self._rotate_locked()
            self._write_locked(data)

    def _write_locked(self, data: bytes):
        if self._native is not None:
            self._fh.append_sync(data)  # group-commit write (+ fsync)
        else:
            self._fh.write(data)
            if self.fsync:
                os.fsync(self._fh.fileno())
        self._cur_bytes += len(data)

    def _rotate_locked(self):
        if self._fh is not None:
            self._fh.close()
        self._open_segment()
        self._gc_locked()

    def _gc_locked(self):
        """Drop segments older than the retention window."""
        self._write_seq_marker_locked()
        cutoff = time.time() - self.retention_days * 86400
        for path in self._segments():
            if path == self._cur_path:
                continue
            try:
                if os.path.getmtime(path) < cutoff:
                    os.remove(path)
            except OSError:
                pass

    # ------------------------------------------------------------------- read

    def _segments(self) -> List[str]:
        segs = glob.glob(os.path.join(self.wal_dir, "wal_*"))
        return sorted(segs)  # name embeds ms timestamp -> lexicographic == temporal

    def _iter_segment(self, path: str) -> Iterator[Dict[str, Any]]:
        if path.endswith(".log"):
            with open(path, "r", encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        yield json.loads(line)
                    except json.JSONDecodeError:
                        return  # torn tail line from a crash
        else:
            # streaming frame reads: iter_records holds every segment's
            # iterator open at once for the seq-merge
            with open(path, "rb") as f:
                off = 0
                while True:
                    head = f.read(8)
                    if len(head) < 8:
                        return
                    ln, crc = struct.unpack("<II", head)
                    body = f.read(ln)
                    if len(body) < ln:
                        return  # truncated trailing frame
                    if (zlib.crc32(body) & 0xFFFFFFFF) != crc:
                        raise errors.WalCorruption(
                            f"{path} @ {off}: crc mismatch")
                    try:
                        rec = msgpack.unpackb(body, raw=False)
                    except Exception as e:
                        raise errors.WalCorruption(f"{path} @ {off}: {e}")
                    yield rec
                    off += 8 + ln

    def iter_records(self, after_seq: Optional[int] = None) -> Iterator[Dict[str, Any]]:
        """All records in LSN order, optionally only those with seq >
        after_seq: a streaming k-way merge of the (individually
        seq-sorted) segments, O(segments) memory."""

        def seg(path):
            for rec in self._iter_segment(path):
                if after_seq is not None and rec.get("seq", 0) <= after_seq:
                    continue
                yield rec

        merged = heapq.merge(*(seg(p) for p in self._segments()),
                             key=lambda r: r.get("seq", 0))
        for rec in merged:
            yield self._decode_vector(rec)

    @staticmethod
    def _decode_vector(rec: Dict[str, Any]) -> Dict[str, Any]:
        v = rec.get("vector")
        if isinstance(v, bytes):
            rec = dict(rec)
            rec["vector"] = np.frombuffer(v, dtype=np.float32).copy()
        elif isinstance(v, list):
            rec = dict(rec)
            rec["vector"] = np.asarray(v, dtype=np.float32)
        return rec

    def replay(self, after_seq: Optional[int] = None) -> List[Dict[str, Any]]:
        """Deduped replay plan: the LAST op per key wins, in LSN order."""
        last: Dict[str, Dict[str, Any]] = {}
        for rec in self.iter_records(after_seq=after_seq):
            last[rec["key"]] = rec
        return sorted(last.values(), key=lambda r: r.get("seq", 0))

    # ------------------------------------------------------------------- misc

    def last_timestamp(self) -> int:
        ts = 0
        for rec in self.iter_records():
            ts = max(ts, rec.get("timestamp", 0))
        return ts

    def backup(self, dest_dir: str) -> List[str]:
        """Copy all segments to dest_dir."""
        os.makedirs(dest_dir, exist_ok=True)
        out = []
        with self._lock:
            for path in self._segments():
                dst = os.path.join(dest_dir, os.path.basename(path))
                shutil.copy2(path, dst)
                out.append(dst)
        return out

    def truncate_through(self, seq: int) -> int:
        """Remove whole segments whose records all have LSN <= seq
        (post-checkpoint GC). Returns number of segments removed. When seq
        covers every record written, the active segment is closed and
        removed too, and the next append starts a new one: a reopen then
        reads no record the checkpoint holds (the reference keeps the
        active segment, so one large batch stays in it until it rotates)."""
        removed = 0
        with self._lock:
            # marker BEFORE deletion: a crash in between must never let the
            # LSN counter regress below records a checkpoint covers
            self._write_seq_marker_locked()
            if self._fh is not None and self.last_seq <= seq:
                # every record of the active segment is covered: close and
                # remove it without reading it back
                self._fh.close()
                self._fh = None  # append opens the next segment
                os.remove(self._cur_path)
                self._cur_path = None
                removed += 1
            for path in self._segments():
                if path == self._cur_path:
                    continue
                try:
                    max_seq = max(
                        (r.get("seq", 0) for r in self._iter_segment(path)),
                        default=0,
                    )
                except errors.WalCorruption:
                    continue
                if max_seq <= seq:
                    os.remove(path)
                    removed += 1
        return removed

    def close(self):
        with self._lock:
            self._write_seq_marker_locked()
            if self._fh is not None:
                self._fh.close()
                self._fh = None
