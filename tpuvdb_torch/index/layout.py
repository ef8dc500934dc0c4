"""Shard memory layout: the port's copy of tpuvdb.index.layout.

Host side: one `ShardMirror` per logical shard — a growable (capacity, dim)
row store plus a validity mask and an append-only slot allocator. The
mirror is the durable source of truth: checkpoints serialize it and the
device buffers are derived from it.

`StackedLayout` gives the same row ids as the reference (row = shard *
phys_cap + slot), so device rows map 1:1 between the two packages.

dtype="int8" mirrors store quantized rows with a per-row dequant scale and
the squared norm of the DEQUANTIZED row; `vector_at`/`rows_f32` dequantize
on read.

path=... keeps the rows in mmap'd vector files (the native VectorFile,
tpuvdb_torch/native) preallocated sparse at full capacity, named and laid
out as the reference's: growth is a watermark bump, host RSS is the touched
pages, and checkpoints hardlink the files instead of copying them.
`rescore_into` runs the native fused exact rescore over the stored rows.

Slot rows are append-only and immutable once written (overwrite = fresh
slot + soft delete), which makes zero-copy checkpoint views consistent.
Slots are never reused until compaction rebuilds the mirror densely.
"""

from __future__ import annotations

import dataclasses
import math
import os
import shutil
import uuid
from typing import Dict, List, Optional, Tuple

import numpy as np

from tpuvdb_torch.core import errors


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def quantize_block(vecs: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(q int8, scales f32, sq f32 of the DEQUANTIZED rows) for f32 rows."""
    vecs = np.asarray(vecs, np.float32)
    absmax = np.abs(vecs).max(axis=-1)
    scales = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.rint(vecs / scales[:, None]), -127, 127).astype(np.int8)
    qf = q.astype(np.float32)
    sq = (np.einsum("nd,nd->n", qf, qf) * scales * scales).astype(np.float32)
    return q, scales, sq


class _VecFile:
    """One mmap'd row store on the native VectorFile. Never explicitly
    unmapped: an off-lock checkpoint writer may hold a view after the
    owning mirror was swapped away, so the mapping goes when the last
    reference does (unlinking the path while mapped is safe on POSIX)."""

    def __init__(self, path: str, rows: int, dtype, cols: int):
        from tpuvdb_torch import native

        self.path = path
        self.rows = rows
        self._native = native.NativeVectorFile(
            path, rows, cols * np.dtype(dtype).itemsize)
        self.arr = self._native.as_array(dtype, cols)

    def flush(self):
        if not self._native.flush():
            raise OSError(f"msync failed: {self.path}")

    def __del__(self):
        native = getattr(self, "_native", None)
        if native is not None:
            native.close()


class ShardMirror:
    def __init__(
        self,
        dim: int,
        capacity: int,
        init_cap: int = 16384,
        block: int = 128,
        dtype: str = "float32",
        path: Optional[str] = None,
    ):
        """path=None keeps rows in RAM; otherwise rows live in mmap files
        `{path}_g<uuid>.{vec,scale,sq}` preallocated (sparse) at full
        capacity, so growth never copies and checkpoints hardlink."""
        self.dim = dim
        self.capacity = capacity  # logical max slots
        self.block = block
        self.dtype = dtype
        self.quantized = dtype == "int8"
        self._qdtype = np.int8 if self.quantized else np.float32
        self.path_prefix = path
        self.file_paths: Dict[str, str] = {}
        self._files: Dict[str, _VecFile] = {}
        init = min(_round_up(init_cap, block), _round_up(capacity, block))
        if path is None:
            self._vec = np.zeros((init, dim), dtype=self._qdtype)
            self._scale = np.ones(init, np.float32) if self.quantized else None
            self._sq = np.zeros(init, np.float32)
            self.valid = np.zeros(init, dtype=bool)
        else:
            self._open_files(link_from=None)
            # validity stays in RAM (1 byte a row), sized as the files
            self.valid = np.zeros(_round_up(capacity, block), dtype=bool)
        self._phys = init
        self.next_slot = 0
        self.deleted = 0

    # ------------------------------------------------------------- mmap files

    @property
    def mmap_backed(self) -> bool:
        return self.path_prefix is not None

    def _open_files(self, link_from: Optional[Dict[str, str]]):
        """Create (or hardlink from a checkpoint) this mirror's files under
        a fresh generation name and map them at full capacity. A hardlinked
        restore shares the immutable [:n) prefix with the checkpoint;
        appends touch rows past every snapshot's recorded watermark."""
        os.makedirs(os.path.dirname(self.path_prefix), exist_ok=True)
        full = _round_up(self.capacity, self.block)
        base = f"{self.path_prefix}_g{uuid.uuid4().hex[:10]}"
        parts = ("vec", "sq", "scale") if self.quantized else ("vec", "sq")
        self.file_paths = {part: f"{base}.{part}" for part in parts}
        if link_from:
            for part, dst in self.file_paths.items():
                src = link_from.get(part)
                if src is None:
                    raise errors.CheckpointError(
                        f"checkpoint missing mirror file part {part!r}")
                try:
                    os.link(src, dst)
                except OSError:  # another file system: copy
                    shutil.copyfile(src, dst)
        self._files = {
            "vec": _VecFile(self.file_paths["vec"], full, self._qdtype,
                            self.dim),
            "sq": _VecFile(self.file_paths["sq"], full, np.float32, 1),
        }
        self._vec = self._files["vec"].arr
        self._sq = self._files["sq"].arr.reshape(-1)
        self._scale = None
        if self.quantized:
            self._files["scale"] = _VecFile(self.file_paths["scale"], full,
                                            np.float32, 1)
            self._scale = self._files["scale"].arr.reshape(-1)

    def flush_files(self):
        """msync the mmap files (no-op for RAM mirrors): called before a
        checkpoint hardlinks them."""
        for f in self._files.values():
            f.flush()

    def unlink_files(self):
        """Remove this mirror's directory entries (compaction swapped it
        out). The mapping stays valid for any live view until GC."""
        for p in self.file_paths.values():
            try:
                os.unlink(p)
            except FileNotFoundError:
                pass

    # -------------------------------------------------------------- allocator

    @property
    def phys_cap(self) -> int:
        return self._phys

    def used(self) -> int:
        return self.next_slot

    def live(self) -> int:
        return self.next_slot - self.deleted

    def _grow_to(self, n: int):
        new_cap = self._phys
        while new_cap < n:
            new_cap *= 2
        new_cap = min(_round_up(new_cap, self.block),
                      _round_up(self.capacity, self.block))
        if new_cap < n:
            raise errors.CapacityExceeded(
                f"shard full: {n} > capacity {self.capacity}")
        if self.mmap_backed:
            # the files are preallocated at full capacity
            self._phys = new_cap
            return
        v = np.zeros((new_cap, self.dim), dtype=self._qdtype)
        v[: self._phys] = self._vec
        sq = np.zeros(new_cap, np.float32)
        sq[: self._phys] = self._sq
        m = np.zeros(new_cap, dtype=bool)
        m[: self._phys] = self.valid
        if self.quantized:
            sc = np.ones(new_cap, np.float32)
            sc[: self._phys] = self._scale
            self._scale = sc
        self._vec, self._sq, self.valid = v, sq, m
        self._phys = new_cap

    def alloc(self, n: int = 1) -> int:
        """Reserve n consecutive slots; returns the first slot."""
        if self.next_slot + n > self.capacity:
            raise errors.CapacityExceeded(
                f"shard full: {self.next_slot + n} > capacity {self.capacity}")
        if self.next_slot + n > self._phys:
            self._grow_to(self.next_slot + n)
        first = self.next_slot
        self.next_slot += n
        return first

    # ------------------------------------------------------------- row access

    def write(self, slot: int, vec: np.ndarray):
        self.write_batch(slot, np.asarray(vec, np.float32)[None, :])

    def write_batch(self, first_slot: int, vecs: np.ndarray):
        """Vectorized write of consecutive slots [first_slot, +n)."""
        vecs = np.asarray(vecs, np.float32)
        sl = slice(first_slot, first_slot + vecs.shape[0])
        if self.quantized:
            q, scales, sq = quantize_block(vecs)
            self._vec[sl] = q
            self._scale[sl] = scales
            self._sq[sl] = sq
        else:
            self._vec[sl] = vecs
            self._sq[sl] = np.einsum("nd,nd->n", vecs, vecs)
        self.valid[sl] = True

    def write_raw_batch(self, first_slot: int, vec, scale, sq):
        """Bulk write of rows already in this mirror's stored dtype (pairs
        with rows_raw; compaction copies int8 codes bit-exactly)."""
        sl = slice(first_slot, first_slot + len(vec))
        self._vec[sl] = vec
        self._sq[sl] = np.asarray(sq).reshape(-1)
        if self.quantized:
            self._scale[sl] = np.asarray(scale).reshape(-1)
        self.valid[sl] = True

    def mark_deleted(self, slot: int):
        if self.valid[slot]:
            self.valid[slot] = False
            self.deleted += 1

    def vector_at(self, slot: int) -> np.ndarray:
        """The stored row as f32 (dequantized for int8 mirrors)."""
        if self.quantized:
            return self._vec[slot].astype(np.float32) * self._scale[slot]
        return np.asarray(self._vec[slot], np.float32)

    def rows_f32(self, slots: np.ndarray) -> np.ndarray:
        """Bulk rows as f32 (one fancy-index gather)."""
        if self.quantized:
            return (self._vec[slots].astype(np.float32)
                    * np.asarray(self._scale[slots])[:, None])
        return np.asarray(self._vec[slots], np.float32)

    def rescore_into(self, q: np.ndarray, qsq: np.ndarray, fetch_w: int,
                     slots: np.ndarray, opos: np.ndarray, out: np.ndarray):
        """Native fused exact rescore over this mirror's stored rows:
        out[opos] = |q[opos // fetch_w] - stored row|^2, each int8/f32 row
        read once and its precomputed ||v||^2 reused (no (n, d) f32
        gather). The caller pre-fills out with +inf."""
        from tpuvdb_torch import native

        native.rescore_rows(q, qsq, fetch_w, self._vec,
                            self._scale if self.quantized else None,
                            self._sq, slots, opos, out)

    def rows_raw(self, slots: np.ndarray):
        """Bulk rows in the STORED dtype: (codes, scales|None, sq)."""
        return (self._vec[slots],
                np.asarray(self._scale[slots]) if self.quantized else None,
                np.asarray(self._sq[slots]))

    def prefix_f32(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(rows f32, sq, valid) of the written prefix [:next_slot) — views
        for f32 mirrors, a dequantized copy for int8 ones."""
        n = self.next_slot
        vec = self._vec[:n]
        if self.quantized:
            vec = vec.astype(np.float32) * self._scale[:n, None]
        return vec, self._sq[:n], self.valid[:n]

    def prefix_raw(self):
        """(rows, scales|None, sq, valid) views of the written prefix in the
        STORED dtype: int8 mirrors hand their codes and scales to an int8
        device index bit-exactly (the reference's raw_range)."""
        n = self.next_slot
        return (self._vec[:n], self._scale[:n] if self.quantized else None,
                self._sq[:n], self.valid[:n])

    def is_valid(self, slot: int) -> bool:
        return bool(self.valid[slot]) if slot < self._phys else False

    # ------------------------------------------------------------ checkpoints

    def checkpoint_snapshot(self) -> dict:
        """Snapshot descriptor captured under the engine lock (views + a
        copy of the small validity prefix). Rows [:n) are immutable, so the
        views stay correct while the caller writes them with the lock
        released; `store_ref` keeps an mmap mirror's mapping alive across a
        concurrent compaction swap."""
        n = self.next_slot
        return {
            "dtype": self.dtype,
            "n": n,
            "deleted": self.deleted,
            "valid": self.valid[:n].copy(),
            "vec": self._vec[:n],
            "scale": self._scale[:n] if self.quantized else None,
            "sq": self._sq[:n],
            "mmap_paths": dict(self.file_paths) if self.mmap_backed else None,
            "store_ref": self,
        }

    def load_raw(self, vec, scale, sq, valid, n: int, deleted: int):
        """Restore rows stored in THIS mirror's dtype. Copies [:n)."""
        if n:
            if n > self._phys:
                self._grow_to(n)
            self._vec[:n] = vec
            self._sq[:n] = np.asarray(sq).reshape(-1)
            if self.quantized:
                self._scale[:n] = np.asarray(scale).reshape(-1)
            self.valid[:n] = valid
        self.next_slot = n
        self.deleted = deleted

    def load_f32(self, vecs: np.ndarray, valid, n: int, deleted: int):
        """Restore from f32 rows (cross-dtype checkpoint)."""
        if n:
            if n > self._phys:
                self._grow_to(n)
            self.write_batch(0, vecs[:n])
            self.valid[:n] = valid
        self.next_slot = n
        self.deleted = deleted

    def adopt_checkpoint_files(self, link_from: Dict[str, str], n: int,
                               deleted: int, valid) -> None:
        """mmap -> mmap restore without copying: hardlink a checkpoint's
        row files in as this mirror's backing store (same dtype and
        geometry, checked by the caller)."""
        self.unlink_files()  # the empty files __init__ created
        self._open_files(link_from=link_from)
        if n > self._phys:
            self._grow_to(n)
        self.valid[:n] = valid
        self.next_slot = n
        self.deleted = deleted


@dataclasses.dataclass
class StackedLayout:
    """Geometry of the stacked device row space."""

    num_shards: int
    phys_cap: int  # common physical capacity per shard (rows)
    dim: int

    @property
    def total_rows(self) -> int:
        return self.num_shards * self.phys_cap

    def row_of(self, shard: int, slot: int) -> int:
        return shard * self.phys_cap + slot

    def shard_slot_of(self, row: int) -> Tuple[int, int]:
        return row // self.phys_cap, row % self.phys_cap

    @classmethod
    def for_mirrors(
        cls,
        mirrors: List[ShardMirror],
        block: int,
        min_rows_multiple: int = 1,
    ) -> "StackedLayout":
        """Common phys_cap = max mirror phys_cap, rounded so the stacked row
        count is a multiple of block and of min_rows_multiple — the
        reference's rule, kept so row ids agree."""
        num = len(mirrors)
        dim = mirrors[0].dim
        cap = max(m.phys_cap for m in mirrors)
        L = block * min_rows_multiple
        step = L // math.gcd(num, L)
        cap = _round_up(_round_up(cap, block), step)
        return cls(num_shards=num, phys_cap=cap, dim=dim)
