"""ctypes bindings for the port's native host runtime (src/tpuvdb_native.cpp).

The port's copy of tpuvdb.native: the group-commit WAL writer
(`NativeWalWriter`), the C++ doc store (`NativeKv`), the mmap vector file
(`NativeVectorFile`) and the fused exact rescore (`rescore_rows`), plus the
`fastlist` CPython extension (src/fastlist.c) that builds the key lists of
the search path.

Both libraries build with g++ / gcc from the sources in `src/` into
`tpuvdb_torch/build/` (or `$TPUVDB_TORCH_NATIVE_BUILD`) at first use, never
at import. A library is rebuilt when its source is newer. The check and the
build run under an `fcntl.flock` on a lock file in the build directory,
each process compiles to a temporary name of its own and moves it in with
`os.replace`: concurrent first loads build once and none loads a
half-written file. A failed build raises `NativeBuildError` with the
compiler's output, and later calls in the process raise the same error.
`available()` is the one place that turns a failure into False, for the
"auto" backends of `core/config.py`.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_HERE, "src")
_SRC = os.path.join(SRC_DIR, "tpuvdb_native.cpp")
_FASTLIST_SRC = os.path.join(SRC_DIR, "fastlist.c")
_DEFAULT_BUILD_DIR = os.path.join(os.path.dirname(_HERE), "build")

_lib = None
_fastlist = None
_error: Optional[str] = None
_lib_lock = threading.Lock()
# seconds each library took to compile in this process (absent = loaded
# an up-to-date build)
build_seconds: Dict[str, float] = {}


class NativeBuildError(RuntimeError):
    """The native library or the fastlist extension did not build."""


def build_dir() -> str:
    return os.environ.get("TPUVDB_TORCH_NATIVE_BUILD", _DEFAULT_BUILD_DIR)


def _lib_command(out: str):
    # -O3: the rescore loops need the vectorizer's full cost model; ISA
    # selection stays runtime-safe through target_clones in the source,
    # so no -march here
    return ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
            _SRC, "-o", out]


def _fastlist_command(out: str):
    import sysconfig

    return ["gcc", "-O2", "-shared", "-fPIC",
            "-I", sysconfig.get_path("include"), _FASTLIST_SRC, "-o", out]


def _build(src: str, name: str, command) -> str:
    """Build `name` from `src` unless an up-to-date build is there. The
    whole check-and-build holds the build directory's lock."""
    bdir = build_dir()
    os.makedirs(bdir, exist_ok=True)
    out = os.path.join(bdir, name)
    with open(os.path.join(bdir, ".native.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if (os.path.exists(out)
                and os.path.getmtime(out) >= os.path.getmtime(src)):
            return out
        tmp = f"{out}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(command(tmp), stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True,
                                  timeout=300)
        except (OSError, subprocess.SubprocessError) as e:
            raise NativeBuildError(f"could not run the compiler for "
                                   f"{src}: {e}") from e
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise NativeBuildError(f"failed to build {src}:\n{proc.stdout}")
        os.replace(tmp, out)
        build_seconds[name] = time.perf_counter() - t0
        return out


def _bind(lib: ctypes.CDLL) -> None:
    c = ctypes
    u8p, u32p = c.POINTER(c.c_uint8), c.POINTER(c.c_uint32)
    i32p, i64p = c.POINTER(c.c_int32), c.POINTER(c.c_int64)
    u64p, f32p = c.POINTER(c.c_uint64), c.POINTER(c.c_float)
    sigs = {
        "wal_open": (c.c_void_p, [c.c_char_p, c.c_int]),
        "wal_append": (c.c_uint64, [c.c_void_p, c.c_char_p, c.c_uint64]),
        "wal_sync": (c.c_int, [c.c_void_p, c.c_uint64]),
        "wal_durable": (c.c_uint64, [c.c_void_p]),
        "wal_close": (None, [c.c_void_p]),
        "kv_create": (c.c_void_p, []),
        "kv_destroy": (None, [c.c_void_p]),
        "kv_put": (c.c_int, [c.c_void_p, c.c_char_p, c.c_uint32, c.c_int32,
                             c.c_int64, c.c_int64, c.c_char_p, c.c_uint32]),
        "kv_get": (c.c_int, [c.c_void_p, c.c_char_p, c.c_uint32, i32p, i64p,
                             i64p, c.c_char_p, c.c_uint32, u32p]),
        "kv_del": (c.c_int, [c.c_void_p, c.c_char_p, c.c_uint32]),
        "kv_size": (c.c_uint64, [c.c_void_p]),
        "kv_next": (c.c_int, [c.c_void_p, u64p, c.c_char_p, c.c_uint32,
                              u32p, i32p, i64p, i64p, c.c_char_p,
                              c.c_uint32, u32p]),
        "kv_dump": (c.c_int, [c.c_void_p, c.c_char_p]),
        "kv_dump_mem": (c.c_int, [c.c_void_p, c.POINTER(u8p), u64p]),
        "kv_buf_free": (None, [u8p]),
        "kv_load": (c.c_int, [c.c_void_p, c.c_char_p]),
        "kv_put_many": (c.c_int, [c.c_void_p, c.c_char_p, u32p, i32p, i64p,
                                  i64p, c.c_char_p, u32p, c.c_uint64, i32p,
                                  i64p]),
        "kv_nonempty_vals": (c.c_uint64, [c.c_void_p]),
        "kv_key_at": (c.c_int, [c.c_void_p, c.c_int32, c.c_int64,
                                c.c_char_p, c.c_uint32, u32p]),
        "kv_slots_live": (c.c_int, [c.c_void_p, i32p, i64p, c.c_uint64,
                                    c.c_char_p]),
        "kv_keys_at": (c.c_int, [c.c_void_p, i32p, i64p, c.c_uint64,
                                 c.c_char_p, c.c_uint64, u32p]),
        "kv_rows_keys": (c.c_int, [c.c_void_p, i64p, c.c_uint64, c.c_int64,
                                   c.c_char_p, c.c_uint64, u32p, u32p]),
        "kv_export_sizes": (c.c_int, [c.c_void_p, u64p, u64p, u64p]),
        "kv_export_entries": (c.c_int, [c.c_void_p, c.c_char_p, c.c_uint64,
                                        u32p, i32p, i64p, i64p, c.c_char_p,
                                        c.c_uint64, u32p, c.c_uint64, u64p]),
        "rescore2_rows_int8": (None, [f32p, f32p, c.c_int64, c.c_int64,
                                      c.c_int64, c.c_int64,
                                      c.POINTER(c.c_int8), f32p, f32p, i64p,
                                      i64p, c.c_int64, f32p]),
        "rescore2_rows_f32": (None, [f32p, f32p, c.c_int64, c.c_int64,
                                     c.c_int64, c.c_int64, f32p, f32p, i64p,
                                     i64p, c.c_int64, f32p]),
        "vf_open": (c.c_void_p, [c.c_char_p, c.c_uint64, c.c_uint64]),
        "vf_data": (u8p, [c.c_void_p]),
        "vf_write": (c.c_int, [c.c_void_p, c.c_uint64, c.c_char_p]),
        "vf_read": (c.c_int, [c.c_void_p, c.c_uint64, c.c_char_p]),
        "vf_flush": (c.c_int, [c.c_void_p]),
        "vf_close": (None, [c.c_void_p]),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes


def _load_extension(path: str):
    import importlib.machinery
    import importlib.util

    loader = importlib.machinery.ExtensionFileLoader("tpuvdb_fastlist", path)
    spec = importlib.util.spec_from_file_location("tpuvdb_fastlist", path,
                                                  loader=loader)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load() -> ctypes.CDLL:
    """The bound C++ library, built (with fastlist) on first use. Raises
    NativeBuildError with the compiler's output when either fails."""
    global _lib, _fastlist, _error
    with _lib_lock:
        if _lib is not None:
            return _lib
        if _error is not None:
            raise NativeBuildError(_error)
        try:
            lib = ctypes.CDLL(_build(_SRC, "libtpuvdb_native.so",
                                     _lib_command))
            _bind(lib)
            ext = _build(_FASTLIST_SRC, "tpuvdb_fastlist.so",
                         _fastlist_command)
            try:
                _fastlist = _load_extension(ext)
            except ImportError as e:
                raise NativeBuildError(f"fastlist did not load: {e}") from e
        except NativeBuildError as e:
            _error = str(e)
            raise
        _lib = lib
        return _lib


def available() -> bool:
    """True when the library and fastlist build and load ("auto")."""
    try:
        load()
        return True
    except NativeBuildError:
        return False


def rescore_available() -> bool:
    """True when the fused exact rescore can run (the library built)."""
    return available()


def fastlist():
    """The fastlist extension module (built and loaded by `load`)."""
    load()
    return _fastlist


def rescore_rows(q, qsq, fetch_w, vec, scale, sq, slots, opos, out):
    """Fused exact-rescore epilogue (src rescore2_rows_*): writes
    qsq[qi] - 2*scale*(q[qi].vec[slot]) + sq[slot] into out[opos] for each
    candidate, qi = opos // fetch_w, streaming int8/f32 mirror rows
    through registers once instead of materializing a (n, d) f32 gather.
    `vec` is the mirror's backing array (int8 codes or f32 rows); `scale`
    is None for f32. A slot outside vec's rows writes +inf, an opos outside
    out is skipped. out must be f32 C-contiguous (written in place) and
    pre-filled with the missing-candidate sentinel."""
    lib = load()
    c = ctypes
    f32p = c.POINTER(c.c_float)
    i64p = c.POINTER(c.c_int64)
    n = len(slots)
    if n == 0:
        return
    slots_a = np.ascontiguousarray(slots, np.int64)
    opos_a = np.ascontiguousarray(opos, np.int64)
    # the C loops read raw pointers with no stride or dtype: a strided
    # view or a float64 array would be silent garbage, so refuse them
    q = np.ascontiguousarray(q, np.float32)
    qsq = np.ascontiguousarray(qsq, np.float32)
    sq = np.ascontiguousarray(sq, np.float32)
    if not (isinstance(out, np.ndarray) and out.dtype == np.float32
            and out.flags.c_contiguous):
        raise ValueError("rescore_rows: out must be f32 C-contiguous "
                         "(written in place)")
    if not (isinstance(vec, np.ndarray) and vec.flags.c_contiguous):
        raise ValueError("rescore_rows: vec must be C-contiguous")
    if scale is not None:
        if vec.dtype != np.int8:
            raise ValueError("rescore_rows: int8 path needs int8 vec")
        scale = np.ascontiguousarray(scale, np.float32)
    elif vec.dtype != np.float32:
        raise ValueError("rescore_rows: f32 path needs f32 vec")
    common = (q.ctypes.data_as(f32p), qsq.ctypes.data_as(f32p), q.shape[1],
              fetch_w, vec.shape[0], out.size)
    tail = (sq.ctypes.data_as(f32p), slots_a.ctypes.data_as(i64p),
            opos_a.ctypes.data_as(i64p), n, out.ctypes.data_as(f32p))
    if scale is not None:
        lib.rescore2_rows_int8(*common,
                               vec.ctypes.data_as(c.POINTER(c.c_int8)),
                               scale.ctypes.data_as(f32p), *tail)
    else:
        lib.rescore2_rows_f32(*common, vec.ctypes.data_as(f32p), *tail)


class NativeWalWriter:
    """Group-commit append file: many threads append, one C++ thread
    writes (+fsyncs), producers block only until THEIR ticket is written."""

    def __init__(self, path: str, fsync: bool = True):
        self._lib = load()
        self._h = self._lib.wal_open(path.encode(), 1 if fsync else 0)
        if not self._h:
            raise OSError(f"wal_open failed: {path}")

    def append(self, data: bytes) -> int:
        return self._lib.wal_append(self._h, data, len(data))

    def sync(self, ticket: int) -> bool:
        """Block until `ticket` is written (and fsynced when enabled).
        Raises OSError on a persistent writer IO failure (e.g. ENOSPC)
        instead of wedging the caller."""
        if not self._lib.wal_sync(self._h, ticket):
            raise OSError(
                "native WAL writer failed (disk full or IO error); "
                f"ticket {ticket} will never become durable")
        return True

    def append_sync(self, data: bytes) -> None:
        self.sync(self.append(data))

    def close(self):
        """Drain, fsync and join the writer thread."""
        if self._h:
            self._lib.wal_close(self._h)
            self._h = None


def _keys_buffer(holder, n: int):
    out = getattr(holder, "_keys_buf", None)
    if out is None or len(out) < max(64 * n, 4096):
        out = ctypes.create_string_buffer(max(64 * n, 8192))
        holder._keys_buf = out
    return out


class NativeKv:
    """String key -> (shard, slot, ts, value-blob) map in C++, with its
    own (shard, slot) -> key reverse table."""

    _VAL_CAP = 1 << 20

    def __init__(self):
        self._lib = load()
        self._fl = _fastlist
        self._h = self._lib.kv_create()
        self._buf = ctypes.create_string_buffer(self._VAL_CAP)

    def put(self, key: str, shard: int, slot: int, ts: int,
            value: bytes = b"") -> bool:
        k = key.encode()
        return bool(self._lib.kv_put(self._h, k, len(k), shard, slot, ts,
                                     value, len(value)))

    def get(self, key: str) -> Optional[Tuple[int, int, int, bytes]]:
        k = key.encode()
        shard = ctypes.c_int32()
        slot = ctypes.c_int64()
        ts = ctypes.c_int64()
        vlen = ctypes.c_uint32()
        for _ in range(2):
            ok = self._lib.kv_get(self._h, k, len(k), ctypes.byref(shard),
                                  ctypes.byref(slot), ctypes.byref(ts),
                                  self._buf, len(self._buf),
                                  ctypes.byref(vlen))
            if ok != 2:
                break
            # value larger than the scratch buffer: grow and retry
            self._buf = ctypes.create_string_buffer(
                max(vlen.value, 2 * len(self._buf)))
        if ok != 1:
            return None
        return (shard.value, slot.value, ts.value,
                ctypes.string_at(self._buf, vlen.value))

    def put_many(self, keys, shards, slots, tss, values=None, raw=False):
        """Bulk insert in ONE FFI crossing. Returns a list of (prev_shard,
        prev_slot) per key, (-1, -1) = new key, or with raw=True the two
        numpy arrays. values=None = all-empty."""
        kbs = [k.encode() for k in keys]
        n = len(kbs)
        key_lens = np.fromiter((len(b) for b in kbs), np.uint32, n)
        if values is None:
            vals_blob = b""
            val_lens = np.zeros(n, np.uint32)
        else:
            vals_blob = b"".join(values)
            val_lens = np.fromiter((len(v) for v in values), np.uint32, n)
        prev_sh, prev_sl = self._put_many(b"".join(kbs), key_lens, shards,
                                          slots, tss, vals_blob, val_lens)
        if raw:
            return prev_sh, prev_sl
        return list(zip(prev_sh.tolist(), prev_sl.tolist()))

    def _put_many(self, keys_blob, key_lens, shards, slots, tss, vals_blob,
                  val_lens):
        c = ctypes
        u32p = c.POINTER(c.c_uint32)
        kl = np.ascontiguousarray(key_lens, np.uint32)
        vl = np.ascontiguousarray(val_lens, np.uint32)
        sh = np.ascontiguousarray(shards, np.int32)
        sl = np.ascontiguousarray(slots, np.int64)
        ts = np.ascontiguousarray(tss, np.int64)
        n = len(kl)
        prev_sh = np.empty(n, np.int32)
        prev_sl = np.empty(n, np.int64)
        self._lib.kv_put_many(
            self._h, keys_blob, kl.ctypes.data_as(u32p),
            sh.ctypes.data_as(c.POINTER(c.c_int32)),
            sl.ctypes.data_as(c.POINTER(c.c_int64)),
            ts.ctypes.data_as(c.POINTER(c.c_int64)),
            vals_blob, vl.ctypes.data_as(u32p), n,
            prev_sh.ctypes.data_as(c.POINTER(c.c_int32)),
            prev_sl.ctypes.data_as(c.POINTER(c.c_int64)))
        return prev_sh, prev_sl

    def put_packed(self, keys_blob: bytes, key_lens, shards, slots, tss,
                   vals_blob: bytes, val_lens):
        """Bulk insert of ALREADY-PACKED buffers (the export_packed format)
        in one FFI crossing: compaction reinserts its snapshot with
        remapped slots without a single python string or msgpack blob."""
        self._put_many(keys_blob, key_lens, shards, slots, tss, vals_blob,
                       val_lens)

    def key_at(self, shard: int, slot: int) -> Optional[str]:
        klen = ctypes.c_uint32()
        buf = ctypes.create_string_buffer(4096)
        ok = self._lib.kv_key_at(self._h, shard, slot, buf, len(buf),
                                 ctypes.byref(klen))
        if ok == 2:
            buf = ctypes.create_string_buffer(klen.value)
            ok = self._lib.kv_key_at(self._h, shard, slot, buf, len(buf),
                                     ctypes.byref(klen))
        if ok != 1:
            return None
        return ctypes.string_at(buf, klen.value).decode()

    def slots_live(self, shards, slots) -> np.ndarray:
        """Bool liveness per (shard, slot): one FFI crossing, no strings."""
        shards_a = np.ascontiguousarray(shards, np.int32)
        slots_a = np.ascontiguousarray(slots, np.int64)
        n = len(shards_a)
        out = np.empty(n, np.uint8)
        c = ctypes
        self._lib.kv_slots_live(
            self._h, shards_a.ctypes.data_as(c.POINTER(c.c_int32)),
            slots_a.ctypes.data_as(c.POINTER(c.c_int64)), n,
            out.ctypes.data_as(c.c_char_p))
        return out.astype(bool)

    def keys_at(self, shards, slots) -> list:
        """Bulk (shard, slot) -> key in one FFI crossing; None = unmapped.
        NOT thread-safe with itself (scratch buffer): callers hold the
        DocStore lock."""
        shards_a = np.ascontiguousarray(shards, np.int32)
        slots_a = np.ascontiguousarray(slots, np.int64)
        n = len(shards_a)
        lens = np.empty(n, np.uint32)
        c = ctypes
        out = _keys_buffer(self, n)
        while not self._lib.kv_keys_at(
                self._h, shards_a.ctypes.data_as(c.POINTER(c.c_int32)),
                slots_a.ctypes.data_as(c.POINTER(c.c_int64)), n,
                out, len(out), lens.ctypes.data_as(c.POINTER(c.c_uint32))):
            out = ctypes.create_string_buffer(len(out) * 4)
            self._keys_buf = out
        # `out` and `lens` stay alive as locals for the call, which is
        # fastlist's contract
        return self._fl.keys_from_buffer(ctypes.addressof(out),
                                         lens.ctypes.data, n)

    def rows_keys(self, rows, phys_cap: int, row: int = 0):
        """Fused liveness + key resolution for FLAT global row ids: one FFI
        crossing decomposes shard/slot in C with prefetch and returns
        (keys, n_missing). Negative rows resolve to None. With row > 0
        (dividing len(rows)) the keys come back as row-sized inner lists
        built in C. NOT thread-safe with itself: callers hold the DocStore
        lock."""
        rows_a = np.ascontiguousarray(rows, np.int64)
        n = len(rows_a)
        lens = np.empty(n, np.uint32)
        miss = ctypes.c_uint32(0)
        c = ctypes
        out = _keys_buffer(self, n)
        while not self._lib.kv_rows_keys(
                self._h, rows_a.ctypes.data_as(c.POINTER(c.c_int64)), n,
                phys_cap, out, len(out),
                lens.ctypes.data_as(c.POINTER(c.c_uint32)),
                ctypes.byref(miss)):
            out = ctypes.create_string_buffer(len(out) * 4)
            self._keys_buf = out
        if row > 0 and n % row == 0:
            keys = self._fl.keys_from_buffer_rows(
                ctypes.addressof(out), lens.ctypes.data, n, row)
        else:
            keys = self._fl.keys_from_buffer(ctypes.addressof(out),
                                             lens.ctypes.data, n)
        return keys, int(miss.value)

    def export_packed(self) -> dict:
        """Columnar snapshot of every live entry in ONE FFI crossing:
        packed buffers {keys_blob, key_lens, shards, slots, tss, vals_blob,
        val_lens}. Keys decode lazily off the engine lock
        (DocStore.snapshot_columns), or never (put_packed)."""
        c = ctypes
        n = c.c_uint64()
        kb = c.c_uint64()
        vb = c.c_uint64()
        self._lib.kv_export_sizes(self._h, c.byref(n), c.byref(kb),
                                  c.byref(vb))
        while True:
            cap_n = n.value
            keys_buf = ctypes.create_string_buffer(max(int(kb.value), 1))
            vals_buf = ctypes.create_string_buffer(max(int(vb.value), 1))
            key_lens = np.empty(max(cap_n, 1), np.uint32)
            val_lens = np.empty(max(cap_n, 1), np.uint32)
            shards = np.empty(max(cap_n, 1), np.int32)
            slots = np.empty(max(cap_n, 1), np.int64)
            tss = np.empty(max(cap_n, 1), np.int64)
            n_out = c.c_uint64()
            ok = self._lib.kv_export_entries(
                self._h, keys_buf, len(keys_buf),
                key_lens.ctypes.data_as(c.POINTER(c.c_uint32)),
                shards.ctypes.data_as(c.POINTER(c.c_int32)),
                slots.ctypes.data_as(c.POINTER(c.c_int64)),
                tss.ctypes.data_as(c.POINTER(c.c_int64)),
                vals_buf, len(vals_buf),
                val_lens.ctypes.data_as(c.POINTER(c.c_uint32)),
                cap_n, c.byref(n_out))
            if ok:
                break
            # raced with concurrent growth: re-size and retry
            self._lib.kv_export_sizes(self._h, c.byref(n), c.byref(kb),
                                      c.byref(vb))
        m = int(n_out.value)
        return {
            "keys_blob": ctypes.string_at(keys_buf, int(key_lens[:m].sum())),
            "key_lens": key_lens[:m],
            "shards": shards[:m],
            "slots": slots[:m],
            "tss": tss[:m],
            "vals_blob": ctypes.string_at(vals_buf, int(val_lens[:m].sum())),
            "val_lens": val_lens[:m],
        }

    @staticmethod
    def decode_keys(keys_blob: bytes, key_lens) -> list:
        """list[str] from a packed key blob, through fastlist."""
        buf = ctypes.create_string_buffer(keys_blob, len(keys_blob))
        lens = np.ascontiguousarray(key_lens, np.uint32)
        return fastlist().keys_from_buffer(ctypes.addressof(buf),
                                           lens.ctypes.data, len(lens))

    def delete(self, key: str) -> bool:
        k = key.encode()
        return bool(self._lib.kv_del(self._h, k, len(k)))

    def __len__(self) -> int:
        return self._lib.kv_size(self._h)

    def items(self):
        """Iterate (key, shard, slot, ts, value) over all live entries."""
        cursor = ctypes.c_uint64(0)
        kbuf = ctypes.create_string_buffer(4096)
        klen = ctypes.c_uint32()
        shard = ctypes.c_int32()
        slot = ctypes.c_int64()
        ts = ctypes.c_int64()
        vlen = ctypes.c_uint32()
        while True:
            ok = self._lib.kv_next(self._h, ctypes.byref(cursor), kbuf,
                                   len(kbuf), ctypes.byref(klen),
                                   ctypes.byref(shard), ctypes.byref(slot),
                                   ctypes.byref(ts), self._buf,
                                   len(self._buf), ctypes.byref(vlen))
            if ok == 0:
                return
            if ok == 2:  # entry larger than the buffers: grow, same cursor
                if klen.value > len(kbuf):
                    kbuf = ctypes.create_string_buffer(
                        max(klen.value, 2 * len(kbuf)))
                if vlen.value > len(self._buf):
                    self._buf = ctypes.create_string_buffer(
                        max(vlen.value, 2 * len(self._buf)))
                continue
            yield (ctypes.string_at(kbuf, klen.value).decode(),
                   shard.value, slot.value, ts.value,
                   ctypes.string_at(self._buf, vlen.value))

    def nonempty_vals(self) -> int:
        return self._lib.kv_nonempty_vals(self._h)

    def dump(self, path: str) -> bool:
        return bool(self._lib.kv_dump(self._h, path.encode()))

    def dump_mem(self) -> "_KvSnapshotBuf":
        """Consistent snapshot serialized into C memory (dump()'s binary
        format), at memory speed under the store mutex: callers snapshot
        under their serving lock and write the buffer to disk with the
        lock released, then call .release()."""
        buf = ctypes.POINTER(ctypes.c_uint8)()
        n = ctypes.c_uint64()
        if self._lib.kv_dump_mem(self._h, ctypes.byref(buf),
                                 ctypes.byref(n)) != 1:
            raise MemoryError("kv_dump_mem could not allocate the snapshot")
        return _KvSnapshotBuf(self._lib, buf, n.value)

    def load(self, path: str) -> bool:
        return bool(self._lib.kv_load(self._h, path.encode()))

    def close(self):
        if self._h:
            self._lib.kv_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class _KvSnapshotBuf:
    """Owns a malloc'd kv_dump_mem buffer; exposes it as a zero-copy
    memoryview for file.write() and frees it on release() or GC."""

    def __init__(self, lib, buf, n: int):
        self._lib = lib
        self._buf = buf
        self.nbytes = n

    def view(self) -> memoryview:
        return memoryview(
            (ctypes.c_uint8 * self.nbytes).from_address(
                ctypes.addressof(self._buf.contents))).cast("B")

    def release(self):
        if self._buf:
            self._lib.kv_buf_free(self._buf)
            self._buf = None

    def __del__(self):
        try:
            self.release()
        except Exception:
            pass


class NativeVectorFile:
    """mmap-backed (rows, row_bytes) store with a zero-copy numpy view."""

    def __init__(self, path: str, rows: int, row_bytes: int):
        self._lib = load()
        self._h = self._lib.vf_open(path.encode(), rows, row_bytes)
        if not self._h:
            raise OSError(f"vf_open failed: {path}")
        self.rows = rows
        self.row_bytes = row_bytes

    def as_array(self, dtype, cols: int) -> np.ndarray:
        ptr = self._lib.vf_data(self._h)
        buf = ctypes.cast(
            ptr, ctypes.POINTER(ctypes.c_uint8 * (self.rows * self.row_bytes))
        ).contents
        return np.frombuffer(buf, dtype=dtype).reshape(self.rows, cols)

    def flush(self) -> bool:
        return bool(self._lib.vf_flush(self._h))

    def close(self):
        if self._h:
            self._lib.vf_close(self._h)
            self._h = None
