"""tpuvdb_torch.native: the port's build of the native host runtime.

Mirrors tests/test_native.py on the port's library (WAL writer durability
and concurrent producers, KV round trip, tombstone reuse, vector file), and
adds what the port's loader promises:
* four processes that load the library into one empty build directory at
  once all load it, it is compiled once, and no temporary file is left;
* a library that does not build raises with the compiler's output for an
  explicit "native", while "auto" resolves to python (and says so);
* the WAL's native writer writes the segments the python writer writes,
  which both packages replay.
"""

import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

from tpuvdb.store.wal import WriteAheadLog as JaxWal
from tpuvdb_torch import native
from tpuvdb_torch.store.kv import DocStore
from tpuvdb_torch.store.wal import WriteAheadLog

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_wal_writer_durability(tmp_path):
    path = str(tmp_path / "wal.bin")
    w = native.NativeWalWriter(path, fsync=True)
    w.append(b"hello ")
    t2 = w.append(b"world")
    assert w.sync(t2)
    assert open(path, "rb").read() == b"hello world"
    w.close()
    # reopen appends
    w2 = native.NativeWalWriter(path, fsync=False)
    w2.append_sync(b"!")
    assert open(path, "rb").read() == b"hello world!"  # written on return
    w2.close()


def test_wal_writer_concurrent(tmp_path):
    path = str(tmp_path / "wal.bin")
    w = native.NativeWalWriter(path, fsync=False)
    n_threads, per = 8, 200

    def worker(tid):
        for i in range(per):
            w.append_sync(f"{tid:02d}:{i:04d};".encode())

    threads = [threading.Thread(target=worker, args=(t,))
               for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    w.close()
    recs = [r for r in open(path, "rb").read().decode().split(";") if r]
    # no torn or interleaved records, none lost
    assert len(recs) == len(set(recs)) == n_threads * per
    assert all(len(r) == 7 and r[2] == ":" for r in recs)


def test_kv_store_roundtrip(tmp_path):
    kv = native.NativeKv()
    assert kv.get("missing") is None
    assert not kv.put("a", 1, 100, 1111, b"meta-a")  # new
    assert kv.put("a", 2, 200, 2222, b"meta-a2")     # overwrite
    assert kv.get("a") == (2, 200, 2222, b"meta-a2")
    assert len(kv) == 1
    assert kv.delete("a")
    assert not kv.delete("a")
    assert kv.get("a") is None
    for i in range(5000):
        kv.put(f"key_{i}", i % 7, i, i * 10, f"m{i}".encode())
    assert len(kv) == 5000
    snap = str(tmp_path / "kv.bin")
    assert kv.dump(snap)
    kv2 = native.NativeKv()
    assert kv2.load(snap)
    assert len(kv2) == 5000
    assert kv2.get("key_4321") == (4321 % 7, 4321, 43210, b"m4321")
    # dump_mem holds the same bytes as dump
    buf = kv.dump_mem()
    assert bytes(buf.view()) == open(snap, "rb").read()
    buf.release()
    kv.close()
    kv2.close()


def test_kv_tombstone_reuse():
    kv = native.NativeKv()
    for i in range(1000):
        kv.put(f"k{i}", 0, i, 0)
    for i in range(0, 1000, 2):
        kv.delete(f"k{i}")
    for i in range(0, 1000, 2):
        kv.put(f"k{i}", 0, i + 1, 0)
    assert len(kv) == 1000
    assert kv.get("k10")[1] == 11
    assert kv.get("k11")[1] == 11
    assert kv.key_at(0, 10) is None  # the deleted entry's slot unmapped
    kv.close()


def test_kv_packed_export_reinserts_verbatim():
    kv = native.NativeKv()
    for i in range(300):
        kv.put(f"ключ{i}" if i % 50 == 0 else f"k{i}", i % 3, i, i,
               b"v" * (i % 4))
    packed = kv.export_packed()
    keys = native.NativeKv.decode_keys(packed["keys_blob"],
                                       packed["key_lens"])
    assert sorted(keys) == sorted(k for k, *_ in kv.items())
    kv2 = native.NativeKv()
    kv2.put_packed(packed["keys_blob"], packed["key_lens"],
                   packed["shards"], packed["slots"] + 1000, packed["tss"],
                   packed["vals_blob"], packed["val_lens"])
    assert len(kv2) == 300
    assert kv2.get("ключ50") == (50 % 3, 1050, 50, b"v" * 2)
    assert kv2.keys_at([2, 1, 1], [1050, 7, 1007]) == ["ключ50", None, "k7"]


def test_vector_file(tmp_path):
    path = str(tmp_path / "vecs.bin")
    dim = 16
    vf = native.NativeVectorFile(path, rows=100, row_bytes=dim * 4)
    arr = vf.as_array(np.float32, dim)
    data = np.arange(dim, dtype=np.float32)
    arr[42] = data
    arr[7] = data * 2
    assert vf.flush()
    vf.close()
    # persisted across reopen, and a plain memmap reads the same rows
    vf2 = native.NativeVectorFile(path, rows=100, row_bytes=dim * 4)
    arr2 = vf2.as_array(np.float32, dim)
    np.testing.assert_array_equal(arr2[42], data)
    np.testing.assert_array_equal(arr2[7], data * 2)
    vf2.close()
    mm = np.memmap(path, dtype=np.float32, mode="r", shape=(100, dim))
    np.testing.assert_array_equal(mm[42], data)


_LOAD = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
from tpuvdb_torch import native
native.load()
kv = native.NativeKv()
kv.put("x", 1, 2, 3)
assert kv.rows_keys([1 * 16 + 2], 16) == (["x"], 0)
print(json.dumps(sorted(native.build_seconds)))
"""


def test_concurrent_first_loads_build_once(tmp_path):
    """Four processes load the library into one empty build directory at
    once: all load it, each library compiles once, no temporary remains."""
    bdir = tmp_path / "build"
    env = dict(os.environ, TPUVDB_TORCH_NATIVE_BUILD=str(bdir))
    procs = [subprocess.Popen([sys.executable, "-c", _LOAD, ROOT], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, [e for _, e in outs]
    built = [name for out, _ in outs
             for name in json.loads(out.strip().splitlines()[-1])]
    assert sorted(built) == ["libtpuvdb_native.so", "tpuvdb_fastlist.so"]
    assert sorted(os.listdir(bdir)) == [".native.lock", "libtpuvdb_native.so",
                                        "tpuvdb_fastlist.so"]


_NO_COMPILER = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
from tpuvdb_torch import native
from tpuvdb_torch.core.config import DBConfig
from tpuvdb_torch.engine.engine import VectorDBEngine
from tpuvdb_torch.store.kv import DocStore
out = {}
try:
    DocStore(backend="native")
except native.NativeBuildError as e:
    out["native"] = str(e)
eng = VectorDBEngine(DBConfig(vector_dim=8, shard_count=1,
                              shard_capacity=256, mirror_init_cap=128),
                     data_dir=sys.argv[2], device="cpu")
info = eng.info()
out["auto"] = [info[k] for k in ("docstore_backend", "wal_backend",
                                 "rescore_backend", "fastlist")]
eng.close()
print(json.dumps(out))
"""


def test_failed_build_raises_for_native_and_auto_resolves_python(tmp_path):
    env = dict(os.environ, TPUVDB_TORCH_NATIVE_BUILD=str(tmp_path / "b"),
               PATH=str(tmp_path / "no-compiler-here"))
    res = subprocess.run([sys.executable, "-c", _NO_COMPILER, ROOT,
                          str(tmp_path / "data")], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert "could not run the compiler" in out["native"]
    assert out["auto"] == ["python", "python", "numpy", False]


@pytest.mark.parametrize("fsync", [True, False])
def test_native_wal_segments_replay_in_both_packages(tmp_path, fsync):
    wal = WriteAheadLog(str(tmp_path), fsync=fsync, backend="native")
    assert wal.backend == "native"
    vecs = np.arange(12, dtype=np.float32).reshape(3, 4)
    wal.append("put", "a", vecs[0], {"m": "1"}, timestamp=5)
    wal.append_batch([{"op": "put", "key": "b", "vector": vecs[1]},
                      {"op": "put", "key": "a", "vector": vecs[2]},
                      {"op": "delete", "key": "b"}])
    # readable before close: an append returns once its bytes are written
    got = [(r["op"], r["key"]) for r in wal.iter_records()]
    assert got == [("put", "a"), ("put", "b"), ("put", "a"), ("delete", "b")]
    wal.close()
    for log in (WriteAheadLog(str(tmp_path), backend="python"),
                JaxWal(str(tmp_path), native_backend=False)):
        plan = log.replay()
        assert [(r["op"], r["key"]) for r in plan] == [("put", "a"),
                                                        ("delete", "b")]
        np.testing.assert_array_equal(
            np.frombuffer(plan[0]["vector"], np.float32), vecs[2])
        assert log.last_seq == 4


def test_docstore_native_backend_is_native():
    assert DocStore(backend="native").backend == "native"
    assert DocStore(backend="auto").backend == "native"
    assert DocStore(backend="python").backend == "python"
    with pytest.raises(ValueError):
        DocStore(backend="leveldb")
