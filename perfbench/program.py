"""The system under test: a tpuvdb_torch engine built from a
configuration's `dbconfig`, bulk-loaded with the harness's rows.

This is the one module that imports the program. It takes from it the
engine (`VectorDBEngine.search_batch` is the timed call), `info()` (its
counters and StageTimer spans; `info` below adds a durable node's set-up
parts) and, for the probe's roofline count, the IVF index's centroids,
cell lengths and nprobe.

A configuration with `"durability": true` runs a durable node: `build`
gives the engine a fresh data_dir (a temporary directory under TMPDIR,
removed after the reopen, or at exit), bulk-loads it through an engine
with the WAL and the cadences off, closes that engine (its one
checkpoint) and opens
the serving engine from the data_dir with the configuration as it is;
`serve` then starts the background flush a served node runs
(api/service.py). A write-
mixed mix drives `put` and `delete` one row a call beside the searcher,
as the service's put_image does. After the window `crash` stops the
engine as a crash would: the background flush stopped and the WAL's file
closed, and no closing checkpoint, since `close()` saves one that would
cover the WAL's tail. `reopen` then recovers from the data_dir: the
newest checkpoint and the WAL's tail replayed.

What the stop leaves is what a killed process leaves, for what a reopen
reads: every acknowledged record was written and fsynced before its put
or delete returned (store/wal.py `_write_locked`: an unbuffered file and
os.fsync, or the native writer's append_sync), and the writer has stopped
before the crash, so none is in flight; a checkpoint's files were msynced
and fsynced before its manifest (store/checkpoint.py), and later writes
touch only mirror rows past its row count (rows [:n) are immutable,
engine.save_checkpoint), which a restore does not read. The close adds
the WAL's `last_seq` marker, which only floors the sequence numbers of
later appends: the replay takes every record past the checkpoint's
position either way.
A configuration without `durability` takes none of this.
"""

from __future__ import annotations

import atexit
import os
import shutil
import sys
import tempfile
import time
import weakref
from typing import Optional

import numpy as np


def key_of(row: int) -> str:
    return f"r{row}"


def row_of(key) -> int:
    """The corpus row a served key names; -1 for anything else."""
    if not isinstance(key, str) or not key.startswith("r"):
        return -1
    try:
        return int(key[1:])
    except ValueError:
        return -1


def build(config: dict, rows: np.ndarray, device):
    """A fresh engine holding every row under key_of(row), its index built.
    The configuration file is the configuration: TPUVDB_* variables of the
    environment, which DBConfig would read over it, are dropped."""
    for name in [n for n in os.environ if n.startswith("TPUVDB_")]:
        print(f"perfbench: ignoring {name} from the environment",
              file=sys.stderr)
        del os.environ[name]
    from tpuvdb_torch.core.config import DBConfig
    from tpuvdb_torch.engine.engine import VectorDBEngine

    if config.get("durability"):
        return _build_durable(config, rows, device)
    engine = VectorDBEngine(DBConfig(**config["dbconfig"]), device=device)
    keys = [key_of(i) for i in range(rows.shape[0])]
    res = engine.put_rows(keys, rows)
    if not res.success:
        raise RuntimeError(f"bulk load failed: {res.message}")
    del keys
    engine.flush()
    return engine


def _build_durable(config: dict, rows: np.ndarray, device):
    """The durable node of the module docstring. The bulk load runs with
    the WAL and both cadences off: through the serving configuration,
    put_rows would log every row (1.8 GB at 900,000 x 512) and count the
    rows toward the cadences, so a compaction of the whole store would run
    inside the load and a checkpoint after it."""
    from tpuvdb_torch.core.config import DBConfig
    from tpuvdb_torch.engine.engine import VectorDBEngine

    data_dir = tempfile.mkdtemp(prefix="perfbench-node-")
    atexit.register(shutil.rmtree, data_dir, True)  # whatever else happens
    off = {**config["dbconfig"], "wal_enabled": False,
           "checkpoint_every_puts": 10 ** 12, "compact_every_puts": 10 ** 12}
    loader = VectorDBEngine(DBConfig(**off), data_dir=data_dir, device=device)
    keys = [key_of(i) for i in range(rows.shape[0])]
    res = loader.put_rows(keys, rows)
    if not res.success:
        raise RuntimeError(f"bulk load failed: {res.message}")
    del keys
    loader.close()  # its one checkpoint
    stages = {name: snap for name, snap in loader.timers.snapshot().items()
              if name.split(".")[0] == "put_rows"}
    del loader
    t0 = time.perf_counter()
    engine = reopen(config, data_dir, device)
    _SETUP[engine] = {"stages": stages, "open_s": time.perf_counter() - t0}
    engine.flush()
    return engine


def serve(engine) -> None:
    """The last step of a durable node's set-up, after its warm writes:
    the staged writes flushed and the background flush started."""
    engine.flush()
    engine.start_background_flush()


# a durable node's set-up parts that its own info() lacks, by engine
_SETUP = weakref.WeakKeyDictionary()


def info(engine) -> dict:
    """engine.info(); for a durable node also the loader's `put_rows`
    stages (the bulk load ran there, the node has none of its own) and
    `setup_open_s`, the seconds its opening from the data_dir took in
    set-up."""
    got = engine.info()
    extra = _SETUP.get(engine)
    if extra is not None:
        for name, snap in extra["stages"].items():
            got["latency"].setdefault(name, snap)
        got["setup_open_s"] = extra["open_s"]
    return got


def reopen(config: dict, data_dir: str, device):
    """The configuration's engine opened from `data_dir`: the newest
    checkpoint restored and the WAL's tail replayed."""
    from tpuvdb_torch.core.config import DBConfig
    from tpuvdb_torch.engine.engine import VectorDBEngine

    return VectorDBEngine(DBConfig(**config["dbconfig"]), data_dir=data_dir,
                          device=device)


def crash(engine) -> None:
    """Stops the engine as a crash would (the module docstring): nothing
    more reaches its data_dir."""
    engine.stop_background_flush()
    if engine.wal is not None:
        engine.wal.close()


def put(engine, key: str, vector: np.ndarray) -> bool:
    """One row put as the service's put_image puts an image: its vector
    and the image's metadata."""
    from tpuvdb_torch.core.types import VectorData

    return bool(engine.put(VectorData(
        key=key, vector=vector,
        metadata={"file_path": f"images/{key}.jpg", "dataset": "default",
                  "dim": str(vector.shape[0])})).success)


def delete(engine, key: str) -> bool:
    return bool(engine.delete(key).success)


def read_back(engine, key: str) -> Optional[np.ndarray]:
    """The float32 vector `get` returns for `key`; None where it answers
    not found."""
    from tpuvdb_torch.core.errors import NOT_FOUND_PREFIX

    r = engine.get(key)
    if r.success:
        return np.asarray(r.vector_data.vector, np.float32)
    if r.message.startswith(NOT_FOUND_PREFIX):
        return None
    raise RuntimeError(f"get {key}: {r.message}")


def window_mark(engine) -> dict:
    """The engine's counters and each stage's (count, total ms), to take
    the window's share of them."""
    return {"stats": dict(engine.stats),
            "stages": {name: (s["count"], s.get("total_ms", 0.0))
                       for name, s in engine.timers.snapshot().items()}}


def warm(engine, traffic) -> None:
    """The engine's warm-up of the one shape the mix sends (no stacks
    above it: a closed-loop client never stacks), then the mix's warm
    calls of real queries."""
    engine.warm_search(traffic.k, traffic.batch, max_stack=traffic.batch)
    for i in range(int(traffic.params["warm_calls"])):
        engine.search_batch(traffic.queries(traffic.batch_index(i)),
                            traffic.k)


def ivf_state(engine) -> Optional[dict]:
    """What the probe's roofline count reads of an IVF index; None for
    another index."""
    ivf = getattr(engine, "_ivf", None)
    if ivf is None:
        return None
    return {"centroids": ivf.centroids_np(),
            "cell_rows": np.asarray(ivf.cell_lens, np.int64),
            "nprobe": min(int(ivf.nprobe), int(ivf.nlist)),
            "spill_rows": int(ivf.stats().spill_rows)}


def stage_counts(engine) -> dict:
    """Samples each StageTimer span has taken so far."""
    return {name: s["count"] for name, s in engine.timers.snapshot().items()}
