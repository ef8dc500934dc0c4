"""The system under test: a tpuvdb_torch engine built from a
configuration's `dbconfig`, bulk-loaded with the harness's rows.

This is the one module that imports the program. It takes from it the
engine (`VectorDBEngine.search_batch` is the timed call), `info()` (its
counters and StageTimer spans) and, for the probe's roofline count, the
IVF index's centroids, cell lengths and nprobe.
"""

from __future__ import annotations

import os
import sys
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

    engine = VectorDBEngine(DBConfig(**config["dbconfig"]), device=device)
    keys = [key_of(i) for i in range(rows.shape[0])]
    res = engine.put_rows(keys, rows)
    if not res.success:
        raise RuntimeError(f"bulk load failed: {res.message}")
    del keys
    engine.flush()
    return engine


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
