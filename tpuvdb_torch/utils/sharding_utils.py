"""Key->shard routing.

Parity: the reference routes by MD5(key) % SHARD_COUNT
(src/utils/shared_utils.py:4-7) and assigns each shard a round-robin master
plus the next REPLICA_COUNT nodes as slaves (src/utils/shared_utils.py:9-21).
The same hash is kept so datasets ingested under either system land on the
same shard ids.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Sequence

import numpy as np


def get_shard_id(key: str, shard_count: int) -> int:
    """MD5-hash a key onto [0, shard_count)."""
    digest = hashlib.md5(key.encode("utf-8")).hexdigest()
    return int(digest, 16) % shard_count


def get_shard_ids(keys: Sequence[str], shard_count: int) -> np.ndarray:
    """Vectorized key routing for batch ingest."""
    return np.array([get_shard_id(k, shard_count) for k in keys], dtype=np.int32)


def assign_shards_to_nodes(
    nodes: Sequence[str], shard_count: int, replica_count: int
) -> Dict[int, Dict[str, List[str]]]:
    """Round-robin shard->(master, slaves) assignment.

    Matches the reference's layout: shard i's master is nodes[i % n], its
    slaves the next `replica_count` nodes (wrapping), excluding the master.
    """
    nodes = list(nodes)
    if not nodes:
        return {i: {"master": [], "slaves": []} for i in range(shard_count)}
    mapping: Dict[int, Dict[str, List[str]]] = {}
    n = len(nodes)
    for shard in range(shard_count):
        master = nodes[shard % n]
        slaves = []
        for j in range(1, replica_count + 1):
            cand = nodes[(shard + j) % n]
            if cand != master and cand not in slaves:
                slaves.append(cand)
        mapping[shard] = {"master": [master], "slaves": slaves}
    return mapping
