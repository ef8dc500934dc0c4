"""Cluster membership, shard mapping and health: the port's copy of
tpuvdb.cluster.membership.

The reference system keeps membership in ZooKeeper (ephemeral znodes, a
shard -> (master, slaves) map, watches and a 5-second TCP-probe health
loop). The registry keeps those external semantics for the API, the CLI
and the federated coordinator:

  * register_node(node_id, address) -> recompute the shard map (the same
    round-robin master + slaves layout,
    tpuvdb_torch.utils.sharding_utils.assign_shards_to_nodes)
  * list_nodes with online/offline status
  * an optional TCP health-probe loop marking unreachable nodes offline
    (every 5 s by default)

In single-process deployments it tracks "virtual" nodes, one per logical
shard at `device:<n>` addresses, which are always online. An optional
JSON journal (`persist_path`) lets a restarted coordinator resume its node
table and shard map; the file is the reference's.
"""

from __future__ import annotations

import dataclasses
import socket
import threading
import time
from typing import Dict, List, Optional

from tpuvdb_torch.utils.logging import get_logger
from tpuvdb_torch.utils.sharding_utils import assign_shards_to_nodes

logger = get_logger("tpuvdb_torch.cluster.membership")


@dataclasses.dataclass
class NodeInfo:
    node_id: str
    address: str  # "host:port" or "device:<n>" for in-process virtual nodes
    online: bool = True
    registered_at: float = dataclasses.field(default_factory=time.time)
    last_seen: float = dataclasses.field(default_factory=time.time)

    @property
    def is_virtual(self) -> bool:
        return self.address.startswith("device:")


class NodeRegistry:
    def __init__(
        self,
        shard_count: int,
        replica_count: int,
        health_interval_s: float = 5.0,
        probe_timeout_s: float = 1.0,
        persist_path: Optional[str] = None,
    ):
        self.shard_count = shard_count
        self.replica_count = replica_count
        self.health_interval_s = health_interval_s
        self.probe_timeout_s = probe_timeout_s
        self._lock = threading.RLock()
        self._nodes: Dict[str, NodeInfo] = {}
        self._map_epoch = 0
        self._shard_map: Dict[int, Dict[str, List[str]]] = {
            i: {"master": [], "slaves": []} for i in range(shard_count)
        }
        self._health_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # membership-change subscribers (ZK watch parity,
        # src/utils/zk_manager.py:47-58 — but persistent, not one-shot)
        self._watchers: List = []
        # Control-plane durability: the reference system
        # keeps membership in a replicated ZK ensemble that survives
        # coordinator restarts (src/utils/zk_manager.py:14-22). Here the
        # registry journals real (non-virtual) registrations + the map
        # epoch to a JSON file; a restarted coordinator resumes routing
        # without manual re-registration. The first health probe (and
        # mark-offline-on-connection-failure) corrects liveness drift.
        self._persist_path = persist_path
        # persist-failure observability: counter
        # + last error, surfaced through /rpc/list_nodes
        self.persist_failures_total = 0
        self.persist_last_error: Optional[str] = None
        if persist_path:
            self._load_persisted()

    def _load_persisted(self) -> None:
        import json
        import os

        if not os.path.exists(self._persist_path):
            return
        try:
            with open(self._persist_path) as f:
                state = json.load(f)
        except (OSError, ValueError):
            return  # torn/corrupt registry never blocks startup
        with self._lock:
            for rec in state.get("nodes", []):
                self._nodes[rec["node_id"]] = NodeInfo(
                    node_id=rec["node_id"],
                    address=rec["address"],
                    online=bool(rec.get("online", True)),
                    registered_at=float(rec.get("registered_at", 0.0)),
                )
            # resume PAST the recorded epoch so any coordinator state
            # keyed to pre-restart epochs (a federation's _synced_epoch
            # starts at -1 anyway) reads as stale until re-synced
            self._map_epoch = int(state.get("map_epoch", 0))
            self._rebuild_shard_map_locked()

    def _persist_locked(self) -> None:
        if not self._persist_path:
            return
        import json
        import os

        state = {
            "map_epoch": self._map_epoch,
            "nodes": [
                {"node_id": n.node_id, "address": n.address,
                 "online": n.online, "registered_at": n.registered_at}
                for n in self._nodes.values() if not n.is_virtual
            ],
        }
        tmp = self._persist_path + ".tmp"
        try:
            os.makedirs(os.path.dirname(self._persist_path) or ".",
                        exist_ok=True)
            with open(tmp, "w") as f:
                json.dump(state, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._persist_path)
            self.persist_last_error = None
        except OSError as e:
            # registry persistence is best-effort (serving continues),
            # but the failure must be VISIBLE: a coordinator whose disk
            # silently stopped accepting the journal would otherwise
            # restart with an empty cluster map and the operator would
            # only learn at the restart. Counter
            # + last error surface through /rpc/list_nodes; the log line
            # rate-limits to state changes so a dead disk doesn't spam.
            self.persist_failures_total += 1
            prev = self.persist_last_error
            self.persist_last_error = f"{type(e).__name__}: {e}"
            if prev != self.persist_last_error:
                logger.error(
                    "membership registry persist FAILED (%s) — cluster "
                    "map will NOT survive a coordinator restart until "
                    "this clears: %s",
                    self._persist_path, self.persist_last_error)

    def persist_health(self) -> Dict[str, object]:
        """Registry-journal health for the ops surface (list_nodes):
        whether persistence is configured, how many writes have failed,
        and the last error. A non-null last_error means the cluster map
        will NOT survive a coordinator restart until it clears."""
        return {
            "enabled": bool(self._persist_path),
            "path": self._persist_path,
            "failures_total": self.persist_failures_total,
            "last_error": self.persist_last_error,
        }

    def subscribe(self, callback) -> None:
        """callback(list_of_NodeInfo) fires after any membership or
        online-status change."""
        with self._lock:
            self._watchers.append(callback)

    def _notify_locked(self):
        nodes = [dataclasses.replace(n) for n in self._nodes.values()]
        for cb in list(self._watchers):
            try:
                cb(nodes)
            except Exception:
                pass

    # ------------------------------------------------------------ membership

    def register_node(self, node_id: str, address: str) -> Dict[int, Dict[str, List[str]]]:
        """Register (or refresh) a node and rebuild the shard map — the same
        full round-robin reassignment the reference performs
        (src/coordinator/handler.py:96-99)."""
        with self._lock:
            self._nodes[node_id] = NodeInfo(node_id=node_id, address=address)
            self._rebuild_shard_map_locked()
            self._notify_locked()
            return dict(self._shard_map)

    def deregister_node(self, node_id: str) -> bool:
        with self._lock:
            if self._nodes.pop(node_id, None) is None:
                return False
            self._rebuild_shard_map_locked()
            self._notify_locked()
            return True

    def register_virtual_nodes(self, n: int, prefix: str = "shard"):
        """One always-online virtual node per logical shard."""
        with self._lock:
            for i in range(n):
                nid = f"{prefix}_{i}"
                self._nodes[nid] = NodeInfo(node_id=nid, address=f"device:{i}")
            self._rebuild_shard_map_locked()

    def _rebuild_shard_map_locked(self):
        online = [nid for nid, n in sorted(self._nodes.items()) if n.online]
        self._shard_map = assign_shards_to_nodes(
            online, self.shard_count, self.replica_count
        )
        # every rebuild moves shard ownership WITHOUT moving data (ref
        # parity, src/coordinator/handler.py:96-99). The epoch lets
        # readers detect "routes may not match data placement" for ALL
        # rebuild triggers — register, deregister, mark_offline/online —
        # until an anti-entropy pass lands (federation.sync_all).
        self._map_epoch += 1
        # every rebuild trigger is a membership/liveness change worth
        # surviving a restart — journal here so no mutator can forget
        self._persist_locked()

    def map_epoch(self) -> int:
        """Monotonic counter of shard-map rebuilds (see above)."""
        with self._lock:
            return self._map_epoch

    def list_nodes(self) -> List[NodeInfo]:
        with self._lock:
            return [dataclasses.replace(n) for n in self._nodes.values()]

    def get_node(self, node_id: str) -> Optional[NodeInfo]:
        with self._lock:
            n = self._nodes.get(node_id)
            return dataclasses.replace(n) if n else None

    def online_nodes(self) -> List[str]:
        with self._lock:
            return [nid for nid, n in self._nodes.items() if n.online]

    # ------------------------------------------------------------- shard map

    def get_shard_nodes(self, shard_id: int) -> Dict[str, List[str]]:
        """Master + slaves for a shard, with master->first-online-slave
        failover (parity: src/utils/zk_manager.py:139-157 — but here the
        failover is real because replicas actually hold data)."""
        with self._lock:
            entry = self._shard_map.get(shard_id, {"master": [], "slaves": []})
            masters = entry.get("master", [])
            if masters:
                m = self._nodes.get(masters[0])
                if m is not None and m.online:
                    return {"master": list(masters), "slaves": list(entry["slaves"])}
            for s in entry.get("slaves", []):
                n = self._nodes.get(s)
                if n is not None and n.online:
                    return {"master": [s], "slaves": [x for x in entry["slaves"] if x != s]}
            return {"master": [], "slaves": []}

    def shard_map(self) -> Dict[int, Dict[str, List[str]]]:
        with self._lock:
            return {k: {"master": list(v["master"]), "slaves": list(v["slaves"])}
                    for k, v in self._shard_map.items()}

    # ---------------------------------------------------------------- health

    def mark_offline(self, node_id: str):
        """Parity: the coordinator marks a node offline when a connection
        fails (src/coordinator/handler.py:128-130)."""
        with self._lock:
            n = self._nodes.get(node_id)
            if n is not None and n.online:
                n.online = False
                self._rebuild_shard_map_locked()
                self._notify_locked()

    def mark_online(self, node_id: str):
        with self._lock:
            n = self._nodes.get(node_id)
            if n is not None and not n.online:
                n.online = True
                n.last_seen = time.time()
                self._rebuild_shard_map_locked()
                self._notify_locked()

    def probe(self, node: NodeInfo) -> bool:
        """TCP-connect probe (parity: src/utils/zk_manager.py:85-99).
        Virtual in-process nodes are always healthy."""
        if node.is_virtual:
            return True
        try:
            host, port_s = node.address.rsplit(":", 1)
            with socket.create_connection((host, int(port_s)), timeout=self.probe_timeout_s):
                return True
        except OSError:
            return False

    def check_health_once(self) -> Dict[str, bool]:
        results = {}
        for node in self.list_nodes():
            ok = self.probe(node)
            results[node.node_id] = ok
            if ok:
                self.mark_online(node.node_id)
            else:
                self.mark_offline(node.node_id)
        return results

    def start_health_loop(self):
        if self._health_thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.health_interval_s):
                try:
                    self.check_health_once()
                except Exception:
                    pass

        self._health_thread = threading.Thread(target=loop, daemon=True,
                                               name="tpuvdb-health")
        self._health_thread.start()

    def stop_health_loop(self):
        self._stop.set()
        if self._health_thread is not None:
            self._health_thread.join(timeout=2)
            self._health_thread = None
