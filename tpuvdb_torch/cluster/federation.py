"""Federated coordinator for multi-host deployments over TCP: the port of
tpuvdb.cluster.federation.

  * data nodes are plain `serve` instances that register here; they may
    be nodes of either package, since both speak the same wire;
  * `put`/`get`/`delete` route by MD5 shard hash to the shard's master
    node, with mark-offline-on-connection-failure;
  * `search` fans out to ALL online nodes in parallel and merges with
    dedup-by-key + ascending sort + truncation;
  * node failure mid-search degrades to partial results (skip and
    continue).

Replication: puts are also forwarded to slave nodes via the `replicate`
RPC (`replica_count`), acknowledged after `write_acks` copies, and
anti-entropy (`sync_all`, `sync_node`) re-places each shard's newest
records on its current owners.

Text and image search embed at the coordinator with the CLIP towers
(embed/clip.py), loaded at first use on its `device` (None = cuda) unless
an embedder is passed in.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from typing import Any, Dict, List, Optional, Tuple

from tpuvdb_torch.api.client import DBClient
from tpuvdb_torch.cluster.membership import NodeRegistry
from tpuvdb_torch.core import errors
from tpuvdb_torch.core.config import DBConfig
from tpuvdb_torch.core.types import (
    Response,
    SearchRequest,
    SearchResult,
    VectorData,
)
from tpuvdb_torch.utils.logging import get_logger
from tpuvdb_torch.utils.sharding_utils import get_shard_id

logger = get_logger("tpuvdb_torch.federation")


class FederatedCoordinator:
    def __init__(self, config: Optional[DBConfig] = None,
                 max_workers: int = 16, embedder=None, device=None):
        self.config = config or DBConfig()
        # text/image embedding runs at the coordinator, on `device`
        self._embedder = embedder
        self.device = device
        import os as _os

        self.registry = NodeRegistry(
            shard_count=self.config.shard_count,
            replica_count=self.config.replica_count,
            health_interval_s=self.config.health_check_interval_s,
            # durable membership: with a data_dir the
            # coordinator resumes its node table + shard map after a
            # restart; nodes need not re-register (routes stay stale until
            # the first sync_all, exactly like any membership change)
            persist_path=(_os.path.join(self.config.data_dir,
                                        "registry.json")
                          if self.config.data_dir else None),
        )
        self._clients: Dict[str, DBClient] = {}
        self._clients_lock = threading.Lock()
        self._pool = ThreadPoolExecutor(max_workers=max_workers,
                                        thread_name_prefix="tpuvdb-torch-fed")
        # Shard-map epoch this coordinator last fully rebalanced at.
        # Routes are STALE whenever the registry's epoch differs — every
        # map rebuild (register, deregister, mark_offline/online) moves
        # shard ownership WITHOUT data migration. Only while stale may
        # get() distrust a clean not-found from a reachable master —
        # outside that window, asking other nodes would resurrect deleted
        # keys from stale replicas. An epoch (not a bool) so a membership
        # change DURING sync_all keeps routes stale. -1 = never synced:
        # stale until the first sync_all.
        self._synced_epoch = -1
        self._rebalance_lock = threading.Lock()
        self._rebalance_pending = False
        if self.config.rebalance_debounce_s > 0:
            # auto-close the stale window: without this, one offline/
            # online flap (epoch bump, no operator action) leaves every
            # clean miss broadcasting to all nodes forever
            self.registry.subscribe(self._on_membership_change)

    @property
    def _routes_stale(self) -> bool:
        return self.registry.map_epoch() != self._synced_epoch

    def _on_membership_change(self, _nodes) -> None:
        with self._rebalance_lock:
            if self._rebalance_pending:
                return  # single-flight; the running worker re-checks
            self._rebalance_pending = True
        self._pool.submit(self._rebalance_until_current)

    def _rebalance_until_current(self) -> None:
        """Debounced background sync_all, repeated while routes trail the
        registry's map epoch (bounded: persistent churn ends with routes
        stale and the next membership change re-arms)."""
        epoch_at_exit = self.registry.map_epoch()
        try:
            time.sleep(self.config.rebalance_debounce_s)  # coalesce flaps
            for attempt in range(8):
                if not self._routes_stale:
                    break
                if attempt:
                    # each retry re-exports every node's dataset: back off
                    # between attempts so persistent churn doesn't become
                    # an 8x back-to-back full-cluster data burst
                    time.sleep(self.config.rebalance_debounce_s)
                r = self.sync_all()
                logger.info("auto rebalance: %s", r.message)
            epoch_at_exit = self.registry.map_epoch()
        except Exception:
            logger.exception("auto rebalance failed")
        finally:
            with self._rebalance_lock:
                self._rebalance_pending = False
            # TOCTOU: a membership change landing between our last
            # staleness check and the flag clear saw pending=True and
            # skipped scheduling — re-arm for the MOVED epoch (not for a
            # merely-failed sync: attempts are deliberately bounded, and
            # an unsyncable cluster must not retry forever; the next real
            # membership change re-arms that case).
            if self.registry.map_epoch() != epoch_at_exit:
                self._on_membership_change(None)

    # ---------------------------------------------------------------- helpers

    def _client(self, node_id: str) -> Optional[DBClient]:
        node = self.registry.get_node(node_id)
        if node is None or not node.online:
            return None
        with self._clients_lock:
            c = self._clients.get(node_id)
            if c is None:
                # binary wire: node-to-node bulk transfers (export/
                # replicate/sync) move raw f32 vectors, not JSON text
                c = DBClient(node.address, timeout=self.config.rpc_timeout_s,
                             binary=True)
                self._clients[node_id] = c
            return c

    def _call_node(self, node_id: str, method: str,
                   params: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        """One RPC; connection failure marks the node offline (ref parity)."""
        c = self._client(node_id)
        if c is None:
            return None
        try:
            return c.call(method, params)
        except OSError as e:
            logger.warning("node %s unreachable (%s); marking offline",
                           node_id, e)
            self.registry.mark_offline(node_id)
            return None

    def _master_for_key(self, key: str) -> Optional[str]:
        shard = get_shard_id(key, self.config.shard_count)
        nodes = self.registry.get_shard_nodes(shard)
        return nodes["master"][0] if nodes["master"] else None

    def _slaves_for_key(self, key: str) -> List[str]:
        shard = get_shard_id(key, self.config.shard_count)
        return self.registry.get_shard_nodes(shard)["slaves"]

    # ------------------------------------------------------------ membership

    def register_node(self, node_id: str, address: str) -> Response:
        known = self.registry.get_node(node_id) is not None
        # the registry bumps its map epoch on the rebuild this triggers,
        # which flips _routes_stale until the next completed sync_all
        self.registry.register_node(node_id, address)
        # a rejoining node usually comes back at a NEW address — drop any
        # cached client or every call would hit the dead socket
        with self._clients_lock:
            stale = self._clients.pop(node_id, None)
        if stale is not None:
            stale.close()
        logger.info("registered node %s at %s", node_id, address)
        if known and self.config.rebalance_debounce_s <= 0:
            # rejoin after a death: the node's replicas are stale — pull it
            # up to date in the background. Only when auto-rebalance is OFF:
            # the registration above bumped the map epoch, so an armed
            # debounced sync_all already covers the rejoined node — running
            # both meant two back-to-back full-cluster exports per rejoin.
            self._pool.submit(self._sync_quietly, node_id)
        return Response.ok(f"registered {node_id}")

    def _sync_quietly(self, node_id: str):
        try:
            r = self.sync_node(node_id)
            logger.info("rejoin sync for %s: %s", node_id, r.message)
        except Exception:
            logger.exception("rejoin sync for %s failed", node_id)

    # ------------------------------------------------------------------- ops

    def put(self, data: VectorData) -> Response:
        master = self._master_for_key(data.key)
        if master is None:
            return Response.fail(
                f"no online node for shard of key {data.key!r}")
        r = self._call_node(master, "put", data.to_dict())
        if r is None:
            return Response.fail(f"master {master} unreachable")
        # replicate to slaves. write_acks=1 acks after the master alone
        # (async replicas); write_acks>=2 waits for replica acks, closing
        # the acked-but-unreplicated durability window.
        futs = [
            self._pool.submit(self._call_node, slave, "replicate",
                              {"op_type": "put", "data": data.to_dict(),
                               "no_wal": False})
            for slave in self._slaves_for_key(data.key)
        ]
        err = self._await_replica_acks(futs)
        if err is not None:
            return err
        return Response.from_dict(r)

    def _await_replica_acks(self, futs) -> Optional[Response]:
        """Wait for write_acks-1 replica successes (None = satisfied).
        One SHARED deadline across all futures: waiting rpc_timeout_s per
        future in list order would block on a slow slave even after a
        later slave acked, degrading put latency to the sum of timeouts."""
        need = min(self.config.write_acks - 1, len(futs))
        if need <= 0:
            return None
        got = 0
        pending = set(futs)
        deadline = time.monotonic() + self.config.rpc_timeout_s
        while pending:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            done, pending = wait(pending, timeout=remaining,
                                 return_when=FIRST_COMPLETED)
            for fut in done:
                try:
                    r = fut.result()
                except Exception:
                    r = None
                if r is not None and r.get("success"):
                    got += 1
                    if got >= need:
                        return None
        return Response.fail(
            f"quorum not met: {got + 1}/{need + 1} acks (written on the "
            "master; replicas will converge via sync)")

    def get(self, key: str) -> Response:
        master = self._master_for_key(key)
        if master is None:
            return Response.fail(f"no online node for shard of key {key!r}")
        tried = {master}
        r = self._call_node(master, "get", {"key": key})
        if r is not None and r.get("success"):
            return Response.from_dict(r)
        # A REACHABLE master's CLEAN not-found is authoritative: asking
        # replicas (whose async delete may still be in flight) or the
        # whole cluster would resurrect deleted keys from stale copies.
        # Failover reads run when the master is unreachable OR errored for
        # any other reason (handler exception, mid-recovery) — only the
        # literal "key not found" response skips them — and while routes
        # are stale (shard ownership moved without data migration), where
        # the record may legitimately live on another node.
        clean_miss = (r is not None and not r.get("success")
                      and str(r.get("message", "")).startswith(
                          errors.NOT_FOUND_PREFIX))
        if not clean_miss:
            # failover read: slaves hold real replicas here
            for slave in self._slaves_for_key(key):
                tried.add(slave)
                r2 = self._call_node(slave, "get", {"key": key})
                if r2 is not None and r2.get("success"):
                    return Response.from_dict(r2)
                r = r or r2
        if (r is None or not r.get("success")) and self._routes_stale:
            # membership changed and no rebalance has landed yet: the
            # record may live on a node no longer in the shard group —
            # ask everyone before failing (closed again by sync_all)
            for nid in self.registry.online_nodes():
                if nid in tried:
                    continue
                r2 = self._call_node(nid, "get", {"key": key})
                if r2 is not None and r2.get("success"):
                    return Response.from_dict(r2)
        return Response.from_dict(r) if r else Response.fail(
            f"no reachable replica for key {key!r}")

    def delete(self, key: str) -> Response:
        master = self._master_for_key(key)
        if master is None:
            return Response.fail(f"no online node for shard of key {key!r}")
        r = self._call_node(master, "delete", {"key": key})
        futs = [
            self._pool.submit(self._call_node, slave, "replicate",
                              {"op_type": "delete", "data": {"key": key}})
            for slave in self._slaves_for_key(key)
        ]
        err = self._await_replica_acks(futs)
        if err is not None:
            return err
        return Response.from_dict(r) if r else Response.fail(
            f"master {master} unreachable")

    # ------------------------------------------------------------ anti-entropy

    def sync_all(self, prune: bool = False) -> Response:
        """Rebalance: run anti-entropy shard by shard (after membership
        changes move shard ownership, this re-places each shard's data
        onto its current master+slaves).

        Streaming: each cluster shard is exported,
        unioned, pushed, and dropped before the next begins — peak
        coordinator memory is one shard's records times the copies that
        exist of them, not the whole cluster's corpus. A 10M-row cluster
        rebalance holds ~10M/shard_count records at a time; the old
        whole-corpus `_freshest_union` materialized every node's full
        export in one dict."""
        # capture the epoch FIRST: a membership change while syncing
        # bumps it, so _synced_epoch below records a topology we actually
        # finished rebalancing — routes stay stale for the new one
        epoch0 = self.registry.map_epoch()
        online = sorted(self.registry.online_nodes())
        if not online:
            return Response.ok("no online nodes")
        smap = self.registry.shard_map()
        pushed = {nid: 0 for nid in online}
        pruned = {nid: 0 for nid in online}
        failed: set = set()
        self._sync_peak_records = 0
        for shard in range(self.config.shard_count):
            # sources = EVERY online node (not just the shard's current
            # group): membership churn moves ownership without moving
            # data, so the freshest copy of a key may live on a node
            # outside the group entirely — but only this shard's keys
            # leave each node (node-side filter in rpc_export)
            freshest, exports = self._freshest_shard(shard, online)
            failed.update(n for n in online if n not in exports)
            owners = [n for n in (smap.get(shard, {}).get("master", [])
                                  + smap.get(shard, {}).get("slaves", []))
                      if n in exports]
            for nid in owners:
                p, d = self._push_shard(nid, freshest, exports[nid], prune)
                pushed[nid] += p
                pruned[nid] += d
        if not failed:
            # every shard's data is back on its current owners: reachable
            # not-found is authoritative again (see get())
            self._synced_epoch = epoch0
        msgs = [f"{nid}: {pushed[nid]} pushed, {pruned[nid]} pruned"
                for nid in online if nid not in failed]
        msgs += [f"{nid}: export failed" for nid in sorted(failed)]
        return Response.ok("; ".join(msgs))

    def _freshest_shard(self, shard: int, source_nodes):
        """Export ONE cluster shard's records from each source node;
        newest-timestamp-wins union. Returns (freshest, exports) scoped
        to this shard only — the streaming unit of sync_all/sync_node."""
        freshest: Dict[str, Dict[str, Any]] = {}
        exports: Dict[str, Dict[str, Dict[str, Any]]] = {}
        for nid in source_nodes:
            recs = self._export_all(nid, shard=shard)
            if recs is None:
                continue
            exports[nid] = recs
            for key, rec in recs.items():
                cur = freshest.get(key)
                if (cur is None
                        or rec.get("timestamp", 0) > cur.get("timestamp", 0)):
                    freshest[key] = rec
        # observability + the bounded-memory test hook: the high-water
        # record count held at once during a streaming sync
        held = sum(len(e) for e in exports.values())
        if held > getattr(self, "_sync_peak_records", 0):
            self._sync_peak_records = held
        return freshest, exports

    # records per replicate_batch call: bounds the target's WAL group /
    # wire frame (~512 * 2 KB = ~1 MB of f32 payload at 512-d)
    _PUSH_BATCH = 512

    def _push_shard(self, node_id: str, freshest, mine,
                    prune: bool) -> Tuple[int, int]:
        """Push one shard's freshest records to one of its owners; with
        prune, delete owned keys no peer has. Returns (pushed, pruned).

        Ops go out in replicate_batch chunks: one wire round-trip and
        one target-side WAL group commit per _PUSH_BATCH records instead
        of per record. Nodes that predate the RPC get the per-record
        fallback."""
        ops = []
        for key, rec in freshest.items():
            have = mine.get(key)
            if have is None or (have.get("timestamp", 0)
                                < rec.get("timestamp", 0)):
                ops.append({"op_type": "put", "data": rec})
        if prune:
            ops.extend({"op_type": "delete", "data": {"key": key}}
                       for key in mine if key not in freshest)
        pushed = pruned = 0
        fallback = False
        for lo in range(0, len(ops), self._PUSH_BATCH):
            chunk = ops[lo : lo + self._PUSH_BATCH]
            r = self._call_node(node_id, "replicate_batch", {"ops": chunk})
            if r is not None and r.get("success"):
                pushed += sum(1 for o in chunk if o["op_type"] == "put")
                pruned += sum(1 for o in chunk if o["op_type"] == "delete")
                continue
            if r is not None and "unknown method" in r.get("message", ""):
                fallback = True
                break
            # transport or apply failure: stop pushing to this node (the
            # caller marks shard convergence by epoch, not per record)
            return pushed, pruned
        if not fallback:
            return pushed, pruned
        for o in ops:
            r = self._call_node(node_id, "replicate", o)
            if r is not None and r.get("success"):
                if o["op_type"] == "put":
                    pushed += 1
                else:
                    pruned += 1
        return pushed, pruned

    def _export_all(self, node_id: str,
                    shard: Optional[int] = None
                    ) -> Optional[Dict[str, Dict[str, Any]]]:
        """Pull a node's record map via the paginated export RPC —
        optionally only one cluster shard's keys (the node filters by the
        coordinator's modulus). Returns key -> record dict, or None if
        the node is unreachable."""
        out: Dict[str, Dict[str, Any]] = {}
        cursor = 0
        while cursor >= 0:
            params: Dict[str, Any] = {"cursor": cursor, "limit": 2000}
            if shard is not None:
                params["shard"] = shard
                params["shard_count"] = self.config.shard_count
            r = self._call_node(node_id, "export", params)
            if r is None or not r.get("success"):
                return None
            for rec in r.get("records", []):
                out[rec["key"]] = rec
            cursor = int(r.get("cursor", -1))
        return out

    def sync_node(self, node_id: str, prune: bool = False) -> Response:
        """Anti-entropy catch-up: bring `node_id` up to date from its shard
        peers (the convergence half of replication: a node that died and
        rejoined holds stale data forever without this).

        For every shard the node participates in, the newest copy of each
        key across its online peers wins (VectorData.timestamp ordering)
        and is pushed via the replicate RPC (WAL'd on the target, so the
        repair itself is durable). With prune=True, keys the node holds
        that NO peer has are deleted — that converges deletes that
        happened while the node was down, at the cost of dropping any
        never-replicated write the node alone held (there are no
        tombstones to tell the two apart; default is the safe keep)."""
        target = self.registry.get_node(node_id)
        if target is None or not target.online:
            return Response.fail(f"node {node_id} not online")
        smap = self.registry.shard_map()
        shards = sorted(s for s, g in smap.items()
                        if node_id in g["master"] + g["slaves"])
        online = sorted(self.registry.online_nodes())
        pushed = pruned = 0
        n_peers: set = set()
        self._sync_peak_records = 0
        for shard in shards:
            # O(shard peers), not O(cluster): only
            # this shard's current group can owe its data — EXCEPT while
            # routes are stale (ownership moved without migration), where
            # the freshest copy may live anywhere; fall back to all
            # online nodes there, exactly the window sync_all exists for.
            if self._routes_stale:
                sources = online
            else:
                g = smap.get(shard, {})
                group = set(g.get("master", []) + g.get("slaves", []))
                group.add(node_id)
                sources = [n for n in online if n in group]
            freshest, exports = self._freshest_shard(shard, sources)
            mine = exports.get(node_id)
            if mine is None:
                return Response.fail(f"node {node_id} export failed")
            n_peers.update(n for n in exports if n != node_id)
            p, d = self._push_shard(node_id, freshest, mine, prune)
            pushed += p
            pruned += d
        if not n_peers:
            return Response.ok("no peers to sync from")
        return Response.ok(
            f"synced {node_id}: {pushed} pushed, {pruned} pruned "
            f"from {len(n_peers)} peers over shards {shards}")

    def search(self, req: SearchRequest) -> Response:
        """Parallel scatter-gather with dedup-by-key + ascending merge."""
        nodes = self.registry.online_nodes()
        if not nodes:
            return Response.fail("no online nodes")
        params = req.to_dict()
        futures = {
            nid: self._pool.submit(self._call_node, nid, "search", params)
            for nid in nodes
        }
        best: Dict[str, Dict[str, Any]] = {}  # key -> hit (lowest score wins)
        reached = 0
        for nid, fut in futures.items():
            r = fut.result()
            if not r or not r.get("success"):
                continue  # skip and continue
            reached += 1
            sr = r.get("search_result") or {}
            for i, key in enumerate(sr.get("keys", [])):
                score = sr["scores"][i]
                cur = best.get(key)
                if cur is None or score < cur["score"]:
                    best[key] = {
                        "score": score,
                        "vector": sr["vectors"][i] if i < len(sr.get("vectors", [])) else [],
                        "metadata": sr["metadatas"][i] if i < len(sr.get("metadatas", [])) else {},
                    }
        if reached == 0:
            return Response.fail("all nodes unreachable")
        ordered = sorted(best.items(), key=lambda kv: kv[1]["score"])
        k = req.top_k if req.top_k > 0 else self.config.default_top_k
        out = SearchResult()
        for key, h in ordered[:k]:
            out.keys.append(key)
            out.scores.append(float(h["score"]))
            out.vectors.append(list(h["vector"]))
            out.metadatas.append(dict(h["metadata"]))
        return Response.ok(f"{len(out)} results ({reached} nodes)",
                           search_result=out)

    # ------------------------------------------------------- HTTP dispatch
    # duck-types DBService.handle() so api.server.DBServer can serve a
    # coordinator directly (the CLI's `coordinate`)

    image_root = None

    def handle(self, method: str, params: Dict[str, Any]) -> Dict[str, Any]:
        try:
            if method == "put":
                return self.put(VectorData.from_dict(params)).to_dict()
            if method == "get":
                return self.get(params["key"]).to_dict()
            if method == "delete":
                return self.delete(params["key"]).to_dict()
            if method == "search":
                return self.search(SearchRequest.from_dict(params)).to_dict()
            if method == "sync_all":
                return self.sync_all(prune=bool(params.get("prune"))).to_dict()
            if method == "sync":
                return self.sync_node(params["node_id"],
                                      prune=bool(params.get("prune"))).to_dict()
            if method == "register_node":
                return self.register_node(params["node_id"],
                                          params["address"]).to_dict()
            if method == "list_nodes":
                nodes = [
                    {"node_id": n.node_id, "address": n.address,
                     "online": n.online, "virtual": n.is_virtual}
                    for n in self.registry.list_nodes()
                ]
                d = Response.ok(f"{len(nodes)} nodes").to_dict()
                d["nodes"] = nodes
                d["shard_map"] = {str(k): v for k, v
                                  in self.registry.shard_map().items()}
                # journal health: operators see persist failures instead
                # of discovering an empty map at the next coordinator
                # restart
                d["registry_persist"] = self.registry.persist_health()
                return d
            return Response.fail(f"unknown method: {method}").to_dict()
        except Exception as e:
            return Response.fail(f"{type(e).__name__}: {e}").to_dict()

    @property
    def embedder(self):
        if self._embedder is None:
            from tpuvdb_torch.embed.clip import load_default_embedder

            self._embedder = load_default_embedder(self.config.vector_dim,
                                                   device=self.device)
        return self._embedder

    def text_search(self, text: str, topk: int = 5) -> Dict[str, Any]:
        """Text -> image search against the federated cluster: embed at
        the coordinator, scatter-gather across data nodes, format like
        DBService.text_search, so /api/search and the web frontend work
        the same under `coordinate`."""
        qvec = self.embedder.text2vec(text)
        r = self.search(SearchRequest(
            query_vector=[float(x) for x in qvec], top_k=topk))
        if not r.success or r.search_result is None:
            return {"results": [], "error": r.message}
        sr = r.search_result
        results = []
        for i, key in enumerate(sr.keys):
            meta = sr.metadatas[i] if i < len(sr.metadatas) else {}
            results.append({
                "key": key,
                "file_path": meta.get("file_path", key),
                "score": sr.scores[i],
                "metadata": meta,
            })
        return {"results": results}

    def put_image(self, image_path: str, key: Optional[str] = None,
                  dataset: str = "default") -> Dict[str, Any]:
        """Embed + ingest one image through the federation (routes to the
        shard master + replicates)."""
        import os as _os

        vec = self.embedder.image2vec(image_path)
        key = key or _os.path.basename(image_path)
        return self.put(VectorData(
            key=key,
            vector=vec,
            metadata={
                "file_path": image_path,
                "dataset": dataset,
                "dim": str(self.config.vector_dim),
            },
        )).to_dict()

    def close(self):
        self.registry.stop_health_loop()
        self._pool.shutdown(wait=False)
        with self._clients_lock:
            for c in self._clients.values():
                c.close()
