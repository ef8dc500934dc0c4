"""Service facade, one object exposing every RPC: the port of
tpuvdb.api.service.

One facade serves the coordinator surface (register_node, list_nodes, put,
delete, get, search, ...) and the node-internal RPCs over the in-process
engine, on `device` (None = cuda; pass "cpu" to run on the CPU) and, with
`mesh`, over the mesh's slots (mesh/). Both the
HTTP server and the embedded CLI mode dispatch through `handle()`, which
turns any exception into a failed Response. The method names, parameters
and response dicts are the reference's, so a client of either package
talks to a server of either.

The application layer's text and image search (`text_search`,
`put_image`) embeds with the CLIP towers (embed/clip.py), loaded at first
use on the service's device unless an embedder is passed in.
`rpc_profile` traces with torch.profiler (utils/tracing.device_trace).
"""

from __future__ import annotations

import os
import tempfile
from typing import Any, Dict, Optional

import numpy as np

from tpuvdb_torch.cluster.membership import NodeRegistry
from tpuvdb_torch.core.config import DBConfig
from tpuvdb_torch.core.types import Response, SearchRequest, VectorData
from tpuvdb_torch.engine.engine import VectorDBEngine
from tpuvdb_torch.utils.logging import get_logger

logger = get_logger("tpuvdb_torch.service")


class DBService:
    def __init__(
        self,
        config: Optional[DBConfig] = None,
        data_dir: Optional[str] = None,
        mesh=None,
        embedder=None,
        image_root: Optional[str] = None,
        device=None,
    ):
        self.config = config or DBConfig()
        self.engine = VectorDBEngine(self.config, data_dir=data_dir,
                                     mesh=mesh, device=device)
        self.registry = NodeRegistry(
            shard_count=self.config.shard_count,
            replica_count=self.config.replica_count,
            health_interval_s=self.config.health_check_interval_s,
        )
        # one always-online virtual node per shard, or per mesh slot
        n_virtual = mesh.size if mesh is not None else self.config.shard_count
        self.registry.register_virtual_nodes(n_virtual)
        # long-running server: drain staged writes off the query path
        self.engine.start_background_flush()
        self._embedder = embedder
        self.image_root = image_root
        # coalesce concurrent unfiltered searches into one device batch,
        # and concurrent single-record puts into one group commit
        from tpuvdb_torch.api.batching import BatchingSearcher, BatchingWriter

        self.batcher = BatchingSearcher(self.engine)
        self.writer = BatchingWriter(self.engine)
        # batcher fast-path failures are counted + rate-limit logged (a
        # silent fall-through would hide a real batcher bug as latency)
        self._batcher_fallbacks = 0
        self._last_fallback_log = 0.0

    # ------------------------------------------------------------- embedder

    @property
    def embedder(self):
        if self._embedder is None:
            from tpuvdb_torch.embed.clip import load_default_embedder

            self._embedder = load_default_embedder(self.config.vector_dim,
                                                   device=self.engine.device)
        return self._embedder

    # ------------------------------------------------------------- dispatch

    def handle(self, method: str, params: Dict[str, Any]) -> Dict[str, Any]:
        fn = getattr(self, f"rpc_{method}", None)
        if fn is None:
            return Response.fail(f"unknown method: {method}").to_dict()
        try:
            return fn(params)
        except Exception as e:  # surface as a failed Response, not a 500
            return Response.fail(f"{type(e).__name__}: {e}").to_dict()

    # ----------------------------------------------------- coordinator RPCs

    def _route_check(self, key: str) -> Optional[Response]:
        """Reference routing semantics: an op on a key whose shard has no
        online master fails (src/coordinator/handler.py:120-130). Virtual
        in-process nodes are always online, so this only fires when an
        operator drains/offlines nodes."""
        from tpuvdb_torch.utils.sharding_utils import get_shard_id

        shard = get_shard_id(key, self.config.shard_count)
        nodes = self.registry.get_shard_nodes(shard)
        if not nodes["master"]:
            return Response.fail(
                f"no online node for shard {shard} (key {key!r})"
            )
        return None

    def rpc_put(self, p: Dict[str, Any]) -> Dict[str, Any]:
        vd = VectorData.from_dict(p)
        err = self._route_check(vd.key)
        if err is not None:
            return err.to_dict()
        # group commit: concurrent single-record puts share one WAL fsync
        # (engine.put fsyncs per record — 30x slower under REST ingest)
        return self.writer.put(vd).to_dict()

    def rpc_put_batch(self, p: Dict[str, Any]) -> Dict[str, Any]:
        if "records" not in p:
            # a misspelled field ("items", "vectors", ...) used to return
            # success for an empty batch — fail loudly instead
            return Response.fail(
                "put_batch expects a 'records' list "
                f"(got keys: {sorted(p)})").to_dict()
        batch = [VectorData.from_dict(d) for d in p["records"]]
        return self.engine.put_batch(batch).to_dict()

    def rpc_get(self, p: Dict[str, Any]) -> Dict[str, Any]:
        err = self._route_check(p["key"])
        if err is not None:
            return err.to_dict()
        return self.engine.get(p["key"]).to_dict()

    def rpc_delete(self, p: Dict[str, Any]) -> Dict[str, Any]:
        err = self._route_check(p["key"])
        if err is not None:
            return err.to_dict()
        return self.engine.delete(p["key"]).to_dict()

    def rpc_search(self, p: Dict[str, Any]) -> Dict[str, Any]:
        # host-inclusive stage: request decode -> batcher/device -> reply
        # dict built
        with self.engine.timers.stage("service.search"):
            return self._rpc_search_timed(p)

    def _rpc_search_timed(self, p: Dict[str, Any]) -> Dict[str, Any]:
        req = SearchRequest.from_dict(p)
        if not req.filter_metadata and req.threshold <= 0:
            # fast path: unfiltered searches share one device batch
            try:
                return self._batched_search_response(req).to_dict()
            except Exception:
                # fall through to the direct path, but never silently:
                # count it (surfaces in info) and log at most 1/10s
                import time as _time

                self._batcher_fallbacks += 1
                now = _time.monotonic()
                if now - self._last_fallback_log > 10.0:
                    self._last_fallback_log = now
                    logger.exception(
                        "batched search fast path failed (%d total); "
                        "serving via the direct path",
                        self._batcher_fallbacks,
                    )
        return self.engine.search(req).to_dict()

    def _batched_search_response(self, req: SearchRequest) -> Response:
        from tpuvdb_torch.core.types import SearchHit, SearchResult

        k = req.top_k if req.top_k > 0 else self.config.default_top_k
        with self.engine.timers.stage("service.batcher_wait"):
            dists, keys = self.batcher.search(
                req.query_np(self.config.vector_dim), k
            )
        hits = []
        with self.engine._lock:  # entry + vector from one generation
            for key, score in zip(keys, dists):
                if key is None:
                    continue
                e = self.engine.docstore.get(key)
                if e is None:
                    continue
                vec = self.engine.mirrors[e.shard].vector_at(e.slot)
                hits.append(SearchHit(key=key, score=float(score),
                                      vector=[float(x) for x in vec],
                                      metadata=dict(e.metadata)))
        return Response.ok(
            f"{len(hits)} results",
            search_result=SearchResult.from_hits(hits),
        )

    def rpc_search_batch(self, p: Dict[str, Any]) -> Dict[str, Any]:
        """Bulk search: {"query_vectors": [[...], ...], "top_k": N} ->
        {"results": [SearchResult-dict, ...]} — one device batch for the
        whole request (the scan cost is batch-amortized)."""
        qs = np.asarray(p["query_vectors"], np.float32)
        if qs.ndim != 2 or qs.shape[1] != self.config.vector_dim:
            return Response.fail(
                f"expected (*, {self.config.vector_dim}) query_vectors, "
                f"got {qs.shape}").to_dict()
        k = int(p.get("top_k", self.config.default_top_k))
        dists, keys = self.engine.search_batch(qs, k)
        from tpuvdb_torch.core.types import SearchHit, SearchResult

        results = []
        with self.engine._lock:
            for qi in range(qs.shape[0]):
                hits = []
                # search_batch returns the FULL fetch width (rescore
                # overfetch can be 16x k) — truncate to the caller's k
                for key, score in zip(keys[qi], dists[qi]):
                    if key is None:
                        continue
                    e = self.engine.docstore.get(key)
                    if e is None:
                        continue
                    hits.append(SearchHit(key=key, score=float(score),
                                          metadata=dict(e.metadata)))
                    if len(hits) == k:
                        break
                results.append(
                    SearchResult.from_hits(hits, include_vectors=False).to_dict())
        d = Response.ok(f"{len(results)} result sets").to_dict()
        d["results"] = results
        return d

    def rpc_register_node(self, p: Dict[str, Any]) -> Dict[str, Any]:
        self.registry.register_node(p["node_id"], p["address"])
        return Response.ok(f"registered {p['node_id']}").to_dict()

    def rpc_list_nodes(self, p: Dict[str, Any]) -> Dict[str, Any]:
        # the reference smuggles the node list through VectorData.metadata
        # (src/coordinator/handler.py:105-114); here it's a proper field
        nodes = [
            {
                "node_id": n.node_id,
                "address": n.address,
                "online": n.online,
                "virtual": n.is_virtual,
            }
            for n in self.registry.list_nodes()
        ]
        d = Response.ok(f"{len(nodes)} nodes").to_dict()
        d["nodes"] = nodes
        d["shard_map"] = {str(k): v for k, v in self.registry.shard_map().items()}
        # journal health: a failing registry disk means the cluster map
        # will not survive a coordinator restart
        d["registry_persist"] = self.registry.persist_health()
        return d

    def rpc_info(self, p: Dict[str, Any]) -> Dict[str, Any]:
        d = Response.ok("info").to_dict()
        d["info"] = self.engine.info()
        d["info"]["batcher_fallbacks"] = self._batcher_fallbacks
        return d

    def rpc_flush(self, p: Dict[str, Any]) -> Dict[str, Any]:
        self.engine.flush()
        return Response.ok("flushed").to_dict()

    def rpc_compact(self, p: Dict[str, Any]) -> Dict[str, Any]:
        self.engine.compact()
        return Response.ok("compacted").to_dict()

    def rpc_checkpoint(self, p: Dict[str, Any]) -> Dict[str, Any]:
        path = self.engine.save_checkpoint()
        return Response.ok(path or "no durable storage configured").to_dict()

    def rpc_profile(self, p: Dict[str, Any]) -> Dict[str, Any]:
        """Capture a torch.profiler trace (host and CUDA activity of every
        thread: the handlers', the batchers' and the flush's) for N
        seconds into log_dir/trace.json (Chrome trace format)."""
        import time as _time

        log_dir = p.get("log_dir",
                        os.path.join(tempfile.gettempdir(),
                                     "tpuvdb_torch_trace"))
        seconds = min(float(p.get("seconds", 3.0)), 60.0)
        from tpuvdb_torch.utils.tracing import device_trace

        with device_trace(log_dir):
            _time.sleep(seconds)
        return Response.ok(f"trace written to {log_dir}").to_dict()

    # ---------------------------------------------- node-internal RPCs

    def rpc_offline(self, p: Dict[str, Any]) -> Dict[str, Any]:
        """Mark a node offline (graceful drain)."""
        node_id = p["node_id"]
        if self.registry.get_node(node_id) is None:
            return Response.fail(f"unknown node: {node_id}").to_dict()
        self.registry.mark_offline(node_id)
        return Response.ok(f"{node_id} offline").to_dict()

    def rpc_replay_wal(self, p: Dict[str, Any]) -> Dict[str, Any]:
        """Re-apply the WAL tail past a given LSN (0 = full replay)."""
        if self.engine.wal is None:
            return Response.fail("no durable storage configured").to_dict()
        after = int(p.get("after_seq", 0))
        n = 0
        for rec in self.engine.wal.replay(after_seq=after):
            if rec.get("op") == "put":
                self.engine.put(VectorData(
                    key=rec["key"], vector=rec["vector"],
                    metadata=rec.get("metadata", {}),
                    timestamp=rec.get("timestamp", 0)), replay_mode=True)
            elif rec.get("op") == "delete":
                self.engine.delete(rec["key"], replay_mode=True)
            n += 1
        return Response.ok(f"replayed {n} records").to_dict()

    def rpc_get_all_keys(self, p: Dict[str, Any]) -> Dict[str, Any]:
        """Enumerate stored keys (the get_all_vectors analog; vectors are
        fetched per key to keep responses bounded)."""
        limit = int(p.get("limit", 10_000))
        keys = self.engine.docstore.keys()[:limit]
        d = Response.ok(f"{len(keys)} keys").to_dict()
        d["keys"] = keys
        return d

    def _export_keys_snapshot(self) -> list:
        """Sorted-key snapshot for export pagination, cached per mutation
        generation: re-sorting the full key list on every page would make
        a multi-page export O(pages * n log n). A mutation mid-export rebuilds the snapshot — the same cursor-drift
        semantics the per-page sort already had, at 1/pages the cost."""
        gen = (self.engine._mut_count, len(self.engine.docstore))
        cached = getattr(self, "_export_cache", None)
        if cached is not None and cached[0] == gen:
            return cached[1]
        keys = sorted(self.engine.docstore.keys())
        self._export_cache = (gen, keys)
        return keys

    def rpc_export(self, p: Dict[str, Any]) -> Dict[str, Any]:
        """Paginated bulk export: returns `limit` records starting at
        `cursor` (a key-sorted offset), plus the next cursor or -1 when
        done. Used by the CLI's `export` for backups and by the federated
        coordinator's sync."""
        cursor = int(p.get("cursor", 0))
        limit = min(int(p.get("limit", 1000)), 10_000)
        keys = self._export_keys_snapshot()
        # optional CLUSTER-shard filter (streaming anti-entropy): the
        # coordinator passes its own modulus explicitly — the node's
        # engine shard_count is a device-level setting and need not match
        # the cluster's key-routing shard count
        if "shard" in p:
            from tpuvdb_torch.utils.sharding_utils import get_shard_id

            want = int(p["shard"])
            mod = int(p["shard_count"])
            keys = [k for k in keys if get_shard_id(k, mod) == want]
        page = keys[cursor : cursor + limit]
        records = []
        with self.engine._lock:
            for key in page:
                e = self.engine.docstore.get(key)
                if e is None:
                    continue
                vec = self.engine.mirrors[e.shard].vector_at(e.slot)
                # the vector stays an ndarray: the binary wire ships it as
                # raw f32 bytes; JSON responses list-ify it at the server
                # (_json_default) — to_dict's per-float python loop was
                # ~40% of export page cost at 768-d
                records.append({
                    "key": key,
                    "vector": np.asarray(vec, np.float32),
                    "metadata": dict(e.metadata),
                    "timestamp": int(e.timestamp),
                })
        d = Response.ok(f"{len(records)} records").to_dict()
        d["records"] = records
        d["cursor"] = cursor + limit if cursor + limit < len(keys) else -1
        d["total"] = len(keys)
        return d

    def rpc_replicate(self, p: Dict[str, Any]) -> Dict[str, Any]:
        """Apply a replicated op from a peer (the federated coordinator's
        replication and sync)."""
        op = p.get("op_type", "put")
        if op == "put":
            vd = VectorData.from_dict(p["data"])
            return self.engine.put(vd, replay_mode=bool(p.get("no_wal"))).to_dict()
        if op == "delete":
            return self.engine.delete(p["data"]["key"]).to_dict()
        return Response.fail(f"unknown op_type: {op}").to_dict()

    def rpc_replicate_batch(self, p: Dict[str, Any]) -> Dict[str, Any]:
        """Batched peer replication: N ops in ONE wire round-trip and one
        WAL group commit (the federation's anti-entropy push). Put
        timestamps are preserved (newest-wins merge semantics are the
        caller's; put_batch stores what it is given). Deletes apply
        individually after the puts (rare on this path: prune only)."""
        ops = p.get("ops", [])
        puts = [VectorData.from_dict(o["data"]) for o in ops
                if o.get("op_type", "put") == "put"]
        dels = [o["data"]["key"] for o in ops
                if o.get("op_type") == "delete"]
        applied = 0
        if puts:
            r = self.engine.put_batch(puts,
                                      replay_mode=bool(p.get("no_wal")))
            if not r.success:
                return r.to_dict()
            applied += len(puts)
        for key in dels:
            if self.engine.delete(key).success:
                applied += 1
        return Response.ok(f"applied {applied}").to_dict()

    # ------------------------------------------------- application layer

    def text_search(self, text: str, topk: int = 5) -> Dict[str, Any]:
        """Text -> image search (the reference's text_search and
        /api/search): {results: [{key, file_path, score, metadata}]}."""
        qvec = self.embedder.text2vec(text)
        hits = self.engine.search_hits(qvec, topk)
        results = []
        for h in hits:
            results.append({
                "key": h.key,
                "file_path": h.metadata.get("file_path", h.key),
                "score": h.score,
                "metadata": h.metadata,
            })
        return {"results": results}

    def put_image(self, image_path: str, key: Optional[str] = None,
                  dataset: str = "default") -> Dict[str, Any]:
        """Embed + ingest one image (the reference's put_image)."""
        vec = self.embedder.image2vec(image_path)
        key = key or os.path.basename(image_path)
        vd = VectorData(
            key=key,
            vector=vec,
            metadata={
                "file_path": image_path,
                "dataset": dataset,
                "dim": str(self.config.vector_dim),
            },
        )
        return self.engine.put(vd).to_dict()

    def close(self):
        self.registry.stop_health_loop()
        self.batcher.close()
        self.writer.close()
        self.engine.close()
