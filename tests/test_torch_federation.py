"""The port's federated coordinator (tpuvdb_torch/cluster/federation.py)
over real in-process port data-node servers on device="cpu", against the
JAX package's (tpuvdb/cluster/federation.py).

Mirrors tests/test_federation.py (routing, the parallel fan-out merge,
replication, quorum writes, failover, rejoin and anti-entropy sync, stale
routes, auto rebalance, a persisted registry, batched pushes; text search
and put_image with a stub embedder, as there), and adds:
* text search and put_image through real tiny CLIP towers at the
  coordinator, and the coordinator's own embedder loaded on its device;
* a mixed federation: a port coordinator over one JAX node and one port
  node replicates every put to both and answers gets and searches as an
  all-JAX federation does (search_mode "exact").

The JAX nodes' native library is switched off (the reference's build races
between test workers).
"""

import time

import numpy as np
import pytest

from tpuvdb import native as jax_native
from tpuvdb_torch.api.server import DBServer
from tpuvdb_torch.api.service import DBService as _PortService
from tpuvdb_torch.cluster.federation import FederatedCoordinator
from tpuvdb_torch.cluster.membership import NodeRegistry
from tpuvdb_torch.core.config import DBConfig
from tpuvdb_torch.core.types import SearchRequest, VectorData
from tpuvdb_torch.utils.sharding_utils import get_shard_id


@pytest.fixture(autouse=True)
def _no_reference_build(monkeypatch):
    monkeypatch.setattr(jax_native, "available", lambda: False)
    monkeypatch.setattr(jax_native, "rescore_available", lambda: False)


def DBService(config=None, **kw):
    """A port data node on the CPU."""
    return _PortService(config, device="cpu", **kw)


def node_config():
    # rebalance_debounce_s=0: routing tests assert the stale-routes
    # window deterministically (the auto-closer has its own test below)
    return DBConfig(vector_dim=8, shard_count=4, replica_count=1,
                    shard_capacity=1024, block_size=128,
                    rebalance_debounce_s=0)


@pytest.fixture()
def cluster():
    """Three data nodes + a coordinator."""
    nodes = []
    for i in range(3):
        svc = DBService(node_config())
        srv = DBServer(svc, port=0)
        srv.start_background()
        nodes.append((f"n{i}", svc, srv))
    coord = FederatedCoordinator(node_config())
    for nid, _, srv in nodes:
        coord.register_node(nid, srv.address)
    yield coord, nodes
    coord.close()
    for _, svc, srv in nodes:
        srv.shutdown()
        svc.close()


def test_coordinator_over_http(cluster, rng):
    """The coordinator itself served over HTTP (the CLI's `coordinate`
    deployment shape): clients talk to it exactly like to a single node."""
    from tpuvdb_torch.api.client import DBClient

    coord, nodes = cluster
    csrv = DBServer(coord, port=0)
    csrv.start_background()
    try:
        client = DBClient(csrv.address)
        v = rng.standard_normal(8).astype(np.float32)
        assert client.call("put", {"key": "hk", "vector": v.tolist()})["success"]
        r = client.call("search", {"query_vector": v.tolist(), "top_k": 1})
        assert r["success"] and r["search_result"]["keys"] == ["hk"]
        r = client.call("list_nodes", {})
        assert r["success"] and len(r["nodes"]) == 3
    finally:
        csrv.shutdown()


def test_routed_put_get_delete(cluster, rng):
    coord, nodes = cluster
    v = rng.standard_normal(8).astype(np.float32)
    assert coord.put(VectorData(key="fk", vector=v, metadata={"m": "1"})).success
    r = coord.get("fk")
    assert r.success
    np.testing.assert_allclose(r.vector_data.vector, v, rtol=1e-6)
    # the key lives on exactly its shard's master node
    shard = get_shard_id("fk", 4)
    master = coord.registry.get_shard_nodes(shard)["master"][0]
    owners = [nid for nid, svc, _ in nodes if svc.engine.get("fk").success]
    assert master in owners
    assert coord.delete("fk").success
    assert not coord.get("fk").success


def test_parallel_fanout_search_merges(cluster, rng):
    coord, nodes = cluster
    vecs = {}
    for i in range(60):
        v = rng.standard_normal(8).astype(np.float32)
        vecs[f"s{i}"] = v
        assert coord.put(VectorData(key=f"s{i}", vector=v)).success
    r = coord.search(SearchRequest(query_vector=vecs["s17"], top_k=5))
    assert r.success
    assert r.search_result.keys[0] == "s17"
    assert r.search_result.scores == sorted(r.search_result.scores)
    assert len(set(r.search_result.keys)) == len(r.search_result.keys)


def test_node_failure_partial_results_and_failover(cluster, rng):
    coord, nodes = cluster
    vecs = {}
    for i in range(40):
        v = rng.standard_normal(8).astype(np.float32)
        vecs[f"p{i}"] = v
        coord.put(VectorData(key=f"p{i}", vector=v))
    # give best-effort slave replication a moment to land
    time.sleep(0.5)

    # kill one node. NOTE: established keep-alive connections can outlive
    # the accept loop, so (as in production) the TCP health probe is what
    # detects the death — it targets the listening socket.
    dead_id, dead_svc, dead_srv = nodes[0]
    dead_srv.shutdown()
    coord.registry.check_health_once()
    assert coord.registry.get_node(dead_id).online is False
    r = coord.search(SearchRequest(query_vector=vecs["p3"], top_k=10))
    assert r.success

    # replicated reads fail over: keys mastered on the dead node are still
    # gettable via their slave replica
    dead_keys = [k for k in vecs
                 if coord.registry.shard_map()[get_shard_id(k, 4)]
                 ["master"] != [dead_id]]
    # (shard map already failed over; verify a key ORIGINALLY on dead node)
    recovered = 0
    for k in list(vecs)[:20]:
        if coord.get(k).success:
            recovered += 1
    assert recovered >= 10  # survivors + replicas keep most keys readable


def quorum_config():
    cfg = node_config()
    cfg.write_acks = 2
    return cfg


def test_quorum_writes_all_keys_survive_node_death(rng):
    """With write_acks=2 an acked write is durable on >=2 nodes, so EVERY
    acked key stays readable after any single node dies (without quorum
    only most keys are; the quorum mode closes the window)."""
    nodes = []
    for i in range(3):
        svc = DBService(node_config())
        srv = DBServer(svc, port=0)
        srv.start_background()
        nodes.append((f"n{i}", svc, srv))
    coord = FederatedCoordinator(quorum_config())
    for nid, _, srv in nodes:
        coord.register_node(nid, srv.address)
    try:
        vecs = {}
        for i in range(20):
            v = rng.standard_normal(8).astype(np.float32)
            vecs[f"q{i}"] = v
            r = coord.put(VectorData(key=f"q{i}", vector=v))
            assert r.success, r.message  # acked => on master AND a replica
        dead_id, _, dead_srv = nodes[0]
        dead_srv.shutdown()
        coord.registry.check_health_once()
        assert coord.registry.get_node(dead_id).online is False
        for k, v in vecs.items():
            r = coord.get(k)
            assert r.success, f"acked key {k} lost after single node death"
            np.testing.assert_allclose(r.vector_data.vector, v, rtol=1e-6)
    finally:
        coord.close()
        for _, svc, srv in nodes:
            srv.shutdown()
            svc.close()


def test_quorum_put_fails_without_enough_replicas(rng):
    """write_acks=2 with every slave down -> the put reports failure
    instead of acking an unreplicated write."""
    svc = DBService(node_config())
    srv = DBServer(svc, port=0)
    srv.start_background()
    coord = FederatedCoordinator(quorum_config())
    coord.register_node("solo", srv.address)
    try:
        v = rng.standard_normal(8).astype(np.float32)
        r = coord.put(VectorData(key="qq", vector=v))
        # single node => no slaves => quorum of 2 unreachable... unless the
        # shard map assigned no slaves at all, in which case acks required
        # caps at available replicas (min) and the put succeeds; both are
        # coherent, but with replica_count=1 and one node there are zero
        # slaves, so need=min(1, 0)=0 -> success. Kill the node instead:
        assert r.success
        srv.shutdown()
        coord.registry.check_health_once()
        r = coord.put(VectorData(key="q2", vector=v))
        assert not r.success
    finally:
        coord.close()
        srv.shutdown()
        svc.close()


def test_rejoin_sync_converges_replicas(cluster, rng):
    """Kill a node -> write -> restart it ->
    all keys for its shards readable from every replica (via sync)."""
    coord, nodes = cluster
    # seed some data, then kill n0
    vecs = {}
    for i in range(10):
        v = rng.standard_normal(8).astype(np.float32)
        vecs[f"r{i}"] = v
        assert coord.put(VectorData(key=f"r{i}", vector=v)).success
    dead_id, dead_svc, dead_srv = nodes[0]
    dead_srv.shutdown()
    coord.registry.check_health_once()
    assert coord.registry.get_node(dead_id).online is False

    # writes continue while n0 is down
    for i in range(10, 30):
        v = rng.standard_normal(8).astype(np.float32)
        vecs[f"r{i}"] = v
        assert coord.put(VectorData(key=f"r{i}", vector=v)).success
    # and one delete, to exercise prune later
    assert coord.delete("r5").success
    del vecs["r5"]
    time.sleep(0.3)  # let async replication land on the survivors

    # restart n0 empty (fresh engine = lost disk, the worst case)
    svc2 = DBService(node_config())
    srv2 = DBServer(svc2, port=0)
    srv2.start_background()
    coord.register_node(dead_id, srv2.address)  # rejoin triggers async sync
    try:
        r = coord.sync_node(dead_id, prune=True)  # deterministic for the test
        assert r.success, r.message

        # n0 must now hold every live key of every shard it participates in
        smap = coord.registry.shard_map()
        my_shards = {s for s, g in smap.items()
                     if dead_id in g["master"] + g["slaves"]}
        missing = []
        for k, v in vecs.items():
            if get_shard_id(k, 4) in my_shards:
                g = svc2.engine.get(k)
                if not g.success:
                    missing.append(k)
                else:
                    np.testing.assert_allclose(g.vector_data.vector, v, rtol=1e-6)
        assert not missing, f"rejoined node missing {missing}"
        # pruned the key deleted while it was down
        assert not svc2.engine.get("r5").success
        # and the cluster as a whole serves every key
        for k in vecs:
            assert coord.get(k).success, k
    finally:
        srv2.shutdown()
        svc2.close()


def test_deleted_key_not_resurrected_by_stale_replica(cluster, rng):
    """A REACHABLE master's not-found must be
    authoritative. Consulting replicas/other nodes on a clean not-found
    resurrects deleted keys whose async replicate-delete was lost."""
    coord, nodes = cluster
    assert coord.sync_all().success  # land the bootstrap rebalance
    v = rng.standard_normal(8).astype(np.float32)
    assert coord.put(VectorData(key="zombie", vector=v)).success
    time.sleep(0.2)  # let async replication land
    assert coord.delete("zombie").success
    time.sleep(0.2)
    # simulate a replica whose replicate-delete never landed: stuff a stale
    # copy straight into a NON-master node's engine
    shard = get_shard_id("zombie", 4)
    master = coord.registry.get_shard_nodes(shard)["master"][0]
    stale_node = next((nid, svc) for nid, svc, _ in nodes if nid != master)
    stale_node[1].engine.put(VectorData(key="zombie", vector=v))
    # master is reachable and says not-found -> that is the answer
    assert not coord.get("zombie").success


def test_stale_route_window_finds_unmigrated_records(cluster, rng):
    """Counterpart: while shard ownership has moved WITHOUT a rebalance
    (routes stale), get() must still find records on their old owners —
    and sync_all closes the window."""
    coord, nodes = cluster
    assert coord.sync_all().success
    vecs = {}
    for i in range(20):
        v = rng.standard_normal(8).astype(np.float32)
        vecs[f"m{i}"] = v
        assert coord.put(VectorData(key=f"m{i}", vector=v)).success
    # a NEW node joins: shard map reshuffles round-robin, no data moves
    svc4 = DBService(node_config())
    srv4 = DBServer(svc4, port=0)
    srv4.start_background()
    try:
        coord.register_node("n3", srv4.address)
        assert coord._routes_stale
        for k in vecs:  # old owners still serve every key via broadcast
            assert coord.get(k).success, k
        assert coord.sync_all().success
        assert not coord._routes_stale
        for k in vecs:  # post-rebalance: served by the new owners directly
            assert coord.get(k).success, k
    finally:
        srv4.shutdown()
        svc4.close()


def test_any_shardmap_rebuild_flips_routes_stale(cluster, rng):
    """Every shard-map rebuild — not just a new
    node's registration — moves ownership without data, so mark_offline /
    mark_online must reopen the stale-routes window until a sync lands."""
    coord, nodes = cluster
    assert coord.sync_all().success
    assert not coord._routes_stale
    vecs = {}
    for i in range(16):
        v = rng.standard_normal(8).astype(np.float32)
        vecs[f"o{i}"] = v
        assert coord.put(VectorData(key=f"o{i}", vector=v)).success
    # an unrelated failure marks n2 offline: shard map reshuffles,
    # surviving-but-demoted owners still hold their records
    coord.registry.mark_offline("n2")
    assert coord._routes_stale
    for k in vecs:
        assert coord.get(k).success, k
    # the flap back online reshuffles AGAIN -> still stale until sync
    coord.registry.mark_online("n2")
    assert coord._routes_stale
    assert coord.sync_all().success
    assert not coord._routes_stale
    for k in vecs:
        assert coord.get(k).success, k


def test_master_error_fails_over_but_clean_miss_does_not(cluster, rng):
    """Only the literal 'key not found' skips failover; any other master
    error (handler exception, mid-recovery) must try the replicas."""
    coord, nodes = cluster
    assert coord.sync_all().success
    v = rng.standard_normal(8).astype(np.float32)
    assert coord.put(VectorData(key="failover-me", vector=v)).success
    time.sleep(0.3)  # async replication to the slave
    shard = get_shard_id("failover-me", 4)
    master = coord.registry.get_shard_nodes(shard)["master"][0]
    real_call = coord._call_node

    def broken_master(node_id, method, params):
        if node_id == master and method == "get":
            return {"success": False, "message": "internal error: boom"}
        return real_call(node_id, method, params)

    coord._call_node = broken_master
    try:
        r = coord.get("failover-me")
        assert r.success, r.message  # served by the replica
    finally:
        coord._call_node = real_call
    # clean miss stays authoritative: no resurrect of deleted keys
    assert coord.delete("failover-me").success
    time.sleep(0.3)
    assert not coord.get("failover-me").success


def test_sync_all_mid_membership_change_keeps_routes_stale(cluster, rng):
    """A shard-map rebuild DURING sync_all must leave routes stale (epoch
    comparison), not be clobbered by the sync's completion."""
    coord, nodes = cluster
    assert coord.sync_all().success
    orig_push = coord._push_shard
    fired = []

    def push_with_midflight_change(node_id, freshest, mine, prune):
        if not fired:
            fired.append(1)
            coord.registry.mark_offline("n2")  # topology changes mid-sync
            coord.registry.mark_online("n2")
        return orig_push(node_id, freshest, mine, prune)

    coord._push_shard = push_with_midflight_change
    try:
        coord.sync_all()
    finally:
        coord._push_shard = orig_push
    assert coord._routes_stale  # the mid-flight topology was never synced
    assert coord.sync_all().success
    assert not coord._routes_stale


def test_auto_rebalance_closes_stale_window(rng):
    """With rebalance_debounce_s > 0, a membership flap triggers a
    debounced background sync_all that closes the broadcast-on-miss
    window without operator action."""
    import dataclasses

    cfg = dataclasses.replace(node_config(), rebalance_debounce_s=0.1)
    nodes = []
    for i in range(2):
        svc = DBService(node_config())
        srv = DBServer(svc, port=0)
        srv.start_background()
        nodes.append((svc, srv))
    coord = FederatedCoordinator(cfg)
    try:
        for i, (_, srv) in enumerate(nodes):
            coord.register_node(f"n{i}", srv.address)
        v = rng.standard_normal(8).astype(np.float32)
        assert coord.put(VectorData(key="auto", vector=v)).success
        deadline = time.monotonic() + 15
        while coord._routes_stale and time.monotonic() < deadline:
            time.sleep(0.1)
        assert not coord._routes_stale, "auto rebalance never landed"
        assert coord.get("auto").success
        # a flap re-opens and re-closes the window by itself
        coord.registry.mark_offline("n1")
        coord.registry.mark_online("n1")
        deadline = time.monotonic() + 15
        while coord._routes_stale and time.monotonic() < deadline:
            time.sleep(0.1)
        assert not coord._routes_stale, "flap rebalance never landed"
    finally:
        coord.close()
        for svc, srv in nodes:
            srv.shutdown()
            svc.close()


class _FakeEmbedder:
    """Deterministic text/image -> vector stub (no CLIP weights needed)."""

    def __init__(self, dim, table=None):
        self.dim = dim
        self.table = table or {}

    def _vec(self, s):
        if s in self.table:
            return np.asarray(self.table[s], np.float32)
        r = np.random.default_rng(abs(hash(s)) % 2**32)
        v = r.standard_normal(self.dim).astype(np.float32)
        return v / np.linalg.norm(v)

    def text2vec(self, text):
        return self._vec(text)

    def image2vec(self, path):
        return self._vec(path)


def test_federated_text_search(cluster, rng):
    """/api/search works against a federated
    cluster — the coordinator embeds the text and scatter-gathers."""
    coord, nodes = cluster
    v = rng.standard_normal(8).astype(np.float32)
    v /= np.linalg.norm(v)
    coord._embedder = _FakeEmbedder(8, {"find me": v})
    assert coord.put(VectorData(
        key="img.jpg", vector=v,
        metadata={"file_path": "/imgs/img.jpg"})).success
    # a decoy far away
    assert coord.put(VectorData(
        key="other.jpg", vector=-v,
        metadata={"file_path": "/imgs/other.jpg"})).success

    out = coord.text_search("find me", topk=1)
    assert out["results"], out
    top = out["results"][0]
    assert top["key"] == "img.jpg"
    assert top["file_path"] == "/imgs/img.jpg"
    assert top["score"] < 1e-3  # exact match: d^2 ~ 0

    # and over HTTP via the coordinate deployment shape (the exact
    # surface the web frontend + `text-search` CLI hit)
    import http.client as hc
    import json as _json

    csrv = DBServer(coord, port=0)
    csrv.start_background()
    try:
        host, port = csrv.address.rsplit(":", 1)
        conn = hc.HTTPConnection(host, int(port), timeout=10)
        conn.request("POST", "/api/search",
                     _json.dumps({"text": "find me", "topk": 1}),
                     {"Content-Type": "application/json"})
        r = _json.loads(conn.getresponse().read())
        assert r["results"][0]["key"] == "img.jpg"
    finally:
        csrv.shutdown()


def test_federated_put_image(cluster, tmp_path):
    """put_image embeds at the coordinator and routes like a normal put."""
    coord, nodes = cluster
    coord._embedder = _FakeEmbedder(8)
    img = tmp_path / "cat.jpg"
    img.write_bytes(b"\xff\xd8fake")
    r = coord.put_image(str(img), dataset="unit")
    assert r["success"], r
    g = coord.get("cat.jpg")
    assert g.success
    assert g.vector_data.metadata["dataset"] == "unit"


def test_sync_node_exports_only_shard_peers(rng):
    """A rejoining node's catch-up sync must export
    its shard-peer set, not every online node (O(peers), not O(cluster))
    — except while routes are stale, where the full union is correct."""
    import dataclasses

    cfg = dataclasses.replace(node_config(), shard_count=1, replica_count=1)
    nodes = []
    for i in range(4):
        svc = DBService(dataclasses.replace(cfg))
        srv = DBServer(svc, port=0)
        srv.start_background()
        nodes.append((f"n{i}", svc, srv))
    coord = FederatedCoordinator(cfg)
    try:
        for nid, _, srv in nodes:
            coord.register_node(nid, srv.address)
        assert coord.sync_all().success  # close the stale window
        assert not coord._routes_stale

        smap = coord.registry.shard_map()
        group = smap[0]["master"] + smap[0]["slaves"]
        assert len(group) == 2  # 1 shard x (master + 1 slave), 4 nodes up

        exported = []
        orig = coord._export_all

        def counting_export(nid, shard=None):
            exported.append(nid)
            return orig(nid, shard=shard)

        coord._export_all = counting_export
        r = coord.sync_node(group[1])
        assert r.success, r.message
        assert sorted(exported) == sorted(group), \
            f"exported {exported}, expected only shard peers {group}"

        # stale routes widen to the full union (data may live anywhere)
        exported.clear()
        coord.registry.mark_offline("n3")
        coord.registry.mark_online("n3")
        assert coord._routes_stale
        coord.sync_node(group[1])
        assert len(exported) == 4
    finally:
        coord.close()
        for _, svc, srv in nodes:
            srv.shutdown()
            svc.close()


def test_coordinator_restart_resumes_routing(rng, tmp_path):
    """With a data_dir, a coordinator restart
    resumes its node table + shard map from the persisted registry —
    puts/gets/searches work without any node re-registering."""
    import dataclasses

    cfg = dataclasses.replace(node_config(), data_dir=str(tmp_path))
    nodes = []
    for i in range(3):
        svc = DBService(node_config())
        srv = DBServer(svc, port=0)
        srv.start_background()
        nodes.append((f"n{i}", svc, srv))
    coord = FederatedCoordinator(cfg)
    vecs = {}
    try:
        for nid, _, srv in nodes:
            coord.register_node(nid, srv.address)
        for i in range(12):
            v = rng.standard_normal(8).astype(np.float32)
            vecs[f"k{i}"] = v
            assert coord.put(VectorData(key=f"k{i}", vector=v)).success
        assert coord.sync_all().success
    finally:
        coord.close()  # coordinator process dies

    # fresh coordinator, same data_dir, NO re-registration
    coord2 = FederatedCoordinator(cfg)
    try:
        assert len(coord2.registry.list_nodes()) == 3
        # routing works immediately: puts route to shard masters
        v = rng.standard_normal(8).astype(np.float32)
        assert coord2.put(VectorData(key="post", vector=v)).success
        for k, vv in vecs.items():
            g = coord2.get(k)
            assert g.success, f"{k}: {g.message}"
        r = coord2.search(SearchRequest(
            query_vector=vecs["k0"].tolist(), top_k=1))
        assert r.success and r.search_result.keys == ["k0"]
        # routes start stale (restart = membership uncertainty) and a
        # sync_all closes the window as usual
        assert coord2._routes_stale
        assert coord2.sync_all().success
        assert not coord2._routes_stale
    finally:
        coord2.close()
        for _, svc, srv in nodes:
            srv.shutdown()
            svc.close()


def test_registry_persistence_survives_torn_file(tmp_path):
    """A corrupt registry file must not block coordinator startup."""
    p = tmp_path / "registry.json"
    p.write_text("{torn")
    reg = NodeRegistry(shard_count=2, replica_count=1,
                       persist_path=str(p))
    assert reg.list_nodes() == []
    reg.register_node("a", "127.0.0.1:1")
    reg2 = NodeRegistry(shard_count=2, replica_count=1,
                        persist_path=str(p))
    assert [n.node_id for n in reg2.list_nodes()] == ["a"]


def test_registry_persist_failure_is_visible(tmp_path):
    """A failing registry journal must be LOUD —
    counter + last_error on the registry, surfaced through list_nodes —
    not a silent `pass` that the operator discovers as an empty cluster
    map at the next coordinator restart."""
    blocker = tmp_path / "blocker"
    blocker.write_text("")  # a FILE where the journal's parent dir must go
    reg = NodeRegistry(shard_count=2, replica_count=1,
                       persist_path=str(blocker / "registry.json"))
    reg.register_node("a", "127.0.0.1:1")  # persist fails (ENOTDIR)
    assert reg.persist_failures_total >= 1
    h = reg.persist_health()
    assert h["enabled"] and h["last_error"]
    assert h["failures_total"] == reg.persist_failures_total

    # healthy registry reports a clean bill through the same surface
    ok = NodeRegistry(shard_count=2, replica_count=1,
                      persist_path=str(tmp_path / "reg.json"))
    ok.register_node("a", "127.0.0.1:1")
    h2 = ok.persist_health()
    assert h2["failures_total"] == 0 and h2["last_error"] is None

    # and the coordinator RPC exposes it (both coordinator flavors share
    # the registry object; FederatedCoordinator.handle wires the field)
    import dataclasses

    cfg = dataclasses.replace(node_config(), data_dir=None)
    coord = FederatedCoordinator(cfg)
    try:
        d = coord.handle("list_nodes", {})
        assert "registry_persist" in d
        assert d["registry_persist"]["enabled"] is False
    finally:
        coord.close()


def test_sync_all_streams_shard_by_shard(cluster, rng):
    """A rebalance must not materialize the whole
    cluster's corpus in coordinator RAM. The streaming sync holds one
    cluster shard's exports at a time — peak held records is bounded by
    the largest shard's copies, a ~shard_count-factor below the corpus."""
    coord, nodes = cluster
    n_keys = 200
    for i in range(n_keys):
        v = rng.standard_normal(8).astype(np.float32)
        assert coord.put(VectorData(key=f"s{i}", vector=v)).success
    assert coord.sync_all().success
    peak = coord._sync_peak_records
    assert peak > 0
    # exact bound: for each shard, every online node exports only that
    # shard's keys — peak <= max_shard_keys * nodes_holding_copies.
    # replica_count=1 => ~1 copy each; allow the put-routing transient
    # (pre-sync copies can exceed R briefly) with a 3x margin, still far
    # below the 200-record corpus a whole-cluster union would hold.
    from collections import Counter

    per_shard = Counter(get_shard_id(f"s{i}", coord.config.shard_count)
                        for i in range(n_keys))
    assert peak <= 3 * max(per_shard.values())
    assert peak < n_keys  # strictly below "whole corpus at once"

    # and the data still converges: every key serves from the cluster
    for i in range(0, n_keys, 97):
        assert coord.get(f"s{i}").success


def test_push_shard_uses_batched_replicate(cluster, rng, monkeypatch):
    """Anti-entropy pushes go out as replicate_batch chunks (one wire
    round-trip + one WAL group per ~512 records), not one replicate call
    per record — and still converge newest-wins."""
    coord, nodes = cluster
    for i in range(60):
        v = rng.standard_normal(8).astype(np.float32)
        assert coord.put(VectorData(key=f"b{i}", vector=v)).success
    calls = {"replicate": 0, "replicate_batch": 0}
    orig = FederatedCoordinator._call_node

    def counting(self, node_id, method, params):
        if method in calls:
            calls[method] += 1
        return orig(self, node_id, method, params)

    monkeypatch.setattr(FederatedCoordinator, "_call_node", counting)
    # a fresh empty node joins: ownership moves, so the next sync has
    # real records to push to it
    svc = DBService(node_config())
    srv = DBServer(svc, port=0)
    srv.start_background()
    try:
        coord.register_node("n3", srv.address)
        assert coord.sync_all().success
        assert calls["replicate_batch"] > 0
        assert calls["replicate"] == 0  # no per-record fallback needed
        # every key still serves with the right payload after the sync
        for i in range(0, 60, 7):
            assert coord.get(f"b{i}").success
    finally:
        srv.shutdown()
        svc.close()


def test_push_shard_falls_back_per_record(cluster, rng, monkeypatch):
    """A peer without the replicate_batch RPC (rolling upgrade) gets the
    per-record path and the sync still converges."""
    coord, nodes = cluster

    # simulate an old node: batched RPC unknown on every target
    monkeypatch.setattr(
        _PortService, "rpc_replicate_batch",
        lambda self, p: {"success": False,
                         "message": "unknown method: replicate_batch"},
        raising=True)
    for i in range(20):
        v = rng.standard_normal(8).astype(np.float32)
        assert coord.put(VectorData(key=f"f{i}", vector=v)).success
    calls = {"replicate": 0}
    orig = FederatedCoordinator._call_node

    def counting(self, node_id, method, params):
        if method == "replicate":
            calls["replicate"] += 1
        return orig(self, node_id, method, params)

    monkeypatch.setattr(FederatedCoordinator, "_call_node", counting)
    svc = DBService(node_config())
    srv = DBServer(svc, port=0)
    srv.start_background()
    try:
        coord.register_node("n3", srv.address)
        assert coord.sync_all().success
        assert calls["replicate"] > 0
        for i in range(0, 20, 3):
            assert coord.get(f"f{i}").success
    finally:
        srv.shutdown()
        svc.close()


def test_text_search_and_put_image_name_item_11(cluster, tmp_path, rng):
    """The coordinator embeds with real (tiny, seeded) CLIP towers: an
    image put through it lands on its shard's node and comes back first
    for its own vector; text search scatter-gathers over the nodes, and
    /api/search on the coordinator's server answers the same. (The name
    dates from when both waited for the CLIP port.)"""
    import http.client as hc
    import json as _json

    from PIL import Image

    from tpuvdb_torch.embed.clip import CLIPConfig, CLIPEmbedder

    coord, nodes = cluster
    coord._embedder = CLIPEmbedder(CLIPConfig(
        embed_dim=8, vocab_size=512, text_width=64, text_layers=2,
        text_heads=2, context_length=16, image_size=64, patch_size=32,
        vision_width=64, vision_layers=2, vision_heads=2), device="cpu")
    paths = []
    for i in range(3):
        p = str(tmp_path / f"cat_{i}.png")
        Image.fromarray(rng.integers(0, 255, (80, 80, 3), np.uint8)).save(p)
        paths.append(p)
        r = coord.put_image(p, dataset="fed")
        assert r["success"], r
    g = coord.get("cat_1.png")
    assert g.success and g.vector_data.metadata["dataset"] == "fed"
    own = coord.search(SearchRequest(
        query_vector=coord.embedder.image2vec(paths[1]), top_k=1))
    assert own.search_result.keys == ["cat_1.png"]
    assert own.search_result.scores[0] < 1e-3

    out = coord.text_search("a cat", topk=3)
    assert out["results"], out
    assert {r["key"] for r in out["results"]} <= {"cat_0.png", "cat_1.png",
                                                  "cat_2.png"}
    scores = [r["score"] for r in out["results"]]
    assert scores == sorted(scores)
    assert out["results"][0]["file_path"] in paths
    csrv = DBServer(coord, port=0)
    csrv.start_background()
    try:
        conn = hc.HTTPConnection(csrv.host, csrv.port, timeout=30)
        conn.request("POST", "/api/search", _json.dumps({"text": "a cat",
                                                         "topk": 3}),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200
        assert _json.loads(resp.read()) == coord.text_search("a cat", 3)
    finally:
        csrv.shutdown()


def test_coordinator_loads_its_embedder_on_its_device(monkeypatch):
    from tpuvdb_torch.embed import clip

    seen = []
    monkeypatch.setattr(clip, "load_default_embedder",
                        lambda dim, device=None: seen.append((dim, device))
                        or "embedder")
    coord = FederatedCoordinator(node_config(), device="cpu")
    try:
        assert coord.embedder == "embedder" and coord.embedder == "embedder"
    finally:
        coord.close()
    assert seen == [(8, "cpu")]


def _federation(coord_cls, node_services):
    """Start each node's server and register it with a new coordinator of
    `coord_cls` (write_acks=2: a put returns once both copies landed)."""
    import dataclasses

    cfg = dataclasses.replace(node_config(), search_mode="exact",
                              write_acks=2)
    servers = []
    for svc in node_services:
        srv = (DBServer if isinstance(svc, _PortService)
               else _jax_server())(svc, port=0)
        srv.start_background()
        servers.append(srv)
    coord = coord_cls(cfg)
    for i, srv in enumerate(servers):
        coord.register_node(f"n{i}", srv.address)
    return coord, servers


def _jax_server():
    from tpuvdb.api.server import DBServer as JaxServer

    return JaxServer


def test_mixed_federation_answers_as_all_jax(rng):
    """A port coordinator over one JAX node and one port node (they share
    the wire): every put is replicated to both nodes, and gets and merged
    searches equal those of a JAX coordinator over two JAX nodes."""
    import dataclasses

    from tpuvdb.api.service import DBService as JaxService
    from tpuvdb.cluster.federation import FederatedCoordinator as JaxCoord
    from tpuvdb.core.config import DBConfig as JaxConfig
    from tpuvdb.core.types import SearchRequest as JaxRequest
    from tpuvdb.core.types import VectorData as JaxData

    jcfg = dataclasses.replace(JaxConfig.from_json(node_config().to_json()),
                               search_mode="exact")
    pcfg = dataclasses.replace(node_config(), search_mode="exact")
    mixed_nodes = [JaxService(jcfg), DBService(pcfg)]
    jax_nodes = [JaxService(jcfg), JaxService(jcfg)]
    mixed, mixed_srv = _federation(FederatedCoordinator, mixed_nodes)
    allj, allj_srv = _federation(JaxCoord, jax_nodes)
    try:
        vecs = rng.standard_normal((40, 8)).astype(np.float32)
        for i, v in enumerate(vecs):
            md = {"i": str(i)}
            r = mixed.put(VectorData(key=f"m{i}", vector=v, metadata=md,
                                     timestamp=100 + i))
            assert r.success, r.message
            assert allj.put(JaxData(key=f"m{i}", vector=v, metadata=md,
                                    timestamp=100 + i)).success
        assert mixed.delete("m7").success and allj.delete("m7").success
        # every live key on both nodes, the JAX one and the port one
        for i in range(40):
            got = [n.engine.get(f"m{i}") for n in mixed_nodes]
            if i == 7:
                assert not any(g.success for g in got)
                continue
            for g in got:
                assert g.success
                np.testing.assert_array_equal(
                    np.asarray(g.vector_data.vector, np.float32), vecs[i])
        for i in range(0, 40, 3):
            a, b = mixed.get(f"m{i}"), allj.get(f"m{i}")
            assert a.success == b.success
            if a.success:
                assert a.vector_data.to_dict() == b.vector_data.to_dict()
        queries = vecs[:6] + 0.1 * rng.standard_normal((6, 8)).astype(
            np.float32)
        for q in queries:
            a = mixed.search(SearchRequest(query_vector=q.tolist(),
                                           top_k=5))
            b = allj.search(JaxRequest(query_vector=q.tolist(), top_k=5))
            assert a.success and b.success
            assert a.search_result.keys == b.search_result.keys
            np.testing.assert_allclose(a.search_result.scores,
                                       b.search_result.scores,
                                       rtol=1e-5, atol=1e-5)
            assert a.search_result.metadatas == b.search_result.metadatas
    finally:
        mixed.close()
        allj.close()
        for srv in mixed_srv + allj_srv:
            srv.shutdown()
        for svc in mixed_nodes + jax_nodes:
            svc.close()
