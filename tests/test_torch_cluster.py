"""Membership, shard map, health and routing in the port
(tpuvdb_torch/cluster/membership.py, utils/sharding_utils.py) against the
JAX package's (tpuvdb/cluster/membership.py).

Mirrors tests/test_cluster.py and adds parity: `get_shard_id`, the shard
map and its failover equal the JAX registry's for the same nodes, and the
persisted registry file of either package loads in the other.
"""

import pytest

from tpuvdb.cluster.membership import NodeRegistry as JaxRegistry
from tpuvdb.utils.sharding_utils import get_shard_id as jax_shard_id
from tpuvdb_torch.cluster.membership import NodeRegistry
from tpuvdb_torch.utils.sharding_utils import (
    assign_shards_to_nodes,
    get_shard_id,
)


def test_shard_id_stable():
    for key in ["a", "hello", "image_123.jpg"]:
        sid = get_shard_id(key, 4)
        assert 0 <= sid < 4
        assert sid == get_shard_id(key, 4)


def test_assign_round_robin():
    m = assign_shards_to_nodes(["n0", "n1", "n2"], shard_count=4,
                               replica_count=2)
    assert m[0]["master"] == ["n0"]
    assert m[1]["master"] == ["n1"]
    assert m[3]["master"] == ["n0"]
    assert "n0" not in m[0]["slaves"] and len(m[0]["slaves"]) == 2


def test_register_and_failover():
    reg = NodeRegistry(shard_count=4, replica_count=2)
    reg.register_node("n0", "10.0.0.1:9090")
    reg.register_node("n1", "10.0.0.2:9090")
    nodes = {n.node_id for n in reg.list_nodes()}
    assert nodes == {"n0", "n1"}
    master = reg.get_shard_nodes(0)["master"][0]
    reg.mark_offline(master)
    sm2 = reg.get_shard_nodes(0)
    assert sm2["master"] and sm2["master"][0] != master
    for nid in list(nodes):
        reg.mark_offline(nid)
    assert reg.get_shard_nodes(0) == {"master": [], "slaves": []}
    reg.mark_online("n1")
    assert reg.get_shard_nodes(0)["master"] == ["n1"]


def test_virtual_nodes_always_online():
    reg = NodeRegistry(shard_count=4, replica_count=2)
    reg.register_virtual_nodes(4)
    assert all(reg.check_health_once().values())
    assert len(reg.online_nodes()) == 4
    assert {n.address for n in reg.list_nodes()} == {
        f"device:{i}" for i in range(4)}


def test_deregister_rebuilds_map():
    reg = NodeRegistry(shard_count=2, replica_count=1)
    reg.register_node("a", "h:1")
    reg.register_node("b", "h:2")
    assert reg.deregister_node("a")
    assert not reg.deregister_node("a")
    assert reg.get_shard_nodes(0)["master"] == ["b"]


def test_tcp_probe_marks_offline():
    reg = NodeRegistry(shard_count=2, replica_count=1, probe_timeout_s=0.2)
    reg.register_node("dead", "127.0.0.1:1")  # nothing listens on port 1
    assert reg.check_health_once() == {"dead": False}
    assert reg.get_node("dead").online is False


def test_get_shard_id_equals_jax():
    keys = [f"key-{i}" for i in range(500)] + ["", "ü-ñ", "img.jpg"]
    for count in (1, 2, 3, 4, 7, 16):
        assert [get_shard_id(k, count) for k in keys] == \
            [jax_shard_id(k, count) for k in keys]


@pytest.mark.parametrize("n_nodes, shards, replicas", [
    (1, 4, 2), (2, 4, 2), (3, 4, 1), (5, 8, 2), (4, 3, 3)])
def test_shard_map_and_failover_equal_jax(n_nodes, shards, replicas):
    regs = [NodeRegistry(shard_count=shards, replica_count=replicas),
            JaxRegistry(shard_count=shards, replica_count=replicas)]
    for reg in regs:
        reg.register_virtual_nodes(2)
        for i in range(n_nodes):
            reg.register_node(f"n{i}", f"127.0.0.1:{9000 + i}")
    port, jax = regs

    def view(reg):
        return (reg.shard_map(), reg.map_epoch(),
                [reg.get_shard_nodes(s) for s in range(shards)])

    assert view(port) == view(jax)
    for reg in regs:
        reg.mark_offline("n0")
        reg.deregister_node("shard_1")
    assert view(port) == view(jax)
    for reg in regs:
        reg.mark_online("n0")
    assert view(port) == view(jax)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_persisted_registry_loads_across_packages(writer, tmp_path):
    path = str(tmp_path / "registry.json")
    cls, other = ((NodeRegistry, JaxRegistry) if writer == "port"
                  else (JaxRegistry, NodeRegistry))
    reg = cls(shard_count=4, replica_count=1, persist_path=path)
    reg.register_node("a", "127.0.0.1:7001")
    reg.register_node("b", "127.0.0.1:7002")
    reg.mark_offline("b")
    back = other(shard_count=4, replica_count=1, persist_path=path)
    assert {(n.node_id, n.address, n.online) for n in back.list_nodes()} == {
        ("a", "127.0.0.1:7001", True), ("b", "127.0.0.1:7002", False)}
    assert back.shard_map() == reg.shard_map()
