"""The port's HTTP server, client, service and CLI (tpuvdb_torch/api/)
against the JAX package's (tpuvdb/api/).

Mirrors tests/test_api.py (the HTTP round trip, search_batch, nodes, static
path traversal, /healthz and /, the embedded and remote CLI, put_batch's
misspelled field) and tests/test_routing.py, on device="cpu", and adds:
* parity: one request sequence through a JAX DBService and a port one in
  search_mode "exact" gives equal response dicts (scores within rtol 1e-5
  + atol 1e-5);
* the wires across packages: a JAX DBClient drives a port DBServer, and a
  port client a JAX server, on JSON and on the binary wire;
* text -> image search (CLIP, tpuvdb_torch/embed/): /api/search, the
  service's text_search and put_image, and the CLI's `text-search` and
  `ingest-images`, embedded and remote, with tiny seeded towers;
* `bench`, `bench --suite scan` and `--suite streaming` run through the
  CLI at a small size and print the reference's keys last.

The JAX service's native library is switched off (the reference's build
races between test workers).
"""

import json
import os

import numpy as np
import pytest
import torch
from click.testing import CliRunner

from tpuvdb import native as jax_native
from tpuvdb.api.client import DBClient as JaxClient
from tpuvdb.api.server import DBServer as JaxServer
from tpuvdb.api.service import DBService as JaxService
from tpuvdb.core.config import DBConfig as JaxConfig
from tpuvdb_torch.api.cli import cli
from tpuvdb_torch.api.client import DBClient
from tpuvdb_torch.api.server import DBServer
from tpuvdb_torch.api.service import DBService
from tpuvdb_torch.core.config import DBConfig
from tpuvdb_torch.embed import clip
from tpuvdb_torch.utils.sharding_utils import get_shard_id

CPU = ["--device", "cpu"]

# tiny CLIP towers (tests/test_embed.py's sizes) for the text search paths
TINY_CLIP = dict(vocab_size=512, text_width=64, text_layers=2, text_heads=2,
                 context_length=16, image_size=64, patch_size=32,
                 vision_width=64, vision_layers=2, vision_heads=2)


@pytest.fixture(autouse=True)
def _no_reference_build(monkeypatch):
    monkeypatch.setattr(jax_native, "available", lambda: False)
    monkeypatch.setattr(jax_native, "rescore_available", lambda: False)


def small_config(cls=DBConfig, **kw):
    return cls(**dict(dict(vector_dim=8, shard_count=4, shard_capacity=1024,
                           block_size=128), **kw))


@pytest.fixture()
def tiny_default_clip(monkeypatch):
    """load_default_embedder builds tiny towers (a fresh set per test)."""
    import functools

    monkeypatch.setattr(clip, "CLIPConfig",
                        functools.partial(clip.CLIPConfig, **TINY_CLIP))
    monkeypatch.setattr(clip, "_defaults", {})


def tiny_embedder(dim=8):
    return clip.CLIPEmbedder(clip.CLIPConfig(embed_dim=dim, **TINY_CLIP),
                             device="cpu")


def save_images(d, rng, n):
    from PIL import Image

    os.makedirs(d, exist_ok=True)
    for i in range(n):
        Image.fromarray(rng.integers(0, 255, (72, 72, 3), np.uint8)).save(
            os.path.join(d, f"pic_{i}.png"))
    return [os.path.join(d, f"pic_{i}.png") for i in range(n)]


@pytest.fixture()
def server():
    svc = DBService(small_config(), device="cpu")
    srv = DBServer(svc, port=0)  # ephemeral port
    srv.start_background()
    yield srv
    srv.shutdown()
    svc.close()


def test_http_roundtrip(server, rng):
    client = DBClient(server.address, timeout=30)
    v = rng.standard_normal(8).astype(np.float32)
    r = client.call("put", {"key": "a", "vector": v.tolist(),
                            "metadata": {"tag": "x"}})
    assert r["success"], r
    r = client.call("get", {"key": "a"})
    assert r["success"]
    np.testing.assert_allclose(r["vector_data"]["vector"], v, rtol=1e-6)

    r = client.call("search", {"query_vector": v.tolist(), "top_k": 1})
    assert r["success"]
    assert r["search_result"]["keys"] == ["a"]

    r = client.call("delete", {"key": "a"})
    assert r["success"]
    assert not client.call("get", {"key": "a"})["success"]

    # unknown method -> failed Response, not HTTP error
    r = client.call("nope", {})
    assert not r["success"] and "unknown method" in r["message"]


def test_search_batch_rpc(server, rng):
    client = DBClient(server.address, timeout=30)
    vecs = {}
    for i in range(20):
        v = rng.standard_normal(8).astype(np.float32)
        vecs[f"b{i}"] = v
        client.call("put", {"key": f"b{i}", "vector": v.tolist()})
    qs = [vecs["b3"].tolist(), vecs["b7"].tolist()]
    r = client.call("search_batch", {"query_vectors": qs, "top_k": 2})
    assert r["success"], r
    assert len(r["results"]) == 2
    assert r["results"][0]["keys"][0] == "b3"
    assert r["results"][1]["keys"][0] == "b7"
    # dim mismatch is a clean failure
    r = client.call("search_batch", {"query_vectors": [[1.0, 2.0]]})
    assert not r["success"]


def test_register_and_list_nodes(server):
    client = DBClient(server.address, timeout=30)
    r = client.call("register_node", {"node_id": "ext1",
                                      "address": "127.0.0.1:9999"})
    assert r["success"]
    r = client.call("list_nodes", {})
    ids = {n["node_id"] for n in r["nodes"]}
    assert "ext1" in ids
    assert any(n["virtual"] for n in r["nodes"])
    assert r["shard_map"]


def test_static_path_traversal_blocked(server):
    import http.client

    conn = http.client.HTTPConnection(server.host, server.port, timeout=30)
    for path in ("/static/../../etc/passwd", "/static/..%2f..%2fetc%2fpasswd"):
        conn.request("GET", path)
        resp = conn.getresponse()
        body = resp.read()
        assert resp.status in (400, 404), (path, resp.status)
        assert b"root:" not in body


def test_healthz_and_frontend(server):
    import http.client

    conn = http.client.HTTPConnection(server.host, server.port, timeout=30)
    conn.request("GET", "/healthz")
    assert json.loads(conn.getresponse().read())["ok"]
    conn.request("GET", "/")
    resp = conn.getresponse()
    body = resp.read().decode()
    assert resp.status == 200 and "tpuvdb" in body


def test_api_search_names_item_11(server, rng, tmp_path):
    """/api/search answers text -> image results through the service's
    embedder (tiny towers here), ascending, with the file paths; without
    text it answers 400. (The name dates from when the route waited for
    the CLIP port; it now checks that the route answers.)"""
    import http.client

    svc = server.service
    svc._embedder = tiny_embedder()
    for p in save_images(str(tmp_path), rng, 3):
        assert svc.put_image(p, dataset="web")["success"]
    conn = http.client.HTTPConnection(server.host, server.port, timeout=30)
    conn.request("POST", "/api/search", json.dumps({"text": "a cat",
                                                    "topk": 2}),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    body = json.loads(resp.read())
    assert resp.status == 200, body
    res = body["results"]
    assert len(res) == 2 and res[0]["score"] <= res[1]["score"]
    assert res[0]["file_path"].endswith(".png")
    assert res[0]["metadata"]["dataset"] == "web"
    assert body == svc.text_search("a cat", 2)
    conn.request("POST", "/api/search", json.dumps({"topk": 2}),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    assert resp.status == 400 and b"missing text" in resp.read()


def test_cli_embedded(tmp_data_dir, rng, monkeypatch):
    monkeypatch.setenv("TPUVDB_VECTOR_DIM", "8")
    runner = CliRunner()
    vec = ",".join(str(x) for x in rng.standard_normal(8))
    base = CPU + ["--data-dir", tmp_data_dir]
    # "--" guards vectors whose first component is negative
    r = runner.invoke(cli, base + ["put", "-m", "color=red", "--", "k1", vec])
    assert r.exit_code == 0, r.output
    r = runner.invoke(cli, base + ["get", "k1"])
    assert r.exit_code == 0 and "color" in r.output
    r = runner.invoke(cli, base + ["search", "-k", "3", "--", vec])
    assert r.exit_code == 0 and "k1" in r.output
    r = runner.invoke(cli, base + ["list-nodes"])
    assert r.exit_code == 0 and "online" in r.output
    r = runner.invoke(cli, base + ["delete", "k1"])
    assert r.exit_code == 0
    r = runner.invoke(cli, base + ["get", "k1"])
    assert r.exit_code == 1


def test_cli_remote(server, rng):
    runner = CliRunner()
    vec = ",".join(str(x) for x in rng.standard_normal(8))
    base = ["--coord-addr", server.address]
    r = runner.invoke(cli, base + ["put", "--", "rk", vec])
    assert r.exit_code == 0, r.output
    r = runner.invoke(cli, base + ["search", "--", vec])
    assert r.exit_code == 0 and "rk" in r.output
    r = runner.invoke(cli, base + ["info"])
    assert r.exit_code == 0 and '"docs"' in r.output


def test_put_batch_rpc_and_misspelled_field(server, rng):
    client = DBClient(server.address, timeout=30)
    vs = rng.standard_normal((4, 8)).astype(np.float32)
    recs = [{"key": f"b{i}", "vector": vs[i].tolist()} for i in range(4)]
    r = client.call("put_batch", {"records": recs})
    assert r["success"], r
    r = client.call("search", {"query_vector": vs[2].tolist(), "top_k": 1})
    assert r["search_result"]["keys"] == ["b2"]
    # a misspelled field must fail loudly, not succeed as an empty batch
    r = client.call("put_batch", {"items": recs})
    assert not r["success"] and "records" in r["message"]
    # an explicit empty batch is still a valid no-op
    assert client.call("put_batch", {"records": []})["success"]


def test_ops_fail_when_shard_offline(rng):
    """tests/test_routing.py: an op on a key whose shard has no online
    master fails."""
    svc = DBService(small_config(shard_capacity=512), device="cpu")
    v = rng.standard_normal(8).tolist()
    assert svc.handle("put", {"key": "a", "vector": v})["success"]
    for n in svc.registry.list_nodes():
        svc.registry.mark_offline(n.node_id)
    r = svc.handle("put", {"key": "b", "vector": v})
    assert not r["success"] and "no online node" in r["message"]
    assert not svc.handle("get", {"key": "a"})["success"]
    assert not svc.handle("delete", {"key": "a"})["success"]
    svc.registry.mark_online("shard_0")
    shard_a = get_shard_id("a", 4)
    assert svc.registry.get_shard_nodes(shard_a)["master"] == ["shard_0"]
    assert svc.handle("get", {"key": "a"})["success"]
    svc.close()


# ------------------------------------------------------------------ parity


def _close(a, b, path="$"):
    """Equal response dicts; floats within rtol 1e-5 + atol 1e-5."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), (path, a, b)
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple, np.ndarray)):
        assert len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        assert abs(float(a) - float(b)) <= 1e-5 + 1e-5 * abs(float(b)), \
            (path, a, b)
    else:
        assert a == b, (path, a, b)


def _request_sequence(rng, n=60, d=8):
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    seq = []
    for i in range(20):
        seq.append(("put", {"key": f"p{i}", "vector": vecs[i].tolist(),
                            "metadata": {"g": str(i % 3)},
                            "timestamp": 1000 + i}))
    seq.append(("put_batch", {"records": [
        {"key": f"b{i}", "vector": vecs[i].tolist(),
         "metadata": {"g": str(i % 3)}, "timestamp": 2000 + i}
        for i in range(20, n)]}))
    seq.append(("put", {"key": "p3", "vector": vecs[50].tolist(),
                        "timestamp": 3000}))       # overwrite
    seq += [("get", {"key": "p3"}), ("get", {"key": "b25"}),
            ("delete", {"key": "b25"}), ("get", {"key": "b25"}),
            ("delete", {"key": "missing"})]
    for i in (0, 7, 25, 44):
        seq.append(("search", {"query_vector": vecs[i].tolist(),
                               "top_k": 5}))
    seq.append(("search", {"query_vector": vecs[4].tolist(), "top_k": 6,
                           "filter_metadata": {"g": "1"}}))
    seq.append(("search_batch", {"query_vectors": vecs[10:16].tolist(),
                                 "top_k": 4}))
    seq.append(("flush", {}))
    seq.append(("search_batch", {"query_vectors": vecs[30:33].tolist()}))
    for cursor in (0, 25, 50):
        seq.append(("export", {"cursor": cursor, "limit": 25}))
    seq.append(("export", {"cursor": 0, "limit": 100, "shard": 1,
                           "shard_count": 4}))
    seq += [("list_nodes", {}), ("get_all_keys", {"limit": 100}),
            ("put_batch", {"items": []}), ("nope", {})]
    return seq


@pytest.mark.parametrize("coalesce", [False, True])
def test_service_parity_with_jax(coalesce, rng):
    """The same request sequence through a JAX DBService and a port one
    gives equal response dicts (search_mode "exact")."""
    kw = dict(search_mode="exact", search_coalesce=coalesce)
    jax_svc = JaxService(small_config(JaxConfig, **kw))
    # the reference's background flush can score a row twice when its
    # scatter lands just before a search's snapshot (a known reference
    # defect, ROADMAP.md); the reference flushes on search without it.
    # The port's service keeps its background flush.
    jax_svc.engine.stop_background_flush()
    svc = DBService(small_config(**kw), device="cpu")
    try:
        for method, params in _request_sequence(rng):
            want = jax_svc.handle(method, json.loads(json.dumps(params)))
            got = svc.handle(method, json.loads(json.dumps(params)))
            if method == "get_all_keys":
                # the doc store's own key order (native here, python in
                # the JAX service, whose library is off): compare the sets
                want["keys"].sort()
                got["keys"].sort()
            # vectors of exports ride as ndarrays until the wire
            _close(json.loads(json.dumps(got, default=_listify)),
                   json.loads(json.dumps(want, default=_listify)),
                   f"{method}")
        assert svc.engine.count() == jax_svc.engine.count()
    finally:
        jax_svc.close()
        svc.close()


def _listify(obj):
    return obj.tolist()


@pytest.mark.parametrize("binary", [False, True])
def test_jax_client_drives_port_server(server, binary, rng):
    client = JaxClient(server.address, timeout=30, binary=binary)
    vs = rng.standard_normal((6, 8)).astype(np.float32)
    r = client.call("put_batch", {"records": [
        {"key": f"j{i}", "vector": vs[i], "metadata": {"i": str(i)}}
        for i in range(6)]})
    assert r["success"], r
    r = client.call("get", {"key": "j4"})
    assert r["success"]
    np.testing.assert_array_equal(np.asarray(r["vector_data"]["vector"],
                                             np.float32), vs[4])
    r = client.call("search", {"query_vector": vs[2], "top_k": 2})
    assert r["search_result"]["keys"][0] == "j2"
    r = client.call("search_batch", {"query_vectors": vs[:3], "top_k": 1})
    assert [x["keys"] for x in r["results"]] == [["j0"], ["j1"], ["j2"]]
    r = client.call("export", {"cursor": 0, "limit": 10})
    got = {rec["key"]: np.asarray(rec["vector"], np.float32)
           for rec in r["records"]}
    assert sorted(got) == [f"j{i}" for i in range(6)]
    np.testing.assert_array_equal(got["j5"], vs[5])
    if binary:
        assert isinstance(r["records"][0]["vector"], np.ndarray)
    client.close()


@pytest.mark.parametrize("binary", [False, True])
def test_port_client_drives_jax_server(binary, rng):
    jax_svc = JaxService(small_config(JaxConfig))
    srv = JaxServer(jax_svc, port=0)
    srv.start_background()
    try:
        client = DBClient(srv.address, timeout=30, binary=binary)
        vs = rng.standard_normal((5, 8)).astype(np.float32)
        for i in range(5):
            assert client.call("put", {"key": f"q{i}",
                                       "vector": vs[i].tolist()})["success"]
        r = client.response("get", {"key": "q1"})
        assert r.success
        np.testing.assert_allclose(r.vector_data.vector, vs[1], rtol=1e-6)
        r = client.call("search", {"query_vector": vs[3].tolist(),
                                   "top_k": 1})
        assert r["search_result"]["keys"] == ["q3"]
        r = client.call("export", {"cursor": 0, "limit": 10})
        assert r["total"] == 5
        client.close()
    finally:
        srv.shutdown()
        jax_svc.close()


def test_poisoned_batcher_falls_back_and_is_visible(rng):
    """tests/test_batching.py: a broken batcher is counted in info, and the
    search still succeeds on the direct path."""
    svc = DBService(small_config(vector_dim=16, shard_count=2,
                                 shard_capacity=2048), device="cpu")
    v = rng.standard_normal(16).astype(np.float32)
    svc.engine.put_batch([__import__("tpuvdb_torch").VectorData(
        key="k", vector=v)])

    def boom(query, k, timeout=30.0):
        raise RuntimeError("poisoned batcher")

    svc.batcher.search = boom
    r = svc.rpc_search({"query_vector": v.tolist(), "top_k": 1})
    assert r["success"] and r["search_result"]["keys"] == ["k"]
    assert svc.rpc_info({})["info"]["batcher_fallbacks"] == 1
    svc.close()


_BENCH_KEYS = {
    "scan": {"metric", "value", "unit", "vs_baseline", "recall_at_10",
             "best_path", "batch", "corpus", "dataset", "paths", "engine",
             "capacity_pq"},
    "streaming": {"metric", "value", "unit", "vs_baseline", "ingest_total",
                  "dim", "concurrent_search_p50_ms", "recovery_s"},
}


@pytest.mark.parametrize("args, item", [
    (["bench"], "item 13"),
    (["bench", "--suite", "scan"], "item 13"),
    (["bench", "--suite", "streaming"], "item 13"),
])
def test_waiting_commands_name_their_item(args, item, rng, monkeypatch):
    """The name is from when these commands waited for ROADMAP.md's item
    13 and failed naming it. The item's scan and streaming benchmarks are
    ported now, so each case runs its suite through the CLI on the CPU, at
    a small size (the scan: 2,048 x 8 rows in one block, one timing window
    of one call, a few engine searches; streaming: 2,048 x 32 rows), exits
    0, names no item, and ends stdout with the reference's keys."""
    import functools

    from test_torch_bench_scan import quick_port_bench
    from tpuvdb_torch.bench import datasets, scan, streaming

    data = (rng.standard_normal((2048, 8)).astype(np.float32),
            rng.standard_normal((512, 8)).astype(np.float32))
    monkeypatch.setattr(datasets, "sift1m_if_available",
                        lambda max_rows=None: data)
    monkeypatch.setattr(scan, "BLOCK", 2048)
    quick_port_bench(monkeypatch)
    monkeypatch.setattr(streaming, "run", functools.partial(
        streaming.run, n_total=2048, dim=32, batch=256))
    r = CliRunner().invoke(cli, ["--device", "cpu"] + args)
    assert r.exit_code == 0, r.output
    assert item not in r.output and "ROADMAP.md" not in r.output
    suite = args[-1] if len(args) > 1 else "scan"
    line = json.loads(r.stdout.splitlines()[-1])
    assert set(line) == _BENCH_KEYS[suite]
    assert line["value"] > 0
    if suite == "scan":
        assert line["corpus"] == [2048, 8] and line["capacity_pq"] is None
        assert len(r.stdout.splitlines()) == 9  # 8 stage lines, the last


def test_serve_mesh_is_the_references(monkeypatch):
    """`serve` opens the reference's mesh: --replicas R over the cards
    where R divides them, all cards on one axis otherwise, none with one
    card, on the CPU or with --no-mesh. The cards are eight CPU slots
    here (create_mesh's own default needs CUDA)."""
    from tpuvdb_torch.api import cli as cli_mod
    from tpuvdb_torch.mesh import mesh as mesh_mod
    from tpuvdb_torch.mesh import replicated

    monkeypatch.setattr(mesh_mod, "device_count", lambda: 8)
    for mod in (mesh_mod, replicated):
        monkeypatch.setattr(mod, "mesh_devices",
                            lambda devices=None: [torch.device("cpu")] * 8)
    for args, shape in (((True, 2), {"repl": 2, "shards": 4}),
                        ((True, 3), {"shards": 8}),
                        ((True, 1), {"shards": 8})):
        assert cli_mod.serve_mesh(*args, "cuda").shape == shape
    assert cli_mod.serve_mesh(False, 2, "cuda") is None
    assert cli_mod.serve_mesh(True, 2, "cpu") is None
    monkeypatch.setattr(mesh_mod, "device_count", lambda: 1)
    assert cli_mod.serve_mesh(True, 1, "cuda") is None


def test_text_search_and_put_image_name_item_11(tmp_path, rng,
                                                tiny_default_clip):
    """put_image and text_search run on the service's own embedder, loaded
    at first use on its device (tiny towers here). One shard: each row
    has a scan bucket of its own, so all three images come back. (The
    name dates from when both waited for the CLIP port.)"""
    svc = DBService(small_config(shard_count=1), device="cpu")
    try:
        paths = save_images(str(tmp_path), rng, 3)
        for p in paths:
            assert svc.put_image(p)["success"]
        assert svc.embedder is clip.load_default_embedder(8, device="cpu")
        res = svc.text_search("a cat", 3)["results"]
        assert sorted(r["key"] for r in res) == [os.path.basename(p)
                                                 for p in paths]
        assert [r["score"] for r in res] == sorted(r["score"] for r in res)
        hit = svc.engine.search_hits(svc.embedder.image2vec(paths[1]), 1)[0]
        assert hit.key == "pic_1.png" and hit.score < 1e-3
        assert hit.metadata["file_path"] == paths[1]
    finally:
        svc.close()


@pytest.mark.parametrize("mode", ["embedded", "remote"])
def test_cli_ingest_images_and_text_search(mode, tmp_path, rng, monkeypatch,
                                           tiny_default_clip):
    """`ingest-images` then `text-search`: in-process with --data-dir, or
    against a server (the CLI embeds the images, the server the text).
    One shard, so both images have scan buckets of their own."""
    monkeypatch.setenv("TPUVDB_VECTOR_DIM", "8")
    monkeypatch.setenv("TPUVDB_SHARD_COUNT", "1")
    paths = save_images(str(tmp_path / "imgs"), rng, 3)
    (tmp_path / "imgs" / "notes.txt").write_text("not an image")
    runner = CliRunner()
    svc = srv = None
    if mode == "embedded":
        base = CPU + ["--data-dir", str(tmp_path / "db")]
    else:
        svc = DBService(small_config(shard_count=1), device="cpu")
        srv = DBServer(svc, port=0)
        srv.start_background()
        base = CPU + ["--coord-addr", srv.address]
    try:
        r = runner.invoke(cli, base + ["ingest-images", str(tmp_path / "imgs"),
                                       "--dataset", "cli", "--limit", "2"])
        assert r.exit_code == 0, r.output
        assert "ingested 2/2 images" in r.output
        r = runner.invoke(cli, base + ["text-search", "-k", "2", "a cat"])
        assert r.exit_code == 0, r.output
        rows = [line for line in r.output.splitlines()
                if "pic_" in line]
        assert len(rows) == 2
        assert {line.split("|")[1].strip() for line in rows} == {
            "pic_0.png", "pic_1.png"}
        assert paths[0] in r.output
    finally:
        if srv is not None:
            srv.shutdown()
            svc.close()


def test_rpc_profile_writes_a_trace(server, tmp_path):
    client = DBClient(server.address, timeout=60)
    r = client.call("profile", {"log_dir": str(tmp_path), "seconds": 0.2})
    assert r["success"], r
    assert os.path.getsize(tmp_path / "trace.json") > 0


def test_service_device_none_means_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: device None is cuda there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DBService(small_config())
