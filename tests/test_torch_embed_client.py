"""The port's remote ingest/search client (tpuvdb_torch/embed/client.py,
`VectorDBOperation`) against a port server and a JAX server: the cases of
tests/test_embed_client.py on both, and the same answers from both
servers for one embedder. The JAX service's native library is switched
off (the reference's build races between test workers).
"""

import numpy as np
import pytest

from tpuvdb import native as jax_native
from tpuvdb.api.server import DBServer as JaxServer
from tpuvdb.api.service import DBService as JaxService
from tpuvdb.core.config import DBConfig as JaxConfig
from tpuvdb_torch.api.server import DBServer
from tpuvdb_torch.api.service import DBService
from tpuvdb_torch.core.config import DBConfig
from tpuvdb_torch.embed import clip
from tpuvdb_torch.embed.client import VectorDBOperation
from tpuvdb_torch.embed.clip import CLIPConfig, CLIPEmbedder

TINY = dict(embed_dim=32, vocab_size=512, text_width=64, text_layers=2,
            text_heads=2, context_length=16, image_size=64, patch_size=32,
            vision_width=64, vision_layers=2, vision_heads=2)
DB = dict(vector_dim=32, shard_capacity=1024, block_size=128)


@pytest.fixture(autouse=True)
def _no_reference_build(monkeypatch):
    monkeypatch.setattr(jax_native, "available", lambda: False)
    monkeypatch.setattr(jax_native, "rescore_available", lambda: False)


@pytest.fixture(scope="module")
def embedder():
    return CLIPEmbedder(CLIPConfig(**TINY), device="cpu")


def _server(package, shard_count=2):
    if package == "port":
        svc = DBService(DBConfig(**DB, shard_count=shard_count),
                        device="cpu")
        srv = DBServer(svc, port=0)
    else:
        svc = JaxService(JaxConfig(**DB, shard_count=shard_count))
        srv = JaxServer(svc, port=0)
    srv.start_background()
    return svc, srv


@pytest.fixture(params=["port", "jax"])
def clip_server(request):
    svc, srv = _server(request.param)
    yield srv
    srv.shutdown()
    svc.close()


def _images(d, rng, n=3):
    from PIL import Image

    for i in range(n):
        Image.fromarray(rng.integers(0, 255, (72, 72, 3), np.uint8)).save(
            str(d / f"pic_{i}.png"))
    (d / "notes.txt").write_text("not an image")


def test_remote_image_ingest_and_text_search(clip_server, embedder,
                                             tmp_path, rng):
    _images(tmp_path, rng)
    op = VectorDBOperation(clip_server.address, embedder=embedder,
                           vector_dim=32)
    out = op.batch_put_images(str(tmp_path), dataset="remote", batch_size=2)
    assert out == {"success": True, "ingested": 3, "total": 3}
    res = op.text_search("whatever", top_k=2)
    assert len(res) == 2
    assert res[0]["metadata"]["dataset"] == "remote"
    assert res[0]["file_path"].endswith(".png")
    assert res[0]["score"] <= res[1]["score"]

    r = op.put_image(str(tmp_path / "pic_0.png"), key="again")
    assert r["success"]
    # the image's own vector finds one of its two copies first (the two
    # share a scan bucket: slot 0 of each shard)
    top = op.client.call("search", {
        "query_vector": embedder.image2vec(str(tmp_path / "pic_0.png"))
        .tolist(), "top_k": 1})["search_result"]
    assert top["keys"][0] in ("again", "pic_0.png")
    assert top["scores"][0] < 1e-3


def test_both_servers_answer_alike(embedder, tmp_path, rng):
    """One shard: each of the few rows has a scan bucket of its own, so
    the port's default "approx" search is exact here, as the JAX
    package's is on the CPU."""
    _images(tmp_path, rng, n=5)
    results = {}
    for package in ("port", "jax"):
        svc, srv = _server(package, shard_count=1)
        try:
            op = VectorDBOperation(srv.address, embedder=embedder,
                                   vector_dim=32)
            assert op.batch_put_images(str(tmp_path), limit=4)["ingested"] == 4
            results[package] = op.text_search("a red bus", top_k=3)
        finally:
            srv.shutdown()
            svc.close()
    port, ref = results["port"], results["jax"]
    assert [r["key"] for r in port] == [r["key"] for r in ref]
    np.testing.assert_allclose([r["score"] for r in port],
                               [r["score"] for r in ref], rtol=1e-5,
                               atol=1e-5)


def test_embedder_loads_on_the_callers_device(monkeypatch):
    seen = []

    def fake(dim, device=None):
        seen.append((dim, device))
        return "embedder"

    monkeypatch.setattr(clip, "load_default_embedder", fake)
    op = VectorDBOperation("127.0.0.1:1", vector_dim=24, device="cpu")
    assert op.embedder == "embedder" and op.embedder == "embedder"
    assert seen == [(24, "cpu")]
