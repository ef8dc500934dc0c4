"""Service-level text -> image search in the port (tpuvdb_torch/api/
service.py with tpuvdb_torch/embed/clip.py): tests/test_service_clip.py's
cases (embed -> ingest -> search -> results), the service's lazily loaded
embedder on its own device, /api/search over HTTP, and parity: a JAX
service and a port service holding the same towers (the JAX flax params
carried across by `params_from_jax`) and the same seeded images return the
same text_search keys, scores within rtol 1e-4 / atol 1e-5 (the towers'
f32 rounding, rtol 2e-4 / atol 2e-5 on features, moves unit vectors'
squared distances by less).

Also the CLIP benchmark: a small `clip_e2e.run` prints the reference's
JSON keys, and its fused path's top-k equals the port's and the JAX
package's int8 scans on the same features.
"""

import ast
import functools
import json
import os

import jax
import numpy as np
import pytest
from click.testing import CliRunner

from tpuvdb import native as jax_native
from tpuvdb.api.service import DBService as JaxService
from tpuvdb.core.config import DBConfig as JaxConfig
from tpuvdb.embed.clip import CLIPConfig as JaxClipConfig
from tpuvdb.embed.clip import CLIPEmbedder as JaxEmbedder
from tpuvdb_torch.api.cli import cli
from tpuvdb_torch.api.server import DBServer
from tpuvdb_torch.api.service import DBService
from tpuvdb_torch.core.config import DBConfig
from tpuvdb_torch.embed import clip
from tpuvdb_torch.embed.clip import CLIPConfig, CLIPEmbedder

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY = dict(embed_dim=32, vocab_size=512, text_width=64, text_layers=2,
            text_heads=2, context_length=16, image_size=64, patch_size=32,
            vision_width=64, vision_layers=2, vision_heads=2)
DB = dict(vector_dim=32, shard_count=2, shard_capacity=1024, block_size=128)


@pytest.fixture(autouse=True)
def _no_reference_build(monkeypatch):
    monkeypatch.setattr(jax_native, "available", lambda: False)
    monkeypatch.setattr(jax_native, "rescore_available", lambda: False)


@pytest.fixture(scope="module")
def svc():
    s = DBService(DBConfig(**DB), device="cpu",
                  embedder=CLIPEmbedder(CLIPConfig(**TINY), device="cpu"))
    yield s
    s.close()


def _save_images(d, rng, n, prefix="img", size=80):
    from PIL import Image

    paths = []
    for i in range(n):
        img = Image.fromarray(rng.integers(0, 255, (size, size, 3), np.uint8))
        p = str(d / f"{prefix}_{i}.png")
        img.save(p)
        paths.append(p)
    return paths


def test_put_image_and_text_search(svc, tmp_path, rng):
    for p in _save_images(tmp_path, rng, 4):
        r = svc.put_image(p, dataset="test")
        assert r["success"], r

    out = svc.text_search("anything", topk=3)
    assert len(out["results"]) == 3
    for res in out["results"]:
        assert res["file_path"].endswith(".png")
        assert res["metadata"]["dataset"] == "test"
        assert isinstance(res["score"], float)
    scores = [r["score"] for r in out["results"]]
    assert scores == sorted(scores)


def test_image_self_retrieval(svc, tmp_path, rng):
    """Searching by an image's own embedding returns that image first."""
    (p,) = _save_images(tmp_path, rng, 1, prefix="target")
    svc.put_image(p, key="target.png")
    vec = svc.embedder.image2vec(p)
    hits = svc.engine.search_hits(vec, 1)
    assert hits[0].key == "target.png"
    assert hits[0].score < 1e-3


def test_api_search_over_http(svc, tmp_path, rng):
    from tpuvdb_torch.api.client import DBClient

    for p in _save_images(tmp_path, rng, 3, prefix="web"):
        assert svc.put_image(p, dataset="web")["success"]
    srv = DBServer(svc, port=0)
    srv.start_background()
    try:
        out = DBClient(srv.address, timeout=60).api_search("a red bus", 2)
    finally:
        srv.shutdown()
    assert out == svc.text_search("a red bus", 2)
    assert len(out["results"]) == 2


def test_service_loads_its_embedder_on_its_device(monkeypatch, tmp_path,
                                                  rng):
    """With no embedder passed in, the service loads
    load_default_embedder(vector_dim) on its own device at first use."""
    tiny = {k: v for k, v in TINY.items() if k != "embed_dim"}
    monkeypatch.setattr(clip, "CLIPConfig",
                        functools.partial(CLIPConfig, **tiny))
    monkeypatch.setattr(clip, "_defaults", {})
    s = DBService(DBConfig(**DB), device="cpu")
    try:
        emb = s.embedder
        assert emb is clip.load_default_embedder(32, device="cpu")
        assert emb.device.type == "cpu" and emb.cfg.embed_dim == 32
        (p,) = _save_images(tmp_path, rng, 1)
        assert s.put_image(p)["success"]
        assert s.text_search("x", 1)["results"][0]["key"] == "img_0.png"
    finally:
        s.close()


def test_jax_and_port_services_agree(tmp_path, rng):
    """Same towers, same images, same texts: the same keys in the same
    order. One shard, so each row has a scan bucket of its own and the
    port's default "approx" search is exact, as the JAX package's is on
    the CPU."""
    je = JaxEmbedder(JaxClipConfig(**TINY), seed=1)
    pe = CLIPEmbedder(CLIPConfig(**TINY), device="cpu")
    pe.params_from_jax(jax.tree_util.tree_map(np.asarray, je.text_params),
                       jax.tree_util.tree_map(np.asarray, je.vision_params))
    db = dict(DB, shard_count=1)
    jsvc = JaxService(JaxConfig(**db), embedder=je)
    psvc = DBService(DBConfig(**db), device="cpu", embedder=pe)
    try:
        for p in _save_images(tmp_path, rng, 12, size=70):
            assert jsvc.put_image(p)["success"]
            assert psvc.put_image(p)["success"]
        for text in ("a photo of a cat", "red", "two dogs on a sofa", ""):
            want = jsvc.text_search(text, topk=5)["results"]
            got = psvc.text_search(text, topk=5)["results"]
            assert [r["key"] for r in got] == [r["key"] for r in want], text
            np.testing.assert_allclose([r["score"] for r in got],
                                       [r["score"] for r in want],
                                       rtol=1e-4, atol=1e-5)
            assert ([r["metadata"] for r in got]
                    == [r["metadata"] for r in want])
    finally:
        jsvc.close()
        psvc.close()


# ------------------------------------------------------ the CLIP benchmark


def _reference_keys():
    """The keys of the JSON line tpuvdb/bench/clip_e2e.py prints."""
    with open(os.path.join(ROOT, "tpuvdb", "bench", "clip_e2e.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
                == "dumps" and node.args
                and isinstance(node.args[0], ast.Dict)):
            return [k.value for k in node.args[0].keys]
    raise AssertionError("no json.dumps({...}) in the reference")


def test_clip_e2e_small_run_prints_the_references_keys():
    from tpuvdb.kernels.quant import l2sq_topk_int8_xla
    from tpuvdb_torch.bench import clip_e2e
    from tpuvdb_torch.kernels.quant import l2sq_topk_int8, quantize_rows_np

    import torch

    n, dim, k = 3000, 32, 5
    cfg = CLIPConfig(**dict(TINY, embed_dim=dim))
    out = clip_e2e.run(n, dim, 6, k, device="cpu", cfg=cfg, iters=2, reps=1)
    line = out["line"]
    assert list(line) == _reference_keys()
    json.dumps(line)
    assert line["batch"] == 6 and line["corpus"] == [n, dim]
    assert line["value"] > 0 and line["batch_latency_ms"] > 0
    assert set(out["stages_ms"]) == {"tokenize", "tower", "normalize",
                                     "int8_scan_topk"}

    # the fused path against the plain composition, and against the JAX
    # package's int8 scan on the same features and corpus
    rng = np.random.default_rng(0)
    corpus = rng.standard_normal((n, dim), dtype=np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    ci8, scales = quantize_rows_np(corpus)
    sq = np.einsum("nd,nd->n", corpus, corpus).astype(np.float32)
    feats = CLIPEmbedder(cfg, device="cpu").text2vec_batch(out["texts"])
    args = (ci8, scales, sq, np.ones(n, bool))
    d_p, i_p = l2sq_topk_int8(torch.from_numpy(feats),
                              *map(torch.from_numpy, args), k=k)
    d_j, i_j = l2sq_topk_int8_xla(feats, *args, k=k)
    np.testing.assert_array_equal(out["idx"], i_p.numpy())
    np.testing.assert_array_equal(out["idx"], np.asarray(i_j))
    np.testing.assert_allclose(out["dist"], np.asarray(d_j), rtol=1e-5,
                               atol=1e-5)
    assert (np.diff(out["dist"], axis=1) >= 0).all()


def test_cli_bench_clip_runs_the_clip_benchmark(monkeypatch):
    from tpuvdb_torch.bench import clip_e2e

    seen = []
    monkeypatch.setattr(clip_e2e, "main", lambda device=None:
                        seen.append(device))
    r = CliRunner().invoke(cli, ["--device", "cpu", "bench", "--suite",
                                 "clip"])
    assert r.exit_code == 0, r.output
    assert seen == ["cpu"]
