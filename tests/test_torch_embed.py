"""CLIP tower plumbing in the port: tests/test_embed.py's contract tests
(shapes, determinism, normalization, preprocessing, truncation) on
tpuvdb_torch.embed.clip, plus its tokenizer choice against the JAX
package's: the same hash ids, and the BPE found at the same places
($TPUVDB_CLIP_TOKENIZER, an explicit path, next to the weights).
"""

import json

import numpy as np
import pytest

from tpuvdb.embed.clip import CLIPConfig as JaxConfig
from tpuvdb.embed.clip import HashTokenizer as JaxHashTokenizer
from tpuvdb.embed.clip import _resolve_tokenizer as jax_resolve
from tpuvdb_torch.embed import bpe
from tpuvdb_torch.embed.clip import (
    CLIPConfig,
    CLIPEmbedder,
    HashTokenizer,
    _resolve_tokenizer,
)

TINY = dict(embed_dim=32, vocab_size=1024, text_width=64, text_layers=2,
            text_heads=2, context_length=16, image_size=64, patch_size=32,
            vision_width=64, vision_layers=2, vision_heads=2)


@pytest.fixture(scope="module")
def tiny_embedder():
    return CLIPEmbedder(CLIPConfig(**TINY), device="cpu")


def test_text_embedding_contract(tiny_embedder):
    e = tiny_embedder
    v = e.text2vec("a cat sitting on the sofa")
    assert v.shape == (32,) and v.dtype == np.float32
    assert abs(np.linalg.norm(v) - 1.0) < 1e-5
    v2 = e.text2vec("a cat sitting on the sofa")
    np.testing.assert_allclose(v, v2, atol=1e-6)  # deterministic
    v3 = e.text2vec("a completely different sentence")
    assert np.linalg.norm(v - v3) > 1e-3


def test_text_batch_matches_single(tiny_embedder):
    e = tiny_embedder
    batch = e.text2vec_batch(["hello world", "goodbye"])
    np.testing.assert_allclose(batch[0], e.text2vec("hello world"), atol=1e-5)


def test_image_embedding_contract(tiny_embedder):
    from PIL import Image

    e = tiny_embedder
    rng = np.random.default_rng(0)
    img = Image.fromarray(rng.integers(0, 255, (96, 128, 3), np.uint8))
    v = e.image2vec(img)
    assert v.shape == (32,) and v.dtype == np.float32
    assert abs(np.linalg.norm(v) - 1.0) < 1e-5


def test_preprocess_center_crop(tiny_embedder):
    from PIL import Image

    img = Image.new("RGB", (200, 100), (255, 0, 0))
    arr = tiny_embedder.preprocess_image(img)
    assert arr.shape == (64, 64, 3)
    # uniform red image: all pixels identical after normalization
    assert np.allclose(arr, arr[0, 0])


def test_tokenizer_truncates(tiny_embedder):
    toks = tiny_embedder.tokenizer.encode(" ".join(["word"] * 100))
    assert len(toks) <= tiny_embedder.cfg.context_length
    assert toks[0] == tiny_embedder.cfg.bos_token


def test_same_seed_same_towers_other_seed_not():
    a = CLIPEmbedder(CLIPConfig(**TINY), seed=3, device="cpu")
    b = CLIPEmbedder(CLIPConfig(**TINY), seed=3, device="cpu")
    c = CLIPEmbedder(CLIPConfig(**TINY), seed=4, device="cpu")
    va, vb, vc = (e.text2vec("same text") for e in (a, b, c))
    np.testing.assert_array_equal(va, vb)
    assert np.linalg.norm(va - vc) > 1e-3


@pytest.mark.parametrize("text", [
    "a photo of a cat", "  MIXED Case   words ", "", "x " * 40,
    "naïve café", "don't stop",
])
def test_hash_tokenizer_equals_jax(text):
    mine = HashTokenizer(CLIPConfig(**TINY)).encode(text)
    assert mine == JaxHashTokenizer(JaxConfig(**TINY)).encode(text)
    full = HashTokenizer(CLIPConfig()).encode(text)
    assert full == JaxHashTokenizer(JaxConfig()).encode(text)


def test_no_bpe_falls_back_to_hash_with_a_warning(monkeypatch):
    monkeypatch.delenv("TPUVDB_CLIP_TOKENIZER", raising=False)
    with pytest.warns(UserWarning, match="hash tokenizer"):
        e = CLIPEmbedder(CLIPConfig(**TINY), device="cpu")
    assert isinstance(e.tokenizer, HashTokenizer)


def _write_table(d):
    vocab = {t: i for i, t in enumerate(
        list(bpe.bytes_to_unicode().values())
        + [v + "</w>" for v in bpe.bytes_to_unicode().values()]
        + ["<|startoftext|>", "<|endoftext|>"])}
    (d / "vocab.json").write_text(json.dumps(vocab))
    (d / "merges.txt").write_text("#version: 0.2\n")


@pytest.mark.parametrize("where", ["env_dir", "model_dir", "explicit_dir"])
def test_bpe_found_where_jax_finds_it(where, tmp_path, monkeypatch):
    _write_table(tmp_path)
    monkeypatch.delenv("TPUVDB_CLIP_TOKENIZER", raising=False)
    kw = {"tokenizer_path": None, "model_dir": None}
    if where == "env_dir":
        monkeypatch.setenv("TPUVDB_CLIP_TOKENIZER", str(tmp_path))
    elif where == "model_dir":
        kw["model_dir"] = str(tmp_path)
    else:
        kw["tokenizer_path"] = str(tmp_path)
    mine = _resolve_tokenizer(cfg=CLIPConfig(**TINY), **kw)
    ref = jax_resolve(cfg=JaxConfig(**TINY), **kw)
    assert isinstance(mine, bpe.ClipBPETokenizer)
    assert mine.context_length == 16
    for text in ("a photo of a cat", "x " * 40):
        assert mine.encode(text) == ref.encode(text)
