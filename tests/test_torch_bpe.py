"""The port's CLIP BPE (tpuvdb_torch/embed/bpe.py) against the JAX
package's (tpuvdb/embed/bpe.py) and `transformers.CLIPTokenizer`, token
for token, on tests/test_bpe.py's trained merge table and string battery,
in all three file formats: vocab.json + merges.txt, tokenizer.json (merges
as "a b" strings and as pairs) and OpenAI's bpe_simple_vocab_16e6.txt.gz.
"""

import gzip
import json

import pytest

from test_bpe import BATTERY, CORPUS, build_vocab, train_merges
from tpuvdb.embed import bpe as jax_bpe
from tpuvdb_torch.embed import bpe

UNICODE = ["naïve café", "piñata jalapeño", "über señor"]
LONG = ["cat " * 500, " ".join(CORPUS) * 3]


@pytest.fixture(scope="module")
def table():
    merges = train_merges(CORPUS)
    assert len(merges) > 50
    return build_vocab(merges), merges


def _write(fmt, vocab, merges, d):
    """The table in one file format; returns the loader's paths."""
    if fmt == "hf":
        vj, mt = d / "vocab.json", d / "merges.txt"
        vj.write_text(json.dumps(vocab))
        mt.write_text("#version: 0.2\n"
                      + "".join(f"{a} {b}\n" for a, b in merges))
        return (str(vj), str(mt))
    if fmt.startswith("tokenizer_json"):
        pairs = fmt.endswith("pairs")
        tj = d / "tokenizer.json"
        tj.write_text(json.dumps({"model": {
            "type": "BPE", "vocab": vocab,
            "merges": [[a, b] if pairs else f"{a} {b}" for a, b in merges]}}))
        return (str(tj),)
    gz = d / "bpe_simple_vocab_16e6.txt.gz"
    with gzip.open(gz, "wt", encoding="utf-8") as f:
        f.write("#version 0.1\n")
        f.write("\n".join(f"{a} {b}" for a, b in merges))
    return (str(gz),)


@pytest.fixture(scope="module")
def hf(table, tmp_path_factory):
    pytest.importorskip("transformers")
    from transformers import CLIPTokenizer

    paths = _write("hf", *table, tmp_path_factory.mktemp("hf"))
    return CLIPTokenizer(*paths)


@pytest.mark.parametrize("fmt", ["hf", "tokenizer_json_strings",
                                 "tokenizer_json_pairs", "openai_gz"])
def test_matches_jax_and_transformers(fmt, table, hf, tmp_path):
    paths = _write(fmt, *table, tmp_path)
    mine = bpe.load_clip_bpe(*paths)
    ref = jax_bpe.load_clip_bpe(*paths)
    assert len(mine) == len(ref)
    for text in BATTERY + UNICODE:
        got = mine.encode(text)
        assert got == ref.encode(text), text
        assert got == hf(text)["input_ids"], text
        assert mine.tokenize(text) == ref.tokenize(text), text
        assert mine.decode(got) == ref.decode(got), text
    for text in LONG:
        got = mine.encode(text)
        assert got == ref.encode(text)
        assert len(got) == 77 and got[-1] == mine.eos_token


@pytest.mark.parametrize("context_length", [8, 16])
def test_truncation_matches_jax(table, context_length):
    vocab, merges = table
    mine = bpe.ClipBPETokenizer(vocab, merges, context_length)
    ref = jax_bpe.ClipBPETokenizer(vocab, merges, context_length)
    for text in BATTERY + LONG:
        got = mine.encode(text)
        assert got == ref.encode(text), text
        assert len(got) <= context_length and got[-1] == mine.eos_token


def test_unknown_pieces_map_to_eos_as_jax(table):
    """The inherited quirk: a piece outside the vocab becomes EOS."""
    vocab, merges = table
    small = {k: v for k, v in vocab.items() if not k.startswith("c")}
    mine = bpe.ClipBPETokenizer(small, merges)
    ref = jax_bpe.ClipBPETokenizer(small, merges)
    ids = mine.encode("cat cafe")
    assert ids == ref.encode("cat cafe")
    assert mine.eos_token in ids[1:-1]


def test_bytes_to_unicode_equals_jax():
    assert bpe.bytes_to_unicode() == jax_bpe.bytes_to_unicode()


@pytest.mark.parametrize("files", [
    (), ("vocab.json",), ("vocab.json", "merges.txt"), ("tokenizer.json",),
    ("bpe_simple_vocab_16e6.txt.gz",), ("tokenizer.json", "vocab.json",
                                        "merges.txt"),
])
def test_find_tokenizer_assets_equals_jax(files, tmp_path):
    for name in files:
        (tmp_path / name).write_text("{}")
    dirs = [str(tmp_path / "missing"), str(tmp_path)]
    assert (bpe.find_tokenizer_assets(dirs)
            == jax_bpe.find_tokenizer_assets(dirs))


def test_unrecognized_file_raises(tmp_path):
    p = tmp_path / "x.txt"
    p.write_text("not a tokenizer")
    with pytest.raises(ValueError, match="unrecognized tokenizer file"):
        bpe.load_clip_bpe(str(p))
    with pytest.raises(ValueError, match="expected 1 or 2 paths"):
        bpe.load_clip_bpe("a", "b", "c")
