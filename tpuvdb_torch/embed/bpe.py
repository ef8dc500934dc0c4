"""CLIP byte-level BPE tokenizer: the port's own copy of tpuvdb.embed.bpe,
which is pure Python (the port imports nothing of the JAX package).

The reference system embeds text through HuggingFace's CLIPProcessor,
whose text side is the OpenAI CLIP tokenizer: lowercase +
whitespace-cleaned text, split by the CLIP regex, bytes mapped to printable
unicode (GPT-2 byte encoder), then greedy lowest-rank BPE merges with a
``</w>`` end-of-word marker, wrapped in ``<|startoftext|>`` /
``<|endoftext|>``.

tests/test_torch_bpe.py holds this copy token for token against
tpuvdb.embed.bpe and ``transformers.CLIPTokenizer`` on a merge table
trained in the test, in all three file formats.

Vocabulary data: the real 49,408-entry table ships with every HF CLIP
checkpoint (vocab.json + merges.txt, or tokenizer.json) and with OpenAI's
original ``bpe_simple_vocab_16e6.txt.gz``; the repository holds none. All
three formats load via :func:`load_clip_bpe`, and the embedder finds them
next to the model weights or at $TPUVDB_CLIP_TOKENIZER. The split regex
needs the ``regex`` package, imported at the first encode.
"""

from __future__ import annotations

import functools
import gzip
import html
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = [
    "ClipBPETokenizer",
    "bytes_to_unicode",
    "load_clip_bpe",
    "find_tokenizer_assets",
]


@functools.lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte->printable-unicode map.

    The 188 bytes that are already printable-and-not-space map to
    themselves; the rest shift into the U+0100.. range so every byte
    sequence becomes a lossless unicode string with no whitespace/control
    characters (which would confuse the BPE merge loop).
    """
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word: Tuple[str, ...]):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


@functools.lru_cache()
def _clip_pattern():
    import regex

    # The CLIP split regex (same as HF CLIPTokenizer.pat): special tokens,
    # English contractions, letter runs, single digits, punctuation runs.
    return regex.compile(
        r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
        r"|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+",
        regex.IGNORECASE,
    )


@functools.lru_cache()
def _ws_pattern():
    import regex

    return regex.compile(r"\s+")


def whitespace_clean(text: str) -> str:
    return _ws_pattern().sub(" ", text).strip()


def basic_clean(text: str) -> str:
    # OpenAI runs ftfy.fix_text here (mojibake repair; identity on clean
    # text — ftfy is not in this image) then double-unescapes HTML.
    return html.unescape(html.unescape(text))


class ClipBPETokenizer:
    """CLIP BPE over an explicit (vocab, merges) table.

    vocab:  token string -> id (must contain <|startoftext|>/<|endoftext|>)
    merges: ordered list of (left, right) pairs; index = merge priority
    """

    BOS = "<|startoftext|>"
    EOS = "<|endoftext|>"

    def __init__(self, vocab: Dict[str, int], merges: Sequence[Tuple[str, str]],
                 context_length: int = 77):
        self.encoder = dict(vocab)
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.context_length = context_length
        self.bos_token = self.encoder[self.BOS]
        self.eos_token = self.encoder[self.EOS]
        self._cache: Dict[str, str] = {self.BOS: self.BOS, self.EOS: self.EOS}

    # ------------------------------------------------------------------ core

    def bpe(self, token: str) -> str:
        """Greedy merge loop: repeatedly merge the lowest-rank adjacent
        pair. The last character carries the ``</w>`` end-of-word marker so
        'cat' mid-word and 'cat' word-final are distinct tokens."""
        cached = self._cache.get(token)
        if cached is not None:
            return cached
        word: Tuple[str, ...] = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word) if len(word) > 1 else None
        if not pairs:
            out = token + "</w>"
            self._cache[token] = out
            return out
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self._cache[token] = out
        return out

    def tokenize(self, text: str) -> List[str]:
        """Text -> BPE token strings (no special tokens)."""
        text = whitespace_clean(basic_clean(text)).lower()
        toks: List[str] = []
        for piece in _clip_pattern().findall(text):
            piece = "".join(self.byte_encoder[b] for b in piece.encode("utf-8"))
            toks.extend(self.bpe(piece).split(" "))
        return toks

    def encode(self, text: str) -> List[int]:
        """Text -> [BOS, ids..., EOS], truncated to context_length with EOS
        always last (openai clip.tokenize truncate=True behavior)."""
        unk = self.eos_token  # CLIP has no UNK; HF maps unknowns to EOS
        ids = [self.encoder.get(t, unk) for t in self.tokenize(text)]
        ids = [self.bos_token] + ids + [self.eos_token]
        if len(ids) > self.context_length:
            ids = ids[: self.context_length]
            ids[-1] = self.eos_token
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        text = "".join(
            self.decoder.get(int(i), "")
            for i in ids
            if int(i) not in (self.bos_token, self.eos_token)
        )
        data = bytearray(self.byte_decoder[c] for c in text if c in self.byte_decoder)
        return data.decode("utf-8", errors="replace").replace("</w>", " ").strip()

    def __len__(self) -> int:
        return len(self.encoder)


# -------------------------------------------------------------------- loaders


def _from_hf_files(vocab_file: str, merges_file: str,
                   context_length: int) -> ClipBPETokenizer:
    with open(vocab_file, encoding="utf-8") as f:
        vocab = json.load(f)
    merges: List[Tuple[str, str]] = []
    with open(merges_file, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#version"):
                continue
            parts = tuple(line.split())
            if len(parts) == 2:
                merges.append(parts)  # type: ignore[arg-type]
    return ClipBPETokenizer(vocab, merges, context_length)


def _from_tokenizer_json(path: str, context_length: int) -> ClipBPETokenizer:
    with open(path, encoding="utf-8") as f:
        spec = json.load(f)
    model = spec["model"]
    vocab = model["vocab"]
    merges = []
    for m in model["merges"]:
        # old format: "a b" strings; new format: ["a", "b"] pairs
        pair = tuple(m.split(" ")) if isinstance(m, str) else tuple(m)
        merges.append(pair)
    return ClipBPETokenizer(vocab, merges, context_length)


def _from_openai_gz(path: str, context_length: int) -> ClipBPETokenizer:
    """OpenAI's bpe_simple_vocab_16e6.txt.gz: a merge list from which the
    vocab is derived (256 bytes, 256 byte+</w>, one token per merge, then
    the two specials) — 49,408 entries total."""
    with gzip.open(path, "rt", encoding="utf-8") as f:
        lines = f.read().split("\n")
    merges = [tuple(m.split()) for m in lines[1 : 49152 - 256 - 2 + 1]]
    base = list(bytes_to_unicode().values())
    tokens = base + [v + "</w>" for v in base]
    tokens += ["".join(m) for m in merges]
    tokens += [ClipBPETokenizer.BOS, ClipBPETokenizer.EOS]
    vocab = {t: i for i, t in enumerate(tokens)}
    return ClipBPETokenizer(vocab, merges, context_length)


def find_tokenizer_assets(search_dirs: Sequence[str]) -> Optional[Tuple[str, ...]]:
    """Locate tokenizer data in any of `search_dirs` (e.g. an HF checkpoint
    directory, which ships vocab.json+merges.txt next to the weights).
    Returns a loadable path tuple or None."""
    for d in search_dirs:
        if not d or not os.path.isdir(d):
            continue
        vj = os.path.join(d, "vocab.json")
        mt = os.path.join(d, "merges.txt")
        if os.path.isfile(vj) and os.path.isfile(mt):
            return (vj, mt)
        tj = os.path.join(d, "tokenizer.json")
        if os.path.isfile(tj):
            return (tj,)
        gz = os.path.join(d, "bpe_simple_vocab_16e6.txt.gz")
        if os.path.isfile(gz):
            return (gz,)
    return None


def load_clip_bpe(*paths: str, context_length: int = 77) -> ClipBPETokenizer:
    """Load from (vocab.json, merges.txt), (tokenizer.json,) or
    (bpe_simple_vocab_16e6.txt.gz,)."""
    if len(paths) == 2:
        return _from_hf_files(paths[0], paths[1], context_length)
    if len(paths) != 1:
        raise ValueError(f"expected 1 or 2 paths, got {len(paths)}")
    p = paths[0]
    if p.endswith(".gz"):
        return _from_openai_gz(p, context_length)
    with open(p, encoding="utf-8") as f:
        head = f.read(512)
    if '"model"' in head:  # tokenizer.json (full HF fast-tokenizer spec)
        return _from_tokenizer_json(p, context_length)
    raise ValueError(
        f"unrecognized tokenizer file {p}; pass (vocab.json, merges.txt), "
        "tokenizer.json, or bpe_simple_vocab_16e6.txt.gz"
    )
