"""Text -> image end-to-end benchmark: the port of tpuvdb.bench.clip_e2e.

    python -m tpuvdb_torch.bench.clip_e2e      (or: cli bench --suite clip)

LAION-style serving at the reference's shape: a CLIP text tower of width
768, 12 layers and 12 heads (the ViT-L/14 text stack) runs as torch ops on
the same card as a corpus of 1,000,000 x 768 unit rows (seed 0), held as
int8 (`quantize_rows_np`). It measures the whole query path for a batch of
64 texts: tokenize -> text tower -> L2 normalize -> int8 scan -> top-10
(`kernels/quant.py` `l2sq_topk_int8`), all on the device except the
tokenizer, and each stage alone beside it.

Weights are seeded (the JAX package's `fast_init` draws); the architecture
and the path are what is measured, semantic quality needs the real
checkpoint ($TPUVDB_CLIP_MODEL).

`main()` prints one JSON line with the reference's keys; diagnostics go to
stderr. `run()` takes the sizes, so a test can call it small.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Optional

import numpy as np
import torch


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def run(n: int, dim: int, text_batch: int, k: int, device=None,
        cfg=None, iters: int = 20, reps: int = 3) -> dict:
    """Builds the embedder and the int8 corpus on `device` (None = cuda)
    and times the path. `cfg` defaults to the reference's text tower
    (width 768, 12 layers, 12 heads) with embed_dim = dim. Returns
    {"line": the JSON record, "stages_ms": each stage's time per batch,
    "init_s", "corpus_s", "tower_params", "corpus_bytes", and the
    batch's "texts", "dist" and "idx" (numpy, of the first call)}. Raises
    if the stages run one by one return another top-k than the path."""
    from tpuvdb_torch.bench.harness import chained_timer
    from tpuvdb_torch.device import resolve_device
    from tpuvdb_torch.embed.clip import CLIPConfig, CLIPEmbedder
    from tpuvdb_torch.kernels.quant import l2sq_topk_int8, quantize_rows_np

    dev = resolve_device(device)
    cfg = cfg or CLIPConfig(embed_dim=dim, text_width=768, text_layers=12,
                            text_heads=12)
    t0 = time.perf_counter()
    emb = CLIPEmbedder(cfg, device=dev)
    init_s = time.perf_counter() - t0
    tower_params = sum(p.numel() for p in emb.text_model.parameters())
    log(f"text tower init: {init_s:.3f} s (width {cfg.text_width}, "
        f"{cfg.text_layers} layers, {tower_params} parameters, "
        f"{tower_params * 4} bytes)")

    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    corpus = rng.standard_normal((n, dim), dtype=np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    ci8, scales = quantize_rows_np(corpus)
    sq = np.einsum("nd,nd->n", corpus, corpus).astype(np.float32)
    del corpus
    corpus_i8 = torch.from_numpy(ci8).to(dev)
    row_scales = torch.from_numpy(scales).to(dev)
    sqnorms = torch.from_numpy(sq).to(dev)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    corpus_s = time.perf_counter() - t0
    log(f"corpus resident: {n} x {dim} int8 = {n * dim} bytes, built in "
        f"{corpus_s:.3f} s")

    texts = [f"a photo of object number {i} on a table"
             for i in range(text_batch)]
    tokens = torch.from_numpy(emb.tokenize(texts)).to(dev, torch.long)

    def tower(tok):
        return emb.text_model(tok)

    def normalize(f):
        return f / torch.clamp(torch.linalg.norm(f, dim=-1, keepdim=True),
                               min=1e-12)

    def scan(feats):
        return l2sq_topk_int8(feats, corpus_i8, row_scales, sqnorms, valid,
                              k=k)

    def text_to_results(tok):
        return scan(normalize(tower(tok)))

    with torch.inference_mode():
        t0 = time.perf_counter()
        dist, idx = text_to_results(tokens)
        dist, idx = dist.cpu().numpy(), idx.cpu().numpy()
        log(f"first e2e call: {time.perf_counter() - t0:.3f} s")
        best = chained_timer(text_to_results, (tokens,), iters, reps)
        feats = tower(tokens)
        feats_n = normalize(feats)
        # the stages one by one compute what the timed path computes
        d_s, i_s = scan(feats_n)
        if not (np.array_equal(i_s.cpu().numpy(), idx)
                and np.array_equal(d_s.cpu().numpy(), dist)):
            raise AssertionError("the stages one by one and the whole path "
                                 "return different top-k")
        stages = {
            "tower": chained_timer(tower, (tokens,), iters, reps),
            "normalize": chained_timer(normalize, (feats,), iters, reps),
            "int8_scan_topk": chained_timer(scan, (feats_n,), iters, reps),
        }
    tok_s = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        emb.tokenize(texts)
        tok_s = min(tok_s, time.perf_counter() - t0)
    stages["tokenize"] = tok_s
    stages_ms = {name: s * 1e3 for name, s in stages.items()}
    qps = text_batch / best
    log(f"e2e text->top{k} over {n} x {dim}d int8: {best * 1e3} ms/batch"
        f"{text_batch} -> {qps} QPS; stages (ms a batch) {stages_ms}")
    line = {
        "metric": "clip_text_to_image_e2e_qps",
        "value": qps,
        "unit": "qps",
        "vs_baseline": None,
        "batch": text_batch,
        "corpus": [n, dim],
        "storage": "int8",
        "batch_latency_ms": best * 1e3,
        "includes": "text tower forward + normalize + int8 scan + top-k",
    }
    return {"line": line, "stages_ms": stages_ms, "init_s": init_s,
            "corpus_s": corpus_s, "tower_params": tower_params,
            "corpus_bytes": n * dim, "texts": texts, "dist": dist,
            "idx": idx}


def main(device: Optional[str] = None):
    out = run(1_000_000, 768, 64, 10, device)
    print(json.dumps(out["line"]))


if __name__ == "__main__":
    main()
