"""Capacity-scale int8 scan: the port of scripts/bench_capacity.py, and
the helpers the capacity benches share.

    python -m tpuvdb_torch.bench.capacity [--rows 8000000] [--dim 768]
                                          [--k 10] [--device cuda]

8,000,000 x 768 unit rows (CLIP-shaped) stored int8 on one card: 0.75 KB
a row, 6.1 GB of device memory. The corpus is the reference's, draw for
draw: 512 unit centres, a 0.25 spread, 500,000-row chunks, each chunk
quantized by `quantize_rows_np` on the host; 64 held-out queries of the
same mixture, and an exact f32 oracle streamed over the chunks. Four
paths run on `device` at k = 10, each timed by `harness.chained_timer`
(CUDA events on the card, the host clock on the CPU; the reference chains
an on-device loop to see past its relay):

  int8_b128, int8_b256            kernels/quant.l2sq_topk_int8
  int8_resc_b128, int8_resc_b256  kernels/quant.l2sq_topk_int8_rescored,
                                  fetch 32 (an exact re-rank on the device)

Both are torch ops, as the reference's are XLA: no hand-written kernel.
Diagnostics go to stderr, and stdout takes one JSON line with the
reference's keys: {path: {"qps", "recall", "ms", "GiBps"}}.

Divergences by design: the reference hard codes rows, dim and k, the
port takes them as arguments (`run`, and the flags above) with the
reference's values as defaults; a time that is not positive raises in
chained_timer, where the reference logs it and skips the path.

Shared with the other capacity benches: `rss_gb` (the peak RSS the
reference scripts report), `nbytes`, `recall_of`, `clustered_unit_draws` (the corpus of this
bench and of bench/capacity_ivf.py), `StreamedOracle` and `stored_oracle`
(the exact scan over an engine's stored int8 rows).
"""

from __future__ import annotations

import argparse
import json
import resource
import sys
import time
from typing import Iterator, List, Optional, Set, Tuple

import numpy as np
import torch

N, DIM, K = 8_000_000, 768, 10
CHUNK = 500_000       # rows drawn, quantized and scored at a time
N_CLUSTERS = 512
SPREAD = 0.25         # noise of a row around its unit centre
N_CHECK = 64          # held-out queries whose recall is taken
FETCH = 32            # candidates of the rescored paths
ORACLE_BLOCK = 262_144  # stored rows scored at a time
DRAW_BLOCK = 16_384   # rows whose f64 normals are drawn at a time


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def rss_gb() -> float:
    """Peak resident set of this process in GB (ru_maxrss), as the
    reference scripts report it."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024 / 1024


class _UnitMixture:
    """Unit rows around unit centres, drawn as the reference draws them
    (`cid = rng.integers(...)`, then `centers[cid] + std *
    rng.standard_normal((m, dim)).astype(float32)`, each row normalized),
    bit for bit: the normals are drawn DRAW_BLOCK rows at a time into one
    reused f64 buffer, which consumes the generator in the same order, and
    every other step is elementwise or row by row. The rows land in one
    reused f32 buffer (warm pages: no fresh 3 GB f64 temporary a chunk)."""

    def __init__(self, rng: np.random.Generator, centers: np.ndarray,
                 std: float, max_rows: int):
        self.rng, self.centers, self.std = rng, centers, np.float32(std)
        dim = centers.shape[1]
        self.out = np.empty((max_rows, dim), np.float32)
        self.normals = np.empty((min(DRAW_BLOCK, max_rows), dim))

    def draw(self, m: int) -> np.ndarray:
        cid = self.rng.integers(0, len(self.centers), m)
        for lo in range(0, m, len(self.normals)):
            b = min(len(self.normals), m - lo)
            self.rng.standard_normal(out=self.normals[:b])
            x = self.out[lo:lo + b]
            x[:] = self.normals[:b]
            x *= self.std
            x += self.centers[cid[lo:lo + b]]
            x /= np.linalg.norm(x, axis=1, keepdims=True)
        return self.out[:m]


def clustered_unit_draws(
    rows: int, dim: int, std: float,
) -> Tuple[np.ndarray, Iterator[Tuple[int, np.ndarray]]]:
    """(queries (N_CHECK, dim), chunks): the draws of the reference's
    capacity scripts (scripts/bench_capacity.py:31-51,
    scripts/bench_capacity_ivf.py:54-86), from default_rng(0): N_CLUSTERS
    unit centres, the held-out queries, then unit rows around the centres,
    yielded as (first row, rows (<= CHUNK, dim) f32). Each chunk is a view
    of one buffer that the next chunk overwrites."""
    rng = np.random.default_rng(0)
    centers = rng.standard_normal((N_CLUSTERS, dim)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    queries = _UnitMixture(rng, centers, std, N_CHECK).draw(N_CHECK)

    def chunks():
        mix = _UnitMixture(rng, centers, std, min(CHUNK, rows))
        for lo in range(0, rows, CHUNK):
            yield lo, mix.draw(min(CHUNK, rows - lo))

    return queries, chunks()


class StreamedOracle:
    """The exact f32 top-k of `queries` over row chunks added in order,
    with the reference's arithmetic (|q|^2 - 2 q.x + |x|^2 in f32, the
    running best in f64)."""

    def __init__(self, queries: np.ndarray, k: int):
        self.queries = queries
        self.k = k
        self.qsq = np.einsum("qd,qd->q", queries, queries)
        self.best_d = np.full((len(queries), k), np.inf, np.float64)
        self.best_i = np.full((len(queries), k), -1, np.int64)

    def add(self, lo: int, x: np.ndarray, sqn: np.ndarray) -> None:
        k = self.k
        d = self.qsq[:, None] - 2.0 * (self.queries @ x.T) + sqn[None, :]
        di = np.argpartition(d, k, axis=1)[:, :k]
        dv = np.take_along_axis(d, di, axis=1)
        alld = np.concatenate([self.best_d, dv], axis=1)
        alli = np.concatenate([self.best_i, di + lo], axis=1)
        order = np.argsort(alld, axis=1)[:, :k]
        self.best_d = np.take_along_axis(alld, order, axis=1)
        self.best_i = np.take_along_axis(alli, order, axis=1)


def stored_oracle(eng, queries: np.ndarray, k: int,
                  layout) -> List[Set[str]]:
    """The keys of the exact top-k of `queries` over the rows the engine
    stores (its int8 mirrors, dequantized), scored on the engine's device
    in blocks of ORACLE_BLOCK rows read through `prefix_raw` views; no f32
    copy of the corpus is made. `layout` maps (shard, slot) to the rows
    the engine's index numbers."""
    dev = eng.device
    q = torch.from_numpy(np.ascontiguousarray(queries, np.float32)).to(dev)
    qsq = (q * q).sum(dim=1)
    best_d = torch.full((len(queries), k), float("inf"), device=dev)
    best_r = torch.full((len(queries), k), -1, dtype=torch.int64, device=dev)
    for s, m in enumerate(eng.mirrors):
        raw, scale, msq, valid = m.prefix_raw()
        for lo in range(0, len(raw), ORACLE_BLOCK):
            hi = min(lo + ORACLE_BLOCK, len(raw))
            blk = (torch.from_numpy(raw[lo:hi]).to(dev).to(torch.float32)
                   * torch.from_numpy(scale[lo:hi]).to(dev)[:, None])
            d = (qsq[:, None] + torch.from_numpy(msq[lo:hi]).to(dev)[None, :]
                 - 2.0 * (q @ blk.T))
            d = torch.where(torch.from_numpy(valid[lo:hi]).to(dev)[None, :],
                            d, float("inf"))
            rows = torch.arange(lo, hi, device=dev) + s * layout.phys_cap
            alld = torch.cat([best_d, d], dim=1)
            allr = torch.cat([best_r, rows.expand(len(queries), -1)], dim=1)
            best_d, sel = torch.topk(alld, k, dim=1, largest=False)
            best_r = torch.gather(allr, 1, sel)
    keys = []
    for row_ids in best_r.cpu().numpy():
        keys.append({eng.docstore.key_at(*layout.shard_slot_of(int(r)))
                     for r in row_ids})
    return keys


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def recall_of(got: np.ndarray, truth: np.ndarray, k: int) -> float:
    """Mean |got_i & truth_i| / k over the rows of truth."""
    return float(np.mean([len(set(got[i]) & set(truth[i])) / k
                          for i in range(len(truth))]))


def run(rows: int = N, dim: int = DIM, k: int = K, device=None,
        log=log) -> dict:
    """Builds the corpus, puts it on `device` (None = cuda) and times the
    four paths; returns {path: {"qps", "recall", "ms", "GiBps"}}."""
    from tpuvdb_torch.bench.harness import chained_timer
    from tpuvdb_torch.device import resolve_device
    from tpuvdb_torch.kernels.quant import (l2sq_topk_int8,
                                            l2sq_topk_int8_rescored,
                                            quantize_rows_np)

    dev = resolve_device(device)
    ci8 = np.empty((rows, dim), np.int8)
    scales = np.empty(rows, np.float32)
    sqn = np.empty(rows, np.float32)
    queries, chunks = clustered_unit_draws(rows, dim, SPREAD)
    q512 = np.concatenate([queries] * 8)[:512].astype(np.float32)
    oracle = StreamedOracle(queries, k)
    t0 = time.time()
    for lo, x in chunks:
        hi = lo + len(x)
        ci8[lo:hi], scales[lo:hi] = quantize_rows_np(x)
        sqn[lo:hi] = np.einsum("nd,nd->n", x, x)
        oracle.add(lo, x, sqn[lo:hi])
        if lo % 2_000_000 == 0:
            log(f"gen+oracle {lo / 1e6:.0f}M / {rows / 1e6:.0f}M "
                f"({time.time() - t0:.0f}s)")
    log(f"corpus built in {time.time() - t0:.1f}s; host int8 "
        f"{ci8.nbytes / 2**30:.2f} GiB")

    arrays = (torch.from_numpy(ci8).to(dev), torch.from_numpy(scales).to(dev),
              torch.from_numpy(sqn).to(dev),
              torch.ones(rows, dtype=torch.bool, device=dev))
    del ci8
    qdev = torch.from_numpy(q512).to(dev)
    log(f"device arrays resident on {dev}")

    def int8_fn(q, c, r, s, v):
        return l2sq_topk_int8(q, c, r, s, v, k=k)

    def resc_fn(q, c, r, s, v):
        return l2sq_topk_int8_rescored(q, c, r, s, v, k=k, fetch=FETCH)

    results = {}
    for name, fn, batch in (("int8_b128", int8_fn, 128),
                            ("int8_b256", int8_fn, 256),
                            ("int8_resc_b128", resc_fn, 128),
                            ("int8_resc_b256", resc_fn, 256)):
        bq = qdev[:batch]
        t1 = time.perf_counter()
        _, idx = fn(bq, *arrays)
        got = idx[:N_CHECK].cpu().numpy()
        log(f"{name}: first call {time.perf_counter() - t1:.3f}s")
        recall = recall_of(got, oracle.best_i, k)
        best = chained_timer(fn, (bq, *arrays), iters=5, reps=3)
        qps = batch / best
        gbs = (rows * dim + rows * 12) / best / 2**30
        results[name] = {"qps": round(qps), "recall": round(recall, 4),
                         "ms": round(best * 1000, 2), "GiBps": round(gbs, 1)}
        log(f"{name}: {best * 1000:.4f} ms -> {qps:,.1f} QPS, recall "
            f"{recall:.4f}, {gbs:.1f} GiB/s effective")
    return results


def main(argv=None, device: Optional[str] = None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=N)
    ap.add_argument("--dim", type=int, default=DIM)
    ap.add_argument("--k", type=int, default=K)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = run(args.rows, args.dim, args.k, device=device or args.device)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
