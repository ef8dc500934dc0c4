"""The fixed cost of a b1 IVF probe, stage by stage: the port of
scripts/diag_ivf_b1.py.

    TPUVDB_BENCH_CACHE=DIR python -m tpuvdb_torch.bench.diag_ivf_b1
        [--rows 10000000] [--dim 96] [--nlist 4096] [--k 10] [--nprobe 16]
        [--device cuda]

Reads capacity_ivf's cached corpus and exact oracle
(DIR/capivf_{rows}_{dim}_0.12_{k}.npz, written by `python -m
tpuvdb_torch.bench.capacity_ivf` with $TPUVDB_BENCH_CACHE set) and the
index this script cached there before (DIR/diagivf_{rows}_{dim}_{nlist}.npz,
IVFIndex.packed_capture, readable by either package), or builds it as the
reference does (int8 cells, seed 0) and caches it. The 64 held-out queries
are the bench's, draw for draw. Each stage is timed alone by
`harness.chained_timer` (CUDA events on the card):

  coarse_exact_b{1,128}_us  the coarse scores 2 q.c - |c|^2 and their
                            top-nprobe
  base.split_b1_us          at b1: the coarse pick; the probe plan (the
                            coarse pick, the per-tile lists: sort, expand,
                            segment ranks); the probe kernel on that plan
                            (csrc/ivf_probe.cu, the int8 cells' expanded
                            form; the compact form above EXPANDED_MAX);
                            the final top-k of the candidates; and the
                            whole probe, whose rest is the spill scan and
                            the glue between the stages
  base.b{1,8,128}_ms        the whole probe (`IVFIndex.probe`)
  base.recall_at_10         of the 64 queries in one probe (tiles of 8),
                            against the cached oracle

The reference's other variants have no lever in the port and print as
"n/a" with the reason: `coarse_approx` (jax.lax.approx_max_k, a TPU partial
reduction; the port's coarse top-k is torch.topk) and `cps_override`
(chunks per TPU grid step; the port's probe has no grid steps: its blocks
take chunks from a group table). Stdout takes one JSON line with the
reference's keys.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

from tpuvdb_torch.bench.capacity import N_CHECK, clustered_unit_draws

SPREAD = 0.12  # capacity_ivf's default --cluster-std, in the cache's name
NA_APPROX = ("n/a: approx_max_k is a TPU partial reduction; the port's "
             "coarse top-k is torch.topk, exact")
NA_CPS = ("n/a: cps_override sets chunks per TPU grid step; the port's "
          "probe has no grid steps (blocks take chunks from a group table)")
VARIANTS_NA = {"cps16": NA_CPS, "cps32": NA_CPS, "approx": NA_APPROX,
               "approx_cps32": NA_APPROX + "; " + NA_CPS}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def coarse_exact(q: torch.Tensor, centroids: torch.Tensor, nprobe: int):
    """The coarse pick alone: top-nprobe of 2 q.c - |c|^2."""
    c_sq = (centroids * centroids).sum(dim=-1)
    s = 2.0 * (q @ centroids.T) - c_sq[None, :]
    return torch.topk(s, nprobe, dim=1)


def batch_of(queries: np.ndarray, b: int) -> np.ndarray:
    """The first b queries, the 64 repeated where b is larger."""
    return (np.concatenate([queries] * 2)[:b] if b > len(queries)
            else queries[:b])


def physical_rows(index, gid: np.ndarray) -> np.ndarray:
    """Grouped / spill ids to physical rows, as IVFIndex.search maps them."""
    rows = np.full(gid.shape, -1, np.int64)
    n_g = index.grouped.shape[0]
    cell, spill = (gid >= 0) & (gid < n_g), gid >= n_g
    rows[cell] = index.row_ids[gid[cell]]
    rows[spill] = index.spill_row_ids[gid[spill] - n_g]
    return rows


def index_file_name(rows: int, dim: int, nlist: int) -> str:
    """The cached index's file name, the reference's."""
    return f"diagivf_{rows}_{dim}_{nlist}.npz"


def load_index(cache: str, args, dev):
    from tpuvdb_torch.index.ivf import IVFIndex

    n, dim, k = args.rows, args.dim, args.k
    corpus_file = os.path.join(cache, f"capivf_{n}_{dim}_{SPREAD}_{k}.npz")
    if not os.path.exists(corpus_file):
        log(f"missing cached corpus {corpus_file}: run "
            f"`python -m tpuvdb_torch.bench.capacity_ivf --rows {n} --dim "
            f"{dim}` with TPUVDB_BENCH_CACHE={cache} first")
        sys.exit(1)
    z = np.load(corpus_file)
    best_i = z["best_i"]
    idx_file = os.path.join(cache, index_file_name(n, dim, args.nlist))
    if os.path.exists(idx_file):
        index = IVFIndex.from_packed(np.load(idx_file), device=dev)
        log(f"packed index loaded from {idx_file}")
    else:
        t0 = time.time()
        index = IVFIndex.build(z["vectors"], np.ones(n, bool),
                               nlist=args.nlist, nprobe=args.nprobe,
                               dtype=torch.int8, seed=0, device=dev)
        log(f"IVF build {time.time() - t0:.1f}s: nlist={index.nlist}, "
            f"cell_pad={index.cell_pad}")
        np.savez(idx_file, **IVFIndex.packed_fetch(index.packed_capture()))
        log(f"packed index cached to {idx_file}")
    return index, best_i


def main(argv=None, device: Optional[str] = None) -> dict:
    """Prints the result line and returns it."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=10_000_000)
    ap.add_argument("--dim", type=int, default=96)
    ap.add_argument("--nlist", type=int, default=4096)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--nprobe", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    k, nprobe = args.k, args.nprobe

    from tpuvdb_torch.bench.harness import chained_timer
    from tpuvdb_torch.device import resolve_device
    from tpuvdb_torch.kernels import ivf_probe

    dev = resolve_device(device or args.device)
    cache = os.environ.get("TPUVDB_BENCH_CACHE")
    if not cache:
        log("set TPUVDB_BENCH_CACHE to the directory capacity_ivf cached "
            "its corpus in")
        sys.exit(1)
    index, best_i = load_index(cache, args, dev)
    queries, _ = clustered_unit_draws(args.rows, args.dim, SPREAD)

    def on_dev(b):
        return torch.from_numpy(np.ascontiguousarray(
            batch_of(queries, b), np.float32)).to(dev)

    def us(fn, *a, iters):
        return round(chained_timer(fn, a, iters=iters, reps=3) * 1e6, 1)

    results = {"rows": args.rows, "dim": args.dim, "nlist": int(index.nlist),
               "cell_pad": int(index.cell_pad), "nprobe": nprobe}

    # ---- stage 1: the coarse pick alone
    cents = index.centroids
    for b in (1, 128):
        results[f"coarse_exact_b{b}_us"] = us(coarse_exact, on_dev(b), cents,
                                              nprobe, iters=20)
        results[f"coarse_approx_b{b}_us"] = NA_APPROX
        log(f"b{b}: coarse exact {results[f'coarse_exact_b{b}_us']} us")

    # ---- stage 2: the whole probe, its recall, and its b1 split
    _, gid = index.probe(on_dev(N_CHECK), k, nprobe)
    rows = physical_rows(index, gid.cpu().numpy())
    oracle = [set(best_i[i]) for i in range(N_CHECK)]
    rec = float(np.mean([len(set(rows[i][rows[i] >= 0]) & oracle[i]) / k
                         for i in range(N_CHECK)]))
    base = {"recall_at_10": round(rec, 4)}
    for b in (1, 8, 128):
        base[f"b{b}_ms"] = round(
            chained_timer(index.probe, (on_dev(b), k, nprobe), iters=10,
                          reps=3) * 1e3, 3)

    q1 = on_dev(1)
    plan = ivf_probe.probe_plan(q1, cents, index.cell_offsets,
                                index.cell_pad, k, nprobe)
    neg_mask = torch.zeros(index.grouped_valid.shape, dtype=torch.float32,
                           device=dev).masked_fill_(~index.grouped_valid,
                                                    ivf_probe.NEG_INF)
    cand_val, _ = ivf_probe.plan_candidates(
        plan, index.grouped, index.grouped_sq, neg_mask,
        cell_scales=index.cell_scales)
    split = {
        "coarse": us(coarse_exact, q1, cents, nprobe, iters=20),
        "plan": us(ivf_probe.probe_plan, q1, cents, index.cell_offsets,
                   index.cell_pad, k, nprobe, iters=20),
        # a tensor leads the arguments, so chained_timer takes the card's
        # clock
        "kernel": us(lambda _q: ivf_probe.plan_candidates(
            plan, index.grouped, index.grouped_sq, neg_mask,
            cell_scales=index.cell_scales), q1, iters=20),
        "final_topk": us(lambda v: torch.sort(v, dim=1, descending=True,
                                              stable=True), cand_val,
                         iters=20),
        "probe": round(base["b1_ms"] * 1e3, 1),
    }
    split["rest"] = round(split["probe"] - split["plan"] - split["kernel"]
                          - split["final_topk"], 1)
    base["form"] = "compact" if plan.compact else "expanded"
    base["split_b1_us"] = split
    results["base"] = base
    log(f"base: recall {rec:.4f}, b1 {base['b1_ms']} ms, b8 "
        f"{base['b8_ms']} ms, b128 {base['b128_ms']} ms; b1 split (us) "
        f"{json.dumps(split)}")
    results.update(VARIANTS_NA)
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    main()
