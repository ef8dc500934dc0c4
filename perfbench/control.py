"""The control of the check: the plain reference put in the program's
place, one precision below the configuration's (TF32 products for a
float32 configuration), answering the queries a run would sample. It has
to come out as not correct, or the check could not tell a program that
computes in TF32 from one that computes in f32.

  python3 -m perfbench.control --workload <cell> --seeds 11 12 13 \
      [--precision tf32|tf32_card]

prints, for each seed, the check's numbers for the control's answers and
whether the run's `correct` would read false. The sampled queries are the
first ceil(check_queries / batch) batches of the seeded call order (a
write-mixed cell's: after every write of a run's plan, with its
self-queries); the benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from perfbench import check, program
from perfbench.corpus import make_corpus, seed_streams
from perfbench.registry import Registry
from perfbench.traffic import Traffic


def control_numbers(workload: str, seed: int, precision: str = "tf32",
                    device="cuda", registry: Registry = None) -> dict:
    """{"numbers", "correct"} of the control on one seed."""
    reg = registry or Registry()
    cell = reg.workload(workload)
    config = reg.config(cell["config"])
    dev = torch.device(device)
    s_query, s_order, _ = seed_streams(seed)
    rows, centres = make_corpus(config["corpus"], dev)
    traffic = Traffic(reg.traffic(cell["traffic"]), centres,
                      bool(config["corpus"]["unit_norm"]), s_query, s_order)
    ref = reg.reference(config["reference"])
    if traffic.writers:
        return _write_control(reg, config, traffic, rows, centres, seed,
                              precision, dev, ref)
    del centres
    queries = np.concatenate([traffic.queries(traffic.batch_index(i))
                              for i in range(traffic.sample_calls())])
    ids, dists = ref.exact_topk(queries, rows, traffic.k, device=dev,
                                precision=precision)
    values = check.numbers(queries, ids, np.asarray(dists, np.float64),
                           np.zeros(len(queries), bool), rows, traffic.k,
                           ref, device=dev)
    correct, _ = check.judge(values, check.limits(config))
    return {"numbers": values, "correct": correct}


def _write_control(reg, config, traffic, rows, centres, seed, precision,
                   dev, ref) -> dict:
    """The control of a write-mixed cell: every write of a run's plan (at
    `run_seconds`) acknowledged in turn, then the sampled calls, each with
    its self-queries of the newest inserts, answered by the reference in
    the lower precision over the versions live then, and held by
    check.live_numbers as a run's answers are."""
    from perfbench import writes

    s_ops, s_vecs = seed_streams(seed, 5)[3:]
    plan = writes.WritePlan(traffic.params, rows.shape[0], centres,
                            float(config["corpus"]["spread"]),
                            bool(config["corpus"]["unit_norm"]),
                            float(reg.bench["run_seconds"]), s_ops, s_vecs)
    log = writes.WriteLog(plan.n)
    for i in range(plan.n):
        log.record(plan, i, float(i), float(i), i + 0.5, True)
    vers = writes.versions(plan, log, rows.shape[0])
    calls = []
    for i in range(traffic.sample_calls()):
        q = traffic.queries(traffic.batch_index(i)).copy()
        n_self = writes.self_slots(traffic, i)
        if n_self:
            fresh = log.fresh_acked[-n_self:]
            q[-n_self:] = plan.vectors[plan.vec_of[fresh]]
        calls.append(q)
    queries = np.concatenate(calls)
    at = np.full(len(queries), float(plan.n + 1))
    parts = [rows, plan.vectors]
    ids, dists = ref.exact_topk_live(queries, parts, vers.born_ack,
                                     vers.died_ack, at, traffic.k,
                                     device=dev, precision=precision)
    key_of = [None] * (rows.shape[0] + plan.vectors.shape[0])
    for key, vids in vers.of_key.items():
        for v in vids:
            key_of[v] = key
    keys = [[key_of[v] if key_of[v] is not None else program.key_of(v)
             for v in row] for row in ids.tolist()]
    values = check.live_numbers(queries, at, at + 1.0,
                                list(np.asarray(dists, np.float64)), keys,
                                traffic.k, vers, parts, ref, device=dev)
    lim = check.limits(config)
    lim["stale_answers"] = 0.0
    correct, _ = check.judge(values, lim)
    return {"numbers": values, "correct": correct}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--precision", default="tf32",
                    choices=("tf32", "tf32_card"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for seed in args.seeds:
        out = control_numbers(args.workload, seed, args.precision,
                              args.device)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "precision": args.precision, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
