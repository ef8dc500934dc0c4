"""The corpus and the queries, made on the device.

A torch copy of the project's clustered generator (`synthetic_corpus(...,
clustered=True)` in tpuvdb_torch/bench/datasets.py): `clusters` centres
drawn from N(0, centre_scale^2), each row a centre picked uniformly plus
N(0, spread^2) noise, then scaled to unit length as CLIP embeddings are.
Rows are drawn in blocks on the device with a `torch.Generator` and copied
to the host, where the program's bulk load takes them; only a block at a
time lives on the card.

The corpus is the deployment's data set: drawn from the configuration's
`data_seed`, the same in every run, as a fixed data set is loaded. The
run's seed draws the traffic: the queries' noise and order. Each centre
is the centre of the same number of queries (pool / clusters, the rest
spread over the first centres), so every seed asks the same mix in other
noise and another order. Drawn from the run's seed, the corpus made an
IVF index whose cells and probe work moved with the seed: three seeds of
the b256 IVF cell read 52,800, 62,000 and 66,700 queries/s on one card,
and 2.0x apart in the probe's bytes a call (PERF.md).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

BLOCK_ROWS = 1 << 16


def seed_streams(seed: int, n: int = 3) -> Tuple[int, ...]:
    """`n` independent 64-bit seeds derived from the run's seed (any whole
    number): queries, call order, answer sample."""
    ss = np.random.SeedSequence(int(seed) & (2 ** 64 - 1))
    return tuple(int(s) for s in ss.generate_state(n, dtype=np.uint64))


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(seed)
    return g


def _unit_draws(g: torch.Generator, centres: torch.Tensor,
                pick: torch.Tensor, spread: float, unit: bool
                ) -> torch.Tensor:
    """A row around each picked centre: the centre plus noise from g."""
    x = centres[pick] + spread * torch.randn(
        (pick.shape[0], centres.shape[1]), generator=g,
        device=centres.device)
    if unit:
        x = x / x.norm(dim=1, keepdim=True)
    return x


def make_corpus(spec: dict, device) -> Tuple[np.ndarray, torch.Tensor]:
    """(rows (n, dim) float32 on the host, centres (clusters, dim) on the
    device) of the configuration's `corpus` spec, from its `data_seed`."""
    n, dim = int(spec["rows"]), int(spec["dim"])
    dev = torch.device(device)
    g = generator(int(spec["data_seed"]), dev)
    centres = spec["centre_scale"] * torch.randn(
        (int(spec["clusters"]), dim), generator=g, device=dev)
    rows = np.empty((n, dim), np.float32)
    for lo in range(0, n, BLOCK_ROWS):
        m = min(BLOCK_ROWS, n - lo)
        pick = torch.randint(0, centres.shape[0], (m,), generator=g,
                             device=dev)
        rows[lo:lo + m] = _unit_draws(g, centres, pick, spec["spread"],
                                      spec["unit_norm"]).cpu().numpy()
    return rows, centres


def make_queries(centres: torch.Tensor, n: int, spread: float, unit: bool,
                 seed: int) -> np.ndarray:
    """(n, dim) float32 queries on the host: centre i % clusters for the
    i-th, in an order and with noise drawn from `seed`."""
    g = generator(seed, centres.device)
    pick = torch.arange(n, device=centres.device) % centres.shape[0]
    pick = pick[torch.randperm(n, generator=g, device=centres.device)]
    return _unit_draws(g, centres, pick, spread, unit).cpu().numpy()
