"""The launchers on a mesh, on the card: each wrapper's launch switches to
its tensors' card and gives the caller its current device back
(csrc/device_guard.cuh). Needs no JAX, so it runs with --noconftest:

    python -m pytest --noconftest -q -m cuda tests/test_torch_mesh_device.py

On one card the mesh is four slots of it, so a switch cannot show; with
more cards the caller's device is the last one and the slots start at 0.
"""

import numpy as np
import pytest
import torch

from tpuvdb_torch.mesh import create_mesh, sharded_search
from tpuvdb_torch.mesh.sharded import shard_rows


def _corpus(rng, rows, d):
    corpus = rng.standard_normal((rows, d)).astype(np.float32)
    valid = np.ones(rows, bool)
    sq = np.einsum("nd,nd->n", corpus, corpus).astype(np.float32)
    return corpus, sq, valid


@pytest.mark.cuda
def test_launches_leave_the_callers_device():
    """Each launcher switches to its tensors' card and back: after scans,
    IVF probes and PQ probes on every slot of a mesh over the visible cards
    (one card: four slots of it), the caller's current device is the one
    it set."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from tpuvdb_torch.kernels import ivf_probe, pq_probe, scan
    from tpuvdb_torch.mesh.sharded_ivf import ShardedIVFIndex

    n = torch.cuda.device_count()
    devs = [f"cuda:{i % n}" for i in range(max(4, n))]
    mesh = create_mesh(devices=devs)
    rng = np.random.default_rng(0)
    corpus, sq, valid = _corpus(rng, mesh.size * 1024, 64)
    caller = n - 1
    torch.cuda.set_device(caller)
    launches = (scan.LAUNCHES, ivf_probe.LAUNCHES_EXPANDED,
                pq_probe.LAUNCHES_PQ)
    sharded_search(corpus[:8], *(shard_rows(mesh, a)
                                 for a in (corpus, sq, valid)),
                   k=10, block_size=1024, mesh=mesh, mode="approx")
    assert torch.cuda.current_device() == caller
    for pq_subq in (0, 8):
        sivf = ShardedIVFIndex.build(corpus, valid, mesh, nlist=8, nprobe=4,
                                     kmeans_iters=2, pq_subq=pq_subq)
        sivf.search(corpus[:8], k=10)
        assert torch.cuda.current_device() == caller
    torch.cuda.synchronize()
    after = (scan.LAUNCHES, ivf_probe.LAUNCHES_EXPANDED, pq_probe.LAUNCHES_PQ)
    assert all(a >= b + mesh.size for a, b in zip(after, launches))
