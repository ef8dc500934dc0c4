"""Two processes join one torch.distributed group (gloo) and search one
mesh: the port of tests/test_multihost.py.

Each worker brings two CPU slots, so the mesh created after
`initialize_multihost` has four, in rank order; a worker holds and scans
only its own two. Each worker checks the topology, an all_reduce sum, and
a `sharded_search` over the global mesh equal to the same search on a
4-slot mesh inside one process (rows equal, distances equal) and, in
"exact" mode, to the numpy oracle. The workers never import jax.
"""

import os
import socket
import subprocess
import sys
import textwrap

WORKER = textwrap.dedent("""
    import sys
    sys.modules["jax"] = None  # an import of jax now raises

    import numpy as np
    import torch
    import torch.distributed as dist

    from tpuvdb_torch.cluster.bootstrap import (initialize_multihost,
                                                shutdown_multihost)
    from tpuvdb_torch.kernels.distance import numpy_oracle
    from tpuvdb_torch.mesh import Mesh, create_mesh, sharded_search
    from tpuvdb_torch.mesh.sharded import shard_rows

    coord, pid = sys.argv[1], int(sys.argv[2])
    info = initialize_multihost(coordinator_address=coord, num_processes=2,
                                process_id=pid)
    assert info == {"process_index": pid, "process_count": 2,
                    "local_devices": 1, "global_devices": 2}, info
    assert dist.get_backend() == "gloo"
    t = torch.tensor([float(pid + 1)])
    dist.all_reduce(t)
    assert t.item() == 3.0, t

    mesh = create_mesh(devices=["cpu", "cpu"])
    assert mesh.size == 4 and mesh.distributed
    assert mesh.local_slots() == [2 * pid, 2 * pid + 1]
    rng = np.random.default_rng(0)   # the same data in both workers
    corpus = rng.standard_normal((4 * 256, 16)).astype(np.float32)
    sq = np.einsum("nd,nd->n", corpus, corpus).astype(np.float32)
    valid = np.ones(len(corpus), bool)
    valid[[3, 600]] = False
    q = rng.standard_normal((5, 16)).astype(np.float32)
    parts = [shard_rows(mesh, a) for a in (corpus, sq, valid)]
    assert [p is not None for p in parts[0]] == [
        s // 2 == pid for s in range(4)]
    one = np.empty(4, object)
    one[:] = [torch.device("cpu")] * 4
    local = Mesh(one, ("shards",))
    for mode in ("exact", "approx"):
        d, r = sharded_search(q, *parts, k=10, block_size=128, mesh=mesh,
                              mode=mode)
        d1, r1 = sharded_search(q, *(shard_rows(local, a)
                                     for a in (corpus, sq, valid)),
                                k=10, block_size=128, mesh=local, mode=mode)
        assert torch.equal(r, r1), (r, r1)
        assert torch.equal(d, d1), (d, d1)
    od, oi = numpy_oracle(q, corpus, valid, 10)
    d, r = sharded_search(q, *parts, k=10, block_size=128, mesh=mesh,
                          mode="exact")
    assert (r.numpy() == oi).all(), (r, oi)
    np.testing.assert_allclose(d.numpy(), od, rtol=1e-5, atol=1e-4)
    shutdown_multihost()
    assert not dist.is_initialized()
    assert sys.modules["jax"] is None
    print(f"proc {pid}: mesh ok", flush=True)
""")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_gloo_mesh(tmp_path):
    coord = f"127.0.0.1:{_free_port()}"
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, str(script), coord, str(pid)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for pid in range(2)]
    try:
        outs = [p.communicate(timeout=180)[0] for p in procs]
        for pid, (p, out) in enumerate(zip(procs, outs)):
            assert p.returncode == 0, f"proc {pid} failed:\n{out}"
            assert f"proc {pid}: mesh ok" in out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()


def test_single_process_needs_no_group(monkeypatch):
    """Without a coordinator or a process count nothing joins."""
    from tpuvdb_torch.cluster.bootstrap import (initialize_multihost,
                                                shutdown_multihost)

    for name in ("TPUVDB_COORDINATOR", "TPUVDB_NUM_PROCESSES",
                 "TPUVDB_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    info = initialize_multihost()
    assert info == {"process_index": 0, "process_count": 1,
                    "local_devices": 1, "global_devices": 1}
    shutdown_multihost()  # nothing to leave
