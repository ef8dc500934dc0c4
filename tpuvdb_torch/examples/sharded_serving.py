"""Serving over a device mesh: shard, replicate and batch-search
(examples/sharded_serving.py on the port's API).

    python -m tpuvdb_torch.examples.sharded_serving

The mesh's slots are `devices` (a device may repeat), by default every
visible card: with 4 or more, and an even count, 2 replica groups x
count / 2 shards; with 2 or 3, one shard a slot; with one, no mesh.
`main(devices=["cpu"] * 4)` runs the 2 x 2 branch on the CPU.
"""

import numpy as np


def main(devices=None):
    from tpuvdb_torch import DBConfig, SearchRequest, VectorData, VectorDBEngine
    from tpuvdb_torch.mesh.mesh import mesh_devices

    devices = mesh_devices(devices)
    ndev = len(devices)
    print(f"{ndev} devices")

    if ndev >= 4 and ndev % 2 == 0:
        # 2 replica groups x ndev/2 shards: each group holds a full corpus
        # copy (fault domain) and serves half of every query batch
        from tpuvdb_torch.mesh.replicated import create_mesh_2d

        mesh = create_mesh_2d(2, ndev // 2, devices=devices)
        print(f"mesh: 2 replicas x {ndev // 2} shards")
    elif ndev > 1:
        from tpuvdb_torch.mesh.mesh import create_mesh

        mesh = create_mesh(devices=devices)
        print(f"mesh: {ndev} shards")
    else:
        mesh = None

    cfg = DBConfig(vector_dim=128, shard_count=4, storage_dtype="bfloat16")
    eng = VectorDBEngine(cfg, mesh=mesh, device=devices[0])

    rng = np.random.default_rng(0)
    vecs = rng.standard_normal((50_000, 128)).astype(np.float32)
    eng.put_batch([VectorData(key=f"v{i}", vector=vecs[i])
                   for i in range(len(vecs))])

    # batched search: one search over the whole mesh
    queries = vecs[:64] + 0.01 * rng.standard_normal((64, 128)).astype(np.float32)
    dists, keys = eng.search_batch(queries, k=3)
    hit = sum(keys[i][0] == f"v{i}" for i in range(64))
    print(f"self-retrieval: {hit}/64, example: {keys[0][:3]}")

    r = eng.search(SearchRequest(query_vector=vecs[7], top_k=3))
    print("single query:", r.search_result.keys)


if __name__ == "__main__":
    main()
