"""Quickstart: the embedded engine, no server (examples/quickstart.py on
the port's API).

    python -m tpuvdb_torch.examples.quickstart

On the card; `main(device="cpu")` runs it on the CPU. Synthetic CLIP-like
512-d unit vectors go into ./quickstart_db (relative to the working
directory, as in the reference): durable, with the WAL and a checkpoint.
"""

import numpy as np

from tpuvdb_torch import DBConfig, SearchRequest, VectorData, VectorDBEngine


def main(device=None):
    cfg = DBConfig(vector_dim=512, shard_count=4)
    eng = VectorDBEngine(cfg, data_dir="./quickstart_db", device=device)

    rng = np.random.default_rng(0)
    vecs = rng.standard_normal((10_000, 512)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)  # CLIP-style unit

    # batched ingest: one WAL group commit per batch
    batch = [
        VectorData(key=f"img_{i:05d}.jpg", vector=vecs[i],
                   metadata={"dataset": "demo", "i": str(i)})
        for i in range(len(vecs))
    ]
    r = eng.put_batch(batch)
    print("ingest:", r.message)

    # search: scores are squared-L2, ascending (== cosine ranking here)
    q = vecs[1234] + 0.01 * rng.standard_normal(512).astype(np.float32)
    r = eng.search(SearchRequest(query_vector=q, top_k=5))
    for key, score in zip(r.search_result.keys, r.search_result.scores):
        print(f"  {key}  d²={score:.4f}")

    # metadata filter
    r = eng.search(SearchRequest(query_vector=q, top_k=3,
                                 filter_metadata={"i": "7"}))
    print("filtered:", r.search_result.keys)

    # overwrite + delete semantics
    eng.put(VectorData(key="img_00000.jpg", vector=vecs[9999]))
    eng.delete("img_00001.jpg")
    print("count:", eng.count())

    eng.close()  # final checkpoint; a restart picks up where this left off


if __name__ == "__main__":
    main()
