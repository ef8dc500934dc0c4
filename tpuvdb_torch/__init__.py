"""tpuvdb_torch — the tpuvdb vector database in PyTorch on an NVIDIA H100.

A second package beside `tpuvdb` (JAX on a TPU), with the same module
layout and public names so each part finds its counterpart:

  core/      config, wire types, errors       (copies of tpuvdb.core)
  utils/     logging, MD5 routing, tracing    (copies; tracing on torch.profiler)
  store/     WAL, doc store, checkpoints      (host-only copies; on-disk formats
                                               byte-compatible)
  native/    the native host runtime: C++ doc store, group-commit WAL writer,
             mmap vector file, fused exact rescore (g++ at first use)
  index/     host mirrors, device exact index and IVF index (CUDA tensors)
  kernels/   distance/top-k and k-means torch ops, and the hand-written CUDA
             kernels: csrc/scan.cu (tpuvdb.kernels.pallas_scan) and
             csrc/ivf_probe.cu (the f32/bf16 probes of pallas_ivf)
  mesh/      slots of devices (a device may repeat): sharded and replicated
             flat search, the sharded IVF index, a dry run of them all
  engine/    put/get/delete/search, flat and IVF indexes (on a mesh too),
             search coalescing
  api/       service, HTTP server and client, CLI (`python -m
             tpuvdb_torch.api.cli`), on the reference's wire (core/wire.py)
  cluster/   membership, the federated coordinator, and the multi-process
             bootstrap (torch.distributed: NCCL on cards, gloo on the CPU)
  embed/     CLIP: the ViT-B/32 text and image towers (torch modules), the
             BPE tokenizer, the remote ingest/search client
  bench/     the timing harness, recall and corpora helpers, and the
             benchmarks: scan, serving, streaming, text -> image, latency
             and capacity (`python -m tpuvdb_torch.bench.<name>`)
  examples/  quickstart and sharded_serving (`python -m
             tpuvdb_torch.examples.<name>`)
  scripts/   the ops scripts: start_server.sh, stop_server.sh,
             register_node.sh, start_cluster.sh (a coordinator and data
             nodes as processes on the card; `demo` proves failover)

It imports `torch`, never `jax`, and nothing of `tpuvdb`. Every entry point
takes `device=None`, which means "cuda", and raises when CUDA is missing;
pass `device="cpu"` to run the plain PyTorch versions on the CPU.
"""

__version__ = "0.1.0"


def __getattr__(name):
    # lazy top-level conveniences, as in tpuvdb/__init__.py
    if name == "VectorDBEngine":
        from tpuvdb_torch.engine.engine import VectorDBEngine

        return VectorDBEngine
    if name == "DBConfig":
        from tpuvdb_torch.core.config import DBConfig

        return DBConfig
    if name in ("VectorData", "SearchRequest", "SearchResult", "Response"):
        from tpuvdb_torch.core import types

        return getattr(types, name)
    raise AttributeError(f"module 'tpuvdb_torch' has no attribute {name!r}")
