"""Configuration: the port's copy of tpuvdb.core.config.

Every field, default, validation rule and the TPUVDB_ env prefix are kept,
and `to_json`/`from_json` write the same JSON, so checkpoints written by
either package restore in the other. The one change: `jnp_dtype` is
replaced by `torch_dtype`.

Env-var overrides use the prefix TPUVDB_, e.g. TPUVDB_VECTOR_DIM=128.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Tuple


def _env(name: str, default, cast):
    v = os.environ.get(f"TPUVDB_{name}")
    if v is None:
        return default
    if cast is bool:
        return v.lower() in ("1", "true", "yes", "on")
    return cast(v)


@dataclasses.dataclass
class DBConfig:
    # -- storage semantics (reference parity) --
    vector_dim: int = 512
    shard_count: int = 4
    replica_count: int = 2
    # federated writes: total acks required before a put/delete returns
    write_acks: int = 1
    rebalance_debounce_s: float = 3.0
    default_top_k: int = 5

    # -- durability --
    # False = bulk-load mode: mutations skip the WAL (durability comes from
    # explicit checkpoints)
    wal_enabled: bool = True
    wal_max_bytes: int = 10 * 1024 * 1024
    wal_retention_days: int = 7
    wal_fsync: bool = True
    checkpoint_every_puts: int = 2000
    compact_every_puts: int = 200_000
    max_checkpoints: int = 3

    # -- device index layout --
    shard_capacity: int = 1 << 20  # slots per shard
    mirror_init_cap: int = 16384   # initial physical rows/shard (growth
                                   # doubles it and rebuilds the device index)
    block_size: int = 8192         # corpus rows per block of the exact scan
    query_block: int = 128
    storage_dtype: str = "float32" # "float32" | "bfloat16" | "int8"
    # int8 storage: overfetch rescore_overfetch*k candidates and re-rank
    # them (0 = serve the int8 scores as they are)
    rescore_overfetch: int = 16
    # "exact": re-rank on the host from the mirrors' rows. "device": re-rank
    # 2*rescore_overfetch dequantized candidates inside the flat index's
    # scan (only corpus quantization error remains; IVF falls back to
    # "exact"). "none": no re-rank
    rescore_mode: str = "exact"    # "exact" | "device" | "none"
    flush_batch: int = 1024        # staged writes served by the host delta
                                   # scan before a search forces a flush
    # group-commit coalescing of concurrent search_batch calls
    # (engine/coalesce.py): batches arriving while a search is in flight
    # stack into the next one. Off by default, as in the reference
    search_coalesce: bool = False
    search_coalesce_max: int = 4096  # max stacked queries per group
    # concurrent stacked searches per group key: overlap against stacking
    search_coalesce_inflight: int = 4
    # "approx" and "pallas" both run the hand-written bucketed scan kernel
    # (kernels/scan.py) for k up to what its buckets serve at recall_target,
    # and the exact path above it; "exact" is an exact torch.topk merge.
    # Both apply to the flat index; IVF probes its cells the same way always
    search_mode: str = "approx"
    recall_target: float = 0.95

    # -- index selection --
    index_type: str = "flat"       # "flat" | "ivf"
    # "python" dict | "native" C++ KV (tpuvdb_torch/native; raises with the
    # compiler's output when it does not build) | "auto" = native when the
    # library builds, python otherwise (the reference's meaning)
    docstore_backend: str = "auto"

    # -- host mirror storage --
    mirror_dtype: str = "float32"  # "float32" | "int8" (quantized mirror)
    # "ram" = numpy arrays; "mmap" = native mmap'd vector files under
    # data_dir/mirrors, so host RSS is the touched pages and checkpoints
    # hardlink instead of copying; "auto" = mmap when data_dir is set
    mirror_backend: str = "ram"

    # -- IVF --
    ivf_nlist: int = 1024
    ivf_nprobe: int = 32
    ivf_kmeans_iters: int = 12
    ivf_train_sample: int = 262_144
    ivf_delta_max: int = 16384
    # IVF-PQ: > 0 stores ivf_pq_subq code bytes per row in the cells
    # (residual product quantization) instead of the rows themselves; must
    # divide vector_dim and excludes storage_dtype="int8"
    ivf_pq_subq: int = 0
    # learn an orthogonal rotation of the residuals with the codebooks (OPQ)
    ivf_opq: bool = False
    # 8: one 256-entry code per byte. 4: two 16-entry codes per byte over
    # 2 * ivf_pq_subq half-width subspaces (the same bytes, a coarser code)
    ivf_pq_bits: int = 8
    # PQ re-ranks a deeper window than int8: max(rescore_overfetch, this)
    # times k candidates (0 = rescore_overfetch alone)
    ivf_pq_rescore_overfetch: int = 64
    # error-bounded re-rank: rescore only the candidates whose calibrated
    # lower bound can still reach the top-k (engine._rescore_adaptive)
    ivf_pq_adaptive_rescore: bool = True
    # checkpoint the packed device index of an IVF-PQ engine
    # (ivf_packed.npz), so a restart uploads it instead of encoding anew
    ivf_checkpoint_packed: bool = True

    # -- mesh --
    mesh_shape: Optional[Tuple[int, ...]] = None
    mesh_axis: str = "shards"

    # -- serving --
    http_host: str = "127.0.0.1"
    http_port: int = 8000
    rpc_port: int = 8081
    rpc_timeout_s: float = 20.0
    health_check_interval_s: float = 5.0

    # -- paths --
    # None = in-memory (no WAL/checkpoints); the engine honors this when no
    # explicit data_dir ctor arg is given
    data_dir: Optional[str] = None

    def __post_init__(self):
        # env overrides
        for f in dataclasses.fields(self):
            if f.name in ("mesh_shape",):
                continue
            cur = getattr(self, f.name)
            cast = type(f.default) if f.default is not None else str
            if isinstance(cur, bool):
                cast = bool
            setattr(self, f.name, _env(f.name.upper(), cur, cast))
        if self.block_size % 128 != 0:
            raise ValueError("block_size must be a multiple of 128")
        _valid = {
            "rescore_mode": ("exact", "device", "none"),
            "search_mode": ("approx", "exact", "pallas"),
            "index_type": ("flat", "ivf"),
            "storage_dtype": ("float32", "bfloat16", "int8"),
            "docstore_backend": ("python", "native", "auto"),
            "mirror_dtype": ("float32", "int8"),
            "mirror_backend": ("ram", "mmap", "auto"),
        }
        for field_name, allowed in _valid.items():
            v = getattr(self, field_name)
            if v not in allowed:
                raise ValueError(
                    f"{field_name}={v!r} invalid; must be one of {allowed}")
        if self.ivf_pq_rescore_overfetch < 0:
            raise ValueError("ivf_pq_rescore_overfetch must be >= 0 "
                             "(0 = fall back to rescore_overfetch)")
        if self.ivf_pq_subq < 0 or (
                self.ivf_pq_subq and self.vector_dim % self.ivf_pq_subq):
            raise ValueError(
                f"ivf_pq_subq={self.ivf_pq_subq} must be >= 0 and divide "
                f"vector_dim={self.vector_dim}")
        if self.ivf_pq_subq and self.storage_dtype == "int8":
            raise ValueError(
                "ivf_pq_subq and storage_dtype='int8' are exclusive")
        if self.ivf_opq and not self.ivf_pq_subq:
            raise ValueError("ivf_opq=True requires ivf_pq_subq > 0")
        if self.ivf_pq_bits not in (8, 4):
            raise ValueError(
                f"ivf_pq_bits={self.ivf_pq_bits} must be 8 or 4")
        if (self.ivf_pq_subq and self.ivf_pq_bits == 4
                and self.vector_dim % (2 * self.ivf_pq_subq)):
            raise ValueError(
                f"ivf_pq_bits=4 needs 2*ivf_pq_subq={2 * self.ivf_pq_subq} "
                f"subspaces to divide vector_dim={self.vector_dim}")

    # -- serialization (stored inside checkpoints so restores validate shape) --
    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["mesh_shape"] = list(self.mesh_shape) if self.mesh_shape else None
        return json.dumps(d, indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "DBConfig":
        d = json.loads(s)
        if d.get("mesh_shape"):
            d["mesh_shape"] = tuple(d["mesh_shape"])
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    def torch_dtype(self):
        import torch

        return {
            "float32": torch.float32,
            "bfloat16": torch.bfloat16,
            "int8": torch.int8,
        }[self.storage_dtype]
