"""Wire types for the vector DB.

These mirror the reference's Thrift IDL structs (src/vector_db.thrift:13-49)
so a user of the reference finds the same request/response surface, but they
are plain Python dataclasses serialized as JSON/msgpack — the internal data
plane is XLA collectives, not RPC, so there is no IDL compiler step.

Score semantics (parity with the reference): scores are *squared L2
distances*, sorted ascending. The reference L2-normalizes CLIP embeddings at
embed time and indexes in hnswlib space='l2' (src/datanode/handler.py:46),
so d^2 = 2 - 2*cos for unit vectors and ascending-L2 == descending-cosine.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np


def now_ms() -> int:
    return int(time.time() * 1000)


@dataclasses.dataclass
class VectorData:
    """One vector record.

    Parity: struct VectorData (src/vector_db.thrift:13-18) — key, vector,
    string->string metadata map, millisecond timestamp.
    """

    key: str
    vector: Sequence[float]
    metadata: Dict[str, str] = dataclasses.field(default_factory=dict)
    timestamp: int = 0

    def __post_init__(self):
        if self.timestamp == 0:
            self.timestamp = now_ms()

    def vector_np(self, dim: Optional[int] = None) -> np.ndarray:
        v = np.asarray(self.vector, dtype=np.float32).reshape(-1)
        if dim is not None and v.shape[0] != dim:
            raise ValueError(
                f"vector dimension mismatch: expected {dim}, got {v.shape[0]}"
            )
        return v

    def to_dict(self) -> Dict[str, Any]:
        return {
            "key": self.key,
            "vector": [float(x) for x in np.asarray(self.vector).reshape(-1)],
            "metadata": dict(self.metadata),
            "timestamp": int(self.timestamp),
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "VectorData":
        return cls(
            key=d["key"],
            vector=d.get("vector", []),
            metadata=dict(d.get("metadata", {})),
            timestamp=int(d.get("timestamp", 0)) or now_ms(),
        )


@dataclasses.dataclass
class SearchRequest:
    """K-NN search request.

    Parity: struct SearchRequest (src/vector_db.thrift:23-28) — query vector,
    top_k default 5, optional metadata filter, optional score threshold.
    Unlike the reference (which accepts but drops `filter`/`threshold`,
    src/coordinator/handler.py:186-189), both are honored here.
    """

    query_vector: Sequence[float]
    top_k: int = 5
    filter_metadata: Dict[str, str] = dataclasses.field(default_factory=dict)
    threshold: float = 0.0  # 0.0 = disabled; else max squared-L2 distance

    def query_np(self, dim: Optional[int] = None) -> np.ndarray:
        return VectorData(key="", vector=self.query_vector).vector_np(dim)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "query_vector": [float(x) for x in np.asarray(self.query_vector).reshape(-1)],
            "top_k": int(self.top_k),
            "filter_metadata": dict(self.filter_metadata),
            "threshold": float(self.threshold),
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SearchRequest":
        return cls(
            query_vector=d["query_vector"],
            top_k=int(d.get("top_k", 5)),
            filter_metadata=dict(d.get("filter_metadata", {})),
            threshold=float(d.get("threshold", 0.0)),
        )


@dataclasses.dataclass
class SearchHit:
    key: str
    score: float  # squared L2 distance (ascending == most similar first)
    vector: Optional[List[float]] = None
    metadata: Dict[str, str] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class SearchResult:
    """Columnar search result.

    Parity: struct SearchResult (src/vector_db.thrift:33-39) — parallel lists
    of keys, scores, vectors, metadata maps, ascending by score.
    """

    keys: List[str] = dataclasses.field(default_factory=list)
    scores: List[float] = dataclasses.field(default_factory=list)
    vectors: List[List[float]] = dataclasses.field(default_factory=list)
    metadatas: List[Dict[str, str]] = dataclasses.field(default_factory=list)

    @classmethod
    def from_hits(cls, hits: Sequence[SearchHit], include_vectors: bool = True) -> "SearchResult":
        r = cls()
        for h in hits:
            r.keys.append(h.key)
            r.scores.append(float(h.score))
            r.vectors.append(list(h.vector) if (include_vectors and h.vector is not None) else [])
            r.metadatas.append(dict(h.metadata))
        return r

    def hits(self) -> List[SearchHit]:
        out = []
        for i, k in enumerate(self.keys):
            out.append(
                SearchHit(
                    key=k,
                    score=self.scores[i],
                    vector=self.vectors[i] if i < len(self.vectors) else None,
                    metadata=self.metadatas[i] if i < len(self.metadatas) else {},
                )
            )
        return out

    def to_dict(self) -> Dict[str, Any]:
        return {
            "keys": list(self.keys),
            "scores": [float(s) for s in self.scores],
            "vectors": [[float(x) for x in v] for v in self.vectors],
            "metadatas": [dict(m) for m in self.metadatas],
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SearchResult":
        return cls(
            keys=list(d.get("keys", [])),
            scores=[float(s) for s in d.get("scores", [])],
            vectors=[list(v) for v in d.get("vectors", [])],
            metadatas=[dict(m) for m in d.get("metadatas", [])],
        )

    def __len__(self) -> int:
        return len(self.keys)


@dataclasses.dataclass
class Response:
    """Uniform op response.

    Parity: struct Response (src/vector_db.thrift:44-49) — success flag,
    message, optional VectorData payload, optional SearchResult payload.
    """

    success: bool
    message: str = ""
    vector_data: Optional[VectorData] = None
    search_result: Optional[SearchResult] = None

    @classmethod
    def ok(cls, message: str = "ok", **kw) -> "Response":
        return cls(success=True, message=message, **kw)

    @classmethod
    def fail(cls, message: str, **kw) -> "Response":
        return cls(success=False, message=message, **kw)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "success": bool(self.success),
            "message": self.message,
            "vector_data": self.vector_data.to_dict() if self.vector_data else None,
            "search_result": self.search_result.to_dict() if self.search_result else None,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Response":
        return cls(
            success=bool(d.get("success")),
            message=d.get("message", ""),
            vector_data=VectorData.from_dict(d["vector_data"]) if d.get("vector_data") else None,
            search_result=SearchResult.from_dict(d["search_result"]) if d.get("search_result") else None,
        )
