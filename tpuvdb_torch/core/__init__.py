from tpuvdb_torch.core.types import (
    VectorData,
    SearchRequest,
    SearchResult,
    Response,
    SearchHit,
)
from tpuvdb_torch.core.config import DBConfig
from tpuvdb_torch.core import errors

__all__ = [
    "VectorData",
    "SearchRequest",
    "SearchResult",
    "Response",
    "SearchHit",
    "DBConfig",
    "errors",
]
