"""The benchmark measures the port alone: no module of JAX, its libraries
or the JAX package may be loaded in a run's process. Names are compared by
their top-level part as a whole word, so `tpuvdb_torch` (the program) is
not `tpuvdb` (the JAX package)."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "tpuvdb"})


def forbidden_loaded(names: Iterable[str] = None) -> List[str]:
    """The loaded modules whose top-level name is forbidden."""
    names = list(sys.modules) if names is None else names
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
