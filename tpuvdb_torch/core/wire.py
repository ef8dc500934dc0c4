"""Compact binary wire encoding: the port's copy of tpuvdb.core.wire.

The format is the reference's, byte for byte, so a JAX client and a port
server (or the other way round) read each other's frames: msgpack with one
ExtType,

  code 1 — numpy ndarray: packb([dtype.str, shape list, raw bytes])

negotiated by Content-Type / Accept: application/x-tpuvdb-bin (JSON
clients are untouched). encode() converts the well-known float-list fields
("vector", "query_vector", "vectors") to float32 ndarrays; decode() leaves
ndarrays in place.

decode() hands back arrays over the frame's bytes (`np.frombuffer`), which
are read-only: code that gives a decoded vector to `torch.from_numpy`
copies it first (the engine's `search_batch` does).

Only the server and client import this module, and only where a binary
frame is read or written, so a JSON-only server runs without msgpack.
"""

from __future__ import annotations

from typing import Any

import msgpack
import numpy as np

BINARY_CTYPE = "application/x-tpuvdb-bin"

_EXT_NDARRAY = 1

# fields whose float-list payloads dominate bulk-path bytes
_F32_FIELDS = frozenset({"vector", "query_vector"})
_F32_LIST_FIELDS = frozenset({"vectors"})


def _default(obj):
    if isinstance(obj, np.ndarray):
        a = np.ascontiguousarray(obj)
        return msgpack.ExtType(
            _EXT_NDARRAY,
            msgpack.packb([a.dtype.str, list(a.shape), a.tobytes()],
                          use_bin_type=True),
        )
    if isinstance(obj, (np.floating, np.integer)):
        return obj.item()
    raise TypeError(f"unserializable type {type(obj)!r}")


def _ext_hook(code, data):
    if code == _EXT_NDARRAY:
        dtype, shape, raw = msgpack.unpackb(data, raw=False)
        return np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape)
    return msgpack.ExtType(code, data)


def _compactify(obj: Any) -> Any:
    """Convert well-known float-list fields to f32 ndarrays (recursive,
    copy-on-write: dicts/lists containing conversions are rebuilt, the
    rest is shared)."""
    if isinstance(obj, dict):
        out = None
        for k, v in obj.items():
            if k in _F32_FIELDS and isinstance(v, (list, tuple)) and v:
                nv = np.asarray(v, np.float32)
            elif (k in _F32_LIST_FIELDS and isinstance(v, (list, tuple))
                  and v and isinstance(v[0], (list, tuple, np.ndarray))):
                # ragged entries (e.g. empty vectors) stay per-row
                try:
                    nv = np.asarray(v, np.float32)
                except ValueError:
                    nv = [np.asarray(x, np.float32) for x in v]
            else:
                nv = _compactify(v)
            if nv is not v:
                if out is None:
                    out = dict(obj)
                out[k] = nv
        return out if out is not None else obj
    if isinstance(obj, list):
        out = None
        for i, v in enumerate(obj):
            nv = _compactify(v)
            if nv is not v:
                if out is None:
                    out = list(obj)
                out[i] = nv
        return out if out is not None else obj
    return obj


def encode(obj: Any) -> bytes:
    return msgpack.packb(_compactify(obj), use_bin_type=True,
                         default=_default)


def decode(data: bytes) -> Any:
    return msgpack.unpackb(data, raw=False, ext_hook=_ext_hook,
                           strict_map_key=False)
