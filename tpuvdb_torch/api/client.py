"""HTTP client for the coordinator surface: the port of
tpuvdb.api.client.

Plain keep-alive HTTP, one connection per thread, JSON bodies or the
binary wire (core/wire.py, `binary=True`). It speaks to a server of either
package. Used by the CLI in remote mode and by the federated coordinator.
"""

from __future__ import annotations

import http.client
import json
import threading
from typing import Any, Dict, Optional

from tpuvdb_torch.core.types import Response


def _json_default(obj):
    """ndarray vectors (e.g. from a binary export file) fall back to
    plain lists on the JSON wire."""
    tolist = getattr(obj, "tolist", None)
    if tolist is not None:
        return tolist()
    item = getattr(obj, "item", None)
    if item is not None:
        return item()
    raise TypeError(f"unserializable type {type(obj)!r}")


class DBClient:
    def __init__(self, address: str = "127.0.0.1:8081", timeout: float = 20.0,
                 binary: bool = False):
        # binary=True speaks the compact wire form (core/wire.py) both
        # ways: vectors as raw f32 bytes.
        # The federation's node-to-node clients enable it; external/CLI
        # clients keep JSON for curl-ability.
        host, _, port = address.partition(":")
        self.host = host
        self.port = int(port or 8081)
        self.timeout = timeout
        self.binary = binary
        self._local = threading.local()

    def _conn(self) -> http.client.HTTPConnection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = http.client.HTTPConnection(self.host, self.port,
                                              timeout=self.timeout)
            self._local.conn = conn
        return conn

    def call(self, method: str, params: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        if self.binary:
            from tpuvdb_torch.core import wire

            body = wire.encode(params or {})
            headers = {"Content-Type": wire.BINARY_CTYPE,
                       "Accept": wire.BINARY_CTYPE}
        else:
            wire = None
            body = json.dumps(params or {}, default=_json_default) \
                .encode("utf-8")
            headers = {"Content-Type": "application/json"}
        for attempt in (0, 1):  # one retry on a stale keep-alive connection
            conn = self._conn()
            try:
                conn.request("POST", f"/rpc/{method}", body, headers)
                resp = conn.getresponse()
                data = resp.read()
                ctype = resp.getheader("Content-Type") or ""
                if wire is not None and wire.BINARY_CTYPE in ctype:
                    return wire.decode(data)
                return json.loads(data.decode("utf-8"))
            except (http.client.HTTPException, ConnectionError, OSError):
                self.close()
                if attempt:
                    raise
        raise RuntimeError("unreachable")

    def response(self, method: str, params: Optional[Dict[str, Any]] = None) -> Response:
        return Response.from_dict(self.call(method, params))

    def api_search(self, text: str, topk: int = 5) -> Dict[str, Any]:
        body = json.dumps({"text": text, "topk": topk}).encode("utf-8")
        conn = self._conn()
        conn.request("POST", "/api/search", body,
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return json.loads(resp.read().decode("utf-8"))

    def close(self):
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            try:
                conn.close()
            except Exception:
                pass
            self._local.conn = None
