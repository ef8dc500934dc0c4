"""HTTP server: the port of tpuvdb.api.server.

One stdlib ThreadingHTTPServer serves, as the reference's does:

  POST /rpc/<method>   — coordinator RPCs (put/get/delete/search/
                         register_node/list_nodes/info/flush/compact/...),
                         JSON, or the binary wire (core/wire.py) when the
                         request's Content-Type / Accept names it
  POST /api/search     — {"text": ..., "topk": N} -> image results (text
                         search through the service's CLIP embedder; 503
                         with the error if embedding or search raises)
  GET  /static/<path>  — image/static file serving
  GET  /               — the search frontend (api/static/index.html)
  GET  /healthz        — liveness probe (used by cluster health checks)

CORS is permissive. `wire`, and msgpack with it, is imported only where a
binary frame is read or written, so a JSON-only server runs without
msgpack.
"""

from __future__ import annotations

import json
import mimetypes
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from tpuvdb_torch.api.service import DBService

BINARY_CTYPE = "application/x-tpuvdb-bin"  # core/wire.py's BINARY_CTYPE

_STATIC_DIR = os.path.join(os.path.dirname(__file__), "static")


def _json_default(obj):
    """JSON fallback for ndarray payloads (producers may keep vectors as
    arrays for the binary path; JSON clients still get plain lists)."""
    import numpy as np

    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (np.floating, np.integer)):
        return obj.item()
    raise TypeError(f"unserializable type {type(obj)!r}")


def make_handler(service: DBService):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet unless TPUVDB_HTTP_LOG=1
            if os.environ.get("TPUVDB_HTTP_LOG"):
                import sys

                print(f"[http] {fmt % args}", file=sys.stderr, flush=True)

        def _send(self, code: int, body: bytes, ctype: str = "application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Access-Control-Allow-Origin", "*")
            self.send_header("Access-Control-Allow-Methods", "GET, POST, OPTIONS")
            self.send_header("Access-Control-Allow-Headers", "Content-Type")
            self.end_headers()
            self.wfile.write(body)

        def _wants_binary(self) -> bool:
            return BINARY_CTYPE in self.headers.get("Accept", "")

        def _send_json(self, obj, code: int = 200):
            # content negotiation (TBinaryProtocol analog): federation
            # clients Accept the compact binary form — vectors ride as
            # raw f32 bytes instead of JSON text (~5-10x fewer bytes on
            # the bulk export/replicate/sync paths)
            if self._wants_binary():
                from tpuvdb_torch.core import wire

                self._send(code, wire.encode(obj), BINARY_CTYPE)
                return
            self._send(code, json.dumps(obj, default=_json_default)
                       .encode("utf-8"))

        def _read_json(self):
            n = int(self.headers.get("Content-Length", 0))
            if n == 0:
                return {}
            body = self.rfile.read(n)
            if BINARY_CTYPE in self.headers.get("Content-Type", ""):
                from tpuvdb_torch.core import wire

                return wire.decode(body)
            return json.loads(body.decode("utf-8"))

        def do_OPTIONS(self):
            self._send(204, b"")

        def do_GET(self):
            path = self.path.split("?", 1)[0]
            if path == "/healthz":
                self._send_json({"ok": True})
                return
            if path in ("/", "/index.html"):
                self._serve_file(os.path.join(_STATIC_DIR, "index.html"))
                return
            if path.startswith("/static/"):
                rel = os.path.normpath(path[len("/static/"):]).lstrip("/")
                if rel.startswith(".."):
                    self._send_json({"error": "bad path"}, 400)
                    return
                root = service.image_root or _STATIC_DIR
                self._serve_file(os.path.join(root, rel))
                return
            self._send_json({"error": "not found"}, 404)

        def _serve_file(self, fpath: str):
            if not os.path.isfile(fpath):
                self._send_json({"error": "not found"}, 404)
                return
            ctype = mimetypes.guess_type(fpath)[0] or "application/octet-stream"
            with open(fpath, "rb") as f:
                self._send(200, f.read(), ctype)

        def do_POST(self):
            path = self.path.split("?", 1)[0]
            try:
                payload = self._read_json()
            except Exception as e:  # bad JSON or torn msgpack frame
                self._send_json({"success": False,
                                 "message": f"bad request body: {e}"}, 400)
                return
            if path.startswith("/rpc/"):
                method = path[len("/rpc/"):]
                self._send_json(service.handle(method, payload))
                return
            if path == "/api/search":
                text = payload.get("text", "")
                topk = int(payload.get("topk", 5))
                if not text:
                    self._send_json({"error": "missing text"}, 400)
                    return
                try:
                    self._send_json(service.text_search(text, topk))
                except Exception as e:
                    self._send_json({"error": f"{type(e).__name__}: {e}"}, 503)
                return
            self._send_json({"error": "not found"}, 404)

    return Handler


class DBServer:
    def __init__(self, service: DBService, host: str = "127.0.0.1",
                 port: Optional[int] = None):
        self.service = service
        self.host = host
        self.port = port if port is not None else service.config.rpc_port
        self.httpd = ThreadingHTTPServer((self.host, self.port),
                                         make_handler(service))
        self.port = self.httpd.server_address[1]  # resolve port=0
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def serve_forever(self):
        self.httpd.serve_forever()

    def start_background(self):
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True, name="tpuvdb-torch-http")
        self._thread.start()

    def shutdown(self):
        self.httpd.shutdown()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None
        self.httpd.server_close()
