"""A fake of the cloud storage API on 127.0.0.1 (no jax; chip_smoke.py and
the port's storage tests use it): the server of tests/test_storage.py
with the port's quota.  It speaks the protocol `HttpCloudBackend` calls —
/list /get /upload /delete /quota with bearer auth, 404 for a missing
file, 429 when `rate_limit_next` is set and a quota body when
`quota_next` is set.

    with serve() as (url, api):
        backend = HttpCloudBackend(url, token_provider=lambda: TOKEN)
"""

import base64
import contextlib
import json
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer
from urllib.parse import parse_qs, unquote, urlparse

from bonnie32_tpu_torch.storage.cloud import USER_QUOTA

TOKEN = "tok123"


class FakeCloudAPI(BaseHTTPRequestHandler):
    """Implements the Cloud Run storage protocol: /list /get /upload
    /delete /quota with bearer auth, 404/429 and quota errors."""

    store: dict = {}
    rate_limit_next = False
    quota_next = False

    def log_message(self, *a):
        pass

    def _reply(self, code, obj):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _auth_ok(self):
        return self.headers.get("Authorization") == f"Bearer {TOKEN}"

    def _common(self):
        if not self._auth_ok():
            self._reply(401, {"success": False})
            return False
        if FakeCloudAPI.rate_limit_next:
            FakeCloudAPI.rate_limit_next = False
            self._reply(429, {"success": False})
            return False
        return True

    def do_GET(self):
        if not self._common():
            return
        u = urlparse(self.path)
        q = parse_qs(u.query)
        if u.path == "/quota":
            used = sum(len(v) for v in self.store.values())
            self._reply(200, {"success": True, "data": {
                "used_bytes": used, "max_bytes": USER_QUOTA}})
        elif u.path == "/list":
            prefix = unquote(q.get("prefix", [""])[0])
            files = [{"path": k, "size": len(v)}
                     for k, v in sorted(self.store.items())
                     if k.startswith(prefix)]
            self._reply(200, {"success": True,
                              "data": {"files": files, "count": len(files)}})
        elif u.path == "/get":
            path = unquote(q.get("path", [""])[0])
            if path not in self.store:
                self._reply(404, {"success": False})
                return
            self._reply(200, {"success": True, "data": {
                "path": path,
                "content": base64.b64encode(self.store[path]).decode(),
                "size": len(self.store[path])}})
        else:
            self._reply(404, {"success": False})

    def do_POST(self):
        if not self._common():
            return
        n = int(self.headers.get("Content-Length", 0))
        body = json.loads(self.rfile.read(n).decode() or "{}")
        if self.path == "/upload":
            if FakeCloudAPI.quota_next:
                FakeCloudAPI.quota_next = False
                self._reply(507, {"success": False,
                                  "error": "user quota exceeded"})
                return
            self.store[body["path"]] = base64.b64decode(body["content"])
            self._reply(200, {"success": True, "data": {}})
        elif self.path == "/delete":
            self.store.pop(body["path"], None)
            self._reply(200, {"success": True, "data": {}})
        else:
            self._reply(404, {"success": False})


@contextlib.contextmanager
def serve():
    """A fresh fake API on an ephemeral port of 127.0.0.1: yields (its
    base url, the handler class holding the store and the error flags);
    the server thread is shut down and joined on exit."""
    FakeCloudAPI.store = {}
    FakeCloudAPI.rate_limit_next = False
    FakeCloudAPI.quota_next = False
    srv = HTTPServer(("127.0.0.1", 0), FakeCloudAPI)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{srv.server_port}", FakeCloudAPI
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=2)
