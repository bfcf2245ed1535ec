"""Cloud storage: quota-limited, size-capped, asynchronous (fire-and-poll).
(The port's own copy of the JAX package's `storage/cloud.py`, host code.)

Reference behavior: `/root/reference/src/storage/gcp.rs` — 100 KiB per
file (:13), 1 MiB user quota (:16), pre-flight size/quota checks on write
(:269-292), REST requests on background threads.

The REST transport is a pluggable `backend` (get/put/delete/list_keys):

  * `HttpCloudBackend` — the real REST client (gcp.rs:342-520 native
    path): Bearer-token auth, /list /get /upload /delete /quota
    endpoints, base64 content bodies, HTTP-status -> StorageError
    mapping (401/403 auth, 404 not-found, 429 rate-limit, quota bodies).
    Tested against a local HTTP server (zero egress in this build, so
    the endpoint URL is injectable).
  * `MemoryCloudBackend` — in-memory dict with optional artificial
    latency, the default for offline runs.
"""

from __future__ import annotations

import base64
import json as jsonlib
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Callable, Dict, List, Optional

from .core import StorageError, StorageHandle

MAX_FILE_SIZE = 100 * 1024   # gcp.rs:13
USER_QUOTA = 1024 * 1024     # gcp.rs:16
CLOUD_RUN_URL = "https://bonnie32-storage-api.invalid"  # gcp.rs:10 shape


class HttpCloudBackend:
    """REST client over the Cloud Run storage API (gcp.rs:342-520).

    `token_provider` returns the ID token (JWT) used as the Bearer
    credential — empty string means unauthenticated (gcp.rs:350).
    """

    def __init__(self, base_url: str = CLOUD_RUN_URL,
                 token_provider: Optional[Callable[[], str]] = None,
                 timeout_s: float = 10.0):
        self.base_url = base_url.rstrip("/")
        self.token_provider = token_provider or (lambda: "")
        self.timeout_s = timeout_s

    # -- request plumbing (gcp.rs:372-404) --------------------------------

    def _token(self) -> str:
        tok = self.token_provider()
        if not tok:
            raise StorageError.auth_required()
        return tok

    def _request(self, endpoint: str, body: Optional[dict] = None) -> dict:
        url = self.base_url + endpoint
        headers = {"Authorization": f"Bearer {self._token()}"}
        data = None
        if body is not None:
            headers["Content-Type"] = "application/json"
            data = jsonlib.dumps(body).encode()
        req = urllib.request.Request(url, data=data, headers=headers,
                                     method="POST" if body is not None
                                     else "GET")
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
                return jsonlib.loads(r.read().decode())
        except urllib.error.HTTPError as e:
            raise self._convert_error(e) from None
        except urllib.error.URLError as e:
            raise StorageError.network(str(e.reason)) from None
        except jsonlib.JSONDecodeError as e:
            raise StorageError("other", f"JSON parse error: {e}") from None

    @staticmethod
    def _convert_error(e: urllib.error.HTTPError) -> StorageError:
        """gcp.rs:406-428 convert_error."""
        code = e.code
        if code in (401, 403):
            return StorageError.auth_required()
        if code == 404:
            return StorageError.not_found("File not found")
        if code == 429:
            return StorageError.rate_limited()
        try:
            body = e.read().decode()
        except Exception:
            body = ""
        if "quota" in body or "Quota" in body:
            return StorageError.quota_exceeded(0, USER_QUOTA)
        return StorageError.network(f"HTTP {code}: {body}")

    # -- backend protocol --------------------------------------------------

    def list_keys(self, prefix: str) -> List[str]:
        """gcp.rs:431 /list — data.files[].path."""
        ep = "/list?prefix=" + urllib.parse.quote(prefix, safe="")
        data = self._request(ep)
        files = data.get("data", {}).get("files", []) or []
        return [f["path"] for f in files if isinstance(f.get("path"), str)]

    def get(self, key: str) -> bytes:
        """gcp.rs:457 /get — base64 data.content."""
        ep = "/get?path=" + urllib.parse.quote(key, safe="")
        data = self._request(ep)
        content = data.get("data", {}).get("content")
        if not isinstance(content, str):
            raise StorageError("other", "No content in response")
        try:
            return base64.b64decode(content)
        except Exception as exc:
            raise StorageError("other", f"Base64 decode error: {exc}") \
                from None

    def put(self, key: str, data: bytes) -> None:
        """gcp.rs:487 /upload — {"path", "content": base64}."""
        self._request("/upload", body={
            "path": key,
            "content": base64.b64encode(bytes(data)).decode()})

    def delete(self, key: str) -> None:
        """gcp.rs:510 /delete — {"path"}."""
        self._request("/delete", body={"path": key})

    def quota(self) -> Dict[str, int]:
        """gcp.rs:347 /quota — {"used_bytes", "max_bytes"}."""
        data = self._request("/quota").get("data", {})
        used = int(data.get("used_bytes", 0))
        limit = int(data.get("max_bytes", USER_QUOTA))
        return {"used": used, "limit": limit,
                "remaining": max(limit - used, 0)}

    def total_bytes(self) -> int:
        try:
            return self.quota()["used"]
        except StorageError:
            return 0


class MemoryCloudBackend:
    """Thread-safe in-memory object store standing in for GCS."""

    def __init__(self, latency_s: float = 0.0):
        self.latency_s = latency_s
        self._lock = threading.Lock()
        self._objects: Dict[str, bytes] = {}

    def _wait(self):
        if self.latency_s > 0:
            time.sleep(self.latency_s)

    def get(self, key: str) -> bytes:
        self._wait()
        with self._lock:
            if key not in self._objects:
                raise StorageError.not_found(key)
            return self._objects[key]

    def put(self, key: str, data: bytes) -> None:
        self._wait()
        with self._lock:
            self._objects[key] = bytes(data)

    def delete(self, key: str) -> None:
        self._wait()
        with self._lock:
            self._objects.pop(key, None)

    def list_keys(self, prefix: str) -> List[str]:
        self._wait()
        with self._lock:
            return sorted(k for k in self._objects if k.startswith(prefix))

    def total_bytes(self) -> int:
        with self._lock:
            return sum(len(v) for v in self._objects.values())


class CloudStorage:
    """gcp.rs:70 — quota-tracked async storage for `assets/userdata/*`."""

    def __init__(self, backend: Optional[MemoryCloudBackend] = None):
        self.backend = backend if backend is not None \
            else MemoryCloudBackend()

    def quota_used(self) -> int:
        return self.backend.total_bytes()

    def quota_limit(self) -> int:
        return USER_QUOTA

    def can_write(self) -> bool:
        """gcp.rs:97."""
        return self.quota_used() < USER_QUOTA

    def list(self, path: str) -> StorageHandle[List[str]]:
        prefix = path if path.endswith("/") else path + "/"
        return StorageHandle.spawn(
            lambda: [k[len(prefix):] for k in self.backend.list_keys(prefix)])

    def read(self, path: str) -> StorageHandle[bytes]:
        return StorageHandle.spawn(lambda: self.backend.get(path))

    def write(self, path: str, data: bytes) -> StorageHandle[None]:
        # pre-flight checks resolve immediately (gcp.rs:269-292)
        if len(data) > MAX_FILE_SIZE:
            return StorageHandle.error(
                StorageError.file_too_large(len(data), MAX_FILE_SIZE))
        used = self.quota_used()
        if used + len(data) > USER_QUOTA:
            return StorageHandle.error(
                StorageError.quota_exceeded(used, USER_QUOTA))
        return StorageHandle.spawn(lambda: self.backend.put(path, data))

    def delete(self, path: str) -> StorageHandle[None]:
        return StorageHandle.spawn(lambda: self.backend.delete(path))

    def exists(self, path: str) -> StorageHandle[bool]:
        def check():
            try:
                self.backend.get(path)
                return True
            except StorageError:
                return False
        return StorageHandle.spawn(check)
