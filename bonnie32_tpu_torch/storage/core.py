"""Storage primitives: status, errors, handles, and the routing facade
(storage/mod.rs:29-420); the port's own copy of the JAX package's
`storage/core.py`, host code."""

from __future__ import annotations

import enum
import threading
from typing import Callable, Generic, List, Optional, TypeVar

T = TypeVar("T")

USERDATA_PREFIX = "assets/userdata/"


class StorageError(Exception):
    """storage/mod.rs:60 — one class with a kind discriminant (Python
    exceptions replace the Rust enum; `kind` keeps the variant)."""

    def __init__(self, kind: str, message: str = "", **info):
        super().__init__(f"{kind}: {message}" if message else kind)
        self.kind = kind
        self.message = message
        self.info = info

    # constructors mirroring the variants
    @classmethod
    def not_found(cls, path):
        return cls("NotFound", str(path))

    @classmethod
    def permission_denied(cls, msg):
        return cls("PermissionDenied", str(msg))

    @classmethod
    def io_error(cls, msg):
        return cls("IoError", str(msg))

    @classmethod
    def network(cls, msg):
        return cls("NetworkError", str(msg))

    @classmethod
    def auth_required(cls):
        return cls("AuthRequired")

    @classmethod
    def rate_limited(cls):
        """mod.rs:77 — HTTP 429 from the cloud API."""
        return cls("RateLimited", "rate limited, try again later")

    @classmethod
    def quota_exceeded(cls, used, limit):
        return cls("QuotaExceeded", f"{used} / {limit} bytes",
                   used=used, limit=limit)

    @classmethod
    def file_too_large(cls, size, maximum):
        return cls("FileTooLarge", f"{size} bytes (max: {maximum})",
                   size=size, max=maximum)


class StorageStatus(enum.Enum):
    """storage/mod.rs:29."""

    PENDING = "pending"
    READY = "ready"
    ERROR = "error"


class StorageMode(enum.Enum):
    """storage/mod.rs:120."""

    LOCAL = "Local"
    CLOUD = "Cloud"

    @property
    def label(self) -> str:
        return self.value


class StorageHandle(Generic[T]):
    """storage/mod.rs:141 — poll/take lifecycle.  Local ops resolve
    immediately; async backends resolve from a worker thread."""

    def __init__(self):
        self._lock = threading.Lock()
        self._status = StorageStatus.PENDING
        self._value: Optional[T] = None
        self._error: Optional[StorageError] = None

    @classmethod
    def ready(cls, value: T) -> "StorageHandle[T]":
        h = cls()
        h._resolve(value)
        return h

    @classmethod
    def error(cls, err: StorageError) -> "StorageHandle[T]":
        h = cls()
        h._reject(err)
        return h

    @classmethod
    def pending(cls) -> "StorageHandle[T]":
        return cls()

    @classmethod
    def spawn(cls, fn: Callable[[], T]) -> "StorageHandle[T]":
        """Run fn on a daemon thread; handle resolves when it returns
        (gcp.rs native path's background-thread requests)."""
        h = cls()

        def run():
            try:
                h._resolve(fn())
            except StorageError as e:
                h._reject(e)
            except Exception as e:  # noqa: BLE001 — report as IoError
                h._reject(StorageError.io_error(str(e)))

        threading.Thread(target=run, daemon=True).start()
        return h

    def _resolve(self, value: T) -> None:
        with self._lock:
            self._value = value
            self._status = StorageStatus.READY

    def _reject(self, err: StorageError) -> None:
        with self._lock:
            self._error = err
            self._status = StorageStatus.ERROR

    def is_pending(self) -> bool:
        return self.poll() is StorageStatus.PENDING

    def is_ready(self) -> bool:
        return not self.is_pending()

    def poll(self) -> StorageStatus:
        with self._lock:
            return self._status

    def take(self) -> Optional[T]:
        """None while pending; the value when ready; raises on error
        (storage/mod.rs:187 returns Result — Python raises)."""
        with self._lock:
            if self._status is StorageStatus.PENDING:
                return None
            if self._status is StorageStatus.ERROR:
                raise self._error
            return self._value

    def wait(self, timeout: float = 10.0, poll_s: float = 0.001) -> T:
        """Convenience: block until resolved (tests, scripts)."""
        import time
        deadline = time.monotonic() + timeout
        while self.is_pending():
            if time.monotonic() > deadline:
                raise StorageError.io_error("timeout waiting for handle")
            time.sleep(poll_s)
        return self.take()


class Storage:
    """storage/mod.rs:212 — `assets/userdata/*` routes to cloud when
    available; everything else is local."""

    def __init__(self, local=None, cloud=None):
        from .local import LocalStorage
        self.local = local if local is not None else LocalStorage()
        self.cloud = cloud

    @staticmethod
    def is_userdata_path(path: str) -> bool:
        return str(path).startswith(USERDATA_PREFIX)

    def mode(self) -> StorageMode:
        return StorageMode.CLOUD if self.cloud is not None \
            else StorageMode.LOCAL

    def has_cloud(self) -> bool:
        return self.cloud is not None

    def can_write(self) -> bool:
        return True  # native semantics: local always writable

    def update_for_auth(self, authenticated: bool, cloud_factory=None):
        """storage/mod.rs:264 — attach/detach cloud on auth changes."""
        if authenticated:
            if cloud_factory is None:
                from .cloud import CloudStorage
                cloud_factory = CloudStorage
            self.cloud = cloud_factory()
        else:
            self.cloud = None

    def _route(self, path: str):
        if self.is_userdata_path(path) and self.cloud is not None:
            return self.cloud
        return self.local

    def list(self, path: str) -> StorageHandle[List[str]]:
        return self._route(path).list(path)

    def read(self, path: str) -> StorageHandle[bytes]:
        return self._route(path).read(path)

    def write(self, path: str, data: bytes) -> StorageHandle[None]:
        return self._route(path).write(path, data)

    def delete(self, path: str) -> StorageHandle[None]:
        return self._route(path).delete(path)

    def exists(self, path: str) -> StorageHandle[bool]:
        return self._route(path).exists(path)

    # sync wrappers (storage/mod.rs:349) — assert non-pending like the
    # reference's expect()
    def _sync(self, handle: StorageHandle):
        assert handle.is_ready(), "sync call on async backend"
        return handle.take()

    def list_sync(self, path: str) -> List[str]:
        return self._sync(self.list(path))

    def read_sync(self, path: str) -> bytes:
        return self._sync(self.read(path))

    def write_sync(self, path: str, data: bytes) -> None:
        return self._sync(self.write(path, data))

    def delete_sync(self, path: str) -> None:
        return self._sync(self.delete(path))

    def exists_sync(self, path: str) -> bool:
        return self._sync(self.exists(path))

    def read_string_sync(self, path: str) -> str:
        return self.read_sync(path).decode("utf-8")

    def write_string_sync(self, path: str, content: str) -> None:
        self.write_sync(path, content.encode("utf-8"))

    def is_sync(self, path: str) -> bool:
        """storage/mod.rs:414."""
        return not (self.is_userdata_path(path) and self.cloud is not None)
