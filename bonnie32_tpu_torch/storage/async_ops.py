"""Background-thread file operations (storage/async_ops.rs:96-137):
PendingSave/PendingLoad/PendingList with is_complete()/take(); the port's
own copy of the JAX package's `storage/async_ops.py`, host code."""

from __future__ import annotations

import os
import threading
from typing import Generic, List, Optional, TypeVar

T = TypeVar("T")


class _Pending(Generic[T]):
    def __init__(self, fn):
        self._lock = threading.Lock()
        self._done = False
        self._result: Optional[T] = None
        self._error: Optional[Exception] = None

        def run():
            try:
                r = fn()
            except Exception as e:  # noqa: BLE001
                with self._lock:
                    self._error = e
                    self._done = True
                return
            with self._lock:
                self._result = r
                self._done = True

        threading.Thread(target=run, daemon=True).start()

    def is_complete(self) -> bool:
        with self._lock:
            return self._done

    def take(self) -> Optional[T]:
        """None while running; result when done; raises the captured
        error (async_ops.rs AsyncResult::Err)."""
        with self._lock:
            if not self._done:
                return None
            if self._error is not None:
                raise self._error
            return self._result

    def wait(self, timeout: float = 10.0) -> T:
        import time
        deadline = time.monotonic() + timeout
        while not self.is_complete():
            if time.monotonic() > deadline:
                raise TimeoutError("async op timeout")
            time.sleep(0.001)
        return self.take()


class PendingSave(_Pending[bool]):
    pass


class PendingLoad(_Pending[bytes]):
    pass


class PendingList(_Pending[List[str]]):
    pass


def save_async(path: str, data: bytes) -> PendingSave:
    """async_ops.rs:96."""
    def run():
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(path, "wb") as f:
            f.write(data)
        return True
    return PendingSave(run)


def load_async(path: str) -> PendingLoad:
    """async_ops.rs:117."""
    def run():
        with open(path, "rb") as f:
            return f.read()
    return PendingLoad(run)


def list_async(path: str) -> PendingList:
    """async_ops.rs:137 — filenames of regular files."""
    def run():
        return [n for n in os.listdir(path)
                if os.path.isfile(os.path.join(path, n))]
    return PendingList(run)
