"""Local filesystem backend (storage/local.rs:14-113): immediate handles,
files-only listing, parent auto-create on write, delete-missing is OK;
the port's own copy of the JAX package's `storage/local.py`, host code."""

from __future__ import annotations

import os
from typing import List

from .core import StorageError, StorageHandle


class LocalStorage:
    def __init__(self, base_dir: str = "."):
        self.base_dir = base_dir

    def _resolve(self, path: str) -> str:
        return os.path.join(self.base_dir, path)

    def list(self, path: str) -> StorageHandle[List[str]]:
        full = self._resolve(path)
        try:
            files = [n for n in os.listdir(full)
                     if os.path.isfile(os.path.join(full, n))]
            return StorageHandle.ready(files)
        except FileNotFoundError as e:
            return StorageHandle.error(StorageError.not_found(str(e)))
        except PermissionError as e:
            return StorageHandle.error(StorageError.permission_denied(str(e)))
        except OSError as e:
            return StorageHandle.error(StorageError.io_error(str(e)))

    def read(self, path: str) -> StorageHandle[bytes]:
        try:
            with open(self._resolve(path), "rb") as f:
                return StorageHandle.ready(f.read())
        except FileNotFoundError as e:
            return StorageHandle.error(StorageError.not_found(str(e)))
        except PermissionError as e:
            return StorageHandle.error(StorageError.permission_denied(str(e)))
        except OSError as e:
            return StorageHandle.error(StorageError.io_error(str(e)))

    def write(self, path: str, data: bytes) -> StorageHandle[None]:
        full = self._resolve(path)
        try:
            parent = os.path.dirname(full)
            if parent:
                os.makedirs(parent, exist_ok=True)
            with open(full, "wb") as f:
                f.write(data)
            return StorageHandle.ready(None)
        except PermissionError as e:
            return StorageHandle.error(StorageError.permission_denied(str(e)))
        except OSError as e:
            return StorageHandle.error(StorageError.io_error(str(e)))

    def delete(self, path: str) -> StorageHandle[None]:
        try:
            os.remove(self._resolve(path))
            return StorageHandle.ready(None)
        except FileNotFoundError:
            return StorageHandle.ready(None)  # not-found is OK for delete
        except OSError as e:
            return StorageHandle.error(StorageError.io_error(str(e)))

    def exists(self, path: str) -> StorageHandle[bool]:
        return StorageHandle.ready(os.path.exists(self._resolve(path)))
