"""Path-routed storage: local filesystem + optional cloud, fire-and-poll.
(The port's own copy of the JAX package's `storage/__init__.py`, host
code.)

Reference behavior: `/root/reference/src/storage/mod.rs` — StorageStatus/
StorageError/StorageHandle (:29-208), the Storage facade with
`assets/userdata/*` -> cloud routing (:212-420) and sync wrappers that
assert non-pending; `/root/reference/src/storage/local.rs`;
`/root/reference/src/storage/gcp.rs` (100 KiB file cap, 1 MiB quota,
background-thread requests); `/root/reference/src/storage/async_ops.rs`
(PendingSave/PendingLoad/PendingList on worker threads).

The GCP REST transport is replaced by a pluggable backend (this
environment has no egress); `MemoryCloudBackend` runs operations on a
worker thread so the pending -> ready lifecycle is exercised for real.
"""

from .core import (Storage, StorageError, StorageHandle, StorageMode,
                   StorageStatus, USERDATA_PREFIX)
from .local import LocalStorage
from .cloud import (CloudStorage, MAX_FILE_SIZE, MemoryCloudBackend,
                    USER_QUOTA)
from .async_ops import (PendingList, PendingLoad, PendingSave, list_async,
                        load_async, save_async)

__all__ = ["Storage", "StorageError", "StorageHandle", "StorageMode",
           "StorageStatus", "USERDATA_PREFIX", "LocalStorage",
           "CloudStorage", "MemoryCloudBackend", "MAX_FILE_SIZE",
           "USER_QUOTA", "PendingSave", "PendingLoad", "PendingList",
           "save_async", "load_async", "list_async"]
