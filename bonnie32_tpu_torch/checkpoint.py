"""Checkpoint / resume for batched rollout state
(bonnie32_tpu/checkpoint.py).

A datagen fleet snapshots the live simulation (the batched ECS state,
event queues, framebuffers, frame counters) and resumes it later.

Format: the JAX package's, key for key — one .npz holding every leaf of
the tree (`tree.py`: NamedTuples, tuples, lists, dicts) under its key
path joined with "/" (a field's name, a sequence's index, a dict entry's
`['key']`), plus `__meta__`, a JSON blob (format version, leaf count,
user metadata) stored as uint8.  A checkpoint written by either package
restores in the other.  `restore` takes the tree's structure from a
template and puts each leaf on the template leaf's device and dtype.
"""

from __future__ import annotations

import io
import json
from typing import Any, Dict, Optional

import numpy as np
import torch

from .tree import leaves_with_paths, map_leaves

FORMAT_VERSION = 1


def _key(path) -> str:
    return "/".join(path)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _arrays(tree, metadata) -> Dict[str, np.ndarray]:
    arrays = {_key(p): _to_numpy(x) for p, x in leaves_with_paths(tree)}
    meta = {"format_version": FORMAT_VERSION, "n_leaves": len(arrays),
            "user": metadata or {}}
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta).encode("utf-8"), dtype=np.uint8)
    return arrays


def save(path: str, tree, metadata: Optional[Dict[str, Any]] = None) -> None:
    """Write a checkpoint: every leaf as an npz entry + a metadata blob."""
    with open(path, "wb") as f:
        np.savez(f, **_arrays(tree, metadata))


def save_bytes(tree, metadata: Optional[Dict[str, Any]] = None) -> bytes:
    """In-memory variant (for the storage layer / cloud sync)."""
    buf = io.BytesIO()
    np.savez(buf, **_arrays(tree, metadata))
    return buf.getvalue()


def load_metadata(path: str) -> Dict[str, Any]:
    with np.load(path) as z:
        return json.loads(bytes(z["__meta__"]).decode("utf-8"))


def _stored(source) -> Dict[str, np.ndarray]:
    with np.load(source) as z:
        return {k: z[k] for k in z.files if k != "__meta__"}


def _fill(stored: Dict[str, np.ndarray], template):
    """`template` with each leaf read from `stored` under its key, cast
    to the template leaf's dtype and put on its device."""
    def leaf(path, want):
        key = _key(path)
        if key not in stored:
            raise ValueError(f"checkpoint missing leaf: {key}")
        arr = stored[key]
        shape = (tuple(want.shape) if isinstance(want, torch.Tensor)
                 else np.shape(want))
        if arr.shape != shape:
            raise ValueError(
                f"leaf {key}: shape {arr.shape} != template {shape}")
        if isinstance(want, torch.Tensor):
            dtype = torch.empty((), dtype=want.dtype).numpy().dtype
            return torch.from_numpy(np.ascontiguousarray(
                arr.astype(dtype))).to(want.device)
        if isinstance(want, np.ndarray):
            return arr.astype(want.dtype)
        return type(want)(arr.item())
    return map_leaves(leaf, template)


def restore(path: str, template):
    """Load a checkpoint into the STRUCTURE of `template`: every leaf of
    the template must exist in the file with a matching shape; dtypes are
    cast to the template's (a file written with 64-bit leaves restores
    into 32-bit ones)."""
    stored = _stored(path)
    missing = [_key(p) for p, _ in leaves_with_paths(template)
               if _key(p) not in stored]
    if missing:
        raise ValueError(f"checkpoint missing leaves: {missing[:5]}")
    return _fill(stored, template)


def restore_bytes(data: bytes, template):
    """`restore` from the bytes of `save_bytes`."""
    return _fill(_stored(io.BytesIO(data)), template)
