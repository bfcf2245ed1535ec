"""Instance-axis sharding over a list of devices
(bonnie32_tpu/parallel/mesh.py).

The reference is a single-process interactive app; the scaling axis of
the datagen build is batch parallelism over independent game instances.
Instances never communicate, so the mesh is a pure data-parallel axis:
per-instance state (framebuffers, cameras, ECS state, action streams)
is cut along axis 0 into one contiguous shard a device; scene data
(geometry, atlas, lights, collision, sky) is copied to every device.  No
collective runs in the hot path.

A mesh is an ordered list of torch.devices.  It may name one device
several times: the shards then run one after another on it, which is how
the split is exercised on one card (the counterpart of the JAX package's
virtual CPU mesh) and on the CPU.
"""

import contextlib
from typing import List, Optional, Sequence

import torch

from .. import rollout
from ..tree import leaves_with_paths, map_leaves, map_tensors


def instance_mesh(devices: Optional[Sequence] = None) -> List[torch.device]:
    """The devices of the instance axis, in order; by default every
    visible card (raising without one)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA card: name the mesh's devices, "
                               "e.g. instance_mesh(['cpu'] * 4)")
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device(d) for d in devices]


def shard_instances(tree, mesh: Sequence[torch.device]) -> list:
    """One tree a device: every tensor's axis 0 cut into len(mesh)
    contiguous pieces (torch.tensor_split: the first N % len(mesh) one
    longer), piece i copied to mesh[i] (a copy of its own, also where
    the device is the tensor's)."""
    n = len(mesh)
    return [map_tensors(
        lambda t, i=i, d=d: torch.tensor_split(t, n, dim=0)[i].to(
            d, copy=True), tree) for i, d in enumerate(mesh)]


def replicate(tree, mesh: Sequence[torch.device]) -> list:
    """One tree a device: every tensor copied to the device, once a
    device (entries naming one device share its copy); host leaves
    (ints, the frozen FlatSceneStatic, the sky's host config) stay shared
    by every copy."""
    copies = {}
    for d in mesh:
        if d not in copies:
            copies[d] = map_tensors(lambda t, d=d: t.to(d), tree)
    return [copies[d] for d in mesh]


def gather_instances(shards: Sequence, device):
    """The shards' trees concatenated back along axis 0 on `device`."""
    device = torch.device(device)
    others = [dict(leaves_with_paths(s)) for s in shards[1:]]

    def cat(path, x):
        if not isinstance(x, torch.Tensor):
            return x
        return torch.cat([t.to(device) for t in [x] + [o[path]
                                                       for o in others]])
    return map_leaves(cat, shards[0])


def sharded_step_and_render(mesh: Sequence[torch.device], env, settings,
                            height: int, width: int,
                            dt: float = 1.0 / 60.0):
    """The multi-device datagen step: `env` replicated over the mesh and
    a callable `(state_shards, action_shards) -> (state_shards,
    fb_shards)` in which shard i runs the whole `rollout.step_and_render`
    (instance_chunk=None) on mesh[i] with its replica, one shard after
    another from the calling thread; no collective runs."""
    mesh = list(mesh)
    envs = replicate(env, mesh)

    def step(state_shards, action_shards):
        if not len(state_shards) == len(action_shards) == len(mesh):
            raise ValueError(f"{len(state_shards)} state and "
                             f"{len(action_shards)} action shards over a "
                             f"mesh of {len(mesh)}")
        states, frames = [], []
        for dev, e, s, a in zip(mesh, envs, state_shards, action_shards):
            with (torch.cuda.device(dev) if dev.type == "cuda"
                  else contextlib.nullcontext()):
                s2, fb = rollout.step_and_render(
                    s, e, a, settings, height=height, width=width, dt=dt,
                    instance_chunk=None)
            states.append(s2)
            frames.append(fb)
        return states, frames

    return step

