"""Batched rendering of one mesh (bonnie32_tpu/batch.py): a leading
instance axis over render_mesh_15, N instances with their own camera and
framebuffer over a shared scene, taken INSTANCE_CHUNK at a time to bound
the memory of the per-pixel planes (raster_fast holds a (chunk, 16, H, W)
plane per pass-1a temporary)."""

import torch

from .config import RasterSettings
from .ops import raster_ref
from .render import render_mesh_15
from .types import CameraArrays, FrameBuffers, resolve_device

INSTANCE_CHUNK = 128


def batched_framebuffers(n: int, height: int, width: int,
                         depth_mode: str = "fast", clear_color: int = 0,
                         device=None) -> FrameBuffers:
    """`n` cleared framebuffers for render_batch in `depth_mode` (the
    "fast" path clears as "inv").  `device` defaults to the card."""
    dm = "inv" if depth_mode == "fast" else depth_mode
    return raster_ref.new_framebuffer(height, width, depth_mode=dm,
                                      clear_color=clear_color, n=n,
                                      device=device)


def in_chunks(n: int, instance_chunk, render) -> FrameBuffers:
    """`render(sl)` over the slices of n instances, instance_chunk at a
    time (None: all at once), its FrameBuffers joined along the instance
    axis."""
    step = n if instance_chunk is None else instance_chunk
    outs = [render(slice(s, s + step)) for s in range(0, n, step)]
    return FrameBuffers(color=torch.cat([o.color for o in outs]),
                        depth=torch.cat([o.depth for o in outs]))


def render_batch(fbs: FrameBuffers, mesh, faces, atlas,
                 cameras: CameraArrays, lights, fog,
                 settings: RasterSettings, depth_mode: str = "fast",
                 instance_chunk: int = INSTANCE_CHUNK) -> FrameBuffers:
    """render_mesh_15 of every (framebuffer, camera) pair, instance_chunk
    instances a call (None: all at once)."""
    return in_chunks(fbs.color.shape[0], instance_chunk, lambda sl:
                     render_mesh_15(
                         FrameBuffers(fbs.color[sl], fbs.depth[sl]), mesh,
                         faces, atlas,
                         CameraArrays(cameras.position[sl],
                                      cameras.basis[sl]),
                         lights, fog, settings, depth_mode=depth_mode))


def batched_cameras(positions, bases, device=None) -> CameraArrays:
    """positions (N, 3), bases (N, 3, 3) -> batched CameraArrays on
    `device` (default: the card)."""
    device = resolve_device(device)
    return CameraArrays(
        position=torch.as_tensor(positions, dtype=torch.float32,
                                 device=device),
        basis=torch.as_tensor(bases, dtype=torch.float32, device=device))
