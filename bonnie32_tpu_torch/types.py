"""Tensor NamedTuples of the render pipeline (bonnie32_tpu/types.py).

Field names match the JAX package's pytrees so the two sides compare
field by field.  Batched values carry a leading instance dimension where
the JAX code would vmap.  The TPU-only texel bit planes of `TextureAtlas`
(black_words, transp_words, black_wrows) are not ported: the CUDA kernels
read the flat Color15 `data` directly.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .tree import map_tensors


class MeshArrays(NamedTuple):
    """Vertex buffers. Reference: Vertex (types.rs:947-959)."""

    pos: torch.Tensor          # (V, 3) f32 world position
    uv: torch.Tensor           # (V, 2) f32
    normal: torch.Tensor       # (V, 3) f32
    color: torch.Tensor        # (V, 3) i32 vertex color rgb 0-255
    color_blend: torch.Tensor  # (V,) i32 BlendMode of the vertex color


class FaceArrays(NamedTuple):
    """Triangle faces. Reference: Face (types.rs:983-1002)."""

    vidx: torch.Tensor               # (T, 3) i32 vertex indices
    tex_id: torch.Tensor             # (T,) i32, -1 = untextured
    black_transparent: torch.Tensor  # (T,) bool
    blend_mode: torch.Tensor         # (T,) i32 BlendMode
    editor_alpha: torch.Tensor       # (T,) i32 0-255
    double_sided: torch.Tensor       # (T,) bool per-face backface opt-out
    valid: torch.Tensor              # (T,) bool padding mask
    key_possible: torch.Tensor       # (T,) bool, False = proven key-free


class TextureAtlas(NamedTuple):
    """All scene textures flattened into one Color15 word array."""

    data: torch.Tensor             # (A,) i32 Color15 words
    offset: torch.Tensor           # (NT,) i32 start index into data
    width: torch.Tensor            # (NT,) i32
    height: torch.Tensor           # (NT,) i32
    blend_mode: torch.Tensor       # (NT,) i32 texture-level BlendMode
    has_black: torch.Tensor        # (NT,) bool any texel with rgb555 == 0
    has_transparent: torch.Tensor  # (NT,) bool any texel word == 0


class TextureAtlas8(NamedTuple):
    """8-bit textures of the non-RGB555 pipeline (`&[Texture]`,
    types.rs:1236).  Texel word r | g<<8 | b<<16 | blend<<24, the blend
    the texel's BlendMode (ERASE: a transparent texel, types.rs:1095)."""

    data: torch.Tensor        # (A,) i32 packed texels
    offset: torch.Tensor      # (NT,) i32
    width: torch.Tensor       # (NT,) i32
    height: torch.Tensor      # (NT,) i32
    blend_mode: torch.Tensor  # (NT,) i32 texture-level BlendMode


class Lights(NamedTuple):
    """Scene lights; kind 0 disabled, 1 directional, 2 point, 3 spot."""

    kind: torch.Tensor       # (L,) i32
    position: torch.Tensor   # (L, 3) f32
    direction: torch.Tensor  # (L, 3) f32, pre-normalized
    color01: torch.Tensor    # (L, 3) f32
    intensity: torch.Tensor  # (L,) f32
    radius: torch.Tensor     # (L,) f32
    angle: torch.Tensor      # (L,) f32
    ambient: torch.Tensor    # () f32


class CameraArrays(NamedTuple):
    """Camera pose; batched as (I, 3) and (I, 3, 3)."""

    position: torch.Tensor  # (..., 3) f32
    basis: torch.Tensor     # (..., 3, 3) f32 rows (basis_x, basis_y, basis_z)


class Fog(NamedTuple):
    """Per-room fog: render_mesh_15's `fog` tuple (render.rs:2309)."""

    enabled: torch.Tensor        # () bool
    start: torch.Tensor          # () f32
    falloff: torch.Tensor        # () f32
    cull_distance: torch.Tensor  # () f32
    color: torch.Tensor          # (3,) i32 rgb 0-255


class Surfaces(NamedTuple):
    """Projected, culled, fogged triangles; (I, T, ...) when batched."""

    sx: torch.Tensor                 # (I, T, 3) f32
    sy: torch.Tensor                 # (I, T, 3) f32
    z: torch.Tensor                  # (I, T, 3) f32
    inv_z: torch.Tensor              # (I, T, 3) f32
    area: torch.Tensor               # (I, T) f32
    inv_area: torch.Tensor           # (I, T) f32
    uv: torch.Tensor                 # (I, T, 3, 2) f32
    vc: torch.Tensor                 # (I, T, 3, 3) i32
    shade: torch.Tensor              # (I, T, 3, 3) f32
    tex_id: torch.Tensor             # (T,) i32
    blend_mode: torch.Tensor         # (T,) i32
    black_transparent: torch.Tensor  # (T,) bool
    editor_alpha: torch.Tensor       # (T,) i32
    needs_dither: torch.Tensor       # (I, T) bool
    has_transparency: torch.Tensor   # (T,) bool
    centroid_z: torch.Tensor         # (I, T) f32
    valid: torch.Tensor              # (I, T) bool
    key_possible: torch.Tensor       # (T,) bool


class FrameBuffers(NamedTuple):
    """Batched framebuffers: packed RGBA8 words and inverse-z depth."""

    color: torch.Tensor  # (I, H, W) i32
    depth: torch.Tensor  # (I, H, W) f32


def empty_lights(pad: int = 8, device=None) -> Lights:
    """All-disabled lights of capacity `pad`, ambient 0.3, on `device`
    (default: the card)."""
    device = resolve_device(device)
    f32 = torch.float32
    return Lights(kind=torch.zeros(pad, dtype=torch.int32, device=device),
                  position=torch.zeros((pad, 3), dtype=f32, device=device),
                  direction=torch.zeros((pad, 3), dtype=f32, device=device),
                  color01=torch.zeros((pad, 3), dtype=f32, device=device),
                  intensity=torch.zeros(pad, dtype=f32, device=device),
                  radius=torch.zeros(pad, dtype=f32, device=device),
                  angle=torch.zeros(pad, dtype=f32, device=device),
                  ambient=torch.tensor(0.3, dtype=f32, device=device))


def default_lights(pad: int = 8, device=None) -> Lights:
    """RasterSettings::default's one directional light (types.rs:1483):
    direction (-1, -1, -1) normalized, white, intensity 0.7, on `device`
    (default: the card)."""
    d = np.array([-1.0, -1.0, -1.0], np.float32)
    unit = d / np.sqrt(np.float32(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]))
    lights = empty_lights(pad=pad, device=device)
    lights.kind[0] = 1
    lights.direction[0] = torch.from_numpy(unit.astype(np.float32))
    lights.color01[0] = 1.0
    lights.intensity[0] = 0.7
    return lights


def no_fog(device=None) -> Fog:
    """Fog disabled, on `device` (default: the card)."""
    device = resolve_device(device)
    return Fog(enabled=torch.tensor(False, device=device),
               start=torch.tensor(0.0, device=device),
               falloff=torch.tensor(0.0, device=device),
               cull_distance=torch.tensor(3.4e38, dtype=torch.float32,
                                          device=device),
               color=torch.zeros(3, dtype=torch.int32, device=device))


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another (the tests pass device="cpu").  With no card and no explicit
    device it raises; it never falls back to the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card: the entry points run on the card by default; "
            "pass device='cpu' to run the plain torch twins on the CPU")
    return torch.device("cuda")


def to_device(tree, device):
    """Move every tensor of a tree (NamedTuples, tuples, lists, dicts;
    `tree.py`) to `device`; other leaves stay as they are."""
    return map_tensors(lambda t: t.to(device), tree)


def device_of(*args) -> torch.device:
    """The device of the first tensor among `args`; the CPU if none is
    one (numpy arrays and Python numbers live on the host)."""
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return torch.device("cpu")


def as_f32(x, device) -> torch.Tensor:
    """`x` as an f32 tensor on `device` (numbers round to f32 as JAX's
    `jnp.asarray(x, float32)` does)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def f32_scalar(v: float, device) -> torch.Tensor:
    """A 0-dim f32 constant on `device` (a divisor must be a tensor: torch
    on CUDA turns `x / python_scalar` into a multiply by the reciprocal)."""
    return torch.full((), float(np.float32(v)), dtype=torch.float32,
                      device=device)
