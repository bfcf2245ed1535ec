"""Tensor NamedTuples of the render pipeline (bonnie32_tpu/types.py).

Field names match the JAX package's pytrees so the two sides compare
field by field.  Batched values carry a leading instance dimension where
the JAX code would vmap.  The TPU-only texel bit planes of `TextureAtlas`
(black_words, transp_words, black_wrows) are not ported: the CUDA kernels
read the flat Color15 `data` directly.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


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


def to_device(tree, device):
    """Move every tensor of a (nested) NamedTuple to `device`."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_device(x, device) for x in tree))
    return tree
