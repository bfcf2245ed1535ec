"""The per-pixel PS1 colour pipeline of the sequential renderer
(bonnie32_tpu/ops/pixel.py): the pixel body of `rasterize_triangle_15`
(render.rs:1563-1661) — UV interpolation, texel fetch, black/transparent
keying, 5->8 expansion, vertex-colour modulation, shading, dither-quantize
and the drawable-black STP fixup.

Every attribute may be one value per instance, shaped to broadcast
against the (I, H, W) pixel planes (the sequential compositor, one
surface at a time), or a plane of its own (the winner's attributes in
raster_fast's resolve); the expressions are the same.  Where the port's
raster_batch already holds an expression (the barycentric interpolation,
the perspective-correct UV, the wrap, the saturating u8 cast, the texel
index) it is used from there, so both renderers evaluate one expression.
The JAX package's TPU texel paths (one-hot and packed-plane gathers, the
key bit planes) are not carried: the texel is read from the flat atlas.
"""

from typing import NamedTuple

import torch

from ..config import RasterSettings, ShadingMode
from ..types import TextureAtlas
from . import color as col
from .raster_batch import (C_IZA, C_IZB, C_IZC, C_U0, C_U1, C_U2, C_VV0,
                           C_VV1, C_VV2, _face_uv, _interp3, _texel_index,
                           _u8_trunc_sat, _wrap01)

# Rust `f32 as u8` (truncate, saturate to [0, 255], NaN -> 0) and the
# reference's interpolation order (bx a0 + by a1) + bz a2, by the JAX
# package's names
u8_trunc_sat = _u8_trunc_sat
interp3 = _interp3


class PixelColor(NamedTuple):
    r8: torch.Tensor
    g8: torch.Tensor
    b8: torch.Tensor
    semi: torch.Tensor       # STP bit (with the all-black fixup)
    keyed_out: torch.Tensor  # the pixel is skipped by the colour key


def texel_flat_index(atlas: TextureAtlas, tid, u, v):
    """The flat atlas index Texture15::sample reads (types.rs:671-681) at
    (u, v), `v` the already flipped (1 - v); tid < 0 reads texture 0."""
    safe = torch.clamp(tid, min=0).long()
    w, h = atlas.width[safe], atlas.height[safe]
    tx = torch.minimum(torch.trunc(_wrap01(u) * w.to(torch.float32))
                       .to(torch.int32), w - 1)
    ty = torch.minimum(torch.trunc(_wrap01(v) * h.to(torch.float32))
                       .to(torch.int32), h - 1)
    return atlas.offset[safe] + ty * w + tx


def sample_texture(atlas: TextureAtlas, tid, u, v):
    """Texture15::sample (types.rs:671-681), `v` already flipped; lanes
    of tid < 0 read texture 0 (the caller overrides them)."""
    return atlas.data[texel_flat_index(atlas, tid, u, v).long()]


def sample_keyed_bit(atlas: TextureAtlas, tid, u, v, black_transparent):
    """The keying test alone (render.rs:1588-1607): the texel at (u, 1-v)
    has rgb 0 and the face is black-transparent."""
    texel = atlas.data[_texel_index(atlas, torch.clamp(tid, min=0).long(),
                                    u, v).long()]
    return ((texel & 0x7FFF) == 0) & black_transparent & (tid >= 0)


def sample_and_key(atlas: TextureAtlas, tid, u, v, black_transparent):
    """Texture sample + keying (render.rs:1582-1607): (the Color15 after
    the drawable-black fixup, keyed_out)."""
    textured = tid >= 0
    sampled = atlas.data[_texel_index(atlas, torch.clamp(tid, min=0).long(),
                                      u, v).long()]
    c15 = torch.where(textured, sampled, torch.full_like(sampled, col.WHITE))
    is_black = (col.r5(c15) == 0) & (col.g5(c15) == 0) & (col.b5(c15) == 0)
    keyed_out = is_black & black_transparent
    c15 = torch.where((c15 == 0) & ~black_transparent,
                      torch.full_like(c15, col.BLACK_DRAWABLE), c15)
    return c15, keyed_out


def uv_at(bc_x, bc_y, bc_z, uv, iz, izi, settings: RasterSettings):
    """UV interpolation (render.rs:1563-1579); uv[k] = (u, v) of corner
    k, iz[k] its 1/z.  Perspective-correct: ((bx u0) iz0 + (by u1) iz1)
    + (bz u2) iz2 over the pixel's 1/z `izi` (or 1 where that is 0), an
    IEEE division (the JAX package's exact_div)."""
    cols = {C_U0: uv[0][0], C_VV0: uv[0][1], C_U1: uv[1][0],
            C_VV1: uv[1][1], C_U2: uv[2][0], C_VV2: uv[2][1],
            C_IZA: iz[0], C_IZB: iz[1], C_IZC: iz[2]}
    return _face_uv(bc_x, bc_y, bc_z, cols.__getitem__,
                    None if settings.affine_textures else izi)


def pixel_color(bc_x, bc_y, bc_z, izi, iz, uv, vc, shade, tid,
                black_transparent, needs_dither, xi, yi,
                atlas: TextureAtlas, settings: RasterSettings) -> PixelColor:
    """The pixel pipeline after the inside and z tests.  iz: the corners'
    1/z; uv: (u, v) per corner; vc: (r, g, b) per corner, integers;
    shade: (r, g, b) per corner, f32."""
    u, v = uv_at(bc_x, bc_y, bc_z, uv, iz, izi, settings)
    c15, keyed_out = sample_and_key(atlas, tid, u, v, black_transparent)
    tex8 = [col.expand_5_to_8(ch(c15)) for ch in (col.r5, col.g5, col.b5)]
    offset = col.dither_offset(xi, yi)
    q5 = []
    for c in range(3):
        v8 = _u8_trunc_sat(_interp3(bc_x, bc_y, bc_z,
                                    *(vc[k][c].to(torch.float32)
                                      for k in range(3))))
        mod8 = col.modulate8(tex8[c], v8)
        if settings.shading == ShadingMode.NONE:
            s = torch.ones_like(bc_x)
        elif settings.shading == ShadingMode.FLAT:
            # the reference takes corner 0's shade (all corners agree)
            s = shade[0][c]
        else:
            s = _interp3(bc_x, bc_y, bc_z, shade[0][c], shade[1][c],
                         shade[2][c])
        shaded = _u8_trunc_sat(torch.clamp(
            mod8.to(torch.float32) * torch.clamp(s, 0.0, 2.0), max=255.0))
        q5.append(torch.where(needs_dither,
                              col.dither_and_quantize8(shaded, offset),
                              shaded >> 3))
    all_black = (q5[0] == 0) & (q5[1] == 0) & (q5[2] == 0)
    return PixelColor(r8=col.expand_5_to_8(q5[0]),
                      g8=col.expand_5_to_8(q5[1]),
                      b8=col.expand_5_to_8(q5[2]),
                      semi=col.is_semi_transparent(c15) | all_black,
                      keyed_out=keyed_out)
