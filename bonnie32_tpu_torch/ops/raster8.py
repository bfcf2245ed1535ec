"""The 8-bit (non-RGB555) pipeline (bonnie32_tpu/ops/raster8.py):
`rasterize_triangle` (render.rs:1202) and `render_mesh` (render.rs:1971),
selected by `use_rgb555 = false`, batched over instances (I, H, W) as the
sequential compositor of ops/raster_ref.py is.  Where it differs from the
15-bit path:

  * textures are 8-bit RGBA; an alpha-0 texel carries BlendMode::ERASE
    and is skipped (types.rs:1095); no black keying, no STP bit;
  * undithered pixels keep all 8 bits; dithering quantizes to 5 bits
    and expands with a plain << 3 (render.rs:1186);
  * blending is in 8-bit space (Color::blend_with, types.rs:886), driven
    by the texel's blend;
  * one pass in face order, no opaque/transparent split; painter's order
    only without a z-buffer; every drawn pixel writes z (render.rs:
    1395-1420), blended and editor-alpha pixels too;
  * editor alpha lerps in f32 with truncating casts (render.rs:398-409).

Depth is the reference's: z = 1 / interp(1/z), tested `z < buf`, so the
framebuffer must be cleared to F32_MAX (raster_ref.new_framebuffer's
"harmonic" clear).  On an inverse-z clear (0) no face passes, as in the
JAX package.  The surface build is ops/surface.build_surfaces; the loop
over faces is sequential, since each face blends against the colour the
faces before it left.
"""

import torch

from ..config import BlendMode, RasterSettings, ShadingMode
from ..types import FrameBuffers, TextureAtlas8
from . import color as col
from . import pixel as px
from .fixed import f32_to_i32
from .raster_batch import _lexsort, _texel_index
from .raster_ref import F32_MAX, OneSurface, edge_setup, one_surface, \
    pixel_grid
from .surface import build_surfaces

WHITE8 = (255, 255, 255, int(BlendMode.OPAQUE))


def sample_texture8(atlas: TextureAtlas8, tid, u, v):
    """Texture::sample (types.rs:1242): rem_euclid wrap, nearest texel at
    (u, 1 - v).  Returns (r8, g8, b8, blend) i32; lanes of tid < 0 read
    texture 0 (the caller overrides them)."""
    word = atlas.data[_texel_index(atlas, torch.clamp(tid, min=0).long(),
                                   u, v).long()]
    return (word & 0xFF, (word >> 8) & 0xFF, (word >> 16) & 0xFF,
            (word >> 24) & 0xFF)


def blend8(fr, fg, fb_, br, bg, bb, mode):
    """Color::blend_with in 8-bit space (types.rs:886-930): the front
    (fr, fg, fb_) over the back (br, bg, bb) in BlendMode `mode`."""
    out = []
    for f, b in ((fr, br), (fg, bg), (fb_, bb)):
        c = torch.where(mode == int(BlendMode.AVERAGE), (b + f) >> 1,
            torch.where(mode == int(BlendMode.ADD),
                        torch.clamp(b + f, max=255),
            torch.where(mode == int(BlendMode.SUBTRACT),
                        torch.clamp(b - f, min=0),
            torch.where(mode == int(BlendMode.ADD_QUARTER),
                        torch.clamp(b + (f >> 2), max=255), f))))
        out.append(torch.where(mode == int(BlendMode.ERASE),
                               torch.zeros_like(c), c))
    return tuple(out)


def raster_one8(color, depth, s: OneSurface, atlas: TextureAtlas8,
                settings: RasterSettings, grid):
    """One surface per instance over the whole frame (render.rs:
    1202-1432).  Returns (colour, depth)."""
    height, width = color.shape[1:]
    bc_x, bc_y, bc_z, covered = edge_setup(s.vx, s.vy, s.area, s.inv_area,
                                           grid, width, height)
    izi = (bc_x * s.iz[0] + bc_y * s.iz[1]) + bc_z * s.iz[2]
    z = torch.where(izi == 0, torch.full_like(izi, F32_MAX),
                    torch.ones_like(izi) / torch.where(
                        izi == 0, torch.ones_like(izi), izi))

    u, v = px.uv_at(bc_x, bc_y, bc_z, s.uv, s.iz, izi, settings)
    textured = s.tid >= 0
    texel = sample_texture8(atlas, s.tid, u, v)
    tr, tg, tb, tblend = (torch.where(textured, t, torch.full_like(t, w))
                          for t, w in zip(texel, WHITE8))

    if settings.shading == ShadingMode.NONE:
        shade = (torch.ones_like(bc_x),) * 3
    elif settings.shading == ShadingMode.FLAT:
        shade = s.shade[0]
    else:
        shade = tuple(px.interp3(bc_x, bc_y, bc_z, s.shade[0][c],
                                 s.shade[1][c], s.shade[2][c])
                      for c in range(3))
    offset = col.dither_offset(grid[2], grid[3])
    front = []
    for c, t8 in enumerate((tr, tg, tb)):
        # interpolated vertex colour with truncating casts
        # (render.rs:1356-1362), modulation (types.rs:801), shading
        # (render.rs:1074) and the optional dither (render.rs:1186)
        v8 = px.u8_trunc_sat(px.interp3(
            bc_x, bc_y, bc_z, *(s.vc[k][c].to(torch.float32)
                                for k in range(3))))
        shaded = f32_to_i32(torch.trunc(torch.clamp(
            col.modulate8(t8, v8).to(torch.float32) * shade[c], max=255.0)))
        front.append(torch.where(
            s.needs_dither, col.dither_and_quantize8(shaded, offset) << 3,
            shaded))

    back = col.unpack_rgba8(color)[:3]
    out = blend8(*front, *back, tblend)
    # editor alpha: an f32 lerp with the blend's result (render.rs:398-409);
    # a tensor divisor, so that the card divides too
    a = s.editor_alpha.to(torch.float32) / torch.tensor(
        255.0, dtype=torch.float32, device=color.device)
    inv = 1.0 - a
    use_lerp = s.editor_alpha < 255
    out = [torch.where(use_lerp, f32_to_i32(torch.trunc(
        o.to(torch.float32) * a + b.to(torch.float32) * inv)), o)
        for o, b in zip(out, back)]
    word = col.pack_rgba8(out[0], out[1], out[2],
                          torch.full_like(out[0], 255))

    drawn = (covered & (tblend != int(BlendMode.ERASE)) & s.valid
             & (s.editor_alpha > 0))
    if settings.use_zbuffer:
        drawn = drawn & (z < depth)
        depth = torch.where(drawn, z, depth)
    return torch.where(drawn, word, color), depth


def draw_order8(surfaces, settings: RasterSettings):
    """(I, T) draw sequence: the valid surfaces in face order, or back to
    front by centroid z without a z-buffer (render.rs:2154), then the
    invalid ones; every sort stable, as the JAX package's lexsort on
    (invalid last, -centroid z, index).  Moving the invalid surfaces
    last changes nothing drawn, and lets the loop stop after the valid
    ones."""
    invalid = (~surfaces.valid).to(torch.int32)
    if settings.use_zbuffer:
        return _lexsort([invalid])
    return _lexsort([invalid, -surfaces.centroid_z])


def render_mesh8(fb: FrameBuffers, mesh, faces, atlas8: TextureAtlas8,
                 cams, lights, fog, settings: RasterSettings
                 ) -> FrameBuffers:
    """render_mesh (render.rs:1971), the 8-bit pipeline, into (I, H, W)
    framebuffers, one camera of `cams` ((I,) CameraArrays) each.  The
    surface build reads only the textures' blend modes, which atlas8
    carries as a 15-bit atlas does.  The loop runs to the most valid
    surfaces any instance has (read once on the host)."""
    height, width = fb.color.shape[1:]
    surfaces = build_surfaces(mesh, faces, atlas8, cams, lights, fog,
                              settings, width, height)
    order = draw_order8(surfaces, settings)
    grid = pixel_grid(height, width, fb.color.device)
    color, depth = fb.color, fb.depth
    for i in range(int(surfaces.valid.sum(1).max())):
        s = one_surface(surfaces, order[:, i])
        color, depth = raster_one8(color, depth, s, atlas8, settings, grid)
    return FrameBuffers(color=color, depth=depth)
