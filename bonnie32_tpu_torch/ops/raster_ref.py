"""The sequential masked compositor (bonnie32_tpu/ops/raster_ref.py):
`rasterize_triangle_15` (render.rs:1440-1714) and the two-pass DRAW phase
(render.rs:2547-2570) as a loop over the surfaces in draw order, each
evaluated over the whole frame with masks, batched over instances (each
instance walks its own draw order).  O(T * H * W): the correctness path of
the sequential renderer; raster_fast.py is its throughput path.

Depth, by `depth_mode`:
  * "harmonic": the buffer holds z = 1 / interp(1/z), an IEEE division
    per pixel (the literal reference, render.rs:1545-1550); cleared to
    F32_MAX, test `z < buf`;
  * "inv": the buffer holds interp(1/z); cleared to 0, test `izi > buf`.

The edge functions are evaluated directly per pixel (the reference steps
them incrementally); with the PS1 fixed-point projection every term is a
small integer in f32 and both forms agree exactly.  The JAX package's
exact_recip (an f64 residual correction for the TPU's divide) is torch's
IEEE division here, with the divisor a tensor.
"""

from typing import NamedTuple

import numpy as np
import torch

from ..config import BlendMode, RasterSettings
from ..types import FrameBuffers, Surfaces, TextureAtlas, resolve_device
from . import color as col
from . import pixel as px
from .fixed import f32_to_i32
from .surface import draw_order

F32_MAX = float(np.finfo(np.float32).max)
COVER_EPS = -0.0001          # render.rs:1541


def new_framebuffer(height: int, width: int, depth_mode: str = "harmonic",
                    clear_color: int = 0, n: int = 1,
                    device=None) -> FrameBuffers:
    """Framebuffer::new + clear (render.rs:18-45) for `n` instances:
    colour `clear_color` (an RGBA8 word), depth F32_MAX ("harmonic") or 0
    ("inv").  `device` defaults to the card."""
    device = resolve_device(device)
    word = clear_color - (1 << 32) if clear_color >= (1 << 31) else clear_color
    depth0 = F32_MAX if depth_mode == "harmonic" else 0.0
    shape = (n, height, width)
    return FrameBuffers(
        color=torch.full(shape, word, dtype=torch.int32, device=device),
        depth=torch.full(shape, depth0, dtype=torch.float32, device=device))


def clear_color_word(r: int, g: int, b: int, a: int = 255) -> int:
    return ((r & 0xFF) | ((g & 0xFF) << 8) | ((b & 0xFF) << 16)
            | ((a & 0xFF) << 24))


def pixel_grid(height: int, width: int, device):
    """(px, py, xi, yi): pixel coordinates as f32 and i32, shaped
    (1, 1, W) and (1, H, 1) to broadcast over (I, H, W)."""
    yi = torch.arange(height, dtype=torch.int32, device=device)[None, :, None]
    xi = torch.arange(width, dtype=torch.int32, device=device)[None, None, :]
    return xi.to(torch.float32), yi.to(torch.float32), xi, yi


def edge_setup(vx, vy, area, inv_area, grid, width: int, height: int):
    """Bounding box with Rust's casts (render.rs:1455-1458) and the edge
    functions (render.rs:1499-1545) of triangles with corners (vx[k],
    vy[k]), each broadcasting against the grid's planes: (bc_x, bc_y,
    bc_z, covered)."""
    pxf, pyf, xi, yi = grid
    v1x, v2x, v3x = vx
    v1y, v2y, v3y = vy
    zero = torch.zeros_like(v1x)
    min_xf = torch.maximum(torch.minimum(torch.minimum(v1x, v2x), v3x), zero)
    max_xf = torch.minimum(torch.maximum(torch.maximum(v1x, v2x), v3x) + 1.0,
                           torch.full_like(v1x, float(width)))
    min_yf = torch.maximum(torch.minimum(torch.minimum(v1y, v2y), v3y), zero)
    max_yf = torch.minimum(torch.maximum(torch.maximum(v1y, v2y), v3y) + 1.0,
                           torch.full_like(v1y, float(height)))
    bbox = ((xi >= f32_to_i32(torch.trunc(min_xf)))
            & (xi < torch.clamp(f32_to_i32(torch.trunc(max_xf)), min=0))
            & (yi >= f32_to_i32(torch.trunc(min_yf)))
            & (yi < torch.clamp(f32_to_i32(torch.trunc(max_yf)), min=0)))
    degenerate = area.abs() < 0.00001
    a0 = v2y - v3y
    b0 = v3x - v2x
    a1 = v3y - v1y
    b1 = v1x - v3x
    w0 = a0 * (pxf - v3x) + b0 * (pyf - v3y)
    w1 = a1 * (pxf - v3x) + b1 * (pyf - v3y)
    bc_x = w0 * inv_area
    bc_y = w1 * inv_area
    bc_z = (1.0 - bc_x) - bc_y
    inside = (bc_x >= COVER_EPS) & (bc_y >= COVER_EPS) & (bc_z >= COVER_EPS)
    return bc_x, bc_y, bc_z, bbox & inside & ~degenerate


class OneSurface(NamedTuple):
    """One surface per instance, every value shaped (I, 1, 1); corner
    values as 3-tuples (of (u, v) or (r, g, b) tuples)."""

    vx: tuple
    vy: tuple
    iz: tuple
    area: torch.Tensor
    inv_area: torch.Tensor
    uv: tuple
    vc: tuple
    shade: tuple
    tid: torch.Tensor
    blend_mode: torch.Tensor
    black_transparent: torch.Tensor
    editor_alpha: torch.Tensor
    needs_dither: torch.Tensor
    valid: torch.Tensor


def one_surface(surfaces: Surfaces, idx, live=None) -> OneSurface:
    """Surface idx[i] (idx (I,) i64) of every instance i; `live` (I,)
    bool masks instances out (their surface is invalid)."""
    inst = torch.arange(idx.shape[0], device=idx.device)

    def per(f):                      # (I, T, ...) or (T,) -> (I, ...)
        v = f[idx] if f.dim() == 1 else f[inst, idx]
        return v.reshape(v.shape[:1] + (1, 1) + v.shape[1:])

    def corners(f):
        v = per(f)
        return tuple(v[..., k] for k in range(3))

    def corner_rows(f):
        v = per(f)
        return tuple(tuple(v[..., k, c] for c in range(v.shape[-1]))
                     for k in range(3))

    valid = per(surfaces.valid)
    if live is not None:
        valid = valid & live[:, None, None]
    return OneSurface(
        vx=corners(surfaces.sx), vy=corners(surfaces.sy),
        iz=corners(surfaces.inv_z), area=per(surfaces.area),
        inv_area=per(surfaces.inv_area), uv=corner_rows(surfaces.uv),
        vc=corner_rows(surfaces.vc), shade=corner_rows(surfaces.shade),
        tid=per(surfaces.tex_id), blend_mode=per(surfaces.blend_mode),
        black_transparent=per(surfaces.black_transparent),
        editor_alpha=per(surfaces.editor_alpha),
        needs_dither=per(surfaces.needs_dither), valid=valid)


def raster_one(color, depth, s: OneSurface, skip_z, atlas: TextureAtlas,
               settings: RasterSettings, grid, depth_mode: str):
    """Rasterize one surface per instance over the whole frame
    (rasterize_triangle_15); skip_z (I, 1, 1) bool: the transparent pass,
    which writes no depth.  Returns (colour, depth)."""
    height, width = color.shape[1:]
    bc_x, bc_y, bc_z, covered = edge_setup(s.vx, s.vy, s.area, s.inv_area,
                                           grid, width, height)
    covered = covered & s.valid
    # depth (render.rs:1545-1550): interpolate 1/z
    izi = (bc_x * s.iz[0] + bc_y * s.iz[1]) + bc_z * s.iz[2]
    if depth_mode == "harmonic":
        z = torch.ones_like(izi) / izi
        zpass = z < depth
        depth_new = z
    else:
        zpass = izi > depth
        depth_new = izi
    zbuffer_active = settings.use_zbuffer and not settings.xray_mode
    vis = covered & zpass if zbuffer_active else covered

    # the shared pixel pipeline (render.rs:1563-1661)
    pc = px.pixel_color(bc_x, bc_y, bc_z, izi, s.iz, s.uv, s.vc, s.shade,
                        s.tid, s.black_transparent, s.needs_dither,
                        grid[2], grid[3], atlas, settings)
    front = (pc.r8, pc.g8, pc.b8)
    drawn = vis & ~pc.keyed_out & (s.editor_alpha != 0)
    back = col.unpack_rgba8(color)[:3]
    if settings.xray_mode:
        # 50% blend, no depth interaction (render.rs:507-526)
        out = [(f + b) >> 1 for f, b in zip(front, back)]
        zwrite = torch.zeros_like(drawn)
    else:
        # the PS1 blend where STP is set and the mode is not opaque
        # (render.rs:1689, 1697), then the editor-alpha lerp
        # (render.rs:564-628), integer path
        do_blend = pc.semi & (s.blend_mode != int(BlendMode.OPAQUE))
        blended = col.blend_rgb555(front, back, s.blend_mode)
        ps1 = [torch.where(do_blend, bl, f) for bl, f in zip(blended, front)]
        a = s.editor_alpha
        use_ea = a < 255
        out = [torch.where(use_ea, (p * a + b * (255 - a)) // 255, p)
               for p, b in zip(ps1, back)]
        zwrite = drawn & settings.use_zbuffer & ~skip_z
    word = col.pack_rgba8(out[0], out[1], out[2],
                          torch.full_like(out[0], 255))
    return (torch.where(drawn, word, color),
            torch.where(zwrite, depth_new, depth))


def rasterize_surfaces(fb: FrameBuffers, surfaces: Surfaces,
                       atlas: TextureAtlas, settings: RasterSettings,
                       depth_mode: str = "harmonic") -> FrameBuffers:
    """The DRAW phase (render.rs:2547-2570), the sequential two-pass
    composite, of every instance's surfaces in its own draw order.  The
    invalid surfaces come last in every order and draw nothing, so the
    loop stops after the most valid ones any instance has (read once on
    the host)."""
    if depth_mode not in ("harmonic", "inv"):
        raise ValueError(f"unknown depth mode {depth_mode!r}")
    height, width = fb.color.shape[1:]
    order, skip_z = draw_order(surfaces, settings)
    grid = pixel_grid(height, width, fb.color.device)
    color, depth = fb.color, fb.depth
    for i in range(int(surfaces.valid.sum(1).max())):
        s = one_surface(surfaces, order[:, i])
        color, depth = raster_one(color, depth, s, skip_z[:, i, None, None],
                                  atlas, settings, grid, depth_mode)
    return FrameBuffers(color=color, depth=depth)
