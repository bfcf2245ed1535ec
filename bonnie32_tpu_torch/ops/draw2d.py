"""2D framebuffer drawing (bonnie32_tpu/ops/draw2d.py): clears, rects,
circles, lines (plain, alpha, thick), and the clipped 3D grid and line
helpers the editors draw their overlays with.

Reference behavior: the Framebuffer methods of the reference's
`src/rasterizer/render.rs` (clear :36, clear_gradient :60, draw_circle
:631, set_pixel_alpha :646, draw_circle_alpha :670, draw_line_alpha :684,
draw_thick_line :875, draw_rect :941, draw_filled_rect :954) and
`src/rasterizer/draw.rs` (draw_3d_line_clipped :12, draw_floor_grid :81,
create_test_cube :138).

On (I, H, W) framebuffers.  A 2D primitive draws the same thing into
every instance; the 3D helpers take CameraArrays with one camera per
instance ((I, 3) and (I, 3, 3); one camera broadcasts over the
instances).  Per-pixel loops become full-frame masks; opaque one-colour
line batches scatter through the closed-form Bresenham strips of
ops/wireframe.py at once (one colour, so the order of the writes does not
matter); alpha lines go one line after the other, because each blends
over what the earlier ones wrote.  Every function returns new tensors
and leaves its input framebuffer as it was.

Card and CPU agree bit for bit: the float expressions are the JAX
package's, one torch op per rounding (no contraction), every divisor a
tensor, float -> int casts through ops/fixed.f32_to_i32.
"""

from typing import Tuple

import numpy as np
import torch

from ..config import NEAR_PLANE
from ..types import (CameraArrays, FrameBuffers, as_f32, device_of,
                     f32_scalar)
from .color import pack_rgb, pack_rgba8, unpack_rgba8
from .fixed import f32_to_i32, sqrt_rn
from .picking import world_to_screen
from .vertex import perspective_transform
from .wireframe import line_pixels, scatter_lines

_F32 = torch.float32
_I32 = torch.int32
F32_MAX = float(np.finfo(np.float32).max)
MAX_STEPS = 384
DEPTH_BIAS_3D_ALPHA = 0.995  # render.rs:827


def _f32(v) -> float:
    """A Python number rounded to f32 (JAX's `_F32(v)`)."""
    return float(np.float32(v))


def _grid(fb: FrameBuffers):
    """(xs (1, W), ys (H, 1)) i32 pixel coordinates."""
    h, w = fb.color.shape[-2:]
    dev = fb.color.device
    return (torch.arange(w, dtype=_I32, device=dev)[None, :],
            torch.arange(h, dtype=_I32, device=dev)[:, None])


def _paint(fb: FrameBuffers, mask, word: int) -> FrameBuffers:
    """`word` where the (H, W) mask holds, in every instance."""
    return FrameBuffers(color=torch.where(
        mask, torch.full((), word, dtype=_I32, device=fb.color.device),
        fb.color), depth=fb.depth)


def _blend(fb: FrameBuffers, mask, rgb, alpha) -> FrameBuffers:
    return FrameBuffers(color=torch.where(
        mask, _alpha_blend_words(fb.color, rgb, alpha), fb.color),
        depth=fb.depth)


def _i32(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=_I32)
    return torch.as_tensor(np.asarray(x, np.int32), device=device)


def clear(fb: FrameBuffers, rgb: Tuple[int, int, int],
          alpha: int = 255) -> FrameBuffers:
    """render.rs:36: solid colour + depth reset."""
    word = (rgb[0] | (rgb[1] << 8) | (rgb[2] << 16) | (alpha << 24))
    word = word - (1 << 32) if word >= (1 << 31) else word
    return FrameBuffers(color=torch.full_like(fb.color, word),
                        depth=torch.full_like(fb.depth, F32_MAX))


def clear_transparent(fb: FrameBuffers) -> FrameBuffers:
    """render.rs:48."""
    return FrameBuffers(color=torch.zeros_like(fb.color),
                        depth=torch.full_like(fb.depth, F32_MAX))


def clear_gradient(fb: FrameBuffers, top: Tuple[int, int, int],
                   bottom: Tuple[int, int, int]) -> FrameBuffers:
    """render.rs:60: vertical lerp, truncating casts (Color::lerp):
    trunc(top (1 - t) + bottom t), one op per rounding."""
    h = fb.color.shape[-2]
    dev = fb.color.device
    t = (torch.arange(h, dtype=_F32, device=dev)
         / f32_scalar(max(h - 1, 1), dev))[:, None]                    # (H, 1)
    top_a = torch.tensor(top, dtype=_F32, device=dev)[None]
    bot_a = torch.tensor(bottom, dtype=_F32, device=dev)[None]
    rgb = f32_to_i32(torch.trunc(top_a * (1.0 - t) + bot_a * t))  # (H, 3)
    words = pack_rgba8(rgb[:, 0], rgb[:, 1], rgb[:, 2],
                       torch.full_like(rgb[:, 0], 255))
    return FrameBuffers(color=words[:, None].expand(fb.color.shape).clone(),
                        depth=torch.full_like(fb.depth, F32_MAX))


def _alpha_blend_words(back_words, rgb: Tuple[int, int, int], alpha):
    """set_pixel_alpha (render.rs:646): integer blend, result alpha 255."""
    br, bg, bb, _ = unpack_rgba8(back_words)
    a = int(alpha)
    inv = 255 - a

    def ch(c, back):
        return torch.div(c * a + back * inv, 255, rounding_mode="floor")
    r, g, b = ch(rgb[0], br), ch(rgb[1], bg), ch(rgb[2], bb)
    return pack_rgba8(r, g, b, torch.full_like(r, 255))


def draw_filled_rect(fb: FrameBuffers, x0: int, y0: int, x1: int, y1: int,
                     rgb, alpha: int = 255) -> FrameBuffers:
    """render.rs:954 (plus the alpha variant the selection overlays
    use)."""
    xs, ys = _grid(fb)
    lo_x, hi_x = min(int(x0), int(x1)), max(int(x0), int(x1))
    lo_y, hi_y = min(int(y0), int(y1)), max(int(y0), int(y1))
    inside = (xs >= lo_x) & (xs <= hi_x) & (ys >= lo_y) & (ys <= hi_y)
    if alpha == 255:
        return _paint(fb, inside, pack_rgb(tuple(rgb)))
    return _blend(fb, inside, rgb, alpha)


def draw_filled_triangle(fb: FrameBuffers, x0, y0, x1, y1, x2, y2, rgb,
                         alpha: int = 255, clip=None) -> FrameBuffers:
    """2D UI triangle fill (macroquad draw_triangle as grid_view.rs's
    sector fills use it).  Winding-agnostic edge-function test at pixel
    centres; optional (x0, y0, x1, y1) scissor rect."""
    xs, ys = _grid(fb)
    dev = fb.color.device
    px = xs.to(_F32) + 0.5
    py = ys.to(_F32) + 0.5
    ax, ay, bx, by, cx, cy = [f32_scalar(v, dev)
                              for v in (x0, y0, x1, y1, x2, y2)]
    area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
    sgn = torch.where(area < 0.0, f32_scalar(-1.0, dev), f32_scalar(1.0, dev))
    e0 = ((bx - ax) * (py - ay) - (by - ay) * (px - ax)) * sgn
    e1 = ((cx - bx) * (py - by) - (cy - by) * (px - bx)) * sgn
    e2 = ((ax - cx) * (py - cy) - (ay - cy) * (px - cx)) * sgn
    inside = (e0 >= 0.0) & (e1 >= 0.0) & (e2 >= 0.0)
    inside = inside & (area.abs() > 1e-6)
    if clip is not None:
        inside = inside & _clip_mask(xs, ys, clip)
    if alpha >= 255:
        return _paint(fb, inside, pack_rgb(tuple(rgb)))
    return _blend(fb, inside, rgb, alpha)


def draw_filled_triangle_scanline(fb: FrameBuffers, p0, p1, p2,
                                  rgb) -> FrameBuffers:
    """Gizmo triangle fill (editor/viewport_3d.rs:6295-6356
    draw_filled_triangle_3d): y-sorted scanline fill over integer screen
    coordinates, deliberately not z-tested ("ignore z, we don't z-test
    gizmos").  Per-row ax/bx use the reference's alpha/beta edge
    interpolation and `as i32` truncation, vectorized over rows."""
    pts = sorted([(int(p0[0]), int(p0[1])), (int(p1[0]), int(p1[1])),
                  (int(p2[0]), int(p2[1]))], key=lambda p: p[1])
    (x0, y0), (x1, y1), (x2, y2) = pts
    if y2 == y0:
        return fb
    xs, _ = _grid(fb)
    height, width = fb.color.shape[-2:]
    dev = fb.color.device
    yv = torch.arange(height, dtype=_F32, device=dev)
    total = f32_scalar(y2 - y0, dev)
    second = ((yv > _f32(y1)) if y1 != y0
              else torch.ones(height, dtype=torch.bool, device=dev))
    seg = torch.where(second, f32_scalar(y2 - y1, dev),
                      f32_scalar(y1 - y0, dev))
    safe_seg = torch.where(seg == 0.0, f32_scalar(1.0, dev), seg)
    alpha_t = (yv - _f32(y0)) / total
    beta = torch.where(second, yv - _f32(y1), yv - _f32(y0)) / safe_seg
    ax = _f32(x0) + _f32(x2 - x0) * alpha_t
    bx = torch.where(second, _f32(x1) + _f32(x2 - x1) * beta,
                     _f32(x0) + _f32(x1 - x0) * beta)
    lo = torch.minimum(ax, bx)
    hi = torch.maximum(ax, bx)
    x_start = torch.clamp(f32_to_i32(torch.trunc(lo)), min=0)
    x_end = torch.clamp(f32_to_i32(torch.trunc(hi)), max=width - 1)
    row_ok = ((yv >= _f32(max(y0, 0))) & (yv <= _f32(min(y2, height - 1)))
              & (seg != 0.0))
    inside = (row_ok[:, None] & (xs >= x_start[:, None])
              & (xs <= x_end[:, None]))
    return _paint(fb, inside, pack_rgb(tuple(rgb)))


def draw_rect(fb: FrameBuffers, x0: int, y0: int, x1: int, y1: int,
              rgb) -> FrameBuffers:
    """render.rs:941: outline (four axis-aligned 1px edges)."""
    xs, ys = _grid(fb)
    lo_x, hi_x = min(int(x0), int(x1)), max(int(x0), int(x1))
    lo_y, hi_y = min(int(y0), int(y1)), max(int(y0), int(y1))
    in_box = (xs >= lo_x) & (xs <= hi_x) & (ys >= lo_y) & (ys <= hi_y)
    on_edge = in_box & ((xs == lo_x) | (xs == hi_x)
                        | (ys == lo_y) | (ys == hi_y))
    return _paint(fb, on_edge, pack_rgb(tuple(rgb)))


def _clip_mask(xs, ys, clip):
    """AND-mask of an optional (x0, y0, x1, y1) scissor rect."""
    cl, ct, cr, cb = clip
    return ((xs >= int(cl)) & (xs < int(cr))
            & (ys >= int(ct)) & (ys < int(cb)))


def _d2(fb, cx, cy):
    """dx^2 + dy^2 in i32 (wrapping as the JAX package's i32 does)."""
    xs, ys = _grid(fb)
    dx = xs - int(cx)
    dy = ys - int(cy)
    return xs, ys, dx * dx + dy * dy


def draw_circle_outline(fb: FrameBuffers, cx, cy, radius, rgb,
                        thickness: int = 1, clip=None) -> FrameBuffers:
    """draw_circle_lines: a ring, r - thickness < dist <= r."""
    xs, ys, d2 = _d2(fb, cx, cy)
    r = int(radius)
    inner = max(r - int(thickness), 0)
    on_ring = (d2 <= r * r) & (d2 > inner * inner)
    if clip is not None:
        on_ring = on_ring & _clip_mask(xs, ys, clip)
    return _paint(fb, on_ring, pack_rgb(tuple(rgb)))


def draw_circle(fb: FrameBuffers, cx, cy, radius, rgb,
                alpha=None, clip=None) -> FrameBuffers:
    """render.rs:631 / draw_circle_alpha :670: dx^2 + dy^2 <= r^2 fill."""
    xs, ys, d2 = _d2(fb, cx, cy)
    r = int(radius)
    inside = d2 <= r * r
    if clip is not None:
        inside = inside & _clip_mask(xs, ys, clip)
    if alpha is None:
        return _paint(fb, inside, pack_rgb(tuple(rgb)))
    return _blend(fb, inside, rgb, alpha)


def draw_thick_line(fb: FrameBuffers, x0, y0, x1, y1, thickness: int,
                    rgb) -> FrameBuffers:
    """render.rs:875: convex-quad fill with half-thickness perpendicular
    offsets; pixel centres at +0.5."""
    if thickness <= 1:
        return draw_lines(fb, [[int(x0), int(x1)]], [[int(y0), int(y1)]],
                          rgb)
    dev = fb.color.device
    x0f, y0f, x1f, y1f = [f32_scalar(v, dev) for v in (x0, y0, x1, y1)]
    dx = x1f - x0f
    dy = y1f - y0f
    ln = sqrt_rn(dx * dx + dy * dy)
    degenerate = ln < 0.001
    ln = torch.where(degenerate, f32_scalar(1.0, dev), ln)
    half = _f32(thickness * 0.5)
    px = -dy / ln * half
    py = dx / ln * half
    corners = [(x0f + px, y0f + py), (x0f - px, y0f - py),
               (x1f - px, y1f - py), (x1f + px, y1f + py)]
    xs, ys = _grid(fb)
    pxc = xs.to(_F32) + 0.5
    pyc = ys.to(_F32) + 0.5
    inside = ~degenerate
    for i in range(4):
        a = corners[i]
        b = corners[(i + 1) % 4]
        cross = ((b[0] - a[0]) * (pyc - a[1]) - (b[1] - a[1]) * (pxc - a[0]))
        inside = inside & (cross >= 0.0)
    return _paint(fb, inside, pack_rgb(tuple(rgb)))


def _strips(fb: FrameBuffers, ex, ey, valid, max_steps: int):
    """The Bresenham strips of segments ex/ey ((E, 2), or (I, E, 2) one
    set per instance): (pixel index (I', E, K) into each instance's plane
    plus one padding slot, the masked steps there, and the strips' t)."""
    height, width = fb.color.shape[-2:]
    dev = fb.color.device
    ex = _i32(ex, dev)
    ey = _i32(ey, dev)
    xs, ys, t, ok = line_pixels(ex[..., 0], ey[..., 0], ex[..., 1],
                                ey[..., 1], width, height, max_steps)
    if valid is not None:
        ok = ok & torch.as_tensor(valid, device=dev)[..., None]
    ok = ok & (xs >= 0) & (xs < width) & (ys >= 0) & (ys < height)
    pix = torch.where(ok, ys.long() * width + xs.long(),
                      torch.full_like(xs, height * width, dtype=torch.long))
    if pix.dim() == 2:
        pix = pix[None]
    return pix, t


def _padded(color):
    """(I, H*W + 1) copy of the colour planes with one padding slot."""
    n = color.shape[0]
    return torch.cat([color.reshape(n, -1),
                      torch.zeros(n, 1, dtype=color.dtype,
                                  device=color.device)], dim=1)


def _unpad(buf, fb: FrameBuffers) -> FrameBuffers:
    return FrameBuffers(color=buf[:, :-1].reshape(fb.color.shape),
                        depth=fb.depth)


def draw_lines(fb: FrameBuffers, ex, ey, rgb, valid=None,
               max_steps: int = MAX_STEPS) -> FrameBuffers:
    """Batched opaque Bresenham lines, one colour (render.rs:715 per
    line).  ex/ey: (E, 2) i32 endpoints, the same in every instance, or
    (I, E, 2), one set per instance.  One colour, so overlapping writes
    agree and all lines scatter at once."""
    pix, _ = _strips(fb, ex, ey, valid, max_steps)
    n = fb.color.shape[0]
    buf = _padded(fb.color)
    buf.scatter_(1, pix.reshape(pix.shape[0], -1).expand(n, -1),
                 pack_rgb(tuple(rgb)))
    return _unpad(buf, fb)


def draw_lines_alpha(fb: FrameBuffers, ex, ey, rgb, alpha, valid=None,
                     max_steps: int = MAX_STEPS) -> FrameBuffers:
    """Alpha-blended lines (render.rs:684), one after the other: a line
    blends over whatever is drawn, the earlier lines of the batch
    included.  One line never revisits a pixel, so each of its steps
    blends once."""
    pix, _ = _strips(fb, ex, ey, valid, max_steps)
    n = fb.color.shape[0]
    buf = _padded(fb.color)
    for e in range(pix.shape[1]):
        idx = pix[:, e].expand(n, -1)
        back = buf.gather(1, idx)
        buf.scatter_(1, idx, _alpha_blend_words(back, rgb, alpha))
    return _unpad(buf, fb)


def draw_lines_3d_alpha(fb: FrameBuffers, ex, ey, ez, rgb, alpha,
                        valid=None, depth_mode: str = "harmonic",
                        max_steps: int = MAX_STEPS) -> FrameBuffers:
    """Depth-tested alpha-blended 3D lines (render.rs:822): endpoint z
    scaled by 0.995 to out-bias co-planar geometry, a `<=` depth test
    (harmonic z; `>=` on an inverse-z plane), no depth write.  ex/ey/ez
    (E, 2) or (I, E, 2).  At alpha 255 the blend gives the line's colour
    whatever lies behind it, so the batch is one scatter; below, the
    lines go one after the other because overlapping writes compose."""
    n, height, width = fb.color.shape
    dev = fb.color.device
    ex = _i32(ex, dev).expand(n, -1, -1)
    ey = _i32(ey, dev).expand(n, -1, -1)
    ez = (as_f32(ez, dev) * _f32(DEPTH_BIAS_3D_ALPHA)).expand(n, -1, -1)
    v = (torch.ones(ex.shape[:2], dtype=torch.bool, device=dev)
         if valid is None else
         torch.as_tensor(valid, device=dev).expand(ex.shape[:2]))
    buf = fb.color.reshape(-1)
    buf = torch.cat([buf, buf.new_zeros(1)])
    if alpha >= 255:
        scatter_lines(buf, fb.depth, ex, ey, ez, v, pack_rgb(tuple(rgb)),
                       max_steps, True, 0, depth_mode, inclusive=True)
        return FrameBuffers(color=buf[:-1].reshape(n, height, width),
                            depth=fb.depth)
    xs, ys, t, ok = line_pixels(ex[..., 0], ey[..., 0], ex[..., 1],
                                ey[..., 1], width, height, max_steps)
    z = ez[..., 0:1] + t * (ez[..., 1:2] - ez[..., 0:1])        # (I, E, K)
    ok = (ok & v[..., None] & (xs >= 0) & (xs < width) & (ys >= 0)
          & (ys < height))
    inst = torch.arange(n, device=dev)[:, None, None]
    pix = (inst * height + ys.long()) * width + xs.long()
    plane = fb.depth.reshape(-1)[torch.where(ok, pix,
                                             torch.zeros_like(pix))]
    if depth_mode == "harmonic":
        ok = ok & (z <= plane)
    else:
        izl = torch.where(z > 0.0, torch.ones_like(z) / z,
                          torch.full_like(z, float("-inf")))
        ok = ok & (izl >= plane)
    pix = torch.where(ok, pix, torch.full_like(pix, n * height * width))
    for e in range(pix.shape[1]):
        idx = pix[:, e].reshape(-1)
        buf[idx] = _alpha_blend_words(buf[idx], rgb, alpha)
    return FrameBuffers(color=buf[:-1].reshape(n, height, width),
                        depth=fb.depth)


# ---------------------------------------------------------------------------
# 3D overlay helpers (draw.rs)
# ---------------------------------------------------------------------------

def _cams(camera: CameraArrays, device, n: int = 1) -> CameraArrays:
    """Cameras as (I, 3) and (I, 3, 3) f32 tensors on `device`, one
    camera expanded to `n` instances."""
    pos = as_f32(camera.position, device).reshape(-1, 3)
    basis = as_f32(camera.basis, device).reshape(-1, 3, 3)
    if pos.shape[0] == 1 and n > 1:
        pos, basis = pos.expand(n, 3), basis.expand(n, 3, 3)
    return CameraArrays(position=pos, basis=basis)


def clip_segments_to_screen(p0, p1, camera: CameraArrays, width: int,
                            height: int):
    """draw_3d_line_clipped's transform half (draw.rs:12-67): camera-space
    near clip, then world_to_screen, of segments p0 -> p1 (E, 3) for each
    camera: ((I, E, 2) sx, sy i32, valid (I, E))."""
    dev = device_of(camera.position)
    cam = _cams(camera, dev)
    pos = cam.position[:, None, :]
    basis = cam.basis[:, None, :, :]
    p0 = as_f32(p0, dev)
    p1 = as_f32(p1, dev)
    rel0 = p0 - pos
    rel1 = p1 - pos
    bz = basis[..., 2, :]
    z0 = rel0[..., 0] * bz[..., 0] + rel0[..., 1] * bz[..., 1] \
        + rel0[..., 2] * bz[..., 2]
    z1 = rel1[..., 0] * bz[..., 0] + rel1[..., 1] * bz[..., 1] \
        + rel1[..., 2] * bz[..., 2]
    visible = ~((z0 <= NEAR_PLANE) & (z1 <= NEAR_PLANE))
    dz = z1 - z0
    denom = torch.where(dz.abs() < 1e-20, f32_scalar(1e-20, dev), dz)
    t = (_f32(NEAR_PLANE) - z0) / denom
    mid = p0 + t[..., None] * (p1 - p0)
    c0 = torch.where((z0 <= NEAR_PLANE)[..., None], mid, p0)
    c1 = torch.where((z1 <= NEAR_PLANE)[..., None], mid, p1)
    sx0, sy0, _, ok0 = world_to_screen(c0, pos, basis, width, height)
    sx1, sy1, _, ok1 = world_to_screen(c1, pos, basis, width, height)
    valid = visible & ok0 & ok1
    ex = f32_to_i32(torch.trunc(torch.stack([sx0, sx1], dim=-1)))
    ey = f32_to_i32(torch.trunc(torch.stack([sy0, sy1], dim=-1)))
    return ex, ey, valid


def draw_3d_lines_clipped(fb: FrameBuffers, p0, p1, camera: CameraArrays,
                          rgb) -> FrameBuffers:
    """Batched draw_3d_line_clipped (draw.rs:12), one colour a batch."""
    height, width = fb.color.shape[-2:]
    ex, ey, valid = clip_segments_to_screen(p0, p1, camera, width, height)
    return draw_lines(fb, ex, ey, rgb, valid=valid)


def draw_floor_grid(fb: FrameBuffers, camera: CameraArrays, y: float,
                    spacing: float, extent: float,
                    grid_rgb=(60, 60, 70), x_axis_rgb=(140, 60, 60),
                    z_axis_rgb=(60, 60, 140)) -> FrameBuffers:
    """draw.rs:81: short segments per cell for near-plane behaviour.

    Reference draw order: X-parallel lines (z-axis coloured at z=0), then
    Z-parallel (x-axis coloured at x=0).  Same-colour groups batch; the
    groups draw in the reference's order, so crossings resolve the
    same."""
    dev = fb.color.device
    n = int(extent / spacing)
    lines = torch.arange(-n, n + 1, dtype=_F32, device=dev) * _f32(spacing)
    starts = torch.arange(-n, n, dtype=_F32, device=dev) * _f32(spacing)
    ll, ss = torch.meshgrid(lines, starts, indexing="ij")
    ll = ll.reshape(-1)
    ss = ss.reshape(-1)
    se = torch.clamp(ss + _f32(spacing), max=_f32(extent))
    yv = torch.full_like(ll, _f32(y))
    is_axis = ll.abs() < 0.001
    xp0 = torch.stack([ss, yv, ll], dim=-1)
    xp1 = torch.stack([se, yv, ll], dim=-1)
    zp0 = torch.stack([ll, yv, ss], dim=-1)
    zp1 = torch.stack([ll, yv, se], dim=-1)
    height, width = fb.color.shape[-2:]
    cam = _cams(camera, dev)
    ex_x, ey_x, ok_x = clip_segments_to_screen(xp0, xp1, cam, width, height)
    ex_z, ey_z, ok_z = clip_segments_to_screen(zp0, zp1, cam, width, height)
    fb = draw_lines(fb, ex_x, ey_x, grid_rgb, valid=ok_x & ~is_axis)
    fb = draw_lines(fb, ex_x, ey_x, z_axis_rgb, valid=ok_x & is_axis)
    fb = draw_lines(fb, ex_z, ey_z, grid_rgb, valid=ok_z & ~is_axis)
    fb = draw_lines(fb, ex_z, ey_z, x_axis_rgb, valid=ok_z & is_axis)
    return fb


def create_test_cube():
    """draw.rs:138: 24-vertex neutral-colour test cube, 12 tris,
    texture 0, as golden-model-format (verts, faces) like
    EditableMesh.to_render_data_textured()."""
    positions = [
        (-1, -1, 1), (1, -1, 1), (1, 1, 1), (-1, 1, 1),        # front
        (-1, -1, -1), (-1, 1, -1), (1, 1, -1), (1, -1, -1),    # back
        (-1, 1, -1), (-1, 1, 1), (1, 1, 1), (1, 1, -1),        # top
        (-1, -1, -1), (1, -1, -1), (1, -1, 1), (-1, -1, 1),    # bottom
        (1, -1, -1), (1, 1, -1), (1, 1, 1), (1, -1, 1),        # right
        (-1, -1, -1), (-1, -1, 1), (-1, 1, 1), (-1, 1, -1),    # left
    ]
    normals = [(0, 0, 1), (0, 0, -1), (0, 1, 0), (0, -1, 0),
               (1, 0, 0), (-1, 0, 0)]
    uvs = [(0.0, 0.0), (1.0, 0.0), (1.0, 1.0), (0.0, 1.0)]
    verts = []
    faces = []
    for f in range(6):
        for i in range(4):
            verts.append(dict(pos=tuple(float(c)
                                        for c in positions[f * 4 + i]),
                              uv=uvs[i],
                              normal=tuple(float(c) for c in normals[f]),
                              color=(128, 128, 128), color_blend=0))
        b = f * 4
        for (a, c, d) in ((b, b + 1, b + 2), (b, b + 2, b + 3)):
            faces.append(dict(v0=a, v1=c, v2=d, tex_id=0,
                              black_transparent=True, blend_mode=0,
                              editor_alpha=255))
    return verts, faces


def draw_wireframe_cylinder(fb: FrameBuffers, camera: CameraArrays,
                            center, radius: float, height: float,
                            segments: int = 12,
                            rgb=(80, 255, 120),
                            depth_mode: str = "harmonic",
                            depth_test: str = "strict") -> FrameBuffers:
    """The player's collision-cylinder debug overlay
    (game/renderer.rs:984): depth-tested bottom and top circles and a
    vertical line every other segment (every segment when <= 8).  Lines
    never write depth.  depth_test "strict" (z < buf), "equal" (z <= buf)
    or "none", the editor camera preview's variant
    (editor/layout.rs:6444-6487 draw_preview_wireframe_cylinder, plain
    unclipped lines)."""
    dev = fb.color.device
    n, h, w = fb.color.shape
    cam = _cams(camera, dev, n)
    center = as_f32(center, dev)
    ang = (torch.arange(segments, dtype=_F32, device=dev)
           / f32_scalar(segments, dev) * _f32(2.0 * np.pi))
    bx = center[0] + _f32(radius) * torch.cos(ang)
    bz = center[2] + _f32(radius) * torch.sin(ang)
    bottom = torch.stack([bx, center[1].expand_as(bx), bz], dim=-1)
    top = torch.stack([bx, (center[1] + _f32(height)).expand_as(bx), bz],
                      dim=-1)
    pos = cam.position[:, None, :]
    basis = cam.basis[:, None, :, :]
    vs = _f32(min(w, h) / 2.0 * 0.75)
    hw, hh = _f32(w / 2.0), _f32(h / 2.0)

    def project(pts):
        c = perspective_transform(pts - pos, basis)        # (I, S, 3)
        cz = c[..., 2]
        ok = cz >= 0.1
        denom = torch.where(ok, cz + 5.0, torch.ones_like(cz))
        sx = (c[..., 0] * 4.0) / denom * vs + hw
        sy = (c[..., 1] * 4.0) / denom * vs + hh
        return (f32_to_i32(torch.trunc(sx)), f32_to_i32(torch.trunc(sy)),
                cz, ok)

    bsx, bsy, bz_, bok = project(bottom)
    tsx, tsy, tz_, tok = project(top)
    nxt = (torch.arange(segments, device=dev) + 1) % segments

    def ring(sx, sy, sz, ok):
        return (torch.stack([sx, sx[:, nxt]], dim=-1),
                torch.stack([sy, sy[:, nxt]], dim=-1),
                torch.stack([sz, sz[:, nxt]], dim=-1), ok & ok[:, nxt])

    word = pack_rgb(tuple(rgb))
    buf = torch.cat([fb.color.reshape(-1), fb.color.new_zeros(1)])
    tested = depth_test != "none"
    inclusive = depth_test == "equal"
    skip = 2 if segments > 8 else 1
    sel = torch.arange(0, segments, skip, device=dev)
    vertical = (torch.stack([bsx[:, sel], tsx[:, sel]], dim=-1),
                torch.stack([bsy[:, sel], tsy[:, sel]], dim=-1),
                torch.stack([bz_[:, sel], tz_[:, sel]], dim=-1),
                bok[:, sel] & tok[:, sel])
    for ex, ey, ez, ok in (ring(bsx, bsy, bz_, bok),
                           ring(tsx, tsy, tz_, tok), vertical):
        scatter_lines(buf, fb.depth, ex, ey, ez, ok, word, MAX_STEPS,
                       tested, 0, depth_mode, inclusive=inclusive)
    return FrameBuffers(color=buf[:-1].reshape(n, h, w), depth=fb.depth)


def _blit(fb: FrameBuffers, x: int, y: int, mh: int, mw: int, fill,
          clip=None) -> FrameBuffers:
    """Replace the window (x, y, mw, mh), clipped to the frame and to
    `clip`, by fill(window, sy0 - y, sx0 - x)."""
    height, width = fb.color.shape[-2:]
    cl, ct = (0, 0) if clip is None else (int(clip[0]), int(clip[1]))
    cr, cb = ((width, height) if clip is None
              else (int(clip[2]), int(clip[3])))
    sx0, sy0 = max(x, cl, 0), max(y, ct, 0)
    sx1, sy1 = min(x + mw, cr, width), min(y + mh, cb, height)
    if sx0 >= sx1 or sy0 >= sy1:
        return fb
    color = fb.color.clone()
    window = color[:, sy0:sy1, sx0:sx1]
    color[:, sy0:sy1, sx0:sx1] = fill(window, slice(sy0 - y, sy1 - y),
                                      slice(sx0 - x, sx1 - x))
    return FrameBuffers(color=color, depth=fb.depth)


def draw_mask(fb: FrameBuffers, x: int, y: int, mask, rgb,
              clip=None) -> FrameBuffers:
    """`rgb` where the host bool mask (h, w) placed at (x, y) holds,
    clipped to the frame and to `clip`: the write of draw_text and of
    ui/icons.draw_icon_centered."""
    mh, mw = mask.shape
    word = pack_rgb(tuple(int(c) & 0xFF for c in rgb))

    def fill(window, rows, cols):
        sub = torch.as_tensor(np.ascontiguousarray(mask[rows, cols]),
                              device=window.device)
        return torch.where(sub, torch.full((), word, dtype=window.dtype,
                                           device=window.device), window)
    return _blit(fb, int(x), int(y), mh, mw, fill, clip)


def draw_text(fb: FrameBuffers, x: int, y: int, s: str, rgb,
              scale: int = 1, clip=None) -> FrameBuffers:
    """Blit a one-line string in the 5x7 bitmap font (ui/font.py) at
    (x, y) top-left.  The coverage mask is host data (text content is host
    state, like the reference's ttf draw calls); the write is one clipped
    window update.  Off-screen text clips."""
    from ..ui import font as font_mod

    return draw_mask(fb, x, y, font_mod.render_text_mask(s, scale=scale),
                     rgb, clip)


def draw_image(fb: FrameBuffers, x: int, y: int, words) -> FrameBuffers:
    """Blit a packed-RGBA8 word image (h, w), numpy or a tensor, at
    (x, y), clipped: the palette and browser thumbnail path
    (texture_palette.rs thumbnails)."""
    if not isinstance(words, torch.Tensor):
        words = torch.from_numpy(np.ascontiguousarray(words, np.int32))
    mh, mw = words.shape

    def fill(window, rows, cols):
        return words[rows, cols].to(device=window.device,
                                    dtype=window.dtype)
    return _blit(fb, int(x), int(y), mh, mw, fill)
