"""The CULL + FOG + surface-build stage of one mesh
(bonnie32_tpu/ops/surface.py), batched over cameras: `build_surfaces`
(render.rs:2364-2513), whose culls, per-vertex fog (render.rs:2266-2293),
winding swap and raster terms (`corner_surfaces`)
models/scene_flat.build_surfaces_flat shares, and the draw order of the
sequential compositor (`draw_order`, render.rs:2518-2545).  The JAX
package's exact divisions and square roots (ops/exactf.py) are torch's
IEEE ones, with every divisor a tensor."""

import numpy as np
import torch

from ..config import NEAR_PLANE, BlendMode, RasterSettings, ShadingMode
from ..types import (CameraArrays, FaceArrays, Fog, Lights, MeshArrays,
                     Surfaces, TextureAtlas)
from .fixed import f32_to_i32
from .lighting import normalize_rows, shade_points
from .raster_batch import _lexsort
from .vertex import transform_vertices


def _fog_factor(z, start, falloff):
    """calculate_fog_factor (render.rs:2266-2274)."""
    safe = torch.where(falloff <= 0.0, torch.ones_like(falloff), falloff)
    lin = torch.clamp((z - start) / safe, max=1.0)
    return torch.where(z <= start, torch.zeros_like(lin),
                       torch.where(falloff <= 0.0, torch.ones_like(lin), lin))


def _apply_fog_to_color(color_rgb, color_blend, fog_rgb, factor):
    """apply_fog_to_color (render.rs:2279-2293): returns (rgb (..., 3) i32,
    blend i32).  The lerp branch builds a fresh colour, so its blend resets
    to OPAQUE; the passthrough branches keep the original colour and blend."""
    f = factor[..., None]
    lerped = color_rgb.to(torch.float32) * (1.0 - f) \
        + fog_rgb.to(torch.float32) * f
    lerped = torch.clamp(f32_to_i32(torch.trunc(lerped)), 0, 255)
    use_orig = factor <= 0.0
    use_fog = factor >= 1.0
    rgb = torch.where(use_orig[..., None], color_rgb,
                      torch.where(use_fog[..., None],
                                  torch.broadcast_to(fog_rgb, color_rgb.shape),
                                  lerped))
    blend = torch.where(use_orig, color_blend,
                        torch.full_like(color_blend, int(BlendMode.OPAQUE)))
    return rgb, blend


def _swap_corners(arr, swap):
    """Corner order (0, 2, 1) where `swap` (I, T) holds; arr (I, T, 3, ...)."""
    swapped = arr[:, :, [0, 2, 1]]
    mask = swap.reshape(swap.shape + (1,) * (arr.dim() - 2))
    return torch.where(mask, swapped, arr)


def build_surfaces(mesh: MeshArrays, faces: FaceArrays, atlas: TextureAtlas,
                   cams: CameraArrays, lights: Lights, fog: Fog,
                   settings: RasterSettings, width: int,
                   height: int) -> Surfaces:
    """Transform + cull + fog + shade of one mesh (render.rs:2364-2513)
    for each camera of `cams` ((I,) CameraArrays): faces -> Surfaces,
    fields (I, T, ...) where they depend on the camera and (T,) where they
    do not, as models/scene_flat.build_surfaces_flat makes them.  The
    culls, fog, winding swap and raster terms are `corner_surfaces`; the
    shades come from the swapped world corners and normals
    (render.rs:1466-1483), per corner or one per face."""
    cam = CameraArrays(position=cams.position[:, None, :],
                       basis=cams.basis[:, None, :, :])
    tv = transform_vertices(mesh.pos, cam, settings, width, height)
    vi = faces.vidx.long()                           # (T, 3)
    n = cams.position.shape[0]

    textured = faces.tex_id >= 0
    tex_blend = atlas.blend_mode[torch.clamp(faces.tex_id, min=0).long()]
    has_transparency = ((textured & (tex_blend != int(BlendMode.OPAQUE)))
                        | (faces.blend_mode != int(BlendMode.OPAQUE))
                        | (faces.editor_alpha < 255))
    blend_mode = torch.where(textured, tex_blend, faces.blend_mode)

    def corners(a):                  # (T, 3, ...) -> (I, T, 3, ...)
        return a.expand((n,) + tuple(a.shape))

    def shade_of(swap):
        wpos = _swap_corners(corners(mesh.pos[vi]), swap)
        wnorm = _swap_corners(corners(mesh.normal[vi]), swap)
        wnorm = torch.where(swap[..., None, None], -wnorm, wnorm)
        if settings.shading == ShadingMode.GOURAUD:
            return shade_points(wnorm, wpos, lights)
        # the average world corner and normal, then one shade
        # (render.rs:1467-1469)
        third = float(np.float32(1.0 / 3.0))
        center = ((wpos[:, :, 0] + wpos[:, :, 1]) + wpos[:, :, 2]) * third
        avg_n = ((wnorm[:, :, 0] + wnorm[:, :, 1]) + wnorm[:, :, 2]) * third
        return shade_points(normalize_rows(avg_n), center, lights)

    return corner_surfaces(
        tv.sx[:, vi], tv.sy[:, vi], tv.sz[:, vi], tv.cam[..., 2][:, vi],
        faces, mesh.uv[vi], mesh.color[vi], mesh.color_blend[vi], fog,
        blend_mode, has_transparency, shade_of, settings)


def corner_surfaces(c_sx, c_sy, c_sz, cam_z, faces: FaceArrays, uv, color,
                    color_blend, fog: Fog, blend_mode, has_transparency,
                    shade_of, settings: RasterSettings) -> Surfaces:
    """The part of the surface build that build_surfaces and
    models/scene_flat.build_surfaces_flat share, from each face's screen
    corners and camera z (I, T, 3):

      * near-plane rejection: any corner at cam_z <= NEAR_PLANE drops the
        face (render.rs:2379-2385), except under ortho projection;
      * the 2-D signed-area backface test (render.rs:2392-2394);
      * per-vertex fog on the corner colours `color` (T, 3, 3) and blends
        (T, 3), and the whole-face distance cull (render.rs:2417-2443).
        `fog`'s fields are one fog (0-dim) or one row per face (T,);
      * the winding swap (0, 2, 1) of a back face that renders
        (render.rs:2452-2479), applied to the corner `uv` (T, 3, 2) too;
      * the shade: `shade_of(swap)` gives (I, T, 3, 3) per corner or
        (I, T, 3) per face under Gouraud or flat shading; none is ones;
      * the dither rule (render.rs:1487-1492) on the fogged colours;
      * 1/z per corner, area and 1/area (the raster formula), centroid z
        (a division by 3, render.rs:2529)."""
    n = c_sx.shape[0]
    if settings.ortho_projection is None:
        near_ok = (cam_z > NEAR_PLANE).all(dim=-1)
    else:
        near_ok = torch.ones_like(cam_z[..., 0], dtype=torch.bool)
    v1x, v2x, v3x = c_sx[..., 0], c_sx[..., 1], c_sx[..., 2]
    v1y, v2y, v3y = c_sy[..., 0], c_sy[..., 1], c_sy[..., 2]
    signed_area = (v2x - v1x) * (v3y - v1y) - (v3x - v1x) * (v2y - v1y)
    is_backface = signed_area <= 0.0

    factors = torch.where(fog.enabled[..., None],
                          _fog_factor(cam_z, fog.start[..., None],
                                      fog.falloff[..., None]),
                          torch.zeros_like(cam_z))
    vc_rgb, vc_blend = _apply_fog_to_color(
        color, color_blend, fog.color[..., None, :], factors)
    fog_cull = fog.enabled & (cam_z > fog.cull_distance[..., None]).all(-1)

    render_back = not settings.backface_cull or settings.xray_mode
    if render_back:
        render_back_face = torch.ones_like(is_backface)
    else:
        render_back_face = faces.double_sided.expand_as(is_backface)
    swap = is_backface & render_back_face

    sx = _swap_corners(c_sx[..., None], swap)[..., 0]
    sy = _swap_corners(c_sy[..., None], swap)[..., 0]
    sz = _swap_corners(c_sz[..., None], swap)[..., 0]
    uv = _swap_corners(uv.expand((n,) + tuple(uv.shape)), swap)
    vc = _swap_corners(vc_rgb.expand(n, -1, -1, -1), swap)
    vcb = _swap_corners(vc_blend.expand(n, -1, -1)[..., None], swap)[..., 0]

    if settings.shading == ShadingMode.GOURAUD:
        shade = shade_of(swap)
    elif settings.shading == ShadingMode.FLAT:
        shade = shade_of(swap)[:, :, None, :].expand(-1, -1, 3, -1)
    else:
        shade = torch.ones(sx.shape + (3,), dtype=torch.float32,
                           device=sx.device)

    vc_eq_12 = (vc[:, :, 0] == vc[:, :, 1]).all(-1) \
        & (vcb[:, :, 0] == vcb[:, :, 1])
    vc_eq_23 = (vc[:, :, 1] == vc[:, :, 2]).all(-1) \
        & (vcb[:, :, 1] == vcb[:, :, 2])
    textured = faces.tex_id >= 0
    needs_dither = (textured | ~vc_eq_12 | ~vc_eq_23
                    | (settings.shading == ShadingMode.GOURAUD)) \
        & settings.dithering

    front_ok = ~is_backface | render_back_face
    valid = faces.valid & near_ok & ~fog_cull & front_ok

    # a tensor divisor: torch on CUDA multiplies by the reciprocal of a
    # Python scalar divisor, which differs from x / 3 by an ulp at times
    centroid_z = ((sz[..., 0] + sz[..., 1]) + sz[..., 2]) / sz.new_tensor(3.0)
    inv_z = torch.ones_like(sz) / sz
    r1x, r2x, r3x = sx[..., 0], sx[..., 1], sx[..., 2]
    r1y, r2y, r3y = sy[..., 0], sy[..., 1], sy[..., 2]
    area = (r2y - r3y) * (r1x - r3x) + (r3x - r2x) * (r1y - r3y)
    degenerate = area.abs() < 0.00001
    inv_area = torch.ones_like(area) / torch.where(
        degenerate, torch.ones_like(area), area)

    return Surfaces(
        sx=sx, sy=sy, z=sz, inv_z=inv_z, area=area, inv_area=inv_area,
        uv=uv, vc=vc, shade=shade, tex_id=faces.tex_id,
        blend_mode=blend_mode, black_transparent=faces.black_transparent,
        editor_alpha=faces.editor_alpha, needs_dither=needs_dither,
        has_transparency=has_transparency, centroid_z=centroid_z,
        valid=valid, key_possible=faces.key_possible)


def draw_order(surfaces: Surfaces, settings: RasterSettings):
    """The SORT phase (render.rs:2518-2545) per instance: (order (I, T)
    i64 draw sequence, skip_z (I, T) bool aligned with it).  Valid opaque
    surfaces first, then valid transparent ones back to front by centroid
    z, then the invalid ones; opaque surfaces sort back to front too in
    painter's mode; every sort stable.  skip_z marks the transparent pass,
    which never writes depth."""
    t = surfaces.valid & surfaces.has_transparency
    o = surfaces.valid & ~surfaces.has_transparency
    rank = torch.where(o, 0, torch.where(t, 1, 2)).to(torch.int32)
    neg_z = -surfaces.centroid_z
    within = (torch.where(t, neg_z, torch.zeros_like(neg_z))
              if settings.use_zbuffer else neg_z)
    order = _lexsort([rank, within])
    return order, t.gather(1, order)
