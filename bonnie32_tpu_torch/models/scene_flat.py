"""Flat scene compile and batched level render
(bonnie32_tpu/models/scene_flat.py).

`compile_level_flat` concatenates every room into one draw list with one
global texture atlas, per-face room fog/ambient and the camera-independent
corner attributes and shade tables, exactly as the JAX package does.  The
TPU kernel tables (bf16 texel planes, key rows, packed encodings) and the
compile-time folds (vc/sh/tex_wh/bt_const) are not carried over: the CUDA
kernels read the flat atlas and evaluate the general expressions, which
the folds only specialised.

`render_level_flat` runs the ported slice only: opaque faces under a
z-buffer, affine textures, constant background.  Every other
configuration raises NotImplementedError.
"""

import dataclasses
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .._host.config import BlendMode, NEAR_PLANE, RasterSettings, \
    ShadingMode
from ..ops import raster_batch as rb
from ..ops.lighting import normalize_rows, shade_points
from ..ops.surface import _apply_fog_to_color, _fog_factor
from ..ops.vertex import transform_vertices
from ..types import (CameraArrays, FaceArrays, FrameBuffers, Lights,
                     MeshArrays, Surfaces, TextureAtlas, to_device)
from . import build

F32 = np.float32
_LATER = "is not ported yet (ROADMAP.md queue 1)"


class FogFaces(NamedTuple):
    """Per-face room fog parameters."""

    enabled: torch.Tensor        # (T,) bool
    start: torch.Tensor          # (T,) f32
    falloff: torch.Tensor        # (T,) f32
    cull_distance: torch.Tensor  # (T,) f32
    color: torch.Tensor          # (T, 3) i32


class FlatScene(NamedTuple):
    """The whole level as one flat draw list, on one device."""

    mesh: MeshArrays
    faces: FaceArrays
    fog: FogFaces
    ambient: torch.Tensor      # (T,) f32 per-face room ambient
    lights: Lights
    atlas: TextureAtlas
    cpos: torch.Tensor         # (T, 3, 3) f32 world corner positions
    cnorm: torch.Tensor        # (T, 3, 3) f32 world corner normals
    cuv: torch.Tensor          # (T, 3, 2) f32
    cvcol: torch.Tensor        # (T, 3, 3) i32
    cvblend: torch.Tensor      # (T, 3) i32
    f_blend: torch.Tensor      # (T,) i32 resolved blend mode
    f_hastransp: torch.Tensor  # (T,) bool
    f_group: torch.Tensor      # (T,) i32 draw group (room) id
    cshade: torch.Tensor       # (T, 3, 3) f32 Gouraud shade, front
    cshade_neg: torch.Tensor   # (T, 3, 3) f32 Gouraud shade, -normal
    fshade: torch.Tensor       # (T, 3) f32 flat shade, front
    fshade_neg: torch.Tensor   # (T, 3) f32 flat shade, -normal


@dataclasses.dataclass(frozen=True)
class FlatSceneStatic:
    """Compile-time facts about a FlatScene."""

    n_faces: int
    n_textures: int
    transparent_idx: Tuple[int, ...]   # faces for the (unported) phase 3


def _room_fog_params(room):
    """build_room_fog (scene.rs:264-276)."""
    f = room.fog
    if not f.enabled:
        return False, 0.0, 0.0, 3.4e38, (0, 0, 0)
    color = tuple(int(F32(F32(c) * F32(255.0))) for c in f.color)
    cull = float(F32(F32(F32(f.start) + F32(f.falloff)) + F32(f.cull_offset)))
    return True, float(f.start), float(f.falloff), cull, color


def compile_level_flat(level, textures, resolve,
                       light_specs: Optional[List[dict]] = None,
                       asset_library=None, light_pad: int = 8,
                       device="cpu") -> Tuple[FlatScene, FlatSceneStatic]:
    """Level -> (FlatScene on `device`, FlatSceneStatic).  `textures` are
    (pixels15, blend) tuples or objects with `.pixels15`; `resolve` maps a
    TextureRef to (texture id, width) as in the JAX package."""
    if asset_library is not None:
        raise NotImplementedError(f"placed asset draws {_LATER}")
    tex_list = [t if isinstance(t, tuple) else (t.pixels15, 0)
                for t in textures]
    groups = []
    for room in level.rooms:
        verts, faces = room.to_render_data(resolve)
        groups.append((verts, faces, _room_fog_params(room), room.ambient))
    scene, static = _compile_groups(groups, tex_list, light_specs, light_pad)
    return to_device(scene, device), static


def _compile_groups(groups, tex_list, light_specs, light_pad):
    all_v, all_f = [], []
    fog_rows, ambients, group_ids = [], [], []
    for gi, (verts, faces, fog_row, amb) in enumerate(groups):
        base = len(all_v)
        if not verts:
            verts = [dict(pos=(0, 0, 0), uv=(0, 0), normal=(0, 0, 0),
                          color=(128, 128, 128), color_blend=0)]
        all_v.extend(verts)
        for f in faces:
            all_f.append(dict(f, v0=f["v0"] + base, v1=f["v1"] + base,
                              v2=f["v2"] + base))
            fog_rows.append(fog_row)
            ambients.append(amb)
            group_ids.append(gi)
    if not all_f:
        raise ValueError("the level has no faces")

    # global atlas trimmed to the sampled textures, in first-use order
    used = list(dict.fromkeys(f["tex_id"] for f in all_f
                              if f.get("tex_id") is not None
                              and f["tex_id"] >= 0))
    if not used and tex_list:
        used = [0]
    remap = {g: i for i, g in enumerate(used)}
    for f in all_f:
        if f.get("tex_id") is not None and f["tex_id"] >= 0:
            f["tex_id"] = remap[f["tex_id"]]
    tex_list = [tex_list[g] for g in used]

    pos = np.array([v["pos"] for v in all_v], F32)
    uv = np.array([v["uv"] for v in all_v], F32)
    normal = np.array([v["normal"] for v in all_v], F32)
    vcol = np.array([v["color"] for v in all_v], np.int32)
    vblend = np.array([v.get("color_blend", 0) for v in all_v], np.int32)
    mesh = build.make_mesh_arrays(pos, uv, normal, vcol, vblend)

    vidx = np.array([(f["v0"], f["v1"], f["v2"]) for f in all_f], np.int32)
    tid = np.array([-1 if f.get("tex_id") is None else f["tex_id"]
                    for f in all_f], np.int32)
    bt = np.array([f.get("black_transparent", True) for f in all_f], bool)
    face_bm = np.array([f.get("blend_mode", 0) for f in all_f], np.int32)
    ea = np.array([f.get("editor_alpha", 255) for f in all_f], np.int32)
    ds = np.array([bool(f.get("double_sided", False)) for f in all_f], bool)
    kp = build.compute_key_possible(uv, vidx, tid, bt, tex_list)
    fa = build.make_face_arrays(vidx, tid, bt, face_bm, ea, ds, kp)

    fog = FogFaces(
        enabled=torch.tensor([f[0] for f in fog_rows], dtype=torch.bool),
        start=torch.from_numpy(np.array([f[1] for f in fog_rows], F32)),
        falloff=torch.from_numpy(np.array([f[2] for f in fog_rows], F32)),
        cull_distance=torch.from_numpy(
            np.array([f[3] for f in fog_rows], F32)),
        color=torch.from_numpy(np.array([f[4] for f in fog_rows], np.int32)))
    ambient = torch.from_numpy(np.array(ambients, F32))
    lights = build.lights_from_list(light_specs or [], pad=light_pad)
    atlas = build.build_atlas(tex_list)

    tex_blend = atlas.blend_mode.numpy()
    textured = tid >= 0
    has_tr = ((textured & (tex_blend[np.maximum(tid, 0)]
                           != int(BlendMode.OPAQUE)))
              | (face_bm != int(BlendMode.OPAQUE)) | (ea < 255))
    tr_idx = tuple(int(i) for i in np.where(has_tr)[0])

    # camera-independent shade tables, both normal orientations; the flat
    # average of the swapped corners sums in the swapped order (0,2),1
    cpos = torch.from_numpy(pos[vidx])
    cnorm = torch.from_numpy(normal[vidx])
    amb3 = torch.broadcast_to(ambient[:, None], cpos.shape[:2])
    cshade = shade_points(cnorm, cpos, lights, ambient=amb3)
    cshade_neg = shade_points(-cnorm, cpos, lights, ambient=amb3)
    third = float(F32(1.0 / 3.0))
    center_f = ((cpos[:, 0] + cpos[:, 1]) + cpos[:, 2]) * third
    avg_f = ((cnorm[:, 0] + cnorm[:, 1]) + cnorm[:, 2]) * third
    fshade = shade_points(normalize_rows(avg_f), center_f, lights,
                          ambient=ambient)
    center_s = ((cpos[:, 0] + cpos[:, 2]) + cpos[:, 1]) * third
    avg_s = ((-cnorm[:, 0] + -cnorm[:, 2]) + -cnorm[:, 1]) * third
    fshade_neg = shade_points(normalize_rows(avg_s), center_s, lights,
                              ambient=ambient)

    scene = FlatScene(
        mesh=mesh, faces=fa, fog=fog, ambient=ambient, lights=lights,
        atlas=atlas, cpos=cpos, cnorm=cnorm,
        cuv=torch.from_numpy(uv[vidx]),
        cvcol=torch.from_numpy(vcol[vidx]),
        cvblend=torch.from_numpy(vblend[vidx]),
        f_blend=torch.from_numpy(
            np.where(textured, tex_blend[np.maximum(tid, 0)],
                     face_bm).astype(np.int32)),
        f_hastransp=torch.from_numpy(has_tr),
        f_group=torch.from_numpy(np.asarray(group_ids, np.int32)),
        cshade=cshade, cshade_neg=cshade_neg,
        fshade=fshade, fshade_neg=fshade_neg)
    static = FlatSceneStatic(
        n_faces=len(all_f), n_textures=int(atlas.offset.shape[0]),
        transparent_idx=tr_idx)
    return scene, static


def _swap_corners(arr, swap):
    """Corner order (0, 2, 1) where `swap` (I, T) holds; arr (I, T, 3, ...)."""
    swapped = arr[:, :, [0, 2, 1]]
    mask = swap.reshape(swap.shape + (1,) * (arr.dim() - 2))
    return torch.where(mask, swapped, arr)


def build_surfaces_flat(scene: FlatScene, cams: CameraArrays,
                        settings: RasterSettings,
                        width: int, height: int) -> Surfaces:
    """ops/surface.build_surfaces with per-face fog/ambient, batched over
    the cameras' leading instance dimension (render.rs:2313-2513)."""
    faces, fog = scene.faces, scene.fog
    cam = CameraArrays(position=cams.position[:, None, None, :],
                       basis=cams.basis[:, None, None, :, :])
    tv = transform_vertices(scene.cpos, cam, settings, width, height)
    c_sx, c_sy, c_sz = tv.sx, tv.sy, tv.sz          # (I, T, 3)
    cam_z = tv.cam[..., 2]
    n = c_sx.shape[0]

    near_ok = (cam_z > NEAR_PLANE).all(dim=-1)
    v1x, v2x, v3x = c_sx[..., 0], c_sx[..., 1], c_sx[..., 2]
    v1y, v2y, v3y = c_sy[..., 0], c_sy[..., 1], c_sy[..., 2]
    signed_area = (v2x - v1x) * (v3y - v1y) - (v3x - v1x) * (v2y - v1y)
    is_backface = signed_area <= 0.0

    factors = torch.where(fog.enabled[:, None],
                          _fog_factor(cam_z, fog.start[:, None],
                                      fog.falloff[:, None]),
                          torch.zeros_like(cam_z))
    vc_rgb, vc_blend = _apply_fog_to_color(
        scene.cvcol, scene.cvblend, fog.color[:, None, :], factors)
    fog_cull = fog.enabled & (cam_z > fog.cull_distance[:, None]).all(-1)

    textured = faces.tex_id >= 0
    render_back = not settings.backface_cull or settings.xray_mode
    if render_back:
        render_back_face = torch.ones_like(is_backface)
    else:
        render_back_face = faces.double_sided.expand_as(is_backface)
    swap = is_backface & render_back_face

    sx = _swap_corners(c_sx[..., None], swap)[..., 0]
    sy = _swap_corners(c_sy[..., None], swap)[..., 0]
    sz = _swap_corners(c_sz[..., None], swap)[..., 0]
    uv = _swap_corners(scene.cuv.expand(n, -1, -1, -1), swap)
    vc = _swap_corners(vc_rgb.expand(n, -1, -1, -1), swap)
    vcb = _swap_corners(vc_blend.expand(n, -1, -1)[..., None], swap)[..., 0]

    if settings.shading == ShadingMode.GOURAUD:
        neg = scene.cshade_neg[:, [0, 2, 1]]
        shade = torch.where(swap[..., None, None], neg, scene.cshade)
    elif settings.shading == ShadingMode.FLAT:
        flat = torch.where(swap[..., None], scene.fshade_neg, scene.fshade)
        shade = flat[:, :, None, :].expand(-1, -1, 3, -1)
    else:
        shade = torch.ones((n,) + tuple(scene.cpos.shape), device=sx.device)

    vc_eq_12 = (vc[:, :, 0] == vc[:, :, 1]).all(-1) \
        & (vcb[:, :, 0] == vcb[:, :, 1])
    vc_eq_23 = (vc[:, :, 1] == vc[:, :, 2]).all(-1) \
        & (vcb[:, :, 1] == vcb[:, :, 2])
    needs_dither = (textured | ~vc_eq_12 | ~vc_eq_23
                    | (settings.shading == ShadingMode.GOURAUD)) \
        & settings.dithering

    front_ok = ~is_backface | render_back_face
    valid = faces.valid & near_ok & ~fog_cull & front_ok

    centroid_z = ((sz[..., 0] + sz[..., 1]) + sz[..., 2]) / 3.0
    inv_z = 1.0 / sz
    r1x, r2x, r3x = sx[..., 0], sx[..., 1], sx[..., 2]
    r1y, r2y, r3y = sy[..., 0], sy[..., 1], sy[..., 2]
    area = (r2y - r3y) * (r1x - r3x) + (r3x - r2x) * (r1y - r3y)
    degenerate = area.abs() < 0.00001
    inv_area = 1.0 / torch.where(degenerate, torch.ones_like(area), area)

    return Surfaces(
        sx=sx, sy=sy, z=sz, inv_z=inv_z, area=area, inv_area=inv_area,
        uv=uv, vc=vc, shade=shade, tex_id=faces.tex_id,
        blend_mode=scene.f_blend,
        black_transparent=faces.black_transparent,
        editor_alpha=faces.editor_alpha, needs_dither=needs_dither,
        has_transparency=scene.f_hastransp, centroid_z=centroid_z,
        valid=valid, key_possible=faces.key_possible)


def check_slice(static: FlatSceneStatic, settings: RasterSettings):
    """Raise NotImplementedError for every configuration outside the
    ported slice (opaque faces, z-buffer, affine UVs, no wireframes)."""
    if settings.ortho_projection is not None:
        raise NotImplementedError(f"ortho projection {_LATER}")
    if settings.xray_mode:
        raise NotImplementedError(f"x-ray mode {_LATER}")
    if not settings.use_zbuffer:
        raise NotImplementedError(f"painter's mode {_LATER}")
    if settings.wireframe_overlay or (settings.backface_cull
                                      and settings.backface_wireframe):
        raise NotImplementedError(f"wireframe passes {_LATER}")
    if not settings.affine_textures:
        raise NotImplementedError(f"perspective-correct UVs {_LATER}")
    if static.transparent_idx:
        raise NotImplementedError(
            f"transparent faces (the kernel's phase 3) {_LATER}")


def render_level_flat(scene: FlatScene, static: FlatSceneStatic,
                      cams: CameraArrays, settings: RasterSettings,
                      height: int, width: int,
                      background: int = 0) -> FrameBuffers:
    """Batched level render of (I,) cameras into (I, H, W) framebuffers
    cleared to `background` and inverse-z 0: surfaces, prep, then the
    visibility and resolve kernels (their plain twins for CPU tensors)."""
    check_slice(static, settings)
    surf = build_surfaces_flat(scene, cams, settings, width, height)
    prep = rb.prep_instance(surf, scene.atlas, width, height)
    color, depth = rb.rasterize_batch(prep, scene.atlas, settings,
                                      height, width, background)
    return FrameBuffers(color=color, depth=depth)
