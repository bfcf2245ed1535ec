"""Flat scene compile and batched level render
(bonnie32_tpu/models/scene_flat.py).

`compile_level_flat` concatenates every room into one draw list with one
global texture atlas, per-face room fog/ambient and the camera-independent
corner attributes and shade tables, exactly as the JAX package does.  The
TPU kernel tables (bf16 texel planes, key rows, packed encodings) and the
compile-time folds (vc/sh/tex_wh/bt_const) are not carried over: the CUDA
kernels read the flat atlas and evaluate the general expressions, which
the folds only specialised.

`render_level_flat` routes as the JAX package's kernel path does:
visibility, resolve, then the ordered composite of the transparent faces;
painter's mode through the painter's visibility; x-ray as the composite
of every face onto the background; affine or perspective-correct UVs;
then the editor's backface wireframes, or, in `wireframe_overlay` mode,
the front edges alone on the cleared frame (ops/wireframe.py).  Placed
asset parts compile into draw groups of their own after the rooms.  The
configurations the kernels cannot draw (`kernel_route_ok`) raise
NotImplementedError here (`check_slice`); rollout.step_and_render sends
them to the sequential renderer (models/scene.render_level), as the JAX
package does.  X-ray with perspective-correct UVs, sequential in the JAX
package, runs in the port's composite kernel.
"""

import dataclasses
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import BlendMode, RasterSettings, \
    ShadingMode
from ..ops import raster_batch as rb
from ..ops import skybox as sky_ops
from ..ops import wireframe as wf
from ..ops.lighting import normalize_rows, shade_points
from ..ops.surface import corner_surfaces
from ..ops.vertex import transform_vertices
from ..types import (CameraArrays, FaceArrays, FrameBuffers, Lights,
                     MeshArrays, Surfaces, TextureAtlas, resolve_device,
                     to_device)
from . import build
from .scene import (NO_FOG_ROW, _room_fog_params, resolve_part_texture15,
                    transform_part_vertices)

F32 = np.float32


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
    transparent_idx: Tuple[int, ...]   # static transparent-face list
    # True when every transparent face lives in the final draw group, so
    # opaque-then-transparent matches the reference's per-room interleave
    transparent_last: bool
    n_draw_groups: int = 1             # rooms (+ placed asset parts)


def compile_level_flat(level, textures, resolve,
                       light_specs: Optional[List[dict]] = None,
                       asset_library=None, user_textures=None,
                       light_pad: int = 8,
                       device=None) -> Tuple[FlatScene, FlatSceneStatic]:
    """Level -> (FlatScene on `device` (default: the card),
    FlatSceneStatic).  `textures` are (pixels15, blend) tuples or objects
    with `.pixels15`; `resolve` maps a TextureRef to (texture id, width)
    as in the JAX package.  With an `asset_library`, the level's placed
    objects draw after the rooms, one draw group per visible part, each
    part with its own texture appended to the table (`user_textures`
    resolves TextureRef::Id parts)."""
    device = resolve_device(device)
    tex_list = [t if isinstance(t, tuple) else (t.pixels15, 0)
                for t in textures]
    groups = []   # (verts, faces, fog row, ambient, double-sided or None)
    for room in level.rooms:
        verts, faces = room.to_render_data(resolve)
        groups.append((verts, faces, _room_fog_params(room), room.ambient,
                       None))
    if asset_library is not None:
        groups += _asset_groups(level, asset_library, user_textures, tex_list)
    scene, static = _compile_groups(groups, tex_list, light_specs, light_pad)
    return to_device(scene, device), static


def _asset_groups(level, asset_library, user_textures, tex_list):
    """The placed asset draws (scene.rs:226-259), as the JAX package walks
    them: per room, per enabled object whose asset has a mesh, per visible
    non-empty part, its vertices placed in the world, one texture appended
    to `tex_list` (which this extends) for all of the part's faces, the
    room's fog and ambient, and the part's double-sidedness on every
    face."""
    groups = []
    for room in level.rooms:
        fog_row = _room_fog_params(room)
        for obj in room.objects:
            if not obj.enabled:
                continue
            asset = asset_library.get_by_id(obj.asset_id)
            parts = asset.mesh() if asset is not None else None
            if not parts:
                continue
            wp = obj.world_position(room)
            for part in parts:
                if not part.visible:
                    continue
                verts, pfaces = part.mesh.to_render_data_textured()
                if not verts:
                    continue
                verts = transform_part_vertices(verts, obj.facing, wp)
                gid = len(tex_list)
                tex_list.append((resolve_part_texture15(part, user_textures),
                                 0))
                pfaces = [dict(f, tex_id=(gid if f.get("tex_id") is not None
                                          else None))
                          for f in pfaces]
                groups.append((verts, pfaces, fog_row, room.ambient,
                               part.double_sided))
    return groups


def compile_scene_flat(verts, faces, textures, light_specs=None,
                       ambient: float = 0.3, light_pad: int = 8,
                       device=None) -> Tuple[FlatScene, FlatSceneStatic]:
    """One raw mesh (vertex/face dicts as tests/scenes.py builds them, and
    (pixels15, blend) textures) -> (FlatScene on `device` (default: the
    card), FlatSceneStatic), one draw group without fog.  The default
    ambient is build.lights_from_list's 0.3, so raw-mesh scenes shade as
    through the per-mesh path."""
    device = resolve_device(device)
    tex_list = [t if isinstance(t, tuple) else (t.pixels15, 0)
                for t in textures]
    fog_row = NO_FOG_ROW
    groups = [(list(verts), [dict(f) for f in faces], fog_row, ambient,
               None)]
    scene, static = _compile_groups(groups, tex_list, light_specs, light_pad)
    return to_device(scene, device), static


def _compile_groups(groups, tex_list, light_specs, light_pad):
    all_v, all_f = [], []
    fog_rows, ambients, ds_flags, group_ids = [], [], [], []
    for gi, (verts, faces, fog_row, amb, ds) in enumerate(groups):
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
            # a placed part's own flag holds for every one of its faces
            ds_flags.append(bool(ds) if ds is not None
                            else bool(f.get("double_sided", False)))
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
    ds = np.array(ds_flags, bool)
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
    last_start = len(all_f) - len(groups[-1][1])
    tr_last = all(i >= last_start for i in tr_idx)

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
        transparent_idx=tr_idx, transparent_last=tr_last,
        n_draw_groups=len(groups))
    return scene, static


def build_surfaces_flat(scene: FlatScene, cams: CameraArrays,
                        settings: RasterSettings,
                        width: int, height: int) -> Surfaces:
    """ops/surface.build_surfaces with per-face fog/ambient, batched over
    the cameras' leading instance dimension (render.rs:2313-2513): the
    shared ops/surface.corner_surfaces with the compiled shade tables."""
    cam = CameraArrays(position=cams.position[:, None, None, :],
                       basis=cams.basis[:, None, None, :, :])
    tv = transform_vertices(scene.cpos, cam, settings, width, height)

    def shade_of(swap):
        if settings.shading == ShadingMode.GOURAUD:
            neg = scene.cshade_neg[:, [0, 2, 1]]
            return torch.where(swap[..., None, None], neg, scene.cshade)
        return torch.where(swap[..., None], scene.fshade_neg, scene.fshade)

    return corner_surfaces(
        tv.sx, tv.sy, tv.sz, tv.cam[..., 2], scene.faces, scene.cuv,
        scene.cvcol, scene.cvblend, scene.fog, scene.f_blend,
        scene.f_hastransp, shade_of, settings)


def kernel_path_ok(static: FlatSceneStatic,
                   settings: RasterSettings) -> bool:
    """Whether the JAX package takes its kernel path (scene_flat.
    kernel_path_ok) for this level and these settings; where it does not,
    it runs its sequential renderer.  The port has no face-table segments
    and no packed texel encodings, so only these conditions remain: no
    ortho projection; backface wireframes in one draw group only; x-ray
    with affine UVs; otherwise every transparent face in the final draw
    group.  This mirrors the JAX function only: the port's routing does
    not read it, and `kernel_route_ok` differs from it in one case, x-ray
    with perspective-correct UVs, which the port's composite draws."""
    if settings.ortho_projection is not None:
        return False
    if (settings.backface_cull and settings.backface_wireframe
            and static.n_draw_groups > 1):
        return False
    if settings.xray_mode:
        return settings.affine_textures
    return static.transparent_last


def kernel_route_refusal(static: FlatSceneStatic,
                         settings: RasterSettings) -> Optional[str]:
    """Why the port's kernels cannot draw this level under these settings,
    or None where they can.  Decided by the settings and the level's
    static facts alone, before any launch.  The kernels cannot draw ortho
    projection (no linear-z merge); backface wireframes over more than one
    draw group (the reference draws each group's wires after that group's
    solids, which a wire pass after all solids cannot reproduce);
    transparent faces outside the last draw group, outside x-ray mode (the
    reference composites them between the groups).  X-ray with
    perspective-correct UVs, sequential in the JAX package, runs in the
    composite kernel."""
    if settings.ortho_projection is not None:
        return "ortho projection"
    if (settings.backface_cull and settings.backface_wireframe
            and static.n_draw_groups > 1):
        return f"backface wireframes over {static.n_draw_groups} draw groups"
    if not (settings.xray_mode or static.transparent_last):
        return "transparent faces outside the last draw group"
    return None


def kernel_route_ok(static: FlatSceneStatic,
                    settings: RasterSettings) -> bool:
    """Whether the port's kernels draw this level under these settings
    (`kernel_route_refusal` is None); where they do not,
    rollout.step_and_render takes the sequential renderer
    (models/scene.render_level)."""
    return kernel_route_refusal(static, settings) is None


def check_slice(static: FlatSceneStatic, settings: RasterSettings):
    """Raise NotImplementedError where the kernels cannot draw the level
    under the settings (`kernel_route_refusal`): those configurations
    take the sequential renderer, models/scene.render_level."""
    why = kernel_route_refusal(static, settings)
    if why is not None:
        raise NotImplementedError(
            f"the kernel route cannot draw {why}: render it with the "
            "sequential renderer, models.scene.render_level "
            "(rollout.step_and_render routes there)")


def render_level_flat(scene: FlatScene, static: FlatSceneStatic,
                      cams: CameraArrays, settings: RasterSettings,
                      height: int, width: int, background: int = 0,
                      sky=None, fb_color=None) -> FrameBuffers:
    """Batched level render of (I,) cameras into (I, H, W) framebuffers
    with inverse-z cleared to 0, routed as the JAX kernel path routes
    (scene_flat.render_level_flat):

      * z-buffer or painter's mode: visibility (the painter's merge in
        painter's mode), resolve, then the composite of the static
        transparent-face list back to front, if the level has one;
      * x-ray mode: the composite of every face in draw order onto the
        background, with a cleared depth plane; neither visibility nor
        resolve runs;
      * then, with backface culling and backface wireframes on (the
        editor's default), the back faces' edges, depth-tested against
        the final depth plane;
      * `wireframe_overlay`: no solid pass at all, only the front faces'
        edges on the cleared frame: the word `background`, or 0 with a
        `sky` or `fb_color`, whose sky the JAX kernel path does not draw
        under the overlay either.

    `affine_textures` off takes the perspective-correct UV in every
    kernel.

    The background is one of: the word `background`; `fb_color`, an
    (I, H, W) i32 plane (the sky-buffer route: ops.skybox.render_skybox);
    or `sky`, an ops.skybox.SkyTables, the in-kernel sky: resolve
    evaluates the sky at every pixel no face drew, then the star
    sparkles land on the pixels whose depth is still 0.0.  `sky` needs
    ops.skybox.sky_kernel_ok.

    CUDA tensors run the kernels of csrc/raster.cu, CPU tensors their
    plain twins."""
    surf = (None if settings.wireframe_overlay
            else build_surfaces_flat(scene, cams, settings, width, height))
    return render_surfaces_flat(scene, static, surf, settings, height,
                                width, background, sky=sky,
                                fb_color=fb_color, cams=cams)


def render_surfaces_flat(scene: FlatScene, static: FlatSceneStatic,
                         surf: Surfaces, settings: RasterSettings,
                         height: int, width: int, background: int = 0,
                         sky=None, fb_color=None,
                         cams=None) -> FrameBuffers:
    """render_level_flat from the surfaces on: prep, then the kernels as
    routed there.  Takes surfaces built elsewhere (the tests feed the JAX
    package's, to hold the raster phases to it apart from the surfaces'
    float rounding); the in-kernel sky and the wireframes need the cameras
    too (overlay mode reads no surfaces)."""
    check_slice(static, settings)
    if wf.wires_on(settings) and cams is None:
        raise ValueError("the wireframe passes need the cameras")
    if settings.wireframe_overlay:
        # the solid passes are skipped (render.rs:2550)
        word = background if sky is None and fb_color is None else 0
        shape = (cams.position.shape[0], height, width)
        dev = cams.position.device
        color = torch.full(shape, word, dtype=torch.int32, device=dev)
        depth = torch.zeros(shape, dtype=torch.float32, device=dev)
        return FrameBuffers(color=wf.render_wireframes_flat(
            color, depth, scene, cams, settings), depth=depth)
    if sky is not None:
        if fb_color is not None or background != 0:
            raise ValueError("sky excludes fb_color and a background word")
        if not sky_ops.sky_kernel_ok(sky, static, settings):
            raise ValueError(
                "in-kernel sky: take the sky-buffer route (fb_color) for "
                "this settings/level combination (sky_kernel_ok)")
        if cams is None:
            raise ValueError("the in-kernel sky needs the cameras")
        background = sky_ops.SkyBackground(
            sky, sky_ops.prep_sky_scal(sky, cams, width, height))
    elif fb_color is not None:
        if background != 0:
            raise ValueError("fb_color excludes a background word")
        background = fb_color
    if settings.xray_mode:
        shape = (surf.sx.shape[0], height, width)
        dev = surf.sx.device
        # the composite updates its colour plane in place on the card:
        # start from a copy of the caller's plane
        color = (fb_color.clone() if fb_color is not None else torch.full(
            shape, background, dtype=torch.int32, device=dev))
        depth = torch.zeros(shape, dtype=torch.float32, device=dev)
        tables = rb.face_tables(surf, scene.atlas, width, height)
        tr = rb.prep_xray(surf, group_id=scene.f_group,
                          use_zbuffer=settings.use_zbuffer)
        color = rb.composite(color, depth, tr, tables, scene.atlas, settings)
        return _backface_wires(color, depth, scene, cams, settings)
    prep = rb.prep_instance(surf, scene.atlas, width, height,
                            painters=not settings.use_zbuffer,
                            group_id=scene.f_group)
    color, depth = rb.rasterize_batch(prep, scene.atlas, settings,
                                      height, width, background)
    if sky is not None and sky.stars_enabled:
        # sky_kernel_ok: no transparent face follows, so the stars cannot
        # end up over one
        color = sky_ops.scatter_stars(color, depth, sky, cams,
                                      time=sky.time)
    if static.transparent_idx:
        tr = rb.prep_transparent(surf, static.transparent_idx)
        color = rb.composite(color, depth, tr, prep, scene.atlas, settings)
    return _backface_wires(color, depth, scene, cams, settings)


def _backface_wires(color, depth, scene, cams, settings) -> FrameBuffers:
    """The frame after its solid and transparent passes, with the back
    faces' edges over it where the settings draw them (check_slice allows
    them for one draw group only)."""
    if settings.backface_cull and settings.backface_wireframe:
        color = wf.render_wireframes_flat(color, depth, scene, cams,
                                          settings)
    return FrameBuffers(color=color, depth=depth)
