"""Scene compile and the per-room sequential renderer
(bonnie32_tpu/models/scene.py): `render_scene` (scene.rs:180-261).

`compile_level` emits every room into stacked padded buffers (R rooms),
each with its own trimmed texture table, fog and ambient, and every
visible part of every placed asset into a draw of its own (D draws);
`render_level` renders the rooms in order, each through
render.render_mesh_15 with its own ambient and fog, then the asset draws
— the reference's per-room settings clone (scene.rs:201-205).  The host
helpers `collect_scene_lights`, `transform_part_vertices` and
`resolve_part_texture15` serve models/scene_flat.compile_level_flat too;
they run on the host in numpy f32, in the reference's operation order.
A scene compiled `with_8bit=True` also carries the 8-bit tables that
`render_level` draws with under `use_rgb555=False` (scene.rs:214-219).
"""

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..config import RasterSettings
from ..render import render_mesh_15
from ..ops.raster8 import render_mesh8
from ..types import (CameraArrays, FaceArrays, Fog, FrameBuffers, Lights,
                     MeshArrays, TextureAtlas, no_fog, resolve_device,
                     to_device)
from . import build
from . import mesh as mesh_mod

F32 = np.float32
NO_FOG_ROW = (False, 0.0, 0.0, 3.4e38, (0, 0, 0))


class CompiledScene(NamedTuple):
    """Stacked per-room buffers (R rooms) and per-asset-part draws (D
    draws; a level without any holds one dummy draw without faces),
    render_scene's two phases (scene.rs:196, 226)."""

    mesh: MeshArrays        # fields (R, V, ...)
    faces: FaceArrays       # fields (R, T, ...)
    atlas: TextureAtlas     # fields (R, ...): per-room trimmed atlases
    fog: Fog                # fields (R, ...)
    ambient: torch.Tensor   # (R,) f32
    lights: Lights          # the scene's lights; ambient set per room
    a_mesh: MeshArrays      # fields (D, V', ...)
    a_faces: FaceArrays     # fields (D, T', ...)
    a_atlas: TextureAtlas   # fields (D, ...): one texture per draw
    a_fog: Fog              # fields (D, ...): the containing room's fog
    a_ambient: torch.Tensor  # (D,) f32: the containing room's ambient
    a_room: object = None   # (D,) i32: the containing room of each draw
    a_count: int = 0        # draws with faces (the dummy draw is not one)
    # the 8-bit pipeline's tables (use_rgb555=False, scene.rs:214-219,
    # 163-168); None unless compiled with_8bit=True
    atlas8: object = None   # TextureAtlas8: every texture, untrimmed
    tex_map: object = None  # (R, NT) i32: room-local -> global texture id
    a_atlas8: object = None  # TextureAtlas8 fields (D, ...)


def collect_scene_lights(level, asset_library=None) -> List[dict]:
    """collect_scene_lights (scene.rs:32-69): the placed Light components
    as point-light specs (build.lights_from_list), with each placed
    object's overrides applied."""
    specs: List[dict] = []
    if asset_library is None:
        return specs
    for room in level.rooms:
        for obj in room.objects:
            if not obj.enabled:
                continue
            asset = asset_library.get_by_id(obj.asset_id)
            if asset is None:
                continue
            light = asset.light_component()
            if light is None:
                continue
            color, intensity, radius, offset = light
            ov = obj.light_override
            if ov is not None:
                color = ov.color if ov.color is not None else color
                intensity = (ov.intensity if ov.intensity is not None
                             else intensity)
                radius = ov.radius if ov.radius is not None else radius
                offset = ov.offset if ov.offset is not None else offset
            base = obj.world_position(room)
            pos = (float(base[0]) + offset[0], float(base[1]) + offset[1],
                   float(base[2]) + offset[2])
            specs.append(dict(kind="point", position=pos, radius=radius,
                              intensity=intensity, color=color))
    return specs


def transform_part_vertices(verts, facing: float, world_pos):
    """render_asset_parts' rotation about Y and translation
    (scene.rs:123-159), host f32 in the reference's operation order.
    Returns new vertex dicts (the input ones where there is nothing to
    transform)."""
    F = np.float32
    cos_f = F(np.cos(F(facing)))
    sin_f = F(np.sin(F(facing)))
    wp = np.asarray(world_pos, F)
    has_transform = (abs(float(facing)) > 0.0001
                     or abs(float(wp[0])) > 0.0001
                     or abs(float(wp[1])) > 0.0001
                     or abs(float(wp[2])) > 0.0001)
    if not has_transform:
        return verts
    out = []
    for v in verts:
        x, y, z = F(v["pos"][0]), F(v["pos"][1]), F(v["pos"][2])
        nx, ny, nz = F(v["normal"][0]), F(v["normal"][1]), F(v["normal"][2])
        rx = F(F(x * cos_f) - F(z * sin_f))
        rz = F(F(x * sin_f) + F(z * cos_f))
        out.append(dict(
            pos=(float(F(rx + wp[0])), float(F(y + wp[1])),
                 float(F(rz + wp[2]))),
            uv=v["uv"],
            normal=(float(F(F(nx * cos_f) - F(nz * sin_f))), float(ny),
                    float(F(F(nx * sin_f) + F(nz * cos_f)))),
            color=v["color"], color_blend=v.get("color_blend", 0)))
    return out


def resolve_part_texture15(part, user_textures) -> np.ndarray:
    """resolve_part_texture + the CLUT pre-bake (scene.rs:75-104,
    163-165): a TextureRef::Id resolves to the user texture's indices
    through its own palette, an embedded atlas through the checkerboard
    CLUT, anything else to the built-in 128x128 checkerboard.  Returns
    the (h, w) uint16 Color15 image."""
    ref = part.texture_ref
    if ref.kind == "Id" and user_textures is not None:
        tex = user_textures.get_by_id(ref.id)
        if tex is not None:
            return tex.to_texture15()
    if (ref.kind == "Embedded" and ref.embedded is not None
            and not ref.embedded.is_empty):
        return ref.embedded.to_texture15(mesh_mod.checkerboard_clut())
    atlas = mesh_mod.IndexedAtlas.new_checkerboard(128, 128, 0)
    return atlas.to_texture15(mesh_mod.checkerboard_clut())


def _rgba8_from_c15(c15: np.ndarray) -> np.ndarray:
    """Color15 -> RGBA8 as to_raster_texture (mesh_editor.rs:725-747):
    5 -> 8 bits as (v << 3) | (v >> 2), texel 0 (transparent) alpha 0
    (ERASE)."""
    r5, g5, b5 = (c15 >> 10) & 31, (c15 >> 5) & 31, c15 & 31
    return np.stack([((r5 << 3) | (r5 >> 2)).astype(np.uint8),
                     ((g5 << 3) | (g5 >> 2)).astype(np.uint8),
                     ((b5 << 3) | (b5 >> 2)).astype(np.uint8),
                     np.where(c15 == 0, 0, 255).astype(np.uint8)], axis=-1)


def _tex_rgba8(entry) -> np.ndarray:
    """The 8-bit view of a texture-table entry: its quantized RGBA8
    source where it keeps one (PackTexture.rgba8, types.rs:876), else its
    Color15 texels expanded."""
    if not isinstance(entry, tuple) \
            and getattr(entry, "rgba8", None) is not None:
        return entry.rgba8
    p15 = entry[0] if isinstance(entry, tuple) else entry.pixels15
    return _rgba8_from_c15(np.asarray(p15, np.uint16))


def _room_fog_params(room):
    """build_room_fog (scene.rs:264-276)."""
    f = room.fog
    if not f.enabled:
        return NO_FOG_ROW
    color = tuple(int(F32(F32(c) * F32(255.0))) for c in f.color)
    cull = float(F32(F32(F32(f.start) + F32(f.falloff)) + F32(f.cull_offset)))
    return True, float(f.start), float(f.falloff), cull, color


def _stack(trees):
    """Stack NamedTuples of tensors field by field."""
    return type(trees[0])(*(torch.stack(xs) for xs in zip(*trees)))


def _fog_rows(rows) -> Fog:
    return Fog(enabled=torch.tensor([f[0] for f in rows], dtype=torch.bool),
               start=torch.from_numpy(np.array([f[1] for f in rows], F32)),
               falloff=torch.from_numpy(np.array([f[2] for f in rows], F32)),
               cull_distance=torch.from_numpy(np.array([f[3] for f in rows],
                                                       F32)),
               color=torch.from_numpy(np.array([f[4] for f in rows],
                                               np.int32)))


def _mesh_of(verts, pad_to):
    return build.make_mesh_arrays(
        np.array([v["pos"] for v in verts], F32),
        np.array([v["uv"] for v in verts], F32),
        np.array([v["normal"] for v in verts], F32),
        np.array([v["color"] for v in verts], np.int32),
        np.array([v.get("color_blend", 0) for v in verts], np.int32),
        pad_to=pad_to)


def _no_faces(pad_to):
    return build.make_face_arrays(np.zeros((1, 3), np.int32),
                                  pad_to=pad_to)._replace(
        valid=torch.zeros(pad_to, dtype=torch.bool))


_ORIGIN = dict(pos=(0, 0, 0), uv=(0, 0), normal=(0, 0, 0),
               color=(128, 128, 128), color_blend=0)


def compile_level(level, textures, resolve,
                  light_specs: Optional[List[dict]] = None,
                  asset_library=None, user_textures=None,
                  light_pad: int = 8, with_8bit: bool = False,
                  device=None) -> CompiledScene:
    """Every room (and placed asset part) into stacked padded buffers on
    `device` (default: the card), as the JAX package compiles them.
    `textures`: (pixels15, blend) tuples or objects with `.pixels15`;
    `resolve`: TextureRef -> (id, width) or None.  Each room's texture
    ids are remapped to the textures it samples, in ascending global id
    order.  `with_8bit` also packs the 8-bit tables: every texture
    untrimmed (the reference's 8-bit branch samples the full list,
    scene.rs:214-219), each room's local -> global id map, and each asset
    draw's Color15 texture expanded as to_raster_texture expands it."""
    device = resolve_device(device)
    per_room = [room.to_render_data(resolve) for room in level.rooms]
    pad_verts = max(max((len(v) for v, _ in per_room), default=1), 1)
    pad_faces = max(max((len(f) for _, f in per_room), default=1), 1)
    tex_list = [t if isinstance(t, tuple) else (t.pixels15, 0)
                for t in textures]
    room_tex_lists, room_used = [], []
    for _, faces in per_room:
        used = sorted({f["tex_id"] for f in faces
                       if f.get("tex_id") is not None and f["tex_id"] >= 0})
        if not used:
            used = [0] if tex_list else []
        remap = {g: i for i, g in enumerate(used)}
        for f in faces:
            if f.get("tex_id") is not None and f["tex_id"] >= 0:
                f["tex_id"] = remap[f["tex_id"]]
        room_tex_lists.append([tex_list[g] for g in used])
        room_used.append(used)

    meshes, face_arrays = [], []
    for room_i, (verts, faces) in enumerate(per_room):
        verts = verts or [_ORIGIN]
        meshes.append(_mesh_of(verts, pad_verts))
        if not faces:
            face_arrays.append(_no_faces(pad_faces))
            continue
        uv = np.array([v["uv"] for v in verts], F32)
        vidx = np.array([(f["v0"], f["v1"], f["v2"]) for f in faces],
                        np.int32)
        tex_id = np.array([-1 if f.get("tex_id") is None else f["tex_id"]
                           for f in faces], np.int32)
        bt = np.array([f.get("black_transparent", True) for f in faces],
                      bool)
        face_arrays.append(build.make_face_arrays(
            vidx, tex_id, bt,
            np.array([f.get("blend_mode", 0) for f in faces], np.int32),
            np.array([f.get("editor_alpha", 255) for f in faces], np.int32),
            key_possible=build.compute_key_possible(
                uv, vidx, tex_id, bt, room_tex_lists[room_i]),
            pad_to=pad_faces))

    room_tex_lists = room_tex_lists or [[]]
    a_max = max(max(sum(p.shape[0] * p.shape[1] for p, _ in lst)
                    for lst in room_tex_lists), 1)
    a_max = -(-a_max // 128) * 128
    nt_max = max(max(len(lst) for lst in room_tex_lists), 1)
    atlas = _stack([build.build_atlas(lst, pad_data_to=a_max,
                                      pad_count_to=nt_max)
                    for lst in room_tex_lists])
    fog = _fog_rows([_room_fog_params(r) for r in level.rooms]
                    or [NO_FOG_ROW])
    ambient = torch.from_numpy(np.array([r.ambient for r in level.rooms]
                                        or [0.5], F32))
    lights = build.lights_from_list(light_specs or [], pad=light_pad)

    # the placed asset draws (scene.rs:226-259)
    draws, draw_rooms = [], []
    if asset_library is not None:
        for room_idx, room in enumerate(level.rooms):
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
                    draws.append((transform_part_vertices(verts, obj.facing,
                                                          wp),
                                  pfaces,
                                  resolve_part_texture15(part,
                                                         user_textures),
                                  fog_row, room.ambient, part.double_sided))
                    draw_rooms.append(room_idx)
    a_count = len(draws)
    if not draws:
        draws = [([_ORIGIN], [], np.full((1, 1), 0x7FFF, np.uint16),
                  NO_FOG_ROW, 0.5, False)]
        draw_rooms = [0]

    av_max = max(max(len(d[0]) for d in draws), 1)
    at_max = max(max(len(d[1]) for d in draws), 1)
    aa_max = max(d[2].shape[0] * d[2].shape[1] for d in draws)
    aa_max = -(-aa_max // 128) * 128
    a_meshes, a_face_arrays, a_atlases = [], [], []
    for verts, pfaces, tex15, _, _, ds in draws:
        a_meshes.append(_mesh_of(verts, av_max))
        if pfaces:
            uv = np.array([v["uv"] for v in verts], F32)
            vidx = np.array([(f["v0"], f["v1"], f["v2"]) for f in pfaces],
                            np.int32)
            tid = np.array([0 if f.get("tex_id") is not None else -1
                            for f in pfaces], np.int32)
            bt = np.array([f.get("black_transparent", True) for f in pfaces],
                          bool)
            a_face_arrays.append(build.make_face_arrays(
                vidx, tid, bt,
                np.array([f.get("blend_mode", 0) for f in pfaces], np.int32),
                double_sided=np.full(len(pfaces), ds, bool),
                key_possible=build.compute_key_possible(uv, vidx, tid, bt,
                                                        [(tex15, 0)]),
                pad_to=at_max))
        else:
            a_face_arrays.append(_no_faces(at_max))
        a_atlases.append(build.build_atlas([(tex15, 0)], pad_data_to=aa_max,
                                           pad_count_to=1))
    tables8 = {}
    if with_8bit:
        tex_map = np.zeros((len(room_used) or 1, nt_max), np.int32)
        for i, used in enumerate(room_used):
            tex_map[i, :len(used)] = used
        tables8 = dict(
            atlas8=build.build_atlas8(
                [(_tex_rgba8(t), 0) for t in textures]
                or [(np.full((1, 1, 4), 255, np.uint8), 0)], device="cpu"),
            tex_map=torch.from_numpy(tex_map),
            a_atlas8=_stack([build.build_atlas8(
                [(_rgba8_from_c15(np.asarray(d[2], np.uint16)), 0)],
                pad_data_to=aa_max, pad_count_to=1, device="cpu")
                for d in draws]))
    scene = CompiledScene(
        mesh=_stack(meshes), faces=_stack(face_arrays), atlas=atlas,
        fog=fog, ambient=ambient, lights=lights,
        a_mesh=_stack(a_meshes), a_faces=_stack(a_face_arrays),
        a_atlas=_stack(a_atlases), a_fog=_fog_rows([d[3] for d in draws]),
        a_ambient=torch.from_numpy(np.array([d[4] for d in draws], F32)),
        a_room=torch.from_numpy(np.array(draw_rooms, np.int32)),
        a_count=a_count, **tables8)
    return to_device(scene, device)


def _index(tree, i):
    return type(tree)(*(x[i] for x in tree))


def render_level(fb: FrameBuffers, scene: CompiledScene,
                 cams: CameraArrays, settings: RasterSettings,
                 depth_mode: str = "fast", skip_rooms: tuple = (),
                 use_fog: bool = True,
                 render_assets: bool = True) -> FrameBuffers:
    """render_scene (scene.rs:180-261) into (I, H, W) framebuffers, one
    camera of `cams` each: the rooms in order, each with its own ambient
    and fog, then the placed asset parts, each through
    render.render_mesh_15 in `depth_mode`.

    `skip_rooms`, `use_fog` and `render_assets` are SceneRenderOptions
    (scene.rs:172-178), the world editor's: the rooms listed (and the
    objects placed in them) are skipped, fog can be forced off, and the
    asset draws left out.  Which rooms draw is decided on the host before
    any launch.  `settings.use_rgb555=False` draws with the 8-bit
    pipeline (`_render_level8`), which needs a scene compiled
    `with_8bit=True`."""
    if not settings.use_rgb555:
        if scene.atlas8 is None:
            raise ValueError(
                "use_rgb555=False needs compile_level(..., with_8bit=True)")
        return _render_level8(fb, scene, cams, settings)
    n_rooms = scene.ambient.shape[0]
    room_ok = [True] * n_rooms
    for r in skip_rooms:
        if 0 <= r < n_rooms:
            room_ok[r] = False

    def draw(fb, mesh, faces, atlas, fog, ambient):
        if not use_fog:
            fog = fog._replace(enabled=torch.zeros_like(fog.enabled))
        return render_mesh_15(fb, mesh, faces, atlas, cams,
                              scene.lights._replace(ambient=ambient), fog,
                              settings, depth_mode=depth_mode)

    for i in range(n_rooms):
        if room_ok[i]:
            fb = draw(fb, _index(scene.mesh, i), _index(scene.faces, i),
                      _index(scene.atlas, i), _index(scene.fog, i),
                      scene.ambient[i])
    if not render_assets or not scene.a_count:
        return fb
    a_room = scene.a_room.tolist() if skip_rooms else [0] * scene.a_count
    for i in range(scene.a_count):
        if room_ok[min(max(a_room[i], 0), n_rooms - 1)]:
            fb = draw(fb, _index(scene.a_mesh, i), _index(scene.a_faces, i),
                      _index(scene.a_atlas, i), _index(scene.a_fog, i),
                      scene.a_ambient[i])
    return fb


def _render_level8(fb: FrameBuffers, scene: CompiledScene,
                   cams: CameraArrays,
                   settings: RasterSettings) -> FrameBuffers:
    """The use_rgb555=False branch (scene.rs:216-218 `render_mesh`): every
    room through ops/raster8.render_mesh8 against the untrimmed 8-bit
    atlas, its faces' texture ids mapped room-local -> global, without
    fog (fog is the 15-bit pipeline's); then the asset draws, each
    against its own 8-bit texture.  As in the JAX package, the depth
    mode and the editor's scene options do not apply: the 8-bit pipeline
    tests z < buffer, so the frame must be cleared to F32_MAX (on the
    inverse-z clear no face passes the z-buffer)."""
    fog0 = no_fog(device=fb.color.device)
    for i in range(scene.ambient.shape[0]):
        faces = _index(scene.faces, i)
        tid = faces.tex_id
        faces = faces._replace(tex_id=torch.where(
            tid >= 0, scene.tex_map[i][torch.clamp(tid, min=0).long()], tid))
        fb = render_mesh8(fb, _index(scene.mesh, i), faces, scene.atlas8,
                          cams, scene.lights._replace(
                              ambient=scene.ambient[i]), fog0, settings)
    for i in range(scene.a_count):
        fb = render_mesh8(fb, _index(scene.a_mesh, i),
                          _index(scene.a_faces, i),
                          _index(scene.a_atlas8, i), cams,
                          scene.lights._replace(ambient=scene.a_ambient[i]),
                          fog0, settings)
    return fb
