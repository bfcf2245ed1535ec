"""Host side of the scene compile (bonnie32_tpu/models/scene.py): the
placed-asset helpers that models/scene_flat.compile_level_flat needs.

`collect_scene_lights` gathers the point lights of placed Light
components, `transform_part_vertices` places an asset part's vertices in
the world, `resolve_part_texture15` resolves a part's texture to a
Color15 image.  All three run on the host in numpy f32, in the
reference's operation order, as in the JAX package.  The per-room
sequential renderer of that module (`compile_level`, `render_level`) is
not ported yet (ROADMAP.md queue 1).
"""

from typing import List

import numpy as np

from . import mesh as mesh_mod


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
