"""3D-viewport overlay rendering: previews, selection, rooms, portals
(bonnie32_tpu/editor/viewport_render.py).

The overlay phase of `draw_viewport_3d` (the reference's
`src/editor/viewport_3d.rs:3492-5654`) drawn headlessly into the same
framebuffer the scene rendered into:

  * floor/ceiling placement grids — 5x5 teal line grid + white corner
    points centered on the hovered sector (:3496-3650),
  * wall / diagonal-wall previews — gap-detected quad outline, teal for
    a new wall, orange when filling a gap between existing walls, with
    white corner markers (:3766-3980, colors :3229-3231),
  * room boundary wireframes — 12 AABB edges per visible room, bright
    blue for the current room, dim gray otherwise (:3981-4048),
  * portal outlines — magenta for horizontal portals, cyan for wall
    portals, depth-tested overlay lines (:4049-4090),
  * selection highlights (yellow/orange :4863) for the primary and all
    multi-selections, split-aware triangle edges for floors/ceilings and
    quad edges for walls; vertex selections add a corner point,
  * hover highlight (light blue :4492) for the hovered face when it is
    not already selected.

Line batches group by color and draw through ops.draw2d — previews and
selection use the reference's non-depth-tested draw_3d_line; room bounds
and portals use the depth-biased overlay variant (render.rs:764).

The segment lists, points and gizmo shapes are host data, built as in the
JAX package; the lines are torch code on the framebuffer's device, each
colour group one scatter (the depth-tested groups draw at alpha 255,
where the alpha pass's blend gives the line's colour whatever lies
behind it).  The editor camera is one camera: it draws the same into
every instance of an (I, H, W) framebuffer.  The entry points
(`render_editor_viewport`, `render_player_camera_preview`) run on the
card unless the caller passes `device="cpu"`.
"""

from typing import List, Tuple

import numpy as np
import torch

from ..models.level import NESW, NORTH, NWSE, SECTOR_SIZE, EAST, SOUTH, WEST
from ..ops import draw2d
from ..ops.fixed import f32_to_i32
from ..ops.picking import world_to_screen
from ..types import CameraArrays, FrameBuffers, resolve_device, to_device
from .state import CEILING_HEIGHT, EditorState, EditorTool, SectorFace

F32 = np.float32

# Overlay palette (viewport_3d.rs)
GRID_INNER = (80, 180, 160)      # :3499 teal bright
GRID_OUTER = (40, 90, 80)        # :3500 teal dim
VERTEX_WHITE = (255, 255, 255)   # :3548
NEW_WALL = (80, 200, 180)        # :3229
GAP_FILL = (255, 180, 80)        # :3230
ROOM_CURRENT = (80, 120, 200)    # :3991
ROOM_OTHER = (60, 60, 80)        # :3993
PORTAL_HORIZONTAL = (255, 100, 255)  # :4056
PORTAL_WALL = (100, 255, 255)    # :4058
SELECT_COLOR = (255, 200, 80)    # :4863
HOVER_COLOR = (150, 200, 255)    # :4492


class _Batch:
    """Segment/point collector; one draw call per (color, depth mode)."""

    def __init__(self):
        self.segs: dict = {}     # (rgb, depth) -> [(p0, p1), ...]
        self.points: List[Tuple[np.ndarray, int, tuple]] = []

    def line(self, p0, p1, rgb, depth=False):
        self.segs.setdefault((rgb, depth), []).append(
            (np.asarray(p0, F32), np.asarray(p1, F32)))

    def quad(self, corners, rgb, depth=False):
        for i in range(4):
            self.line(corners[i], corners[(i + 1) % 4], rgb, depth)

    def point(self, p, size, rgb):
        self.points.append((np.asarray(p, F32), size, rgb))

    def flush(self, fb: FrameBuffers, camera: CameraArrays,
              depth_mode: str) -> FrameBuffers:
        height, width = fb.color.shape[-2:]
        for (rgb, depth), segs in self.segs.items():
            p0 = np.stack([s[0] for s in segs])
            p1 = np.stack([s[1] for s in segs])
            if not depth:
                fb = draw2d.draw_3d_lines_clipped(fb, p0, p1, camera, rgb)
            else:
                # draw_line_3d_overlay (render.rs:764): segments with an
                # endpoint behind the camera are dropped, not clipped
                # (viewport_3d.rs:4045 `if let (Some, Some)`)
                sx0, sy0, z0, ok0 = _w2s(p0, camera, width, height)
                sx1, sy1, z1, ok1 = _w2s(p1, camera, width, height)
                ex = f32_to_i32(torch.stack([sx0, sx1], dim=-1))
                ey = f32_to_i32(torch.stack([sy0, sy1], dim=-1))
                ez = torch.stack([z0, z1], dim=-1)
                fb = draw2d.draw_lines_3d_alpha(
                    fb, ex, ey, ez, rgb, 255, valid=ok0 & ok1,
                    depth_mode=depth_mode)
        if self.points:
            # every point projected at once, read on the host once
            sx, sy, ok = _projected(camera, np.stack(
                [p for p, _, _ in self.points]), width, height)
            for i, (_, size, rgb) in enumerate(self.points):
                if ok[i]:
                    x, y = int(sx[i]), int(sy[i])
                    r = size // 2
                    fb = draw2d.draw_filled_rect(fb, x - r, y - r, x + r,
                                                 y + r, rgb)
        return fb


def _w2s(pts, camera: CameraArrays, width, height):
    """world_to_screen of host points (P, 3) by the camera(s) (I,):
    (trunc(sx), trunc(sy), cam_z, valid), each (I, P)."""
    pos = camera.position
    sx, sy, cz, ok = world_to_screen(
        torch.as_tensor(np.asarray(pts, np.float32), device=pos.device),
        pos.reshape(-1, 1, 3), camera.basis.reshape(-1, 1, 3, 3), width,
        height)
    return torch.trunc(sx), torch.trunc(sy), cz, ok


def _camera(state: EditorState, device) -> CameraArrays:
    """The editor camera as one camera (1, 3) / (1, 3, 3) on `device`."""
    return CameraArrays(
        position=torch.as_tensor(np.asarray(state.camera_pos, np.float32),
                                 device=device).reshape(1, 3),
        basis=torch.as_tensor(np.asarray(state.camera_basis(), np.float32),
                              device=device).reshape(1, 3, 3))


def _projected(camera: CameraArrays, pts, width, height):
    """The projection of points (P, 3) by the first camera, read back:
    (trunc(sx), trunc(sy), valid) numpy arrays."""
    sx, sy, _, ok = _w2s(pts, camera, width, height)
    return sx[0].cpu().numpy(), sy[0].cpu().numpy(), ok[0].cpu().numpy()


# ---------------------------------------------------------------------------
# the overlays
# ---------------------------------------------------------------------------

def _placement_grid(batch: _Batch, state: EditorState, editor) -> None:
    """viewport_3d.rs:3496-3650 — 5x5 grid + corner points at the hovered
    cell, on the floor plane or the ceiling plane by tool."""
    if editor is None or editor.preview_sector is None:
        return
    if state.tool not in (EditorTool.DRAW_FLOOR, EditorTool.DRAW_CEILING):
        return
    room = state.current_room_ref()
    room_y = float(room.position[1]) if room is not None else 0.0
    grid_y = room_y + (CEILING_HEIGHT
                       if state.tool == EditorTool.DRAW_CEILING else 0.0)
    snapped_x, snapped_z = editor.preview_sector[0], editor.preview_sector[1]
    sx = np.floor(snapped_x / SECTOR_SIZE) * SECTOR_SIZE
    sz = np.floor(snapped_z / SECTOR_SIZE) * SECTOR_SIZE
    cx = sx + SECTOR_SIZE * 0.5
    cz = sz + SECTOR_SIZE * 0.5
    inner_half = SECTOR_SIZE * 1.5
    outer_half = SECTOR_SIZE * 2.5
    for i in range(6):
        off = -outer_half + i * SECTOR_SIZE
        rgb = GRID_INNER if abs(off) <= inner_half else GRID_OUTER
        batch.line((cx - outer_half, grid_y, cz + off),
                   (cx + outer_half, grid_y, cz + off), rgb)
        batch.line((cx + off, grid_y, cz - outer_half),
                   (cx + off, grid_y, cz + outer_half), rgb)
    for dx, dz in ((0, 0), (SECTOR_SIZE, 0), (SECTOR_SIZE, SECTOR_SIZE),
                   (0, SECTOR_SIZE)):
        batch.point((sx + dx, grid_y, sz + dz), 3, VERTEX_WHITE)


def _wall_edge_corners(room, gx, gz, d, heights):
    """World-space wall quad corners for direction `d` with the emitter's
    corner order [BL, BR, TR, TL] (models/level.py _Emitter.wall)."""
    bx = float(room.position[0]) + gx * SECTOR_SIZE
    bz = float(room.position[2]) + gz * SECTOR_SIZE
    y = float(room.position[1])
    s = SECTOR_SIZE
    h = [y + float(v) for v in heights]
    if d == NORTH:
        pts = [(bx, h[0], bz), (bx + s, h[1], bz),
               (bx + s, h[2], bz), (bx, h[3], bz)]
    elif d == EAST:
        pts = [(bx + s, h[0], bz), (bx + s, h[1], bz + s),
               (bx + s, h[2], bz + s), (bx + s, h[3], bz)]
    elif d == SOUTH:
        pts = [(bx + s, h[0], bz + s), (bx, h[1], bz + s),
               (bx, h[2], bz + s), (bx + s, h[3], bz + s)]
    elif d == WEST:
        pts = [(bx, h[0], bz + s), (bx, h[1], bz),
               (bx, h[2], bz), (bx, h[3], bz + s)]
    elif d == NWSE:
        pts = [(bx + s, h[1], bz + s), (bx, h[0], bz),
               (bx, h[3], bz), (bx + s, h[2], bz + s)]
    else:  # NESW
        pts = [(bx, h[1], bz + s), (bx + s, h[0], bz),
               (bx + s, h[3], bz), (bx, h[2], bz + s)]
    return [np.asarray(p, F32) for p in pts]


def _wall_preview(batch: _Batch, state: EditorState, editor) -> None:
    """viewport_3d.rs:3766-3980 — gap-detected preview quad + corners."""
    if editor is None or state.tool != EditorTool.DRAW_WALL:
        return
    cur = editor.wall_drag_current
    room = state.current_room_ref()
    if cur is None or room is None:
        return
    heights = editor.wall_preview()
    if heights is None:
        return
    gx, gz, d = cur
    sector = room.get_sector(gx, gz)
    filling = sector is not None and len(sector.walls(d)) > 0
    rgb = GAP_FILL if filling else NEW_WALL
    corners = _wall_edge_corners(room, gx, gz, d, heights)
    batch.quad(corners, rgb)
    for c in corners:
        batch.point(c, 3, VERTEX_WHITE)


def _room_bounds_and_portals(batch: _Batch, state: EditorState) -> None:
    """viewport_3d.rs:3981-4090."""
    if not getattr(state, "show_room_bounds", True):
        return
    for room_idx, room in enumerate(state.level.rooms):
        if room_idx in state.hidden_rooms:
            continue
        rgb = ROOM_CURRENT if room_idx == state.current_room else ROOM_OTHER
        min_x = float(room.position[0])
        min_z = float(room.position[2])
        max_x = min_x + room.width * SECTOR_SIZE
        max_z = min_z + room.depth * SECTOR_SIZE
        min_y = float(room.position[1]) + float(room.bounds_min[1])
        max_y = float(room.position[1]) + float(room.bounds_max[1])
        if min_y > max_y or min_x > max_x or min_z > max_z:
            continue
        c = [(min_x, min_y, min_z), (max_x, min_y, min_z),
             (max_x, min_y, max_z), (min_x, min_y, max_z),
             (min_x, max_y, min_z), (max_x, max_y, min_z),
             (max_x, max_y, max_z), (min_x, max_y, max_z)]
        for i, j in ((0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6),
                     (6, 7), (7, 4), (0, 4), (1, 5), (2, 6), (3, 7)):
            batch.line(c[i], c[j], rgb, depth=True)
        for portal in room.portals:
            horizontal = abs(float(portal.normal[1])) > 0.9
            prgb = PORTAL_HORIZONTAL if horizontal else PORTAL_WALL
            verts = (np.asarray(portal.vertices, F32)
                     + np.asarray(room.position, F32)[None, :])
            for i in range(4):
                batch.line(verts[i], verts[(i + 1) % 4], prgb, depth=True)


def _face_edges(batch: _Batch, room, gx, gz, face: SectorFace, rgb) -> bool:
    """Edges of one selected/hovered sector face (viewport_3d.rs:4874-5100
    selection closure).  Returns False if the face no longer exists."""
    sector = room.get_sector(gx, gz)
    if sector is None:
        return False
    bx = float(room.position[0]) + gx * SECTOR_SIZE
    bz = float(room.position[2]) + gz * SECTOR_SIZE
    y = float(room.position[1])
    s = SECTOR_SIZE

    if face.kind in ("floor", "ceiling"):
        f = sector.floor if face.kind == "floor" else sector.ceiling
        if f is None:
            return False
        h1 = [y + float(v) for v in f.heights]
        h2 = [y + float(v) for v in f.get_heights_2()]
        p1 = [(bx, h1[0], bz), (bx + s, h1[1], bz),
              (bx + s, h1[2], bz + s), (bx, h1[3], bz + s)]
        p2 = [(bx, h2[0], bz), (bx + s, h2[1], bz),
              (bx + s, h2[2], bz + s), (bx, h2[3], bz + s)]
        if f.split_direction == 0:   # NwSe: tri1 NW-NE-SE, tri2 NW-SE-SW
            edges = [(p1, 0, 1), (p1, 1, 2), (p2, 2, 3), (p2, 3, 0),
                     (p1, 0, 2), (p2, 0, 2)]
        else:                        # NeSw: tri1 NW-NE-SW, tri2 NE-SE-SW
            edges = [(p1, 0, 1), (p2, 1, 2), (p2, 2, 3), (p1, 3, 0),
                     (p1, 1, 3), (p2, 1, 3)]
        seen = set()
        for pts, i, j in edges:
            key = (pts[i], pts[j])
            if key in seen:
                continue
            seen.add(key)
            batch.line(pts[i], pts[j], rgb)
        return True

    walls = sector.walls(face.direction)
    if not (0 <= face.wall_index < len(walls)):
        return False
    corners = _wall_edge_corners(room, gx, gz, face.direction,
                                 walls[face.wall_index].heights)
    batch.quad(corners, rgb)
    return True


def _ring(batch, center, radius, y, rgb, segments=12, axis="y"):
    import math
    pts = []
    for i in range(segments):
        a = 2.0 * math.pi * i / segments
        if axis == "y":
            pts.append((center[0] + radius * math.cos(a), y,
                        center[2] + radius * math.sin(a)))
        elif axis == "x":
            pts.append((center[0], center[1] + radius * math.cos(a),
                        center[2] + radius * math.sin(a)))
        else:
            pts.append((center[0] + radius * math.cos(a),
                        center[1] + radius * math.sin(a), center[2]))
    for i in range(segments):
        batch.line(pts[i], pts[(i + 1) % segments], rgb, depth=True)


def _wire_sphere(batch, center, radius, rgb, segments=12):
    """draw_wireframe_sphere (viewport_3d.rs:6023): equator + two great
    circles."""
    _ring(batch, center, radius, center[1], rgb, segments, axis="y")
    _ring(batch, center, radius, None, rgb, segments, axis="x")
    _ring(batch, center, radius, None, rgb, segments, axis="z")


def _wire_cylinder(batch, center, radius, height, rgb, segments=12):
    """Rings + every-other vertical (game/renderer.rs:984 style)."""
    import math
    _ring(batch, center, radius, center[1], rgb, segments)
    _ring(batch, center, radius, center[1] + height, rgb, segments)
    step = 2 if segments > 8 else 1
    for i in range(0, segments, step):
        a = 2.0 * math.pi * i / segments
        x = center[0] + radius * math.cos(a)
        z = center[2] + radius * math.sin(a)
        batch.line((x, center[1], z), (x, center[1] + height, z), rgb,
                   depth=True)


def _rotated_box(batch, mn, mx, world_pos, facing, rgb):
    """draw_rotated_bounding_box: local AABB yawed by facing at
    world_pos."""
    import math
    c, s = math.cos(facing), math.sin(facing)
    corners = []
    for x in (mn[0], mx[0]):
        for y in (mn[1], mx[1]):
            for z in (mn[2], mx[2]):
                corners.append((world_pos[0] + x * c + z * s,
                                world_pos[1] + y,
                                world_pos[2] - x * s + z * c))
    # index bits: x*4 + y*2 + z
    for i, j in ((0, 1), (0, 2), (0, 4), (1, 3), (1, 5), (2, 3), (2, 6),
                 (3, 7), (4, 5), (4, 6), (5, 7), (6, 7)):
        batch.line(corners[i], corners[j], rgb, depth=True)


def _octahedron(fb, batch, camera, center, size, rgb):
    """draw_filled_octahedron (viewport_3d.rs:6223-6293): 8 same-color
    scanline-filled faces (not z-tested, as in the reference) + 3/4-bright
    edges.  A face is drawn iff all three of ITS vertices project
    (per-face Option check, :6270-6274) — not all six."""
    height, width = fb.color.shape[-2:]
    verts = np.array([
        [center[0], center[1] + size, center[2]],   # top
        [center[0], center[1] - size, center[2]],   # bottom
        [center[0], center[1], center[2] + size],   # front
        [center[0], center[1], center[2] - size],   # back
        [center[0] - size, center[1], center[2]],   # left
        [center[0] + size, center[1], center[2]],   # right
    ], F32)
    sx, sy, ok = _projected(camera, verts, width, height)
    if not ok.any():
        return fb
    for a, b, c in ((0, 2, 5), (0, 5, 3), (0, 3, 4), (0, 4, 2),
                    (1, 5, 2), (1, 3, 5), (1, 4, 3), (1, 2, 4)):
        if not (ok[a] and ok[b] and ok[c]):
            continue
        fb = draw2d.draw_filled_triangle_scanline(
            fb, (sx[a], sy[a]), (sx[b], sy[b]), (sx[c], sy[c]), rgb)
    edge = tuple(int(v) * 3 // 4 for v in rgb)
    for i, j in ((0, 2), (0, 3), (0, 4), (0, 5), (1, 2), (1, 3), (1, 4),
                 (1, 5), (2, 5), (5, 3), (3, 4), (4, 2)):
        batch.line(verts[i], verts[j], edge)
    return fb


# Gizmo palette (viewport_3d.rs:4111-4131)
GIZMO_SPAWN = (100, 255, 100)
GIZMO_LIGHT = (255, 255, 100)
GIZMO_LIGHT_OFF = (80, 80, 80)
GIZMO_ENEMY = (255, 100, 100)
GIZMO_MESH = (180, 130, 255)
GIZMO_TRIGGER = (255, 100, 200)
GIZMO_PLAIN = (100, 100, 100)
GIZMO_SELECTED_BOX = (255, 200, 50)


def _asset_gizmos(fb, batch: _Batch, state: EditorState,
                  camera: CameraArrays) -> FrameBuffers:
    """viewport_3d.rs:4088-4272 — per placed object: light octahedron,
    player-spawn collision cylinder + camera indicator, collision-shape
    wireframes, fallback screen-space dots, selected bounding box."""
    lib = state.asset_library
    if lib is None:
        return fb
    height, width = fb.color.shape[-2:]
    for room_idx, room in enumerate(state.level.rooms):
        for obj_idx, obj in enumerate(room.objects):
            wp = obj.world_position(room)
            sx, sy, ok = _projected(camera, wp[None, :], width, height)
            if not bool(ok[0]):
                continue
            selected = (state.selection.kind == "object"
                        and state.selection.room == room_idx
                        and state.selection.index == obj_idx)
            asset = lib.get_by_id(obj.asset_id)
            if asset is None:
                fb = draw2d.draw_circle_outline(
                    fb, int(sx[0]), int(sy[0]), 5, GIZMO_PLAIN)
                continue
            if asset.has_light():
                light = asset.light_component()
                offset = light[3] if light else (0.0, 0.0, 0.0)
                if obj.light_override is not None \
                        and obj.light_override.offset is not None:
                    offset = obj.light_override.offset
                pos = (wp[0] + offset[0], wp[1] + offset[1],
                       wp[2] + offset[2])
                size = 80.0 if selected else 50.0
                rgb = ((255, 255, 255) if selected else
                       GIZMO_LIGHT if obj.enabled else GIZMO_LIGHT_OFF)
                fb = _octahedron(fb, batch, camera, pos, size, rgb)
            elif asset.has_spawn_point(True):
                ps = state.level.player_settings
                rgb = GIZMO_SPAWN if selected else GIZMO_PLAIN
                _wire_cylinder(batch, wp, ps.radius, ps.height, rgb)
                cam_pos = (wp[0], wp[1] + ps.camera_height,
                           wp[2] - ps.camera_distance)
                crgb = (255, 255, 100) if selected else (120, 120, 80)
                _wire_sphere(batch, cam_pos, 30.0, crgb, 6)
                batch.line((wp[0], wp[1] + ps.height, wp[2]), cam_pos,
                           crgb, depth=True)
            else:
                shape = asset.collision_shape()
                if shape is not None:
                    d = asset.collision_component() or {}
                    rgb = ((255, 255, 255) if selected
                           else (100, 255, 150) if d.get("is_trigger")
                           else (100, 150, 255))
                    if shape.kind == "sphere":
                        _wire_sphere(batch, wp, shape.radius, rgb, 16)
                    elif shape.kind == "box":
                        hx, hy, hz = shape.half_extents
                        _rotated_box(batch, (-hx, -hy, -hz), (hx, hy, hz),
                                     wp, obj.facing, rgb)
                    elif shape.kind == "cylinder":
                        _wire_cylinder(batch, wp, shape.radius,
                                       shape.height, rgb)
                    elif shape.kind == "capsule":
                        _wire_cylinder(batch, wp, shape.radius,
                                       shape.height, rgb)
                        _wire_sphere(batch, (wp[0], wp[1], wp[2]),
                                     shape.radius, rgb)
                        _wire_sphere(batch,
                                     (wp[0], wp[1] + shape.height, wp[2]),
                                     shape.radius, rgb)
                else:
                    base = 8 if selected else 5
                    col = (GIZMO_ENEMY if asset.has_enemy()
                           else GIZMO_MESH if asset.has_mesh()
                           else GIZMO_TRIGGER if asset.has_trigger()
                           else GIZMO_PLAIN)
                    if selected:
                        fb = draw2d.draw_circle(fb, int(sx[0]), int(sy[0]),
                                                base + 3, (255, 255, 255))
                    fb = draw2d.draw_circle(fb, int(sx[0]), int(sy[0]),
                                            base, col)
            if selected and asset.has_mesh():
                b = _asset_bounds(asset)
                if b is not None:
                    _rotated_box(batch, b[0], b[1], wp, obj.facing,
                                 GIZMO_SELECTED_BOX)
    return fb


def _asset_bounds(asset):
    """Asset::bounds — AABB over all mesh part vertices."""
    parts = asset.mesh() or []
    pts = []
    for part in parts:
        for v in getattr(part.mesh, "vertices", []):
            pts.append(v.pos if hasattr(v, "pos") else v["pos"])
    if not pts:
        return None
    arr = np.asarray(pts, F32)
    return arr.min(axis=0), arr.max(axis=0)


def _selection_overlays(batch: _Batch, state: EditorState) -> None:
    """Primary + multi selections (viewport_3d.rs:4863-5260)."""
    for sel in [state.selection] + state.multi_selection:
        if sel.kind not in ("sector_face", "vertex", "sector"):
            continue
        if not (0 <= sel.room < len(state.level.rooms)):
            continue
        room = state.level.rooms[sel.room]
        if sel.kind == "sector":
            # highlight the sector footprint through its floor (or flat
            # outline at room height when no floor exists)
            face = SectorFace(kind="floor")
            if not _face_edges(batch, room, sel.x, sel.z, face,
                               SELECT_COLOR):
                bx = float(room.position[0]) + sel.x * SECTOR_SIZE
                bz = float(room.position[2]) + sel.z * SECTOR_SIZE
                yy = float(room.position[1])
                s = SECTOR_SIZE
                batch.quad([(bx, yy, bz), (bx + s, yy, bz),
                            (bx + s, yy, bz + s), (bx, yy, bz + s)],
                           SELECT_COLOR)
            continue
        if sel.face is None:
            continue
        _face_edges(batch, room, sel.x, sel.z, sel.face, SELECT_COLOR)
        if sel.kind == "vertex":
            sector = room.get_sector(sel.x, sel.z)
            if sector is None:
                continue
            if sel.face.kind in ("floor", "ceiling"):
                f = (sector.floor if sel.face.kind == "floor"
                     else sector.ceiling)
                if f is None:
                    continue
                corner_off = [(0.0, 0.0), (SECTOR_SIZE, 0.0),
                              (SECTOR_SIZE, SECTOR_SIZE), (0.0, SECTOR_SIZE)]
                dx, dz = corner_off[sel.corner_idx % 4]
                p = (float(room.position[0]) + sel.x * SECTOR_SIZE + dx,
                     float(room.position[1]) + float(
                         f.heights[sel.corner_idx % 4]),
                     float(room.position[2]) + sel.z * SECTOR_SIZE + dz)
            else:
                walls = sector.walls(sel.face.direction)
                if not (0 <= sel.face.wall_index < len(walls)):
                    continue
                corners = _wall_edge_corners(
                    room, sel.x, sel.z, sel.face.direction,
                    walls[sel.face.wall_index].heights)
                p = corners[sel.corner_idx % 4]
            batch.point(p, 5, SELECT_COLOR)


def _hover_overlay(batch: _Batch, state: EditorState, hover) -> None:
    """viewport_3d.rs:4481 — hovered face edges unless already selected.

    `hover` is the reference's `hovered_face`: (room_idx, gx, gz,
    SectorFace) — e.g. a hover.py HoverResult's quad tag."""
    if hover is None:
        return
    room_idx, gx, gz, face = hover
    if face is None:
        return
    sel = state.selection
    if (sel.kind in ("sector_face", "vertex") and sel.face == face
            and (sel.room, sel.x, sel.z) == (room_idx, gx, gz)):
        return
    if not (0 <= room_idx < len(state.level.rooms)):
        return
    _face_edges(batch, state.level.rooms[room_idx], gx, gz, face,
                HOVER_COLOR)


PASTE_PREVIEW = (150, 255, 150)   # viewport_3d.rs paste ghost (green)


def _paste_preview(batch: _Batch, state: EditorState, paste_hover) -> None:
    """viewport_3d.rs:4660 — the geometry clipboard's ghost wireframe at
    the hovered cell: each copied face outlines at its transformed offset
    (quad + split diagonal for horizontal faces, quads for walls)."""
    if paste_hover is None or not state.geometry_clipboard.faces:
        return
    room = state.current_room_ref()
    if room is None:
        return
    hx, hz = paste_hover
    y = float(room.position[1])
    s = SECTOR_SIZE
    for cf in state.geometry_clipboard.faces:
        ox, oz = state.geometry_clipboard.transformed_offset(cf.rel_x,
                                                             cf.rel_z)
        gx, gz = hx + ox, hz + oz
        bx = float(room.position[0]) + gx * s
        bz = float(room.position[2]) + gz * s
        if cf.kind in ("floor", "ceiling"):
            h = [y + float(v) for v in cf.face.heights]
            pts = [(bx, h[0], bz), (bx + s, h[1], bz),
                   (bx + s, h[2], bz + s), (bx, h[3], bz + s)]
            batch.quad(pts, PASTE_PREVIEW)
            d = ((0, 2) if cf.face.split_direction == 0 else (1, 3))
            batch.line(pts[d[0]], pts[d[1]], PASTE_PREVIEW)
        else:
            corners = _wall_edge_corners(room, gx, gz, cf.direction,
                                         cf.face.heights)
            batch.quad(corners, PASTE_PREVIEW)


def draw_viewport_overlays(fb: FrameBuffers, state: EditorState,
                           editor=None, hover=None, paste_hover=None,
                           depth_mode: str = "inv") -> FrameBuffers:
    """Compose every overlay onto a rendered viewport framebuffer
    (I, H, W), on its device."""
    camera = _camera(state, fb.color.device)
    batch = _Batch()
    _placement_grid(batch, state, editor)
    _wall_preview(batch, state, editor)
    _room_bounds_and_portals(batch, state)
    fb = _asset_gizmos(fb, batch, state, camera)
    _selection_overlays(batch, state)
    _hover_overlay(batch, state, hover)
    _paste_preview(batch, state, paste_hover)
    return batch.flush(fb, camera, depth_mode)


def render_player_camera_preview(state: EditorState, room, obj,
                                 width: int, height: int,
                                 scene=None, device=None):
    """layout.rs:6311-6440 draw_player_camera_preview: the level rendered
    from an orbit-style camera behind/above the player spawn, plus the
    green player collision cylinder (draw_preview_wireframe_cylinder,
    :6444-6487; 12 segments, no depth test, no fog).  Returns the packed
    (height, width) i32 color words (numpy) for a ui "image" command.
    With scene=None only the cylinder is drawn over the clear color.
    Renders on the card unless `device` names another (the compiled
    scene is moved there)."""
    import math

    from ..config import RasterSettings
    from ..models import build
    from ..ops import raster_ref

    ps = state.level.player_settings
    wp = np.asarray(obj.world_position(room), np.float32)
    look = np.array([wp[0], wp[1] + ps.camera_vertical_offset, wp[2]], F32)
    cam_pos = np.array(
        [wp[0],
         wp[1] + ps.camera_vertical_offset + ps.camera_distance * 0.2,
         wp[2] - ps.camera_distance], F32)
    d = look - cam_pos
    ln = float(np.sqrt((d * d).sum()))
    if ln > 1e-3:
        nx, ny, nz = (d / ln).tolist()
        rot_x = math.asin(max(-1.0, min(1.0, -ny)))
        rot_y = math.atan2(nx, nz)
    else:
        rot_x = rot_y = 0.0
    basis = build.camera_basis(rot_x, rot_y)
    dev = resolve_device(device)
    cam = CameraArrays(
        position=torch.from_numpy(cam_pos).reshape(1, 3).to(dev),
        basis=torch.from_numpy(np.asarray(basis, F32)).reshape(
            1, 3, 3).to(dev))
    fb = raster_ref.new_framebuffer(height, width, device=dev)
    fb = draw2d.clear(fb, (20, 20, 25))
    if scene is not None:
        from ..models import scene as scene_mod
        fb = scene_mod.render_level(
            fb, to_device(scene, dev), cam, RasterSettings(), use_fog=False,
            render_assets=True)
    fb = draw2d.draw_wireframe_cylinder(
        fb, cam, wp, ps.radius, ps.height, segments=12,
        rgb=(100, 255, 100), depth_test="none")
    return fb.color[0].cpu().numpy()


def render_editor_viewport(state: EditorState, scene, width: int,
                           height: int, settings=None, editor=None,
                           hover=None, device=None) -> FrameBuffers:
    """The full draw_viewport_3d content pass: scene render from the
    editor camera (viewport_3d.rs:3472 render_scene) + every overlay.
    `scene` is a models.scene.CompiledScene for state.level (moved to the
    device); the caller blits the returned framebuffer, one view
    (1, height, width), into the viewport rect (the same contract as the
    game tab's frame, frame.py).  Renders on the card unless `device`
    names another."""
    from ..config import RasterSettings
    from ..models import scene as scene_mod
    from ..ops import raster_ref

    if settings is None:
        settings = RasterSettings.modeler()
    dev = resolve_device(device)
    fb = raster_ref.new_framebuffer(height, width, depth_mode="inv",
                                    device=dev)
    fb = scene_mod.render_level(
        fb, to_device(scene, dev), _camera(state, dev), settings,
        skip_rooms=tuple(sorted(state.hidden_rooms)))
    return draw_viewport_overlays(fb, state, editor=editor, hover=hover)
