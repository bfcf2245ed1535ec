"""2D grid views: top/front/side sector rendering + editing.
(The port's own copy of the JAX package's `editor/grid_view.py`, host code.)

Reference behavior: `src/editor/grid_view.rs` — the
full interactive view (:43 draw_grid_view): pan/zoom, grid lines,
sector fills per content, diagonal indicators, wall markers, portals,
object markers with facing arrows, room center handles, drag ghosts,
rubber-band selection, and per-tool click handling (Select / DrawFloor /
DrawCeiling / DrawWall / PlaceObject) with room grid expansion.

Drawing goes through the UiContext command queue (scissored to the view
rect) so the same code paints into a framebuffer via ctx.paint().
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

from ..models.level import (EAST, NESW, NORTH, NWSE, SECTOR_SIZE, SOUTH,
                            WEST, AssetInstance)
from .state import (CEILING_HEIGHT, CLICK_HEIGHT, EditorState, EditorTool,
                    GridViewMode, Selection)


def world_to_plane(mode: GridViewMode, x: float, y: float,
                   z: float) -> Tuple[float, float]:
    """grid_view.rs:108 — project a world position onto the view plane."""
    if mode == GridViewMode.TOP:
        return (x, z)
    if mode == GridViewMode.FRONT:
        return (x, y)
    return (z, y)


def plane_to_world_offset(mode: GridViewMode, da: float,
                          db: float) -> Tuple[float, float, float]:
    """grid_view.rs:118 — lift a 2D plane delta back to a world offset."""
    if mode == GridViewMode.TOP:
        return (da, 0.0, db)
    if mode == GridViewMode.FRONT:
        return (da, db, 0.0)
    return (0.0, db, da)


@dataclasses.dataclass
class GridView:
    """Pan/zoom state for one 2D view (grid_view.rs screen transforms)."""

    mode: GridViewMode = GridViewMode.TOP
    center_x: float = 0.0   # screen px of world-plane origin
    center_y: float = 0.0
    scale: float = 0.1      # screen px per world unit
    # world-plane coords the view is centered on (for pan)
    offset_a: float = 0.0
    offset_b: float = 0.0

    def world_to_screen(self, wa: float, wb: float) -> Tuple[float, float]:
        return (self.center_x + (wa - self.offset_a) * self.scale,
                self.center_y - (wb - self.offset_b) * self.scale)

    def screen_to_world(self, sx: float, sy: float) -> Tuple[float, float]:
        """grid_view.rs:101 — inverse, y flipped."""
        return (self.offset_a + (sx - self.center_x) / self.scale,
                self.offset_b - (sy - self.center_y) / self.scale)

    def pan(self, dx_px: float, dy_px: float) -> None:
        self.offset_a -= dx_px / self.scale
        self.offset_b += dy_px / self.scale

    def zoom(self, factor: float, at_sx: float, at_sy: float) -> None:
        """Zoom keeping the world point under the cursor fixed."""
        wa, wb = self.screen_to_world(at_sx, at_sy)
        self.scale *= factor
        wa2, wb2 = self.screen_to_world(at_sx, at_sy)
        self.offset_a += wa - wa2
        self.offset_b += wb - wb2

    def sector_at(self, sx: float, sy: float, room_origin=(0.0, 0.0, 0.0)
                  ) -> Optional[Tuple[int, int]]:
        """Sector cell under a screen point (TOP view only: x/z cells)."""
        if self.mode != GridViewMode.TOP:
            return None
        wa, wb = self.screen_to_world(sx, sy)
        lx = wa - room_origin[0]
        lz = wb - room_origin[2]
        return (int(math.floor(lx / SECTOR_SIZE)),
                int(math.floor(lz / SECTOR_SIZE)))


# ---------------------------------------------------------------------------
# Interactive grid view (grid_view.rs:43 draw_grid_view)
# ---------------------------------------------------------------------------

def closest_edge_top_view(local_x: float, local_z: float) -> int:
    """grid_view.rs:13 — nearest sector edge from intra-sector position."""
    fx = math.fmod(local_x / float(SECTOR_SIZE), 1.0)
    fz = math.fmod(local_z / float(SECTOR_SIZE), 1.0)
    if fx < 0.0:
        fx += 1.0
    if fz < 0.0:
        fz += 1.0
    dists = [(fz, NORTH), (1.0 - fz, SOUTH), (fx, WEST), (1.0 - fx, EAST)]
    best = min(d for d, _ in dists)
    for d, direction in dists:
        if d == best:
            return direction
    return NORTH


def asset_marker_style(asset) -> Tuple[tuple, tuple, str]:
    """grid_view.rs:626-644 — (fill rgb, outline rgb, icon letter) by the
    asset's components; gray '?' for unknown."""
    if asset is None:
        return ((100, 100, 100), (150, 150, 150), "?")
    if asset.has_spawn_point(True):
        return ((50, 200, 50), (100, 255, 100), "P")
    if asset.has_light():
        return ((255, 200, 50), (255, 255, 150), "L")
    if asset.has_enemy():
        return ((200, 50, 50), (255, 100, 100), "E")
    if asset.has_mesh():
        return ((150, 100, 200), (200, 150, 255), "M")
    if asset.has_trigger():
        return ((200, 100, 50), (255, 150, 100), "T")
    return ((100, 100, 100), (150, 150, 150), "?")


def _lookup_asset(state: EditorState, asset_id):
    lib = state.asset_library
    return lib.get_by_id(asset_id) if lib is not None else None


def draw_grid_view(ctx, rect, state: EditorState) -> None:
    """grid_view.rs:43 — one frame of the 2D view: draw + interact."""
    ss = float(SECTOR_SIZE)
    ctx.set_clip(rect)
    ctx.fill(rect, (20, 20, 25))

    mouse = (ctx.mouse.x, ctx.mouse.y)
    inside = rect.contains(*mouse)

    # --- pan & zoom (grid_view.rs:51-73) ---
    if inside:
        if ctx.mouse.wheel != 0.0:
            factor = 1.0 + ctx.mouse.wheel * 0.008
            state.grid_zoom = min(max(state.grid_zoom * factor, 0.002), 2.0)
        if ctx.mouse.right_down:
            if state.grid_panning:
                state.grid_offset_x += mouse[0] - state.grid_last_mouse[0]
                state.grid_offset_y += mouse[1] - state.grid_last_mouse[1]
            state.grid_panning = True
        else:
            state.grid_panning = False
    else:
        state.grid_panning = False
    state.grid_last_mouse = mouse

    room = state.current_room_ref()
    if room is None:
        ctx.text(rect.x + 10, rect.y + 20, "No room", (100, 100, 100))
        ctx.set_clip(None)
        return

    center_x = rect.x + rect.w * 0.5 + state.grid_offset_x
    center_y = rect.y + rect.h * 0.5 + state.grid_offset_y
    scale = state.grid_zoom
    view_mode = state.grid_view

    def w2s(wa, wb):
        return (center_x + wa * scale, center_y - wb * scale)

    def s2w(sx, sy):
        return ((sx - center_x) / scale, -(sy - center_y) / scale)

    def pos_to_plane(x, y, z):
        return world_to_plane(view_mode, x, y, z)

    # --- grid lines (grid_view.rs:141-182) ---
    if state.show_grid:
        step = state.grid_size
        min_wx = (rect.x - center_x) / scale
        max_wx = (rect.right - center_x) / scale
        min_wz = -(rect.bottom - center_y) / scale
        max_wz = -(rect.y - center_y) / scale
        x = math.floor(min_wx / step) * step
        while x <= max_wx:
            sx, _ = w2s(x, 0.0)
            if rect.x <= sx <= rect.right:
                rgb = (80, 40, 40) if abs(x / step) < 0.01 else (40, 40, 45)
                ctx.line(sx, rect.y, sx, rect.bottom, rgb)
            x += step
        z = math.floor(min_wz / step) * step
        while z <= max_wz:
            _, sy = w2s(0.0, z)
            if rect.y <= sy <= rect.bottom:
                rgb = (40, 80, 40) if abs(z / step) < 0.01 else (40, 40, 45)
                ctx.line(rect.x, sy, rect.right, sy, rgb)
            z += step

    cur_idx = state.current_room

    # --- hovered sector + edge (grid_view.rs:188-208) ---
    hovered_sector: Optional[Tuple[int, int]] = None
    hovered_edge: Optional[int] = None
    if inside:
        wx, wz = s2w(*mouse)
        local_x = wx - float(room.position[0])
        local_z = wz - float(room.position[2])
        if local_x >= 0.0 and local_z >= 0.0:
            gx = int(local_x / ss)
            gz = int(local_z / ss)
            if gx < room.width and gz < room.depth \
                    and room.get_sector(gx, gz) is not None:
                hovered_sector = (gx, gz)
                if view_mode == GridViewMode.TOP:
                    hovered_edge = closest_edge_top_view(local_x, local_z)

    def sector_quad(r, gx, gz, sector):
        """Screen corners for one sector in the current view mode
        (grid_view.rs:234-256); order NW, NE, SE, SW in plane terms."""
        base_x = float(r.position[0]) + gx * ss
        base_z = float(r.position[2]) + gz * ss
        floor_y = float(r.position[1]) + (
            sector.floor.avg_height() if sector.floor is not None else 0.0)
        ceil_y = float(r.position[1]) + (
            sector.ceiling.avg_height() if sector.ceiling is not None
            else CEILING_HEIGHT)
        if view_mode == GridViewMode.TOP:
            return (w2s(base_x, base_z), w2s(base_x + ss, base_z),
                    w2s(base_x + ss, base_z + ss), w2s(base_x, base_z + ss))
        if view_mode == GridViewMode.FRONT:
            return (w2s(base_x, floor_y), w2s(base_x + ss, floor_y),
                    w2s(base_x + ss, ceil_y), w2s(base_x, ceil_y))
        return (w2s(base_z, floor_y), w2s(base_z + ss, floor_y),
                w2s(base_z + ss, ceil_y), w2s(base_z, ceil_y))

    def quad_fill(q, rgb, alpha):
        (x0, y0), (x1, y1), (x2, y2), (x3, y3) = q
        ctx.tri(x0, y0, x1, y1, x2, y2, rgb, alpha)
        ctx.tri(x0, y0, x2, y2, x3, y3, rgb, alpha)

    def quad_outline(q, rgb, alpha=255):
        for i in range(4):
            a, b = q[i], q[(i + 1) % 4]
            ctx.line(a[0], a[1], b[0], b[1], rgb, alpha)

    # --- non-current rooms, dimmed (grid_view.rs:211-315) ---
    for room_idx, r in enumerate(state.level.rooms):
        if room_idx == cur_idx or room_idx in state.hidden_rooms:
            continue
        for gx, gz, sector in r.iter_sectors():
            has_floor = sector.floor is not None
            has_ceiling = sector.ceiling is not None
            has_walls = any(sector.walls(d) for d in range(4))
            if not (has_floor or has_ceiling or has_walls):
                continue
            q = sector_quad(r, gx, gz, sector)
            if has_floor and has_ceiling:
                fill = ((40, 60, 55), 60)
            elif has_floor:
                fill = ((40, 55, 60), 60)
            elif has_ceiling:
                fill = ((55, 40, 60), 60)
            else:
                fill = ((50, 50, 50), 40)
            quad_fill(q, *fill)
            quad_outline(q, (60, 60, 65), 180)
            wall_lists = (sector.walls_north, sector.walls_east,
                          sector.walls_south, sector.walls_west)
            for i, walls in enumerate(wall_lists):
                if walls:
                    a, b = q[i], q[(i + 1) % 4]
                    ctx.line(a[0], a[1], b[0], b[1], (120, 90, 60), 180)

    # --- current room sectors (grid_view.rs:318-490) ---
    for gx, gz, sector in room.iter_sectors():
        q = sector_quad(room, gx, gz, sector)
        is_hovered = hovered_sector == (gx, gz)
        is_selected = (state.selection.kind == "sector"
                       and (state.selection.room, state.selection.x,
                            state.selection.z) == (cur_idx, gx, gz))
        is_multi = any(
            s.kind == "sector" and (s.room, s.x, s.z) == (cur_idx, gx, gz)
            for s in state.multi_selection)
        has_floor = sector.floor is not None
        has_ceiling = sector.ceiling is not None
        has_walls = any(sector.walls(d) for d in range(4))
        has_geometry = has_floor or has_ceiling or has_walls
        if not has_geometry and not (is_selected or is_multi or is_hovered):
            continue
        if is_selected or is_multi:
            fill = ((255, 200, 100), 150)
        elif is_hovered:
            fill = ((150, 200, 255), 120)
        elif has_floor and has_ceiling:
            fill = ((60, 120, 100), 100)
        elif has_floor:
            fill = ((60, 100, 120), 100)
        elif has_ceiling:
            fill = ((100, 60, 120), 100)
        else:
            fill = ((80, 80, 80), 60)
        quad_fill(q, *fill)

        # diagonal split indicators (grid_view.rs:403-440, Top only)
        if view_mode == GridViewMode.TOP:
            def diag(split, rgb):
                if split == 0:   # NwSe: corner 0 -> 2
                    ctx.line(q[0][0], q[0][1], q[2][0], q[2][1], rgb, 200)
                else:            # NeSw: corner 1 -> 3
                    ctx.line(q[1][0], q[1][1], q[3][0], q[3][1], rgb, 200)
            if sector.floor is not None and sector.floor.diagonal_matters():
                diag(sector.floor.split_direction, (255, 180, 100))
            if sector.ceiling is not None \
                    and sector.ceiling.diagonal_matters():
                fsplit = (sector.floor.split_direction
                          if sector.floor is not None else None)
                if sector.ceiling.split_direction != fsplit:
                    diag(sector.ceiling.split_direction, (180, 100, 255))

        highlighted = is_selected or is_multi or is_hovered
        edge_rgb = (200, 200, 220) if highlighted else (100, 100, 110)
        quad_outline(q, edge_rgb)
        if highlighted:
            for (vx, vy) in q:
                ctx.circle(vx, vy, 3, (255, 255, 255))

        wall_lists = (sector.walls_north, sector.walls_east,
                      sector.walls_south, sector.walls_west)
        for i, walls in enumerate(wall_lists):
            if walls:
                a, b = q[i], q[(i + 1) % 4]
                ctx.line(a[0], a[1], b[0], b[1], (200, 150, 100))
        if sector.walls_nwse:
            ctx.line(q[0][0], q[0][1], q[2][0], q[2][1], (220, 180, 120))
        if sector.walls_nesw:
            ctx.line(q[1][0], q[1][1], q[3][0], q[3][1], (220, 180, 120))

    # --- wall-mode edge highlight (grid_view.rs:493-522) ---
    if (view_mode == GridViewMode.TOP
            and state.tool == EditorTool.DRAW_WALL
            and hovered_sector is not None and hovered_edge is not None):
        gx, gz = hovered_sector
        base_x = float(room.position[0]) + gx * ss
        base_z = float(room.position[2]) + gz * ss
        c = (w2s(base_x, base_z), w2s(base_x + ss, base_z),
             w2s(base_x + ss, base_z + ss), w2s(base_x, base_z + ss))
        pair = {NORTH: (0, 1), EAST: (1, 2), SOUTH: (2, 3), WEST: (3, 0),
                NWSE: (0, 2), NESW: (1, 3)}[hovered_edge]
        a, b = c[pair[0]], c[pair[1]]
        ctx.line(a[0], a[1], b[0], b[1], (100, 255, 255))
        ctx.circle(a[0], a[1], 5, (100, 255, 255))
        ctx.circle(b[0], b[1], 5, (100, 255, 255))

    # --- portals (grid_view.rs:525-602) ---
    for portal in room.portals:
        verts = [(float(v[0]) + float(room.position[0]),
                  float(v[1]) + float(room.position[1]),
                  float(v[2]) + float(room.position[2]))
                 for v in portal.vertices]
        horizontal = abs(float(portal.normal[1])) > 0.9
        q = [w2s(*pos_to_plane(*v)) for v in verts]
        should_fill = (horizontal if view_mode == GridViewMode.TOP
                       else not horizontal)
        if should_fill:
            quad_fill(q, (200, 50, 200), 80)
        quad_outline(q, (255, 100, 255))

    # --- objects (grid_view.rs:605-691) ---
    hovered_object: Optional[int] = None
    for obj_idx, obj in enumerate(room.objects):
        world_x = float(room.position[0]) + (obj.sector_x + 0.5) * ss
        world_y = float(room.position[1]) + obj.height
        world_z = float(room.position[2]) + (obj.sector_z + 0.5) * ss
        sx, sy = w2s(*pos_to_plane(world_x, world_y, world_z))
        is_selected = (state.selection.kind == "object"
                       and state.selection.room == cur_idx
                       and state.selection.index == obj_idx)
        radius = 10.0 if is_selected else 7.0
        dist = math.hypot(mouse[0] - sx, mouse[1] - sy)
        if inside and dist < radius + 4.0:
            hovered_object = obj_idx
        asset = _lookup_asset(state, obj.asset_id)
        fill_rgb, outline_rgb, letter = asset_marker_style(asset)
        is_spawn = asset is not None and asset.has_spawn_point(True)
        if obj.enabled:
            ctx.circle(sx, sy, radius, fill_rgb)
            ctx.circle_lines(sx, sy, radius, outline_rgb)
            if is_spawn:
                arrow = radius + 6.0
                dx = math.sin(obj.facing) * arrow
                dy = math.cos(obj.facing) * arrow
                ctx.line(sx, sy, sx + dx, sy + dy, outline_rgb)
                for ha in (obj.facing + 2.5, obj.facing - 2.5):
                    ctx.line(sx + dx, sy + dy,
                             sx + dx - math.sin(ha) * 4.0,
                             sy + dy - math.cos(ha) * 4.0, outline_rgb)
            ctx.text(sx - 2, sy - 3, letter, (255, 255, 255))
        else:
            ctx.circle_lines(sx, sy, radius, (100, 100, 100))
        if is_selected:
            ctx.circle_lines(sx, sy, radius + 4, (255, 255, 255))
        elif hovered_object == obj_idx:
            ctx.circle_lines(sx, sy, radius + 4, (255, 255, 200))

    # --- room center handles (grid_view.rs:694-743) ---
    hovered_room_origin: Optional[int] = None
    for room_idx, r in enumerate(state.level.rooms):
        is_current = room_idx == cur_idx
        if room_idx in state.hidden_rooms and not is_current:
            continue
        cx = float(r.position[0]) + r.width * ss / 2.0
        cz = float(r.position[2]) + r.depth * ss / 2.0
        cy = float(r.position[1]) + (float(r.bounds_max[1])
                                     + float(r.bounds_min[1])) / 2.0
        if view_mode == GridViewMode.TOP:
            ox, oy = w2s(cx, cz)
        elif view_mode == GridViewMode.FRONT:
            ox, oy = w2s(cx, cy)
        else:
            ox, oy = w2s(cz, cy)
        if not (rect.x - 10 <= ox <= rect.right + 10
                and rect.y - 10 <= oy <= rect.bottom + 10):
            continue
        hovered = inside and math.hypot(mouse[0] - ox, mouse[1] - oy) < 12.0
        if hovered:
            hovered_room_origin = room_idx
        if hovered:
            rgb = (255, 255, 150)
        elif room_idx in state.hidden_rooms:
            rgb = (100, 60, 60)
        elif is_current:
            rgb = (255, 100, 100)
        else:
            rgb = (150, 80, 80)
        ctx.circle(ox, oy, 8 if hovered else 6, rgb)
        ctx.line(ox - 12, oy, ox + 12, oy, rgb)
        ctx.line(ox, oy - 12, ox, oy + 12, rgb)
        if is_current or hovered:
            ctx.text(ox + 14, oy - 4, f"R{room_idx}", rgb)

    # --- drag ghosts (grid_view.rs:746-863) ---
    if state.grid_dragging_sectors and state.grid_sector_drag_start:
        off_x, off_z = state.grid_sector_drag_offset
        for (room_idx, gx, gz) in state.grid_dragging_sectors:
            if room_idx >= len(state.level.rooms):
                continue
            r = state.level.rooms[room_idx]
            base_x = float(r.position[0]) + gx * ss + off_x
            base_z = float(r.position[2]) + gz * ss + off_z
            q = (w2s(base_x, base_z), w2s(base_x + ss, base_z),
                 w2s(base_x + ss, base_z + ss), w2s(base_x, base_z + ss))
            quad_fill(q, (100, 200, 255), 100)
            quad_outline(q, (100, 200, 255), 200)
    if state.grid_dragging_room_origin and state.grid_sector_drag_start:
        off_a, off_b = state.grid_sector_drag_offset
        r = state.level.rooms[cur_idx]
        cx = float(r.position[0]) + r.width * ss / 2.0
        cz = float(r.position[2]) + r.depth * ss / 2.0
        cy = float(r.position[1]) + (float(r.bounds_max[1])
                                     + float(r.bounds_min[1])) / 2.0
        if view_mode == GridViewMode.TOP:
            ox, oy = w2s(cx + off_a, cz + off_b)
        elif view_mode == GridViewMode.FRONT:
            ox, oy = w2s(cx + off_a, cy + off_b)
        else:
            ox, oy = w2s(cz + off_a, cy + off_b)
        ctx.circle(ox, oy, 8, (100, 255, 100))
        ctx.line(ox - 14, oy, ox + 14, oy, (100, 255, 100))
        ctx.line(ox, oy - 14, ox, oy + 14, (100, 255, 100))
    if state.grid_dragging_object is not None \
            and state.grid_sector_drag_start:
        off_a, off_b = state.grid_sector_drag_offset
        wdx, wdy, wdz = plane_to_world_offset(view_mode, off_a, off_b)
        sdx = round(wdx / ss) * ss
        sdz = round(wdz / ss) * ss
        sdy = round(wdy / CLICK_HEIGHT) * CLICK_HEIGHT
        drag_room_idx, obj_idx = state.grid_dragging_object
        if drag_room_idx < len(state.level.rooms):
            drag_room = state.level.rooms[drag_room_idx]
            if obj_idx < len(drag_room.objects):
                obj = drag_room.objects[obj_idx]
                wp = obj.world_position(drag_room)
                gp = pos_to_plane(float(wp[0]) + sdx, float(wp[1]) + sdy,
                                  float(wp[2]) + sdz)
                gxp, gyp = w2s(*gp)
                asset = _lookup_asset(state, obj.asset_id)
                fill_rgb, _, letter = asset_marker_style(asset)
                ctx.circle(gxp, gyp, 10, fill_rgb)
                ctx.circle_lines(gxp, gyp, 13, (255, 255, 255))
                ctx.text(gxp - 2, gyp - 3, letter, (255, 255, 255))

    # --- rubber-band rectangle (grid_view.rs:866-884) ---
    if state.selection_rect_start and state.selection_rect_end:
        (ax, ay), (bx, by) = state.selection_rect_start, \
            state.selection_rect_end
        rx, ry = min(ax, bx), min(ay, by)
        rw, rh = abs(bx - ax), abs(by - ay)
        if rw > 2.0 or rh > 2.0:
            from ..ui.rect import Rect as _R
            band = _R(rx, ry, rw, rh)
            ctx.fill(band, (100, 180, 255), 50)
            ctx.outline(band, (100, 180, 255))

    _grid_view_interact(ctx, rect, state, room, inside, mouse, s2w,
                        hovered_sector, hovered_edge, hovered_object,
                        hovered_room_origin)
    ctx.set_clip(None)


def _grid_view_interact(ctx, rect, state: EditorState, room, inside, mouse,
                        s2w, hovered_sector, hovered_edge, hovered_object,
                        hovered_room_origin) -> None:
    """The interaction half of draw_grid_view (grid_view.rs:886-1616)."""
    ss = float(SECTOR_SIZE)
    cur_idx = state.current_room
    shift = ctx.key_down("shift")

    if inside and not state.grid_panning:
        # drag updates (grid_view.rs:889-898)
        if ctx.mouse.down and state.grid_sector_drag_start is not None:
            wx, wz = s2w(*mouse)
            sx0, sz0 = state.grid_sector_drag_start
            state.grid_sector_drag_offset = (wx - sx0, wz - sz0)
        if ctx.mouse.down and state.selection_rect_start is not None:
            state.selection_rect_end = mouse

        # drag release (grid_view.rs:901-1101)
        if ctx.mouse.released and state.grid_sector_drag_start is not None:
            _release_drag(state)
        # rubber-band release (grid_view.rs:1104-1157)
        if ctx.mouse.released and state.selection_rect_start is not None:
            _release_selection_rect(state, room, s2w, shift)

        if ctx.mouse.pressed:
            _grid_press(state, room, mouse, s2w, shift, hovered_sector,
                        hovered_edge, hovered_object, hovered_room_origin)

    # Delete/Backspace (grid_view.rs:1510-1601)
    if inside and (ctx.key_pressed("delete") or ctx.key_pressed("backspace")):
        _delete_selected(state)

    # tool shortcuts 1-5 (grid_view.rs:1604-1616)
    if inside:
        keys = {"1": EditorTool.SELECT, "2": EditorTool.DRAW_FLOOR,
                "3": EditorTool.DRAW_WALL, "4": EditorTool.DRAW_CEILING,
                "5": EditorTool.PLACE_OBJECT}
        for k, tool in keys.items():
            if ctx.key_pressed(k):
                state.tool = tool


def _expand_room_for(room, local_x: int, local_z: int) -> Tuple[int, int]:
    """Grow the sector grid to include signed cell (local_x, local_z),
    shifting position for negative growth (grid_view.rs:1277-1321).
    Returns the cell's grid coordinates after expansion."""
    ss = float(SECTOR_SIZE)
    if local_x < 0:
        shift = -local_x
        room.position = room.position.copy()
        room.position[0] -= shift * ss
        room.sectors = [[None] * room.depth
                        for _ in range(shift)] + room.sectors
        room.width += shift
        local_x = 0
    if local_z < 0:
        shift = -local_z
        room.position = room.position.copy()
        room.position[2] -= shift * ss
        for i, col in enumerate(room.sectors):
            room.sectors[i] = [None] * shift + col
        room.depth += shift
        local_z = 0
    while local_x >= room.width:
        room.width += 1
        room.sectors.append([None] * room.depth)
    while local_z >= room.depth:
        room.depth += 1
        for col in room.sectors:
            col.append(None)
    return local_x, local_z


def _release_drag(state: EditorState) -> None:
    """grid_view.rs:901-1101 — commit object/sector/room drags."""
    ss = float(SECTOR_SIZE)
    cur_idx = state.current_room
    off_a, off_b = state.grid_sector_drag_offset
    wdx, wdy, wdz = plane_to_world_offset(state.grid_view, off_a, off_b)
    sdx = round(wdx / ss) * ss
    sdz = round(wdz / ss) * ss
    sdy = round(wdy / CLICK_HEIGHT) * CLICK_HEIGHT

    if state.grid_dragging_object is not None:
        drag_room_idx, obj_idx = state.grid_dragging_object
        sector_dx = int(round(sdx / ss))
        sector_dz = int(round(sdz / ss))
        has_h = sector_dx != 0 or sector_dz != 0
        has_v = abs(sdy) >= CLICK_HEIGHT * 0.5
        if has_h or has_v:
            state.save_undo()
            obj = state.level.get_object(drag_room_idx, obj_idx)
            if obj is not None:
                if has_h:
                    obj.sector_x = max(obj.sector_x + sector_dx, 0)
                    obj.sector_z = max(obj.sector_z + sector_dz, 0)
                if has_v:
                    obj.height += sdy
                if has_h and has_v:
                    state.set_status(
                        f"Moved object to sector ({obj.sector_x}, "
                        f"{obj.sector_z}) at height {obj.height:.0f}", 2.0)
                elif has_h:
                    state.set_status(
                        f"Moved object to sector ({obj.sector_x}, "
                        f"{obj.sector_z})", 2.0)
                else:
                    state.set_status(
                        f"Changed object height to {obj.height:.0f}", 2.0)
        state.grid_dragging_object = None
        state.grid_sector_drag_offset = (0.0, 0.0)
        state.grid_sector_drag_start = None
        return

    has_movement = (abs(sdx) >= ss * 0.5 or abs(sdz) >= ss * 0.5
                    or abs(sdy) >= CLICK_HEIGHT * 0.5)
    if has_movement:
        state.save_undo()
        if state.grid_dragging_room_origin:
            if cur_idx < len(state.level.rooms):
                room = state.level.rooms[cur_idx]
                room.position = room.position.copy()
                room.position[0] += sdx
                room.position[1] += sdy
                room.position[2] += sdz
                state.set_status(
                    f"Moved room to ({room.position[0]:.0f}, "
                    f"{room.position[1]:.0f}, {room.position[2]:.0f})", 2.0)
            state.mark_portals_dirty()
        elif state.grid_dragging_sectors \
                and cur_idx < len(state.level.rooms):
            grid_dx = int(round(sdx / ss))
            grid_dz = int(round(sdz / ss))
            room = state.level.rooms[cur_idx]
            moving = [(gx, gz, room.sectors[gx][gz])
                      for (r, gx, gz) in state.grid_dragging_sectors
                      if r == cur_idx and gx < room.width
                      and gz < room.depth
                      and room.sectors[gx][gz] is not None]
            min_gx = min([0] + [gx + grid_dx for gx, _, _ in moving])
            min_gz = min([0] + [gz + grid_dz for _, gz, _ in moving])
            shift_x, shift_z = -min_gx, -min_gz
            if shift_x or shift_z:
                _expand_room_for(room, -shift_x, -shift_z)
            for (_, gx, gz) in state.grid_dragging_sectors:
                ax, az = gx + shift_x, gz + shift_z
                if ax < room.width and az < room.depth:
                    room.sectors[ax][az] = None
            for (gx, gz, sector) in moving:
                nx = gx + grid_dx + shift_x
                nz = gz + grid_dz + shift_z
                nx, nz = _expand_room_for(room, nx, nz)
                room.sectors[nx][nz] = sector
            room.compact()
            state.set_status(
                f"Moved {len(state.grid_dragging_sectors)} sector(s)", 2.0)
            state.mark_portals_dirty()
    state.grid_dragging_sectors = []
    state.grid_sector_drag_offset = (0.0, 0.0)
    state.grid_sector_drag_start = None
    state.grid_dragging_room_origin = False


def _release_selection_rect(state: EditorState, room, s2w, shift) -> None:
    """grid_view.rs:1104-1157 — select sectors whose center lies inside."""
    ss = float(SECTOR_SIZE)
    cur_idx = state.current_room
    (ax, ay), (bx, by) = state.selection_rect_start, state.selection_rect_end
    wx0, wz0 = s2w(min(ax, bx), max(ay, by))
    wx1, wz1 = s2w(max(ax, bx), min(ay, by))
    if math.hypot(bx - ax, by - ay) > 5.0:
        selected = []
        for gx, gz, _ in room.iter_sectors():
            cx = float(room.position[0]) + gx * ss + ss * 0.5
            cz = float(room.position[2]) + gz * ss + ss * 0.5
            if wx0 <= cx <= wx1 and wz0 <= cz <= wz1:
                selected.append((gx, gz))
        if selected:
            state.save_selection_undo()
            if not shift:
                state.multi_selection = []
            for (gx, gz) in selected:
                state.add_to_multi_selection(
                    Selection(kind="sector", room=cur_idx, x=gx, z=gz))
            gx, gz = selected[0]
            state.set_selection(
                Selection(kind="sector", room=cur_idx, x=gx, z=gz))
            state.set_status(f"Selected {len(selected)} sector(s)", 2.0)
    state.selection_rect_start = None
    state.selection_rect_end = None


def _grid_press(state: EditorState, room, mouse, s2w, shift, hovered_sector,
                hovered_edge, hovered_object, hovered_room_origin) -> None:
    """grid_view.rs:1159-1505 — left-press dispatch per tool."""
    ss = float(SECTOR_SIZE)
    cur_idx = state.current_room
    tool = state.tool

    if tool == EditorTool.SELECT:
        if hovered_object is not None:
            already = (state.selection.kind == "object"
                       and state.selection.room == cur_idx
                       and state.selection.index == hovered_object)
            if already:
                wx, wz = s2w(*mouse)
                state.grid_dragging_object = (cur_idx, hovered_object)
                state.grid_sector_drag_start = (wx, wz)
                state.grid_sector_drag_offset = (0.0, 0.0)
            else:
                state.save_selection_undo()
                state.multi_selection = []
                state.set_selection(Selection(kind="object", room=cur_idx,
                                              index=hovered_object))
        elif hovered_room_origin is not None:
            state.current_room = hovered_room_origin
            state.grid_dragging_room_origin = True
            wx, wz = s2w(*mouse)
            state.grid_sector_drag_start = (wx, wz)
            state.grid_sector_drag_offset = (0.0, 0.0)
        elif hovered_sector is not None:
            gx, gz = hovered_sector
            already = state.selection.includes_sector(cur_idx, gx, gz) \
                or any(s.kind == "sector"
                       and (s.room, s.x, s.z) == (cur_idx, gx, gz)
                       for s in state.multi_selection)
            if already and not shift:
                drag = []
                s = state.selection
                if s.kind == "sector":
                    drag.append((s.room, s.x, s.z))
                for m in state.multi_selection:
                    if m.kind == "sector" \
                            and (m.room, m.x, m.z) not in drag:
                        drag.append((m.room, m.x, m.z))
                state.grid_dragging_sectors = drag
                wx, wz = s2w(*mouse)
                state.grid_sector_drag_start = (wx, wz)
                state.grid_sector_drag_offset = (0.0, 0.0)
            else:
                new_sel = Selection(kind="sector", room=cur_idx, x=gx, z=gz)
                if shift:
                    state.save_selection_undo()
                    if new_sel in state.multi_selection:
                        state.multi_selection.remove(new_sel)
                    else:
                        state.multi_selection.append(new_sel)
                    state.set_selection(new_sel)
                elif state.selection != new_sel or state.multi_selection:
                    state.save_selection_undo()
                    state.multi_selection = []
                    state.set_selection(new_sel)
        else:
            if not shift and (state.selection.kind != "none"
                              or state.multi_selection):
                state.save_selection_undo()
                state.set_selection(Selection())
                state.multi_selection = []
            state.selection_rect_start = mouse
            state.selection_rect_end = mouse

    elif tool in (EditorTool.DRAW_FLOOR, EditorTool.DRAW_CEILING):
        is_floor = tool == EditorTool.DRAW_FLOOR
        wx, wz = s2w(*mouse)
        snapped_x = math.floor(wx / ss) * ss
        snapped_z = math.floor(wz / ss) * ss
        local_x = int(math.floor((snapped_x - float(room.position[0])) / ss))
        local_z = int(math.floor((snapped_z - float(room.position[2])) / ss))
        existing = None
        if local_x >= 0 and local_z >= 0:
            existing = room.get_sector(local_x, local_z)
        if existing is not None and \
                (existing.floor if is_floor else existing.ceiling) is not None:
            state.set_status(
                f"Sector already has a {'floor' if is_floor else 'ceiling'}",
                2.0)
            return
        state.save_undo()
        room = state.level.rooms[cur_idx]
        gx, gz = _expand_room_for(room, local_x, local_z)
        if is_floor:
            room.set_floor(gx, gz, 0.0, state.selected_texture)
            state.set_status("Created floor sector", 2.0)
        else:
            room.set_ceiling(gx, gz, CEILING_HEIGHT, state.selected_texture)
            state.set_status("Created ceiling sector", 2.0)
        room.recalculate_bounds()
        state.mark_portals_dirty()

    elif tool == EditorTool.DRAW_WALL:
        if state.wall_direction in (NWSE, NESW):
            state.set_status(
                "Diagonal walls: use 3D viewport (R to change direction)",
                2.0)
        elif state.grid_view != GridViewMode.TOP:
            state.set_status("Wall tool: switch to Top view", 2.0)
        elif hovered_sector is not None and hovered_edge is not None:
            gx, gz = hovered_sector
            sector = room.get_sector(gx, gz)
            has_wall = (sector is not None
                        and hovered_edge < 4
                        and bool(sector.walls(hovered_edge)))
            if has_wall:
                state.set_status("Wall already exists on this edge", 1.5)
            else:
                state.save_undo()
                room.add_wall(gx, gz, hovered_edge, 0.0, CEILING_HEIGHT,
                              state.selected_texture)
                room.recalculate_bounds()
                state.mark_portals_dirty()
                names = {NORTH: "north", EAST: "east", SOUTH: "south",
                         WEST: "west"}
                state.set_status(
                    f"Created {names.get(hovered_edge, '?')} wall", 1.5)
        else:
            state.set_status("Hover over a sector edge to place wall", 2.0)

    elif tool == EditorTool.PLACE_OBJECT:
        wx, wz = s2w(*mouse)
        snapped_x = math.floor(wx / ss) * ss
        snapped_z = math.floor(wz / ss) * ss
        gx = int(math.floor((snapped_x - float(room.position[0])) / ss))
        gz = int(math.floor((snapped_z - float(room.position[2])) / ss))
        if not (gx >= 0 and gz >= 0
                and room.get_sector(gx, gz) is not None):
            state.set_status("Click on a sector to place object", 2.0)
            return
        if state.selected_asset is None:
            state.set_status("No asset selected", 2.0)
            return
        lib = state.asset_library
        asset = lib.get(state.selected_asset) if lib is not None else None
        if asset is None:
            state.set_status(
                f"Asset '{state.selected_asset}' not found", 2.0)
            return
        if asset.has_spawn_point(True):
            for r in state.level.rooms:
                for obj in r.objects:
                    a = _lookup_asset(state, obj.asset_id)
                    if a is not None and a.has_spawn_point(True):
                        state.set_status(
                            "Only one player spawn allowed per level", 2.0)
                        return
        state.save_undo()
        idx = state.level.add_object(
            cur_idx, AssetInstance(sector_x=gx, sector_z=gz,
                                   asset_id=asset.id))
        if idx is not None:
            state.set_selection(
                Selection(kind="object", room=cur_idx, index=idx))
            state.set_status(f"{state.selected_asset} placed", 1.0)


def _delete_selected(state: EditorState) -> None:
    """grid_view.rs:1510-1601 — delete selected objects, else clear
    selected sectors' geometry."""
    sels = [state.selection] + list(state.multi_selection)
    objects = [(s.room, s.index) for s in sels if s.kind == "object"]
    if objects:
        state.save_undo()
        deleted = 0
        for room_idx, obj_idx in sorted(objects, key=lambda t: -t[1]):
            if state.level.remove_object(room_idx, obj_idx) is not None:
                deleted += 1
        if deleted:
            state.set_selection(Selection())
            state.multi_selection = []
            state.set_status(
                "Deleted 1 object" if deleted == 1
                else f"Deleted {deleted} objects", 2.0)
        return
    sectors = [(s.room, s.x, s.z) for s in sels if s.kind == "sector"]
    if not sectors:
        return
    state.save_undo()
    deleted = 0
    affected = set()
    for room_idx, gx, gz in sectors:
        if room_idx >= len(state.level.rooms):
            continue
        room = state.level.rooms[room_idx]
        sector = room.get_sector(gx, gz)
        if sector is None or not sector.has_geometry():
            continue
        sector.floor = None
        sector.ceiling = None
        for d in range(6):
            sector.walls(d).clear()
        deleted += 1
        affected.add(room_idx)
    for room_idx in affected:
        state.level.rooms[room_idx].compact()
    if deleted:
        state.set_selection(Selection())
        state.multi_selection = []
        state.mark_portals_dirty()
        state.set_status(
            "Deleted 1 sector" if deleted == 1
            else f"Deleted {deleted} sectors", 2.0)
