"""3D-viewport interactive editing: click/drag state machines.
(The port's own copy of the JAX package's `editor/viewport_edit.py`,
host code.)

The headless port of draw_viewport_3d's edit interactions
(the reference's `src/editor/viewport_3d.rs:294-5654`):

  * DrawFloor / DrawCeiling — ray-plane pick snapped to the sector grid
    (:701-800), Shift+drag height adjustment in CLICK_HEIGHT clicks
    (:742-768), drag-rectangle fill committed on release (:2009-2021 +
    release handler).
  * DrawWall (cardinal) — edge preview + drag along the edge line,
    committed as wall faces spanning the floor/ceiling gap.
  * Select — clicking a face selects it (editor/hover.py); dragging a
    selected floor/ceiling vertically moves its corner heights in
    CLICK_HEIGHT increments (vertex selection moves one corner).
  * PlaceObject — click to place the chosen asset at the preview cell;
    dragging an existing object moves it in the XZ plane, Shift+drag
    adjusts its height (:2071-2115).

Mutations snapshot to the undo stack exactly once per gesture
(state.save_undo, state.rs:938).  All coordinates are framebuffer pixels;
the caller resolves window-to-fb mapping.
"""

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np

from ..models.level import (EAST, NESW, NORTH, NWSE, SECTOR_SIZE, SOUTH,
                            WEST, AssetInstance, HorizontalFace)
from ..ops import picking
from .state import (CEILING_HEIGHT, CLICK_HEIGHT, EditorState, EditorTool,
                    Selection)

Y_SENSITIVITY = 5.0   # viewport_3d.rs:761 (mouse px -> world units)


def pick_plane(mouse_fb, camera_pos, basis, fb_w, fb_h, plane_y):
    """Ray from the mouse through the camera onto the y=plane_y plane
    (viewport_3d.rs pick_plane); returns world (x, y, z) or None."""
    origin, direction = picking.screen_to_ray(
        float(mouse_fb[0]), float(mouse_fb[1]), fb_w, fb_h,
        np.asarray(camera_pos, np.float32), np.asarray(basis, np.float32))
    o = np.asarray(origin, np.float32).reshape(3)
    d = np.asarray(direction, np.float32).reshape(3)
    if abs(d[1]) < 1e-8:
        return None
    t = (plane_y - o[1]) / d[1]
    if t <= 0:
        return None
    return o + d * t


@dataclasses.dataclass
class ViewportEditor:
    """Per-viewport interaction state (the state.rs:462-500 drag fields)."""

    state: EditorState
    fb_w: int = 320
    fb_h: int = 240

    # floor/ceiling placement
    placement_target_y: float = 0.0
    height_adjust_mode: bool = False
    height_adjust_start_mouse_y: float = 0.0
    height_adjust_start_y: float = 0.0
    height_adjust_locked_pos: Optional[Tuple[float, float]] = None
    placement_drag_start: Optional[Tuple[int, int]] = None
    placement_drag_current: Optional[Tuple[int, int]] = None
    preview_sector: Optional[Tuple[float, float, float, bool]] = None

    # wall placement
    wall_direction: int = NORTH
    wall_prefer_high: bool = False
    wall_drag_start: Optional[Tuple[int, int, int]] = None
    wall_drag_current: Optional[Tuple[int, int, int]] = None

    # select-tool height dragging
    drag_started: bool = False
    drag_start_mouse_y: float = 0.0
    drag_start_heights: Optional[list] = None

    # object dragging
    dragging_object: Optional[Tuple[int, int]] = None
    object_drag_y: bool = False
    object_drag_initial_height: float = 0.0
    object_drag_start_mouse_y: float = 0.0
    object_xz_click_offset: Tuple[float, float] = (0.0, 0.0)
    selected_asset: Optional[int] = None

    # -----------------------------------------------------------------
    # shared picking
    # -----------------------------------------------------------------

    def _room(self):
        return self.state.current_room_ref()

    def _snap_cell(self, mouse_fb, camera_pos, basis):
        """Mouse -> snapped world (x, z) on the room's floor plane
        (viewport_3d.rs:712-739)."""
        room = self._room()
        room_y = float(room.position[1]) if room is not None else 0.0
        hit = pick_plane(mouse_fb, camera_pos, basis, self.fb_w, self.fb_h,
                         room_y)
        if hit is None:
            return None
        gx = math.floor(hit[0] / SECTOR_SIZE) * SECTOR_SIZE
        gz = math.floor(hit[2] / SECTOR_SIZE) * SECTOR_SIZE
        return gx, gz

    def _world_to_cell(self, wx, wz):
        room = self._room()
        if room is None:
            return None
        gx = math.floor((wx - float(room.position[0])) / SECTOR_SIZE)
        gz = math.floor((wz - float(room.position[2])) / SECTOR_SIZE)
        return int(gx), int(gz)

    # -----------------------------------------------------------------
    # floor / ceiling placement (viewport_3d.rs:701-800, :2009-2021)
    # -----------------------------------------------------------------

    def update_placement_preview(self, mouse_fb, camera_pos, basis,
                                 shift: bool = False) -> None:
        if self.state.tool not in (EditorTool.DRAW_FLOOR,
                                   EditorTool.DRAW_CEILING):
            self.preview_sector = None
            return
        is_floor = self.state.tool == EditorTool.DRAW_FLOOR

        if self.height_adjust_locked_pos is not None:
            snapped = self.height_adjust_locked_pos
        else:
            snapped = self._snap_cell(mouse_fb, camera_pos, basis)

        # Shift enters height-adjust mode, locking the cell (:745-756)
        if shift and not self.height_adjust_mode and snapped is not None:
            self.height_adjust_mode = True
            self.height_adjust_start_mouse_y = mouse_fb[1]
            self.height_adjust_start_y = self.placement_target_y
            self.height_adjust_locked_pos = snapped
        elif not shift and self.height_adjust_mode:
            self.height_adjust_mode = False
            self.height_adjust_locked_pos = None

        if self.height_adjust_mode:
            delta = (self.height_adjust_start_mouse_y - mouse_fb[1]) \
                * Y_SENSITIVITY
            snapped_delta = round(delta / CLICK_HEIGHT) * CLICK_HEIGHT
            self.placement_target_y = self.height_adjust_start_y \
                + snapped_delta
            clicks = int(self.placement_target_y / CLICK_HEIGHT)
            self.state.set_status(
                f"Height: {self.placement_target_y:.0f} ({clicks} clicks)",
                0.5)

        if snapped is None:
            self.preview_sector = None
            return
        cell = self._world_to_cell(snapped[0] + SECTOR_SIZE * 0.5,
                                   snapped[1] + SECTOR_SIZE * 0.5)
        occupied = False
        room = self._room()
        if room is not None and cell is not None:
            s = room.get_sector(*cell)
            if s is not None:
                occupied = (s.floor if is_floor else s.ceiling) is not None
        y = self.placement_target_y
        if y == 0.0 and not self.height_adjust_mode:
            y = 0.0 if is_floor else CEILING_HEIGHT
        self.preview_sector = (snapped[0], snapped[1], y, occupied)

    def press_placement(self) -> None:
        """Mouse down in DrawFloor/DrawCeiling: start the drag rectangle
        (:2009-2021)."""
        if self.preview_sector is None:
            return
        sx, sz, _, _ = self.preview_sector
        cell = self._world_to_cell(sx, sz)
        if cell is not None:
            self.placement_drag_start = cell
            self.placement_drag_current = cell

    def move_placement(self, mouse_fb, camera_pos, basis,
                       shift: bool = False) -> None:
        self.update_placement_preview(mouse_fb, camera_pos, basis, shift)
        if self.placement_drag_start is None or self.preview_sector is None:
            return
        cell = self._world_to_cell(self.preview_sector[0],
                                   self.preview_sector[1])
        if cell is not None:
            self.placement_drag_current = cell

    def release_placement(self, texture) -> int:
        """Mouse up: fill the dragged rectangle with floors/ceilings at
        the target height, skipping occupied cells.  Returns the number
        of faces placed (one undo snapshot for the gesture)."""
        start, cur = self.placement_drag_start, self.placement_drag_current
        self.placement_drag_start = self.placement_drag_current = None
        if start is None or cur is None or self.preview_sector is None:
            return 0
        room = self._room()
        if room is None:
            return 0
        is_floor = self.state.tool == EditorTool.DRAW_FLOOR
        y = self.preview_sector[2]
        placed = 0
        x0, x1 = sorted((start[0], cur[0]))
        z0, z1 = sorted((start[1], cur[1]))
        snapshot_done = False
        for gx in range(x0, x1 + 1):
            for gz in range(z0, z1 + 1):
                if not (0 <= gx < room.width and 0 <= gz < room.depth):
                    continue
                s = room.get_sector(gx, gz)
                if s is not None and \
                        (s.floor if is_floor else s.ceiling) is not None:
                    continue
                if not snapshot_done:
                    self.state.save_undo()
                    snapshot_done = True
                if is_floor:
                    room.set_floor(gx, gz, y, texture)
                else:
                    room.set_ceiling(gx, gz, y, texture)
                placed += 1
        if placed:
            room.recalculate_bounds()
            self.state.set_status(
                f"Placed {placed} "
                f"{'floor' if is_floor else 'ceiling'}"
                f"{'s' if placed != 1 else ''}", 1.5)
        return placed

    # -----------------------------------------------------------------
    # wall placement (viewport_3d.rs:801-938, :2022-2047)
    # -----------------------------------------------------------------

    def cycle_wall_direction(self) -> None:
        """R key (:373-379): N -> E -> S -> W -> NwSe -> NeSw."""
        order = [NORTH, EAST, SOUTH, WEST, NWSE, NESW]
        self.wall_direction = order[(order.index(self.wall_direction) + 1)
                                    % len(order)]

    def press_wall(self, mouse_fb, camera_pos, basis) -> None:
        snapped = self._snap_cell(mouse_fb, camera_pos, basis)
        if snapped is None:
            return
        cell = self._world_to_cell(snapped[0] + SECTOR_SIZE * 0.5,
                                   snapped[1] + SECTOR_SIZE * 0.5)
        if cell is not None:
            self.wall_drag_start = (cell[0], cell[1], self.wall_direction)
            self.wall_drag_current = self.wall_drag_start

    def move_wall(self, mouse_fb, camera_pos, basis) -> None:
        if self.wall_drag_start is None:
            return
        snapped = self._snap_cell(mouse_fb, camera_pos, basis)
        if snapped is None:
            return
        cell = self._world_to_cell(snapped[0] + SECTOR_SIZE * 0.5,
                                   snapped[1] + SECTOR_SIZE * 0.5)
        if cell is None:
            return
        sx, sz, d = self.wall_drag_start
        # constrain the drag to the edge's axis (N/S walls run along X,
        # E/W along Z; diagonals place a single edge)
        if d in (NORTH, SOUTH):
            self.wall_drag_current = (cell[0], sz, d)
        elif d in (EAST, WEST):
            self.wall_drag_current = (sx, cell[1], d)
        else:
            self.wall_drag_current = (sx, sz, d)

    def toggle_wall_prefer(self) -> None:
        """Tab in DrawWall mode (viewport_3d.rs:382): select the high or
        low gap when an edge has several."""
        self.wall_prefer_high = not self.wall_prefer_high
        self.state.set_status(
            f"Wall gap: {'High' if self.wall_prefer_high else 'Low'}", 1.5)

    def _gap_select_y(self, room) -> float:
        """Gap-selection probe height (viewport_3d.rs:877-881, :976-980):
        just inside the room's effective top or bottom."""
        bottom, top = room.effective_height_bounds()
        return (top - 1.0) if self.wall_prefer_high else (bottom + 1.0)

    def wall_preview(self):
        """Gap-detected heights the next release would place at the drag's
        current cell (viewport_3d.rs:804-938 preview), or None."""
        cur = self.wall_drag_current
        room = self._room()
        if cur is None or room is None:
            return None
        gx, gz, d = cur
        sector = room.get_sector(gx, gz)
        bottom, top = room.effective_height_bounds()
        gap_y = self._gap_select_y(room)
        if sector is None:
            return [bottom, bottom, top, top]
        if d in (NWSE, NESW):
            return sector.next_diagonal_wall_position(d == NWSE, bottom,
                                                      top, gap_y)
        return sector.next_wall_position(d, bottom, top, gap_y)

    @staticmethod
    def _wall_normal_mode(room, gx, gz, d, camera_pos) -> int:
        """Front/Back by the camera's side of the wall plane
        (viewport_3d.rs:2741-2776)."""
        if camera_pos is None:
            return 0
        base_x = float(room.position[0]) + gx * SECTOR_SIZE
        base_z = float(room.position[2]) + gz * SECTOR_SIZE
        half = SECTOR_SIZE / 2.0
        center = {
            NORTH: (base_x + half, base_z),
            SOUTH: (base_x + half, base_z + SECTOR_SIZE),
            EAST: (base_x + SECTOR_SIZE, base_z + half),
            WEST: (base_x, base_z + half),
            NWSE: (base_x + half, base_z + half),
            NESW: (base_x + half, base_z + half),
        }[d]
        normal = {
            NORTH: (0.0, 1.0), SOUTH: (0.0, -1.0),
            EAST: (-1.0, 0.0), WEST: (1.0, 0.0),
            # diagonal normals perpendicular to the NW-SE / NE-SW edge
            NWSE: (-1.0, 1.0), NESW: (1.0, 1.0),
        }[d]
        to_cam = (float(camera_pos[0]) - center[0],
                  float(camera_pos[2]) - center[1])
        dot = normal[0] * to_cam[0] + normal[1] * to_cam[1]
        return 1 if dot < 0.0 else 0   # FaceNormalMode::Back / Front

    def release_wall(self, texture, camera_pos=None) -> int:
        """Place gap-detected walls along the dragged edge line
        (viewport_3d.rs:2640-2790; diagonals :2048-2120 place one edge).
        Cells outside the room grow it exactly like floor placement."""
        from .grid_view import _expand_room_for

        start, cur = self.wall_drag_start, self.wall_drag_current
        self.wall_drag_start = self.wall_drag_current = None
        if start is None or cur is None:
            return 0
        room = self._room()
        if room is None:
            return 0
        d = start[2]
        cells = []
        if d in (NORTH, SOUTH):
            x0, x1 = sorted((start[0], cur[0]))
            cells = [(x, start[1]) for x in range(x0, x1 + 1)]
        elif d in (EAST, WEST):
            z0, z1 = sorted((start[1], cur[1]))
            cells = [(start[0], z) for z in range(z0, z1 + 1)]
        else:
            cells = [(start[0], start[1])]
        placed = 0
        snapshot_done = False
        # expand the grid ONCE for the whole drag, then offset every cell —
        # expanding per-cell would shift the origin mid-loop and land later
        # cells in the wrong columns (grid_view._release_drag's approach)
        min_gx = min(c[0] for c in cells)
        min_gz = min(c[1] for c in cells)
        max_gx = max(c[0] for c in cells)
        max_gz = max(c[1] for c in cells)
        off_x = off_z = 0
        if not (0 <= min_gx and 0 <= min_gz
                and max_gx < room.width and max_gz < room.depth):
            self.state.save_undo()
            snapshot_done = True
            ax, az = _expand_room_for(room, min_gx, min_gz)
            off_x, off_z = ax - min_gx, az - min_gz
            _expand_room_for(room, max_gx + off_x, max_gz + off_z)
        for gx, gz in cells:
            gx += off_x
            gz += off_z
            if not snapshot_done:
                self.state.save_undo()
                snapshot_done = True
            sector = room.ensure_sector(gx, gz)
            bottom, top = room.effective_height_bounds()
            gap_y = self._gap_select_y(room)
            if d in (NWSE, NESW):
                heights = sector.next_diagonal_wall_position(
                    d == NWSE, bottom, top, gap_y)
            else:
                heights = sector.next_wall_position(d, bottom, top, gap_y)
            if heights is None:
                continue
            room.add_wall_heights(gx, gz, d, heights, texture)
            sector.walls(d)[-1].normal_mode = self._wall_normal_mode(
                room, gx, gz, d, camera_pos)
            placed += 1
        # drop any geometry-less sectors ensure_sector created for cells
        # whose edge had no gap, then refresh bounds (viewport_3d.rs:2790)
        room.cleanup_empty_sectors()
        room.recalculate_bounds()
        if placed:
            self.state.set_status(f"Placed {placed} wall"
                                  f"{'s' if placed != 1 else ''}", 1.5)
        return placed

    # -----------------------------------------------------------------
    # select-tool height dragging (face / vertex)
    # -----------------------------------------------------------------

    def press_select_drag(self, mouse_fb) -> None:
        """Mouse down with a floor/ceiling (or vertex) selected: arm the
        height drag; the undo snapshot lands on first movement."""
        sel = self.state.selection
        if sel.kind not in ("sector_face", "vertex"):
            return
        face = self._selected_face(sel)
        if face is None:
            return
        self.drag_started = False
        self.drag_start_mouse_y = mouse_fb[1]
        self.drag_start_heights = list(face.heights)

    def _selected_face(self, sel) -> Optional[HorizontalFace]:
        room = self.state.level.rooms[sel.room] \
            if sel.room < len(self.state.level.rooms) else None
        if room is None:
            return None
        s = room.get_sector(sel.x, sel.z)
        if s is None:
            return None
        if sel.face is not None and sel.face.kind == "ceiling":
            return s.ceiling
        return s.floor

    def move_select_drag(self, mouse_fb) -> None:
        sel = self.state.selection
        if self.drag_start_heights is None or \
                sel.kind not in ("sector_face", "vertex"):
            return
        face = self._selected_face(sel)
        if face is None:
            return
        delta = (self.drag_start_mouse_y - mouse_fb[1]) * Y_SENSITIVITY
        snapped = round(delta / CLICK_HEIGHT) * CLICK_HEIGHT
        if snapped != 0.0 and not self.drag_started:
            self.state.save_undo()
            self.drag_started = True
        if not self.drag_started:
            return
        if sel.kind == "vertex":
            corner = sel.corner_idx
            face.heights[corner] = self.drag_start_heights[corner] + snapped
        else:
            for i in range(4):
                face.heights[i] = self.drag_start_heights[i] + snapped
        self.state.dirty = True

    def release_select_drag(self) -> None:
        if self.drag_started:
            room = self._room()
            if room is not None:
                room.recalculate_bounds()
        self.drag_started = False
        self.drag_start_heights = None

    # -----------------------------------------------------------------
    # object placement / dragging (viewport_3d.rs:2071-2140)
    # -----------------------------------------------------------------

    def place_object(self, mouse_fb, camera_pos, basis) -> Optional[int]:
        """Click with PlaceObject + a selected asset: add an instance at
        the snapped cell.  Returns the new object index."""
        if self.selected_asset is None:
            return None
        snapped = self._snap_cell(mouse_fb, camera_pos, basis)
        if snapped is None:
            return None
        cell = self._world_to_cell(snapped[0] + SECTOR_SIZE * 0.5,
                                   snapped[1] + SECTOR_SIZE * 0.5)
        room = self._room()
        if room is None or cell is None:
            return None
        if not (0 <= cell[0] < room.width and 0 <= cell[1] < room.depth):
            return None
        self.state.save_undo()
        room.objects.append(AssetInstance(
            sector_x=cell[0], sector_z=cell[1],
            asset_id=self.selected_asset))
        idx = len(room.objects) - 1
        self.state.set_selection(Selection(kind="object",
                                           room=self.state.current_room,
                                           index=idx))
        return idx

    def press_object(self, room_idx: int, obj_idx: int, mouse_fb,
                     camera_pos, basis, shift: bool = False) -> None:
        """Click on an existing object: select + start XZ (or Shift=Y)
        drag (:2075-2115)."""
        self.state.save_selection_undo()
        self.state.set_selection(Selection(kind="object", room=room_idx,
                                           index=obj_idx))
        room = self.state.level.rooms[room_idx]
        obj = room.objects[obj_idx]
        self.dragging_object = (room_idx, obj_idx)
        self.drag_started = False
        if shift:
            self.object_drag_y = True
            self.object_drag_initial_height = obj.height
            self.object_drag_start_mouse_y = mouse_fb[1]
        else:
            self.object_drag_y = False
            wp = obj.world_position(room)
            hit = pick_plane(mouse_fb, camera_pos, basis, self.fb_w,
                             self.fb_h, float(wp[1]))
            if hit is not None:
                self.object_xz_click_offset = (float(hit[0] - wp[0]),
                                               float(hit[2] - wp[2]))

    def move_object(self, mouse_fb, camera_pos, basis) -> None:
        if self.dragging_object is None:
            return
        room_idx, obj_idx = self.dragging_object
        room = self.state.level.rooms[room_idx]
        obj = room.objects[obj_idx]
        if not self.drag_started:
            self.state.save_undo()
            self.drag_started = True
        if self.object_drag_y:
            delta = (self.object_drag_start_mouse_y - mouse_fb[1]) \
                * Y_SENSITIVITY
            obj.height = self.object_drag_initial_height + delta
            return
        wp = obj.world_position(room)
        hit = pick_plane(mouse_fb, camera_pos, basis, self.fb_w, self.fb_h,
                         float(wp[1]))
        if hit is None:
            return
        wx = hit[0] - self.object_xz_click_offset[0]
        wz = hit[2] - self.object_xz_click_offset[1]
        cell = self._world_to_cell(wx, wz)
        if cell is None:
            return
        gx = min(max(cell[0], 0), room.width - 1)
        gz = min(max(cell[1], 0), room.depth - 1)
        obj.sector_x, obj.sector_z = gx, gz

    def release_object(self) -> None:
        self.dragging_object = None
        self.drag_started = False


# ---------------------------------------------------------------------------
# Box select + shared multi-vertex drags (viewport_3d.rs:1159-1230,
# 1990-2005, 2994-3022, 7512-7600)
# ---------------------------------------------------------------------------

def _face_world_corners(room, gx: int, gz: int, face: HorizontalFace):
    """World-space corner positions [NW, NE, SE, SW] of a sector face."""
    bx = float(room.position[0]) + gx * SECTOR_SIZE
    bz = float(room.position[2]) + gz * SECTOR_SIZE
    by = float(room.position[1])
    ss = SECTOR_SIZE
    offs = ((0.0, 0.0), (ss, 0.0), (ss, ss), (0.0, ss))
    return [np.asarray([bx + ox, by + float(face.heights[i]), bz + oz],
                       np.float32)
            for i, (ox, oz) in enumerate(offs)]


class BoxSelector:
    """Marquee selection over the 3D viewport (viewport_3d.rs box select:
    press on empty space, drag a screen rect, release collects the face
    centers inside it into the multi-selection)."""

    def __init__(self, editor: "ViewportEditor"):
        self.editor = editor
        self.start: Optional[Tuple[float, float]] = None
        self.current: Optional[Tuple[float, float]] = None
        self.active = False

    def press(self, mouse_fb, shift: bool = False) -> None:
        """Begin on empty-space click; plain click clears the selection
        first (viewport_3d.rs:1994-2003)."""
        st = self.editor.state
        if not shift and (st.selection.kind != "none" or st.multi_selection):
            st.save_selection_undo()
            st.clear_selection()
        self.start = (float(mouse_fb[0]), float(mouse_fb[1]))
        self.current = self.start
        self.active = True

    def move(self, mouse_fb) -> None:
        if self.active:
            self.current = (float(mouse_fb[0]), float(mouse_fb[1]))

    def rect(self) -> Optional[Tuple[float, float, float, float]]:
        if not self.active or self.start is None or self.current is None:
            return None
        x0, x1 = sorted((self.start[0], self.current[0]))
        y0, y1 = sorted((self.start[1], self.current[1]))
        return (x0, y0, x1, y1)

    def release(self, camera_pos, basis) -> int:
        """Collect face selections whose projected centers fall inside the
        rect (>3 px each way, viewport_3d.rs:3001); returns the count."""
        r = self.rect()
        self.active = False
        self.start = self.current = None
        if r is None:
            return 0
        x0, y0, x1, y1 = r
        if (x1 - x0) <= 3.0 and (y1 - y0) <= 3.0:
            return 0
        ed = self.editor
        st = ed.state
        room = ed._room()
        if room is None:
            return 0
        collected = []
        centers = []

        def center_of(points):
            p = np.mean(np.stack(points, axis=0), axis=0)
            return p

        from .state import SectorFace
        room_idx = st.current_room
        for gx, gz, sector in room.iter_sectors():
            if sector.floor is not None:
                centers.append((center_of(_face_world_corners(
                    room, gx, gz, sector.floor)),
                    Selection(kind="sector_face", room=room_idx, x=gx,
                              z=gz, face=SectorFace("floor"))))
            if sector.ceiling is not None:
                centers.append((center_of(_face_world_corners(
                    room, gx, gz, sector.ceiling)),
                    Selection(kind="sector_face", room=room_idx, x=gx,
                              z=gz, face=SectorFace("ceiling"))))
            for dname, dcode in (("walls_north", NORTH), ("walls_east", EAST),
                                 ("walls_south", SOUTH), ("walls_west", WEST),
                                 ("walls_nwse", NWSE), ("walls_nesw", NESW)):
                for wi, wall in enumerate(getattr(sector, dname)):
                    bx = float(room.position[0]) + gx * SECTOR_SIZE
                    bz = float(room.position[2]) + gz * SECTOR_SIZE
                    by = float(room.position[1])
                    ss = SECTOR_SIZE
                    a, b = {
                        NORTH: ((bx, bz), (bx + ss, bz)),
                        EAST: ((bx + ss, bz), (bx + ss, bz + ss)),
                        SOUTH: ((bx, bz + ss), (bx + ss, bz + ss)),
                        WEST: ((bx, bz), (bx, bz + ss)),
                        NWSE: ((bx, bz), (bx + ss, bz + ss)),
                        NESW: ((bx + ss, bz), (bx, bz + ss)),
                    }[dcode]
                    ymid = by + (float(wall.heights[0])
                                 + float(wall.heights[2])) * 0.5
                    c = np.asarray([(a[0] + b[0]) * 0.5, ymid,
                                    (a[1] + b[1]) * 0.5], np.float32)
                    centers.append((c, Selection(
                        kind="sector_face", room=room_idx, x=gx, z=gz,
                        face=SectorFace("wall", direction=dcode,
                                        wall_index=wi))))

        for c, sel in centers:
            sx, sy, _, ok = picking.world_to_screen(
                c, np.asarray(camera_pos, np.float32),
                np.asarray(basis, np.float32), ed.fb_w, ed.fb_h)
            if bool(ok) and x0 <= float(sx) <= x1 and y0 <= float(sy) <= y1:
                collected.append(sel)

        if collected:
            st.save_selection_undo()
            for sel in collected:
                st.add_to_multi_selection(sel)
            if st.selection.kind == "none" and st.multi_selection:
                st.selection = st.multi_selection[0]
            st.set_status(f"Selected {len(st.multi_selection)} items", 2.0)
        return len(collected)


class VertexDrag:
    """Shared multi-vertex height drag (viewport_3d.rs:1159-1230): every
    selected vertex drags together, and coincident corners of ADJACENT
    sector faces at the same world position move with them."""

    EPS = 0.5   # world-units coincidence tolerance

    def __init__(self, editor: "ViewportEditor"):
        self.editor = editor
        self.entries: list = []     # (face, corner, initial_height)
        self.start_mouse_y = 0.0
        self.started = False

    def _vertex_selections(self):
        st = self.editor.state
        sels = [st.selection] + list(st.multi_selection)
        return [s for s in sels if s.kind == "vertex"]

    def press(self, mouse_fb) -> bool:
        ed = self.editor
        st = ed.state
        room = ed._room()
        vsels = self._vertex_selections()
        if room is None or not vsels:
            return False
        # world positions of explicitly selected corners
        keyed = {}    # id(face) -> set(corner)
        positions = []
        for s in vsels:
            sector = room.get_sector(s.x, s.z)
            if sector is None:
                continue
            face = (sector.ceiling if s.face is not None
                    and s.face.kind == "ceiling" else sector.floor)
            if face is None:
                continue
            corners = _face_world_corners(room, s.x, s.z, face)
            c = s.corner_idx or 0
            keyed.setdefault(id(face), (face, set()))[1].add(c)
            positions.append(corners[c])
        if not positions:
            return False
        # coincident corners across every sector face (shared vertices of
        # neighbouring sectors drag together, viewport_3d.rs:1211-1229)
        for gx, gz, sector in room.iter_sectors():
            for face in (sector.floor, sector.ceiling):
                if face is None:
                    continue
                corners = _face_world_corners(room, gx, gz, face)
                for ci, cpos in enumerate(corners):
                    for p in positions:
                        if (abs(float(cpos[0]) - float(p[0])) < self.EPS
                                and abs(float(cpos[1]) - float(p[1]))
                                < self.EPS
                                and abs(float(cpos[2]) - float(p[2]))
                                < self.EPS):
                            keyed.setdefault(id(face),
                                             (face, set()))[1].add(ci)
                            break
        self.entries = []
        for face, corners in keyed.values():
            for ci in corners:
                self.entries.append((face, ci, float(face.heights[ci])))
        self.start_mouse_y = float(mouse_fb[1])
        self.started = False
        return True

    def move(self, mouse_fb) -> None:
        if not self.entries:
            return
        delta = (self.start_mouse_y - float(mouse_fb[1])) * Y_SENSITIVITY
        snapped = round(delta / CLICK_HEIGHT) * CLICK_HEIGHT
        if snapped != 0.0 and not self.started:
            self.editor.state.save_undo()
            self.started = True
        if not self.started:
            return
        for face, ci, h0 in self.entries:
            face.heights[ci] = h0 + snapped
        self.editor.state.dirty = True

    def release(self) -> None:
        if self.started:
            room = self.editor._room()
            if room is not None:
                room.recalculate_bounds()
            self.editor.state.mark_portals_dirty()
        self.entries = []
        self.started = False
