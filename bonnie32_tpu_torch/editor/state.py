"""EditorState: tool/selection model, snapshot undo/redo, clipboards.
(The port's own copy of the JAX package's `editor/state.py`, host code.)

Reference behavior: `src/editor/state.rs` —
EditorTool (:126), GridViewMode (:136), TriangleSelection (:144),
SectorFace (:153), Selection (:188), SelectionSnapshot (:214),
FaceClipboard (:221), GeometryClipboard + CopiedFace (:254-307),
UndoEvent (:318), save_undo/save_selection_undo/save_texture_undo/
undo/redo (:938-1093; full-Level snapshots, 100-entry cap).
"""

from __future__ import annotations

import copy
import dataclasses
import enum
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..models.level import (SECTOR_SIZE, Level, Room, Sector,
                            create_empty_level)


class EditorTool(enum.Enum):
    """state.rs:126."""

    SELECT = "select"
    DRAW_FLOOR = "draw_floor"
    DRAW_WALL = "draw_wall"
    DRAW_CEILING = "draw_ceiling"
    PLACE_OBJECT = "place_object"


class GridViewMode(enum.Enum):
    """state.rs:136 — 2D grid projection."""

    TOP = "top"
    FRONT = "front"
    SIDE = "side"


class TriangleSelection(enum.Enum):
    """state.rs:144."""

    BOTH = "both"
    TRI1 = "tri1"
    TRI2 = "tri2"


# SectorFace (state.rs:153): kind + wall index.  Directions follow
# models.level's wall order (N, E, S, W, NwSe, NeSw).
@dataclasses.dataclass(frozen=True)
class SectorFace:
    kind: str                 # "floor" | "ceiling" | "wall"
    direction: Optional[int] = None  # 0..5 for walls
    wall_index: int = 0

    @property
    def is_wall(self) -> bool:
        return self.kind == "wall"


@dataclasses.dataclass(frozen=True)
class Selection:
    """state.rs:188 — tagged selection.

    kind: none | room | sector | sector_face | vertex | edge | portal |
    object.  Fields are used as the corresponding variant requires.
    """

    kind: str = "none"
    room: int = 0
    x: int = 0
    z: int = 0
    face: Optional[SectorFace] = None
    corner_idx: int = 0
    edge_idx: int = 0
    index: int = 0

    def includes_sector(self, room_idx: int, sx: int, sz: int) -> bool:
        """state.rs:330."""
        if self.kind in ("sector", "sector_face", "vertex", "edge"):
            return (self.room, self.x, self.z) == (room_idx, sx, sz)
        return False


@dataclasses.dataclass
class SelectionSnapshot:
    """state.rs:214."""

    selection: Selection
    multi_selection: List[Selection]


@dataclasses.dataclass
class FaceClipboard:
    """state.rs:221 — face PROPERTIES (no heights): a dict of the face's
    visual fields keyed by the face type."""

    kind: str                 # "horizontal" | "vertical"
    props: Dict[str, Any]


@dataclasses.dataclass
class CopiedFace:
    """state.rs:286 — face data at a sector offset from the copy anchor."""

    rel_x: int
    rel_z: int
    kind: str                 # "floor" | "ceiling" | "wall"
    direction: Optional[int]  # wall direction 0..5
    wall_index: int
    face: Any                 # HorizontalFace | VerticalFace (deep copy)


@dataclasses.dataclass
class GeometryClipboard:
    """state.rs:274 — copied faces + paste transform toggles."""

    faces: List[CopiedFace] = dataclasses.field(default_factory=list)
    flip_h: bool = False
    flip_v: bool = False
    rotation: int = 0         # 0..3 quarter turns clockwise

    def bounds(self) -> Tuple[int, int, int, int]:
        """state.rs:297 — (min_x, max_x, min_z, max_z)."""
        if not self.faces:
            return (0, 0, 0, 0)
        xs = [f.rel_x for f in self.faces]
        zs = [f.rel_z for f in self.faces]
        return (min(xs), max(xs), min(zs), max(zs))

    def transformed_offset(self, rel_x: int, rel_z: int) -> Tuple[int, int]:
        """Rotation-then-flips against the clipboard bounds
        (layout.rs:1461-1483 transform_clipboard_position)."""
        mn_x, mx_x, mn_z, mx_z = self.bounds()
        return transform_clipboard_position(
            rel_x, rel_z, mx_x - mn_x, mx_z - mn_z,
            self.rotation, self.flip_h, self.flip_v)


def transform_clipboard_position(rel_x: int, rel_z: int, width: int,
                                 depth: int, rotation: int, flip_h: bool,
                                 flip_v: bool) -> Tuple[int, int]:
    """layout.rs:1461-1483 — rotate about the clipboard extents FIRST,
    then flip within the rotated extents."""
    rotation %= 4
    if rotation == 1:       # 90 deg CW
        rx, rz, rw, rd = depth - rel_z, rel_x, depth, width
    elif rotation == 2:     # 180
        rx, rz, rw, rd = width - rel_x, depth - rel_z, width, depth
    elif rotation == 3:     # 270 CW
        rx, rz, rw, rd = rel_z, width - rel_x, depth, width
    else:
        rx, rz, rw, rd = rel_x, rel_z, width, depth
    if flip_h:
        rx = rw - rx
    if flip_v:
        rz = rd - rz
    return rx, rz


def rotate_quad(vals, rotation: int):
    """layout.rs:1486-1509 rotate_heights / rotate_colors — 90 deg CW per
    step over the [NW, NE, SE, SW] corner order."""
    vals = list(vals)
    rotation %= 4
    if rotation == 1:
        return [vals[3], vals[0], vals[1], vals[2]]
    if rotation == 2:
        return [vals[2], vals[3], vals[0], vals[1]]
    if rotation == 3:
        return [vals[1], vals[2], vals[3], vals[0]]
    return vals


def _flip_quad(vals, flip_h: bool, flip_v: bool):
    """Corner swaps for already-rotated [NW, NE, SE, SW] quads
    (layout.rs:1680-1699)."""
    vals = list(vals)
    if flip_h:
        vals = [vals[1], vals[0], vals[3], vals[2]]
    if flip_v:
        vals = [vals[3], vals[2], vals[1], vals[0]]
    return vals


def transform_wall_direction(direction: int, rotation: int, flip_h: bool,
                             flip_v: bool) -> int:
    """layout.rs:1511-1566 — wall list retargeting under paste
    transforms.  Directions are level.py's NORTH..NESW codes."""
    from ..models.level import EAST, NESW, NORTH, NWSE, SOUTH, WEST

    rot_cards = {NORTH: EAST, EAST: SOUTH, SOUTH: WEST, WEST: NORTH}
    d = direction
    r = rotation % 4
    for _ in range(r):
        d = rot_cards.get(d, NWSE if d == NESW else NESW)
    if flip_h and flip_v:
        d = {NORTH: SOUTH, SOUTH: NORTH, EAST: WEST, WEST: EAST}.get(d, d)
    elif flip_h:
        d = {EAST: WEST, WEST: EAST, NWSE: NESW, NESW: NWSE}.get(d, d)
    elif flip_v:
        d = {NORTH: SOUTH, SOUTH: NORTH, NWSE: NESW, NESW: NWSE}.get(d, d)
    return d


@dataclasses.dataclass
class UndoEvent:
    """state.rs:318 — level snapshot, selection snapshot, or texture edit."""

    kind: str                 # "level" | "selection" | "texture"
    level: Optional[Level] = None
    selection: Optional[SelectionSnapshot] = None
    texture_name: str = ""
    texture_indices: Optional[List[int]] = None
    texture_palette: Optional[List[int]] = None


MAX_UNDO = 100  # state.rs:945

# TRLE grid constraints (state.rs:104-108)
CLICK_HEIGHT = 256.0
CEILING_HEIGHT = 3072.0


@dataclasses.dataclass
class MemoryStats:
    """state.rs:52 — process + asset memory accounting for the debug HUD."""

    physical_bytes: int = 0
    texture_bytes: int = 0
    texture15_bytes: int = 0
    framebuffer_bytes: int = 0
    texture_count: int = 0
    gpu_cache_count: int = 0

    def update_process_memory(self) -> None:
        """RSS from the OS (state.rs:69; /proc on Linux)."""
        try:
            with open("/proc/self/statm") as f:
                pages = int(f.read().split()[1])
            import os
            self.physical_bytes = pages * os.sysconf("SC_PAGE_SIZE")
        except (OSError, ValueError, IndexError):
            pass

    def update_assets(self, textures=(), framebuffers=()) -> None:
        """Estimate texture/framebuffer footprints: 15-bit textures are 2
        bytes/texel; framebuffers 4 (color) + 4 (depth) bytes/pixel."""
        self.texture_count = len(textures)
        self.texture15_bytes = sum(
            int(t.shape[0]) * int(t.shape[1]) * 2 for t in textures)
        self.texture_bytes = self.texture15_bytes * 2  # rgba8 source copies
        self.framebuffer_bytes = sum(
            int(fb.shape[-2]) * int(fb.shape[-1]) * 8 for fb in framebuffers)

    @staticmethod
    def format_bytes(n: int) -> str:
        """state.rs:76."""
        if n >= 1024 ** 3:
            return f"{n / 1024 ** 3:.1f} GB"
        if n >= 1024 ** 2:
            return f"{n / 1024 ** 2:.1f} MB"
        if n >= 1024:
            return f"{n / 1024:.1f} KB"
        return f"{n} B"


class EditorState:
    """state.rs:384 — the world editor's host-side state."""

    def __init__(self, level: Optional[Level] = None):
        self.level = level if level is not None else create_empty_level()
        self.current_room = 0
        self.tool = EditorTool.SELECT
        self.grid_view = GridViewMode.TOP
        self.triangle_selection = TriangleSelection.BOTH
        self.selection = Selection()
        self.multi_selection: List[Selection] = []
        self.undo_stack: List[UndoEvent] = []
        self.redo_stack: List[UndoEvent] = []
        self.face_clipboard: Optional[FaceClipboard] = None
        self.geometry_clipboard = GeometryClipboard()
        self.user_textures: Dict[str, Any] = {}
        self.dirty = False
        # status toast (state.rs:922 set_status): message + remaining secs
        self.status_message: str = ""
        self.status_time: float = 0.0
        # --- 2D grid view state (state.rs:401-487, :613, :696) ---
        self.grid_offset_x = 0.0
        self.grid_offset_y = 0.0
        self.grid_zoom = 0.1          # px per world unit (state.rs:755)
        self.grid_size = 1024.0       # SECTOR_SIZE grid step
        self.show_grid = True
        self.grid_last_mouse: Tuple[float, float] = (0.0, 0.0)
        self.grid_panning = False
        self.grid_dragging_sectors: List[Tuple[int, int, int]] = []
        self.grid_sector_drag_offset: Tuple[float, float] = (0.0, 0.0)
        self.grid_sector_drag_start: Optional[Tuple[float, float]] = None
        self.grid_dragging_room_origin = False
        self.grid_dragging_object: Optional[Tuple[int, int]] = None
        self.selection_rect_start: Optional[Tuple[float, float]] = None
        self.selection_rect_end: Optional[Tuple[float, float]] = None
        self.hidden_rooms: set = set()
        self.selected_texture: Any = None     # TextureRef
        self.selected_asset: Optional[str] = None
        self.asset_library: Any = None        # AssetLibrary when wired
        self.wall_direction: int = 0          # NORTH; state.rs wall tool
        self.portals_dirty = True             # state.rs:616
        self.current_file = None              # state.rs current_file
        # --- debug HUD inputs (state.rs:52, layout.rs:2816) ---
        self.memory_stats = MemoryStats()
        self.frame_timings: Dict[str, float] = {}   # section -> ms
        self.frame_fps: float = 0.0
        # --- 3D viewport camera (state.rs:418-428, :704-731) ---
        self.camera_pos = np.array([4096.0, 4096.0, 4096.0], np.float32)
        self.camera_rot_x = 0.46
        self.camera_rot_y = 4.02
        self.camera_mode = "free"             # "free" | "orbit"
        self.orbit_target = np.array([512.0, 512.0, 512.0], np.float32)
        self.orbit_distance = 4000.0
        self.orbit_azimuth = 0.8
        self.orbit_elevation = 0.4
        self.last_orbit_target = self.orbit_target.copy()

    def camera_basis(self) -> np.ndarray:
        """Camera::update_basis (camera.rs:76-91) for the editor camera."""
        from ..models import build
        return np.asarray(build.camera_basis(self.camera_rot_x,
                                             self.camera_rot_y))

    def sync_camera_from_orbit(self) -> None:
        """state.rs:1128 — place the camera behind the orbit target along
        the current azimuth/elevation."""
        pitch, yaw = self.orbit_elevation, self.orbit_azimuth
        forward = np.array([math.cos(pitch) * math.sin(yaw),
                            -math.sin(pitch),
                            math.cos(pitch) * math.cos(yaw)], np.float32)
        self.camera_pos = (np.asarray(self.orbit_target, np.float32)
                           - forward * np.float32(self.orbit_distance))
        self.camera_rot_x = pitch
        self.camera_rot_y = yaw

    def get_selection_center(self):
        """state.rs:1147 — world-space center of the selection (orbit
        target), or None.  Covers every variant incl. portals/objects."""
        s = self.selection
        rooms = self.level.rooms
        if s.kind == "none" or not (0 <= s.room < len(rooms)):
            return None
        room = rooms[s.room]
        if s.kind == "room":
            return np.array([
                float(room.position[0]) + room.width * SECTOR_SIZE / 2.0,
                float(room.position[1]) + 512.0,
                float(room.position[2]) + room.depth * SECTOR_SIZE / 2.0,
            ], np.float32)
        if s.kind in ("sector", "sector_face", "vertex", "edge"):
            sector = room.get_sector(s.x, s.z)
            if sector is None:
                return None
            floor_y = sector.floor.avg_height() if sector.floor else 0.0
            ceil_y = (sector.ceiling.avg_height() if sector.ceiling
                      else 2048.0)
            return np.array([
                float(room.position[0]) + (s.x + 0.5) * SECTOR_SIZE,
                (floor_y + ceil_y) / 2.0,
                float(room.position[2]) + (s.z + 0.5) * SECTOR_SIZE,
            ], np.float32)
        if s.kind == "portal":
            if not (0 <= s.index < len(room.portals)):
                return None
            # portal vertices are room-relative (level.py Portal docstring)
            return (np.mean(np.asarray(room.portals[s.index].vertices,
                                       np.float32), axis=0)
                    + np.asarray(room.position, np.float32))
        if s.kind == "object":
            if not (0 <= s.index < len(room.objects)):
                return None
            return np.asarray(room.objects[s.index].world_position(room),
                              np.float32)
        return None

    def update_orbit_target(self) -> None:
        """state.rs:1225."""
        center = self.get_selection_center()
        if center is not None:
            self.orbit_target = center
            self.last_orbit_target = center.copy()
        else:
            self.orbit_target = self.last_orbit_target

    def center_camera_on_selection(self) -> None:
        """state.rs:1237 — orbit mode retargets; free mode keeps the
        current distance and basis but looks at the selection."""
        center = self.get_selection_center()
        if center is None:
            return
        if self.camera_mode == "orbit":
            self.orbit_target = center
            self.last_orbit_target = center.copy()
            self.sync_camera_from_orbit()
        else:
            to_camera = self.camera_pos - center
            distance = float(np.sqrt(np.sum(to_camera ** 2)))
            if distance <= 0.1:
                distance = 2000.0
            bz = self.camera_basis()[2]
            self.camera_pos = (center - bz * np.float32(distance)).astype(
                np.float32)

    def toggle_multi_selection(self, sel: Selection) -> None:
        """state.rs:1110 — Shift+click toggling; folds the primary
        selection in first so the first-clicked item stays selected."""
        if self.selection.kind != "none" \
                and self.selection not in self.multi_selection:
            self.multi_selection.append(self.selection)
        if sel in self.multi_selection:
            self.multi_selection.remove(sel)
        elif sel.kind != "none":
            self.multi_selection.append(sel)

    def mark_portals_dirty(self) -> None:
        """state.rs:1251 — portal recompute is deferred to the frame."""
        self.portals_dirty = True

    def set_status(self, message: str, seconds: float = 2.0) -> None:
        """state.rs:922 — transient status-bar toast (the reference's only
        user-facing observability channel)."""
        self.status_message = message
        self.status_time = float(seconds)

    def tick_status(self, dt: float) -> None:
        """Advance the toast timer; clears the message when it expires."""
        if self.status_time > 0.0:
            self.status_time = max(self.status_time - dt, 0.0)
            if self.status_time == 0.0:
                self.status_message = ""

    # --- rooms ---------------------------------------------------------

    def current_room_ref(self) -> Optional[Room]:
        if 0 <= self.current_room < len(self.level.rooms):
            return self.level.rooms[self.current_room]
        return None

    # --- selection -----------------------------------------------------

    def set_selection(self, sel: Selection) -> None:
        self.selection = sel

    def clear_selection(self) -> None:
        self.selection = Selection()
        self.multi_selection = []

    def add_to_multi_selection(self, sel: Selection) -> None:
        if sel not in self.multi_selection:
            self.multi_selection.append(sel)

    def selected_sectors(self) -> List[Tuple[int, int, int]]:
        """All (room, x, z) touched by the selection set."""
        out = []
        for s in [self.selection] + self.multi_selection:
            if s.kind in ("sector", "sector_face", "vertex", "edge"):
                key = (s.room, s.x, s.z)
                if key not in out:
                    out.append(key)
        return out

    # --- undo / redo (state.rs:938-1093) ----------------------------------

    def _push_undo(self, ev: UndoEvent) -> None:
        self.undo_stack.append(ev)
        self.redo_stack.clear()
        if len(self.undo_stack) > MAX_UNDO:
            self.undo_stack.pop(0)

    def save_undo(self) -> None:
        """Full-Level snapshot (state.rs:938)."""
        self._push_undo(UndoEvent(kind="level",
                                  level=copy.deepcopy(self.level)))
        self.dirty = True

    def save_selection_undo(self) -> None:
        """state.rs:951 — skipped when unchanged from the last selection
        snapshot."""
        for ev in reversed(self.undo_stack):
            if ev.kind == "selection":
                if (ev.selection.selection == self.selection
                        and ev.selection.multi_selection
                        == self.multi_selection):
                    return
                break
        self._push_undo(UndoEvent(
            kind="selection",
            selection=SelectionSnapshot(self.selection,
                                        list(self.multi_selection))))

    def save_texture_undo(self, name: str) -> None:
        """state.rs:976."""
        tex = self.user_textures.get(name)
        if tex is None:
            return
        self._push_undo(UndoEvent(
            kind="texture", texture_name=name,
            texture_indices=list(tex.indices),
            texture_palette=list(tex.palette)))

    def _texture_event_now(self, name: str) -> Optional[UndoEvent]:
        tex = self.user_textures.get(name)
        if tex is None:
            return None
        return UndoEvent(kind="texture", texture_name=name,
                         texture_indices=list(tex.indices),
                         texture_palette=list(tex.palette))

    def _apply_event(self, ev: UndoEvent, other_stack: List[UndoEvent]):
        if ev.kind == "level":
            other_stack.append(UndoEvent(kind="level",
                                         level=copy.deepcopy(self.level)))
            self.level = ev.level
        elif ev.kind == "selection":
            other_stack.append(UndoEvent(
                kind="selection",
                selection=SelectionSnapshot(self.selection,
                                            list(self.multi_selection))))
            self.set_selection(ev.selection.selection)
            self.multi_selection = list(ev.selection.multi_selection)
        elif ev.kind == "texture":
            cur = self._texture_event_now(ev.texture_name)
            if cur is not None:
                other_stack.append(cur)
            tex = self.user_textures.get(ev.texture_name)
            if tex is not None:
                tex.indices = list(ev.texture_indices)
                tex.palette = list(ev.texture_palette)

    def undo(self) -> bool:
        if not self.undo_stack:
            return False
        self._apply_event(self.undo_stack.pop(), self.redo_stack)
        return True

    def redo(self) -> bool:
        if not self.redo_stack:
            return False
        self._apply_event(self.redo_stack.pop(), self.undo_stack)
        return True

    # --- geometry clipboard ----------------------------------------------

    def copy_selected_geometry(self) -> int:
        """Copy all faces of the selected sectors, positions relative to the
        first selected sector (the anchor).  Returns the face count."""
        sectors = self.selected_sectors()
        if not sectors:
            return 0
        ar, ax, az = sectors[0]
        faces: List[CopiedFace] = []
        for (r, x, z) in sectors:
            if r != ar:
                continue  # single-room clipboard, like the reference
            room = self.level.rooms[r]
            sec = room.sectors[x][z]
            if sec is None:
                continue
            if sec.floor is not None:
                faces.append(CopiedFace(x - ax, z - az, "floor", None, 0,
                                        copy.deepcopy(sec.floor)))
            if sec.ceiling is not None:
                faces.append(CopiedFace(x - ax, z - az, "ceiling", None, 0,
                                        copy.deepcopy(sec.ceiling)))
            for d in range(6):
                for wi, wf in enumerate(sec.walls(d)):
                    faces.append(CopiedFace(x - ax, z - az, "wall", d, wi,
                                            copy.deepcopy(wf)))
        self.geometry_clipboard = GeometryClipboard(faces=faces)
        return len(faces)

    def paste_geometry(self, room_idx: int, at_x: int, at_z: int) -> int:
        """layout.rs:1574-1878 paste_geometry_at_impl: rotate/flip the
        face offsets AND contents (corner heights, corner colors, split
        direction with tri1/tri2 swap, wall list retargeting), expanding
        the room grid to fit.  Saves a level undo snapshot first.
        Returns faces pasted."""
        clip = self.geometry_clipboard
        if not clip.faces or room_idx >= len(self.level.rooms):
            return 0
        self.save_undo()
        room = self.level.rooms[room_idx]
        mn_x, mx_x, mn_z, mx_z = clip.bounds()
        width, depth = mx_x - mn_x, mx_z - mn_z
        rot = clip.rotation % 4
        fh, fv = clip.flip_h, clip.flip_v
        # odd rotation flips the diagonal; flip_h XOR flip_v also does
        should_flip_split = (rot % 2 == 1) != (fh != fv)

        rels = [transform_clipboard_position(cf.rel_x, cf.rel_z, width,
                                             depth, rot, fh, fv)
                for cf in clip.faces]
        txs = [at_x + rx for rx, _ in rels]
        tzs = [at_z + rz for _, rz in rels]
        # expand the grid for the full target bounds (layout.rs:1597-1636)
        from .grid_view import _expand_room_for
        gx0, gz0 = _expand_room_for(room, min(txs), min(tzs))
        offset_x, offset_z = gx0 - min(txs), gz0 - min(tzs)
        _expand_room_for(room, max(txs) + offset_x, max(tzs) + offset_z)

        pasted = 0
        for cf, (rx, rz) in zip(clip.faces, rels):
            x, z = at_x + rx + offset_x, at_z + rz + offset_z
            sec = room.ensure_sector(x, z)
            face = copy.deepcopy(cf.face)
            if cf.kind in ("floor", "ceiling"):
                face.heights = _flip_quad(rotate_quad(face.heights, rot),
                                          fh, fv)
                if face.heights_2 is not None:
                    face.heights_2 = _flip_quad(
                        rotate_quad(face.heights_2, rot), fh, fv)
                face.colors = _flip_quad(rotate_quad(face.colors, rot),
                                         fh, fv)
                if face.colors_2 is not None:
                    face.colors_2 = _flip_quad(
                        rotate_quad(face.colors_2, rot), fh, fv)
                if should_flip_split:
                    face.split_direction = 1 - face.split_direction
                    # tri 1 and 2 switch positions (layout.rs:1702-1720)
                    tex1 = face.texture
                    tex2 = (face.texture_2 if face.texture_2 is not None
                            else copy.deepcopy(tex1))
                    face.texture, face.texture_2 = tex2, tex1
                    face.uv, face.uv_2 = face.uv_2, face.uv
                    c1 = face.colors
                    c2 = face.colors_2 if face.colors_2 is not None else c1
                    face.colors, face.colors_2 = c2, c1
                    h1 = face.heights
                    h2 = (face.heights_2 if face.heights_2 is not None
                          else h1)
                    face.heights, face.heights_2 = h2, h1
                if cf.kind == "floor":
                    sec.floor = face
                else:
                    sec.ceiling = face
            else:
                tgt = transform_wall_direction(cf.direction, rot, fh, fv)
                wl = sec.walls(tgt)
                if cf.wall_index < len(wl):
                    wl[cf.wall_index] = face
                else:
                    wl.append(face)
            pasted += 1
        room.recalculate_bounds()
        if pasted:
            self.set_status(f"Pasted {pasted} faces", 2.0)
        else:
            self.set_status("No faces pasted (out of bounds?)", 2.0)
        self.dirty = True
        return pasted

    # --- face-property clipboard (state.rs:221) ----------------------------

    HORIZONTAL_PROPS = ("split_direction", "texture", "uv", "colors",
                        "texture_2", "uv_2", "colors_2", "walkable",
                        "blend_mode", "normal_mode", "black_transparent")
    VERTICAL_PROPS = ("texture", "uv", "solid", "blend_mode", "colors",
                      "normal_mode", "black_transparent", "uv_projection")

    def copy_face_properties(self, face) -> None:
        """Copy the visual properties (NOT heights) of a face object."""
        from ..models.level import HorizontalFace
        horizontal = isinstance(face, HorizontalFace)
        names = self.HORIZONTAL_PROPS if horizontal else self.VERTICAL_PROPS
        props = {n: copy.deepcopy(getattr(face, n))
                 for n in names if hasattr(face, n)}
        self.face_clipboard = FaceClipboard(
            kind="horizontal" if horizontal else "vertical", props=props)

    def paste_face_properties(self, face) -> bool:
        """Apply the copied properties onto a face of the same kind."""
        from ..models.level import HorizontalFace
        if self.face_clipboard is None:
            return False
        horizontal = isinstance(face, HorizontalFace)
        if (self.face_clipboard.kind == "horizontal") != horizontal:
            return False
        for k, v in self.face_clipboard.props.items():
            if hasattr(face, k):
                setattr(face, k, copy.deepcopy(v))
        self.dirty = True
        return True


# ---------------------------------------------------------------------------
# Level lifecycle + EditorLayoutConfig persistence (state.rs:897,
# geometry.rs:3357, main.rs:2542-2640)
# ---------------------------------------------------------------------------

def _orbit_defaults() -> dict:
    """EditorLayoutConfig's serde defaults (geometry.rs:3373-3420)."""
    return dict(main_split=0.22, right_split=0.72, left_split=0.5,
                right_panel_split=0.5, grid_offset_x=0.0, grid_offset_y=0.0,
                grid_zoom=0.1, orbit_target_x=512.0, orbit_target_y=512.0,
                orbit_target_z=512.0, orbit_distance=4000.0,
                orbit_azimuth=0.8, orbit_elevation=0.4)


def apply_layout_config(state: EditorState, layout=None) -> None:
    """Restore grid pan/zoom + the orbit camera (and split ratios when an
    EditorLayout is given) from level.editor_layout — the PromptLoad flow
    (main.rs:2616-2629)."""
    cfg = dict(_orbit_defaults())
    cfg.update(state.level.editor_layout or {})
    state.grid_offset_x = float(cfg["grid_offset_x"])
    state.grid_offset_y = float(cfg["grid_offset_y"])
    state.grid_zoom = float(cfg["grid_zoom"])
    state.orbit_target = np.array([cfg["orbit_target_x"],
                                   cfg["orbit_target_y"],
                                   cfg["orbit_target_z"]], np.float32)
    state.last_orbit_target = state.orbit_target.copy()
    state.orbit_distance = float(cfg["orbit_distance"])
    state.orbit_azimuth = float(cfg["orbit_azimuth"])
    state.orbit_elevation = float(cfg["orbit_elevation"])
    state.sync_camera_from_orbit()
    if layout is not None:
        layout.main_split.ratio = float(cfg["main_split"])
        layout.right_split.ratio = float(cfg["right_split"])


def store_layout_config(state: EditorState, layout=None) -> None:
    """Write the current editor view state into level.editor_layout before
    saving (main.rs:2568-2576 to_config)."""
    cfg = dict(state.level.editor_layout or {})
    cfg.update(
        grid_offset_x=float(state.grid_offset_x),
        grid_offset_y=float(state.grid_offset_y),
        grid_zoom=float(state.grid_zoom),
        orbit_target_x=float(state.orbit_target[0]),
        orbit_target_y=float(state.orbit_target[1]),
        orbit_target_z=float(state.orbit_target[2]),
        orbit_distance=float(state.orbit_distance),
        orbit_azimuth=float(state.orbit_azimuth),
        orbit_elevation=float(state.orbit_elevation),
    )
    if layout is not None:
        cfg.update(main_split=float(layout.main_split.ratio),
                   right_split=float(layout.right_split.ratio))
    state.level.editor_layout = cfg


def load_level_into(state: EditorState, level: Level, path=None) -> None:
    """EditorState::load_level (state.rs:897): swap the level, reset
    selection/undo, refresh bounds and mark portals dirty."""
    state.level = level
    state.current_file = path
    state.selection = Selection()
    state.multi_selection = []
    state.undo_stack = []
    state.redo_stack = []
    state.dirty = False
    for room in level.rooms:
        room.recalculate_bounds()
    state.portals_dirty = True


EditorState.apply_layout_config = apply_layout_config
EditorState.store_layout_config = store_layout_config
EditorState.load_level = load_level_into
