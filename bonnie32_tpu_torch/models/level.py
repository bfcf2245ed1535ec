"""Sector/portal world data model — levels, rooms, sectors, faces (the
port's own copy of the JAX package's `models/level.py`, pure numpy).

Host-side Python mirror of the reference's `src/world/geometry.rs` with the
same serialized RON schema, mesh-emission math, collision queries and portal
detection.  Geometry math runs in numpy float32 with the reference's exact
operation order so emitted vertex buffers are bit-identical inputs to the
rasterizer.

Key reference anchors:
  * SECTOR_SIZE 1024 / UV_SCALE 0.5 (geometry.rs:10-15)
  * HorizontalFace / VerticalFace / Sector (geometry.rs:1104, 1355, 1499)
  * Room + to_render_data_with_textures (geometry.rs:2437, 2839-3352)
  * Level + get_floor_info + recalculate_portals (geometry.rs:3443-3990)
  * level IO + validation limits (world/level.rs:14-330)
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..io import ron
from ..io.ron import Tag
from ..io import brotli_io

F32 = np.float32

SECTOR_SIZE = F32(1024.0)
UV_SCALE = F32(0.5)
USER_TEXTURE_PACK = "_USER"

# validation limits (world/level.rs:14-25)
MAX_ROOMS = 256
MAX_ROOM_SIZE = 128
MAX_WALLS_PER_EDGE = 16
MAX_STRING_LEN = 256
MAX_COORD = 1_000_000.0

# BlendMode codes match config.BlendMode.
_BLEND_NAMES = ["Opaque", "Average", "Add", "Subtract", "AddQuarter", "Erase"]
_NORMAL_MODES = ["Front", "Both", "Back"]
_SPLITS = ["NwSe", "NeSw"]
_UV_PROJ = ["Default", "Projected"]

NORTH, EAST, SOUTH, WEST, NWSE, NESW = range(6)
_DIR_NAMES = ["North", "East", "South", "West", "NwSe", "NeSw"]


def _blend_code(tag) -> int:
    if tag is None:
        return 0
    name = tag.name if isinstance(tag, Tag) else str(tag)
    return _BLEND_NAMES.index(name)


def _enum_code(tag, names, default=0) -> int:
    if tag is None:
        return default
    name = tag.name if isinstance(tag, Tag) else str(tag)
    return names.index(name)


def _color_from_ron(d) -> Tuple[Tuple[int, int, int], int]:
    """Color {r, g, b, blend?} -> ((r,g,b), blend_code).  Old files may have
    an `a` field (ignored; see types.rs:746-758)."""
    if d is None:
        return (128, 128, 128), 0
    return (int(d["r"]), int(d["g"]), int(d["b"])), _blend_code(d.get("blend"))


def _color_to_ron(rgb, blend=0):
    out = {"r": int(rgb[0]), "g": int(rgb[1]), "b": int(rgb[2])}
    if blend:
        out["blend"] = Tag(_BLEND_NAMES[blend])
    return out


def _vec2(d):
    return (float(d["x"]), float(d["y"]))


def _vec3(d):
    return np.array([d["x"], d["y"], d["z"]], F32)


def _vec3_to_ron(v):
    return {"x": F32(v[0]), "y": F32(v[1]), "z": F32(v[2])}


@dataclasses.dataclass
class TextureRef:
    """geometry.rs:22 — texture by pack + name."""

    pack: str = ""
    name: str = ""

    USER_PACK = "_USER"   # geometry.rs USER_TEXTURE_PACK

    @property
    def is_valid(self) -> bool:
        return bool(self.pack and self.name)

    @classmethod
    def user(cls, name) -> "TextureRef":
        """geometry.rs:38 — reference into textures-user/."""
        return cls(pack=cls.USER_PACK, name=str(name))

    @property
    def is_user_texture(self) -> bool:
        return self.pack == self.USER_PACK

    @classmethod
    def from_ron(cls, d):
        return cls(pack=d.get("pack", ""), name=d.get("name", ""))

    def to_ron(self):
        return {"pack": self.pack, "name": self.name}


@dataclasses.dataclass
class HorizontalFace:
    """geometry.rs:1104 — floor/ceiling quad with 4 corner heights.

    heights order [NW, NE, SE, SW]; colors are ((r,g,b), blend) tuples.
    """

    heights: List[float]
    texture: TextureRef
    split_direction: int = 0  # 0 NwSe, 1 NeSw
    uv: Optional[List[Tuple[float, float]]] = None
    colors: Optional[List] = None
    texture_2: Optional[TextureRef] = None
    uv_2: Optional[List[Tuple[float, float]]] = None
    colors_2: Optional[List] = None
    heights_2: Optional[List[float]] = None
    walkable: bool = True
    blend_mode: int = 0
    normal_mode: int = 0  # 0 Front, 1 Both, 2 Back
    black_transparent: bool = True

    def __post_init__(self):
        if self.colors is None:
            self.colors = [((128, 128, 128), 0)] * 4

    @classmethod
    def flat(cls, height, texture):
        return cls(heights=[height] * 4, texture=texture)

    def get_heights_2(self):
        return self.heights_2 if self.heights_2 is not None else self.heights

    def get_texture_2(self):
        return self.texture_2 if self.texture_2 is not None else self.texture

    def get_uv_2(self):
        return self.uv_2 if self.uv_2 is not None else self.uv

    def get_colors_2(self):
        return self.colors_2 if self.colors_2 is not None else self.colors

    def tri1_corners(self):
        return [0, 1, 2] if self.split_direction == 0 else [0, 1, 3]

    def tri2_corners(self):
        return [0, 2, 3] if self.split_direction == 0 else [1, 2, 3]

    def edge_heights(self, direction: int) -> Tuple[float, float]:
        """geometry.rs:1326 — (left, right) looking from inside."""
        h = self.heights
        return {
            NORTH: (h[0], h[1]), EAST: (h[1], h[2]), SOUTH: (h[3], h[2]),
            WEST: (h[0], h[3]), NWSE: (h[0], h[2]), NESW: (h[1], h[3]),
        }[direction]

    def avg_height(self) -> float:
        """geometry.rs:1262."""
        h = self.heights
        return (h[0] + h[1] + h[2] + h[3]) / 4.0

    def is_flat(self) -> bool:
        """geometry.rs:1267."""
        h0 = self.heights[0]
        return all(abs(h - h0) < 0.001 for h in self.heights)

    def is_uniform_slope(self) -> bool:
        """geometry.rs:1243 — flat, E-W ramp, or N-S ramp ([NW,NE,SE,SW])."""
        h = self.heights
        return ((h[0] == h[1] == h[2] == h[3])
                or (h[0] == h[1] and h[3] == h[2])
                or (h[0] == h[3] and h[1] == h[2]))

    def diagonal_matters(self) -> bool:
        """geometry.rs:1232 — the split diagonal is visually meaningful."""
        return (self.texture_2 is not None or self.heights_2 is not None
                or not self.is_uniform_slope())

    def interpolate_height(self, u: float, v: float) -> float:
        """geometry.rs:1283 — height at normalized (u, v), f32 order."""
        u = F32(min(max(u, 0.0), 1.0))
        v = F32(min(max(v, 0.0), 1.0))
        h = [F32(x) for x in self.heights]
        if self.split_direction == 0:  # NwSe
            if u >= v:
                return F32(F32(h[0] + F32(u * F32(h[1] - h[0])))
                           + F32(v * F32(h[2] - h[1])))
            return F32(F32(h[0] + F32(u * F32(h[2] - h[3])))
                       + F32(v * F32(h[3] - h[0])))
        if F32(u + v) <= 1.0:
            return F32(F32(h[0] + F32(u * F32(h[1] - h[0])))
                       + F32(v * F32(h[3] - h[0])))
        return F32(F32(h[3] + F32(u * F32(h[2] - h[3])))
                   + F32(F32(F32(1.0) - v) * F32(h[1] - h[2])))

    @classmethod
    def from_ron(cls, d):
        def colors4(lst):
            return [_color_from_ron(c) for c in lst] if lst is not None else None

        def uv4(lst):
            return [_vec2(c) for c in lst] if lst is not None else None

        return cls(
            heights=[float(h) for h in d["heights"]],
            split_direction=_enum_code(d.get("split_direction"), _SPLITS),
            texture=TextureRef.from_ron(d["texture"]),
            uv=uv4(d.get("uv")),
            colors=colors4(d.get("colors")) or None,
            texture_2=TextureRef.from_ron(d["texture_2"]) if d.get("texture_2") else None,
            uv_2=uv4(d.get("uv_2")),
            colors_2=colors4(d.get("colors_2")),
            heights_2=[float(h) for h in d["heights_2"]] if d.get("heights_2") else None,
            walkable=bool(d.get("walkable", True)),
            blend_mode=_blend_code(d.get("blend_mode")),
            normal_mode=_enum_code(d.get("normal_mode"), _NORMAL_MODES),
            black_transparent=bool(d.get("black_transparent", True)),
        )

    def to_ron(self):
        out = {
            "heights": tuple(F32(h) for h in self.heights),
            "split_direction": Tag(_SPLITS[self.split_direction]),
            "texture": self.texture.to_ron(),
            "uv": ron.wrap_some([{"x": F32(u), "y": F32(v)} for u, v in self.uv])
                if self.uv is not None else None,
            "colors": tuple(_color_to_ron(c, b) for c, b in self.colors),
            "walkable": self.walkable,
            "blend_mode": Tag(_BLEND_NAMES[self.blend_mode]),
            "normal_mode": Tag(_NORMAL_MODES[self.normal_mode]),
            "black_transparent": self.black_transparent,
        }
        if self.texture_2 is not None:
            out["texture_2"] = ron.wrap_some(self.texture_2.to_ron())
        if self.uv_2 is not None:
            out["uv_2"] = ron.wrap_some([{"x": F32(u), "y": F32(v)} for u, v in self.uv_2])
        if self.colors_2 is not None:
            out["colors_2"] = ron.wrap_some(tuple(_color_to_ron(c, b) for c, b in self.colors_2))
        if self.heights_2 is not None:
            out["heights_2"] = ron.wrap_some(tuple(F32(h) for h in self.heights_2))
        return out


@dataclasses.dataclass
class VerticalFace:
    """geometry.rs:1355 — wall quad; heights [BL, BR, TR, TL]."""

    heights: List[float]
    texture: TextureRef
    uv: Optional[List[Tuple[float, float]]] = None
    solid: bool = True
    blend_mode: int = 0
    colors: Optional[List] = None
    normal_mode: int = 0
    black_transparent: bool = True
    uv_projection: int = 0  # 0 Default, 1 Projected

    def __post_init__(self):
        if self.colors is None:
            self.colors = [((128, 128, 128), 0)] * 4

    def y_top(self) -> float:
        return (self.heights[2] + self.heights[3]) / 2.0

    def y_bottom(self) -> float:
        return (self.heights[0] + self.heights[1]) / 2.0

    @classmethod
    def from_ron(cls, d):
        return cls(
            heights=[float(h) for h in d["heights"]],
            texture=TextureRef.from_ron(d["texture"]),
            uv=[_vec2(c) for c in d["uv"]] if d.get("uv") else None,
            solid=bool(d.get("solid", True)),
            blend_mode=_blend_code(d.get("blend_mode")),
            colors=[_color_from_ron(c) for c in d["colors"]] if d.get("colors") else None,
            normal_mode=_enum_code(d.get("normal_mode"), _NORMAL_MODES),
            black_transparent=bool(d.get("black_transparent", True)),
            uv_projection=_enum_code(d.get("uv_projection"), _UV_PROJ),
        )

    def to_ron(self):
        return {
            "heights": tuple(F32(h) for h in self.heights),
            "texture": self.texture.to_ron(),
            "uv": ron.wrap_some([{"x": F32(u), "y": F32(v)} for u, v in self.uv])
                if self.uv is not None else None,
            "solid": self.solid,
            "blend_mode": Tag(_BLEND_NAMES[self.blend_mode]),
            "colors": tuple(_color_to_ron(c, b) for c, b in self.colors),
            "normal_mode": Tag(_NORMAL_MODES[self.normal_mode]),
            "black_transparent": self.black_transparent,
            "uv_projection": Tag(_UV_PROJ[self.uv_projection]),
        }


@dataclasses.dataclass
class Sector:
    """geometry.rs:1499 — floor/ceiling + wall stacks per direction."""

    floor: Optional[HorizontalFace] = None
    ceiling: Optional[HorizontalFace] = None
    walls_north: List[VerticalFace] = dataclasses.field(default_factory=list)
    walls_east: List[VerticalFace] = dataclasses.field(default_factory=list)
    walls_south: List[VerticalFace] = dataclasses.field(default_factory=list)
    walls_west: List[VerticalFace] = dataclasses.field(default_factory=list)
    walls_nwse: List[VerticalFace] = dataclasses.field(default_factory=list)
    walls_nesw: List[VerticalFace] = dataclasses.field(default_factory=list)

    def walls(self, direction: int) -> List[VerticalFace]:
        return [self.walls_north, self.walls_east, self.walls_south,
                self.walls_west, self.walls_nwse, self.walls_nesw][direction]

    def has_geometry(self) -> bool:
        return (self.floor is not None or self.ceiling is not None
                or any(self.walls(d) for d in range(6)))

    MIN_GAP = 256.0   # geometry.rs:1632 — one click = SECTOR_SIZE / 4

    @staticmethod
    def _pick_gap(gaps, mouse_y):
        """Gap selection (geometry.rs:1790-1820): nearest center to
        mouse_y, else the largest gap."""
        if not gaps:
            return None
        if mouse_y is not None:
            best = min(gaps, key=lambda g: abs(mouse_y - (g[1] + g[2]) / 2.0))
        else:
            best = max(gaps, key=lambda g: g[2] - g[1])
        return best[0]

    @classmethod
    def _stack_gaps(cls, sorted_walls, f1, f2, c1, c2):
        """Gaps around/between a sorted wall stack, with per-corner
        triangular collapse (geometry.rs:1706-1790 / :1890-1960).
        f1/f2 = floor heights at the (left, right) corners; c1/c2 ceiling.
        Returns [(heights[4], avg_bottom, avg_top), ...]."""
        gaps = []
        lowest = sorted_walls[0]
        g1 = lowest.heights[0] - f1
        g2 = lowest.heights[1] - f2
        if max(g1, g2) > cls.MIN_GAP:
            bl, tl = (f1, lowest.heights[0]) if g1 > cls.MIN_GAP else (f1, f1)
            br, tr = (f2, lowest.heights[1]) if g2 > cls.MIN_GAP else (f2, f2)
            gaps.append(([bl, br, tr, tl], (bl + br) / 2.0, (tl + tr) / 2.0))
        for lower, upper in zip(sorted_walls, sorted_walls[1:]):
            g1 = upper.heights[0] - lower.heights[3]
            g2 = upper.heights[1] - lower.heights[2]
            if max(g1, g2) > cls.MIN_GAP:
                gaps.append((
                    [lower.heights[3], lower.heights[2],
                     upper.heights[1], upper.heights[0]],
                    (lower.heights[2] + lower.heights[3]) / 2.0,
                    (upper.heights[0] + upper.heights[1]) / 2.0))
        highest = sorted_walls[-1]
        g1 = c1 - highest.heights[3]
        g2 = c2 - highest.heights[2]
        if max(g1, g2) > cls.MIN_GAP:
            bl, tl = ((highest.heights[3], c1) if g1 > cls.MIN_GAP
                      else (c1, c1))
            br, tr = ((highest.heights[2], c2) if g2 > cls.MIN_GAP
                      else (c2, c2))
            gaps.append(([bl, br, tr, tl], (bl + br) / 2.0, (tl + tr) / 2.0))
        return gaps

    def _gap_position(self, walls, f1, f2, c1, c2, mouse_y):
        """Shared body of next_wall_position / next_diagonal_wall_position
        once the corner floor/ceiling heights are known.  Wall heights are
        [bot1, bot2, top2, top1]."""
        if len(walls) >= 3:      # max 3 walls per edge (geometry.rs:1658)
            return None
        if not walls:
            # sloped floor/ceiling offers triangular gaps by mouse side
            if (abs(f1 - f2) > self.MIN_GAP or abs(c1 - c2) > self.MIN_GAP):
                floor_max = max(f1, f2)
                mid = (floor_max + min(c1, c2)) / 2.0
                if mouse_y is not None:
                    if mouse_y < mid:
                        return [f1, f2, floor_max, floor_max]
                    return [floor_max, floor_max, c2, c1]
            return [f1, f2, c2, c1]
        sw = sorted(walls,
                    key=lambda w: (w.heights[0] + w.heights[1]) / 2.0)
        return self._pick_gap(self._stack_gaps(sw, f1, f2, c1, c2), mouse_y)

    def next_wall_position(self, direction: int, fallback_bottom: float,
                           fallback_top: float, mouse_y=None):
        """geometry.rs:1630 — heights [BL, BR, TR, TL] for the next wall on
        an edge, gap-detected against the existing stack, or None.

        edge_heights is (left, right) from INSIDE; wall corners face
        outward, so sector-left is wall-right (geometry.rs:1636-1642).
        Room bounds are absolute limits: floor clamps DOWN to the room
        bottom, ceiling UP to the room top (geometry.rs:1639-1653)."""
        if self.floor is not None:
            el, er = self.floor.edge_heights(direction)
            floor_right, floor_left = (min(el, fallback_bottom),
                                       min(er, fallback_bottom))
        else:
            floor_right = floor_left = fallback_bottom
        if self.ceiling is not None:
            el, er = self.ceiling.edge_heights(direction)
            ceiling_right, ceiling_left = (max(el, fallback_top),
                                           max(er, fallback_top))
        else:
            ceiling_right = ceiling_left = fallback_top
        return self._gap_position(self.walls(direction), floor_left,
                                  floor_right, ceiling_left, ceiling_right,
                                  mouse_y)

    def extrude_floor(self, amount: float, wall_texture) -> bool:
        """geometry.rs:1986 — raise the floor by `amount` and connect the
        perimeter: existing edge walls get their bottoms raised to the new
        floor, otherwise a new Back-facing wall spans old->new heights."""
        if self.floor is None:
            return False
        old = list(self.floor.heights)
        self.floor.heights = [h + amount for h in old]
        new = self.floor.heights
        # per edge: (stack, bottom corner idx pair (BL, BR), top pair)
        edges = [
            (self.walls_north, (0, 1)),   # BL=NW, BR=NE
            (self.walls_east, (1, 2)),    # BL=NE, BR=SE
            (self.walls_south, (2, 3)),   # BL=SE, BR=SW
            (self.walls_west, (3, 0)),    # BL=SW, BR=NW
        ]
        for stack, (bl, br) in edges:
            if stack:
                stack[-1].heights[0] = new[bl]
                stack[-1].heights[1] = new[br]
            else:
                wall = VerticalFace(
                    heights=[old[bl], old[br], new[br], new[bl]],
                    texture=wall_texture)
                wall.normal_mode = 2    # FaceNormalMode::Back
                stack.append(wall)
        return True

    def next_diagonal_wall_position(self, is_nwse: bool,
                                    fallback_bottom: float,
                                    fallback_top: float, mouse_y=None):
        """geometry.rs:1823 — like next_wall_position for the NwSe/NeSw
        diagonal; corners are (NW, SE) or (NE, SW), heights returned as
        [c1_bot, c2_bot, c2_top, c1_top]."""
        i1, i2 = (0, 2) if is_nwse else (1, 3)
        f1 = self.floor.heights[i1] if self.floor else fallback_bottom
        f2 = self.floor.heights[i2] if self.floor else fallback_bottom
        c1 = self.ceiling.heights[i1] if self.ceiling else fallback_top
        c2 = self.ceiling.heights[i2] if self.ceiling else fallback_top
        walls = self.walls_nwse if is_nwse else self.walls_nesw
        return self._gap_position(walls, f1, f2, c1, c2, mouse_y)

    @classmethod
    def from_ron(cls, d):
        def walls(key):
            return [VerticalFace.from_ron(w) for w in d.get(key, [])]

        return cls(
            floor=HorizontalFace.from_ron(d["floor"]) if d.get("floor") else None,
            ceiling=HorizontalFace.from_ron(d["ceiling"]) if d.get("ceiling") else None,
            walls_north=walls("walls_north"),
            walls_east=walls("walls_east"),
            walls_south=walls("walls_south"),
            walls_west=walls("walls_west"),
            walls_nwse=walls("walls_nwse"),
            walls_nesw=walls("walls_nesw"),
        )

    def to_ron(self):
        return {
            "floor": ron.wrap_some(self.floor.to_ron()) if self.floor else None,
            "ceiling": ron.wrap_some(self.ceiling.to_ron()) if self.ceiling else None,
            "walls_north": [w.to_ron() for w in self.walls_north],
            "walls_east": [w.to_ron() for w in self.walls_east],
            "walls_south": [w.to_ron() for w in self.walls_south],
            "walls_west": [w.to_ron() for w in self.walls_west],
            "walls_nwse": [w.to_ron() for w in self.walls_nwse],
            "walls_nesw": [w.to_ron() for w in self.walls_nesw],
        }


@dataclasses.dataclass
class Portal:
    """geometry.rs:2369."""

    target_room: int
    vertices: np.ndarray  # (4, 3) f32, room-relative
    normal: np.ndarray    # (3,) f32

    @classmethod
    def from_ron(cls, d):
        return cls(target_room=int(d["target_room"]),
                   vertices=np.stack([_vec3(v) for v in d["vertices"]]),
                   normal=_vec3(d["normal"]))

    def to_ron(self):
        return {"target_room": self.target_room,
                "vertices": tuple(_vec3_to_ron(v) for v in self.vertices),
                "normal": _vec3_to_ron(self.normal)}


@dataclasses.dataclass
class RoomFog:
    """geometry.rs:2403."""

    enabled: bool = False
    color: Tuple[float, float, float] = (0.02, 0.02, 0.02)
    start: float = 8192.0
    falloff: float = 30000.0
    cull_offset: float = 9000.0

    @classmethod
    def from_ron(cls, d):
        if d is None:
            return cls()
        c = d.get("color", (0.02, 0.02, 0.02))
        falloff = d.get("falloff", d.get("end", 30000.0))
        return cls(enabled=bool(d.get("enabled", False)),
                   color=(float(c[0]), float(c[1]), float(c[2])),
                   start=float(d.get("start", 8192.0)),
                   falloff=float(falloff),
                   cull_offset=float(d.get("cull_offset", 0.0)))

    def to_ron(self):
        return {"enabled": self.enabled,
                "color": tuple(F32(c) for c in self.color),
                "start": F32(self.start), "falloff": F32(self.falloff),
                "cull_offset": F32(self.cull_offset)}


@dataclasses.dataclass
class LightOverride:
    color: Optional[Tuple[int, int, int]] = None
    intensity: Optional[float] = None
    radius: Optional[float] = None
    offset: Optional[Tuple[float, float, float]] = None

    @classmethod
    def from_ron(cls, d):
        if d is None:
            return None
        return cls(
            color=tuple(int(c) for c in d["color"]) if d.get("color") else None,
            intensity=float(d["intensity"]) if d.get("intensity") is not None else None,
            radius=float(d["radius"]) if d.get("radius") is not None else None,
            offset=tuple(float(c) for c in d["offset"]) if d.get("offset") else None,
        )


@dataclasses.dataclass
class AssetInstance:
    """geometry.rs:2289."""

    sector_x: int
    sector_z: int
    asset_id: int
    height: float = 0.0
    facing: float = 0.0
    name: str = ""
    enabled: bool = True
    light_override: Optional[LightOverride] = None

    def world_position(self, room: "Room") -> np.ndarray:
        """geometry.rs:2353 — sector center at floor height."""
        base_x = F32(room.position[0] + F32(F32(self.sector_x) * SECTOR_SIZE)
                     + F32(SECTOR_SIZE * F32(0.5)))
        base_z = F32(room.position[2] + F32(F32(self.sector_z) * SECTOR_SIZE)
                     + F32(SECTOR_SIZE * F32(0.5)))
        sector = room.get_sector(self.sector_x, self.sector_z)
        if sector is not None and sector.floor is not None:
            h = sector.floor.heights
            base_y = F32(F32(F32(F32(F32(h[0]) + F32(h[1])) + F32(h[2])) + F32(h[3])) / F32(4.0))
        else:
            base_y = F32(room.position[1])
        return np.array([base_x, F32(base_y + F32(self.height)), base_z], F32)

    @classmethod
    def from_ron(cls, d):
        ov = d.get("overrides") or {}
        return cls(
            sector_x=int(d["sector_x"]), sector_z=int(d["sector_z"]),
            asset_id=int(d.get("asset_id", 0)),
            height=float(d.get("height", 0.0)),
            facing=float(d.get("facing", 0.0)),
            name=d.get("name", ""),
            enabled=bool(d.get("enabled", True)),
            light_override=LightOverride.from_ron(ov.get("light")),
        )

    def to_ron(self):
        return {"sector_x": self.sector_x, "sector_z": self.sector_z,
                "height": F32(self.height), "facing": F32(self.facing),
                "asset_id": self.asset_id, "name": self.name,
                "enabled": self.enabled}


@dataclasses.dataclass
class Room:
    """geometry.rs:2437."""

    id: int
    position: np.ndarray  # (3,) f32
    width: int
    depth: int
    sectors: List[List[Optional[Sector]]]  # [x][z]
    portals: List[Portal] = dataclasses.field(default_factory=list)
    ambient: float = 0.5
    objects: List[AssetInstance] = dataclasses.field(default_factory=list)
    fog: RoomFog = dataclasses.field(default_factory=RoomFog)
    bounds_min: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, F32))
    bounds_max: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, F32))

    @classmethod
    def new(cls, id, position, width, depth):
        return cls(id=id, position=np.asarray(position, F32), width=width,
                   depth=depth,
                   sectors=[[None] * depth for _ in range(width)])

    def get_sector(self, x: int, z: int) -> Optional[Sector]:
        if 0 <= x < self.width and 0 <= z < self.depth:
            return self.sectors[x][z]
        return None

    def ensure_sector(self, x: int, z: int) -> Sector:
        if self.sectors[x][z] is None:
            self.sectors[x][z] = Sector()
        return self.sectors[x][z]

    def set_floor(self, x, z, height, texture):
        self.ensure_sector(x, z).floor = HorizontalFace.flat(height, texture)

    def set_ceiling(self, x, z, height, texture):
        self.ensure_sector(x, z).ceiling = HorizontalFace.flat(height, texture)

    def add_wall(self, x, z, direction, y_bottom, y_top, texture):
        self.ensure_sector(x, z).walls(direction).append(
            VerticalFace(heights=[y_bottom, y_bottom, y_top, y_top],
                         texture=texture))

    def add_wall_heights(self, x, z, direction, heights, texture):
        """Place a wall with explicit per-corner heights (the gap-detected
        result of Sector.next_wall_position)."""
        self.ensure_sector(x, z).walls(direction).append(
            VerticalFace(heights=list(heights), texture=texture))

    def effective_height_bounds(self) -> Tuple[float, float]:
        """geometry.rs:2580 — room vertical span for wall gap detection;
        degenerate rooms fall back to a default ceiling above the floor."""
        min_gap = 256.0
        default_ceiling = 3072.0
        bottom = float(self.bounds_min[1])
        top = float(self.bounds_max[1])
        if top - bottom < min_gap:
            top = bottom + default_ceiling
        return bottom, top

    def iter_sectors(self):
        for x in range(self.width):
            for z in range(self.depth):
                s = self.sectors[x][z]
                if s is not None:
                    yield x, z, s

    def cleanup_empty_sectors(self):
        """geometry.rs:2675 — drop sectors whose geometry is all gone."""
        for x in range(self.width):
            for z in range(self.depth):
                s = self.sectors[x][z]
                if s is not None and not s.has_geometry():
                    self.sectors[x][z] = None

    def trim_empty_edges(self) -> Tuple[int, int]:
        """geometry.rs:2700 — trim empty border rows/columns, shifting the
        room position (and object cells) to keep world positions fixed.
        Returns (trim_x, trim_z) removed from the start."""
        if not self.sectors or self.width == 0 or self.depth == 0:
            return (0, 0)
        first_col = 0
        while first_col < self.width and not any(
                self.sectors[first_col][z] is not None
                for z in range(self.depth)):
            first_col += 1
        last_col = self.width
        while last_col > first_col and not any(
                self.sectors[last_col - 1][z] is not None
                for z in range(self.depth)):
            last_col -= 1
        first_row = 0
        while first_row < self.depth and not any(
                self.sectors[x][first_row] is not None
                for x in range(first_col, last_col)):
            first_row += 1
        last_row = self.depth
        while last_row > first_row and not any(
                self.sectors[x][last_row - 1] is not None
                for x in range(first_col, last_col)):
            last_row -= 1
        if first_col >= last_col or first_row >= last_row:
            self.width = 1
            self.depth = 1
            self.sectors = [[None]]
            return (0, 0)
        if (first_col, first_row) == (0, 0) and last_col == self.width \
                and last_row == self.depth:
            return (0, 0)
        self.position = self.position.copy()
        self.position[0] += F32(first_col) * SECTOR_SIZE
        self.position[2] += F32(first_row) * SECTOR_SIZE
        kept = []
        for obj in self.objects:
            if (first_col <= obj.sector_x < last_col
                    and first_row <= obj.sector_z < last_row):
                obj.sector_x -= first_col
                obj.sector_z -= first_row
                kept.append(obj)
        self.objects = kept
        self.sectors = [[self.sectors[x][z]
                         for z in range(first_row, last_row)]
                        for x in range(first_col, last_col)]
        self.width = last_col - first_col
        self.depth = last_row - first_row
        return (first_col, first_row)

    def compact(self) -> Tuple[int, int]:
        """geometry.rs:2690 — cleanup + trim + bounds after edits."""
        self.cleanup_empty_sectors()
        off = self.trim_empty_edges()
        self.recalculate_bounds()
        return off

    def recalculate_bounds(self):
        """geometry.rs:2594 — room-relative AABB over all face corners."""
        mn = np.array([np.inf, np.inf, np.inf], F32)
        mx = np.array([-np.inf, -np.inf, -np.inf], F32)

        def expand(x, y, z):
            mn[0] = min(mn[0], x); mn[1] = min(mn[1], y); mn[2] = min(mn[2], z)
            mx[0] = max(mx[0], x); mx[1] = max(mx[1], y); mx[2] = max(mx[2], z)

        corner_off = [(0.0, 0.0), (float(SECTOR_SIZE), 0.0),
                      (float(SECTOR_SIZE), float(SECTOR_SIZE)),
                      (0.0, float(SECTOR_SIZE))]
        for x, z, sector in self.iter_sectors():
            bx = x * float(SECTOR_SIZE)
            bz = z * float(SECTOR_SIZE)
            for face in (sector.floor, sector.ceiling):
                if face is not None:
                    for i, h in enumerate(face.heights):
                        dx, dz = corner_off[i]
                        expand(bx + dx, h, bz + dz)
            for w in sector.walls_north:
                for h in w.heights:
                    expand(bx, h, bz)
            for w in sector.walls_east:
                for h in w.heights:
                    expand(bx + float(SECTOR_SIZE), h, bz)
            for w in sector.walls_south:
                for h in w.heights:
                    expand(bx, h, bz + float(SECTOR_SIZE))
            for w in sector.walls_west:
                for h in w.heights:
                    expand(bx, h, bz)
            for w in sector.walls_nwse:
                for h in w.heights:
                    expand(bx, h, bz)
                    expand(bx + float(SECTOR_SIZE), h, bz + float(SECTOR_SIZE))
            for w in sector.walls_nesw:
                for h in w.heights:
                    expand(bx + float(SECTOR_SIZE), h, bz)
                    expand(bx, h, bz + float(SECTOR_SIZE))
        self.bounds_min = mn.astype(F32)
        self.bounds_max = mx.astype(F32)

    def contains_point(self, point) -> bool:
        rel = np.asarray(point, F32) - self.position
        return bool(np.all(rel >= self.bounds_min) and np.all(rel <= self.bounds_max))

    # ------------------------------------------------------------------
    # Mesh emission (geometry.rs:2839-3352)
    # ------------------------------------------------------------------

    def to_render_data(self, resolve_texture: Callable[[TextureRef], Optional[Tuple[int, int]]]):
        """Emit (vertices, faces) in golden-model format: world-space f32
        positions/uvs/normals/colors, exact reference op order."""
        em = _Emitter(self, resolve_texture)
        for gx, gz, sector in self.iter_sectors():
            base_x = F32(self.position[0] + F32(F32(gx) * SECTOR_SIZE))
            base_z = F32(self.position[2] + F32(F32(gz) * SECTOR_SIZE))
            if sector.floor is not None:
                em.horizontal(sector.floor, base_x, base_z, gx, gz, True)
            if sector.ceiling is not None:
                em.horizontal(sector.ceiling, base_x, base_z, gx, gz, False)
            for w in sector.walls_north:
                em.wall(w, base_x, base_z, gx, gz, NORTH)
            for w in sector.walls_east:
                em.wall(w, base_x, base_z, gx, gz, EAST)
            for w in sector.walls_south:
                em.wall(w, base_x, base_z, gx, gz, SOUTH)
            for w in sector.walls_west:
                em.wall(w, base_x, base_z, gx, gz, WEST)
            for w in sector.walls_nwse:
                em.diagonal(w, base_x, base_z, gx, gz, True)
            for w in sector.walls_nesw:
                em.diagonal(w, base_x, base_z, gx, gz, False)
        return em.vertices, em.faces

    @classmethod
    def from_ron(cls, d):
        sectors = []
        for col in d["sectors"]:
            sectors.append([Sector.from_ron(s) if s is not None else None
                            for s in col])
        room = cls(
            id=int(d["id"]),
            position=_vec3(d["position"]),
            width=int(d["width"]),
            depth=int(d["depth"]),
            sectors=sectors,
            portals=[Portal.from_ron(p) for p in d.get("portals", [])],
            ambient=float(d.get("ambient", 0.5)),
            objects=[AssetInstance.from_ron(o) for o in d.get("objects", [])],
            fog=RoomFog.from_ron(d.get("fog")),
        )
        return room

    def to_ron(self):
        return {
            "id": self.id,
            "position": _vec3_to_ron(self.position),
            "width": self.width,
            "depth": self.depth,
            "sectors": [[ron.wrap_some(s.to_ron()) if s is not None else None
                         for s in col] for col in self.sectors],
            "portals": [p.to_ron() for p in self.portals],
            "ambient": F32(self.ambient),
            "objects": [o.to_ron() for o in self.objects],
            "fog": self.fog.to_ron(),
        }


def _normalize3(v):
    l = F32(np.sqrt(F32(F32(F32(v[0] * v[0]) + F32(v[1] * v[1])) + F32(v[2] * v[2]))))
    if l == 0:
        return np.zeros(3, F32)
    return (v / l).astype(F32)


def _cross(a, b):
    return np.array([
        F32(a[1] * b[2]) - F32(a[2] * b[1]),
        F32(a[2] * b[0]) - F32(a[0] * b[2]),
        F32(a[0] * b[1]) - F32(a[1] * b[0])], F32)


class _Emitter:
    """Vertex/face emission helper mirroring geometry.rs:2905-3352."""

    def __init__(self, room: Room, resolve_texture):
        self.room = room
        self.resolve = resolve_texture
        self.vertices: List[dict] = []
        self.faces: List[dict] = []

    def _push_tri(self, corners, idxs, uvs, colors, normal, tex_id, flip,
                  black_transparent, blend_mode):
        base = len(self.vertices)
        for ci in idxs:
            rgb, cblend = colors[ci]
            self.vertices.append(dict(
                pos=tuple(float(x) for x in corners[ci]),
                uv=(float(uvs[ci][0]), float(uvs[ci][1])),
                normal=tuple(float(x) for x in normal),
                color=rgb, color_blend=cblend))
        order = (0, 2, 1) if flip else (0, 1, 2)
        self.faces.append(dict(
            v0=base + order[0], v1=base + order[1], v2=base + order[2],
            tex_id=tex_id, black_transparent=black_transparent,
            blend_mode=blend_mode, editor_alpha=255))

    def horizontal(self, face: HorizontalFace, base_x, base_z, gx, gz, is_floor):
        """geometry.rs:2906-3048."""
        room_y = F32(self.room.position[1])
        s = SECTOR_SIZE

        def corners_of(heights):
            return [
                np.array([base_x, F32(room_y + F32(heights[0])), base_z], F32),
                np.array([F32(base_x + s), F32(room_y + F32(heights[1])), base_z], F32),
                np.array([F32(base_x + s), F32(room_y + F32(heights[2])), F32(base_z + s)], F32),
                np.array([base_x, F32(room_y + F32(heights[3])), F32(base_z + s)], F32),
            ]

        corners_1 = corners_of(face.heights)
        corners_2 = corners_of(face.get_heights_2())

        tid1, tw1 = self.resolve(face.texture) or (0, 64)
        tid2, tw2 = self.resolve(face.get_texture_2()) or (0, 64)
        uv_scale_1 = F32(F32(32.0) / F32(tw1))
        uv_scale_2 = F32(F32(32.0) / F32(tw2))

        if face.uv is not None:
            uvs_1 = [(F32(u), F32(v)) for u, v in face.uv]
        else:
            uo = F32(F32(gx) * uv_scale_1)
            vo = F32(F32(gz) * uv_scale_1)
            uvs_1 = [(uo, vo), (F32(uo + uv_scale_1), vo),
                     (F32(uo + uv_scale_1), F32(vo + uv_scale_1)),
                     (uo, F32(vo + uv_scale_1))]
        uv2 = face.get_uv_2()
        if uv2 is not None:
            uvs_2 = [(F32(u), F32(v)) for u, v in uv2]
        elif tw1 == tw2:
            uvs_2 = uvs_1
        else:
            uo = F32(F32(gx) * uv_scale_2)
            vo = F32(F32(gz) * uv_scale_2)
            uvs_2 = [(uo, vo), (F32(uo + uv_scale_2), vo),
                     (F32(uo + uv_scale_2), F32(vo + uv_scale_2)),
                     (uo, F32(vo + uv_scale_2))]

        colors_1 = face.colors
        colors_2 = face.get_colors_2()

        render_front = face.normal_mode != 2
        render_back = face.normal_mode != 0

        t1 = face.tri1_corners()
        t2 = face.tri2_corners()

        def normal_of(corners):
            e1 = (corners[1] - corners[0]).astype(F32)
            e2 = (corners[3] - corners[0]).astype(F32)
            if is_floor:
                return _normalize3(_cross(e2, e1))
            return _normalize3(_cross(e1, e2))

        fn1 = normal_of(corners_1)
        bn1 = (-fn1).astype(F32)
        fn2 = normal_of(corners_2)
        bn2 = (-fn2).astype(F32)

        if render_front:
            self._push_tri(corners_1, t1, uvs_1, colors_1, fn1, tid1,
                           not is_floor, face.black_transparent, face.blend_mode)
        if render_back:
            self._push_tri(corners_1, t1, uvs_1, colors_1, bn1, tid1,
                           is_floor, face.black_transparent, face.blend_mode)
        if render_front:
            self._push_tri(corners_2, t2, uvs_2, colors_2, fn2, tid2,
                           not is_floor, face.black_transparent, face.blend_mode)
        if render_back:
            self._push_tri(corners_2, t2, uvs_2, colors_2, bn2, tid2,
                           is_floor, face.black_transparent, face.blend_mode)

    def _wall_quad(self, wall, corners, front_normal, gx_or_gz):
        """Shared UV + quad emission (geometry.rs:3142-3230)."""
        tid, tw = self.resolve(wall.texture) or (0, 64)
        uv_scale = F32(F32(32.0) / F32(tw))
        u_left = F32(F32(gx_or_gz) * uv_scale)
        u_right = F32(u_left + uv_scale)
        corner_u = [u_left, u_right, u_right, u_left]

        room_y = F32(self.room.position[1])
        if wall.uv_projection == 1:  # Projected
            if wall.uv is not None:
                base_u = [F32(u) for u, _ in wall.uv]
            else:
                base_u = corner_u
            uvs = []
            for i in range(4):
                wh = F32(room_y + F32(wall.heights[i]))
                v = F32(F32(F32(-wh) / SECTOR_SIZE) * uv_scale)
                uvs.append((base_u[i], v))
        elif wall.uv is not None:
            uvs = [(F32(u), F32(v)) for u, v in wall.uv]
        else:
            uvs = [(corner_u[0], uv_scale), (corner_u[1], uv_scale),
                   (corner_u[2], F32(0.0)), (corner_u[3], F32(0.0))]

        render_front = wall.normal_mode != 2
        render_back = wall.normal_mode != 0

        def push_quad(normal):
            base = len(self.vertices)
            for i in range(4):
                rgb, cblend = wall.colors[i]
                self.vertices.append(dict(
                    pos=tuple(float(x) for x in corners[i]),
                    uv=(float(uvs[i][0]), float(uvs[i][1])),
                    normal=tuple(float(x) for x in normal),
                    color=rgb, color_blend=cblend))
            return base

        # Front: (0,2,1), (0,3,2); back: reversed (geometry.rs:3216-3229).
        if render_front:
            base = push_quad(front_normal)
            for a, b, c in ((0, 2, 1), (0, 3, 2)):
                self.faces.append(dict(
                    v0=base + a, v1=base + b, v2=base + c, tex_id=tid,
                    black_transparent=wall.black_transparent,
                    blend_mode=wall.blend_mode, editor_alpha=255))
        if render_back:
            back_normal = (-np.asarray(front_normal)).astype(F32)
            base = push_quad(back_normal)
            for a, b, c in ((0, 1, 2), (0, 2, 3)):
                self.faces.append(dict(
                    v0=base + a, v1=base + b, v2=base + c, tex_id=tid,
                    black_transparent=wall.black_transparent,
                    blend_mode=wall.blend_mode, editor_alpha=255))

    def wall(self, wall: VerticalFace, base_x, base_z, gx, gz, direction):
        """geometry.rs:3051-3231."""
        y = F32(self.room.position[1])
        s = SECTOR_SIZE
        h = [F32(y + F32(hh)) for hh in wall.heights]
        if direction == NORTH:
            corners = [np.array([base_x, h[0], base_z], F32),
                       np.array([F32(base_x + s), h[1], base_z], F32),
                       np.array([F32(base_x + s), h[2], base_z], F32),
                       np.array([base_x, h[3], base_z], F32)]
            normal = np.array([0.0, 0.0, 1.0], F32)
            gcoord = gx
        elif direction == EAST:
            corners = [np.array([F32(base_x + s), h[0], base_z], F32),
                       np.array([F32(base_x + s), h[1], F32(base_z + s)], F32),
                       np.array([F32(base_x + s), h[2], F32(base_z + s)], F32),
                       np.array([F32(base_x + s), h[3], base_z], F32)]
            normal = np.array([-1.0, 0.0, 0.0], F32)
            gcoord = gz
        elif direction == SOUTH:
            corners = [np.array([F32(base_x + s), h[0], F32(base_z + s)], F32),
                       np.array([base_x, h[1], F32(base_z + s)], F32),
                       np.array([base_x, h[2], F32(base_z + s)], F32),
                       np.array([F32(base_x + s), h[3], F32(base_z + s)], F32)]
            normal = np.array([0.0, 0.0, -1.0], F32)
            gcoord = gx
        else:  # WEST
            corners = [np.array([base_x, h[0], F32(base_z + s)], F32),
                       np.array([base_x, h[1], base_z], F32),
                       np.array([base_x, h[2], base_z], F32),
                       np.array([base_x, h[3], F32(base_z + s)], F32)]
            normal = np.array([1.0, 0.0, 0.0], F32)
            gcoord = gz
        self._wall_quad(wall, corners, normal, gcoord)

    def diagonal(self, wall: VerticalFace, base_x, base_z, gx, gz, is_nwse):
        """geometry.rs:3235-3352."""
        y = F32(self.room.position[1])
        s = SECTOR_SIZE
        h = [F32(y + F32(hh)) for hh in wall.heights]
        n = F32(F32(1.0) / F32(np.sqrt(F32(2.0))))
        if is_nwse:
            corners = [np.array([F32(base_x + s), h[1], F32(base_z + s)], F32),
                       np.array([base_x, h[0], base_z], F32),
                       np.array([base_x, h[3], base_z], F32),
                       np.array([F32(base_x + s), h[2], F32(base_z + s)], F32)]
            normal = np.array([n, 0.0, -n], F32)
        else:
            corners = [np.array([base_x, h[1], F32(base_z + s)], F32),
                       np.array([F32(base_x + s), h[0], base_z], F32),
                       np.array([F32(base_x + s), h[3], base_z], F32),
                       np.array([base_x, h[2], F32(base_z + s)], F32)]
            normal = np.array([n, 0.0, n], F32)
        # NOTE: diagonal wall UV mapping uses heights in WALL order for
        # projected V, but corner order differs — handled in _wall_quad via
        # wall.heights directly (geometry.rs:3303-3315).
        self._wall_quad(wall, corners, normal, gx)


# =============================================================================
# Level
# =============================================================================


@dataclasses.dataclass
class PlayerSettings:
    """geometry.rs:2177 with defaults from :2206-2224."""

    radius: float = 300.0
    height: float = 1800.0
    step_height: float = 384.0
    walk_speed: float = 3000.0
    run_speed: float = 5000.0
    gravity: float = 2400.0
    jump_velocity: float = 1200.0
    sprint_jump_multiplier: float = 1.15
    camera_distance: float = 6000.0
    camera_vertical_offset: float = 2000.0
    camera_pitch_min: float = -0.8
    camera_pitch_max: float = 0.8
    camera_height: float = 610.0

    @classmethod
    def from_ron(cls, d):
        if d is None:
            return cls()
        out = cls()
        for f in dataclasses.fields(cls):
            if f.name in d:
                setattr(out, f.name, float(d[f.name]))
        return out

    def to_ron(self):
        return {f.name: F32(getattr(self, f.name))
                for f in dataclasses.fields(self)}


@dataclasses.dataclass
class FloorInfo:
    room: int
    floor: float
    ceiling: float
    sector_x: int
    sector_z: int


@dataclasses.dataclass
class Level:
    """geometry.rs:3443."""

    rooms: List[Room] = dataclasses.field(default_factory=list)
    player_settings: PlayerSettings = dataclasses.field(default_factory=PlayerSettings)
    skybox: Optional[dict] = None        # raw RON dict (models/skybox.py parses)
    editor_layout: Optional[dict] = None  # opaque editor state, round-tripped

    def add_room(self, room: Room) -> int:
        self.rooms.append(room)
        return len(self.rooms) - 1

    # ------------------------------------------------------------------
    # Placed-object CRUD (geometry.rs:3489-3556)
    # ------------------------------------------------------------------

    def add_object(self, room_idx: int, obj: "AssetInstance"
                   ) -> Optional[int]:
        """geometry.rs:3489 — append; returns the new object index."""
        if not 0 <= room_idx < len(self.rooms):
            return None
        self.rooms[room_idx].objects.append(obj)
        return len(self.rooms[room_idx].objects) - 1

    def get_object(self, room_idx: int, index: int
                   ) -> Optional["AssetInstance"]:
        """geometry.rs:3512."""
        if 0 <= room_idx < len(self.rooms):
            objs = self.rooms[room_idx].objects
            if 0 <= index < len(objs):
                return objs[index]
        return None

    def remove_object(self, room_idx: int, index: int
                      ) -> Optional["AssetInstance"]:
        """geometry.rs:3532 — remove and return, or None."""
        if 0 <= room_idx < len(self.rooms):
            objs = self.rooms[room_idx].objects
            if 0 <= index < len(objs):
                return objs.pop(index)
        return None

    def find_room_at(self, point, hint: Optional[int] = None) -> Optional[int]:
        """geometry.rs:3566-3588."""
        if hint is not None and 0 <= hint < len(self.rooms):
            if self.rooms[hint].contains_point(point):
                return hint
        for i, room in enumerate(self.rooms):
            if room.contains_point(point):
                return i
        return None

    def get_floor_info(self, point, room_hint=None) -> Optional[FloorInfo]:
        """geometry.rs:3597-3643, f32 op order."""
        room_idx = self.find_room_at(point, room_hint)
        if room_idx is None:
            return None
        room = self.rooms[room_idx]
        local_x = F32(F32(point[0]) - F32(room.position[0]))
        local_z = F32(F32(point[2]) - F32(room.position[2]))
        sector_x = math.floor(float(F32(local_x / SECTOR_SIZE)))
        sector_z = math.floor(float(F32(local_z / SECTOR_SIZE)))
        if sector_x < 0 or sector_z < 0:
            return None
        sector = room.get_sector(sector_x, sector_z)
        if sector is None:
            return None
        sbx = F32(F32(sector_x) * SECTOR_SIZE)
        sbz = F32(F32(sector_z) * SECTOR_SIZE)
        u = F32(F32(local_x - sbx) / SECTOR_SIZE)
        v = F32(F32(local_z - sbz) / SECTOR_SIZE)
        room_y = F32(room.position[1])
        if sector.floor is not None:
            floor_y = F32(room_y + sector.floor.interpolate_height(u, v))
        else:
            floor_y = room_y
        if sector.ceiling is not None:
            ceiling_y = F32(room_y + sector.ceiling.interpolate_height(u, v))
        else:
            ceiling_y = F32(room_y + F32(2048.0))
        return FloorInfo(room=room_idx, floor=float(floor_y),
                         ceiling=float(ceiling_y),
                         sector_x=sector_x, sector_z=sector_z)

    # ------------------------------------------------------------------
    # Portals (geometry.rs:3655-3990)
    # ------------------------------------------------------------------

    def recalculate_portals(self):
        for room in self.rooms:
            room.portals = []
        n = len(self.rooms)
        for a in range(n):
            for b in range(a + 1, n):
                self._detect_portals_between(a, b)

    def _detect_portals_between(self, ai: int, bi: int):
        ra, rb = self.rooms[ai], self.rooms[bi]
        pos_a, pos_b = ra.position, rb.position
        s = float(SECTOR_SIZE)

        for d in (NORTH, EAST, SOUTH, WEST):
            for gx_a in range(ra.width):
                for gz_a in range(ra.depth):
                    wx = float(pos_a[0]) + gx_a * s
                    wz = float(pos_a[2]) + gz_a * s
                    off = {NORTH: (0, -s), EAST: (s, 0), SOUTH: (0, s),
                           WEST: (-s, 0)}[d]
                    ax, az = wx + off[0], wz + off[1]
                    lx, lz = ax - float(pos_b[0]), az - float(pos_b[2])
                    if lx < 0 or lz < 0:
                        continue
                    if abs(lx % s) > 0.1 or abs(lz % s) > 0.1:
                        continue
                    gx_b, gz_b = int(lx / s), int(lz / s)
                    if gx_b >= rb.width or gz_b >= rb.depth:
                        continue
                    sa = ra.get_sector(gx_a, gz_a)
                    sb = rb.get_sector(gx_b, gz_b)
                    if sa is None or sb is None:
                        continue
                    od = {NORTH: SOUTH, EAST: WEST, SOUTH: NORTH, WEST: EAST}[d]
                    if sa.walls(d) or sb.walls(od):
                        continue
                    if (sa.floor is None or sa.ceiling is None
                            or sb.floor is None or sb.ceiling is None):
                        continue

                    fal, far_ = sa.floor.edge_heights(d)
                    fbl, fbr = sb.floor.edge_heights(od)
                    cal, car = sa.ceiling.edge_heights(d)
                    cbl, cbr = sb.ceiling.edge_heights(od)
                    fal += float(pos_a[1]); far_ += float(pos_a[1])
                    cal += float(pos_a[1]); car += float(pos_a[1])
                    fbl += float(pos_b[1]); fbr += float(pos_b[1])
                    cbl += float(pos_b[1]); cbr += float(pos_b[1])

                    bl = max(fal, fbl)
                    br = max(far_, fbr)
                    tl = min(cal, cbl)
                    tr = min(car, cbr)
                    if bl >= tl and br >= tr:
                        continue

                    if d == NORTH:
                        v = [(wx, bl, wz), (wx + s, br, wz),
                             (wx + s, tr, wz), (wx, tl, wz)]
                        na = (0.0, 0.0, -1.0)
                    elif d == EAST:
                        ex = wx + s
                        v = [(ex, bl, wz), (ex, br, wz + s),
                             (ex, tr, wz + s), (ex, tl, wz)]
                        na = (1.0, 0.0, 0.0)
                    elif d == SOUTH:
                        ez = wz + s
                        v = [(wx + s, bl, ez), (wx, br, ez),
                             (wx, tr, ez), (wx + s, tl, ez)]
                        na = (0.0, 0.0, 1.0)
                    else:
                        ex = wx
                        v = [(ex, bl, wz + s), (ex, br, wz),
                             (ex, tr, wz), (ex, tl, wz + s)]
                        na = (-1.0, 0.0, 0.0)

                    def rel(verts, pos):
                        return np.array([[p[0] - pos[0], p[1] - pos[1],
                                          p[2] - pos[2]] for p in verts], F32)

                    ra.portals.append(Portal(bi, rel(v, pos_a), np.asarray(na, F32)))
                    nb = (-na[0], -na[1], -na[2])
                    vb = [v[1], v[0], v[3], v[2]]
                    rb.portals.append(Portal(ai, rel(vb, pos_b), np.asarray(nb, F32)))

        self._detect_horizontal_portals(ai, bi)

    def _detect_horizontal_portals(self, ai: int, bi: int):
        """geometry.rs:3877-3990."""
        ra, rb = self.rooms[ai], self.rooms[bi]
        pos_a, pos_b = ra.position, rb.position
        s = float(SECTOR_SIZE)
        tol = 1.0

        for gx_a in range(ra.width):
            for gz_a in range(ra.depth):
                wx = float(pos_a[0]) + gx_a * s
                wz = float(pos_a[2]) + gz_a * s
                lx, lz = wx - float(pos_b[0]), wz - float(pos_b[2])
                if lx < 0 or lz < 0:
                    continue
                if abs(lx % s) > 0.1 or abs(lz % s) > 0.1:
                    continue
                gx_b, gz_b = int(lx / s), int(lz / s)
                if gx_b >= rb.width or gz_b >= rb.depth:
                    continue
                sa = ra.get_sector(gx_a, gz_a)
                sb = rb.get_sector(gx_b, gz_b)
                if sa is None or sb is None:
                    continue

                def add_pair(heights, upper_idx, lower_idx, upper_pos, lower_pos):
                    verts = [(wx, heights[0], wz), (wx + s, heights[1], wz),
                             (wx + s, heights[2], wz + s), (wx, heights[3], wz + s)]

                    def rel(vv, pos):
                        return np.array([[p[0] - pos[0], p[1] - pos[1],
                                          p[2] - pos[2]] for p in vv], F32)

                    lower_verts = rel(verts, lower_pos)
                    upper_verts = rel([verts[0], verts[3], verts[2], verts[1]],
                                      upper_pos)
                    lower_room = self.rooms[lower_idx]
                    upper_room = self.rooms[upper_idx]
                    lower_room.portals.append(Portal(upper_idx, lower_verts,
                                                     np.asarray((0.0, 1.0, 0.0), F32)))
                    upper_room.portals.append(Portal(lower_idx, upper_verts,
                                                     np.asarray((0.0, -1.0, 0.0), F32)))

                if sa.ceiling is not None and sb.floor is not None:
                    ch = [h + float(pos_a[1]) for h in sa.ceiling.heights]
                    fh = [h + float(pos_b[1]) for h in sb.floor.heights]
                    if all(abs(ch[i] - fh[i]) < tol for i in range(4)):
                        add_pair(ch, bi, ai, pos_b, pos_a)
                if sb.ceiling is not None and sa.floor is not None:
                    ch = [h + float(pos_b[1]) for h in sb.ceiling.heights]
                    fh = [h + float(pos_a[1]) for h in sa.floor.heights]
                    if all(abs(ch[i] - fh[i]) < tol for i in range(4)):
                        add_pair(ch, ai, bi, pos_a, pos_b)
                if (sa.ceiling is None and sb.floor is None
                        and float(pos_b[1]) > float(pos_a[1])):
                    h = float(pos_b[1])
                    add_pair([h] * 4, bi, ai, pos_b, pos_a)
                if (sb.ceiling is None and sa.floor is None
                        and float(pos_a[1]) > float(pos_b[1])):
                    h = float(pos_a[1])
                    add_pair([h] * 4, ai, bi, pos_a, pos_b)

    # ------------------------------------------------------------------
    # Serialization (world/level.rs:224-467)
    # ------------------------------------------------------------------

    @classmethod
    def from_ron(cls, d):
        level = cls(
            rooms=[Room.from_ron(r) for r in d["rooms"]],
            player_settings=PlayerSettings.from_ron(d.get("player_settings")),
            skybox=d.get("skybox"),
            editor_layout=d.get("editor_layout"),
        )
        return level

    def to_ron(self):
        out = {"rooms": [r.to_ron() for r in self.rooms]}
        if self.editor_layout is not None:
            out["editor_layout"] = self.editor_layout
        out["player_settings"] = self.player_settings.to_ron()
        out["skybox"] = ron.wrap_some(self.skybox) if self.skybox is not None else None
        return out


class LevelError(Exception):
    pass


def validate_level(level: Level):
    """world/level.rs:224 — structural limits."""
    if len(level.rooms) > MAX_ROOMS:
        raise LevelError(f"too many rooms ({len(level.rooms)} > {MAX_ROOMS})")
    for i, room in enumerate(level.rooms):
        if room.width > MAX_ROOM_SIZE or room.depth > MAX_ROOM_SIZE:
            raise LevelError(f"room {i} too large")
        if len(room.sectors) != room.width:
            raise LevelError(f"room {i} sector grid width mismatch")
        for col in room.sectors:
            if len(col) != room.depth:
                raise LevelError(f"room {i} sector grid depth mismatch")
            for sec in col:
                if sec is None:
                    continue
                for d in range(6):
                    if len(sec.walls(d)) > MAX_WALLS_PER_EDGE:
                        raise LevelError(f"room {i}: too many walls on an edge")


def parse_level_data(data: bytes) -> Level:
    """world/level.rs:411 — brotli auto-detect + parse + validate + fixups."""
    text = brotli_io.maybe_decompress(data)
    level = Level.from_ron(ron.loads(text))
    validate_level(level)
    for room in level.rooms:
        room.objects = [o for o in room.objects if o.asset_id != 0]
        room.recalculate_bounds()
    return level


def load_level(path) -> Level:
    with open(path, "rb") as f:
        return parse_level_data(f.read())


def save_level(level: Level, path, quality: int = 6):
    """world/level.rs:311 — RON + brotli quality 6."""
    text = ron.dumps(level.to_ron())
    with open(path, "wb") as f:
        f.write(brotli_io.compress(text.encode(), quality=quality))


def create_test_level() -> Level:
    """geometry.rs:4013 — one enclosed 1x1 room."""
    level = Level()
    room = Room.new(0, (0.0, 0.0, 0.0), 1, 1)
    floor_tex = TextureRef("retro-texture-pack", "FLOOR_1A")
    wall_tex = TextureRef("retro-texture-pack", "WALL_1A")
    room.set_floor(0, 0, 0.0, floor_tex)
    room.set_ceiling(0, 0, 1024.0, TextureRef("retro-texture-pack", "FLOOR_1A"))
    for d in (NORTH, EAST, SOUTH, WEST):
        room.add_wall(0, 0, d, 0.0, 1024.0, wall_tex)
    room.recalculate_bounds()
    level.add_room(room)
    return level


def create_empty_level() -> Level:
    """geometry.rs:3995."""
    level = Level()
    room = Room.new(0, (0.0, 0.0, 0.0), 1, 1)
    room.set_floor(0, 0, 0.0, TextureRef("retro-texture-pack", "FLOOR_1A"))
    room.recalculate_bounds()
    level.add_room(room)
    return level
