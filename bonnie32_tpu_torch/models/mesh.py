"""Modeler data model: editable meshes, indexed atlases, CLUTs, mesh parts
(the port's own copy of the JAX package's `models/mesh.py`, pure numpy).

Host-side mirror of `src/modeler/mesh_editor.rs` with the
same RON schema:
  * EditFace — n-gon faces with fan triangulation (mesh_editor.rs:28, 99)
  * EditableMesh + primitives + to_render_data_textured (:984, :1623)
  * TextureRef enum None/Checkerboard/Id/Embedded (:146)
  * MeshPart (:219), MeshProject (:306)
  * Clut / ClutPool (:495; rasterizer/types.rs:328)
  * IndexedAtlas + to_texture15 + checkerboard (:594, :669)
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from ..io.ron import Tag
from ..io import ron

_BLEND_NAMES = ["Opaque", "Average", "Add", "Subtract", "AddQuarter", "Erase"]


def _blend_code(tag) -> int:
    if tag is None:
        return 0
    return _BLEND_NAMES.index(tag.name if isinstance(tag, Tag) else str(tag))


def _depth_code(tag) -> int:
    """ClutDepth: 0 = Bpp4 (16 colors), 1 = Bpp8 (256)."""
    if tag is None:
        return 0
    name = tag.name if isinstance(tag, Tag) else str(tag)
    return {"Bpp4": 0, "Bpp8": 1}[name]


def depth_colors(depth: int) -> int:
    return 16 if depth == 0 else 256


@dataclasses.dataclass
class Clut:
    """rasterizer/types.rs:328 — 16/256 Color15 entries, index 0 transparent."""

    id: int = 0
    name: str = ""
    depth: int = 0  # 0=Bpp4, 1=Bpp8
    colors: List[int] = dataclasses.field(default_factory=list)

    @classmethod
    def new_4bit(cls, name=""):
        """types.rs:342 — grayscale ramp, index 0 transparent."""
        colors = [0] + [((i * 2) << 10) | ((i * 2) << 5) | (i * 2)
                        for i in range(1, 16)]
        return cls(id=0, name=name, depth=0, colors=colors)

    def lookup(self, index: int) -> int:
        if 0 <= index < len(self.colors):
            return self.colors[index]
        return 0

    @classmethod
    def from_ron(cls, d):
        return cls(id=int(d.get("id", 0)), name=d.get("name", ""),
                   depth=_depth_code(d.get("depth")),
                   colors=[int(c) for c in d.get("colors", [])])

    def to_ron(self):
        return {"id": self.id, "name": self.name,
                "depth": Tag("Bpp4" if self.depth == 0 else "Bpp8"),
                "colors": [int(c) for c in self.colors]}


@dataclasses.dataclass
class ClutPool:
    """mesh_editor.rs:495."""

    cluts: List[Clut] = dataclasses.field(default_factory=list)
    next_id: int = 1

    @classmethod
    def new(cls):
        pool = cls()
        pool.add_clut(Clut.new_4bit("Default"))
        return pool

    def add_clut(self, clut: Clut) -> int:
        clut.id = self.next_id
        self.next_id += 1
        self.cluts.append(clut)
        return clut.id

    def get(self, clut_id: int) -> Optional[Clut]:
        for c in self.cluts:
            if c.id == clut_id:
                return c
        return None

    def first_id(self) -> int:
        return self.cluts[0].id if self.cluts else 0

    @classmethod
    def from_ron(cls, d):
        if d is None:
            return cls.new()
        return cls(cluts=[Clut.from_ron(c) for c in d.get("cluts", [])],
                   next_id=int(d.get("next_id", 1)))

    def to_ron(self):
        return {"cluts": [c.to_ron() for c in self.cluts],
                "next_id": self.next_id}


def checkerboard_clut() -> Clut:
    """mesh_editor.rs:196 — grayscale incl. index 0 (NOT transparent)."""
    c = Clut.new_4bit("checkerboard_clut")
    for i in range(16):
        v = i * 2
        c.colors[i] = (v << 10) | (v << 5) | v
    return c


@dataclasses.dataclass
class IndexedAtlas:
    """mesh_editor.rs:594."""

    width: int = 0
    height: int = 0
    depth: int = 0
    indices: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.uint8))
    default_clut: int = 0

    @classmethod
    def new_checkerboard(cls, width=128, height=128, depth=0):
        """mesh_editor.rs:615 — 8x8 cells of indices 7 / 15."""
        ys, xs = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
        idx = np.where(((xs // 8) + (ys // 8)) % 2 == 0, 7, 15).astype(np.uint8)
        return cls(width=width, height=height, depth=depth,
                   indices=idx.reshape(-1), default_clut=0)

    def to_texture15(self, clut: Clut) -> np.ndarray:
        """mesh_editor.rs:669 — (h, w) uint16 Color15 via CLUT lookup."""
        lut = np.zeros(256, np.uint16)
        n = min(len(clut.colors), 256)
        lut[:n] = np.asarray(clut.colors[:n], np.uint16)
        return lut[self.indices.astype(np.int64)].reshape(self.height, self.width)

    @property
    def is_empty(self) -> bool:
        return self.width == 0 or self.height == 0 or self.indices.size == 0

    @classmethod
    def from_ron(cls, d):
        if d is None:
            return cls()
        return cls(width=int(d.get("width", 0)), height=int(d.get("height", 0)),
                   depth=_depth_code(d.get("depth")),
                   indices=np.asarray(d.get("indices", []), np.uint8),
                   default_clut=int(d.get("default_clut", 0)))

    def to_ron(self):
        return {"width": self.width, "height": self.height,
                "depth": Tag("Bpp4" if self.depth == 0 else "Bpp8"),
                "indices": [int(i) for i in self.indices],
                "default_clut": self.default_clut}


@dataclasses.dataclass
class TextureRef:
    """mesh_editor.rs:146 — None / Checkerboard / Id(u64) / Embedded."""

    kind: str = "Checkerboard"   # "None" | "Checkerboard" | "Id" | "Embedded"
    id: int = 0
    embedded: Optional[IndexedAtlas] = None

    @classmethod
    def from_ron(cls, v):
        if v is None:
            return cls(kind="Checkerboard")
        if isinstance(v, Tag):
            if v.name == "Id":
                return cls(kind="Id", id=int(v.value))
            if v.name == "Embedded":
                return cls(kind="Embedded",
                           embedded=IndexedAtlas.from_ron(v.value))
            return cls(kind=v.name)
        return cls(kind="Checkerboard")

    def to_ron(self):
        if self.kind == "Id":
            return Tag("Id", self.id)
        if self.kind == "Embedded":
            return Tag("Embedded", self.embedded.to_ron())
        return Tag(self.kind)


@dataclasses.dataclass
class EditFace:
    """mesh_editor.rs:28."""

    vertices: List[int]
    texture_id: Optional[int] = None
    black_transparent: bool = True
    blend_mode: int = 0

    def triangulate(self) -> List[Tuple[int, int, int]]:
        """Fan triangulation (mesh_editor.rs:99)."""
        n = len(self.vertices)
        if n < 3:
            return []
        v = self.vertices
        return [(v[0], v[i], v[i + 1]) for i in range(1, n - 1)]

    @classmethod
    def from_ron(cls, d):
        return cls(vertices=[int(i) for i in d["vertices"]],
                   texture_id=int(d["texture_id"]) if d.get("texture_id") is not None else None,
                   black_transparent=bool(d.get("black_transparent", True)),
                   blend_mode=_blend_code(d.get("blend_mode")))

    def to_ron(self):
        return {"vertices": list(self.vertices),
                "texture_id": ron.wrap_some(self.texture_id),
                "black_transparent": self.black_transparent,
                "blend_mode": Tag(_BLEND_NAMES[self.blend_mode])}


@dataclasses.dataclass
class MeshVertex:
    pos: Tuple[float, float, float]
    uv: Tuple[float, float] = (0.0, 0.0)
    normal: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    color: Tuple[int, int, int] = (128, 128, 128)
    color_blend: int = 0
    bone_index: Optional[int] = None

    @classmethod
    def from_ron(cls, d):
        c = d.get("color")
        if c is not None:
            rgb = (int(c["r"]), int(c["g"]), int(c["b"]))
            cb = _blend_code(c.get("blend"))
        else:
            rgb, cb = (128, 128, 128), 0
        return cls(
            pos=(float(d["pos"]["x"]), float(d["pos"]["y"]), float(d["pos"]["z"])),
            uv=(float(d["uv"]["x"]), float(d["uv"]["y"])),
            normal=(float(d["normal"]["x"]), float(d["normal"]["y"]),
                    float(d["normal"]["z"])),
            color=rgb, color_blend=cb,
            bone_index=int(d["bone_index"]) if d.get("bone_index") is not None else None,
        )

    def to_ron(self):
        out = {
            "pos": {"x": np.float32(self.pos[0]), "y": np.float32(self.pos[1]),
                    "z": np.float32(self.pos[2])},
            "uv": {"x": np.float32(self.uv[0]), "y": np.float32(self.uv[1])},
            "normal": {"x": np.float32(self.normal[0]),
                       "y": np.float32(self.normal[1]),
                       "z": np.float32(self.normal[2])},
            "color": {"r": self.color[0], "g": self.color[1], "b": self.color[2],
                      "blend": Tag(_BLEND_NAMES[self.color_blend])},
        }
        if self.bone_index is not None:
            out["bone_index"] = ron.wrap_some(self.bone_index)
        return out


@dataclasses.dataclass
class EditableMesh:
    """mesh_editor.rs:984."""

    vertices: List[MeshVertex] = dataclasses.field(default_factory=list)
    faces: List[EditFace] = dataclasses.field(default_factory=list)

    @classmethod
    def cube(cls, size: float) -> "EditableMesh":
        """mesh_editor.rs:1002 — 24 verts, 6 CW quads."""
        h = size / 2.0
        v = MeshVertex
        verts = [
            v((-h, -h, h), (0, 1), (0, 0, 1)), v((h, -h, h), (1, 1), (0, 0, 1)),
            v((h, h, h), (1, 0), (0, 0, 1)), v((-h, h, h), (0, 0), (0, 0, 1)),
            v((h, -h, -h), (0, 1), (0, 0, -1)), v((-h, -h, -h), (1, 1), (0, 0, -1)),
            v((-h, h, -h), (1, 0), (0, 0, -1)), v((h, h, -h), (0, 0), (0, 0, -1)),
            v((-h, h, h), (0, 1), (0, 1, 0)), v((h, h, h), (1, 1), (0, 1, 0)),
            v((h, h, -h), (1, 0), (0, 1, 0)), v((-h, h, -h), (0, 0), (0, 1, 0)),
            v((-h, -h, -h), (0, 1), (0, -1, 0)), v((h, -h, -h), (1, 1), (0, -1, 0)),
            v((h, -h, h), (1, 0), (0, -1, 0)), v((-h, -h, h), (0, 0), (0, -1, 0)),
            v((h, -h, h), (0, 1), (1, 0, 0)), v((h, -h, -h), (1, 1), (1, 0, 0)),
            v((h, h, -h), (1, 0), (1, 0, 0)), v((h, h, h), (0, 0), (1, 0, 0)),
            v((-h, -h, -h), (0, 1), (-1, 0, 0)), v((-h, -h, h), (1, 1), (-1, 0, 0)),
            v((-h, h, h), (1, 0), (-1, 0, 0)), v((-h, h, -h), (0, 0), (-1, 0, 0)),
        ]
        faces = [EditFace([0, 3, 2, 1]), EditFace([4, 7, 6, 5]),
                 EditFace([8, 11, 10, 9]), EditFace([12, 15, 14, 13]),
                 EditFace([16, 19, 18, 17]), EditFace([20, 23, 22, 21])]
        return cls(vertices=verts, faces=faces)


    @classmethod
    def plane(cls, size: float) -> "EditableMesh":
        """mesh_editor.rs:1053 — single CW quad at y=0."""
        h = size / 2.0
        v = MeshVertex
        verts = [v((-h, 0.0, -h), (0, 0), (0, 1, 0)),
                 v((h, 0.0, -h), (1, 0), (0, 1, 0)),
                 v((h, 0.0, h), (1, 1), (0, 1, 0)),
                 v((-h, 0.0, h), (0, 1), (0, 1, 0))]
        return cls(vertices=verts, faces=[EditFace([0, 1, 2, 3])])

    @classmethod
    def prism(cls, size: float, height: float) -> "EditableMesh":
        """mesh_editor.rs:1071 — triangular wedge: 2 tri caps + 3 quads."""
        h = size / 2.0
        v = MeshVertex
        verts = [
            v((-h, 0.0, -h), (0, 1), (0, -1, 0)),
            v((h, 0.0, -h), (1, 1), (0, -1, 0)),
            v((0.0, 0.0, h), (0.5, 0), (0, -1, 0)),
            v((-h, height, -h), (0, 1), (0, 1, 0)),
            v((h, height, -h), (1, 1), (0, 1, 0)),
            v((0.0, height, h), (0.5, 0), (0, 1, 0)),
        ]
        faces = [EditFace([0, 1, 2]), EditFace([3, 4, 5]),
                 EditFace([0, 1, 4, 3]), EditFace([1, 2, 5, 4]),
                 EditFace([2, 0, 3, 5])]
        return cls(vertices=verts, faces=faces)

    @classmethod
    def cylinder(cls, radius: float, height: float,
                 segments: int = 8) -> "EditableMesh":
        """mesh_editor.rs:1104 — n-gon caps + per-segment side quads with
        radial normals (cap and side rings are separate vertices)."""
        import math as _m
        segments = max(segments, 3)
        v = MeshVertex
        verts = []
        for y, ny in ((0.0, -1.0), (height, 1.0)):
            for i in range(segments):
                a = (i / segments) * 2.0 * _m.pi
                verts.append(v((_m.cos(a) * radius, y, _m.sin(a) * radius),
                               (0.5 + _m.cos(a) * 0.5,
                                0.5 + _m.sin(a) * 0.5), (0.0, ny, 0.0)))
        side0 = len(verts)
        for y, vv in ((0.0, 1.0), (height, 0.0)):
            for i in range(segments):
                a = (i / segments) * 2.0 * _m.pi
                verts.append(v((_m.cos(a) * radius, y, _m.sin(a) * radius),
                               (i / segments, vv),
                               (_m.cos(a), 0.0, _m.sin(a))))
        faces = [EditFace(list(range(segments - 1, -1, -1))),
                 EditFace(list(range(segments, 2 * segments)))]
        for i in range(segments):
            nx = (i + 1) % segments
            faces.append(EditFace([side0 + i, side0 + nx,
                                   side0 + segments + nx,
                                   side0 + segments + i]))
        return cls(vertices=verts, faces=faces)

    @classmethod
    def pyramid(cls, base_size: float, height: float) -> "EditableMesh":
        """mesh_editor.rs:1185 — quad base + 4 apex triangles."""
        h = base_size / 2.0
        v = MeshVertex
        verts = [
            v((-h, 0.0, -h), (0, 0), (0, -1, 0)),
            v((h, 0.0, -h), (1, 0), (0, -1, 0)),
            v((h, 0.0, h), (1, 1), (0, -1, 0)),
            v((-h, 0.0, h), (0, 1), (0, -1, 0)),
            v((0.0, height, 0.0), (0.5, 0.5), (0, 1, 0)),
        ]
        faces = [EditFace([0, 3, 2, 1]), EditFace([0, 1, 4]),
                 EditFace([1, 2, 4]), EditFace([2, 3, 4]),
                 EditFace([3, 0, 4])]
        return cls(vertices=verts, faces=faces)

    @classmethod
    def ngon_prism(cls, sides: int, radius: float,
                   height: float) -> "EditableMesh":
        """mesh_editor.rs:1229 — N-sided prism (pent/hex presets below)."""
        import math as _m
        sides = max(sides, 3)
        v = MeshVertex
        verts = []
        for y, ny in ((0.0, -1.0), (height, 1.0)):
            for i in range(sides):
                a = (i / sides) * 2.0 * _m.pi
                verts.append(v((_m.cos(a) * radius, y, _m.sin(a) * radius),
                               (0.5 + _m.cos(a) * 0.5,
                                0.5 + _m.sin(a) * 0.5), (0.0, ny, 0.0)))
        faces = [EditFace(list(range(sides - 1, -1, -1))),
                 EditFace(list(range(sides, 2 * sides)))]
        for i in range(sides):
            nx = (i + 1) % sides
            faces.append(EditFace([i, nx, sides + nx, sides + i]))
        return cls(vertices=verts, faces=faces)

    @classmethod
    def pent(cls, radius: float, height: float) -> "EditableMesh":
        return cls.ngon_prism(5, radius, height)

    @classmethod
    def hex(cls, radius: float, height: float) -> "EditableMesh":
        return cls.ngon_prism(6, radius, height)

    # --- topology queries (mesh_editor.rs:2025-2215) -------------------

    def faces_with_edge(self, v0: int, v1: int) -> List[int]:
        """mesh_editor.rs:2025 — faces containing edge (v0, v1) in either
        winding."""
        out = []
        for i, face in enumerate(self.faces):
            fv = face.vertices
            n = len(fv)
            for k in range(n):
                a, b = fv[k], fv[(k + 1) % n]
                if (a == v0 and b == v1) or (a == v1 and b == v0):
                    out.append(i)
                    break
        return out

    def opposite_edge_in_quad(self, face_idx: int, v0: int, v1: int):
        """mesh_editor.rs:2045 — the edge two positions away in a quad;
        None for non-quads or faces missing the edge."""
        fv = self.faces[face_idx].vertices
        if len(fv) != 4:
            return None
        for i in range(4):
            a, b = fv[i], fv[(i + 1) % 4]
            if (a == v0 and b == v1) or (a == v1 and b == v0):
                return (fv[(i + 2) % 4], fv[(i + 3) % 4])
        return None

    def select_edge_loop(self, v0: int, v1: int) -> List[Tuple[int, int]]:
        """mesh_editor.rs:2070 — walk perpendicular across quads in both
        directions from (v0, v1)."""
        loop_edges = [(v0, v1)]
        norm = lambda a, b: (a, b) if a < b else (b, a)  # noqa: E731
        visited = {norm(v0, v1)}
        for start_v, end_v in ((v0, v1), (v1, v0)):
            prev_v, curr_v = start_v, end_v
            while True:
                next_v = None
                for face in self.faces:
                    fv = face.vertices
                    if len(fv) != 4:
                        continue
                    pos = None
                    for i in range(4):
                        if fv[i] == curr_v and (fv[(i + 1) % 4] == prev_v
                                                or fv[(i + 3) % 4] == prev_v):
                            pos = i
                            break
                    if pos is None:
                        continue
                    n1 = fv[(pos + 1) % 4]
                    n2 = fv[(pos + 3) % 4]
                    cand = n1 if n1 != prev_v else n2
                    if norm(curr_v, cand) not in visited:
                        next_v = cand
                        break
                if next_v is None:
                    break
                visited.add(norm(curr_v, next_v))
                loop_edges.append((curr_v, next_v))
                prev_v, curr_v = curr_v, next_v
        return loop_edges

    def select_face_loop(self, start_face: int, edge_v0: int,
                         edge_v1: int) -> List[int]:
        """mesh_editor.rs:2154 — strip of quads through opposite edges,
        both directions."""
        loop_faces = [start_face]
        visited = {start_face}
        opposite_start = self.opposite_edge_in_quad(start_face, edge_v0,
                                                    edge_v1)
        for direction in range(2):
            current_face = start_face
            if direction == 0:
                current_edge = (edge_v0, edge_v1)
            elif opposite_start is not None:
                current_edge = opposite_start
            else:
                continue
            while True:
                opposite = self.opposite_edge_in_quad(
                    current_face, current_edge[0], current_edge[1])
                if opposite is None:
                    break
                adjacent = self.faces_with_edge(opposite[0], opposite[1])
                next_face = next((f for f in adjacent
                                  if f != current_face
                                  and f not in visited), None)
                if next_face is None:
                    break
                visited.add(next_face)
                loop_faces.append(next_face)
                current_face = next_face
                current_edge = opposite
        return loop_faces

    def vertices_from_edge_loop(self, edges) -> List[int]:
        """mesh_editor.rs:2205 — unique vertex ids in first-seen order."""
        out: List[int] = []
        seen = set()
        for v0, v1 in edges:
            for v in (v0, v1):
                if v not in seen:
                    seen.add(v)
                    out.append(v)
        return out

    def to_render_data_textured(self):
        """mesh_editor.rs:1623 — golden-model-format verts + tri faces with
        texture_id defaulting to 0 (the part's atlas)."""
        verts = [dict(pos=v.pos, uv=v.uv, normal=v.normal, color=v.color,
                      color_blend=v.color_blend) for v in self.vertices]
        faces = []
        for ef in self.faces:
            for (a, b, c) in ef.triangulate():
                faces.append(dict(
                    v0=a, v1=b, v2=c,
                    tex_id=ef.texture_id if ef.texture_id is not None else 0,
                    black_transparent=ef.black_transparent,
                    blend_mode=ef.blend_mode, editor_alpha=255))
        return verts, faces

    @classmethod
    def from_ron(cls, d):
        return cls(vertices=[MeshVertex.from_ron(v) for v in d.get("vertices", [])],
                   faces=[EditFace.from_ron(f) for f in d.get("faces", [])])

    def to_ron(self):
        return {"vertices": [v.to_ron() for v in self.vertices],
                "faces": [f.to_ron() for f in self.faces]}


@dataclasses.dataclass
class MeshPart:
    """mesh_editor.rs:219."""

    name: str = ""
    mesh: EditableMesh = dataclasses.field(default_factory=EditableMesh)
    texture_ref: TextureRef = dataclasses.field(default_factory=TextureRef)
    visible: bool = True
    locked: bool = False
    double_sided: bool = False
    default_bone_index: Optional[int] = None

    @classmethod
    def from_ron(cls, d):
        dbi = d.get("default_bone_index", d.get("bone_index"))
        return cls(
            name=d.get("name", ""),
            mesh=EditableMesh.from_ron(d.get("mesh", {})),
            texture_ref=TextureRef.from_ron(d.get("texture_ref")),
            visible=bool(d.get("visible", True)),
            locked=bool(d.get("locked", False)),
            double_sided=bool(d.get("double_sided", False)),
            default_bone_index=int(dbi) if dbi is not None else None,
        )

    def to_ron(self):
        out = {"name": self.name, "mesh": self.mesh.to_ron(),
               "texture_ref": self.texture_ref.to_ron(),
               "visible": self.visible, "locked": self.locked,
               "double_sided": self.double_sided}
        if self.default_bone_index is not None:
            out["default_bone_index"] = ron.wrap_some(self.default_bone_index)
        return out


@dataclasses.dataclass
class MeshProject:
    """mesh_editor.rs:306 — multi-part model + shared CLUT pool."""

    name: str = ""
    objects: List[MeshPart] = dataclasses.field(default_factory=list)
    clut_pool: ClutPool = dataclasses.field(default_factory=ClutPool)
    preview_clut: Optional[int] = None     # not serialized
    selected_object: Optional[int] = None  # not serialized

    @classmethod
    def new(cls, name: str) -> "MeshProject":
        """mesh_editor.rs:326 — a default cube part linked to the pool's
        first CLUT."""
        pool = ClutPool()
        cube = MeshPart(name="Cube.00", mesh=EditableMesh.cube(1024.0))
        return cls(name=name, objects=[cube], clut_pool=pool,
                   selected_object=0)

    def add_object(self, obj: MeshPart) -> int:
        self.objects.append(obj)
        return len(self.objects) - 1

    def selected(self) -> Optional[MeshPart]:
        if self.selected_object is None:
            return None
        if 0 <= self.selected_object < len(self.objects):
            return self.objects[self.selected_object]
        return None

    def total_vertices(self) -> int:
        return sum(len(o.mesh.vertices) for o in self.objects)

    def total_faces(self) -> int:
        return sum(len(o.mesh.faces) for o in self.objects)

    def effective_clut(self) -> Optional[Clut]:
        """mesh_editor.rs:372 — preview override > first object's default >
        first in pool."""
        if self.preview_clut is not None:
            c = self.clut_pool.get(self.preview_clut)
            if c is not None:
                return c
        return self.clut_pool.get(self.clut_pool.first_id())

    @classmethod
    def from_ron(cls, d):
        return cls(
            name=d.get("name", ""),
            objects=[MeshPart.from_ron(o) for o in d.get("objects", [])],
            clut_pool=(ClutPool.from_ron(d["clut_pool"])
                       if d.get("clut_pool") else ClutPool()),
            selected_object=0 if d.get("objects") else None,
        )

    def to_ron(self):
        return {"name": self.name,
                "objects": [o.to_ron() for o in self.objects],
                "clut_pool": self.clut_pool.to_ron()}
