"""Asset system: component-based assets + library (the port's own copy
of the JAX package's `models/asset.py`, pure Python).

Host-side mirror of `src/asset/` with the same RON schema:
  * AssetComponent enum (component.rs:18): Mesh{parts}, Collision{shape,
    is_trigger}, Light{color,intensity,radius,offset}, Trigger, Pickup,
    Enemy, Door, Audio, Particle, SpawnPoint{is_player,respawns},
    Skeleton{bones} — parsed generically (tag + payload) with typed
    accessors for the components the runtime consumes.
  * Asset (asset.rs:85): id/name/components/category/description/tags.
  * AssetLibrary (library.rs): directory discovery (brotli-RON files),
    lookup by id, hot reload.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Tuple

from ..io import brotli_io, ron
from ..io.ron import Tag
from .mesh import MeshPart


@dataclasses.dataclass
class AssetComponent:
    """Generic tagged component; `data` holds the RON payload dict."""

    kind: str
    data: dict

    @classmethod
    def from_ron(cls, v):
        if isinstance(v, Tag):
            payload = v.value if isinstance(v.value, dict) else {"value": v.value}
            return cls(kind=v.name, data=payload or {})
        raise ValueError(f"bad component: {v!r}")

    def to_ron(self):
        if self.kind == "Mesh" and "parts_obj" in self.data:
            return Tag("Mesh", {"parts": [p.to_ron()
                                          for p in self.data["parts_obj"]]})
        return Tag(self.kind, self.data if self.data else None)


@dataclasses.dataclass
class Asset:
    """asset.rs:85."""

    id: int
    name: str
    components: List[AssetComponent]
    category: str = ""
    description: str = ""
    tags: List[str] = dataclasses.field(default_factory=list)
    is_builtin: bool = False

    def mesh(self) -> Optional[List[MeshPart]]:
        """First Mesh component's parts (asset.rs:192)."""
        for c in self.components:
            if c.kind == "Mesh":
                if "parts_obj" not in c.data:
                    c.data["parts_obj"] = [MeshPart.from_ron(p)
                                           for p in c.data.get("parts", [])]
                return c.data["parts_obj"]
        return None

    def light_component(self):
        """First Light component as (color, intensity, radius, offset)
        (scene.rs:44-62 consumption shape)."""
        for c in self.components:
            if c.kind == "Light":
                d = c.data
                color = tuple(int(x) for x in d.get("color", (255, 255, 255)))
                offset = tuple(float(x) for x in d.get("offset", (0.0, 0.0, 0.0)))
                return (color, float(d.get("intensity", 1.0)),
                        float(d.get("radius", 0.0)), offset)
        return None

    def has_spawn_point(self, is_player: bool) -> bool:
        """asset.rs:279."""
        for c in self.components:
            if c.kind == "SpawnPoint":
                if bool(c.data.get("is_player", False)) == is_player:
                    return True
        return False

    def has_component(self, kind: str) -> bool:
        return any(c.kind == kind for c in self.components)

    # Component predicates (asset.rs:266-300) — used by the editors to
    # pick marker colors/icons per placed object.
    def has_light(self) -> bool:
        return self.has_component("Light")

    def has_enemy(self) -> bool:
        return self.has_component("Enemy")

    def has_mesh(self) -> bool:
        return self.has_component("Mesh")

    def has_trigger(self) -> bool:
        return self.has_component("Trigger")

    def collision_component(self) -> Optional[dict]:
        for c in self.components:
            if c.kind == "Collision":
                return c.data
        return None

    def collision_shape(self) -> Optional["CollisionShape"]:
        """Typed collision shape, FromMesh resolved against the asset's
        mesh bounds (component.rs:251-261 'computed at load time')."""
        d = self.collision_component()
        if d is None:
            return None
        shape = CollisionShape.parse(d.get("shape"))
        if shape is not None and shape.kind == "from_mesh":
            shape = shape.resolve_from_mesh(self.mesh() or [])
        return shape

    @classmethod
    def from_ron(cls, d):
        return cls(
            id=int(d.get("id", 0)),
            name=d.get("name", ""),
            components=[AssetComponent.from_ron(c)
                        for c in d.get("components", [])],
            category=d.get("category", ""),
            description=d.get("description", ""),
            tags=list(d.get("tags", [])),
            is_builtin=bool(d.get("is_builtin", False)),
        )

    def to_ron(self):
        return {"id": self.id, "name": self.name,
                "components": [c.to_ron() for c in self.components],
                "category": self.category, "description": self.description,
                "tags": self.tags, "is_builtin": self.is_builtin}


def parse_asset(data: bytes) -> Asset:
    return Asset.from_ron(ron.loads(brotli_io.maybe_decompress(data)))


def load_asset(path) -> Asset:
    with open(path, "rb") as f:
        return parse_asset(f.read())


def save_asset(asset: Asset, path, quality: int = 6):
    text = ron.dumps(asset.to_ron())
    with open(path, "wb") as f:
        f.write(brotli_io.compress(text.encode(), quality=quality))


# ----------------------------------------------------------------------------
# Built-in assets (asset/library.rs creates player_spawn, point_light, ...)
# ----------------------------------------------------------------------------

PLAYER_SPAWN_ID = 1
POINT_LIGHT_ID = 2
CHECKPOINT_ID = 3


def builtin_assets() -> List[Asset]:
    return [
        Asset(id=PLAYER_SPAWN_ID, name="player_spawn", is_builtin=True,
              components=[AssetComponent("SpawnPoint",
                                         {"is_player": True, "respawns": False})]),
        Asset(id=POINT_LIGHT_ID, name="point_light", is_builtin=True,
              components=[AssetComponent("Light", {
                  "color": (255, 220, 160), "intensity": 1.0,
                  "radius": 4096.0, "offset": (0.0, 0.0, 0.0)})]),
        Asset(id=CHECKPOINT_ID, name="checkpoint", is_builtin=True,
              components=[AssetComponent("SpawnPoint",
                                         {"is_player": False, "respawns": True})]),
    ]


class AssetLibrary:
    """asset/library.rs:61 — discovery over sample + user dirs, id lookup."""

    def __init__(self, dirs: Optional[List[str]] = None,
                 include_builtins: bool = True):
        self.dirs = dirs or []
        self.assets: Dict[int, Asset] = {}
        self.include_builtins = include_builtins
        self.reload_all()

    def reload_all(self):
        self.assets = {}
        if self.include_builtins:
            for a in builtin_assets():
                self.assets[a.id] = a
        for d in self.dirs:
            if not os.path.isdir(d):
                continue
            for fn in sorted(os.listdir(d)):
                if not fn.endswith(".ron"):
                    continue
                try:
                    a = load_asset(os.path.join(d, fn))
                    self.assets[a.id] = a
                except Exception:
                    continue

    def get_by_id(self, asset_id: int) -> Optional[Asset]:
        return self.assets.get(asset_id)

    def get(self, name: str) -> Optional[Asset]:
        """library.rs name lookup (used by object placement)."""
        for a in self.assets.values():
            if a.name == name:
                return a
        return None

    def __len__(self):
        return len(self.assets)


# =============================================================================
# Collision shapes (component.rs:251-330)
# =============================================================================

@dataclasses.dataclass(frozen=True)
class CollisionShape:
    """CollisionShapeDef: sphere / box / capsule / cylinder / from_mesh."""

    kind: str
    radius: float = 0.0
    height: float = 0.0
    half_extents: Tuple[float, float, float] = (0.0, 0.0, 0.0)

    @classmethod
    def sphere(cls, radius):
        return cls("sphere", radius=float(radius))

    @classmethod
    def box(cls, hx, hy, hz):
        return cls("box", half_extents=(float(hx), float(hy), float(hz)))

    @classmethod
    def capsule(cls, radius, height):
        return cls("capsule", radius=float(radius), height=float(height))

    @classmethod
    def cylinder(cls, radius, height):
        return cls("cylinder", radius=float(radius), height=float(height))

    @classmethod
    def parse(cls, v) -> Optional["CollisionShape"]:
        """From a RON enum value (Tag) or plain dict."""
        if v is None:
            return None
        if isinstance(v, Tag):
            name = v.name
            payload = v.value if isinstance(v.value, dict) else {}
        elif isinstance(v, dict) and "kind" in v:
            name = v["kind"]
            payload = v
        else:
            return None
        name_l = name.lower()
        if name_l == "sphere":
            return cls.sphere(payload.get("radius", 0.0))
        if name_l == "box":
            he = payload.get("half_extents", (0, 0, 0))
            return cls.box(he[0], he[1], he[2])
        if name_l == "capsule":
            return cls.capsule(payload.get("radius", 0.0),
                               payload.get("height", 0.0))
        if name_l == "cylinder":
            return cls.cylinder(payload.get("radius", 0.0),
                                payload.get("height", 0.0))
        if name_l == "frommesh" or name_l == "from_mesh":
            return cls("from_mesh")
        return None

    def to_ron(self):
        if self.kind == "sphere":
            return Tag("Sphere", {"radius": self.radius})
        if self.kind == "box":
            return Tag("Box", {"half_extents": list(self.half_extents)})
        if self.kind == "capsule":
            return Tag("Capsule", {"radius": self.radius,
                                   "height": self.height})
        if self.kind == "cylinder":
            return Tag("Cylinder", {"radius": self.radius,
                                    "height": self.height})
        return Tag("FromMesh")

    def resolve_from_mesh(self, parts) -> "CollisionShape":
        """FromMesh -> AABB box of all part vertices (load-time rule)."""
        if self.kind != "from_mesh":
            return self
        import numpy as np
        pts = [v.pos for p in parts for v in p.mesh.vertices]
        if not pts:
            return CollisionShape.box(0.0, 0.0, 0.0)
        a = np.asarray(pts, np.float32)
        half = (a.max(axis=0) - a.min(axis=0)) / 2.0
        return CollisionShape.box(half[0], half[1], half[2])

    def contains(self, point) -> bool:
        """Point-in-shape test in the shape's local frame (origin at the
        shape center; capsule/cylinder axis = +Y, height = total)."""
        import numpy as np
        p = np.asarray(point, np.float32)
        if self.kind == "sphere":
            return bool(p @ p <= self.radius ** 2)
        if self.kind == "box":
            he = np.asarray(self.half_extents, np.float32)
            return bool(np.all(np.abs(p) <= he))
        if self.kind == "cylinder":
            return bool(abs(p[1]) <= self.height / 2.0
                        and p[0] ** 2 + p[2] ** 2 <= self.radius ** 2)
        if self.kind == "capsule":
            half_core = max(self.height / 2.0 - self.radius, 0.0)
            y = min(max(float(p[1]), -half_core), half_core)
            d = p - np.asarray([0.0, y, 0.0], np.float32)
            return bool(d @ d <= self.radius ** 2)
        return False

    def bounding_radius(self) -> float:
        """Conservative sphere radius (broad-phase)."""
        import math
        if self.kind == "sphere":
            return self.radius
        if self.kind == "box":
            return math.sqrt(sum(h * h for h in self.half_extents))
        if self.kind in ("capsule", "cylinder"):
            return math.hypot(self.radius, self.height / 2.0)
        return 0.0

    def description(self) -> str:
        """component.rs:289."""
        if self.kind == "sphere":
            return f"Sphere (r={self.radius:.0f})"
        if self.kind == "box":
            hx, hy, hz = self.half_extents
            return f"Box ({hx * 2:.0f}x{hy * 2:.0f}x{hz * 2:.0f})"
        if self.kind == "capsule":
            return f"Capsule (r={self.radius:.0f}, h={self.height:.0f})"
        if self.kind == "cylinder":
            return f"Cylinder (r={self.radius:.0f}, h={self.height:.0f})"
        return "From Mesh"
