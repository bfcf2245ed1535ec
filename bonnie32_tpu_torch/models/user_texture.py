"""User textures: self-contained indexed textures with embedded palettes
(the port's own copy of the JAX package's `models/user_texture.py`, pure
numpy).

Host-side mirror of `src/texture/user_texture.rs` (RON +
brotli, id'd, 4/8-bit indices + RGB555 palette) and the TextureLibrary
discovery (`texture/texture_library.rs`).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional

import numpy as np

from ..io import brotli_io, ron
from ..io.ron import Tag

_BLEND_NAMES = ["Opaque", "Average", "Add", "Subtract", "AddQuarter", "Erase"]


@dataclasses.dataclass
class UserTexture:
    """user_texture.rs:180."""

    id: int
    name: str
    width: int
    height: int
    depth: int              # 0 = Bpp4, 1 = Bpp8
    indices: np.ndarray     # (h*w,) uint8
    palette: List[int]      # Color15 words
    blend_mode: int = 0

    def to_texture15(self) -> np.ndarray:
        """(h, w) uint16 Color15 via the embedded palette."""
        lut = np.zeros(256, np.uint16)
        n = min(len(self.palette), 256)
        lut[:n] = np.asarray(self.palette[:n], np.uint16)
        return lut[self.indices.astype(np.int64)].reshape(self.height, self.width)

    @classmethod
    def from_ron(cls, d):
        depth = d.get("depth")
        depth_code = 0
        if depth is not None:
            name = depth.name if isinstance(depth, Tag) else str(depth)
            depth_code = {"Bpp4": 0, "Bpp8": 1}[name]
        return cls(
            id=int(d.get("id", 0)),
            name=d.get("name", ""),
            width=int(d["width"]), height=int(d["height"]),
            depth=depth_code,
            indices=np.asarray(d.get("indices", []), np.uint8),
            palette=[int(c) for c in d.get("palette", [])],
            blend_mode=_BLEND_NAMES.index(
                d["blend_mode"].name) if isinstance(d.get("blend_mode"), Tag) else 0,
        )

    def to_ron(self):
        return {
            "id": self.id, "name": self.name,
            "width": self.width, "height": self.height,
            "depth": Tag("Bpp4" if self.depth == 0 else "Bpp8"),
            "indices": [int(i) for i in self.indices],
            "palette": [int(c) for c in self.palette],
            "blend_mode": Tag(_BLEND_NAMES[self.blend_mode]),
        }


def parse_user_texture(data: bytes) -> UserTexture:
    return UserTexture.from_ron(ron.loads(brotli_io.maybe_decompress(data)))


def load_user_texture(path) -> UserTexture:
    with open(path, "rb") as f:
        return parse_user_texture(f.read())


def save_user_texture(tex: UserTexture, path, quality: int = 6):
    with open(path, "wb") as f:
        f.write(brotli_io.compress(ron.dumps(tex.to_ron()).encode(),
                                   quality=quality))


class TextureLibrary:
    """texture/texture_library.rs — discovery + id lookup."""

    def __init__(self, dirs: Optional[List[str]] = None):
        self.dirs = dirs or []
        self.textures: Dict[int, UserTexture] = {}
        self.reload_all()

    def reload_all(self):
        self.textures = {}
        for d in self.dirs:
            if not os.path.isdir(d):
                continue
            for fn in sorted(os.listdir(d)):
                if not fn.endswith(".ron"):
                    continue
                try:
                    t = load_user_texture(os.path.join(d, fn))
                    self.textures[t.id] = t
                except Exception:
                    continue

    def get_by_id(self, tex_id: int) -> Optional[UserTexture]:
        return self.textures.get(tex_id)

    def __len__(self):
        return len(self.textures)
