"""Texture pack loading: PNG directories -> Color15 arrays
(bonnie32_tpu/models/texture_pack.py; a host copy).

Reference: `editor/texture_pack.rs:16-50` loads each pack directory's
PNGs sorted by filename, quantizing to 15-bit on load; the game then
converts to Texture15 (`game/renderer.rs:131`, `types.rs:1267`):
alpha == 0 -> transparent 0x0000, else rgb >> 3 packed RGB555.

The renderer's texture resolver (`game/renderer.rs:104-112`) matches by
texture NAME against the flat concatenation of all packs, falling back to
texture 0 (64px wide) for invalid refs and None for unknown names.
Pillow is imported only where a PNG is read.
"""

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class PackTexture:
    def __init__(self, name: str, pixels15: np.ndarray,
                 rgba8: Optional[np.ndarray] = None):
        self.name = name
        self.pixels15 = pixels15  # (h, w) uint16 Color15
        # 8-bit quantized source (types.rs:876 quantize_15bit masks &0xF8;
        # alpha kept) — consumed by the non-RGB555 path (render_mesh).
        self.rgba8 = rgba8        # (h, w, 4) uint8, or None

    @property
    def width(self) -> int:
        return self.pixels15.shape[1]

    @property
    def height(self) -> int:
        return self.pixels15.shape[0]


def png_to_color15(path) -> np.ndarray:
    """PNG -> (h, w) uint16 Color15 (alpha-0 keyed to 0x0000)."""
    from PIL import Image

    img = Image.open(path).convert("RGBA")
    arr = np.asarray(img, np.uint16)
    r5 = arr[..., 0] >> 3
    g5 = arr[..., 1] >> 3
    b5 = arr[..., 2] >> 3
    c15 = (r5 << 10) | (g5 << 5) | b5
    return np.where(arr[..., 3] == 0, np.uint16(0), c15.astype(np.uint16))


def load_png_pack_texture(path) -> PackTexture:
    """PNG -> PackTexture with both views: Color15 (alpha-0 -> 0x0000) and
    the quantized 8-bit original (channels masked &0xF8, types.rs:876)."""
    from PIL import Image

    name = os.path.splitext(os.path.basename(path))[0]
    img = Image.open(path).convert("RGBA")
    arr8 = np.asarray(img, np.uint8)
    arr = arr8.astype(np.uint16)
    r5 = arr[..., 0] >> 3
    g5 = arr[..., 1] >> 3
    b5 = arr[..., 2] >> 3
    c15 = ((r5 << 10) | (g5 << 5) | b5).astype(np.uint16)
    c15 = np.where(arr[..., 3] == 0, np.uint16(0), c15)
    rgba8 = arr8.copy()
    rgba8[..., :3] &= 0xF8
    return PackTexture(name, c15, rgba8=rgba8)


def load_texture_pack(pack_dir) -> List[PackTexture]:
    """One pack directory, PNGs sorted by path (texture_pack.rs:16-50)."""
    paths = sorted(
        os.path.join(pack_dir, f) for f in os.listdir(pack_dir)
        if f.lower().endswith(".png"))
    return [load_png_pack_texture(p) for p in paths]


def load_texture_packs(root, pack_names: Optional[Sequence[str]] = None
                       ) -> List[PackTexture]:
    """Concatenate packs (main.rs:812 gathers all loaded packs in order)."""
    if pack_names is None:
        pack_names = sorted(
            d for d in os.listdir(root)
            if os.path.isdir(os.path.join(root, d)))
    textures: List[PackTexture] = []
    for name in pack_names:
        textures.extend(load_texture_pack(os.path.join(root, name)))
    return textures


def make_resolver(textures: Sequence[PackTexture]):
    """game/renderer.rs:104-112 — name -> (index, width); invalid -> (0, 64)."""
    by_name: Dict[str, Tuple[int, int]] = {}
    for i, t in enumerate(textures):
        by_name.setdefault(t.name, (i, t.width))

    def resolve(tex_ref) -> Optional[Tuple[int, int]]:
        if not getattr(tex_ref, "is_valid", False):
            return (0, 64)
        return by_name.get(tex_ref.name)

    return resolve


def with_user_textures(textures: Sequence[PackTexture],
                       user_textures) -> List[PackTexture]:
    """main.rs:495-507 — pack textures first, user textures appended
    (resolved by name; live edits show in the 3D view on recompile)."""
    out = list(textures)
    for t in user_textures:
        out.append(PackTexture(t.name, np.asarray(t.to_texture15())))
    return out
