"""Texture import: image → resize → quantize → indexed texture.
(The port's own copy of the JAX package's `texture/import_image.py`, host
code.)

Port of `/root/reference/src/texture/import.rs`: the import state
machine (source image, target size, resize mode, quantizer knobs,
atlas-cell / crop-rect source selection), the three resize modes
(Fit & Pad, Stretch, Crop — Lanczos-filtered like the reference's
`image` crate calls), atlas-cell extraction, and preview generation
through the shared median-cut quantizer — finalizing into a
`UserTexture` for the paint tool's library.
"""

import dataclasses
import enum
from typing import List, Optional, Tuple

import numpy as np

from ..models.mesh import depth_colors
from ..models.quantize import (QuantizeOptions, count_unique_colors,
                               quantize_image)
from ..models.user_texture import UserTexture

# import.rs:8-13 / :40
IMPORT_SIZES = (32, 64, 128, 256)
ATLAS_CELL_SIZES = (32, 64, 128, 256)


class ResizeMode(enum.Enum):
    """import.rs:16 — how a non-square source maps onto the target."""

    FIT_PAD = "fit_pad"
    STRETCH = "stretch"
    CROP_CENTER = "crop_center"

    @property
    def label(self) -> str:
        return {ResizeMode.FIT_PAD: "Fit & Pad",
                ResizeMode.STRETCH: "Stretch",
                ResizeMode.CROP_CENTER: "Crop"}[self]


def _lanczos_resize(rgba: np.ndarray, w: int, h: int) -> np.ndarray:
    """(H,W,4) u8 → (h,w,4) u8, Lanczos like import.rs's FilterType."""
    from PIL import Image

    img = Image.fromarray(rgba, "RGBA").resize((w, h), Image.LANCZOS)
    return np.asarray(img, np.uint8)


def resize_to_target(rgba: np.ndarray, target: int,
                     mode: ResizeMode) -> np.ndarray:
    """import.rs:143 — (H,W,4) u8 → (target,target,4) u8."""
    rgba = np.asarray(rgba, np.uint8)
    height, width = rgba.shape[:2]
    tf = float(target)
    if mode == ResizeMode.FIT_PAD:
        scale = min(tf / width, tf / height)
        nw = max(int(round(width * scale)), 1)
        nh = max(int(round(height * scale)), 1)
        scaled = _lanczos_resize(rgba, nw, nh)
        out = np.zeros((target, target, 4), np.uint8)
        ox, oy = (target - nw) // 2, (target - nh) // 2
        out[oy:oy + nh, ox:ox + nw] = scaled
        return out
    if mode == ResizeMode.STRETCH:
        return _lanczos_resize(rgba, target, target)
    # CROP_CENTER: scale so the short side covers, crop the middle
    scale = max(tf / width, tf / height)
    nw = max(int(round(width * scale)), target)
    nh = max(int(round(height * scale)), target)
    scaled = _lanczos_resize(rgba, nw, nh)
    cx, cy = (nw - target) // 2, (nh - target) // 2
    return scaled[cy:cy + target, cx:cx + target]


def atlas_dimensions(width: int, height: int,
                     cell_size: int) -> Tuple[int, int]:
    """(cols, rows) of whole cells (import.rs:213)."""
    return (width // cell_size, height // cell_size)


def extract_atlas_cell(rgba: np.ndarray, cell_size: int, col: int,
                       row: int) -> Optional[np.ndarray]:
    """One whole cell or None when out of range (import.rs:187)."""
    rgba = np.asarray(rgba, np.uint8)
    height, width = rgba.shape[:2]
    x, y = col * cell_size, row * cell_size
    if x + cell_size > width or y + cell_size > height:
        return None
    return rgba[y:y + cell_size, x:x + cell_size].copy()


def extract_selection(rgba: np.ndarray, sel: Tuple[int, int, int, int]
                      ) -> np.ndarray:
    """Crop-rect (x, y, w, h) slice (import.rs:219)."""
    x, y, w, h = sel
    return np.asarray(rgba, np.uint8)[y:y + h, x:x + w].copy()


class CropResizeEdge(enum.Enum):
    TOP = "top"
    BOTTOM = "bottom"
    LEFT = "left"
    RIGHT = "right"
    TOP_LEFT = "top_left"
    TOP_RIGHT = "top_right"
    BOTTOM_LEFT = "bottom_left"
    BOTTOM_RIGHT = "bottom_right"


@dataclasses.dataclass
class TextureImportState:
    """import.rs:43 — the import dialog's working state."""

    active: bool = False
    source_rgba: Optional[np.ndarray] = None      # (H, W, 4) u8
    target_size: int = 64
    resize_mode: ResizeMode = ResizeMode.FIT_PAD
    depth: int = 1                                 # 0=Bpp4, 1=Bpp8
    quantize_opts: QuantizeOptions = QuantizeOptions()
    unique_colors: int = 0
    preview_dirty: bool = False
    preview_indices: Optional[np.ndarray] = None   # (target²,) u8
    preview_palette: List[int] = dataclasses.field(default_factory=list)
    atlas_mode: bool = False
    atlas_cell_size: int = 64
    atlas_selected: Tuple[int, int] = (0, 0)
    crop_selection: Optional[Tuple[int, int, int, int]] = None

    def reset(self) -> None:
        fresh = TextureImportState()
        for f in dataclasses.fields(fresh):
            setattr(self, f.name, getattr(fresh, f.name))

    @property
    def source_width(self) -> int:
        return 0 if self.source_rgba is None else self.source_rgba.shape[1]

    @property
    def source_height(self) -> int:
        return 0 if self.source_rgba is None else self.source_rgba.shape[0]

    def load_image(self, rgba: np.ndarray) -> None:
        """import.rs:122 load_png_to_import_state — auto-picks Bpp4 when
        the source has ≤15 unique opaque colors (index 0 is reserved)."""
        rgba = np.asarray(rgba, np.uint8)
        assert rgba.ndim == 3 and rgba.shape[2] == 4
        self.source_rgba = rgba
        self.active = True
        self.preview_dirty = True
        self.crop_selection = None
        self.unique_colors = count_unique_colors(rgba.reshape(-1, 4))
        self.depth = 0 if self.unique_colors <= 15 else 1

    def load_png(self, path) -> None:
        from PIL import Image

        img = Image.open(path).convert("RGBA")
        self.load_image(np.asarray(img, np.uint8))

    def source_for_preview(self) -> np.ndarray:
        """Atlas cell > crop rect > whole image (import.rs:246-272)."""
        assert self.source_rgba is not None
        if self.atlas_mode:
            cell = extract_atlas_cell(self.source_rgba,
                                      self.atlas_cell_size,
                                      *self.atlas_selected)
            if cell is not None:
                return cell
            return self.source_rgba
        if self.crop_selection is not None:
            return extract_selection(self.source_rgba, self.crop_selection)
        return self.source_rgba

    def generate_preview(self) -> None:
        """import.rs:239 — resize + quantize into the preview buffers."""
        if self.source_rgba is None:
            return
        src = self.source_for_preview()
        resized = resize_to_target(src, self.target_size, self.resize_mode)
        result = quantize_image(resized, self.target_size, self.target_size,
                                depth=self.depth, name="preview",
                                opts=self.quantize_opts)
        self.preview_indices = result.texture.indices
        self.preview_palette = list(result.clut.colors)
        self.preview_dirty = False

    def finalize(self, tex_id: int, name: str) -> UserTexture:
        """Commit the preview as a library UserTexture (the accept path;
        the quantized CLUT becomes the texture's embedded palette)."""
        if self.preview_indices is None or self.preview_dirty:
            self.generate_preview()
        assert self.preview_indices is not None
        ncolors = depth_colors(self.depth)
        return UserTexture(id=tex_id, name=name,
                           width=self.target_size,
                           height=self.target_size,
                           depth=self.depth,
                           indices=np.asarray(self.preview_indices,
                                              np.uint8),
                           palette=[int(c) for c in
                                    self.preview_palette[:ncolors]])
