"""Texture editing ("Paint"): pixel tools on indexed UserTextures.
(The port's own copy of the JAX package's `texture/__init__.py`, host
code.)

Reference: `/root/reference/src/texture/texture_editor.rs` — DrawTool
(:76), BrushShape (:98), Selection (:106), flood_fill (:889),
select_by_color (:961), editor undo (:718-783).
"""

from .paint import (BrushShape, DrawTool, PaintState, Selection,
                    draw_ellipse, draw_line, draw_rect, flood_fill,
                    paint_brush, select_by_color)
from .import_image import (ATLAS_CELL_SIZES, IMPORT_SIZES, CropResizeEdge,
                           ResizeMode, TextureImportState,
                           atlas_dimensions, extract_atlas_cell,
                           extract_selection, resize_to_target)

__all__ = ["DrawTool", "BrushShape", "Selection", "PaintState",
           "paint_brush", "flood_fill", "draw_line", "draw_rect",
           "draw_ellipse", "select_by_color",
           "TextureImportState", "ResizeMode", "CropResizeEdge",
           "IMPORT_SIZES", "ATLAS_CELL_SIZES", "resize_to_target",
           "extract_atlas_cell", "extract_selection", "atlas_dimensions"]
