"""Pixel paint tools on indexed UserTextures.
(The port's own copy of the JAX package's `texture/paint.py`, host code.)

Reference behavior: `/root/reference/src/texture/texture_editor.rs` —
DrawTool (:76), square/circle brushes sized brush_size with half offset
(:2361-2365), scanline-free stack flood fill (:889), select-by-color with
tolerance/contiguous modes (:961), rectangle/ellipse outline-or-filled,
line = brush stamped along Bresenham, editor undo snapshots (:718).

All tools operate on (index array, width, height) — numpy vectorized
where the access pattern allows.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Tuple

import numpy as np


class DrawTool(enum.Enum):
    """texture_editor.rs:76."""

    SELECT = "select"
    SELECT_BY_COLOR = "select_by_color"
    BRUSH = "brush"
    FILL = "fill"
    LINE = "line"
    RECTANGLE = "rectangle"
    ELLIPSE = "ellipse"
    EYEDROPPER = "eyedropper"

    def uses_brush_size(self) -> bool:
        return self in (DrawTool.BRUSH, DrawTool.LINE)

    def is_shape_tool(self) -> bool:
        return self in (DrawTool.RECTANGLE, DrawTool.ELLIPSE)

    def modifies_texture(self) -> bool:
        return self not in (DrawTool.SELECT, DrawTool.SELECT_BY_COLOR,
                            DrawTool.EYEDROPPER)


class BrushShape(enum.Enum):
    """texture_editor.rs:98."""

    SQUARE = "square"
    CIRCLE = "circle"


def _grid(tex) -> np.ndarray:
    return tex.indices.reshape(tex.height, tex.width)


def paint_brush(tex, x: int, y: int, index: int, size: int = 1,
                shape: BrushShape = BrushShape.SQUARE,
                mask: Optional[np.ndarray] = None) -> int:
    """Stamp the brush at (x, y).  The brush anchors like the reference's
    cursor: top-left offset by (size-1)//2.  Returns pixels changed."""
    g = _grid(tex)
    h, w = g.shape
    half = (size - 1) // 2
    x0, y0 = x - half, y - half
    ys, xs = np.mgrid[0:size, 0:size]
    px = xs + x0
    py = ys + y0
    ok = (px >= 0) & (px < w) & (py >= 0) & (py < h)
    if shape == BrushShape.CIRCLE and size > 2:
        c = (size - 1) / 2.0
        ok &= (xs - c) ** 2 + (ys - c) ** 2 <= (size / 2.0) ** 2
    if mask is not None:
        m = mask.reshape(h, w)
        sel = np.zeros_like(ok)
        sel[ok] = m[py[ok], px[ok]]
        ok &= sel
    changed = int(np.sum(g[py[ok], px[ok]] != index))
    g[py[ok], px[ok]] = index
    tex.indices = g.reshape(-1)
    return changed


def flood_fill(tex, x: int, y: int, fill_index: int) -> int:
    """texture_editor.rs:889 — 4-connected fill of the clicked index.
    Returns pixels changed."""
    g = _grid(tex)
    h, w = g.shape
    if not (0 <= x < w and 0 <= y < h):
        return 0
    target = g[y, x]
    if target == fill_index:
        return 0
    stack = [(x, y)]
    n = 0
    while stack:
        cx, cy = stack.pop()
        if not (0 <= cx < w and 0 <= cy < h) or g[cy, cx] != target:
            continue
        g[cy, cx] = fill_index
        n += 1
        stack.extend(((cx - 1, cy), (cx + 1, cy), (cx, cy - 1),
                      (cx, cy + 1)))
    tex.indices = g.reshape(-1)
    return n


def _bresenham(x0, y0, x1, y1):
    dx = abs(x1 - x0)
    dy = -abs(y1 - y0)
    sx = 1 if x0 < x1 else -1
    sy = 1 if y0 < y1 else -1
    err = dx + dy
    x, y = x0, y0
    while True:
        yield x, y
        if x == x1 and y == y1:
            return
        e2 = 2 * err
        if e2 >= dy:
            err += dy
            x += sx
        if e2 <= dx:
            err += dx
            y += sy


def draw_line(tex, x0: int, y0: int, x1: int, y1: int, index: int,
              size: int = 1,
              shape: BrushShape = BrushShape.SQUARE) -> int:
    """Line = brush stamped along Bresenham (thickness = brush size)."""
    n = 0
    for x, y in _bresenham(x0, y0, x1, y1):
        n += paint_brush(tex, x, y, index, size, shape)
    return n


def draw_rect(tex, x0: int, y0: int, x1: int, y1: int, index: int,
              filled: bool = False) -> int:
    g = _grid(tex)
    h, w = g.shape
    lx, hx = sorted((x0, x1))
    ly, hy = sorted((y0, y1))
    lx, hx = max(lx, 0), min(hx, w - 1)
    ly, hy = max(ly, 0), min(hy, h - 1)
    if lx > hx or ly > hy:
        return 0
    before = g.copy()
    if filled:
        g[ly:hy + 1, lx:hx + 1] = index
    else:
        g[ly, lx:hx + 1] = index
        g[hy, lx:hx + 1] = index
        g[ly:hy + 1, lx] = index
        g[ly:hy + 1, hx] = index
    tex.indices = g.reshape(-1)
    return int(np.sum(before != g))


def draw_ellipse(tex, x0: int, y0: int, x1: int, y1: int, index: int,
                 filled: bool = False) -> int:
    """Ellipse inscribed in the drag rectangle; outline = filled minus a
    1px-eroded interior."""
    g = _grid(tex)
    h, w = g.shape
    lx, hx = sorted((x0, x1))
    ly, hy = sorted((y0, y1))
    cx = (lx + hx) / 2.0
    cy = (ly + hy) / 2.0
    rx = max((hx - lx) / 2.0, 0.5)
    ry = max((hy - ly) / 2.0, 0.5)
    ys, xs = np.mgrid[0:h, 0:w]
    d = ((xs - cx) / rx) ** 2 + ((ys - cy) / ry) ** 2
    inside = d <= 1.0
    if filled:
        sel = inside
    else:
        inner = (((xs - cx) / max(rx - 1.0, 0.5)) ** 2
                 + ((ys - cy) / max(ry - 1.0, 0.5)) ** 2) <= 1.0
        sel = inside & ~inner
    changed = int(np.sum(g[sel] != index))
    g[sel] = index
    tex.indices = g.reshape(-1)
    return changed


def select_by_color(tex, x: int, y: int, tolerance: int = 0,
                    contiguous: bool = False) -> np.ndarray:
    """texture_editor.rs:961 — (h*w,) bool mask of palette indices within
    `tolerance` of the clicked index; `contiguous` restricts to the
    4-connected component."""
    g = _grid(tex)
    h, w = g.shape
    mask = np.zeros((h, w), bool)
    if not (0 <= x < w and 0 <= y < h):
        return mask.reshape(-1)
    target = int(g[y, x])
    matches = np.abs(g.astype(np.int32) - target) <= tolerance
    if not contiguous:
        mask = matches
    else:
        stack = [(x, y)]
        while stack:
            cx, cy = stack.pop()
            if not (0 <= cx < w and 0 <= cy < h):
                continue
            if mask[cy, cx] or not matches[cy, cx]:
                continue
            mask[cy, cx] = True
            stack.extend(((cx - 1, cy), (cx + 1, cy), (cx, cy - 1),
                          (cx, cy + 1)))
    return mask.reshape(-1)


@dataclasses.dataclass
class Selection:
    """texture_editor.rs:106 — rect selection with optional floating
    pixels (cut on move, stamped on anchor)."""

    x: int
    y: int
    w: int
    h: int
    floating: Optional[np.ndarray] = None   # (h, w) indices while moving
    mask: Optional[np.ndarray] = None       # non-rectangular selections

    @classmethod
    def from_corners(cls, x0, y0, x1, y1) -> "Selection":
        lx, hx = sorted((int(x0), int(x1)))
        ly, hy = sorted((int(y0), int(y1)))
        return cls(lx, ly, hx - lx + 1, hy - ly + 1)

    @classmethod
    def from_mask(cls, mask: np.ndarray, tex_width: int,
                  tex_height: int) -> Optional["Selection"]:
        m = mask.reshape(tex_height, tex_width)
        ys, xs = np.nonzero(m)
        if len(ys) == 0:
            return None
        sel = cls(int(xs.min()), int(ys.min()),
                  int(xs.max() - xs.min() + 1), int(ys.max() - ys.min() + 1))
        sel.mask = m.copy()
        return sel

    def contains(self, px: int, py: int) -> bool:
        if not (self.x <= px < self.x + self.w
                and self.y <= py < self.y + self.h):
            return False
        if self.mask is not None:
            return bool(self.mask[py, px])
        return True

    def is_rectangular(self) -> bool:
        return self.mask is None

    def cut(self, tex, background: int = 0) -> None:
        """Lift the selection into `floating`, clearing the source."""
        g = _grid(tex)
        region = g[self.y:self.y + self.h, self.x:self.x + self.w].copy()
        self.floating = region
        if self.mask is not None:
            sub = self.mask[self.y:self.y + self.h, self.x:self.x + self.w]
            g[self.y:self.y + self.h, self.x:self.x + self.w][sub] = background
        else:
            g[self.y:self.y + self.h, self.x:self.x + self.w] = background
        tex.indices = g.reshape(-1)

    def stamp(self, tex) -> None:
        """Write floating pixels at the current position (clipped)."""
        if self.floating is None:
            return
        g = _grid(tex)
        th, tw = g.shape
        for dy in range(self.h):
            for dx in range(self.w):
                px, py = self.x + dx, self.y + dy
                if 0 <= px < tw and 0 <= py < th:
                    if self.mask is None or self.mask_at(dx, dy):
                        g[py, px] = self.floating[dy, dx]
        tex.indices = g.reshape(-1)

    def mask_at(self, dx: int, dy: int) -> bool:
        if self.mask is None:
            return True
        # mask stored in original texture coords at cut time; after moves it
        # travels with the floating block
        sy = min(max(dy, 0), self.mask.shape[0] - 1)
        sx = min(max(dx, 0), self.mask.shape[1] - 1)
        sub = self.mask[self.y:self.y + self.h, self.x:self.x + self.w] \
            if self.mask.shape == self.floating.shape else self.mask
        if sub.shape == (self.h, self.w):
            return bool(sub[dy, dx])
        return True


class PaintState:
    """texture_editor.rs:653 — tool state + texture undo stack."""

    MAX_UNDO = 50

    def __init__(self):
        self.tool = DrawTool.BRUSH
        self.brush_shape = BrushShape.SQUARE
        self.brush_size = 3           # texture_editor.rs:586
        self.fill_shapes = False
        self.primary_index = 1
        self.selection: Optional[Selection] = None
        self.undo_stack: List[tuple] = []
        self.redo_stack: List[tuple] = []
        self.status: Optional[str] = None

    def reset(self):
        self.tool = DrawTool.BRUSH
        self.brush_size = 3
        self.selection = None

    def save_undo(self, tex, description: str = "") -> None:
        """texture_editor.rs:718 — snapshot indices + palette."""
        self.undo_stack.append((description, tex.indices.copy(),
                                list(tex.palette)))
        self.redo_stack.clear()
        if len(self.undo_stack) > self.MAX_UNDO:
            self.undo_stack.pop(0)

    def undo(self, tex) -> bool:
        if not self.undo_stack:
            return False
        desc, idx, pal = self.undo_stack.pop()
        self.redo_stack.append((desc, tex.indices.copy(), list(tex.palette)))
        tex.indices = idx
        tex.palette = pal
        return True

    def redo(self, tex) -> bool:
        if not self.redo_stack:
            return False
        desc, idx, pal = self.redo_stack.pop()
        self.undo_stack.append((desc, tex.indices.copy(), list(tex.palette)))
        tex.indices = idx
        tex.palette = pal
        return True

    def eyedrop(self, tex, x: int, y: int) -> int:
        g = _grid(tex)
        if 0 <= x < tex.width and 0 <= y < tex.height:
            self.primary_index = int(g[y, x])
        return self.primary_index
