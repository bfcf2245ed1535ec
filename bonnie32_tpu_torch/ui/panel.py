"""Resizable split panels + panel chrome (ui/panel.rs).
(The port's own copy of the JAX package's `ui/panel.py`, host code.)

SplitPanel divides a rect into two children around a draggable divider
(`/root/reference/src/ui/panel.rs:16-161`); draw_panel / collapsible
panels render the chrome into the UiContext draw queue, which paint()
rasterizes into the framebuffer (headless equivalent of macroquad's
immediate draw calls)."""

import dataclasses
import enum
from typing import Optional, Tuple

from .context import UiContext
from .rect import Rect

DIVIDER_IDLE = (60, 60, 60)
DIVIDER_HOT = (100, 150, 255)
PANEL_BORDER = (80, 80, 80)
TITLE_BG = (50, 50, 60)
TITLE_BG_HOVER = (60, 60, 70)
TITLE_HEIGHT = 20.0
COLLAPSED_PANEL_HEIGHT = 20.0


class SplitDir(enum.Enum):
    HORIZONTAL = "horizontal"   # Left | Right
    VERTICAL = "vertical"       # Top / Bottom


@dataclasses.dataclass
class SplitPanel:
    """panel.rs:16 — ratio-split with min-size clamped divider drags."""

    id: str
    dir: SplitDir
    ratio: float = 0.5
    min_size: float = 50.0
    divider_size: float = 4.0

    @classmethod
    def horizontal(cls, pid: str) -> "SplitPanel":
        return cls(pid, SplitDir.HORIZONTAL)

    @classmethod
    def vertical(cls, pid: str) -> "SplitPanel":
        return cls(pid, SplitDir.VERTICAL)

    def with_ratio(self, ratio: float) -> "SplitPanel":
        self.ratio = min(max(ratio, 0.0), 1.0)
        return self

    def with_min_size(self, min_size: float) -> "SplitPanel":
        self.min_size = min_size
        return self

    # --- geometry (panel.rs:110-161) ---

    def _clamp_ratio(self, ratio: float, total: float) -> float:
        if total <= 0:
            return 0.5
        min_ratio = self.min_size / total
        return min(max(ratio, min_ratio), 1.0 - min_ratio)

    def divider_rect(self, bounds: Rect) -> Rect:
        if self.dir == SplitDir.HORIZONTAL:
            x = bounds.x + bounds.w * self.ratio - self.divider_size * 0.5
            return Rect(x, bounds.y, self.divider_size, bounds.h)
        y = bounds.y + bounds.h * self.ratio - self.divider_size * 0.5
        return Rect(bounds.x, y, bounds.w, self.divider_size)

    def layout(self, bounds: Rect) -> Tuple[Rect, Rect]:
        half = self.divider_size * 0.5
        if self.dir == SplitDir.HORIZONTAL:
            split = bounds.w * self.ratio
            return (Rect(bounds.x, bounds.y, split - half, bounds.h),
                    Rect(bounds.x + split + half, bounds.y,
                         bounds.w - split - half, bounds.h))
        split = bounds.h * self.ratio
        return (Rect(bounds.x, bounds.y, bounds.w, split - half),
                Rect(bounds.x, bounds.y + split + half, bounds.w,
                     bounds.h - split - half))

    # --- input + divider draw (panel.rs:61-101) ---

    def handle_input(self, ctx: UiContext, bounds: Rect) -> None:
        div = self.divider_rect(bounds)
        wid = f"split:{self.id}"
        # widgets inside panels claim drags first (call order does this:
        # handle_input comes after content widgets ran)
        can_interact = ctx.active is None
        hot = False
        if can_interact and div.contains(ctx.mouse.x, ctx.mouse.y):
            hot = True
            ctx.hot = wid
            if ctx.mouse.pressed:
                ctx.active = wid
        if ctx.active == wid and ctx.mouse.down:
            if self.dir == SplitDir.HORIZONTAL:
                new_ratio = (ctx.mouse.x - bounds.x) / max(bounds.w, 1e-6)
                self.ratio = self._clamp_ratio(new_ratio, bounds.w)
            else:
                new_ratio = (ctx.mouse.y - bounds.y) / max(bounds.h, 1e-6)
                self.ratio = self._clamp_ratio(new_ratio, bounds.h)
        dragging = ctx.active == wid
        ctx.fill(self.divider_rect(bounds),
                 DIVIDER_HOT if (hot or dragging) else DIVIDER_IDLE)

    def update(self, ctx: UiContext, bounds: Rect) -> Tuple[Rect, Rect]:
        self.handle_input(ctx, bounds)
        return self.layout(bounds)


def draw_panel(ctx: UiContext, rect: Rect, title: Optional[str],
               bg_color) -> None:
    """panel.rs:163-182 — background, border, optional title bar."""
    ctx.fill(rect, bg_color)
    ctx.outline(rect, PANEL_BORDER)
    if title is not None:
        ctx.fill(Rect(rect.x, rect.y, rect.w, TITLE_HEIGHT), TITLE_BG)
        ctx.text(rect.x + 5, rect.y + 7, title, (255, 255, 255))


def panel_content_rect(rect: Rect, has_title: bool) -> Rect:
    """panel.rs:185-191."""
    if has_title:
        return rect.remaining_after_top(TITLE_HEIGHT).pad(2.0)
    return rect.pad(2.0)


def draw_collapsible_panel(ctx: UiContext, rect: Rect, title: str,
                           collapsed: bool, bg_color
                           ) -> Tuple[bool, Optional[Rect]]:
    """panel.rs:198-266 — header with collapse indicator; returns
    (header_clicked, content_rect or None when collapsed)."""
    header = Rect(rect.x, rect.y, rect.w, TITLE_HEIGHT)
    hovered = header.contains(ctx.mouse.x, ctx.mouse.y)
    ctx.fill(header, TITLE_BG_HOVER if hovered else TITLE_BG)
    # collapse indicator (> collapsed, v expanded)
    ctx.text(rect.x + 4, rect.y + 7, ">" if collapsed else "v",
             (180, 180, 180))
    ctx.text(rect.x + 16, rect.y + 7, title, (255, 255, 255))
    clicked = hovered and ctx.mouse.pressed
    if collapsed:
        ctx.outline(header, PANEL_BORDER)
        return clicked, None
    ctx.fill(Rect(rect.x, rect.y + TITLE_HEIGHT, rect.w,
                  rect.h - TITLE_HEIGHT), bg_color)
    ctx.outline(rect, PANEL_BORDER)
    content = Rect(rect.x + 2, rect.y + TITLE_HEIGHT + 2,
                   rect.w - 4, rect.h - TITLE_HEIGHT - 4)
    return clicked, content
