"""UiContext: per-frame immediate-mode state + framebuffer painting (the
port's own copy of the JAX package's `ui/context.py`; `paint` replays the
queue through the port's ops/draw2d onto the framebuffer's device).

Mirrors the reference's UiContext usage (ui/widgets.rs) with a virtual
mouse: widgets are functions `(ctx, rect, ...) -> result` that test the
mouse against their rect, track hot/active ids across frames, and queue
draw commands.  `ctx.paint(fb)` replays the commands through ops/draw2d.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from .rect import Rect
from .theme import DEFAULT_THEME, Theme


@dataclasses.dataclass
class MouseState:
    x: float = 0.0
    y: float = 0.0
    down: bool = False
    pressed: bool = False   # edge: went down this frame
    released: bool = False  # edge: went up this frame
    wheel: float = 0.0
    right_down: bool = False
    double_clicked: bool = False


class UiContext:
    def __init__(self, theme: Theme = DEFAULT_THEME):
        self.theme = theme
        self.mouse = MouseState()
        self.hot: Optional[str] = None      # hovered widget id
        self.active: Optional[str] = None   # held widget id
        self.commands: List[tuple] = []     # draw queue
        self.blocked: bool = False          # modal/dropdown click blocking
        self.keys_down: frozenset = frozenset()
        self.keys_pressed: frozenset = frozenset()
        self.clip: Optional[Rect] = None    # scissor for queued commands

    # --- frame lifecycle -------------------------------------------------

    def begin_frame(self, x: float, y: float, down: bool,
                    wheel: float = 0.0, right_down: bool = False,
                    keys_down=(), keys_pressed=(),
                    double_clicked: bool = False) -> None:
        prev_down = self.mouse.down
        self.mouse = MouseState(
            x=x, y=y, down=down,
            pressed=down and not prev_down,
            released=(not down) and prev_down,
            wheel=wheel, right_down=right_down,
            double_clicked=double_clicked)
        self.hot = None
        self.commands = []
        self.blocked = False
        self.keys_down = frozenset(keys_down)
        self.keys_pressed = frozenset(keys_pressed)
        self.clip = None
        # active persists through the release frame (widgets detect the
        # click on release), then clears once the mouse has settled up
        if not down and not self.mouse.released:
            self.active = None

    def key_down(self, key: str) -> bool:
        return key in self.keys_down

    def key_pressed(self, key: str) -> bool:
        return key in self.keys_pressed

    # --- scissor (grid_view.rs:129-138 GL scissor equivalent) -----------

    def set_clip(self, rect: Optional[Rect]) -> None:
        self.clip = rect

    # --- interaction helpers ----------------------------------------------

    def hover(self, wid: str, rect: Rect) -> bool:
        if self.blocked:
            return False
        h = rect.contains(self.mouse.x, self.mouse.y)
        if h:
            self.hot = wid
        return h

    def clicked(self, wid: str, rect: Rect) -> bool:
        """Press begins on the widget, click fires on release inside."""
        h = self.hover(wid, rect)
        if h and self.mouse.pressed:
            self.active = wid
        fired = (self.active == wid and self.mouse.released and h)
        return fired

    def held(self, wid: str, rect: Rect) -> bool:
        h = self.hover(wid, rect)
        if h and self.mouse.pressed:
            self.active = wid
        return self.active == wid and self.mouse.down

    # --- draw queue ---------------------------------------------------------
    # Every command carries the clip rect active when it was queued (or
    # None); paint() applies it like the reference's GL scissor.

    def fill(self, rect: Rect, rgb, alpha: int = 255) -> None:
        self.commands.append(("fill", rect, tuple(rgb), alpha, self.clip))

    def outline(self, rect: Rect, rgb) -> None:
        self.commands.append(("outline", rect, tuple(rgb), self.clip))

    def line(self, x0, y0, x1, y1, rgb, alpha: int = 255) -> None:
        self.commands.append(("line", (x0, y0, x1, y1), tuple(rgb), alpha,
                              self.clip))

    def tri(self, x0, y0, x1, y1, x2, y2, rgb, alpha: int = 255) -> None:
        """Filled triangle (grid_view.rs sector fills via draw_triangle)."""
        self.commands.append(("tri", (x0, y0, x1, y1, x2, y2), tuple(rgb),
                              alpha, self.clip))

    def circle(self, cx, cy, radius, rgb) -> None:
        self.commands.append(("circle", (cx, cy, radius), tuple(rgb),
                              self.clip))

    def circle_lines(self, cx, cy, radius, rgb) -> None:
        """Ring: filled circle minus its interior at paint time."""
        self.commands.append(("circle_lines", (cx, cy, radius),
                              tuple(rgb), self.clip))

    def text(self, x, y, s: str, rgb=None, scale: int = 1) -> None:
        """Queue a text draw; paint() rasterizes it with the 5x7 bitmap
        font (ui/font.py) like the reference draws its ttf text into the
        frame (ui/widgets.rs)."""
        self.commands.append(("text", (x, y), s,
                              tuple(rgb or self.theme.text), scale,
                              self.clip))

    @staticmethod
    def _clip_seg(x0, y0, x1, y1, clip: Rect):
        """Liang-Barsky segment/rect clip; returns clipped ints or None."""
        dx, dy = x1 - x0, y1 - y0
        t0, t1 = 0.0, 1.0
        # right/bottom are exclusive (Rect.contains): last pixel column is
        # right-1, so clip just inside the boundary
        for p, q in ((-dx, x0 - clip.x), (dx, clip.right - 0.001 - x0),
                     (-dy, y0 - clip.y), (dy, clip.bottom - 0.001 - y0)):
            if p == 0:
                if q < 0:
                    return None
                continue
            r = q / p
            if p < 0:
                if r > t1:
                    return None
                t0 = max(t0, r)
            else:
                if r < t0:
                    return None
                t1 = min(t1, r)
        return (x0 + t0 * dx, y0 + t0 * dy, x0 + t1 * dx, y0 + t1 * dy)

    def paint(self, fb):
        """Replay the queue into a FrameBuffers (I, H, W) via ops/draw2d,
        on the framebuffer's device: every command draws the same into
        each instance."""
        from ..ops import draw2d

        def _clip4(clip):
            return (None if clip is None
                    else (clip.x, clip.y, clip.right, clip.bottom))

        def isect(r: Rect, clip) -> Optional[Rect]:
            if clip is None:
                return r
            x = max(r.x, clip.x)
            y = max(r.y, clip.y)
            right = min(r.right, clip.right)
            bottom = min(r.bottom, clip.bottom)
            if right <= x or bottom <= y:
                return None
            return Rect(x, y, right - x, bottom - y)

        for cmd in self.commands:
            if cmd[0] == "fill":
                _, r, rgb, alpha, clip = cmd
                r = isect(r, clip)
                if r is None:
                    continue
                fb = draw2d.draw_filled_rect(fb, int(r.x), int(r.y),
                                             int(r.right) - 1,
                                             int(r.bottom) - 1, rgb,
                                             alpha=alpha)
            elif cmd[0] == "outline":
                _, r, rgb, clip = cmd
                if isect(r, clip) is None:
                    continue
                fb = draw2d.draw_rect(fb, int(r.x), int(r.y),
                                      int(r.right) - 1, int(r.bottom) - 1,
                                      rgb)
            elif cmd[0] == "line":
                _, (x0, y0, x1, y1), rgb, alpha, clip = cmd
                if clip is not None:
                    seg = self._clip_seg(float(x0), float(y0), float(x1),
                                         float(y1), clip)
                    if seg is None:
                        continue
                    x0, y0, x1, y1 = seg
                ex, ey = [[int(x0), int(x1)]], [[int(y0), int(y1)]]
                if alpha >= 255:
                    fb = draw2d.draw_lines(fb, ex, ey, rgb)
                else:
                    fb = draw2d.draw_lines_alpha(fb, ex, ey, rgb, alpha)
            elif cmd[0] == "tri":
                _, pts, rgb, alpha, clip = cmd
                fb = draw2d.draw_filled_triangle(
                    fb, *[float(v) for v in pts], rgb, alpha=alpha,
                    clip=(None if clip is None else
                          (clip.x, clip.y, clip.right, clip.bottom)))
            elif cmd[0] == "circle":
                _, (cx, cy, radius), rgb, clip = cmd
                fb = draw2d.draw_circle(fb, int(cx), int(cy),
                                        int(radius), rgb,
                                        clip=_clip4(clip))
            elif cmd[0] == "circle_lines":
                _, (cx, cy, radius), rgb, clip = cmd
                fb = draw2d.draw_circle_outline(fb, int(cx), int(cy),
                                                int(radius), rgb,
                                                clip=_clip4(clip))
            elif cmd[0] == "text":
                _, (x, y), s, rgb, scale, clip = cmd
                fb = draw2d.draw_text(fb, int(x), int(y), s, rgb,
                                      scale=scale, clip=_clip4(clip))
            elif cmd[0] == "image":
                _, (x, y), words = cmd[:3]
                fb = draw2d.draw_image(fb, int(x), int(y), words)
        return fb
