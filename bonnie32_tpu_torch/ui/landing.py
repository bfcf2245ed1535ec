"""Landing screen: wrapped-text sections, FAQ, link rows, scrolling.
(The port's own copy of the JAX package's `ui/landing.py`; it paints
through the port's ops/draw2d on the framebuffer's device.)

Port of `/root/reference/src/landing.rs`: greedy word wrapping against
a pixel budget (:5-45), the scroll-clamped content column with centered
max-width layout (:70-80), section and FAQ-item boxes (:186-260), and
the hoverable link row (ui/widgets.rs:203) — all painting into the
shared framebuffer with the 5x7 bitmap font.
"""

import dataclasses
from typing import List, Optional, Sequence, Tuple

from . import font
from .rect import Rect

# landing.rs:47-51 (Color → RGB8)
BG_COLOR = (25, 25, 31)
TEXT_COLOR = (229, 229, 229)
MUTED_COLOR = (153, 153, 166)
ACCENT_COLOR = (0, 191, 229)
SECTION_BG = (31, 31, 36)

LINE_HEIGHT = 11
TITLE_HEIGHT = 13
SECTION_PAD = 8
SECTION_GAP = 10

SECTIONS: Tuple[Tuple[str, str], ...] = (
    ("What is this?",
     "A TPU-native fantasy console for PS1-era 3D games. Model, texture, "
     "compose music, and build levels in one place.\n\nThe software "
     "rasterizer reproduces the classic PS1 quirks - affine texture "
     "mapping, vertex snapping, limited color depth - and every effect "
     "can be toggled on or off. Rendering, game simulation, and batched "
     "data generation all run as XLA programs."),
    ("Where to start",
     "Use the tabs at the top to switch tools:\n\nWorld - sector-based "
     "level editor with a 2D grid view, 3D preview, and portals.\n\n"
     "Assets - a low-poly mesh modeler with extrusion, multi-object "
     "editing, and a shared texture atlas.\n\nPaint - indexed textures "
     "with limited palettes, 4-bit or 8-bit color depth, and dithering."
     "\n\nMusic - a pattern-based tracker with SF2 soundfonts, up to 8 "
     "channels, and classic effects like arpeggio and vibrato."),
)

FAQ: Tuple[Tuple[str, str], ...] = (
    ("Is this a game or a tool?",
     "Both - a complete toolkit plus a runtime for shipping games made "
     "with it, in the tradition of fantasy consoles."),
    ("Why a software rasterizer?",
     "True PS1-style rendering means embracing the limitations rather "
     "than simulating them on top of a modern pipeline."),
)

LINKS: Tuple[Tuple[str, str], ...] = (
    ("GitHub", "https://github.com/EBonura/bonnie-32"),
    ("itch.io", "https://bonnie-games.itch.io/"),
)


def wrap_text(text: str, max_width: int, scale: int = 1) -> List[str]:
    """landing.rs:5 — greedy per-paragraph word wrap; a word longer than
    the budget gets its own line."""
    lines: List[str] = []
    for paragraph in text.split("\n"):
        words = paragraph.split()
        if not words:
            lines.append("")
            continue
        current = ""
        for word in words:
            test = word if not current else f"{current} {word}"
            if font.text_size(test, scale)[0] <= max_width or not current:
                current = test
            else:
                lines.append(current)
                current = word
        if current:
            lines.append(current)
    return lines


@dataclasses.dataclass
class LandingState:
    """landing.rs:54 — scroll position (clamped to content height)."""

    scroll_y: float = 0.0
    max_scroll: float = 0.0

    def scroll(self, delta: float) -> None:
        self.scroll_y = min(max(self.scroll_y + delta * 3.0,
                                self.max_scroll), 0.0)


class _FbPainter:
    """Paints straight into FrameBuffers via ops/draw2d."""

    def __init__(self, fb):
        self.fb = fb

    def fill(self, x0, y0, x1, y1, rgb):
        from ..ops import draw2d
        self.fb = draw2d.draw_filled_rect(self.fb, int(x0), int(y0),
                                          int(x1), int(y1), rgb)

    def text(self, x, y, s, rgb, scale=1):
        from ..ops import draw2d
        self.fb = draw2d.draw_text(self.fb, int(x), int(y), s, rgb,
                                   scale=scale)


class _CtxPainter:
    """Queues through a UiContext (frame.py's command-replay path)."""

    def __init__(self, ctx):
        self.ctx = ctx

    def fill(self, x0, y0, x1, y1, rgb):
        self.ctx.fill(Rect(x0, y0, x1 - x0 + 1, y1 - y0 + 1), rgb)

    def text(self, x, y, s, rgb, scale=1):
        self.ctx.text(x, y, s, rgb, scale=scale)


def _section_height(text: str, text_width: int) -> int:
    lines = wrap_text(text, text_width)
    return TITLE_HEIGHT + SECTION_PAD + len(lines) * LINE_HEIGHT \
        + SECTION_PAD


def _draw_section(p, x: int, y: int, width: int, title: str,
                  text: str) -> int:
    """landing.rs:186 — boxed section: accent title + wrapped body."""
    text_x = x + SECTION_PAD
    text_width = width - SECTION_PAD * 2
    lines = wrap_text(text, text_width)
    h = _section_height(text, text_width)
    p.fill(x, y, x + width - 1, y + h - 1, SECTION_BG)
    p.text(text_x, y + SECTION_PAD, title, ACCENT_COLOR)
    ty = y + SECTION_PAD + TITLE_HEIGHT
    for line in lines:
        if line:
            p.text(text_x, ty, line, TEXT_COLOR)
        ty += LINE_HEIGHT
    return y + h + SECTION_GAP


def _link_row(p, x: int, y: int, links: Sequence[Tuple[str, str]],
              separator: str = " | ",
              mouse: Optional[Tuple[float, float]] = None):
    cursor_x = x
    sep_w = font.text_size(separator)[0] + 1
    rects: List[Tuple[Rect, str]] = []
    hovered: Optional[str] = None
    for i, (text, url) in enumerate(links):
        if i > 0:
            p.text(cursor_x, y, separator, MUTED_COLOR)
            cursor_x += sep_w
        w = font.text_size(text)[0] + 1
        r = Rect(cursor_x, y, w, font.GLYPH_H)
        is_hover = (mouse is not None and r.contains(*mouse))
        if is_hover:
            hovered = url
        p.text(cursor_x, y, text,
               ACCENT_COLOR if is_hover else MUTED_COLOR)
        rects.append((r, url))
        cursor_x += w
    return rects, hovered


def draw_link_row(fb, x: int, y: int, links: Sequence[Tuple[str, str]],
                  separator: str = " | ",
                  mouse: Optional[Tuple[float, float]] = None):
    """ui/widgets.rs:203 — inline links with separators; returns
    (fb, link rects, hovered url or None)."""
    p = _FbPainter(fb)
    rects, hovered = _link_row(p, x, y, links, separator, mouse)
    return p.fb, rects, hovered


def _draw_landing(p, rect: Rect, state: LandingState,
                  scroll_delta: float,
                  mouse: Optional[Tuple[float, float]],
                  version: str) -> Optional[str]:
    state.scroll(scroll_delta)
    p.fill(rect.x, rect.y, rect.x + rect.w - 1, rect.y + rect.h - 1,
           BG_COLOR)
    padding = 12
    content_width = min(int(rect.w) - padding * 2, 480)
    content_x = int(rect.x + (rect.w - content_width) // 2)
    y = int(rect.y + padding + state.scroll_y)

    title = f"BONNIE-32 v{version}"
    tw = font.text_size(title, 2)[0]
    p.text(content_x + (content_width - tw) // 2, y, title,
           ACCENT_COLOR, scale=2)
    y += font.GLYPH_H * 2 + 6
    subtitle = "A Fantasy Console for PS1-Era 3D Games"
    sw = font.text_size(subtitle)[0]
    p.text(content_x + (content_width - sw) // 2, y, subtitle,
           MUTED_COLOR)
    y += LINE_HEIGHT + SECTION_GAP

    for sec_title, sec_text in SECTIONS:
        y = _draw_section(p, content_x, y, content_width,
                          sec_title, sec_text)

    p.text(content_x, y, "FAQ", ACCENT_COLOR)
    y += TITLE_HEIGHT
    for question, answer in FAQ:
        y = _draw_section(p, content_x, y, content_width,
                          question, answer)

    p.text(content_x, y, "A TPU-native build", TEXT_COLOR)
    y += LINE_HEIGHT + 4
    _, hovered = _link_row(p, content_x, y, LINKS, mouse=mouse)
    y += LINE_HEIGHT + padding

    content_height = y - rect.y - state.scroll_y
    state.max_scroll = -max(content_height - rect.h + padding, 0.0)
    return hovered


def draw_landing(fb, rect: Rect, state: LandingState,
                 scroll_delta: float = 0.0,
                 mouse: Optional[Tuple[float, float]] = None,
                 version: str = "0.2"):
    """landing.rs:70 — the full screen: title, subtitle, sections, FAQ,
    credits + links; updates state.max_scroll from measured content.
    Returns (fb, hovered url or None)."""
    p = _FbPainter(fb)
    hovered = _draw_landing(p, rect, state, scroll_delta, mouse, version)
    return p.fb, hovered


def draw_landing_ctx(ctx, rect: Rect, state: LandingState,
                     version: str = "0.2") -> Optional[str]:
    """The frame.py path: queue through a UiContext (scroll + hover from
    the ctx's virtual mouse); returns the hovered url or None."""
    p = _CtxPainter(ctx)
    return _draw_landing(p, rect, state, ctx.mouse.wheel,
                         (ctx.mouse.x, ctx.mouse.y), version)
