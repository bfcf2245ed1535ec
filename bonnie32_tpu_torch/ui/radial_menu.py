"""Hold-to-show radial menu (modeler/radial_menu.rs).
(The port's own copy of the JAX package's `ui/radial_menu.py`, host code.)

Segment hit-testing, nested submenu navigation, and drawing through the
UiContext queue: the 16-sided background polygon, segment dividers,
highlighted labels, and the center cancel / back-exit zones match
`/root/reference/src/modeler/radial_menu.rs:59-310`.
"""

import dataclasses
import math
from typing import List, Optional, Tuple

from .context import UiContext

TWO_PI = math.pi * 2.0


@dataclasses.dataclass
class RadialMenuItem:
    """radial_menu.rs:17-56."""

    id: str
    label: str
    children: List["RadialMenuItem"] = dataclasses.field(
        default_factory=list)
    enabled: bool = True

    def with_children(self, children) -> "RadialMenuItem":
        self.children = list(children)
        return self

    def disabled(self) -> "RadialMenuItem":
        self.enabled = False
        return self


@dataclasses.dataclass
class RadialMenuConfig:
    """radial_menu.rs:139-168."""

    inner_radius: float = 24.0
    outer_radius: float = 80.0
    bg_color: Tuple[int, int, int] = (30, 30, 38)
    border_color: Tuple[int, int, int] = (90, 90, 110)
    highlight_color: Tuple[int, int, int] = (70, 90, 140)
    text_color: Tuple[int, int, int] = (220, 220, 230)
    disabled_color: Tuple[int, int, int] = (110, 110, 120)


@dataclasses.dataclass
class RadialMenuState:
    """radial_menu.rs:59-137."""

    is_open: bool = False
    center: Tuple[float, float] = (0.0, 0.0)
    highlighted: Optional[int] = None
    items: List[RadialMenuItem] = dataclasses.field(default_factory=list)
    menu_stack: List[List[RadialMenuItem]] = dataclasses.field(
        default_factory=list)
    selected_id: Optional[str] = None

    def open(self, x: float, y: float, items) -> None:
        self.is_open = True
        self.center = (x, y)
        self.items = list(items)
        self.highlighted = None
        self.selected_id = None
        self.menu_stack.clear()

    def close(self, select: bool) -> Optional[str]:
        self.is_open = False
        if select and self.highlighted is not None \
                and self.highlighted < len(self.items):
            item = self.items[self.highlighted]
            if item.enabled:
                self.selected_id = item.id
                return self.selected_id
        self.selected_id = None
        return None

    def take_selected(self) -> Optional[str]:
        s = self.selected_id
        self.selected_id = None
        return s

    def enter_submenu(self, idx: int) -> None:
        if idx < len(self.items) and self.items[idx].children:
            self.menu_stack.append(self.items)
            self.items = list(self.items[idx].children)
            self.highlighted = None

    def back(self) -> bool:
        if self.menu_stack:
            self.items = self.menu_stack.pop()
            self.highlighted = None
            return True
        return False


def segment_at(state: RadialMenuState, config: RadialMenuConfig,
               mouse_x: float, mouse_y: float) -> Optional[int]:
    """radial_menu.rs:185-202 — which segment the mouse highlights
    (None = center cancel zone or outside the 1.5x ring)."""
    cx, cy = state.center
    dx = mouse_x - cx
    dy = mouse_y - cy
    dist = math.hypot(dx, dy)
    if dist < config.inner_radius:
        return None
    if dist >= config.outer_radius * 1.5:
        return state.highlighted   # unchanged beyond the ring
    n = len(state.items)
    if n == 0:
        return None
    angle = math.atan2(dy, dx)
    normalized = (angle + math.pi * 0.5 + TWO_PI) % TWO_PI
    return int(normalized / (TWO_PI / n)) % n


def draw_radial_menu(ctx: UiContext, state: RadialMenuState,
                     config: RadialMenuConfig, mouse_x: float,
                     mouse_y: float) -> None:
    """Update the highlight from the mouse and queue the menu's draw
    (radial_menu.rs:172-310); selection fires via state.close(True)."""
    if not state.is_open or not state.items:
        return
    state.highlighted = segment_at(state, config, mouse_x, mouse_y)

    cx, cy = state.center
    # 16-sided background polygon outline (radial_menu.rs:206)
    pts = [(cx + math.cos(a) * config.outer_radius,
            cy + math.sin(a) * config.outer_radius)
           for a in (TWO_PI * i / 16 + math.pi / 16 for i in range(16))]
    for i in range(16):
        x0, y0 = pts[i]
        x1, y1 = pts[(i + 1) % 16]
        ctx.line(x0, y0, x1, y1, config.border_color)

    n = len(state.items)
    seg = TWO_PI / n
    for i, item in enumerate(state.items):
        start = -math.pi * 0.5 + i * seg
        mid = start + seg * 0.5
        # divider line
        ctx.line(cx + math.cos(start) * config.inner_radius,
                 cy + math.sin(start) * config.inner_radius,
                 cx + math.cos(start) * config.outer_radius,
                 cy + math.sin(start) * config.outer_radius,
                 config.border_color)
        label_dist = (config.inner_radius + config.outer_radius) * 0.55
        lx = cx + math.cos(mid) * label_dist
        ly = cy + math.sin(mid) * label_dist
        color = config.highlight_color if state.highlighted == i else (
            config.text_color if item.enabled else config.disabled_color)
        ctx.text(lx - len(item.label) * 3, ly - 3, item.label, color)
