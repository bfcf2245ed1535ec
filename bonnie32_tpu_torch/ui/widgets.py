"""Core immediate-mode widgets (ui/widgets.rs behaviors).
(The port's own copy of the JAX package's `ui/widgets.py`, host code.)

Each widget draws into the context queue and returns its interaction
result.  Widget identity is the caller-provided id string (the reference
hashes labels; explicit ids avoid collisions).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

from .context import UiContext
from .rect import Rect


def button(ctx: UiContext, wid: str, rect: Rect, label: str = "") -> bool:
    """Click-on-release button; hover/active tint."""
    hovered = ctx.hover(wid, rect)
    clicked = ctx.clicked(wid, rect)
    if ctx.active == wid and ctx.mouse.down:
        bg = ctx.theme.widget_active
    elif hovered:
        bg = ctx.theme.widget_hover
    else:
        bg = ctx.theme.widget
    ctx.fill(rect, bg)
    ctx.outline(rect, ctx.theme.panel_border)
    if label:
        ctx.text(rect.x + 4, rect.center_y, label)
    return clicked


def checkbox(ctx: UiContext, wid: str, rect: Rect, value: bool,
             label: str = "") -> bool:
    """Returns the (possibly toggled) value."""
    box = rect.slice_left(rect.h)
    if ctx.clicked(wid, rect):
        value = not value
    ctx.fill(box, ctx.theme.widget)
    ctx.outline(box, ctx.theme.panel_border)
    if value:
        ctx.fill(box.pad(3), ctx.theme.accent)
    if label:
        ctx.text(box.right + 4, rect.center_y, label)
    return value


def slider(ctx: UiContext, wid: str, rect: Rect, value: float,
           lo: float, hi: float) -> float:
    """Horizontal drag slider; returns the new value clamped to [lo, hi]."""
    if ctx.held(wid, rect):
        t = (ctx.mouse.x - rect.x) / max(rect.w, 1e-6)
        value = lo + (hi - lo) * min(max(t, 0.0), 1.0)
    t = 0.0 if hi == lo else (value - lo) / (hi - lo)
    ctx.fill(rect, ctx.theme.slider_track)
    fill = Rect(rect.x, rect.y, rect.w * min(max(t, 0.0), 1.0), rect.h)
    ctx.fill(fill, ctx.theme.slider_fill)
    ctx.outline(rect, ctx.theme.panel_border)
    return min(max(value, min(lo, hi)), max(lo, hi))


def drag_value(ctx: UiContext, wid: str, rect: Rect, value: float,
               speed: float = 1.0, lo: Optional[float] = None,
               hi: Optional[float] = None,
               state: Optional[dict] = None) -> float:
    """Horizontal-drag numeric field (widgets.rs DragValueResult): value
    changes by mouse-x delta * speed while held.  `state` carries the last
    mouse x across frames ({} persisted by the caller)."""
    st = state if state is not None else {}
    if ctx.held(wid, rect):
        last = st.get("last_x")
        if last is not None:
            value += (ctx.mouse.x - last) * speed
        st["last_x"] = ctx.mouse.x
    else:
        st.pop("last_x", None)
    if lo is not None:
        value = max(value, lo)
    if hi is not None:
        value = min(value, hi)
    ctx.fill(rect, ctx.theme.widget)
    ctx.outline(rect, ctx.theme.panel_border)
    ctx.text(rect.x + 4, rect.center_y, f"{value:.3g}")
    return value


def label_row(ctx: UiContext, rect: Rect, label: str,
              value: str = "") -> None:
    ctx.text(rect.x, rect.center_y, label)
    if value:
        ctx.text(rect.center_x, rect.center_y, value, ctx.theme.text_dim)


def tab_bar(ctx: UiContext, wid: str, rect: Rect, labels: Sequence[str],
            active: int) -> int:
    """Horizontal tab strip (ui/tabbar.rs): equal-width tabs, click to
    switch; returns the (possibly new) active index."""
    if not labels:
        return active
    tw = rect.w / len(labels)
    for i, label in enumerate(labels):
        tr = Rect(rect.x + i * tw, rect.y, tw, rect.h)
        tid = f"{wid}.{i}"
        if ctx.clicked(tid, tr):
            active = i
        if i == active:
            ctx.fill(tr, ctx.theme.widget_active)
            ctx.fill(Rect(tr.x, tr.bottom - 2, tr.w, 2), ctx.theme.accent)
        elif ctx.hot == tid:
            ctx.fill(tr, ctx.theme.widget_hover)
        else:
            ctx.fill(tr, ctx.theme.panel)
        ctx.text(tr.x + 6, tr.center_y, label)
    ctx.outline(rect, ctx.theme.panel_border)
    return active


def toolbar(ctx: UiContext, wid: str, rect: Rect, items: Sequence[str],
            active: int, button_w: float = 28.0) -> int:
    """Icon-button strip (ui/widgets.rs Toolbar): one square-ish button per
    item, the active one accented; returns the selected index."""
    for i, label in enumerate(items):
        br = Rect(rect.x + i * button_w, rect.y, button_w, rect.h).pad(1)
        bid = f"{wid}.{i}"
        if ctx.clicked(bid, br):
            active = i
        if i == active:
            ctx.fill(br, ctx.theme.accent)
        elif ctx.hot == bid:
            ctx.fill(br, ctx.theme.widget_hover)
        else:
            ctx.fill(br, ctx.theme.widget)
        ctx.outline(br, ctx.theme.panel_border)
        ctx.text(br.center_x - 3, br.center_y, label)
    return active


def vlist(ctx: UiContext, wid: str, rect: Rect, items: Sequence[str],
          selected: Optional[int], row_h: float = 18.0,
          scroll: float = 0.0) -> Tuple[Optional[int], float]:
    """Scrollable selection list (widgets.rs ListResult): returns
    (selected index, new scroll offset)."""
    scroll = max(0.0, min(scroll - ctx.mouse.wheel * row_h,
                          max(len(items) * row_h - rect.h, 0.0)))
    ctx.fill(rect, ctx.theme.panel)
    first = int(scroll // row_h)
    visible = int(rect.h // row_h) + 1
    for i in range(first, min(first + visible, len(items))):
        row = Rect(rect.x, rect.y + i * row_h - scroll, rect.w, row_h)
        row = row.intersect(rect)
        if row.h <= 0:
            continue
        rid = f"{wid}.{i}"
        if ctx.clicked(rid, row):
            selected = i
        if i == selected:
            ctx.fill(row, ctx.theme.accent, alpha=120)
        elif ctx.hot == rid:
            ctx.fill(row, ctx.theme.widget_hover)
        ctx.text(row.x + 4, row.center_y, items[i])
    # scrollbar track + thumb when content overflows (widgets.rs:118-133)
    total_h = len(items) * row_h
    if total_h > rect.h:
        sb_w = 6.0
        sb_x = rect.right - sb_w - 2.0
        sb_h = max(rect.h / total_h * rect.h, 20.0)
        max_scroll = total_h - rect.h
        sb_y = rect.y + (scroll / max_scroll) * (rect.h - sb_h)
        ctx.fill(Rect(sb_x, rect.y, sb_w, rect.h), (20, 20, 26))
        ctx.fill(Rect(sb_x, sb_y, sb_w, sb_h), (77, 77, 89))
    ctx.outline(rect, ctx.theme.panel_border)
    return selected, scroll


# =============================================================================
# Dropdown menu system (widgets.rs:2084-2290)
# =============================================================================

class DropdownState:
    """widgets.rs:2084 — one instance per screen; at most one open menu."""

    def __init__(self):
        self.active: Optional[str] = None
        self.trigger_rect: Optional[Rect] = None

    def is_open(self, wid: str) -> bool:
        return self.active == wid

    def is_any_open(self) -> bool:
        return self.active is not None

    def open(self, wid: str, trigger_rect: Rect) -> None:
        self.active = wid
        self.trigger_rect = trigger_rect

    def close(self) -> None:
        self.active = None
        self.trigger_rect = None

    def toggle(self, wid: str, trigger_rect: Rect) -> None:
        if self.is_open(wid):
            self.close()
        else:
            self.open(wid, trigger_rect)


def dropdown_block_clicks(ctx: UiContext, dropdown: DropdownState) -> None:
    """widgets.rs:2133 — while a menu is open, swallow presses everywhere
    except its trigger so underlying widgets don't react."""
    if dropdown.is_any_open():
        on_trigger = (dropdown.trigger_rect is not None
                      and dropdown.trigger_rect.contains(ctx.mouse.x,
                                                         ctx.mouse.y))
        if not on_trigger:
            ctx.mouse.pressed = False


def dropdown_trigger(ctx: UiContext, rect: Rect, current_value: str) -> bool:
    """widgets.rs:2153 — value + chevron button; True on press."""
    hovered = rect.contains(ctx.mouse.x, ctx.mouse.y)
    ctx.fill(rect, ctx.theme.widget_hover if hovered else ctx.theme.widget)
    ctx.outline(rect, ctx.theme.panel_border)
    ctx.text(rect.x + 4, rect.center_y, current_value)
    ctx.text(rect.right - 12, rect.center_y, "v", ctx.theme.text_dim)
    return hovered and ctx.mouse.pressed


def begin_dropdown(ctx: UiContext, dropdown: DropdownState, wid: str,
                   menu_rect: Rect) -> bool:
    """widgets.rs:2183 — draw the open menu background; close on outside
    click.  Returns True when the menu body should be drawn."""
    if not dropdown.is_open(wid):
        return False
    ctx.fill(menu_rect, ctx.theme.panel)
    ctx.outline(menu_rect, ctx.theme.panel_border)
    click_outside = (ctx.mouse.pressed
                     and not menu_rect.contains(ctx.mouse.x, ctx.mouse.y)
                     and not (dropdown.trigger_rect is not None
                              and dropdown.trigger_rect.contains(
                                  ctx.mouse.x, ctx.mouse.y)))
    if click_outside:
        dropdown.close()
        return False
    return True


def dropdown_item(ctx: UiContext, item_rect: Rect, label: str,
                  icon: Optional[str] = None,
                  is_selected: bool = False) -> bool:
    """widgets.rs:2220 — one menu row; True on press."""
    hovered = item_rect.contains(ctx.mouse.x, ctx.mouse.y)
    if hovered:
        ctx.fill(item_rect, ctx.theme.widget_hover)
    text_x = item_rect.x + 4
    if icon:
        ctx.text(item_rect.x + 4, item_rect.center_y, icon)
        text_x = item_rect.x + 22
    rgb = ctx.theme.accent if is_selected else ctx.theme.text
    ctx.text(text_x, item_rect.center_y, label, rgb)
    if is_selected:
        ctx.text(item_rect.right - 14, item_rect.center_y, "*",
                 ctx.theme.accent)
    return hovered and ctx.mouse.pressed


def dropdown_menu_rect(trigger_rect: Rect, item_count: int,
                       item_height: float = 20.0,
                       menu_width: Optional[float] = None) -> Rect:
    """widgets.rs:2273 — menu box below the trigger."""
    width = menu_width if menu_width is not None else trigger_rect.w
    return Rect(trigger_rect.x, trigger_rect.bottom + 2.0, width,
                item_count * item_height + 4.0)


def dropdown(ctx: UiContext, dropdown_state: DropdownState, wid: str,
             rect: Rect, items: Sequence[str], selected: int,
             item_height: float = 20.0) -> Optional[int]:
    """Composed trigger+menu convenience: returns the newly-picked index
    or None.  (The reference composes the primitives per call site; this
    wrapper covers the common pattern.)"""
    label = items[selected] if 0 <= selected < len(items) else ""
    if dropdown_trigger(ctx, rect, label):
        dropdown_state.toggle(wid, rect)
    menu = dropdown_menu_rect(rect, len(items), item_height)
    picked = None
    if begin_dropdown(ctx, dropdown_state, wid, menu):
        for i, item in enumerate(items):
            ir = Rect(menu.x + 2, menu.y + 2 + i * item_height,
                      menu.w - 4, item_height)
            if dropdown_item(ctx, ir, item, is_selected=(i == selected)):
                picked = i
                dropdown_state.close()
    return picked


# =============================================================================
# PS1 color pickers (widgets.rs:1252-1975)
# =============================================================================

PS1_PRESETS = [(31, 31, 31), (0, 0, 0), (31, 0, 0), (0, 31, 0),
               (0, 0, 31), (31, 31, 0), (0, 31, 31), (31, 0, 31)]
BLEND_MODE_LABELS = ["AVG", "ADD", "SUB", "+25%"]  # types.rs blend modes


def _expand5(v: int) -> int:
    return (v << 3) | (v >> 2)


def _from_ps1(r5: int, g5: int, b5: int) -> Tuple[int, int, int]:
    return (_expand5(r5), _expand5(g5), _expand5(b5))


def ps1_color_picker(ctx: UiContext, wid: str, x: float, y: float,
                     width: float, current: Tuple[int, int, int],
                     default: Tuple[int, int, int], label: str,
                     state: dict) -> Tuple[Optional[Tuple[int, int, int]],
                                           bool]:
    """widgets.rs:1280 draw_ps1_color_picker — swatch + three 5-bit RGB
    sliders + preset row.  `state` persists the active-slider index across
    frames (the reference's `active_slider: &mut Option<usize>`).
    Returns (new color or None, dragging)."""
    changed: Optional[Tuple[int, int, int]] = None
    active = False
    swatch = 32.0
    slider_h, gap = 10.0, 1.0
    label_w, value_w = 16.0, 20.0
    slider_x = x + swatch + 8.0 + label_w
    slider_w = width - swatch - 8.0 - label_w - value_w - 4.0

    if label:
        ctx.text(x, y - 10, label, ctx.theme.text_dim)
    ctx.fill(Rect(x, y, swatch, swatch), (60, 60, 65))
    ctx.fill(Rect(x + 1, y + 1, swatch - 2, swatch - 2), current)

    vals = [current[0] >> 3, current[1] >> 3, current[2] >> 3]
    tints = [(204, 51, 51), (51, 204, 51), (51, 102, 230)]
    start_y = y + (swatch - (3 * slider_h + 2 * gap)) / 2.0
    for i, name in enumerate("RGB"):
        sy = start_y + i * (slider_h + gap)
        ctx.text(x + swatch + 8, sy + 2, name)
        track = Rect(slider_x, sy, slider_w, slider_h)
        ctx.fill(track, (38, 38, 46))
        fill_w = vals[i] / 31.0 * slider_w
        ctx.fill(Rect(track.x, track.y, fill_w, track.h), tints[i])
        ctx.fill(Rect(track.x + fill_w - 1, track.y, 3, track.h),
                 (255, 255, 255))
        ctx.text(slider_x + slider_w + 4, sy + 2, f"{vals[i]:2d}")

        hovered = track.contains(ctx.mouse.x, ctx.mouse.y)
        if hovered and ctx.mouse.double_clicked:
            # double-click resets the channel to the default color
            vals[i] = default[i] >> 3
            changed = _from_ps1(*vals)
            state.pop(wid, None)
        else:
            if hovered and ctx.mouse.pressed:
                state[wid] = i
            if state.get(wid) == i and ctx.mouse.down:
                active = True
                rel = min(max(ctx.mouse.x - track.x, 0.0), slider_w)
                vals[i] = int(round(rel / slider_w * 31.0))
                changed = _from_ps1(*vals)
        if state.get(wid) == i and not ctx.mouse.down:
            state.pop(wid, None)

    # preset row (widgets.rs:1408-1446)
    py = y + swatch + 6.0
    psz, psp, plabel_w = 14.0, 2.0, 42.0
    ctx.text(x, py + 4, "Presets", ctx.theme.text_dim)
    for i, p5 in enumerate(PS1_PRESETS):
        pr = Rect(x + plabel_w + i * (psz + psp), py, psz, psz)
        ctx.fill(pr, (60, 60, 65))
        ctx.fill(pr.pad(1), _from_ps1(*p5))
        if pr.contains(ctx.mouse.x, ctx.mouse.y) and ctx.mouse.pressed:
            changed = _from_ps1(*p5)
    return changed, active


def ps1_color_picker_height() -> float:
    """widgets.rs:1448."""
    return 52.0


def ps1_color_picker_with_alpha(ctx: UiContext, wid: str, x: float,
                                y: float, width: float,
                                current: Tuple[int, int, int], alpha: int,
                                default: Tuple[int, int, int], label: str,
                                state: dict):
    """widgets.rs:1464 — RGB picker + a 0-255 alpha slider below.
    Returns ((color or None, alpha or None), dragging)."""
    color, active = ps1_color_picker(ctx, wid, x, y, width, current,
                                     default, label, state)
    new_alpha: Optional[int] = None
    ay = y + ps1_color_picker_height() + 4.0
    slider_h = 10.0
    label_w, value_w = 16.0, 26.0
    slider_x = x + label_w
    slider_w = width - label_w - value_w - 4.0
    ctx.text(x, ay + 2, "A")
    track = Rect(slider_x, ay, slider_w, slider_h)
    ctx.fill(track, (38, 38, 46))
    fill_w = alpha / 255.0 * slider_w
    ctx.fill(Rect(track.x, track.y, fill_w, track.h), (180, 180, 190))
    ctx.fill(Rect(track.x + fill_w - 1, track.y, 3, track.h),
             (255, 255, 255))
    ctx.text(slider_x + slider_w + 4, ay + 2, f"{alpha:3d}")
    akey = wid + ".a"
    hovered = track.contains(ctx.mouse.x, ctx.mouse.y)
    if hovered and ctx.mouse.pressed:
        state[akey] = True
    if state.get(akey) and ctx.mouse.down:
        active = True
        rel = min(max(ctx.mouse.x - track.x, 0.0), slider_w)
        new_alpha = int(round(rel / slider_w * 255.0))
    if state.get(akey) and not ctx.mouse.down:
        state.pop(akey, None)
    return (color, new_alpha), active


def ps1_color_picker_with_alpha_height() -> float:
    """widgets.rs:1705."""
    return ps1_color_picker_height() + 18.0


def ps1_color_picker_with_blend_mode(ctx: UiContext, wid: str, x: float,
                                     y: float, width: float,
                                     current: Tuple[int, int, int],
                                     blend_mode: int,
                                     default: Tuple[int, int, int],
                                     label: str, state: dict):
    """widgets.rs:1732 — RGB picker + the four PS1 semi-transparency
    blend-mode buttons (types.rs BlendMode).  Returns
    ((color or None, blend or None), dragging)."""
    color, active = ps1_color_picker(ctx, wid, x, y, width, current,
                                     default, label, state)
    new_blend: Optional[int] = None
    by = y + ps1_color_picker_height() + 4.0
    bw = (width - 3 * 2.0) / 4.0
    for i, name in enumerate(BLEND_MODE_LABELS):
        br = Rect(x + i * (bw + 2.0), by, bw, 16.0)
        sel = i == blend_mode
        ctx.fill(br, ctx.theme.accent if sel else ctx.theme.widget)
        ctx.outline(br, ctx.theme.panel_border)
        ctx.text(br.x + 3, br.center_y, name)
        if br.contains(ctx.mouse.x, ctx.mouse.y) and ctx.mouse.pressed \
                and not sel:
            new_blend = i
    return (color, new_blend), active


def ps1_color_picker_with_blend_mode_height() -> float:
    """widgets.rs:1964."""
    return ps1_color_picker_height() + 22.0


# =============================================================================
# Three-way toggle (widgets.rs:1977)
# =============================================================================

def three_way_toggle(ctx: UiContext, rect: Rect, options: Sequence[str],
                     selected: int) -> Optional[int]:
    """widgets.rs:1977 — pill toggle with a light pill over the selected
    option (square corners here; the reference rounds them).  Returns the
    newly-clicked index or None."""
    ctx.fill(rect, (30, 32, 38))
    ctx.outline(rect, (60, 62, 68))
    n = max(len(options), 1)
    ow = rect.w / n
    clicked = None
    for i, label in enumerate(options):
        orect = Rect(rect.x + i * ow, rect.y, ow, rect.h)
        sel = i == selected
        hovered = orect.contains(ctx.mouse.x, ctx.mouse.y)
        if sel:
            ctx.fill(orect.pad(3), (240, 240, 245))
            rgb = (30, 32, 38)
        elif hovered:
            rgb = (200, 200, 205)
        else:
            rgb = (140, 142, 148)
        ctx.text(orect.x + 4, orect.center_y, label, rgb)
        if hovered and ctx.mouse.pressed and not sel:
            clicked = i
    return clicked


# =============================================================================
# Rotary knobs (widgets.rs:781-1100) — tracker channel strips
# =============================================================================

_KNOB_START = math.radians(225.0)   # bottom-left
_KNOB_END = math.radians(-45.0)     # bottom-right: 270 deg sweep
_ACCENT = (120, 180, 255)


def _knob_arc(ctx: UiContext, cx, cy, arc_r, a_from, a_to, thickness,
              segments):
    """Arc as line segments (widgets.rs:816-858); y flips screenward."""
    for i in range(segments):
        t1 = i / segments
        t2 = (i + 1) / segments
        a1 = a_from + (a_to - a_from) * t1
        a2 = a_from + (a_to - a_from) * t2
        if not (_KNOB_END <= a1 <= _KNOB_START
                and _KNOB_END <= a2 <= _KNOB_START):
            continue
        for off in range(int(thickness)):
            r = arc_r - thickness / 2.0 + off
            ctx.line(cx + r * math.cos(a1), cy - r * math.sin(a1),
                     cx + r * math.cos(a2), cy - r * math.sin(a2), _ACCENT)


def _knob_angle(value: int) -> float:
    return _KNOB_START - (value / 127.0) * (_KNOB_START - _KNOB_END)


def _knob_drag_value(ctx: UiContext, cx, cy) -> int:
    """Angle-from-center mapping with bottom dead-zone snap
    (widgets.rs:917-952)."""
    dx = ctx.mouse.x - cx
    dy = cy - ctx.mouse.y
    mouse_angle = math.atan2(dx, dy)       # 0 at 12 o'clock, cw positive
    lo, hi = math.radians(-135.0), math.radians(45.0)
    norm = (mouse_angle - lo) / (hi - lo)
    if hi < mouse_angle <= math.pi:
        norm = 1.0
    elif -math.pi <= mouse_angle < lo:
        norm = 0.0
    norm = min(max(norm, 0.0), 1.0)
    return int(round(norm * 127.0))


def knob(ctx: UiContext, cx: float, cy: float, radius: float, value: int,
         label: str, bipolar: bool = False,
         is_editing: bool = False) -> Tuple[Optional[int], bool]:
    """widgets.rs:781 draw_knob — ring + value arc + pointer + label +
    click-to-edit value box.  Returns (new value or None, start_editing)."""
    rect = Rect(cx - radius, cy - radius, radius * 2, radius * 2)
    hovered = rect.contains(ctx.mouse.x, ctx.mouse.y)
    ctx.circle(cx, cy, radius, (64, 64, 77))
    ctx.circle(cx, cy, radius - 5.0, (31, 31, 38))

    angle = _knob_angle(value)
    arc_r = radius - 2.5
    if bipolar:
        center_angle = _KNOB_START - 0.5 * (_KNOB_START - _KNOB_END)
        a_from, a_to = ((angle, center_angle) if value < 64
                        else (center_angle, angle))
        _knob_arc(ctx, cx, cy, arc_r, a_from, a_to, 5.0, 32)
    else:
        _knob_arc(ctx, cx, cy, arc_r, _KNOB_START, angle, 5.0, 32)

    # pointer + center dot
    ctx.line(cx + radius * 0.35 * math.cos(angle),
             cy - radius * 0.35 * math.sin(angle),
             cx + radius * 0.75 * math.cos(angle),
             cy - radius * 0.75 * math.sin(angle), _ACCENT)
    ctx.circle(cx, cy, 3.0, _ACCENT)
    ctx.text(cx - len(label) * 3, cy - radius - 12, label, (153, 153, 153))

    # value box below (click to start text entry)
    box = Rect(cx - 18, cy + radius + 6, 36, 16)
    box_hovered = box.contains(ctx.mouse.x, ctx.mouse.y)
    bg = ((51, 64, 77) if is_editing
          else (46, 46, 56) if box_hovered else (36, 36, 43))
    ctx.fill(box, bg)
    if is_editing:
        ctx.outline(box, _ACCENT)
    ctx.text(box.x + 4, box.center_y, str(int(value)), (204, 204, 204))

    new_value = _knob_drag_value(ctx, cx, cy) if hovered and ctx.mouse.down \
        else None
    start_editing = box_hovered and ctx.mouse.pressed and not is_editing
    return new_value, start_editing


def mini_knob(ctx: UiContext, cx: float, cy: float, radius: float,
              value: int, label: str,
              bipolar: bool = False) -> Optional[int]:
    """widgets.rs:969 draw_mini_knob — compact strip knob: thin ring, value
    arc, centered label, no value box.  Returns new value while dragged."""
    rect = Rect(cx - radius, cy - radius, radius * 2, radius * 2)
    hovered = rect.contains(ctx.mouse.x, ctx.mouse.y)
    ring = (89, 89, 102) if hovered else (64, 64, 77)
    ctx.circle(cx, cy, radius, ring)
    ctx.circle(cx, cy, radius - 3.0, (31, 31, 38))

    angle = _knob_angle(value)
    arc_r = radius - 1.5
    if bipolar:
        center_angle = _KNOB_START - 0.5 * (_KNOB_START - _KNOB_END)
        a_from, a_to = ((angle, center_angle) if value < 64
                        else (center_angle, angle))
        _knob_arc(ctx, cx, cy, arc_r, a_from, a_to, 3.0, 20)
    else:
        _knob_arc(ctx, cx, cy, arc_r, _KNOB_START, angle, 3.0, 20)
    ctx.line(cx + radius * 0.3 * math.cos(angle),
             cy - radius * 0.3 * math.sin(angle),
             cx + radius * 0.7 * math.cos(angle),
             cy - radius * 0.7 * math.sin(angle), _ACCENT)
    ctx.text(cx - len(label) * 3, cy, label, (178, 178, 178))
    return _knob_drag_value(ctx, cx, cy) if hovered and ctx.mouse.down \
        else None


def tab_bar_with_auth(ctx: UiContext, wid: str, rect: Rect,
                      labels: Sequence[str], active: int,
                      version: str = "", storage_label: str = "Local",
                      is_authenticated: bool = False,
                      user_label: str = "") -> Tuple[int, bool]:
    """ui/tabbar.rs:298 draw_fixed_tabs_with_auth — the tab strip plus the
    right-aligned version tag, storage-mode label, signed-in identity and
    the Sign In / Sign Out button.  Returns (active, auth_clicked)."""
    right_w = 200.0
    tabs_rect = Rect(rect.x, rect.y, max(rect.w - right_w, 60.0), rect.h)
    active = tab_bar(ctx, wid, tabs_rect, labels, active)

    x = rect.right - 8.0
    # Sign In / Sign Out button (tabbar.rs:402-430)
    btn_label = "Sign Out" if is_authenticated else "Sign In"
    bw = 7.0 * len(btn_label) + 14.0
    btn = Rect(x - bw, rect.y + 4, bw, rect.h - 8)
    hovered = btn.contains(ctx.mouse.x, ctx.mouse.y)
    ctx.fill(btn, (46, 46, 56) if hovered else (36, 36, 43))
    ctx.outline(btn, (128, 128, 140) if is_authenticated
                else (90, 170, 230))
    ctx.text(btn.x + 7, btn.center_y, btn_label)
    clicked = hovered and ctx.mouse.pressed
    x = btn.x - 10.0

    # storage mode + identity (tabbar.rs mode/user labels)
    info = storage_label if not user_label else \
        f"{user_label} - {storage_label}"
    x -= 6.0 * len(info)
    ctx.text(x, rect.center_y, info, (140, 140, 150))
    if version:
        vx = x - 6.0 * (len(version) + 2) - 8.0
        ctx.text(vx, rect.center_y, f"v{version}", (110, 110, 120))
    return active, clicked
