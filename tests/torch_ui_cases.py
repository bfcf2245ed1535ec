"""Scripted UI cases shared by the port's tests and chip_smoke.py (no jax).

Every case takes the UI package it drives (`bonnie32_tpu_torch.ui` or the
JAX package's `ui`) and the modules it needs, so one script runs through
both packages, or through the port on two devices:

  * WIDGET_CASES: one widget (or panel, or radial menu) with a mouse
    script of a few frames; `run_case` replays it and records, per frame,
    the widget's result, the context's hot and active ids, the case's
    persistent state and the command queue, all as plain Python values
    (`plain`), so two packages' traces compare with `==`;
  * `widget_frame`: every widget at once on a 640x480 editor frame, the
    mouse dragging a knob along a numpy-seeded path for FRAME_COUNT
    frames while a dropdown is open;
  * `text_input_calls` / `landing_calls`: the text input (a double-click
    word selection, typing, a shift-extended selection, the caret shown)
    and the landing page (scrolled, a link hovered) drawn straight into a
    framebuffer;
  * `drag_cases`: the drag tracker's four pickers with and without grid
    snapping, along seeded mouse paths from a seeded camera;
  * `import_rgba` / `imported_texture`: a seeded RGBA image through the
    texture import dialog (resize to 64x64, quantize at 4 or 8 bpp).
"""

import enum
import importlib
import math

import numpy as np

ITEMS = ["Alpha", "Beta", "Gamma"]
TABS = ["World", "Assets", "Paint", "Music"]
FRAME_SIZE = (640, 480)     # the editor's window (width, height)
FRAME_COUNT = 3             # frames of the full widget frame's mouse script


def sub(ui, name):
    """The submodule `name` of the UI package `ui`."""
    return importlib.import_module(f"{ui.__name__}.{name}")


def plain(v):
    """`v` as plain Python values: objects become (class name, fields),
    enums their value, arrays (dtype, shape, bytes); so the two packages'
    results compare with ==."""
    if isinstance(v, enum.Enum):
        return v.value
    if isinstance(v, (bool, int, float, str, bytes, type(None))):
        return v
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, np.ndarray):
        return ("array", v.dtype.str, v.shape, v.tobytes())
    if isinstance(v, (list, tuple)):
        return tuple(plain(x) for x in v)
    if isinstance(v, (set, frozenset)):
        return tuple(sorted(plain(x) for x in v))
    if isinstance(v, dict):
        return tuple((k, plain(x)) for k, x in v.items())
    return (type(v).__name__, plain(vars(v)))


# ---------------------------------------------------------------------------
# Widget cases: (draw(ui, ctx, st, ox, oy) -> result, mouse script)
# A script frame is (x, y, down) or (x, y, down, begin_frame keywords), in
# the case's own coordinates (offset by ox, oy).
# ---------------------------------------------------------------------------

WIDGET_CASES = {}


def _case(*script):
    def register(fn):
        WIDGET_CASES[fn.__name__] = (fn, script)
        return fn
    return register


@_case((20, 15, False), (20, 15, True), (22, 16, False), (200, 90, True),
       (200, 90, False))
def button(ui, ctx, st, ox, oy):
    return ui.button(ctx, "b", ui.Rect(ox + 10, oy + 10, 60, 20), "OK")


@_case((8, 10, True), (8, 10, False), (40, 10, False))
def checkbox(ui, ctx, st, ox, oy):
    st["v"] = ui.checkbox(ctx, "c", ui.Rect(ox + 5, oy + 5, 80, 16),
                          st.get("v", False), "Snap")
    return st["v"]


@_case((50, 35, True), (75, 35, True), (500, 35, True), (500, 35, False))
def slider(ui, ctx, st, ox, oy):
    st["v"] = ui.slider(ctx, "s", ui.Rect(ox + 5, oy + 30, 100, 10),
                        st.get("v", 2.0), 0.0, 10.0)
    return st["v"]


@_case((10, 10, True), (30, 10, True), (31, 10, True), (31, 10, False))
def drag_value(ui, ctx, st, ox, oy):
    st["v"] = ui.drag_value(ctx, "d", ui.Rect(ox + 5, oy + 5, 60, 16),
                            st.get("v", 5.0), speed=0.5, lo=0.0, hi=12.0,
                            state=st.setdefault("drag", {}))
    return st["v"]


@_case((0, 0, False))
def label_row(ui, ctx, st, ox, oy):
    ui.label_row(ctx, ui.Rect(ox + 5, oy + 5, 140, 12), "Name", "cave")


@_case((110, 9, True), (110, 9, False), (60, 9, False))
def tab_bar(ui, ctx, st, ox, oy):
    st["t"] = ui.tab_bar(ctx, "tabs", ui.Rect(ox, oy, 150, 18),
                         ["World", "Assets", "Music"], st.get("t", 0))
    return st["t"]


@_case((34, 12, True), (34, 12, False), (90, 12, False))
def toolbar(ui, ctx, st, ox, oy):
    st["t"] = ui.toolbar(ctx, "tools", ui.Rect(ox, oy, 140, 24),
                         ["S", "M", "R", "E"], st.get("t", 0))
    return st["t"]


@_case((50, 20, True), (50, 20, False), (50, 20, False, {"wheel": -2.0}),
       (50, 60, False))
def vlist(ui, ctx, st, ox, oy):
    sel, st["scroll"] = ui.vlist(
        ctx, "l", ui.Rect(ox, oy, 100, 90), [f"row {i}" for i in range(30)],
        st.get("sel"), scroll=st.get("scroll", 0.0))
    st["sel"] = sel
    return sel


def _dropdown(ui, ctx, st, ox, oy):
    picked = ui.dropdown(ctx, st.setdefault("state", ui.DropdownState()),
                         "dd", ui.Rect(ox + 10, oy + 10, 100, 20), ITEMS,
                         st.get("sel", 0))
    if picked is not None:
        st["sel"] = picked
    return picked


@_case((50, 20, True), (50, 20, False), (50, 45, False))
def dropdown(ui, ctx, st, ox, oy):
    """Opened by a press on its trigger, an item hovered: stays open."""
    return _dropdown(ui, ctx, st, ox, oy)


@_case((50, 20, True), (50, 20, False), (50, 84, True), (50, 84, False))
def dropdown_pick(ui, ctx, st, ox, oy):
    return _dropdown(ui, ctx, st, ox, oy)


@_case((150, 100, True), (150, 100, False), (50, 20, True))
def dropdown_block(ui, ctx, st, ox, oy):
    state = st.setdefault("state", ui.DropdownState())
    if st.get("opened") is None:
        state.open("dd", ui.Rect(ox + 10, oy + 10, 100, 20))
        st["opened"] = True
    ui.dropdown_block_clicks(ctx, state)
    pressed = ctx.mouse.pressed
    return pressed, _dropdown(ui, ctx, st, ox, oy)


@_case((100, 25, True), (126, 25, True), (126, 25, False), (86, 60, True),
       (86, 60, False), (100, 36, True, {"double_clicked": True}))
def ps1_color_picker(ui, ctx, st, ox, oy):
    changed, active = ui.ps1_color_picker(
        ctx, "cp", ox + 10, oy + 20, 140, st.get("cur", (128, 128, 128)),
        (100, 100, 100), "Col", st.setdefault("w", {}))
    if changed is not None:
        st["cur"] = changed
    return changed, active, ui.ps1_color_picker_height()


@_case((30, 81, True), (80, 81, True), (80, 81, False), (100, 45, True))
def ps1_color_picker_with_alpha(ui, ctx, st, ox, oy):
    (color, alpha), active = ui.ps1_color_picker_with_alpha(
        ctx, "cpa", ox + 10, oy + 20, 140, st.get("cur", (10, 20, 30)),
        st.get("a", 255), (0, 0, 0), "", st.setdefault("w", {}))
    if alpha is not None:
        st["a"] = alpha
    if color is not None:
        st["cur"] = color
    return (color, alpha), active, ui.ps1_color_picker_with_alpha_height()


@_case((48.5, 84, True), (48.5, 84, False), (119.5, 84, True))
def ps1_color_picker_with_blend_mode(ui, ctx, st, ox, oy):
    (color, blend), active = ui.ps1_color_picker_with_blend_mode(
        ctx, "cpb", ox + 10, oy + 20, 140, (10, 20, 30), st.get("b", 0),
        (0, 0, 0), "Glass", st.setdefault("w", {}))
    if blend is not None:
        st["b"] = blend
    return ((color, blend), active,
            ui.ps1_color_picker_with_blend_mode_height())


@_case((45, 9, True), (45, 9, False), (5, 9, True), (75, 9, False))
def three_way_toggle(ui, ctx, st, ox, oy):
    r = ui.three_way_toggle(ctx, ui.Rect(ox, oy, 90, 18), ["A", "B", "C"],
                            st.get("sel", 0))
    if r is not None:
        st["sel"] = r
    return r


def _knob(ui, ctx, st, cx, cy):
    new, editing = sub(ui, "widgets").knob(
        ctx, cx, cy, 20, st.get("v", 64), "VOL",
        is_editing=st.get("edit", False))
    if new is not None:
        st["v"] = new
    if editing:
        st["edit"] = True
    return new, editing


@_case((60, 35, True), (75, 45, True), (48, 64, True), (60, 84, False),
       (60, 84, True))
def knob(ui, ctx, st, ox, oy):
    return _knob(ui, ctx, st, ox + 60, oy + 50)


@_case((30, 20, True), (38, 30, True), (30, 30, False), (85, 24, True))
def mini_knob(ui, ctx, st, ox, oy):
    w = sub(ui, "widgets")
    a = w.mini_knob(ctx, ox + 30, oy + 30, 12, st.get("a", 64), "P",
                    bipolar=True)
    b = w.mini_knob(ctx, ox + 80, oy + 30, 12, st.get("b", 20), "V")
    st["a"] = st.get("a", 64) if a is None else a
    st["b"] = st.get("b", 20) if b is None else b
    return a, b


@_case((30, 11, True), (30, 11, False), (260, 11, True), (260, 11, False),
       (250, 11, True))
def tab_bar_with_auth(ui, ctx, st, ox, oy):
    auth = st.get("auth", False)
    active, clicked = sub(ui, "widgets").tab_bar_with_auth(
        ctx, "tabs", ui.Rect(ox, oy, 300, 22), TABS, st.get("t", 0),
        version="0.2", storage_label="Cloud" if auth else "Local",
        is_authenticated=auth, user_label="ada" if auth else "")
    st["t"] = active
    if clicked:
        st["auth"] = not auth
    return active, clicked


@_case((100, 50, False), (100, 50, True), (150, 50, True), (999, 50, True),
       (999, 50, False), (190, 10, True))
def split_panel(ui, ctx, st, ox, oy):
    sp = st.setdefault("sp", ui.SplitPanel.horizontal("main")
                       .with_ratio(0.5).with_min_size(20))
    bounds = ui.Rect(ox, oy, 200, 100)
    left, right = sp.layout(bounds)
    ui.draw_panel(ctx, left, "TOOLS", (30, 30, 36))
    clicked, content = ui.draw_collapsible_panel(
        ctx, right, "INFO", st.get("collapsed", False), (20, 20, 25))
    if clicked:
        st["collapsed"] = not st.get("collapsed", False)
    sp.handle_input(ctx, bounds)
    return (left, right, ui.panel_content_rect(left, True), clicked,
            content, sp.divider_rect(bounds))


@_case((50, 33, False), (50, 33, True), (50, 70, True), (50, 70, False))
def split_panel_vertical(ui, ctx, st, ox, oy):
    sp = st.setdefault("sp", ui.SplitPanel.vertical("side")
                       .with_ratio(0.3))
    top, bottom = sp.update(ctx, ui.Rect(ox + 10, oy, 120, 110))
    ui.draw_panel(ctx, top, None, (40, 30, 36))
    return top, bottom, ui.panel_content_rect(bottom, False)


@_case((50, 10, False), (50, 10, True), (50, 10, False), (50, 10, True))
def collapsible_panel(ui, ctx, st, ox, oy):
    clicked, content = ui.draw_collapsible_panel(
        ctx, ui.Rect(ox, oy, 100, 80), "LAYERS", st.get("collapsed", False),
        (20, 20, 25))
    if clicked:
        st["collapsed"] = not st.get("collapsed", False)
    return clicked, content, ui.COLLAPSED_PANEL_HEIGHT


def radial_items(rm):
    return [rm.RadialMenuItem("a", "Add"),
            rm.RadialMenuItem("b", "Box").with_children(
                [rm.RadialMenuItem("b1", "Cube"),
                 rm.RadialMenuItem("b2", "Wedge")]),
            rm.RadialMenuItem("c", "Cut").disabled(),
            rm.RadialMenuItem("d", "Del")]


@_case((160, 20, False), (200, 60, False), (161, 61, False),
       (110, 60, False), (400, 60, False))
def radial_menu(ui, ctx, st, ox, oy):
    rm = sub(ui, "radial_menu")
    if "menu" not in st:
        st["menu"] = rm.RadialMenuState()
        st["menu"].open(ox + 160, oy + 60, radial_items(rm))
    cfg = rm.RadialMenuConfig(outer_radius=50.0)
    rm.draw_radial_menu(ctx, st["menu"], cfg, ctx.mouse.x, ctx.mouse.y)
    return (st["menu"].highlighted,
            rm.segment_at(st["menu"], cfg, ox + 160, oy + 10))


@_case((200, 60, False), (160, 20, False), (160, 20, False),
       (110, 60, False))
def radial_submenu(ui, ctx, st, ox, oy):
    """Enter Box's submenu, come back, then select Del on close."""
    rm = sub(ui, "radial_menu")
    frame = st.get("frame", 0)
    st["frame"] = frame + 1
    menu = st.setdefault("menu", rm.RadialMenuState())
    if frame == 0:
        menu.open(ox + 160, oy + 60, radial_items(rm))
    cfg = rm.RadialMenuConfig(outer_radius=50.0)
    rm.draw_radial_menu(ctx, menu, cfg, ctx.mouse.x, ctx.mouse.y)
    out = None
    if frame == 0:
        menu.enter_submenu(menu.highlighted)
    elif frame == 2:
        out = menu.back()
    elif frame == 3:
        out = (menu.close(select=True), menu.take_selected(),
               menu.take_selected())
    return out, [i.id for i in menu.items]


def run_case(ui, name, ox=0.0, oy=0.0, ctx=None):
    """Replay WIDGET_CASES[name] through `ui`: (ctx after the last frame,
    per frame (result, hot, active, state, commands) as plain values)."""
    fn, script = WIDGET_CASES[name]
    ctx = ctx if ctx is not None else ui.UiContext()
    st, trace = {}, []
    for ev in script:
        x, y, down = ev[:3]
        ctx.begin_frame(x + ox, y + oy, down, **(ev[3] if len(ev) > 3
                                                  else {}))
        result = fn(ui, ctx, st, ox, oy)
        trace.append(plain((result, ctx.hot, ctx.active, st,
                            ctx.commands)))
    return ctx, trace


# Where each case sits in the full frame (top-left offsets at 640x480).
FRAME_LAYOUT = (
    ("tab_bar_with_auth", 0, 0), ("tab_bar", 320, 0), ("toolbar", 480, 0),
    ("button", 0, 30), ("checkbox", 80, 30), ("slider", 170, 30),
    ("drag_value", 290, 30), ("label_row", 360, 30),
    ("three_way_toggle", 520, 34),
    ("ps1_color_picker", 0, 100), ("ps1_color_picker_with_alpha", 160, 100),
    ("ps1_color_picker_with_blend_mode", 320, 100), ("vlist", 500, 100),
    ("dropdown", 0, 200), ("mini_knob", 230, 290),
    ("radial_menu", 320, 200), ("split_panel", 0, 340),
    ("collapsible_panel", 220, 340), ("split_panel_vertical", 330, 340))
KNOB_CENTER = (200, 250)


def frame_mouse(seed, frames=FRAME_COUNT):
    """The full frame's mouse script: held down from the first frame on,
    at numpy-seeded points inside the knob's circle (radius 20)."""
    rng = np.random.default_rng(seed)
    ang = rng.uniform(0.0, 2.0 * math.pi, frames)
    rad = rng.uniform(4.0, 15.0, frames)
    return [(float(KNOB_CENTER[0] + r * math.cos(a)),
             float(KNOB_CENTER[1] + r * math.sin(a)), True)
            for a, r in zip(ang, rad)]


def widget_frame(ui, seed, frames=FRAME_COUNT):
    """Every widget of widgets.py, a split and a collapsible panel and an
    open radial menu, laid out on the editor's 640x480 window; the mouse
    drags the knob along `frame_mouse(seed)` while the dropdown, opened
    through its DropdownState after the first frame, stays open (a held
    mouse presses nothing, so no outside click closes it).  Returns (ctx
    after the last frame, per frame (results, hot, active, commands))."""
    ctx = ui.UiContext()
    states = {name: {} for name, _, _ in FRAME_LAYOUT}
    knob_st, trace = {}, []
    for i, (x, y, down) in enumerate(frame_mouse(seed, frames)):
        ctx.begin_frame(x, y, down)
        dd = states["dropdown"].setdefault("state", ui.DropdownState())
        if i >= 1 and not dd.is_any_open():
            dd.open("dd", ui.Rect(10, 210, 100, 20))
        ui.dropdown_block_clicks(ctx, dd)
        results = [WIDGET_CASES[name][0](ui, ctx, states[name], ox, oy)
                   for name, ox, oy in FRAME_LAYOUT]
        results.append(_knob(ui, ctx, knob_st, *KNOB_CENTER))
        trace.append(plain((results, ctx.hot, ctx.active, states, knob_st,
                            ctx.commands)))
    return ctx, trace


# ---------------------------------------------------------------------------
# Text input and landing page: drawn straight into a framebuffer
# ---------------------------------------------------------------------------

def text_input_calls(ui, fb, scale=1):
    """draw_text_input seven times into `fb` (rect 8,8 240x(16*scale)):
    a double-click that selects a word, typing over it, shift+left twice
    (a selection), a shift-click, end + backspace, then shift+left three
    times: the last frame shows a selection and the caret.
    Returns (fb, per call (changed, text, cursor, selection_start,
    selection_range, blink_timer))."""
    st = ui.TextInputState.new("hello world_x 42")
    rect = ui.Rect(8, 8, 240, 16 * scale)
    text_x = 8 + 4 * scale
    word_x = text_x + ui.font.text_size("hello wor", scale)[0]
    calls = [dict(mouse=(word_x, 12, True), now=1.0, dt=0.6),
             dict(mouse=(word_x + 1, 12, True), now=1.2, dt=0.1),
             dict(keys=[("N", False, False), ("e", False, False),
                        ("w", False, False)], dt=0.2),
             dict(keys=[("left", True, False), ("left", True, False)],
                  dt=0.1),
             dict(mouse=(text_x + 2, 12, True), keys=[("shift_down", True,
                                                       False)], now=3.0,
                  dt=0.05),
             dict(keys=[("end", False, False), ("backspace", False,
                                                 False)], dt=0.3),
             dict(keys=[("left", True, False)] * 3, dt=0.2)]
    trace = []
    for kw in calls:
        fb, changed = ui.draw_text_input(fb, rect, st, scale=scale, **kw)
        trace.append((changed, st.text, st.cursor, st.selection_start,
                      st.selection_range(), st.blink_timer))
    idx = [ui.x_to_char_index(st.text, float(text_x), float(mx), scale)
           for mx in (0, text_x + 7, text_x + 30, 1e6)]
    return fb, trace + [tuple(idx)]


def landing_calls(ui, fb, width, height, version="0.2"):
    """The landing page drawn into `fb`; then queued through a UiContext
    (draw_landing_ctx) scrolled by a wheel delta of -130 (to its end),
    where the first link's text command gives the link's place; then
    drawn into `fb` scrolled the same way with the mouse on that link,
    queued once more with the mouse there, and the link row alone with
    its first link hovered.  Returns (fb, [hovered urls, scroll states,
    the link rects, the last queue])."""
    ld = sub(ui, "landing")
    rect = ui.Rect(0, 0, width, height)
    st = ld.LandingState()
    fb, hovered0 = ld.draw_landing(fb, rect, st, version=version)
    ctx = ui.UiContext()
    ctx.begin_frame(0.0, 0.0, False, wheel=-130.0)
    probe = ld.LandingState(scroll_y=st.scroll_y, max_scroll=st.max_scroll)
    ld.draw_landing_ctx(ctx, rect, probe, version)
    x, y = next(c[1] for c in ctx.commands
                if c[0] == "text" and c[2] == ld.LINKS[0][0])
    mouse = (float(x) + 1.0, float(y) + 1.0)
    fb, hovered1 = ld.draw_landing(fb, rect, st, scroll_delta=-130.0,
                                   mouse=mouse, version=version)
    ctx.begin_frame(*mouse, False)
    hovered2 = ld.draw_landing_ctx(ctx, rect, probe, version)
    fb, rects, hovered3 = ld.draw_link_row(fb, 12, height - 20, ld.LINKS,
                                           mouse=(13.0, height - 19.0))
    return fb, [hovered0, hovered1, hovered2, hovered3, mouse,
                (st.scroll_y, st.max_scroll), plain(rects),
                plain(ctx.commands)]


# ---------------------------------------------------------------------------
# The drag tracker
# ---------------------------------------------------------------------------

DRAG_SIZE = (320, 240)      # the viewport (width, height) of the drags
DRAG_STEPS = 4              # mouse moves a drag


def drag_camera(seed):
    """(cam_pos (3,), basis (3, 3) rows x/y/z) as f32 numpy: a camera
    above the y=0 plane looking down at it from a seeded yaw and pitch."""
    rng = np.random.default_rng(seed)
    yaw, pitch = rng.uniform(-0.6, 0.6), rng.uniform(0.35, 0.7)
    fwd = np.array([math.sin(yaw) * math.cos(pitch), -math.sin(pitch),
                    math.cos(yaw) * math.cos(pitch)])
    right = np.array([math.cos(yaw), 0.0, -math.sin(yaw)])
    down = np.cross(fwd, right)
    pos = -fwd * 1500.0 + np.array([rng.uniform(-50, 50), 0.0,
                                    rng.uniform(-50, 50)])
    return (pos.astype(np.float32),
            np.stack([right, down, fwd]).astype(np.float32))


def drag_cases(ui):
    """(name, DragConfig, DragState factory): the line, plane, circle and
    screen pickers, each unsnapped, relatively and absolutely snapped."""
    line = ui.DragConfig.line([10.0, 0.0, -20.0], [0.8, 0.0, 0.6])
    plane = ui.DragConfig.plane([0.0, 0.0, 0.0], [0.0, -1.0, 0.0])
    circle = ui.DragConfig.circle([30.0, 0.0, 40.0], [0.0, -1.0, 0.0],
                                  [1.0, 0.0, 0.0])
    screen = ui.DragConfig(picker="screen", sensitivity=2.5)
    offset = [3.0, 0.0, -2.0]

    def moved(mouse):
        return ui.DragState.new([12.5, 0.0, -7.25], offset, mouse)

    def turned(mouse):
        return ui.DragState.new_rotation([30.0, 0.0, 40.0], 0.25, mouse,
                                         (160.0, 120.0))
    cases = []
    for label, cfg, make, grid in (("line", line, moved, 64.0),
                                   ("plane", plane, moved, 32.0),
                                   ("circle", circle, turned, math.pi / 12),
                                   ("screen", screen, moved, 16.0)):
        cases += [(label, cfg, make),
                  (f"{label}, relative snap", cfg.with_snap(grid), make),
                  (f"{label}, absolute snap", cfg.with_absolute_snap(grid),
                   make)]
    return cases


def drag_paths(seed, n_cases, steps=DRAG_STEPS):
    """Seeded mouse paths: a start point and `steps` moves a case."""
    rng = np.random.default_rng(seed)
    w, h = DRAG_SIZE
    pts = rng.uniform((0.15 * w, 0.2 * h), (0.85 * w, 0.9 * h),
                      (n_cases, steps + 1, 2))
    return [[(float(x), float(y)) for x, y in case] for case in pts]


def run_drags(ui, cam_pos, basis, seed):
    """Every drag case along its seeded path: per case and move
    (current_position (3,) f32, current_angle, position_delta,
    angle_delta, mouse_delta)."""
    cases = drag_cases(ui)
    out = []
    for (name, cfg, make), path in zip(cases, drag_paths(seed, len(cases))):
        st = make(path[0])
        moves = []
        for mx, my in path[1:]:
            st = cfg.update(st, mx, my, cam_pos, basis, *DRAG_SIZE)
            moves.append((np.asarray(st.current_position, np.float32).copy(),
                          float(st.current_angle),
                          np.asarray(st.position_delta(), np.float32),
                          float(st.angle_delta()), st.mouse_delta()))
        st.reset_initial()
        moves.append((st.initial_position.copy(), st.initial_angle,
                      np.zeros(3, np.float32), st.angle_delta(),
                      st.mouse_delta()))
        out.append((name, cfg.snap_mode, moves))
    return out


# ---------------------------------------------------------------------------
# The texture import path
# ---------------------------------------------------------------------------

IMPORT_SHAPE = (80, 96)     # (rows, columns) of the imported image
IMPORT_TARGET = 64


def import_rgba(seed, shape=IMPORT_SHAPE):
    """A seeded (rows, cols, 4) u8 image: two crossed colour gradients with
    noise, a disc of one flat colour and ~8% transparent pixels."""
    rng = np.random.default_rng(seed)
    h, w = shape
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.zeros((h, w, 4), np.float32)
    img[..., 0] = 255.0 * xs / (w - 1)
    img[..., 1] = 255.0 * ys / (h - 1)
    img[..., 2] = 128.0 + 100.0 * np.sin(xs / 7.0) * np.cos(ys / 5.0)
    img[..., :3] += rng.normal(0.0, 12.0, (h, w, 3))
    disc = (xs - 0.7 * w) ** 2 + (ys - 0.4 * h) ** 2 < (0.15 * h) ** 2
    img[disc, :3] = (230.0, 40.0, 60.0)
    img[..., 3] = 255.0
    img[rng.random((h, w)) < 0.08, 3] = 0.0
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def imported_texture(texture, rgba, depth, tex_id=1, name="imported",
                     target=IMPORT_TARGET):
    """`rgba` through the import dialog (`texture.TextureImportState`):
    loaded, `depth` forced (0 = 4 bpp, 1 = 8 bpp), resized to
    target x target (fit and pad) and quantized; returns (the state, the
    finalized UserTexture)."""
    st = texture.TextureImportState()
    st.load_image(rgba)
    st.depth = depth
    st.target_size = target
    return st, st.finalize(tex_id, name)
