"""Game debug overlay + options menu, drawn into the frame
(bonnie32_tpu/game/overlay.py; a host copy).

Reference: `game/renderer.rs:735-905` (draw_debug_overlay — FPS, player
state, input sticks, frame-time bar) and `:494-733` (draw_debug_menu —
D-pad-navigated PS1-quirk toggles).  The text goes through ui/font's
bitmap glyphs via the UiContext draw queue, which paints on the
framebuffer's device.  The game state is GameToolState's batch of one:
its instance 0 is read.
"""

import dataclasses
import math
from typing import List, Optional, Tuple

from ..config import RasterSettings, ShadingMode
from ..input import Action, InputState
from ..profiling import FrameTimings
from ..ui import Rect, UiContext
from .runtime import CameraMode, GameToolState

LABEL = (120, 120, 130)
VALUE = (200, 200, 210)
GOOD = (100, 255, 100)
WARN = (255, 180, 80)
BAD = (255, 100, 100)
BG = (20, 22, 28)
BORDER = (60, 65, 75)

# frame-time bar segment colors (renderer.rs:751-755)
BAR_SEGMENTS = [
    ("input", (100, 180, 255)),
    ("clear", (180, 100, 255)),
    ("render", (255, 100, 100)),
    ("ui", (255, 200, 100)),
]

MENU_ITEMS = [
    "Camera", "Overlay", "---", "Affine UV", "Fixed-Point", "Low Res",
    "4:3 Aspect", "RGB555", "Dithering", "Shading", "FPS", "---", "Reset",
]


def overlay_lines(game: GameToolState, inp: InputState, fps: float,
                  floor_height: Optional[float] = None
                  ) -> List[Tuple[str, Tuple[int, int, int]]]:
    """The overlay's text lines (renderer.rs:771-850), host data."""
    lines: List[Tuple[str, Tuple[int, int, int]]] = []
    fps_color = GOOD if fps >= 55 else (WARN if fps >= 30 else BAD)
    lines.append((f"FPS: {fps:.0f}", fps_color))

    st = game.state
    player = int(st.player[0])
    if player >= 0 and bool(st.alive[0, player]):
        p = st.pos[0, player].cpu().numpy()
        v = st.vel[0, player].cpu().numpy()
        lines.append((f"Pos: {p[0]:.0f}, {p[1]:.0f}, {p[2]:.0f}", VALUE))
        speed = math.hypot(float(v[0]), float(v[2]))
        lines.append((f"Speed: {speed:.0f}", VALUE))
        lines.append((f"Vel Y: {float(v[1]):.1f}", VALUE))
        grounded = bool(st.grounded[0, player])
        lines.append((f"Grounded: {'YES' if grounded else 'NO'}",
                      GOOD if grounded else WARN))
        vv = float(st.vertical_velocity[0, player])
        lines.append((f"Vert Vel: {vv:.1f}", VALUE))
        lines.append((f"Room: {int(st.room[0, player])}", VALUE))
        facing_deg = math.degrees(float(st.facing[0, player]))
        lines.append((f"Facing: {facing_deg:.0f}deg", VALUE))
        if floor_height is not None:
            lines.append((f"Floor: {floor_height:.0f}", VALUE))
    else:
        lines.append(("No Player", WARN))

    lines.append(("---", LABEL))
    lx, ly = inp.left_stick()
    lines.append((f"L Stick: {lx:.2f}, {ly:.2f}", VALUE))
    rx, ry = inp.right_stick()
    lines.append((f"R Stick: {rx:.2f}, {ry:.2f}", VALUE))
    b_down = inp.action_down(Action.DODGE)
    if b_down:
        lines.append(("B: DOWN", GOOD))
    if b_down and math.hypot(lx, ly) > 0.1:
        lines.append(("SPRINTING", GOOD))
    if player >= 0 and bool(st.alive[0, player]) \
            and not bool(st.grounded[0, player]) \
            and float(st.vertical_velocity[0, player]) > 0.0:
        lines.append(("JUMPING", (255, 200, 100)))
    return lines


def draw_debug_overlay(ctx: UiContext, game: GameToolState,
                       rect: Rect, inp: InputState, fps: float,
                       timings: Optional[FrameTimings] = None,
                       floor_height: Optional[float] = None) -> None:
    """renderer.rs:735-905 at 1x font scale (the headless frame is the
    PS1-resolution framebuffer, not a desktop window)."""
    line_h = 9
    overlay_w = 110
    x = rect.x + rect.w - overlay_w - 6
    y = rect.y + 6
    lines = overlay_lines(game, inp, fps, floor_height)

    overlay_h = 6 + len(lines) * line_h + 4
    ctx.fill(Rect(x, y, overlay_w, overlay_h), BG, alpha=200)
    ctx.outline(Rect(x, y, overlay_w, overlay_h), BORDER)
    for i, (text, color) in enumerate(lines):
        if text == "---":
            ctx.line(x + 4, y + 6 + i * line_h + 3,
                     x + overlay_w - 4, y + 6 + i * line_h + 3, LABEL)
        else:
            ctx.text(x + 4, y + 6 + i * line_h, text, color)

    # frame-time bar (renderer.rs:866-905)
    if timings is not None and timings.total_ms > 0:
        bar_y = y + overlay_h + 4
        bar_h = 8
        bar_w = overlay_w - 8
        ctx.fill(Rect(x, bar_y - 2, overlay_w, bar_h + 14), BG, alpha=200)
        ctx.outline(Rect(x, bar_y - 2, overlay_w, bar_h + 14), BORDER)
        total = max(timings.total_ms, 1e-3)
        bx = x + 4
        for phase, color in BAR_SEGMENTS:
            ms = timings.ms.get(phase, 0.0)
            seg = ms / total * bar_w
            if seg > 0.5:
                ctx.fill(Rect(bx, bar_y, seg, bar_h), color)
                bx += seg
        # 60 fps target marker
        target_x = x + 4 + min(16.67 / max(total, 16.67), 1.0) * bar_w
        ctx.line(target_x, bar_y - 1, target_x, bar_y + bar_h + 1,
                 (255, 255, 255))
        ctx.text(x + 4, bar_y + bar_h + 2, f"{total:.1f}ms", VALUE)


def _toggle_pressed(inp: InputState) -> bool:
    """renderer.rs:728-732."""
    return (inp.action_pressed(Action.JUMP)
            or inp.action_pressed(Action.SWITCH_LEFT_WEAPON)
            or inp.action_pressed(Action.SWITCH_RIGHT_WEAPON))


def menu_navigate(game: GameToolState, inp: InputState) -> None:
    """D-pad up/down with separator skipping (renderer.rs:524-540)."""
    sel = game.debug_menu_selection
    if inp.action_pressed(Action.SWITCH_SPELL):       # up
        new = max(sel - 1, 0)
        while new > 0 and MENU_ITEMS[new] == "---":
            new -= 1
        game.debug_menu_selection = new
    if inp.action_pressed(Action.SWITCH_ITEM):        # down
        new = min(sel + 1, len(MENU_ITEMS) - 1)
        while new < len(MENU_ITEMS) - 1 and MENU_ITEMS[new] == "---":
            new += 1
        game.debug_menu_selection = new


def menu_apply(game: GameToolState, inp: InputState) -> None:
    """Apply the toggle on the selected row (renderer.rs:560-727)."""
    if not _toggle_pressed(inp):
        return
    item = MENU_ITEMS[game.debug_menu_selection]
    s = game.settings
    if item == "Camera":
        game.toggle_camera_mode()
    elif item == "Overlay":
        game.show_debug_overlay = not game.show_debug_overlay
    elif item == "Affine UV":
        game.settings = dataclasses.replace(
            s, affine_textures=not s.affine_textures)
    elif item == "Fixed-Point":
        game.settings = dataclasses.replace(
            s, use_fixed_point=not s.use_fixed_point)
    elif item == "Low Res":
        game.settings = dataclasses.replace(
            s, low_resolution=not s.low_resolution)
    elif item == "4:3 Aspect":
        game.settings = dataclasses.replace(
            s, stretch_to_fill=not s.stretch_to_fill)
    elif item == "RGB555":
        game.settings = dataclasses.replace(s, use_rgb555=not s.use_rgb555)
    elif item == "Dithering":
        game.settings = dataclasses.replace(s, dithering=not s.dithering)
    elif item == "Shading":
        order = [ShadingMode.NONE, ShadingMode.FLAT, ShadingMode.GOURAUD]
        nxt = order[(order.index(s.shading) + 1) % 3]
        game.settings = dataclasses.replace(s, shading=nxt)
    elif item == "FPS":
        game.fps_limit = game.fps_limit.next()
    elif item == "Reset":
        game.settings = RasterSettings.game()


def draw_debug_menu(ctx: UiContext, game: GameToolState, rect: Rect,
                    inp: InputState) -> None:
    """renderer.rs:494-727 — navigate, apply, draw."""
    menu_navigate(game, inp)
    menu_apply(game, inp)

    x = rect.x + 6
    y = rect.y + 6
    menu_w = 120
    row_h = 10
    menu_h = 12 + len(MENU_ITEMS) * row_h + 8
    ctx.fill(Rect(x, y, menu_w, menu_h), BG, alpha=220)
    ctx.outline(Rect(x, y, menu_w, menu_h), BORDER)

    s = game.settings
    states = {
        "Camera": game.camera_mode == CameraMode.FREEFLY,
        "Overlay": game.show_debug_overlay,
        "Affine UV": s.affine_textures,
        "Fixed-Point": s.use_fixed_point,
        "Low Res": s.low_resolution,
        "4:3 Aspect": not s.stretch_to_fill,
        "RGB555": s.use_rgb555,
        "Dithering": s.dithering,
    }
    for i, item in enumerate(MENU_ITEMS):
        ry = y + 10 + i * row_h
        if item == "---":
            ctx.line(x + 6, ry - 3, x + menu_w - 6, ry - 3, BORDER)
            continue
        selected = i == game.debug_menu_selection
        color = (255, 255, 255) if selected else VALUE
        if selected:
            ctx.text(x + 3, ry, ">", GOOD)
        ctx.text(x + 12, ry, item, color)
        if item in states:
            on = states[item]
            ctx.text(x + menu_w - 26, ry, "ON" if on else "OFF",
                     GOOD if on else LABEL)
        elif item == "Shading":
            ctx.text(x + menu_w - 46, ry, s.shading.name[:7], VALUE)
        elif item == "FPS":
            ctx.text(x + menu_w - 46, ry, game.fps_limit.label, VALUE)
