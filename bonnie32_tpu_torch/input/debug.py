"""Controller debug screen: sticks, deadzone slider, action states.

Port of `input/debug.rs` (bonnie32_tpu/input/debug.py; a host copy,
painted through the port's UiContext): the Input-tab tester —
detection header, an interactive deadzone slider (0–50%), the two
analog-stick widgets (outer ring, deadzone ring, position dot + line),
and the action grid colored by just-pressed / held / idle, labeled with
the detected controller's button names.
"""

import math
from typing import List, Tuple

from ..ui.context import UiContext
from ..ui.rect import Rect
from .actions import Action
from .state import ButtonLabels, InputState

BG = (20, 22, 28)
HEADER_OK = (100, 255, 100)
HEADER_MISSING = (255, 100, 100)
MUTED = (150, 150, 160)
SLIDER_BG = (40, 42, 48)
SLIDER_FILL = (80, 140, 200)
SLIDER_HANDLE = (100, 180, 255)
RING = (60, 60, 70)
DEADZONE_RING = (100, 60, 60)
STICK_DOT = (100, 180, 255)
PRESSED = (100, 255, 100)
HELD = (255, 200, 100)
IDLE = (80, 80, 90)
DOT_ON = (100, 200, 100)
DOT_OFF = (50, 50, 55)


def build_action_labels(labels: ButtonLabels) -> List[Tuple[Action, str]]:
    """debug.rs:117 — action → prompt with the platform button name."""
    return [
        (Action.JUMP, f"Jump ({labels.a})"),
        (Action.DODGE, f"Dodge ({labels.b})"),
        (Action.USE_ITEM, f"Use Item ({labels.x})"),
        (Action.INTERACT, f"Interact ({labels.y})"),
        (Action.ATTACK, "Attack (RB)"),
        (Action.STRONG_ATTACK, "Strong Attack (RT)"),
        (Action.GUARD, "Guard (LB)"),
        (Action.SKILL, "Skill (LT)"),
        (Action.CROUCH, "Crouch (L3)"),
        (Action.LOCK_ON, "Lock-On (R3)"),
        (Action.OPEN_MENU, "Menu (Start)"),
        (Action.OPEN_MAP, "Map (Select)"),
        (Action.SWITCH_LEFT_WEAPON, "D-Pad Left"),
        (Action.SWITCH_RIGHT_WEAPON, "D-Pad Right"),
        (Action.SWITCH_SPELL, "D-Pad Up"),
        (Action.SWITCH_ITEM, "D-Pad Down"),
    ]


def _draw_stick_widget(ctx: UiContext, cx: float, cy: float,
                       radius: float, value: Tuple[float, float],
                       label: str, deadzone: float) -> None:
    """debug.rs:140 — ring + deadzone ring + dot (screen y inverted)."""
    ctx.circle_lines(cx, cy, radius, RING)
    ctx.circle_lines(cx, cy, radius * deadzone, DEADZONE_RING)
    px = cx + value[0] * radius
    py = cy - value[1] * radius
    if math.hypot(*value) > 0.01:
        ctx.line(cx, cy, px, py, STICK_DOT)
    ctx.circle(px, py, 3, STICK_DOT)
    ctx.text(int(cx - len(label) * 3), int(cy + radius + 4), label, MUTED)


def draw_controller_debug(ctx: UiContext, rect: Rect,
                          inp: InputState) -> None:
    """debug.rs:6 — the whole Input-tab screen into the ctx queue.
    The deadzone slider is live: dragging it calls set_deadzone."""
    ctx.fill(rect, BG)
    x = rect.x + 16
    y = rect.y + 10

    if inp.has_gamepad():
        header = f"Detected: {inp.controller_type().value}"
        ctx.text(x, y, header, HEADER_OK)
    else:
        ctx.text(x, y, "No Controller Detected", HEADER_MISSING)
    y += 16

    ctx.text(x, y, "DEADZONE", MUTED)
    y += 10
    slider_w, slider_h = 100.0, 5.0
    slider = Rect(x, y, slider_w, slider_h)
    ctx.fill(slider, SLIDER_BG)
    deadzone = inp.deadzone()
    fill_w = (deadzone / 0.5) * slider_w
    if fill_w >= 1:
        ctx.fill(Rect(x, y, fill_w, slider_h), SLIDER_FILL)
    ctx.circle(x + fill_w, y + slider_h / 2, 3, SLIDER_HANDLE)
    ctx.text(int(x + slider_w + 8), int(y - 1),
             f"{deadzone * 100:.0f}%", MUTED)
    # live drag (debug.rs:48-53): grow the hit rect around the track
    hit = Rect(slider.x - 5, slider.y - 5, slider.w + 10, slider.h + 10)
    if ctx.mouse.down and hit.contains(ctx.mouse.x, ctx.mouse.y):
        t = min(max((ctx.mouse.x - x) / slider_w, 0.0), 1.0)
        inp.set_deadzone(t * 0.5)
    y += 16

    ctx.text(x, y, "ANALOG STICKS", MUTED)
    y += 10
    stick_r = 20.0
    _draw_stick_widget(ctx, x + stick_r + 4, y + stick_r, stick_r,
                       inp.left_stick(), "Left", inp.deadzone())
    _draw_stick_widget(ctx, x + stick_r + 4 + 70, y + stick_r, stick_r,
                       inp.right_stick(), "Right", inp.deadzone())
    y += stick_r * 2 + 16

    ctx.text(x, y, "ACTIONS", MUTED)
    y += 10
    actions = build_action_labels(inp.button_labels())
    col_w, row_h, per_col = 100, 10, 9
    start_y = y
    col = 0
    for i, (action, label) in enumerate(actions):
        ax = x + col * col_w
        pressed = inp.action_pressed(action)
        down = inp.action_down(action)
        color = PRESSED if pressed else (HELD if down else IDLE)
        ctx.circle(ax + 3, y + 3, 2, DOT_ON if down else DOT_OFF)
        ctx.text(int(ax + 9), int(y), label, color)
        y += row_h
        if (i + 1) % per_col == 0:
            col += 1
            y = start_y

    if not inp.has_gamepad():
        ctx.text(int(rect.x + 16), int(rect.y + rect.h - 12),
                 "Connect a controller to test input", MUTED)
