"""InputState: merge keyboard + gamepad into actions and stick vectors
(bonnie32_tpu/input/state.py; `to_actions` gives the port's batched
Actions of one instance).

Reference behavior: `/root/reference/src/input/state.rs` (left_stick merge
:28-48, action_down/pressed :63-72), `/root/reference/src/input/
gamepad.rs:260` (radial deadzone), `/root/reference/src/input/
controller_type.rs` (name detection + labels).
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Dict, Optional, Set, Tuple

from .actions import (Action, GAMEPAD_BINDINGS, KEYBOARD_BINDINGS,
                      KEYBOARD_PRESSED_ACTIONS)


def apply_deadzone(x: float, y: float, deadzone: float) -> Tuple[float, float]:
    """gamepad.rs:260 — radial, rescaled to the full range."""
    length = math.sqrt(x * x + y * y)
    if length < deadzone:
        return (0.0, 0.0)
    scale = (length - deadzone) / (1.0 - deadzone) / length
    return (x * scale, y * scale)


class ControllerType(enum.Enum):
    """controller_type.rs:8."""

    PLAYSTATION = "PlayStation"
    XBOX = "Xbox"
    NINTENDO = "Nintendo"
    GENERIC = "Generic"

    @classmethod
    def from_name(cls, name: str) -> "ControllerType":
        """controller_type.rs:22 — substring detection, lowercase."""
        n = name.lower()
        if any(s in n for s in ("playstation", "dualshock", "dualsense",
                                "sony", "ps3", "ps4", "ps5")):
            return cls.PLAYSTATION
        if any(s in n for s in ("nintendo", "switch", "joy-con", "joycon",
                                "pro controller")):
            return cls.NINTENDO
        if any(s in n for s in ("xbox", "microsoft", "xinput")):
            return cls.XBOX
        return cls.GENERIC


@dataclasses.dataclass(frozen=True)
class ButtonLabels:
    """Face-button prompts per platform (controller_type.rs labels)."""

    a: str
    b: str
    x: str
    y: str

    @classmethod
    def for_type(cls, ct: ControllerType) -> "ButtonLabels":
        if ct is ControllerType.PLAYSTATION:
            return cls(a="Cross", b="Circle", x="Square", y="Triangle")
        if ct is ControllerType.NINTENDO:
            return cls(a="B", b="A", x="Y", y="X")
        return cls(a="A", b="B", x="X", y="Y")


class VirtualKeyboard:
    """Scriptable keyboard backend: feed held keys per frame; `pressed`
    = newly held this frame (edge detect in update())."""

    def __init__(self):
        self._down: Set[str] = set()
        self._pressed: Set[str] = set()

    def update(self, held) -> None:
        held = set(held)
        self._pressed = held - self._down
        self._down = held

    def is_down(self, key: str) -> bool:
        return key in self._down

    def is_pressed(self, key: str) -> bool:
        return key in self._pressed


class VirtualGamepad:
    """Scriptable gamepad backend with stick axes + named buttons."""

    def __init__(self, name: str = "Xbox Wireless Controller",
                 deadzone: float = 0.15):
        self.name = name
        self.deadzone = deadzone
        self.connected = False
        self._axes = dict(lx=0.0, ly=0.0, rx=0.0, ry=0.0)
        self._down: Set[str] = set()
        self._pressed: Set[str] = set()

    def update(self, axes: Optional[Dict[str, float]] = None,
               buttons=()) -> None:
        self.connected = True
        if axes:
            self._axes.update(axes)
        buttons = set(buttons)
        self._pressed = buttons - self._down
        self._down = buttons

    def left_stick(self) -> Tuple[float, float]:
        return apply_deadzone(self._axes["lx"], self._axes["ly"],
                              self.deadzone)

    def right_stick(self) -> Tuple[float, float]:
        return apply_deadzone(self._axes["rx"], self._axes["ry"],
                              self.deadzone)

    def is_button_down(self, button: str) -> bool:
        return button in self._down

    def is_button_pressed(self, button: str) -> bool:
        return button in self._pressed


class InputState:
    """state.rs:10 — merged keyboard + gamepad view, polled per frame."""

    def __init__(self, keyboard: Optional[VirtualKeyboard] = None,
                 gamepad: Optional[VirtualGamepad] = None):
        self.keyboard = keyboard or VirtualKeyboard()
        self.gamepad = gamepad or VirtualGamepad()

    # --- sticks ---

    def left_stick(self) -> Tuple[float, float]:
        """state.rs:28 — WASD vector; gamepad wins if larger; normalize
        diagonals."""
        x = y = 0.0
        if self.keyboard.is_down("w"):
            y += 1.0
        if self.keyboard.is_down("s"):
            y -= 1.0
        if self.keyboard.is_down("a"):
            x -= 1.0
        if self.keyboard.is_down("d"):
            x += 1.0
        gx, gy = self.gamepad.left_stick()
        if math.hypot(gx, gy) > math.hypot(x, y):
            x, y = gx, gy
        length = math.hypot(x, y)
        if length > 1.0:
            x, y = x / length, y / length
        return (x, y)

    def right_stick(self) -> Tuple[float, float]:
        """state.rs:52 — gamepad only."""
        return self.gamepad.right_stick()

    # --- actions ---

    def action_down(self, action: Action) -> bool:
        """state.rs:63 — keyboard OR gamepad."""
        key = KEYBOARD_BINDINGS.get(action)
        if key is not None and self.keyboard.is_down(key):
            return True
        btn = GAMEPAD_BINDINGS.get(action)
        return btn is not None and self.gamepad.is_button_down(btn)

    def action_pressed(self, action: Action) -> bool:
        """state.rs:68 — edge-detected; keyboard supports a subset
        (state.rs:140)."""
        if action in KEYBOARD_PRESSED_ACTIONS:
            key = KEYBOARD_BINDINGS.get(action)
            if key is not None and self.keyboard.is_pressed(key):
                return True
        btn = GAMEPAD_BINDINGS.get(action)
        return btn is not None and self.gamepad.is_button_pressed(btn)

    # --- deadzone (input/debug.rs slider) ---

    def deadzone(self) -> float:
        return self.gamepad.deadzone

    def set_deadzone(self, value: float) -> None:
        self.gamepad.deadzone = min(max(float(value), 0.0), 0.5)

    # --- metadata ---

    def has_gamepad(self) -> bool:
        return self.gamepad.connected

    def controller_type(self) -> ControllerType:
        return ControllerType.from_name(self.gamepad.name)

    def button_labels(self) -> ButtonLabels:
        return ButtonLabels.for_type(self.controller_type())

    # --- bridge to the batched sim ---

    def to_actions(self, device=None):
        """Snapshot for game/step.py's batched tick, one instance: left
        stick = movement, right stick = camera, Dodge hold = sprint, Jump
        held (the sim edge detects).  Each field a (1,) tensor on
        `device` (default: the card)."""
        import torch

        from ..game.step import Actions
        from ..types import resolve_device
        device = resolve_device(device)
        mx, my = self.left_stick()
        cx, cy = self.right_stick()

        def f32(v):
            return torch.tensor([v], dtype=torch.float32, device=device)

        def flag(v):
            return torch.tensor([bool(v)], device=device)

        return Actions(move_x=f32(mx), move_y=f32(my), cam_x=f32(cx),
                       cam_y=f32(cy), sprint=flag(self.action_down(
                           Action.DODGE)),
                       jump=flag(self.action_down(Action.JUMP)))
