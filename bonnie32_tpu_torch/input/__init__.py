"""Action-based input: Elden-Ring layout mapping, keyboard+gamepad merge.

Reference behavior: `/root/reference/src/input/` — Action enum
(actions.rs:19-63), InputState stick merging and action_down/pressed
(state.rs:10-200), radial deadzone (gamepad.rs:260), controller type
detection + button labels (controller_type.rs).

The reference polls macroquad/gilrs; here the backends are pluggable
`VirtualKeyboard` / `VirtualGamepad` objects (scripted rollouts, tests,
or a real host shim).  `InputState.to_actions()` bridges to the batched
simulation's Actions snapshot (game/step.py).  A copy of the JAX
package's input/ (bonnie32_tpu/input/), with its MIDI queue (`midi.py`,
over a pluggable backend) and its controller view (`debug.py`, painted
through the port's UiContext).
"""

from .actions import (ACTIONS, Action, GAMEPAD_BINDINGS, KEYBOARD_BINDINGS,
                      KEYBOARD_PRESSED_ACTIONS)
from .state import (ButtonLabels, ControllerType, InputState, VirtualGamepad,
                    VirtualKeyboard, apply_deadzone)

__all__ = ["Action", "ACTIONS", "KEYBOARD_BINDINGS", "GAMEPAD_BINDINGS",
           "KEYBOARD_PRESSED_ACTIONS", "InputState", "VirtualKeyboard",
           "VirtualGamepad", "apply_deadzone", "ControllerType",
           "ButtonLabels"]
