"""Action definitions and default bindings (actions.rs:19-63,
state.rs:73-175)."""

import enum


class Action(enum.Enum):
    """Elden-Ring controller layout (actions.rs:19)."""

    # movement (analog - left stick / WASD)
    MOVE_FORWARD = "move_forward"
    MOVE_BACKWARD = "move_backward"
    MOVE_LEFT = "move_left"
    MOVE_RIGHT = "move_right"
    # camera (analog - right stick / mouse)
    LOOK_UP = "look_up"
    LOOK_DOWN = "look_down"
    LOOK_LEFT = "look_left"
    LOOK_RIGHT = "look_right"
    # combat
    ATTACK = "attack"                 # RB
    STRONG_ATTACK = "strong_attack"   # RT
    SKILL = "skill"                   # LT
    GUARD = "guard"                   # LB
    # face buttons
    JUMP = "jump"                     # A
    DODGE = "dodge"                   # B (sprint on hold)
    USE_ITEM = "use_item"             # X
    INTERACT = "interact"             # Y
    # stick clicks
    CROUCH = "crouch"                 # L3
    LOCK_ON = "lock_on"               # R3
    # d-pad
    SWITCH_LEFT_WEAPON = "switch_left_weapon"
    SWITCH_RIGHT_WEAPON = "switch_right_weapon"
    SWITCH_SPELL = "switch_spell"
    SWITCH_ITEM = "switch_item"
    # system
    OPEN_MENU = "open_menu"
    OPEN_MAP = "open_map"
    # free-fly
    FLY_UP = "fly_up"
    FLY_DOWN = "fly_down"


ACTIONS = list(Action)

# keyboard_down mapping (state.rs:73-101); keys are lowercase names
KEYBOARD_BINDINGS = {
    Action.MOVE_FORWARD: "w",
    Action.MOVE_BACKWARD: "s",
    Action.MOVE_LEFT: "a",
    Action.MOVE_RIGHT: "d",
    Action.JUMP: "space",
    Action.DODGE: "left_shift",
    Action.ATTACK: "j",
    Action.STRONG_ATTACK: "k",
    Action.GUARD: "l",
    Action.SKILL: "i",
    Action.USE_ITEM: "r",
    Action.INTERACT: "e",
    Action.CROUCH: "c",
    Action.LOCK_ON: "tab",
    Action.OPEN_MENU: "escape",
    Action.FLY_UP: "q",
    Action.FLY_DOWN: "e",
}

# keyboard_pressed supports a subset (state.rs:140-151)
KEYBOARD_PRESSED_ACTIONS = {
    Action.JUMP, Action.DODGE, Action.ATTACK, Action.STRONG_ATTACK,
    Action.INTERACT, Action.OPEN_MENU, Action.LOCK_ON, Action.CROUCH,
}

# gamepad button names per action (state.rs:104-136); Elden Ring layout
GAMEPAD_BINDINGS = {
    Action.JUMP: "a",
    Action.DODGE: "b",
    Action.USE_ITEM: "x",
    Action.INTERACT: "y",
    Action.GUARD: "lb",
    Action.SKILL: "lt",
    Action.ATTACK: "rb",
    Action.STRONG_ATTACK: "rt",
    Action.CROUCH: "l3",
    Action.LOCK_ON: "r3",
    Action.SWITCH_LEFT_WEAPON: "dpad_left",
    Action.SWITCH_RIGHT_WEAPON: "dpad_right",
    Action.SWITCH_SPELL: "dpad_up",
    Action.SWITCH_ITEM: "dpad_down",
    Action.OPEN_MENU: "start",
    Action.OPEN_MAP: "select",
    Action.FLY_UP: "lb",
    Action.FLY_DOWN: "lt",
}
