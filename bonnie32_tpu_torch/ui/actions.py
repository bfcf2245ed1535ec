"""Action/shortcut framework: registry, rebindable shortcuts, context.
(The port's own copy of the JAX package's `ui/actions.py`, host code.)

Port of `/root/reference/src/ui/actions.rs`: `Shortcut` (key +
ctrl/shift/alt with display strings), `ActionContext` (flags +
text-editing suppression), builder-style `Action` definitions with
enabled/checked predicates, and the `ActionRegistry` with
shortcut-conflict-checked rebinding and pressed-shortcut dispatch.
`create_modeler_actions` mirrors the modeler's registry
(`modeler/actions.rs:32`) with its real default shortcuts.
"""

import dataclasses
from typing import Callable, Dict, List, Optional, Set


@dataclasses.dataclass(frozen=True)
class Shortcut:
    """ui/actions.rs:32 — key name + modifiers."""

    key_name: str
    ctrl: bool = False
    shift: bool = False
    alt: bool = False

    @classmethod
    def key(cls, k: str) -> "Shortcut":
        return cls(k)

    @classmethod
    def with_ctrl(cls, k: str) -> "Shortcut":
        return cls(k, ctrl=True)

    @classmethod
    def ctrl_shift(cls, k: str) -> "Shortcut":
        return cls(k, ctrl=True, shift=True)

    @classmethod
    def with_shift(cls, k: str) -> "Shortcut":
        return cls(k, shift=True)

    @classmethod
    def with_alt(cls, k: str) -> "Shortcut":
        return cls(k, alt=True)

    def display(self) -> str:
        """ui/actions.rs:107 — "Ctrl+Shift+S" style."""
        parts = []
        if self.ctrl:
            parts.append("Ctrl+")
        if self.shift:
            parts.append("Shift+")
        if self.alt:
            parts.append("Alt+")
        parts.append(self.key_name.upper() if len(self.key_name) == 1
                     else self.key_name.capitalize())
        return "".join(parts)

    def is_pressed(self, pressed_keys: Set[str], ctrl: bool, shift: bool,
                   alt: bool) -> bool:
        return (self.key_name in pressed_keys and ctrl == self.ctrl
                and shift == self.shift and alt == self.alt)


@dataclasses.dataclass
class ActionContext:
    """ui/actions.rs:223 — per-frame dispatch context."""

    flags: Set[str] = dataclasses.field(default_factory=set)
    text_editing: bool = False
    pressed_keys: Set[str] = dataclasses.field(default_factory=set)
    ctrl: bool = False
    shift: bool = False
    alt: bool = False
    # typed predicates (ui/actions.rs:223-231)
    can_undo: bool = False
    can_redo: bool = False
    has_selection: bool = False
    has_clipboard: bool = False
    mode: str = ""

    def with_flag(self, flag: str) -> "ActionContext":
        self.flags.add(flag)
        return self

    def has_flag(self, flag: str) -> bool:
        return flag in self.flags


def _always_enabled(ctx: ActionContext) -> bool:
    return True


@dataclasses.dataclass
class Action:
    """ui/actions.rs:272 — builder-style definition."""

    id: str
    label: str = ""
    default_shortcut: Optional[Shortcut] = None
    shortcut: Optional[Shortcut] = None
    icon: Optional[str] = None
    status_tip: str = ""
    category: str = "General"
    enabled_fn: Callable[[ActionContext], bool] = _always_enabled
    checked_fn: Optional[Callable[[ActionContext], bool]] = None

    def with_label(self, label: str) -> "Action":
        self.label = label
        return self

    def with_shortcut(self, shortcut: Shortcut) -> "Action":
        self.default_shortcut = shortcut
        self.shortcut = shortcut
        return self

    def with_tip(self, tip: str) -> "Action":
        self.status_tip = tip
        return self

    def with_category(self, category: str) -> "Action":
        self.category = category
        return self

    def enabled_when(self, fn) -> "Action":
        self.enabled_fn = fn
        return self

    def checked_when(self, fn) -> "Action":
        self.checked_fn = fn
        return self

    def is_enabled(self, ctx: ActionContext) -> bool:
        """Text editing suppresses every action (ui/actions.rs:336)."""
        if ctx.text_editing:
            return False
        return self.enabled_fn(ctx)

    def is_checked(self, ctx: ActionContext) -> bool:
        return bool(self.checked_fn and self.checked_fn(ctx))

    def is_triggered(self, ctx: ActionContext) -> bool:
        if self.shortcut is None or not self.is_enabled(ctx):
            return False
        return self.shortcut.is_pressed(ctx.pressed_keys, ctx.ctrl,
                                        ctx.shift, ctx.alt)

    def tooltip(self) -> str:
        if self.shortcut is not None:
            return f"{self.label} ({self.shortcut.display()})"
        return self.label


class ActionRegistry:
    """ui/actions.rs:404 — id map + shortcut map with conflict checks."""

    def __init__(self):
        self.actions: Dict[str, Action] = {}
        self.shortcut_map: Dict[Shortcut, str] = {}

    def register(self, action: Action) -> None:
        if action.shortcut is not None:
            self.shortcut_map[action.shortcut] = action.id
        self.actions[action.id] = action

    def get(self, aid: str) -> Optional[Action]:
        return self.actions.get(aid)

    def triggered(self, aid: str, ctx: ActionContext) -> bool:
        a = self.actions.get(aid)
        return a.is_triggered(ctx) if a else False

    def is_enabled(self, aid: str, ctx: ActionContext) -> bool:
        a = self.actions.get(aid)
        return a.is_enabled(ctx) if a else False

    def is_checked(self, aid: str, ctx: ActionContext) -> bool:
        a = self.actions.get(aid)
        return a.is_checked(ctx) if a else False

    def tooltip(self, aid: str) -> str:
        a = self.actions.get(aid)
        return a.tooltip() if a else ""

    def triggered_ids(self, ctx: ActionContext) -> List[str]:
        """All actions fired by the pressed keys this frame."""
        return [a.id for a in self.actions.values() if a.is_triggered(ctx)]

    def rebind(self, aid: str,
               new_shortcut: Optional[Shortcut]) -> None:
        """ui/actions.rs:447 — conflict-checked rebinding."""
        action = self.actions.get(aid)
        if action is None:
            raise KeyError("Action not found")
        if new_shortcut is not None:
            owner = self.shortcut_map.get(new_shortcut)
            if owner is not None and owner != aid:
                raise ValueError("Shortcut already in use")
        if action.shortcut is not None:
            self.shortcut_map.pop(action.shortcut, None)
        action.shortcut = new_shortcut
        if new_shortcut is not None:
            self.shortcut_map[new_shortcut] = aid

    def reset_shortcut(self, aid: str) -> None:
        a = self.actions.get(aid)
        if a is not None:
            self.rebind(aid, a.default_shortcut)

    def by_category(self) -> Dict[str, List[Action]]:
        out: Dict[str, List[Action]] = {}
        for a in self.actions.values():
            out.setdefault(a.category, []).append(a)
        return out


def _has_selection(ctx: ActionContext) -> bool:
    return ctx.has_flag("has_selection")


def create_modeler_actions() -> ActionRegistry:
    """modeler/actions.rs:32 — the modeler's action set with its real
    default shortcuts (representative core subset)."""
    r = ActionRegistry()
    r.register(Action("file.new").with_label("New")
               .with_shortcut(Shortcut.with_ctrl("n"))
               .with_tip("Create a new model").with_category("File"))
    r.register(Action("file.open").with_label("Open")
               .with_shortcut(Shortcut.with_ctrl("o"))
               .with_tip("Open an existing model").with_category("File"))
    r.register(Action("file.save").with_label("Save")
               .with_shortcut(Shortcut.with_ctrl("s"))
               .with_tip("Save the current model").with_category("File"))
    r.register(Action("file.save_as").with_label("Save As...")
               .with_shortcut(Shortcut.ctrl_shift("s"))
               .with_tip("Save to a new file").with_category("File"))
    r.register(Action("file.browse_models").with_label("Browse Assets")
               .with_tip("Open asset browser").with_category("File"))
    r.register(Action("edit.undo").with_label("Undo")
               .with_shortcut(Shortcut.with_ctrl("z"))
               .with_category("Edit"))
    r.register(Action("edit.redo").with_label("Redo")
               .with_shortcut(Shortcut.ctrl_shift("z"))
               .with_category("Edit"))
    r.register(Action("edit.copy").with_label("Copy")
               .with_shortcut(Shortcut.with_ctrl("c"))
               .with_category("Edit").enabled_when(_has_selection))
    r.register(Action("edit.paste").with_label("Paste")
               .with_shortcut(Shortcut.with_ctrl("v"))
               .with_category("Edit"))
    r.register(Action("edit.delete").with_label("Delete")
               .with_shortcut(Shortcut.key("x"))
               .with_category("Edit").enabled_when(_has_selection))
    r.register(Action("transform.grab").with_label("Grab")
               .with_shortcut(Shortcut.key("g"))
               .with_category("Transform").enabled_when(_has_selection))
    r.register(Action("transform.rotate").with_label("Rotate")
               .with_shortcut(Shortcut.key("r"))
               .with_category("Transform").enabled_when(_has_selection))
    r.register(Action("transform.scale").with_label("Scale")
               .with_shortcut(Shortcut.key("t"))
               .with_category("Transform").enabled_when(_has_selection))
    r.register(Action("mesh.extrude").with_label("Extrude")
               .with_shortcut(Shortcut.key("e"))
               .with_category("Mesh").enabled_when(_has_selection))
    r.register(Action("select.all").with_label("Select All")
               .with_shortcut(Shortcut.with_ctrl("a"))
               .with_category("Select"))
    return r


# Editor flags (editor/actions.rs:5-13) as ActionContext flag strings
EDITOR_FLAGS = ("room_selected", "sector_selected", "object_selected",
                "portal_selected", "geometry_mode", "texture_mode",
                "object_mode", "has_level")


def _flag(name: str) -> Callable[[ActionContext], bool]:
    return lambda ctx: ctx.has_flag(name)


def create_editor_actions() -> ActionRegistry:
    """editor/actions.rs:15 — the world editor's registry with its real
    shortcuts and enabling predicates."""
    r = ActionRegistry()
    r.register(Action("file.new").with_label("New Level")
               .with_shortcut(Shortcut.with_ctrl("n"))
               .with_tip("Create a new level").with_category("File"))
    r.register(Action("file.open").with_label("Open Level")
               .with_shortcut(Shortcut.with_ctrl("o"))
               .with_tip("Open an existing level").with_category("File"))
    r.register(Action("file.save").with_label("Save")
               .with_shortcut(Shortcut.with_ctrl("s"))
               .with_tip("Save the current level").with_category("File"))
    r.register(Action("file.save_as").with_label("Save As...")
               .with_shortcut(Shortcut.ctrl_shift("s"))
               .with_tip("Save to a new file").with_category("File"))
    r.register(Action("edit.undo").with_label("Undo")
               .with_shortcut(Shortcut.with_ctrl("z"))
               .with_category("Edit")
               .enabled_when(lambda ctx: ctx.can_undo))
    r.register(Action("edit.redo").with_label("Redo")
               .with_shortcut(Shortcut.ctrl_shift("z"))
               .with_category("Edit")
               .enabled_when(lambda ctx: ctx.can_redo))
    r.register(Action("edit.copy").with_label("Copy")
               .with_shortcut(Shortcut.with_ctrl("c"))
               .with_category("Edit")
               .enabled_when(lambda ctx:
                             ctx.has_flag("object_selected")
                             or ctx.has_flag("sector_selected")))
    r.register(Action("edit.paste").with_label("Paste")
               .with_shortcut(Shortcut.with_ctrl("v"))
               .with_category("Edit")
               .enabled_when(lambda ctx: ctx.has_clipboard))
    r.register(Action("edit.delete").with_label("Delete")
               .with_shortcut(Shortcut.key("delete"))
               .with_category("Edit")
               .enabled_when(lambda ctx: ctx.has_selection))
    r.register(Action("room.add").with_label("Add Room")
               .with_category("Room"))
    r.register(Action("room.delete").with_label("Delete Room")
               .with_category("Room")
               .enabled_when(_flag("room_selected")))
    r.register(Action("room.duplicate").with_label("Duplicate Room")
               .with_category("Room")
               .enabled_when(_flag("room_selected")))
    for aid, label in (("sector.raise_floor", "Raise Floor"),
                       ("sector.lower_floor", "Lower Floor"),
                       ("sector.raise_ceiling", "Raise Ceiling"),
                       ("sector.lower_ceiling", "Lower Ceiling")):
        r.register(Action(aid).with_label(label).with_category("Sector")
                   .enabled_when(_flag("sector_selected")))
    r.register(Action("portal.create").with_label("Create Portal")
               .with_category("Portal")
               .enabled_when(_flag("sector_selected")))
    r.register(Action("portal.delete").with_label("Delete Portal")
               .with_category("Portal")
               .enabled_when(_flag("portal_selected")))
    r.register(Action("object.add").with_label("Add Object")
               .with_category("Object"))
    r.register(Action("object.delete").with_label("Delete Object")
               .with_category("Object")
               .enabled_when(_flag("object_selected")))
    r.register(Action("view.center_selection")
               .with_label("Center Camera on Selection")
               .with_shortcut(Shortcut("."))
               .with_tip("Orbit/look at the selection (viewport_3d.rs:507)")
               .with_category("View"))
    r.register(Action("view.toggle_grid").with_label("Toggle Grid")
               .with_category("View"))
    r.register(Action("view.zoom_in").with_label("Zoom In")
               .with_shortcut(Shortcut.key("="))
               .with_category("View"))
    r.register(Action("view.zoom_out").with_label("Zoom Out")
               .with_shortcut(Shortcut.key("-"))
               .with_category("View"))
    return r


def create_tracker_actions() -> ActionRegistry:
    """tracker/actions.rs — playback/navigation/edit/note/pattern set
    with the tracker's real shortcuts."""
    r = ActionRegistry()
    r.register(Action("playback.toggle").with_label("Play/Pause")
               .with_shortcut(Shortcut.key("space"))
               .with_category("Playback"))
    r.register(Action("playback.stop").with_label("Stop")
               .with_shortcut(Shortcut.key("escape"))
               .with_category("Playback"))
    r.register(Action("playback.rewind").with_label("Rewind")
               .with_category("Playback"))
    for aid, label, key in (("nav.up", "Move Up", "up"),
                            ("nav.down", "Move Down", "down"),
                            ("nav.left", "Move Left", "left"),
                            ("nav.right", "Move Right", "right"),
                            ("nav.next_channel", "Next Channel", "tab"),
                            ("nav.page_up", "Page Up", "pageup"),
                            ("nav.page_down", "Page Down", "pagedown"),
                            ("nav.home", "Go to Start", "home"),
                            ("nav.end", "Go to End", "end")):
        r.register(Action(aid).with_label(label)
                   .with_shortcut(Shortcut.key(key))
                   .with_category("Navigation"))
    r.register(Action("nav.prev_channel").with_label("Previous Channel")
               .with_shortcut(Shortcut.with_shift("tab"))
               .with_category("Navigation"))
    r.register(Action("octave.up").with_label("Octave Up")
               .with_shortcut(Shortcut.key("kp_add"))
               .with_category("Octave"))
    r.register(Action("octave.down").with_label("Octave Down")
               .with_shortcut(Shortcut.key("kp_subtract"))
               .with_category("Octave"))
    r.register(Action("edit.copy").with_label("Copy")
               .with_shortcut(Shortcut.with_ctrl("c"))
               .with_category("Edit"))
    r.register(Action("edit.paste").with_label("Paste")
               .with_shortcut(Shortcut.with_ctrl("v"))
               .with_category("Edit")
               .enabled_when(lambda ctx: ctx.has_clipboard))
    r.register(Action("edit.cut").with_label("Cut")
               .with_shortcut(Shortcut.with_ctrl("x"))
               .with_category("Edit"))
    r.register(Action("edit.select_all").with_label("Select All")
               .with_shortcut(Shortcut.with_ctrl("a"))
               .with_category("Edit"))
    r.register(Action("note.delete").with_label("Delete Note")
               .with_shortcut(Shortcut.key("delete"))
               .with_category("Note Entry")
               .enabled_when(_flag("note_column")))
    r.register(Action("note.off").with_label("Note Off")
               .with_shortcut(Shortcut.key("'"))
               .with_category("Note Entry")
               .enabled_when(_flag("note_column")))
    r.register(Action("pattern.new").with_label("New Pattern")
               .with_category("Pattern"))
    r.register(Action("pattern.duplicate").with_label("Duplicate Pattern")
               .with_category("Pattern")
               .enabled_when(_flag("has_pattern")))
    r.register(Action("pattern.clear").with_label("Clear Pattern")
               .with_category("Pattern")
               .enabled_when(_flag("has_pattern")))
    r.register(Action("instrument.prev").with_label("Previous Instrument")
               .with_category("Instrument"))
    r.register(Action("instrument.next").with_label("Next Instrument")
               .with_category("Instrument"))
    return r
