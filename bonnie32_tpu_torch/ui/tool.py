"""Tool lifecycle, input routing, and the modal ToolBox coordinator.
(The port's own copy of the JAX package's `ui/tool.py`, host code.)

Port of `/root/reference/src/ui/tool.rs` (the `Tool` activation
lifecycle + `ToolRegistry`), `tool_controller.rs` (`InputState` and the
`ToolController` mouse-event interface), and `tool_box.rs` (the
`ToolBox`: a modal tool stack with exclusive groups and
suppress-while-active relationships, restoring suppressed tools when
their suppressor deactivates).
"""

import dataclasses
import enum
from typing import Dict, List, Optional, Sequence, Set, Tuple


class Tool:
    """tool.rs:1 — activation lifecycle.  Subclasses override
    do_activate/do_deactivate (returning False vetoes the transition)."""

    id: str = ""
    label: str = ""

    def __init__(self, tool_id: str = "", label: str = ""):
        if tool_id:
            self.id = tool_id
        self.label = label or self.label or self.id
        self._active = False

    def active(self) -> bool:
        return self._active

    def activate(self) -> bool:
        """False when already active (tool.rs:9-14)."""
        if self.active():
            return False
        return self.do_activate()

    def deactivate(self) -> bool:
        if not self.active():
            return False
        return self.do_deactivate()

    def do_activate(self) -> bool:
        self._active = True
        return True

    def do_deactivate(self) -> bool:
        self._active = False
        return True


class ToolRegistry:
    """tool.rs:31 — id → Tool lookup (a concrete dict registry; the
    reference leaves this as a trait for each editor to implement)."""

    def __init__(self, tools: Sequence[Tool] = ()):
        self._tools: Dict[str, Tool] = {}
        for t in tools:
            self.add(t)

    def add(self, tool: Tool) -> None:
        self._tools[tool.id] = tool

    def get_tool(self, tool_id: str) -> Optional[Tool]:
        return self._tools.get(tool_id)

    def tool_ids(self) -> List[str]:
        return list(self._tools)


# -- tool_controller.rs input types ---------------------------------------

@dataclasses.dataclass(frozen=True)
class ModifierKeys:
    """tool_controller.rs:4."""

    shift: bool = False
    ctrl: bool = False
    alt: bool = False


@dataclasses.dataclass(frozen=True)
class MouseButtons:
    left: bool = False
    right: bool = False
    middle: bool = False


@dataclasses.dataclass
class InputState:
    """tool_controller.rs:17 — one frame of routed mouse input."""

    mouse_x: float = 0.0
    mouse_y: float = 0.0
    mouse_dx: float = 0.0
    mouse_dy: float = 0.0
    buttons: MouseButtons = MouseButtons()
    left_pressed: bool = False
    left_released: bool = False
    right_pressed: bool = False
    scroll: float = 0.0
    modifiers: ModifierKeys = ModifierKeys()
    double_click: bool = False

    def mouse_pos(self) -> Tuple[float, float]:
        return (self.mouse_x, self.mouse_y)

    def mouse_delta(self) -> Tuple[float, float]:
        return (self.mouse_dx, self.mouse_dy)

    def has_modifier(self) -> bool:
        m = self.modifiers
        return m.shift or m.ctrl or m.alt


class DragAcceptResult(enum.Enum):
    NONE = "none"
    STARTED = "started"


class ToolController(Tool):
    """tool_controller.rs:50 — per-event hooks; defaults decline."""

    def mouse_click(self, input_state: InputState) -> bool:
        return False

    def mouse_double_click(self, input_state: InputState) -> bool:
        return False

    def mouse_move(self, input_state: InputState) -> None:
        pass

    def mouse_scroll(self, input_state: InputState) -> None:
        pass

    def accept_mouse_drag(self, input_state: InputState) -> DragAcceptResult:
        return DragAcceptResult.NONE

    def modifier_key_change(self, input_state: InputState) -> None:
        pass

    def cancel(self) -> bool:
        return False


# -- tool_box.rs ----------------------------------------------------------

class ToolBox:
    """tool_box.rs:4 — modal tool stack + exclusivity + suppression.

    Activating a tool deactivates others in its exclusive groups and
    temporarily suppresses its `suppress_while_active` targets; when the
    suppressor deactivates, suppressed tools reactivate and rejoin the
    modal stack.
    """

    def __init__(self):
        self.modal_tool_stack: List[str] = []
        self._exclusive_groups: List[List[str]] = []
        self._suppressed_by: Dict[str, List[str]] = {}
        self._suppressed_tools: Set[str] = set()
        self._enabled = True

    def add_exclusive_group(self, tool_ids: Sequence[str]) -> None:
        if len(tool_ids) > 1:
            self._exclusive_groups.append(list(tool_ids))

    def suppress_while_active(self, primary: str,
                              suppressed: Sequence[str]) -> None:
        self._suppressed_by.setdefault(primary, []).extend(suppressed)

    def enabled(self) -> bool:
        return self._enabled

    def enable(self) -> None:
        self._enabled = True

    def disable(self) -> None:
        self._enabled = False

    def active_tool(self) -> Optional[str]:
        return self.modal_tool_stack[-1] if self.modal_tool_stack else None

    def is_tool_active(self, tool_id: str) -> bool:
        return tool_id in self.modal_tool_stack

    def is_tool_suppressed(self, tool_id: str) -> bool:
        return tool_id in self._suppressed_tools

    def toggle_tool(self, tool_id: str, registry: ToolRegistry) -> None:
        if self.is_tool_active(tool_id):
            self.deactivate_tool(tool_id, registry)
        else:
            self.activate_tool(tool_id, registry)

    def activate_tool(self, tool_id: str, registry: ToolRegistry) -> None:
        """tool_box.rs:73 — exclusivity first, then suppression, then
        push onto the modal stack (only if the tool accepts)."""
        if not self._enabled:
            return
        tool = registry.get_tool(tool_id)
        if tool is None or tool.active():
            return

        for excluded_id in self._excluded_tools(tool_id):
            excluded = registry.get_tool(excluded_id)
            if excluded is not None and excluded.active():
                self._deactivate_internal(excluded_id, registry)

        previously_suppressed = self._currently_suppressed()
        if not tool.activate():
            return
        for sid in self._suppressed_by.get(tool_id, []):
            if sid in previously_suppressed:
                continue
            s = registry.get_tool(sid)
            if s is not None and s.active():
                s.deactivate()
                self._suppressed_tools.add(sid)
                self.modal_tool_stack = [i for i in self.modal_tool_stack
                                         if i != sid]
        self.modal_tool_stack.append(tool_id)

    def deactivate_tool(self, tool_id: str, registry: ToolRegistry) -> None:
        self._deactivate_internal(tool_id, registry)

    def _deactivate_internal(self, tool_id: str,
                             registry: ToolRegistry) -> None:
        """tool_box.rs:119 — pop, then restore tools that are no longer
        suppressed by anything still on the stack."""
        previously_suppressed = self._currently_suppressed()
        tool = registry.get_tool(tool_id)
        if tool is not None and tool.active():
            tool.deactivate()
        self.modal_tool_stack = [i for i in self.modal_tool_stack
                                 if i != tool_id]
        still_suppressed = self._currently_suppressed()
        for rid in previously_suppressed - still_suppressed:
            if rid in self._suppressed_tools:
                self._suppressed_tools.discard(rid)
                t = registry.get_tool(rid)
                if t is not None and t.activate():
                    self.modal_tool_stack.append(rid)

    def deactivate_all(self, registry: ToolRegistry) -> None:
        for tool_id in list(self.modal_tool_stack):
            self._deactivate_internal(tool_id, registry)
        self._suppressed_tools.clear()

    def _excluded_tools(self, tool_id: str) -> Set[str]:
        result: Set[str] = set()
        for group in self._exclusive_groups:
            if tool_id in group:
                result.update(group)
        result.discard(tool_id)
        return result

    def _currently_suppressed(self) -> Set[str]:
        result: Set[str] = set()
        for active_id in self.modal_tool_stack:
            result.update(self._suppressed_by.get(active_id, []))
        return result
