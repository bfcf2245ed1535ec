"""Immediate-mode UI toolkit of the port (headless; bonnie32_tpu/ui/).

Layout and interaction are host code driven by a virtual mouse and
keyboard, copied from the JAX package: the widgets (buttons, sliders,
lists, tab bars, dropdowns, the PS1 colour pickers, knobs), split and
collapsible panels, the radial menu, the text input's state machine, the
tool and action registries and the landing page's layout.  Painting goes
through the port's ops/draw2d into the same (I, H, W) framebuffers the
rasterizer writes, on their device, so editor overlays and panels
composite with rendered viewports: `UiContext.paint` replays a widget
frame's queue, `draw_text_input` and `landing.draw_landing` draw straight
into the framebuffers.  The drag tracker casts its rays through the
port's ops/picking on the device of the camera basis it is given.
"""

from .rect import Rect
from .theme import Theme, DEFAULT_THEME
from .context import MouseState, UiContext
from .widgets import (button, checkbox, drag_value, label_row, slider,
                      tab_bar, toolbar, vlist,
                      DropdownState, begin_dropdown, dropdown,
                      dropdown_block_clicks, dropdown_item,
                      dropdown_menu_rect, dropdown_trigger,
                      ps1_color_picker, ps1_color_picker_height,
                      ps1_color_picker_with_alpha,
                      ps1_color_picker_with_alpha_height,
                      ps1_color_picker_with_blend_mode,
                      ps1_color_picker_with_blend_mode_height,
                      three_way_toggle, PS1_PRESETS)
from .drag_tracker import DragConfig, DragState
from .panel import (SplitDir, SplitPanel, draw_panel, panel_content_rect,
                    draw_collapsible_panel, COLLAPSED_PANEL_HEIGHT)
from .text_input import TextInputState, draw_text_input, x_to_char_index
from .tool import (DragAcceptResult, InputState, ModifierKeys, MouseButtons,
                   Tool, ToolBox, ToolController, ToolRegistry)
from . import font
from . import icons

__all__ = ["Rect", "Theme", "DEFAULT_THEME", "UiContext", "MouseState",
           "button", "checkbox", "slider", "drag_value", "vlist",
           "label_row", "tab_bar", "toolbar", "DragState", "DragConfig",
           "SplitDir", "SplitPanel", "draw_panel", "panel_content_rect",
           "draw_collapsible_panel", "COLLAPSED_PANEL_HEIGHT", "font",
           "TextInputState", "draw_text_input", "x_to_char_index",
           "Tool", "ToolRegistry", "ToolBox", "ToolController",
           "InputState", "ModifierKeys", "MouseButtons",
           "DragAcceptResult", "icons"]
