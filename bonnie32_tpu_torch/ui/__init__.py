"""Immediate-mode UI toolkit of the port (headless; bonnie32_tpu/ui/).

Layout and interaction are host code driven by a virtual mouse and
keyboard, copied from the JAX package; painting goes through the port's
ops/draw2d into the same (I, H, W) framebuffers the rasterizer writes, on
their device, so editor overlays and panels composite with rendered
viewports.  Ported so far: Rect, Theme, UiContext (with MouseState), the
5x7 font and the icons.  The widgets, panels, text input, tools and the
drag tracker come with the editor layouts that use them.
"""

from .rect import Rect
from .theme import Theme, DEFAULT_THEME
from .context import MouseState, UiContext
from . import font
from . import icons

__all__ = ["Rect", "Theme", "DEFAULT_THEME", "UiContext", "MouseState",
           "font", "icons"]
