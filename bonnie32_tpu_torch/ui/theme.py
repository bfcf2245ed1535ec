"""UI theme colors (ui/theme.rs — dark editor palette); the port's own
copy of the JAX package's `ui/theme.py`, host code."""

import dataclasses
from typing import Tuple

RGB = Tuple[int, int, int]


@dataclasses.dataclass(frozen=True)
class Theme:
    background: RGB = (24, 24, 28)
    panel: RGB = (34, 34, 40)
    panel_border: RGB = (52, 52, 60)
    widget: RGB = (48, 48, 56)
    widget_hover: RGB = (66, 66, 78)
    widget_active: RGB = (90, 90, 110)
    accent: RGB = (96, 140, 220)
    text: RGB = (210, 210, 216)
    text_dim: RGB = (140, 140, 148)
    slider_track: RGB = (40, 40, 46)
    slider_fill: RGB = (96, 140, 220)


DEFAULT_THEME = Theme()
