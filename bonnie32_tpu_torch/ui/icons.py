"""7x7 bitmap toolbar icons rendered into the framebuffer (the port's own
copy of the JAX package's `ui/icons.py`; `draw_icon_centered` writes
through the port's ops/draw2d).

The reference's icon set is the Lucide icon font
(the reference's `src/ui/icons.rs` — named codepoints drawn with
`draw_icon_centered` :119).  The headless build draws the same named
icons as hand-drawn 7x7 pixel glyphs matching the 5x7 text font's
chunky style; `draw_icon_centered` centers one in a rect like the
reference.  Unknown names render as the fallback box.
"""

from typing import Dict

import numpy as np

ICON_W = ICON_H = 7

_RAW: Dict[str, str] = {
    # file (icons.rs:5-9)
    "save":        "XXXXX.X|X...XXX|X.X...X|X.....X|X.XXX.X|X.XXX.X|XXXXXXX",
    "folder_open": ".XX....|X..XXXX|X.....X|XXXXXXX|X.....X|X.....X|XXXXXXX",
    "file_plus":   ".XXXX..|.X..X..|.X..XX.|.X.X.X.|.XXXXX.|.X.X.X.|.XXXX..",
    "download":    "...X...|...X...|...X...|.X.X.X.|..XXX..|...X...|XXXXXXX",
    # edit (icons.rs:11-12)
    "undo":        "..X....|.X.....|XXXXXX.|.X....X|..X...X|......X|...XXX.",
    "redo":        "....X..|.....X.|.XXXXXX|X....X.|X...X..|X......|.XXX...",
    # transport (icons.rs:14-18)
    "play":        "X......|XX.....|XXX....|XXXX...|XXX....|XX.....|X......",
    "pause":       "XX..XX.|XX..XX.|XX..XX.|XX..XX.|XX..XX.|XX..XX.|XX..XX.",
    "stop":        "XXXXXX.|XXXXXX.|XXXXXX.|XXXXXX.|XXXXXX.|XXXXXX.|.......",
    "skip_back":   "X....X.|X...XX.|X..XXX.|X.XXXX.|X..XXX.|X...XX.|X....X.",
    "skip_forward": ".X....X|.XX...X|.XXX..X|.XXXX.X|.XXX..X|.XX...X|.X....X",
    # common ops (icons.rs:20-29)
    "plus":        "...X...|...X...|...X...|XXXXXXX|...X...|...X...|...X...",
    "minus":       ".......|.......|.......|XXXXXXX|.......|.......|.......",
    "trash":       "XXXXXXX|.X...X.|.X...X.|.X.X.X.|.X.X.X.|.X.X.X.|.XXXXX.",
    "move":        "...X...|..XXX..|...X...|.X.X.X.|XXXXXXX|.X.X.X.|...X...",
    "chevron_up":  ".......|...X...|..XXX..|.XX.XX.|XX...XX|.......|.......",
    "chevron_down": ".......|.......|XX...XX|.XX.XX.|..XXX..|...X...|.......",
    "chevron_left": "....X..|...XX..|..XX...|.XX....|..XX...|...XX..|....X..",
    "chevron_right": "..X....|..XX...|...XX..|....XX.|...XX..|..XX...|..X....",
    # world editor tools (icons.rs:34-38)
    "box":         "XXXXXXX|X.....X|X.....X|X.....X|X.....X|X.....X|XXXXXXX",
    "brick_wall":  "XXXXXXX|X..X..X|XXXXXXX|X.X..XX|XXXXXXX|X..X..X|XXXXXXX",
    "layers":      "...X...|..XXX..|.XXXXX.|..XXX..|.XXXXX.|..XXX..|...X...",
    "grid":        "X.X.X.X|.......|X.X.X.X|.......|X.X.X.X|.......|X.X.X.X",
    "door_closed": ".XXXXX.|.X...X.|.X...X.|.X..XX.|.X...X.|.X...X.|.XXXXX.",
    # modeler tools (icons.rs:40-49)
    "pointer":     "X......|XX.....|XXX....|XXXX...|XXXXX..|..XX...|...XX..",
    "rotate_3d":   ".XXXX..|X....X.|X......|X..XXX.|X....X.|.X...X.|..XXXX.",
    "scale_3d":    "XXX....|XX.....|X.X....|...X...|....X.X|.....XX|....XXX",
    "brush":       ".....XX|....XX.|...XX..|..XX...|.XX....|XX.....|X......",
    "paint_bucket": "...X...|..XXX..|.XXXXX.|XXXXXXX|.XXXXX.|..XXX..|....XX.",
    "scan":        "XX...XX|X.....X|.......|..XXX..|.......|X.....X|XX...XX",
    "circle_dot":  ".XXXXX.|X.....X|X..X..X|X.XXX.X|X..X..X|X.....X|.XXXXX.",
    "bone":        "XX...XX|XXX.XXX|..XXX..|...X...|..XXX..|XXX.XXX|XX...XX",
    # settings toggles (icons.rs:51-60)
    "waves":       ".......|XX..XX.|..XX..X|.......|XX..XX.|..XX..X|.......",
    "magnet":      "XX...XX|XX...XX|XX...XX|X.....X|X.....X|.X...X.|..XXX..",
    "monitor":     "XXXXXXX|X.....X|X.....X|XXXXXXX|...X...|..XXX..|.......",
    "sun":         "X..X..X|.XXXXX.|.X...X.|XX.X.XX|.X...X.|.XXXXX.|X..X..X",
    "palette":     ".XXXXX.|XX.X..X|X.....X|XX....X|X..X..X|X.....X|.XXXX..",
    # tabs (icons.rs:69-71)
    "house":       "...X...|..XXX..|.XXXXX.|XXXXXXX|.X...X.|.X.X.X.|.XXXXX.",
    "globe":       ".XXXXX.|X..X..X|XXXXXXX|X..X..X|XXXXXXX|X..X..X|.XXXXX.",
    "person":      "..XXX..|..XXX..|...X...|.XXXXX.|...X...|..X.X..|.X...X.",
    "music":       "..XXXXX|..X...X|..X...X|..X...X|XXX..XX|XXX..XX|.X...X.",
    # state (icons.rs:88-96)
    "eye":         ".......|..XXX..|.X...X.|X..X..X|.X...X.|..XXX..|.......",
    "eye_off":     "......X|..XXXX.|.X.XX..|X..X..X|..XX.X.|.XXXX..|X......",
    "lock":        "..XXX..|.X...X.|.X...X.|XXXXXXX|XX.X.XX|XX.X.XX|XXXXXXX",
    "check":       ".......|......X|.....XX|X...XX.|XX.XX..|.XXX...|..X....",
    "zoom_in":     ".XXXX..|X..X.X.|X.XXX.X|X..X.X.|.XXXX..|....XX.|.....XX",
    "zoom_out":    ".XXXX..|X....X.|X.XXX.X|X....X.|.XXXX..|....XX.|.....XX",
    "circle_x":    ".XXXXX.|X.....X|X.X.X.X|X..X..X|X.X.X.X|X.....X|.XXXXX.",
    # paint tools (icons.rs:107-115)
    "pencil":      "....XXX|...XX.X|..XX.XX|.XX.XX.|XX.XX..|X.XX...|XXX....",
    "eraser":      "...XXXX|..X...X|.X...X.|X...X..|X..X...|XXXX...|.......",
    "pipette":     "....XXX|.....XX|....X.X|...X...|..X....|.X.....|X......",
    "wand":        ".....XX|....XX.|...XX..|X.XX...|.XX....|XX.X...|X...X..",
    # fallback
    "_unknown":    "XXXXXXX|X.....X|X..X..X|X.XXX.X|X..X..X|X.....X|XXXXXXX",
}


def _compile(rows: str) -> np.ndarray:
    g = np.zeros((ICON_H, ICON_W), bool)
    for y, row in enumerate(rows.split("|")):
        for x, ch in enumerate(row[:ICON_W]):
            g[y, x] = ch == "X"
    return g


ICONS: Dict[str, np.ndarray] = {n: _compile(r) for n, r in _RAW.items()}


def icon_mask(name: str, scale: int = 1) -> np.ndarray:
    """(7s, 7s) bool mask; unknown names get the fallback box."""
    g = ICONS.get(name, ICONS["_unknown"])
    if scale > 1:
        g = np.kron(g, np.ones((scale, scale), bool))
    return g


def draw_icon_centered(fb, name: str, rect, rgb,
                       scale: int = 1):
    """icons.rs:119: blit the icon centred in `rect` (a ui.Rect) into
    every instance of the (I, H, W) framebuffer, on its device; the mask
    is host data."""
    from ..ops import draw2d

    mask = icon_mask(name, scale)
    mh, mw = mask.shape
    x = int(rect.x + (rect.w - mw) // 2)
    y = int(rect.y + (rect.h - mh) // 2)
    return draw2d.draw_mask(fb, x, y, mask, rgb)
