"""5x7 bitmap font rasterized into the framebuffer.
(The port's own copy of the JAX package's `ui/font.py`, host code.)

The reference draws every piece of UI text into its frame via macroquad's
ttf path (VT323 + the Lucide icon font, the reference's `src/ui/`); the
headless build uses a hand-drawn 5x7 pixel font in the same spirit as the
console's chunky text.  Glyphs cover printable ASCII 32..126; unknown
characters render as the 0x7F box.

`render_text_mask` is host-side numpy (text content is host data); the
blit into a FrameBuffers happens in ops/draw2d.draw_text.
"""

from typing import Dict

import numpy as np

GLYPH_W = 5
GLYPH_H = 7
ADVANCE = 6   # 1px spacing

_RAW: Dict[str, str] = {
    " ": ".....|.....|.....|.....|.....|.....|.....",
    "!": "..X..|..X..|..X..|..X..|..X..|.....|..X..",
    '"': ".X.X.|.X.X.|.....|.....|.....|.....|.....",
    "#": ".X.X.|XXXXX|.X.X.|.X.X.|.X.X.|XXXXX|.X.X.",
    "$": "..X..|.XXXX|X.X..|.XXX.|..X.X|XXXX.|..X..",
    "%": "XX..X|XX..X|...X.|..X..|.X...|X..XX|X..XX",
    "&": ".XX..|X..X.|X.X..|.X...|X.X.X|X..X.|.XX.X",
    "'": "..X..|..X..|.....|.....|.....|.....|.....",
    "(": "...X.|..X..|.X...|.X...|.X...|..X..|...X.",
    ")": ".X...|..X..|...X.|...X.|...X.|..X..|.X...",
    "*": ".....|..X..|X.X.X|.XXX.|X.X.X|..X..|.....",
    "+": ".....|..X..|..X..|XXXXX|..X..|..X..|.....",
    ",": ".....|.....|.....|.....|.....|..X..|.X...",
    "-": ".....|.....|.....|XXXXX|.....|.....|.....",
    ".": ".....|.....|.....|.....|.....|.XX..|.XX..",
    "/": "....X|....X|...X.|..X..|.X...|X....|X....",
    "0": ".XXX.|X...X|X..XX|X.X.X|XX..X|X...X|.XXX.",
    "1": "..X..|.XX..|..X..|..X..|..X..|..X..|.XXX.",
    "2": ".XXX.|X...X|....X|...X.|..X..|.X...|XXXXX",
    "3": ".XXX.|X...X|....X|..XX.|....X|X...X|.XXX.",
    "4": "...X.|..XX.|.X.X.|X..X.|XXXXX|...X.|...X.",
    "5": "XXXXX|X....|XXXX.|....X|....X|X...X|.XXX.",
    "6": ".XXX.|X....|X....|XXXX.|X...X|X...X|.XXX.",
    "7": "XXXXX|....X|...X.|..X..|..X..|..X..|..X..",
    "8": ".XXX.|X...X|X...X|.XXX.|X...X|X...X|.XXX.",
    "9": ".XXX.|X...X|X...X|.XXXX|....X|....X|.XXX.",
    ":": ".....|.XX..|.XX..|.....|.XX..|.XX..|.....",
    ";": ".....|.XX..|.XX..|.....|.XX..|..X..|.X...",
    "<": "...X.|..X..|.X...|X....|.X...|..X..|...X.",
    "=": ".....|.....|XXXXX|.....|XXXXX|.....|.....",
    ">": ".X...|..X..|...X.|....X|...X.|..X..|.X...",
    "?": ".XXX.|X...X|....X|...X.|..X..|.....|..X..",
    "@": ".XXX.|X...X|X.XXX|X.X.X|X.XX.|X....|.XXX.",
    "A": ".XXX.|X...X|X...X|XXXXX|X...X|X...X|X...X",
    "B": "XXXX.|X...X|X...X|XXXX.|X...X|X...X|XXXX.",
    "C": ".XXX.|X...X|X....|X....|X....|X...X|.XXX.",
    "D": "XXXX.|X...X|X...X|X...X|X...X|X...X|XXXX.",
    "E": "XXXXX|X....|X....|XXXX.|X....|X....|XXXXX",
    "F": "XXXXX|X....|X....|XXXX.|X....|X....|X....",
    "G": ".XXX.|X...X|X....|X.XXX|X...X|X...X|.XXXX",
    "H": "X...X|X...X|X...X|XXXXX|X...X|X...X|X...X",
    "I": ".XXX.|..X..|..X..|..X..|..X..|..X..|.XXX.",
    "J": "..XXX|...X.|...X.|...X.|...X.|X..X.|.XX..",
    "K": "X...X|X..X.|X.X..|XX...|X.X..|X..X.|X...X",
    "L": "X....|X....|X....|X....|X....|X....|XXXXX",
    "M": "X...X|XX.XX|X.X.X|X.X.X|X...X|X...X|X...X",
    "N": "X...X|XX..X|X.X.X|X..XX|X...X|X...X|X...X",
    "O": ".XXX.|X...X|X...X|X...X|X...X|X...X|.XXX.",
    "P": "XXXX.|X...X|X...X|XXXX.|X....|X....|X....",
    "Q": ".XXX.|X...X|X...X|X...X|X.X.X|X..X.|.XX.X",
    "R": "XXXX.|X...X|X...X|XXXX.|X.X..|X..X.|X...X",
    "S": ".XXXX|X....|X....|.XXX.|....X|....X|XXXX.",
    "T": "XXXXX|..X..|..X..|..X..|..X..|..X..|..X..",
    "U": "X...X|X...X|X...X|X...X|X...X|X...X|.XXX.",
    "V": "X...X|X...X|X...X|X...X|X...X|.X.X.|..X..",
    "W": "X...X|X...X|X...X|X.X.X|X.X.X|XX.XX|X...X",
    "X": "X...X|X...X|.X.X.|..X..|.X.X.|X...X|X...X",
    "Y": "X...X|X...X|.X.X.|..X..|..X..|..X..|..X..",
    "Z": "XXXXX|....X|...X.|..X..|.X...|X....|XXXXX",
    "[": ".XXX.|.X...|.X...|.X...|.X...|.X...|.XXX.",
    "\\": "X....|X....|.X...|..X..|...X.|....X|....X",
    "]": ".XXX.|...X.|...X.|...X.|...X.|...X.|.XXX.",
    "^": "..X..|.X.X.|X...X|.....|.....|.....|.....",
    "_": ".....|.....|.....|.....|.....|.....|XXXXX",
    "`": ".X...|..X..|.....|.....|.....|.....|.....",
    "a": ".....|.....|.XXX.|....X|.XXXX|X...X|.XXXX",
    "b": "X....|X....|X.XX.|XX..X|X...X|X...X|XXXX.",
    "c": ".....|.....|.XXX.|X....|X....|X...X|.XXX.",
    "d": "....X|....X|.XX.X|X..XX|X...X|X...X|.XXXX",
    "e": ".....|.....|.XXX.|X...X|XXXXX|X....|.XXX.",
    "f": "..XX.|.X..X|.X...|XXX..|.X...|.X...|.X...",
    "g": ".....|.XXXX|X...X|X...X|.XXXX|....X|.XXX.",
    "h": "X....|X....|X.XX.|XX..X|X...X|X...X|X...X",
    "i": "..X..|.....|.XX..|..X..|..X..|..X..|.XXX.",
    "j": "...X.|.....|..XX.|...X.|...X.|X..X.|.XX..",
    "k": "X....|X....|X..X.|X.X..|XX...|X.X..|X..X.",
    "l": ".XX..|..X..|..X..|..X..|..X..|..X..|.XXX.",
    "m": ".....|.....|XX.X.|X.X.X|X.X.X|X.X.X|X.X.X",
    "n": ".....|.....|X.XX.|XX..X|X...X|X...X|X...X",
    "o": ".....|.....|.XXX.|X...X|X...X|X...X|.XXX.",
    "p": ".....|.....|XXXX.|X...X|XXXX.|X....|X....",
    "q": ".....|.....|.XXXX|X...X|.XXXX|....X|....X",
    "r": ".....|.....|X.XX.|XX..X|X....|X....|X....",
    "s": ".....|.....|.XXXX|X....|.XXX.|....X|XXXX.",
    "t": ".X...|.X...|XXX..|.X...|.X...|.X..X|..XX.",
    "u": ".....|.....|X...X|X...X|X...X|X..XX|.XX.X",
    "v": ".....|.....|X...X|X...X|X...X|.X.X.|..X..",
    "w": ".....|.....|X...X|X...X|X.X.X|X.X.X|.X.X.",
    "x": ".....|.....|X...X|.X.X.|..X..|.X.X.|X...X",
    "y": ".....|.....|X...X|X...X|.XXXX|....X|.XXX.",
    "z": ".....|.....|XXXXX|...X.|..X..|.X...|XXXXX",
    "{": "...XX|..X..|..X..|.X...|..X..|..X..|...XX",
    "|": "..X..|..X..|..X..|..X..|..X..|..X..|..X..",
    "}": "XX...|..X..|..X..|...X.|..X..|..X..|XX...",
    "~": ".....|.....|.X...|X.X.X|...X.|.....|.....",
}

_UNKNOWN = "XXXXX|X...X|X...X|X...X|X...X|X...X|XXXXX"


def _compile(raw: str) -> np.ndarray:
    rows = raw.split("|")
    return np.array([[c == "X" for c in row] for row in rows], bool)


GLYPHS: Dict[str, np.ndarray] = {c: _compile(r) for c, r in _RAW.items()}
_UNKNOWN_GLYPH = _compile(_UNKNOWN)


def glyph(c: str) -> np.ndarray:
    return GLYPHS.get(c, _UNKNOWN_GLYPH)


def text_size(s: str, scale: int = 1):
    """(width, height) in pixels."""
    if not s:
        return 0, GLYPH_H * scale
    return (len(s) * ADVANCE - 1) * scale, GLYPH_H * scale


def render_text_mask(s: str, scale: int = 1) -> np.ndarray:
    """(h, w) bool coverage mask for a single-line string."""
    w, h = text_size(s, scale)
    mask = np.zeros((GLYPH_H, max(w // max(scale, 1), 1)), bool)
    for i, c in enumerate(s):
        x = i * ADVANCE
        g = glyph(c)
        mask[:, x:x + GLYPH_W] |= g[:, :max(min(GLYPH_W,
                                                mask.shape[1] - x), 0)]
    if scale > 1:
        mask = np.repeat(np.repeat(mask, scale, axis=0), scale, axis=1)
    return mask
