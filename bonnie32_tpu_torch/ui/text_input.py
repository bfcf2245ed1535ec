"""Single-line text input: cursor, selection, word ops, fb rendering.
(The port's own copy of the JAX package's `ui/text_input.py`; it paints
through the port's ops/draw2d on the framebuffer's device.)

Port of `/root/reference/src/ui/text_input.rs`: `TextInputState`
(text_input.rs:6-260) with selection-range ordering, extend-selection
movement semantics, word boundaries (alnum + '_'), double-click word
select, and the draw routine (:364-427) — here painting into the shared
framebuffer via the 5x7 bitmap font instead of a ttf.

Cursor/selection indices are *character* indices into a python str (the
reference uses byte indices into utf-8; the semantics — char-granular
movement and editing — are identical, python strings just make the
char/byte distinction vanish).
"""

import dataclasses
from typing import Optional, Tuple

# text_input.rs:324-331
INPUT_BG = (31, 31, 36)
INPUT_BORDER = (0, 191, 229)
INPUT_TEXT = (204, 204, 217)
INPUT_SELECTION = (0, 128, 178)
INPUT_CURSOR = (229, 229, 242)
DOUBLE_CLICK_TIME = 0.4


def _is_word_char(ch: str) -> bool:
    return ch.isalnum() or ch == "_"


@dataclasses.dataclass
class TextInputState:
    """text_input.rs:6 — focused editable single-line text state."""

    text: str = ""
    cursor: int = 0
    selection_start: Optional[int] = None
    blink_timer: float = 0.0
    focused: bool = True
    last_click_time: float = 0.0
    last_click_pos: int = 0

    @classmethod
    def new(cls, text: str = "") -> "TextInputState":
        """text_input.rs:26 — cursor starts at the end."""
        return cls(text=text, cursor=len(text))

    # -- selection ---------------------------------------------------------

    def selection_range(self) -> Optional[Tuple[int, int]]:
        """Ordered (min, max) or None (text_input.rs:41)."""
        if self.selection_start is None:
            return None
        s, c = self.selection_start, self.cursor
        return (s, c) if s < c else (c, s)

    def delete_selection(self) -> None:
        rng = self.selection_range()
        if rng is not None:
            start, end = rng
            self.text = self.text[:start] + self.text[end:]
            self.cursor = start
            self.selection_start = None

    def has_selection(self) -> bool:
        """A zero-width selection is not a selection (text_input.rs:61)."""
        return (self.selection_start is not None
                and self.selection_start != self.cursor)

    def selected_text(self) -> str:
        rng = self.selection_range()
        return self.text[rng[0]:rng[1]] if rng else ""

    # -- movement ----------------------------------------------------------

    def move_left(self, extend_selection: bool = False) -> None:
        """text_input.rs:66 — non-extend with a selection collapses to its
        start without moving; extend anchors the selection at the cursor."""
        if extend_selection:
            if self.selection_start is None:
                self.selection_start = self.cursor
        else:
            rng = self.selection_range()
            if rng is not None:
                self.cursor = rng[0]
                self.selection_start = None
                return
        if self.cursor > 0:
            self.cursor -= 1
        if not extend_selection:
            self.selection_start = None

    def move_right(self, extend_selection: bool = False) -> None:
        """text_input.rs:97 — mirror of move_left (collapses to end)."""
        if extend_selection:
            if self.selection_start is None:
                self.selection_start = self.cursor
        else:
            rng = self.selection_range()
            if rng is not None:
                self.cursor = rng[1]
                self.selection_start = None
                return
        if self.cursor < len(self.text):
            self.cursor += 1
        if not extend_selection:
            self.selection_start = None

    def move_home(self, extend_selection: bool = False) -> None:
        if extend_selection and self.selection_start is None:
            self.selection_start = self.cursor
        self.cursor = 0
        if not extend_selection:
            self.selection_start = None

    def move_end(self, extend_selection: bool = False) -> None:
        if extend_selection and self.selection_start is None:
            self.selection_start = self.cursor
        self.cursor = len(self.text)
        if not extend_selection:
            self.selection_start = None

    def select_all(self) -> None:
        self.selection_start = 0
        self.cursor = len(self.text)

    # -- words -------------------------------------------------------------

    def word_boundaries(self, pos: int) -> Tuple[int, int]:
        """(start, end) of the alnum/_ run around pos (text_input.rs:156)."""
        if not self.text:
            return (0, 0)
        start = pos
        for i in range(pos - 1, -1, -1):
            if not _is_word_char(self.text[i]):
                start = i + 1
                break
            start = i
        end = pos
        for i in range(pos, len(self.text)):
            if not _is_word_char(self.text[i]):
                end = i
                break
            end = i + 1
        return (start, end)

    def select_word_at_cursor(self) -> None:
        start, end = self.word_boundaries(self.cursor)
        if start != end:
            self.selection_start = start
            self.cursor = end

    def set_cursor(self, pos: int, extend_selection: bool = False) -> None:
        """text_input.rs:194 — click placement; resets the caret blink."""
        pos = min(pos, len(self.text))
        if extend_selection:
            if self.selection_start is None:
                self.selection_start = self.cursor
        else:
            self.selection_start = None
        self.cursor = pos
        self.blink_timer = 0.0

    # -- editing -----------------------------------------------------------

    def insert(self, s: str) -> None:
        if self.has_selection():
            self.delete_selection()
        self.text = self.text[:self.cursor] + s + self.text[self.cursor:]
        self.cursor += len(s)

    def insert_char(self, ch: str) -> None:
        self.insert(ch)

    def backspace(self) -> None:
        if self.has_selection():
            self.delete_selection()
            return
        if self.cursor > 0:
            self.text = self.text[:self.cursor - 1] + self.text[self.cursor:]
            self.cursor -= 1

    def delete(self) -> None:
        if self.has_selection():
            self.delete_selection()
            return
        if self.cursor < len(self.text):
            self.text = self.text[:self.cursor] + self.text[self.cursor + 1:]

    # -- event handling (headless; the reference polls macroquad) ----------

    def handle_key(self, key: str, shift: bool = False,
                   ctrl: bool = False) -> bool:
        """One key event (text_input.rs:262 handle_input, event-driven).
        Returns True when the text changed."""
        old = self.text
        if key == "left":
            self.move_left(shift)
        elif key == "right":
            self.move_right(shift)
        elif key == "home":
            self.move_home(shift)
        elif key == "end":
            self.move_end(shift)
        elif ctrl and key == "a":
            self.select_all()
        elif key == "backspace":
            self.backspace()
        elif key == "delete":
            self.delete()
        elif len(key) == 1 and key.isprintable():
            self.insert_char(key)
        self.blink_timer = 0.0
        return self.text != old

    def handle_click(self, click_pos: int, now: float,
                     shift: bool = False) -> None:
        """Click at char index click_pos at time now (text_input.rs:378-390):
        a second click within DOUBLE_CLICK_TIME and one char of the last
        selects the word under the cursor."""
        if (now - self.last_click_time < DOUBLE_CLICK_TIME
                and abs(click_pos - self.last_click_pos) <= 1):
            self.cursor = click_pos
            self.select_word_at_cursor()
        elif shift:
            self.set_cursor(click_pos, True)
        else:
            self.set_cursor(click_pos, False)
        self.last_click_time = now
        self.last_click_pos = click_pos


def x_to_char_index(text: str, text_x: float, mouse_x: float,
                    scale: int = 1) -> int:
    """Nearest caret position for a click x (text_input.rs:334) under the
    fixed-advance 5x7 bitmap font."""
    from . import font

    relative_x = mouse_x - text_x
    if relative_x <= 0.0:
        return 0
    best_pos, best_dist = 0, relative_x
    for i in range(1, len(text) + 1):
        width = font.text_size(text[:i], scale)[0] if i else 0
        dist = abs(relative_x - width)
        if dist < best_dist:
            best_dist = dist
            best_pos = i
    return best_pos


def draw_text_input(fb, rect, state: TextInputState, scale: int = 1,
                    mouse=None, keys=(), now: float = 0.0,
                    dt: float = 0.0):
    """Paint the input into the framebuffer and process input
    (text_input.rs:364-427).  `mouse` is an optional (mx, my, pressed)
    tuple; `keys` an iterable of (key, shift, ctrl) events.
    Returns (fb, changed)."""
    from ..ops import draw2d
    from . import font

    state.blink_timer += dt
    x0, y0 = int(rect.x), int(rect.y)
    x1, y1 = int(rect.x + rect.w) - 1, int(rect.y + rect.h) - 1
    fb = draw2d.draw_filled_rect(fb, x0, y0, x1, y1, INPUT_BG)
    fb = draw2d.draw_rect(fb, x0, y0, x1, y1, INPUT_BORDER)

    padding = 4 * scale
    text_x = x0 + padding
    glyph_h = font.GLYPH_H * scale
    text_y = y0 + (int(rect.h) - glyph_h) // 2

    if mouse is not None:
        mx, my, pressed = mouse
        in_rect = (rect.x <= mx < rect.x + rect.w
                   and rect.y <= my < rect.y + rect.h)
        if in_rect and pressed:
            click_pos = x_to_char_index(state.text, text_x, mx, scale)
            shift = any(k[1] for k in keys if k[0] == "shift_down")
            state.handle_click(click_pos, now, shift)

    changed = False
    for key, shift, ctrl in keys:
        if key == "shift_down":
            continue
        changed = state.handle_key(key, shift, ctrl) or changed

    rng = state.selection_range()
    if rng is not None and rng[0] != rng[1]:
        sx = text_x + (font.text_size(state.text[:rng[0]], scale)[0]
                       + (scale if rng[0] else 0))
        sw = font.text_size(state.text[rng[0]:rng[1]], scale)[0]
        fb = draw2d.draw_filled_rect(fb, sx, y0 + 2, sx + sw,
                                     y1 - 2, INPUT_SELECTION, alpha=128)

    if state.text:
        fb = draw2d.draw_text(fb, text_x, text_y, state.text, INPUT_TEXT,
                              scale=scale)

    if state.focused and (state.blink_timer % 1.0) < 0.5:
        coff = font.text_size(state.text[:state.cursor], scale)[0]
        cx = text_x + coff + (scale if state.cursor else 0)
        fb = draw2d.draw_filled_rect(fb, cx, y0 + 2, cx, y1 - 2,
                                     INPUT_CURSOR)
    return fb, changed
