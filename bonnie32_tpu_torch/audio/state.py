"""Tracker editing/playback state: cursor, pattern bank, arrangement,
(The port's own copy of the JAX package's `audio/state.py`, host code.)
playback stepping, tap tempo, selection + clipboard.

Reference behavior: `src/tracker/state.rs` (TrackerState
:23-152, tap_tempo :242, pattern CRUD :397-455, arrangement :457-515,
cursor :517-586, note entry :588-700, playback :781-1065, selection
:1154).  The audio side effects (note_on previews, all_notes_off) are
routed through an optional `sink` callback instead of a synth handle;
render offline with audio/engine.py.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

from .song import MAX_CHANNELS, Note, Pattern, Song

NUM_COLUMNS = 4  # note / volume / effect / effect-param (state.rs:543)


@dataclasses.dataclass
class TrackerState:
    song: Song = dataclasses.field(default_factory=lambda: _default_song())
    # cursor
    current_pattern_idx: int = 0    # position in arrangement
    current_row: int = 0
    current_channel: int = 0
    current_column: int = 0
    # edit state
    octave: int = 4
    default_volume: int = 100
    edit_mode: bool = True
    dirty: bool = False
    # playback
    playing: bool = False
    playback_row: int = 0
    playback_pattern_idx: int = 0
    playback_time: float = 0.0
    # view
    scroll_row: int = 0
    visible_rows: int = 32
    # selection: (pattern_idx, row, channel)
    selection_start: Optional[Tuple[int, int, int]] = None
    selection_end: Optional[Tuple[int, int, int]] = None
    clipboard: Optional[List[List[Note]]] = None
    # tap tempo timestamps
    tap_times: List[float] = dataclasses.field(default_factory=list)
    # playback side effects: sink(kind, channel, payload) — "note_on",
    # "note_off", "all_off", "reverb"
    sink: Optional[Callable] = None
    _sustained: List[Optional[int]] = dataclasses.field(
        default_factory=lambda: [None] * MAX_CHANNELS)

    # --- helpers -----------------------------------------------------------

    def current_pattern(self) -> Optional[Pattern]:
        """state.rs:295 — pattern under the arrangement cursor."""
        if self.current_pattern_idx >= len(self.song.arrangement):
            return None
        num = self.song.arrangement[self.current_pattern_idx]
        if num >= len(self.song.patterns):
            return None
        return self.song.patterns[num]

    def num_channels(self) -> int:
        return self.song.num_channels()

    def pattern_length(self) -> int:
        p = self.current_pattern()
        return p.length if p else 0

    def _emit(self, kind, channel=0, payload=None):
        if self.sink is not None:
            self.sink(kind, channel, payload)

    # --- channels / pattern length (state.rs:345-396) ----------------------

    def add_channel(self):
        self.song.add_channel()
        self.dirty = True

    def remove_channel(self):
        self.song.remove_channel()
        self.current_channel = min(self.current_channel,
                                   self.num_channels() - 1)
        self.dirty = True

    def increase_pattern_length(self):
        """+16 rows, max 256."""
        p = self.current_pattern()
        if p:
            p.set_length(min(p.length + 16, 256))
            self.dirty = True

    def decrease_pattern_length(self):
        """-16 rows, min 16; cursor clamped."""
        p = self.current_pattern()
        if p:
            p.set_length(max(p.length - 16, 16))
            if self.current_row >= p.length:
                self.current_row = p.length - 1
            self.dirty = True

    # --- pattern bank (state.rs:397-455) ------------------------------------

    def create_pattern(self) -> int:
        self.song.patterns.append(Pattern.new(64, self.num_channels()))
        self.dirty = True
        return len(self.song.patterns) - 1

    def duplicate_pattern(self, pattern_idx: int) -> Optional[int]:
        if pattern_idx >= len(self.song.patterns):
            return None
        import copy
        self.song.patterns.append(copy.deepcopy(self.song.patterns[pattern_idx]))
        self.dirty = True
        return len(self.song.patterns) - 1

    def delete_pattern(self, pattern_idx: int) -> bool:
        """Removes bank slot + fixes arrangement indices (state.rs:422)."""
        if len(self.song.patterns) <= 1 or pattern_idx >= len(self.song.patterns):
            return False
        self.song.patterns.pop(pattern_idx)
        self.song.arrangement = [i for i in self.song.arrangement
                                 if i != pattern_idx]
        self.song.arrangement = [i - 1 if i > pattern_idx else i
                                 for i in self.song.arrangement]
        if not self.song.arrangement:
            self.song.arrangement.append(0)
        if self.current_pattern_idx >= len(self.song.arrangement):
            self.current_pattern_idx = len(self.song.arrangement) - 1
        self.dirty = True
        return True

    # --- arrangement (state.rs:457-515) --------------------------------------

    def arrangement_insert(self, position: int, pattern_idx: int):
        if pattern_idx < len(self.song.patterns):
            pos = min(position, len(self.song.arrangement))
            self.song.arrangement.insert(pos, pattern_idx)
            self.dirty = True

    def arrangement_remove(self, position: int) -> bool:
        if len(self.song.arrangement) <= 1 \
                or position >= len(self.song.arrangement):
            return False
        self.song.arrangement.pop(position)
        if self.current_pattern_idx >= len(self.song.arrangement):
            self.current_pattern_idx = len(self.song.arrangement) - 1
        self.dirty = True
        return True

    def arrangement_move_up(self, position: int) -> bool:
        a = self.song.arrangement
        if position == 0 or position >= len(a):
            return False
        a[position - 1], a[position] = a[position], a[position - 1]
        self.dirty = True
        return True

    def arrangement_move_down(self, position: int) -> bool:
        a = self.song.arrangement
        if position + 1 >= len(a):
            return False
        a[position], a[position + 1] = a[position + 1], a[position]
        self.dirty = True
        return True

    def arrangement_set_pattern(self, position: int, pattern_idx: int):
        if position < len(self.song.arrangement) \
                and pattern_idx < len(self.song.patterns):
            self.song.arrangement[position] = pattern_idx
            self.dirty = True

    # --- cursor (state.rs:517-586) -------------------------------------------

    def _ensure_row_visible(self):
        if self.current_row < self.scroll_row:
            self.scroll_row = self.current_row
        elif self.current_row >= self.scroll_row + self.visible_rows:
            self.scroll_row = self.current_row - self.visible_rows + 1

    def cursor_up(self):
        if self.current_row > 0:
            self.current_row -= 1
            self._ensure_row_visible()

    def cursor_down(self):
        p = self.current_pattern()
        if p and self.current_row < p.length - 1:
            self.current_row += 1
            self._ensure_row_visible()

    def cursor_left(self):
        if self.current_column > 0:
            self.current_column -= 1
        elif self.current_channel > 0:
            self.current_channel -= 1
            self.current_column = NUM_COLUMNS - 1

    def cursor_right(self):
        if self.current_column < NUM_COLUMNS - 1:
            self.current_column += 1
        elif self.current_channel < self.num_channels() - 1:
            self.current_channel += 1
            self.current_column = 0

    # --- note entry (state.rs:588-700) ----------------------------------------

    def get_selection_bounds(self):
        """state.rs:1154 — (row0, row1, ch0, ch1), same-pattern only."""
        if self.selection_start is None or self.selection_end is None:
            return None
        p1, r1, c1 = self.selection_start
        p2, r2, c2 = self.selection_end
        if p1 != p2:
            return None
        return (min(r1, r2), max(r1, r2), min(c1, c2), max(c1, c2))

    def enter_note(self, pitch: int, instrument: Optional[int] = None):
        """Set at cursor (or fill selection); preview; cursor stays
        (advance_cursor is a no-op, state.rs:777)."""
        if instrument is None:
            instrument = self.song.get_channel_instrument(self.current_channel)
        note = Note(pitch=pitch, instrument=instrument)
        p = self.current_pattern()
        if p is None:
            return
        bounds = self.get_selection_bounds()
        if bounds is not None:
            r0, r1, c0, c1 = bounds
            for ch in range(c0, c1 + 1):
                for row in range(r0, r1 + 1):
                    p.set(ch, row, dataclasses.replace(note))
        else:
            p.set(self.current_channel, self.current_row, note)
        self.dirty = True
        self._emit("note_on", self.current_channel, (pitch, 100))

    def enter_note_off(self):
        p = self.current_pattern()
        if p:
            p.set(self.current_channel, self.current_row, Note.off())
            self.dirty = True

    def delete_note(self):
        p = self.current_pattern()
        if p:
            p.set(self.current_channel, self.current_row, Note())
            self.dirty = True

    def set_volume(self, volume: int):
        """layout.rs:1880 — write the cursor note's volume column."""
        p = self.current_pattern()
        note = p.get(self.current_channel, self.current_row) if p else None
        if note is not None:
            note.volume = max(0, min(int(volume), 127))
            self.dirty = True

    EFFECT_CHARS = {  # pattern.rs:428 Effect::from_char
        "0": "Arpeggio", "1": "SlideUp", "2": "SlideDown",
        "3": "Portamento", "4": "Vibrato", "a": "VolumeSlide",
        "c": "SetVolume", "d": "PatternBreak", "e": "SetExpression",
        "f": "SetSpeed", "m": "SetModulation", "p": "SetPan"}

    def set_effect_char(self, char: str) -> bool:
        """Effect-column letter entry: sets the effect kind, keeping the
        current parameter (layout.rs:1893-1937)."""
        kind = self.EFFECT_CHARS.get(char.lower())
        if kind is None:
            return False
        p = self.current_pattern()
        note = p.get(self.current_channel, self.current_row) if p else None
        if note is None:
            return False
        self.set_effect(kind, note.effect.x, note.effect.y)
        return True

    def set_effect(self, kind: str, x: int = 0, y: int = 0):
        p = self.current_pattern()
        note = p.get(self.current_channel, self.current_row) if p else None
        if note is not None:
            from .song import Effect
            note.effect = Effect(kind=kind, x=x, y=y)
            self.dirty = True

    # --- clipboard ------------------------------------------------------------

    def copy_selection(self) -> bool:
        bounds = self.get_selection_bounds()
        p = self.current_pattern()
        if bounds is None or p is None:
            return False
        r0, r1, c0, c1 = bounds
        self.clipboard = [[dataclasses.replace(p.channels[ch][row])
                           for row in range(r0, r1 + 1)]
                          for ch in range(c0, c1 + 1)]
        return True

    def paste(self) -> bool:
        """Paste at cursor, clipped to pattern bounds."""
        p = self.current_pattern()
        if self.clipboard is None or p is None:
            return False
        for ci, ch_notes in enumerate(self.clipboard):
            ch = self.current_channel + ci
            for ri, note in enumerate(ch_notes):
                p.set(ch, self.current_row + ri, dataclasses.replace(note))
        self.dirty = True
        return True

    # --- playback (state.rs:781-1065) ------------------------------------------

    def toggle_playback(self):
        self.playing = not self.playing
        if self.playing:
            self.playback_row = self.current_row
            self.playback_pattern_idx = self.current_pattern_idx
            self.playback_time = 0.0
            self._sustained = [None] * MAX_CHANNELS
        else:
            self._emit("all_off")
            self._sustained = [None] * MAX_CHANNELS

    def play_from_start(self):
        self._emit("all_off")
        self.playback_row = 0
        self.playback_pattern_idx = 0
        self.playback_time = 0.0
        self.playing = True
        self._sustained = [None] * MAX_CHANNELS

    def stop_playback(self):
        self.playing = False
        self.playback_row = 0
        self.playback_pattern_idx = 0
        self.current_row = 0
        self.current_pattern_idx = 0
        self.scroll_row = 0
        self._emit("all_off")
        self._sustained = [None] * MAX_CHANNELS

    def update_playback(self, delta: float):
        """state.rs:845 — accumulate time; fire rows at tick_duration."""
        if not self.playing:
            return
        self.playback_time += delta
        tick = self.song.tick_duration()
        while self.playback_time >= tick:
            self.playback_time -= tick
            self._play_current_row()
            self._advance_playback()

    def _play_current_row(self):
        """state.rs:867 — same-pitch sustain: retrigger only on change;
        empty rows sustain; note-off stops the channel."""
        song = self.song
        if self.playback_pattern_idx >= len(song.arrangement):
            return
        num = song.arrangement[self.playback_pattern_idx]
        if num >= len(song.patterns):
            return
        pattern = song.patterns[num]
        reverb = pattern.get_reverb(self.playback_row)
        if reverb is not None:
            self._emit("reverb", 0, reverb)
        for ch in range(song.num_channels()):
            note = pattern.get(ch, self.playback_row)
            if note is None or note.is_empty:
                continue
            if note.is_off:
                if self._sustained[ch] is not None:
                    self._emit("note_off", ch, self._sustained[ch])
                    self._sustained[ch] = None
                continue
            if note.pitch is not None:
                if self._sustained[ch] == note.pitch:
                    continue  # sustain, no retrigger
                if self._sustained[ch] is not None:
                    self._emit("note_off", ch, self._sustained[ch])
                vol = note.volume if note.volume is not None \
                    else self.default_volume
                self._emit("note_on", ch, (note.pitch, vol))
                self._sustained[ch] = note.pitch
        # effects apply after the row's notes (state.rs:946-948)
        for ch in range(song.num_channels()):
            note = pattern.get(ch, self.playback_row)
            if note is not None and note.effect.kind != "None":
                self._apply_effect(ch, note.effect)

    def _apply_effect(self, ch: int, effect) -> None:
        """state.rs:971-1027 — the MIDI-control effect subset the
        reference implements (Arpeggio/Portamento/VolumeSlide need
        per-tick processing and are unimplemented there too)."""
        k = effect.kind
        if k == "SetVolume":
            self._emit("volume", ch, effect.x)
        elif k == "SetPan":
            self._emit("pan", ch, effect.x)
        elif k == "SetExpression":
            self._emit("expression", ch, effect.x)
        elif k == "SetModulation":
            self._emit("modulation", ch, effect.x)
        elif k == "SlideUp":
            self._emit("pitch_bend", ch, min(8192 + effect.x * 64, 16383))
        elif k == "SlideDown":
            self._emit("pitch_bend", ch, max(8192 - effect.x * 64, 0))
        elif k == "Vibrato":
            self._emit("modulation", ch, min(effect.y * 8, 127))
        elif k == "SetSpeed":
            if effect.x > 0:
                self.song.bpm = effect.x

    def _advance_playback(self):
        """state.rs:1029 — wrap pattern, then arrangement (loop)."""
        song = self.song
        if self.playback_pattern_idx >= len(song.arrangement):
            self.stop_playback()
            return
        num = song.arrangement[self.playback_pattern_idx]
        if num >= len(song.patterns):
            self.stop_playback()
            return
        self.playback_row += 1
        if self.playback_row >= song.patterns[num].length:
            self.playback_row = 0
            self.playback_pattern_idx += 1
            if self.playback_pattern_idx >= len(song.arrangement):
                self.playback_pattern_idx = 0  # loop
        self.current_row = self.playback_row
        self.current_pattern_idx = self.playback_pattern_idx
        self._ensure_row_visible()

    # --- tap tempo (state.rs:242) ------------------------------------------------

    def tap_tempo(self, now: float) -> Optional[int]:
        """Average of up to 8 tap intervals -> BPM (40..300); resets after
        2 s of silence.  `now` is an injected clock (seconds)."""
        if self.tap_times and now - self.tap_times[-1] > 2.0:
            self.tap_times.clear()
        self.tap_times.append(now)
        if len(self.tap_times) > 8:
            self.tap_times.pop(0)
        if len(self.tap_times) < 2:
            return None
        total = sum(self.tap_times[i] - self.tap_times[i - 1]
                    for i in range(1, len(self.tap_times)))
        avg = total / (len(self.tap_times) - 1)
        bpm = int(round(60.0 / avg))
        return max(40, min(bpm, 300))


def _default_song() -> Song:
    from .song import ChannelSettings
    return Song(patterns=[Pattern.new(64, 4)], arrangement=[0],
                channel_instruments=[0, 0, 0, 0],
                channel_settings=[ChannelSettings() for _ in range(4)])
