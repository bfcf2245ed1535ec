"""Tracker song model: notes, patterns, arrangement, channel settings.
(The port's own copy of the JAX package's `audio/song.py`, host code.)

Host-side mirror of the reference's `src/tracker/pattern.rs` with the same
RON schema (brotli-compressed song files, `tracker/io.rs:15-60`).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from ..io import brotli_io, ron
from ..io.ron import Tag

MAX_CHANNELS = 8
DEFAULT_PATTERN_LEN = 64

EFFECT_NAMES = ["None", "Arpeggio", "SlideUp", "SlideDown", "Portamento",
                "Vibrato", "VolumeSlide", "SetVolume", "PatternBreak",
                "SetSpeed"]


@dataclasses.dataclass
class Effect:
    """pattern.rs:396 — tracker effect with up to two parameters."""

    kind: str = "None"
    x: int = 0
    y: int = 0

    @classmethod
    def from_ron(cls, v):
        if v is None:
            return cls()
        if isinstance(v, Tag):
            payload = v.value
            if payload is None:
                return cls(kind=v.name)
            if isinstance(payload, tuple):
                x = int(payload[0]) if len(payload) > 0 else 0
                y = int(payload[1]) if len(payload) > 1 else 0
                return cls(kind=v.name, x=x, y=y)
            return cls(kind=v.name, x=int(payload))
        return cls()

    def to_ron(self):
        if self.kind == "None":
            return Tag("None")
        if self.kind in ("Arpeggio", "Vibrato", "VolumeSlide"):
            return Tag(self.kind, (self.x, self.y))
        return Tag(self.kind, self.x)


NOTE_OFF = 0xFF  # pattern.rs:105 — special pitch for note-off


@dataclasses.dataclass
class Note:
    """pattern.rs:75."""

    pitch: Optional[int] = None
    instrument: Optional[int] = None
    volume: Optional[int] = None
    effect: Effect = dataclasses.field(default_factory=Effect)

    @property
    def is_empty(self) -> bool:
        return (self.pitch is None and self.instrument is None
                and self.volume is None and self.effect.kind == "None")

    @classmethod
    def off(cls) -> "Note":
        """pattern.rs:103."""
        return cls(pitch=NOTE_OFF)

    @property
    def is_off(self) -> bool:
        return self.pitch == NOTE_OFF

    @classmethod
    def from_ron(cls, d):
        if not isinstance(d, dict):
            # all-default Note serializes as the unit struct `()`
            return cls()
        eff = d.get("effect")
        if eff is not None and not isinstance(eff, Tag):
            # legacy schema: numeric effect + effect_param fields
            eff = None
        return cls(
            pitch=int(d["pitch"]) if d.get("pitch") is not None else None,
            instrument=int(d["instrument"]) if d.get("instrument") is not None else None,
            volume=int(d["volume"]) if d.get("volume") is not None else None,
            effect=Effect.from_ron(eff),
        )

    def to_ron(self):
        out = {}
        if self.pitch is not None:
            out["pitch"] = ron.wrap_some(self.pitch)
        if self.instrument is not None:
            out["instrument"] = ron.wrap_some(self.instrument)
        if self.volume is not None:
            out["volume"] = ron.wrap_some(self.volume)
        out["effect"] = self.effect.to_ron()
        return out


@dataclasses.dataclass
class Pattern:
    """pattern.rs:95 — notes[channel][row] + per-row reverb automation."""

    length: int
    channels: List[List[Note]]
    reverb: List[Optional[int]] = dataclasses.field(default_factory=list)

    @classmethod
    def new(cls, length=DEFAULT_PATTERN_LEN, num_channels=4):
        """pattern.rs:185 (with_channels) — length <= 256, 1..8 channels."""
        length = min(length, 256)
        num_channels = max(1, min(num_channels, MAX_CHANNELS))
        return cls(length=length,
                   channels=[[Note() for _ in range(length)]
                             for _ in range(num_channels)],
                   reverb=[None] * length)

    def get(self, channel: int, row: int) -> Optional[Note]:
        """pattern.rs:215."""
        if 0 <= channel < len(self.channels) and 0 <= row < self.length:
            return self.channels[channel][row]
        return None

    def set(self, channel: int, row: int, note: Note) -> None:
        """pattern.rs:220 — silently ignores out-of-range."""
        if 0 <= channel < len(self.channels) and 0 <= row < self.length:
            self.channels[channel][row] = note

    def set_length(self, new_length: int) -> None:
        """pattern.rs:231 — resize all channels, clamp 1..256."""
        n = max(1, min(new_length, 256))
        for ch in self.channels:
            while len(ch) < n:
                ch.append(Note())
            del ch[n:]
        while len(self.reverb) < n:
            self.reverb.append(None)
        del self.reverb[n:]
        self.length = n

    def add_channel(self) -> None:
        """pattern.rs:196."""
        if len(self.channels) < MAX_CHANNELS:
            self.channels.append([Note() for _ in range(self.length)])

    def remove_channel(self) -> None:
        """pattern.rs:203."""
        if len(self.channels) > 1:
            self.channels.pop()

    def num_channels(self) -> int:
        return len(self.channels)

    def get_reverb(self, row: int) -> Optional[int]:
        """pattern.rs:241."""
        if 0 <= row < len(self.reverb):
            return self.reverb[row]
        return None

    def set_reverb(self, row: int, preset: Optional[int]) -> None:
        if 0 <= row < len(self.reverb):
            self.reverb[row] = preset

    @classmethod
    def from_ron(cls, d):
        return cls(
            length=int(d["length"]),
            channels=[[Note.from_ron(n) for n in ch] for ch in d["channels"]],
            reverb=[int(r) if r is not None else None
                    for r in d.get("reverb", [])],
        )

    def to_ron(self):
        return {"length": self.length,
                "channels": [[n.to_ron() for n in ch] for ch in self.channels],
                "reverb": [ron.wrap_some(r) for r in self.reverb]}


@dataclasses.dataclass
class ChannelSettings:
    """pattern.rs:9."""

    pan: int = 64
    modulation: int = 0
    expression: int = 127
    reverb_type: int = 0
    wet: int = 64
    effect_amount: int = 64
    sample_rate: int = 0

    @classmethod
    def from_ron(cls, d):
        if d is None:
            return cls()
        out = cls()
        for f in dataclasses.fields(cls):
            if f.name in d:
                setattr(out, f.name, int(d[f.name]))
        return out

    def to_ron(self):
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}


@dataclasses.dataclass
class ReverbSettings:
    """pattern.rs:35."""

    preset: int = 0
    wet: int = 64

    @classmethod
    def from_ron(cls, d):
        if d is None:
            return cls()
        return cls(preset=int(d.get("preset", 0)), wet=int(d.get("wet", 64)))

    def to_ron(self):
        return {"preset": self.preset, "wet": self.wet}


@dataclasses.dataclass
class Song:
    """pattern.rs:262."""

    name: str = ""
    bpm: int = 120
    rows_per_beat: int = 4
    patterns: List[Pattern] = dataclasses.field(default_factory=list)
    arrangement: List[int] = dataclasses.field(default_factory=list)
    instrument_names: List[str] = dataclasses.field(default_factory=list)
    channel_instruments: List[int] = dataclasses.field(default_factory=list)
    channel_settings: List[ChannelSettings] = dataclasses.field(default_factory=list)
    reverb: ReverbSettings = dataclasses.field(default_factory=ReverbSettings)
    master_volume: int = 100

    def rows_per_second(self) -> float:
        """Row rate from bpm (state.rs tick_duration semantics)."""
        return self.bpm / 60.0 * self.rows_per_beat

    def tick_duration(self) -> float:
        """pattern.rs:382 — seconds per row."""
        return 60.0 / (self.bpm * self.rows_per_beat)

    def total_rows(self) -> int:
        return sum(self.patterns[p].length for p in self.arrangement
                   if p < len(self.patterns))

    def num_channels(self) -> int:
        """pattern.rs:307 — channel_instruments defines the count."""
        return max(len(self.channel_instruments), 1)

    def get_channel_instrument(self, channel: int) -> int:
        if 0 <= channel < len(self.channel_instruments):
            return self.channel_instruments[channel]
        return 0

    def add_channel(self) -> None:
        """pattern.rs:312 — instrument 0 + defaults, added to all patterns."""
        if len(self.channel_instruments) < MAX_CHANNELS:
            self.channel_instruments.append(0)
            self.channel_settings.append(ChannelSettings())
            for p in self.patterns:
                p.add_channel()

    def remove_channel(self) -> None:
        """pattern.rs:324."""
        if len(self.channel_instruments) > 1:
            self.channel_instruments.pop()
            self.channel_settings.pop()
            for p in self.patterns:
                p.remove_channel()

    @classmethod
    def from_ron(cls, d):
        return cls(
            name=d.get("name", ""),
            bpm=int(d.get("bpm", 120)),
            rows_per_beat=int(d.get("rows_per_beat", 4)),
            patterns=[Pattern.from_ron(p) for p in d.get("patterns", [])],
            arrangement=[int(a) for a in d.get("arrangement", [])],
            instrument_names=list(d.get("instrument_names", [])),
            channel_instruments=[int(i) for i in d.get("channel_instruments", [])],
            channel_settings=[ChannelSettings.from_ron(c)
                              for c in d.get("channel_settings", [])],
            reverb=ReverbSettings.from_ron(d.get("reverb")),
            master_volume=int(d.get("master_volume", 100)),
        )

    def to_ron(self):
        return {
            "name": self.name, "bpm": self.bpm,
            "rows_per_beat": self.rows_per_beat,
            "patterns": [p.to_ron() for p in self.patterns],
            "arrangement": self.arrangement,
            "instrument_names": self.instrument_names,
            "channel_instruments": self.channel_instruments,
            "channel_settings": [c.to_ron() for c in self.channel_settings],
            "reverb": self.reverb.to_ron(),
            "master_volume": self.master_volume,
        }


def parse_song(data: bytes) -> Song:
    """tracker/io.rs:15 — brotli auto-detect + parse."""
    return Song.from_ron(ron.loads(brotli_io.maybe_decompress(data)))


def load_song(path) -> Song:
    with open(path, "rb") as f:
        return parse_song(f.read())


def save_song(song: Song, path, quality: int = 6):
    with open(path, "wb") as f:
        f.write(brotli_io.compress(ron.dumps(song.to_ron()).encode(),
                                   quality=quality))
