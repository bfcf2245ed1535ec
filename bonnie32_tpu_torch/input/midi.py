"""MIDI input: note/CC message queue with held-note tracking.
(The port's own copy of the JAX package's `input/midi.py`, host code.)

Reference behavior: `src/input/midi.rs` — MidiMessage
(:8), MidiInput with poll()/held-note state/device management (:40-150;
midir on native, Web MIDI FFI on WASM).  The OS transport is a pluggable
`backend` here: anything with `read() -> list[(status, data1, data2)]`
raw triples (0x80 note-off / 0x90 note-on / 0xB0 CC, any channel) and
optional `name`/`devices()`/`connect(i)`.  `VirtualMidiBackend` feeds
scripted messages for tests and headless tools.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional, Tuple, Union


@dataclasses.dataclass(frozen=True)
class NoteOn:
    note: int
    velocity: int


@dataclasses.dataclass(frozen=True)
class NoteOff:
    note: int


@dataclasses.dataclass(frozen=True)
class ControlChange:
    controller: int
    value: int


MidiMessage = Union[NoteOn, NoteOff, ControlChange]


class VirtualMidiBackend:
    """Scriptable transport: queue raw (status, data1, data2) triples."""

    def __init__(self, name: str = "Virtual Keyboard"):
        self.name = name
        self._queue: List[Tuple[int, int, int]] = []
        self.connected = True

    def feed(self, triples: Iterable[Tuple[int, int, int]]) -> None:
        self._queue.extend(triples)

    def note_on(self, note: int, velocity: int = 100) -> None:
        self.feed([(0x90, note, velocity)])

    def note_off(self, note: int) -> None:
        self.feed([(0x80, note, 0)])

    def read(self) -> List[Tuple[int, int, int]]:
        out = self._queue
        self._queue = []
        return out

    def devices(self) -> List[str]:
        return [self.name]


class MidiInput:
    """midi.rs:40 — poll raw transport bytes into typed messages; track
    held notes (note-on w/ velocity 0 counts as note-off, per MIDI)."""

    def __init__(self, backend: Optional[VirtualMidiBackend] = None):
        self.backend = backend if backend is not None \
            else VirtualMidiBackend()
        self._held = [False] * 128

    def poll(self) -> List[MidiMessage]:
        out: List[MidiMessage] = []
        for (status, d1, d2) in self.backend.read():
            kind = status & 0xF0
            if kind == 0x90 and d2 > 0:
                self._held[d1 & 0x7F] = True
                out.append(NoteOn(d1 & 0x7F, d2 & 0x7F))
            elif kind == 0x80 or (kind == 0x90 and d2 == 0):
                self._held[d1 & 0x7F] = False
                out.append(NoteOff(d1 & 0x7F))
            elif kind == 0xB0:
                out.append(ControlChange(d1 & 0x7F, d2 & 0x7F))
            # other statuses ignored (midi.rs `_ => continue`)
        return out

    def is_note_held(self, note: int) -> bool:
        """midi.rs:125."""
        return self._held[note & 0x7F]

    def is_connected(self) -> bool:
        return getattr(self.backend, "connected", False)

    def device_name(self) -> str:
        return getattr(self.backend, "name", "")

    def list_devices(self) -> List[str]:
        devices = getattr(self.backend, "devices", None)
        return devices() if devices else []
