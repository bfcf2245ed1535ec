"""The port's MIDI input queue (input/midi.py) and tracker state
(audio/state.py), host copies of the JAX package's: the cases of
tests/test_midi.py, and the same MIDI-driven editing through both
packages' TrackerState with equal results.
"""

import dataclasses

import numpy as np

from bonnie32_tpu.audio import state as jstate
from bonnie32_tpu.input import midi as jmidi
from bonnie32_tpu_torch.audio import state as tstate
from bonnie32_tpu_torch.audio.state import TrackerState
from bonnie32_tpu_torch.editor.state import MemoryStats
from bonnie32_tpu_torch.input import midi as tmidi
from bonnie32_tpu_torch.input.midi import (ControlChange, MidiInput,
                                           NoteOff, NoteOn,
                                           VirtualMidiBackend)


def test_midi_messages_and_held():
    be = VirtualMidiBackend()
    m = MidiInput(be)
    assert m.is_connected() and m.list_devices() == ["Virtual Keyboard"]

    be.note_on(60, 90)
    be.feed([(0xB1, 7, 100)])
    assert m.poll() == [NoteOn(60, 90), ControlChange(7, 100)]
    assert m.is_note_held(60)
    assert not m.is_note_held(61)

    be.note_off(60)
    assert m.poll() == [NoteOff(60)]
    assert not m.is_note_held(60)

    # velocity-0 note-on is a note-off; 0xF8 (clock) is ignored
    be.feed([(0x90, 62, 100), (0x90, 62, 0), (0xF8, 0, 0)])
    assert m.poll() == [NoteOn(62, 100), NoteOff(62)]
    assert not m.is_note_held(62)
    assert m.poll() == []


def test_midi_drives_tracker():
    be = VirtualMidiBackend()
    m = MidiInput(be)
    t = TrackerState()
    be.note_on(48)
    for msg in m.poll():
        if isinstance(msg, NoteOn):
            t.enter_note(msg.note)
    assert t.current_pattern().get(0, 0).pitch == 48


def _midi_run(midi_mod, state_mod, feed):
    """Feed raw MIDI triples through one package's MidiInput into its
    TrackerState: note-ons enter notes, CC 7 sets the entry volume."""
    be = midi_mod.VirtualMidiBackend()
    m = midi_mod.MidiInput(be)
    t = state_mod.TrackerState()
    messages = []
    for chunk in feed:
        be.feed(chunk)
        for msg in m.poll():
            messages.append(dataclasses.astuple(msg)
                            + (type(msg).__name__,))
            if isinstance(msg, midi_mod.NoteOn):
                t.enter_note(msg.note)
            elif isinstance(msg, midi_mod.ControlChange):
                t.default_volume = max(msg.value, 1)
    pat = t.current_pattern()
    notes = [[(n.pitch, n.instrument, n.volume) for n in ch]
             for ch in pat.channels]
    return messages, notes, t.current_row, t.default_volume


def test_midi_run_matches_jax():
    rng = np.random.default_rng(9)
    feed = []
    for _ in range(12):
        chunk = []
        for _ in range(int(rng.integers(1, 4))):
            kind = int(rng.integers(3))
            status = (0x90, 0x80, 0xB0)[kind] | int(rng.integers(16))
            chunk.append((status, 7 if kind == 2 else int(rng.integers(24,
                                                                   100)),
                          int(rng.integers(0, 128))))
        feed.append(chunk)
    got = _midi_run(tmidi, tstate, feed)
    assert got == _midi_run(jmidi, jstate, feed)
    assert any(p is not None for ch in got[1] for p, _, _ in ch)


def test_memory_stats():
    s = MemoryStats()
    s.update_process_memory()
    assert s.physical_bytes > 1024 * 1024
    s.update_assets(textures=[np.zeros((64, 64)), np.zeros((32, 32))],
                    framebuffers=[np.zeros((240, 320))])
    assert s.texture_count == 2
    assert s.texture15_bytes == (64 * 64 + 32 * 32) * 2
    assert s.framebuffer_bytes == 240 * 320 * 8
    assert MemoryStats.format_bytes(512) == "512 B"
    assert MemoryStats.format_bytes(2048) == "2.0 KB"
    assert MemoryStats.format_bytes(3 * 1024 ** 2) == "3.0 MB"
    assert MemoryStats.format_bytes(int(1.5 * 1024 ** 3)) == "1.5 GB"
