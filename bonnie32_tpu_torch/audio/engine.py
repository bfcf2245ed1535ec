"""Song rendering: tracker playback -> voices -> SPU reverb/resampler (the
JAX package's `audio/engine.py`).

The playback row state machine mirrors TrackerState's arrangement advance
(the reference's `src/tracker/state.rs`: rows advance at bpm *
rows_per_beat per minute; notes trigger per row with channel
pan/expression applied).

INSTRUMENT NOTE: the reference synthesizes through a General-MIDI SoundFont
(rustysynth + an SF2 file, audio.rs:516).  When an SF2 file is available,
`render_song` synthesizes through `sf2_synth` (own SoundFont parser + voice
model: mod envelope, LFOs, filter); otherwise it falls back to a GM-family
mapped oscillator synth (waveform family by program number + exponential
decay envelope).  Timing, note/volume/pan handling, SPU reverb and the
Gaussian resampler are faithful in both modes.

The dry synthesis is host numpy (`stream.SongSynth`, shared with the
incremental `AudioStream`); the master gain, the reverb and the resampler
run on the device (`stream.SpuChain`: the `spu_reverb` and `spu_resample`
kernels on the card, their plain twins on the CPU).
"""

from typing import Optional, Tuple

import numpy as np

from ..types import resolve_device
from . import stream as strm
from .song import Song

SAMPLE_RATE = strm.SAMPLE_RATE  # audio.rs SAMPLE_RATE


def render_song(song: Song, seconds: Optional[float] = None,
                sample_rate: int = SAMPLE_RATE,
                apply_reverb: bool = True,
                apply_resampler: bool = True,
                soundfont=None, device=None) -> Tuple[np.ndarray, np.ndarray]:
    """Render the song's arrangement to stereo f32 PCM (host arrays).

    `soundfont`: an audio.sf2.SoundFont (or path / bytes) — when given,
    notes play through the sample-based SF2 synthesizer exactly like the
    reference's rustysynth path (audio.rs:516); otherwise the documented
    oscillator fallback is used.  The DSP runs on `device` (default: the
    card; it raises without one)."""
    device = resolve_device(device)
    n_rows = strm._row_tables(song)[0].shape[0]
    if n_rows == 0:
        n = int((seconds or 1.0) * sample_rate)
        return np.zeros(n, np.float32), np.zeros(n, np.float32)

    rows_per_sec = song.rows_per_second()
    total_sec = seconds if seconds is not None else n_rows / rows_per_sec
    n = int(total_sec * sample_rate)

    chain = strm.SpuChain(song, device, apply_reverb, apply_resampler)
    synth = strm.SongSynth(song, n, sample_rate, soundfont)
    return chain.run(*synth.dry_chunk(0, n))
