"""Streaming (incremental) song rendering (the JAX package's
`audio/stream.py`).

The reference renders audio per frame with a sample accumulator feeding a
ring buffer (the reference's `src/tracker/audio.rs:679-720`: `render_audio
(delta)` converts elapsed seconds to whole samples, caps catch-up at 4096,
runs synth -> SPU reverb -> Gaussian resampler -> master gain -> output
ring).  This module is that capability for the port:

  * `SongSynth` — the dry tracker synthesizer as a resumable chunk
    producer (host numpy, a copy of the JAX package's): `dry_chunk(a, b)`
    yields absolute frames [a, b) bit-exactly equal to the corresponding
    slice of a whole-song render.  Oscillator channels carry their phase
    accumulator (and the noise channel its RNG) across chunks; SoundFont
    channels trigger each note voice once, when its start frame enters
    the window, into a rolling per-channel tail buffer (voice math is a
    pure function of note-relative time, so the mix-in order — event
    order — is what bit-exactness needs).
  * `SpuChain` — the device half: the master gain, the SPU reverb
    (`reverb.process`) and the Gaussian resampler (`resampler.process`)
    on one device, their states carried from one chunk to the next.
  * `AudioStream` — the `render_audio(delta)`-equivalent: accumulator ->
    `SongSynth` -> host-to-device copy -> `SpuChain` -> device-to-host
    copy -> ring buffer.  The SPU stages are per-sample recurrences
    (the `spu_reverb` and `spu_resample` kernels of csrc/audio.cu on the
    card) whose state threads across chunk boundaries, so the streamed
    output is bit-for-bit the offline `engine.render_song` output.

`engine.render_song` itself renders through `SongSynth` and `SpuChain`
as one whole-song chunk — a single source of truth for the synth math.
"""

import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..types import resolve_device
from . import resampler as rsp
from . import reverb as rvb

SAMPLE_RATE = 44100  # audio.rs SAMPLE_RATE
MAX_CHUNK = 4096     # audio.rs:697 catch-up cap per render_audio call


def _program_wave(program: int) -> str:
    """GM program family -> oscillator family (fallback synth only).

    This mapping has no reference counterpart (the reference's no-SF2
    fallback is a filtered click, audio.rs:354-365) — it is this port's
    fallback voicing, unchanged since it lived in engine.py and pinned by
    tests/test_audio_stream.py::test_program_wave_mapping so it cannot
    drift silently again."""
    if program < 8:
        return "triangle"   # pianos
    if program < 24:
        return "sine"       # chromatic percussion, organs
    if program < 56:
        return "saw"        # guitars, basses, strings, ensemble
    if program < 104:
        return "square"     # brass, reeds, pipes, leads, pads
    return "noise"          # ethnic/percussive/sfx


def _row_tables(song):
    """Flatten the arrangement into per-row (pitch, volume, instrument,
    note_start_row, reverb_type) tables of shape (rows, channels)
    (state.rs arrangement advance; notes latch until replaced)."""
    rows = []
    reverb_rows = []
    for pat_idx in song.arrangement:
        if pat_idx >= len(song.patterns):
            continue
        pat = song.patterns[pat_idx]
        for r in range(pat.length):
            rows.append([pat.channels[c][r] if c < len(pat.channels) else None
                         for c in range(len(pat.channels))])
            rv = pat.reverb[r] if r < len(pat.reverb) else None
            reverb_rows.append(rv)
    n_rows = len(rows)
    n_ch = max((len(r) for r in rows), default=1)

    pitch = np.full((n_rows, n_ch), -1, np.int32)
    vol = np.full((n_rows, n_ch), 100, np.int32)
    inst = np.zeros((n_rows, n_ch), np.int32)
    start = np.full((n_rows, n_ch), -1, np.int32)

    cur_pitch = [-1] * n_ch
    cur_vol = [100] * n_ch
    cur_inst = [int(song.channel_instruments[c])
                if c < len(song.channel_instruments) else 0
                for c in range(n_ch)]
    cur_start = [-1] * n_ch
    for i, row in enumerate(rows):
        for c in range(n_ch):
            note = row[c] if c < len(row) else None
            if note is not None:
                if note.instrument is not None:
                    cur_inst[c] = int(note.instrument)
                if note.volume is not None:
                    cur_vol[c] = int(note.volume)
                if note.pitch is not None:
                    cur_pitch[c] = int(note.pitch)
                    cur_start[c] = i
            pitch[i, c] = cur_pitch[c]
            vol[i, c] = cur_vol[c]
            inst[i, c] = cur_inst[c]
            start[i, c] = cur_start[c]
    return pitch, vol, inst, start, reverb_rows


def _sf2_channel_events(song, pitch, vol, inst, start, c, n,
                        rows_per_sec, sample_rate):
    """One channel's rows -> SoundFont NoteEvents (key held until the
    pitch/start latch changes; <=1 s release tail, capped at n)."""
    from . import sf2_synth

    n_rows = pitch.shape[0]
    events = []
    r = 0
    while r < n_rows:
        if pitch[r, c] >= 0 and start[r, c] == r:
            r2 = r + 1
            while r2 < n_rows and pitch[r2, c] == pitch[r, c] \
                    and start[r2, c] == r:
                r2 += 1
            f0 = int(r / rows_per_sec * sample_rate)
            f_off = int(r2 / rows_per_sec * sample_rate)
            f_end = min(f_off + sample_rate, n)   # <=1s release tail
            events.append(sf2_synth.NoteEvent(
                start_frame=f0, off_frame=f_off, end_frame=f_end,
                key=int(pitch[r, c]), vel=int(max(min(vol[r, c], 127), 1)),
                bank=0, program=int(inst[r, c])))
            r = r2
        else:
            r += 1
    return events


class _OscState:
    """Streaming carry for one oscillator channel."""
    __slots__ = ("phase", "rng")

    def __init__(self, c: int):
        self.phase = 0.0                              # running cumsum carry
        self.rng = np.random.default_rng(1234 + c)    # noise stream


class _Sf2State:
    """Streaming carry for one SoundFont channel: untriggered events plus
    a rolling tail buffer of already-triggered voices (base-aligned)."""
    __slots__ = ("events", "next_ev", "base", "tail_l", "tail_r")

    def __init__(self, events):
        self.events = events
        self.next_ev = 0
        self.base = 0
        self.tail_l = np.zeros(0, np.float32)
        self.tail_r = np.zeros(0, np.float32)


class SongSynth:
    """Resumable dry-signal producer.  `dry_chunk(a, b)` must be called
    with contiguous windows (b of one call == a of the next); the
    concatenation of all chunks equals one whole-song render bit-for-bit.

    total_frames fixes the render horizon (the offline `n`): voices are
    end-capped there and frames past it are silence."""

    def __init__(self, song, total_frames: int,
                 sample_rate: int = SAMPLE_RATE, soundfont=None):
        if soundfont is not None:
            from . import sf2 as sf2_mod
            if not isinstance(soundfont, sf2_mod.SoundFont):
                soundfont = sf2_mod.load(soundfont)
        self.song = song
        self.sf = soundfont
        self.rate = sample_rate
        self.total = int(total_frames)
        pitch, vol, inst, start, _ = _row_tables(song)
        self.pitch, self.vol, self.inst, self.start = pitch, vol, inst, start
        self.n_rows, self.n_ch = pitch.shape
        self.rows_per_sec = song.rows_per_second() if self.n_rows else 1.0

        self.pans = [song.channel_settings[c].pan
                     if c < len(song.channel_settings) else 64
                     for c in range(self.n_ch)]
        self.exprs = [song.channel_settings[c].expression
                      if c < len(song.channel_settings) else 127
                      for c in range(self.n_ch)]

        self._skip = [True] * self.n_ch
        self._wave_kind = ["sine"] * self.n_ch
        self._state: List[object] = [None] * self.n_ch
        if self.n_rows and self.total > 0:
            # rows actually covered by the horizon (same truncation as the
            # per-frame row_idx formula at the last frame)
            t_last = np.float64(self.total - 1) / self.rate
            max_row = int(min(np.int64(t_last * self.rows_per_sec),
                              self.n_rows - 1))
            for c in range(self.n_ch):
                self._skip[c] = not (pitch[:max_row + 1, c] >= 0).any()
                if self._skip[c]:
                    continue
                if self.sf is not None:
                    evs = _sf2_channel_events(song, pitch, vol, inst, start,
                                              c, self.total,
                                              self.rows_per_sec, self.rate)
                    self._state[c] = _Sf2State(evs)
                else:
                    col = inst[:, c]
                    prog = (int(np.bincount(col[col >= 0]).argmax())
                            if (col >= 0).any() else 0)
                    self._wave_kind[c] = _program_wave(prog)
                    self._state[c] = _OscState(c)

    # -- per-channel chunk producers ------------------------------------

    def _osc_chunk(self, c: int, a: int, b: int, t, row_idx):
        st: _OscState = self._state[c]
        p = self.pitch[row_idx, c]
        active = p >= 0
        freq = 440.0 * np.exp2((p - 69) / 12.0)
        w = np.where(active, freq / self.rate, 0.0)
        # carry-seeded cumsum == the sequential fold the whole-song cumsum
        # computes (prepend the carry, drop it after)
        phase = np.cumsum(np.concatenate([[st.phase], w]))[1:]
        if len(phase):
            st.phase = float(phase[-1])
        frac = phase % 1.0

        kind = self._wave_kind[c]
        if kind == "sine":
            wave = np.sin(2 * math.pi * frac)
        elif kind == "square":
            wave = np.where(frac < 0.5, 1.0, -1.0) * 0.6
        elif kind == "saw":
            wave = (frac * 2.0 - 1.0) * 0.7
        elif kind == "triangle":
            wave = (np.abs(frac * 4.0 - 2.0) - 1.0)
        else:  # noise — sequential stream, split across chunks
            wave = st.rng.uniform(-0.6, 0.6, b - a)

        start_rows = self.start[row_idx, c]
        note_start_t = np.where(start_rows >= 0,
                                start_rows / self.rows_per_sec, 0.0)
        dt = np.maximum(t - note_start_t, 0.0)
        env = np.minimum(dt / 0.005, 1.0) * np.exp(-dt * 1.8)

        gain = (self.vol[row_idx, c] / 127.0) * (self.exprs[c] / 127.0) * 0.25
        sig = (wave * env * gain * active).astype(np.float32)
        pan = self.pans[c] / 127.0
        return (sig * np.float32(math.sqrt(1.0 - pan)),
                sig * np.float32(math.sqrt(pan)))

    def _sf2_chunk(self, c: int, a: int, b: int):
        from . import sf2_synth

        st: _Sf2State = self._state[c]
        # drop consumed tail prefix
        if a > st.base:
            cut = a - st.base
            st.tail_l = st.tail_l[cut:]
            st.tail_r = st.tail_r[cut:]
            st.base = a
        # trigger voices whose start enters this window, in event order
        while st.next_ev < len(st.events) \
                and st.events[st.next_ev].start_frame < b:
            ev = st.events[st.next_ev]
            st.next_ev += 1
            n_total = min(ev.end_frame, self.total) - ev.start_frame
            if n_total <= 0:
                continue
            n_on = max(min(ev.off_frame, ev.end_frame) - ev.start_frame, 0)
            end_abs = ev.start_frame + n_total
            if end_abs > st.base + len(st.tail_l):
                grow = end_abs - (st.base + len(st.tail_l))
                st.tail_l = np.concatenate(
                    [st.tail_l, np.zeros(grow, np.float32)])
                st.tail_r = np.concatenate(
                    [st.tail_r, np.zeros(grow, np.float32)])
            preset = self.sf.find_preset(ev.bank, ev.program)
            if preset is None:
                continue
            off = ev.start_frame - st.base
            for region in preset.regions:
                if not (region.key_lo <= ev.key <= region.key_hi
                        and region.vel_lo <= ev.vel <= region.vel_hi):
                    continue
                sig, gl, gr = sf2_synth.render_voice(
                    self.sf, region, ev.key, ev.vel, n_on, n_total,
                    self.rate)
                st.tail_l[off:off + n_total] += sig * np.float32(gl)
                st.tail_r[off:off + n_total] += sig * np.float32(gr)
        m = b - a
        if len(st.tail_l) < m:
            st.tail_l = np.concatenate(
                [st.tail_l, np.zeros(m - len(st.tail_l), np.float32)])
            st.tail_r = np.concatenate(
                [st.tail_r, np.zeros(m - len(st.tail_r), np.float32)])
        sl, sr_ = st.tail_l[:m], st.tail_r[:m]
        expr = self.exprs[c] / 127.0
        pan = self.pans[c] / 127.0
        # channel pan/expression (CC10/CC11) on top of per-voice SF2 pan;
        # sqrt(2) normalizes the constant-power curve to unity at center
        return (sl * np.float32(expr * math.sqrt(2.0 * (1.0 - pan))),
                sr_ * np.float32(expr * math.sqrt(2.0 * pan)))

    # -- public ----------------------------------------------------------

    def dry_chunk(self, a: int, b: int) -> Tuple[np.ndarray, np.ndarray]:
        """Mixed dry stereo frames [a, b), pre-master-volume."""
        m = b - a
        left = np.zeros(m, np.float32)
        right = np.zeros(m, np.float32)
        if self.n_rows == 0 or m <= 0:
            return left, right
        b_eff = min(b, self.total)
        if b_eff <= a:
            return left, right
        me = b_eff - a
        t = np.arange(a, b_eff, dtype=np.float64) / self.rate
        row_idx = np.minimum((t * self.rows_per_sec).astype(np.int64),
                             self.n_rows - 1)
        for c in range(self.n_ch):
            if self._skip[c]:
                continue
            if self.sf is not None:
                sl, sr_ = self._sf2_chunk(c, a, b_eff)
            else:
                sl, sr_ = self._osc_chunk(c, a, b_eff, t, row_idx)
            left[:me] += sl
            right[:me] += sr_
        return left, right


class RingBuffer:
    """Fixed-capacity stereo f32 ring (the audio-out buffer the reference
    streams into via wasm::write_audio / docs/audio-processor.js)."""

    def __init__(self, capacity: int = 1 << 16):
        self.capacity = int(capacity)
        self._l = np.zeros(self.capacity, np.float32)
        self._r = np.zeros(self.capacity, np.float32)
        self._rd = 0
        self._count = 0

    @property
    def available(self) -> int:
        return self._count

    @property
    def space(self) -> int:
        return self.capacity - self._count

    def write(self, left: np.ndarray, right: np.ndarray) -> int:
        n = min(len(left), self.space)
        wr = (self._rd + self._count) % self.capacity
        first = min(n, self.capacity - wr)
        self._l[wr:wr + first] = left[:first]
        self._r[wr:wr + first] = right[:first]
        self._l[:n - first] = left[first:n]
        self._r[:n - first] = right[first:n]
        self._count += n
        return n

    def read(self, n: int) -> Tuple[np.ndarray, np.ndarray]:
        n = min(int(n), self._count)
        first = min(n, self.capacity - self._rd)
        l = np.concatenate([self._l[self._rd:self._rd + first],
                            self._l[:n - first]])
        r = np.concatenate([self._r[self._rd:self._rd + first],
                            self._r[:n - first]])
        self._rd = (self._rd + n) % self.capacity
        self._count -= n
        return l, r


def resampler_pitch(song) -> int:
    """The resampler's pitch from channel 0's sample-rate setting (native
    where the song has no channel settings)."""
    sr_idx = song.channel_settings[0].sample_rate \
        if song.channel_settings else 0
    return {0: rsp.PITCH_NATIVE, 1: rsp.PITCH_NATIVE,
            2: rsp.PITCH_22K, 3: rsp.PITCH_11K,
            4: rsp.PITCH_5K}.get(int(sr_idx), rsp.PITCH_NATIVE)


class SpuChain:
    """The SPU DSP chain of one song on `device` (audio.rs:706-717): the
    master gain, then the reverb (where the song's preset is not 0), then
    the Gaussian resampler (where channel 0's pitch is below native), the
    reverb's and resampler's states carried from one `run` to the next
    (on the card the kernels update them in place).
    The gain is one f32 multiply, as the JAX package's numpy one is."""

    def __init__(self, song, device=None, apply_reverb: bool = True,
                 apply_resampler: bool = True):
        self.device = dev = resolve_device(device)
        self._master = torch.tensor(np.float32(song.master_volume / 100.0),
                                    device=dev)
        self.use_reverb = apply_reverb and song.reverb.preset != 0
        if self.use_reverb:
            self.reverb_state = rvb.init_state(dev)
            self.reverb_params = torch.from_numpy(
                rvb.preset_params(song.reverb.preset)).to(dev)
            self.reverb_wet = np.float32(song.reverb.wet / 127.0)
        self.pitch = resampler_pitch(song)
        self.use_resampler = (apply_resampler
                              and self.pitch < rsp.PITCH_NATIVE)
        if self.use_resampler:
            self.resampler_state = rsp.init_state(dev)

    def to_device(self, left: np.ndarray, right: np.ndarray):
        """Dry host samples -> one (2, n) f32 tensor on the device."""
        return torch.from_numpy(np.stack([left, right])).to(self.device)

    def gain_reverb(self, lr: torch.Tensor):
        """Master gain and reverb of a (2, n) device chunk."""
        left, right = lr[0] * self._master, lr[1] * self._master
        if self.use_reverb:
            self.reverb_state, left, right = rvb.process(
                self.reverb_state, left, right, self.reverb_params,
                self.reverb_wet, inplace=True)
        return left, right

    def resample(self, left: torch.Tensor, right: torch.Tensor):
        if self.use_resampler:
            self.resampler_state, left, right = rsp.process(
                self.resampler_state, left, right, pitch=self.pitch,
                inplace=True)
        return left, right

    def run(self, left: np.ndarray, right: np.ndarray
            ) -> Tuple[np.ndarray, np.ndarray]:
        """Dry host samples in, processed host samples out."""
        out = torch.stack(self.resample(*self.gain_reverb(
            self.to_device(left, right)))).cpu().numpy()
        return out[0], out[1]


class AudioStream:
    """`render_audio(delta)`-equivalent (audio.rs:679-720): seconds in,
    ring-buffered synth+DSP samples out, chunk-exact vs render_song.  The
    DSP runs on `device` (default: the card; the tests pass "cpu").

    Deviations from the reference, both documented:
      * if the ring lacks space, unrendered time stays in the accumulator
        (back-pressure) instead of overrunning the output;
      * the >MAX_CHUNK catch-up drop is the reference's backgrounded-tab
        behavior and is kept (time beyond the cap per call is discarded).
    """

    def __init__(self, song, seconds: Optional[float] = None,
                 sample_rate: int = SAMPLE_RATE,
                 apply_reverb: bool = True, apply_resampler: bool = True,
                 soundfont=None, ring_capacity: int = 1 << 16, device=None):
        pitch_tables = _row_tables(song)[0]
        n_rows = pitch_tables.shape[0]
        rows_per_sec = song.rows_per_second() if n_rows else 1.0
        total_sec = seconds if seconds is not None \
            else (n_rows / rows_per_sec if n_rows else 1.0)
        self.total = int(total_sec * sample_rate)
        self.chain = SpuChain(song, device, apply_reverb, apply_resampler)
        self.synth = SongSynth(song, self.total, sample_rate, soundfont)
        self.song = song
        self.rate = sample_rate
        self.ring = RingBuffer(ring_capacity)
        self.position = 0            # absolute frames synthesized
        self.accumulator = 0.0       # fractional pending samples

    def render_audio(self, delta: float) -> int:
        """Advance the stream by `delta` seconds; returns frames written
        to the ring buffer."""
        self.accumulator += float(delta) * self.rate
        samples = int(self.accumulator)
        if samples <= 0:
            return 0
        self.accumulator -= samples
        samples = min(samples, MAX_CHUNK)        # reference catch-up cap
        n = min(samples, self.ring.space)        # back-pressure (ours)
        self.accumulator += samples - n          # unrendered time retries
        if n <= 0:
            return 0
        a, b = self.position, self.position + n
        left, right = self.chain.run(*self.synth.dry_chunk(a, b))
        self.position = b
        written = self.ring.write(left, right)
        return written

    def read(self, n: int) -> Tuple[np.ndarray, np.ndarray]:
        """Consume up to n frames from the output ring."""
        return self.ring.read(n)
