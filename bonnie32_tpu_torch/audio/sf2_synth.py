"""Sample-based SoundFont synthesizer (the rustysynth-subset voice model).
(The port's own copy of the JAX package's `audio/sf2_synth.py`, host
code: numpy, with scipy's `lfilter` imported where it filters.)

Replaces the placeholder oscillator bank for song rendering when a
SoundFont is loaded, mirroring the reference's synthesis path
(the reference's `src/tracker/audio.rs:516-700`: rustysynth Synthesizer
fed by tracker note_on/note_off, rendered in blocks).  Implemented
generators (the set rustysynth's voice model applies to every note):

  * sample playback with loop modes 0 (none), 1 (continuous),
    3 (loop while key held), linear interpolation;
  * pitch: (key - rootKey) * scaleTuning + coarseTune*100 + fineTune
    cents, times sampleRate ratio;
  * DAHDSR volume envelope (timecents stages; attack linear in
    amplitude, decay/release linear in dB, sustain in centibels);
  * initialAttenuation (centibels), velocity curve (vel/127)^2,
    stereo pan (-500..500, constant-power).

The per-voice math is vectorized over the whole note duration (positions
are an affine ramp, the loop is a modulo, the envelope piecewise) — a
form that runs equally well in numpy on host or jnp on device.
"""

import math
from typing import List, NamedTuple, Optional, Tuple

import numpy as np

from .sf2 import Region, SoundFont

F32 = np.float32


def _timecents_to_sec(tc: int) -> float:
    """2^(tc/1200); the spec's -32768 'instant' floor maps to 0."""
    if tc <= -12000:
        return 0.0
    return float(2.0 ** (tc / 1200.0))


def region_pitch_ratio(region: Region, sf: SoundFont, key: int,
                       out_rate: int) -> float:
    cents = ((key - region.root_key) * region.scale_tuning
             + region.coarse_tune * 100 + region.fine_tune)
    sr = sf.sample_headers[region.sample].sample_rate
    return float(2.0 ** (cents / 1200.0)) * sr / out_rate


def envelope(region: Region, n_on: int, n_total: int,
             out_rate: int, key: int = 60) -> np.ndarray:
    """DAHDSR amplitude envelope over n_total frames, key released at
    frame n_on.  Attack ramps linearly in amplitude; decay/release ramp
    linearly in dB (exponential amplitude); sustain holds at
    -sustain_cB/10 dB.  Hold/decay timecents stretch by
    keynumToVolEnv{Hold,Decay} * (60 - key) (spec 8.1.2 gens 39/40)."""
    t = np.arange(n_total, dtype=np.float64) / out_rate
    t_delay = _timecents_to_sec(region.delay_vol_env)
    t_attack = _timecents_to_sec(region.attack_vol_env)
    t_hold = _timecents_to_sec(
        region.hold_vol_env + region.keynum_to_vol_hold * (60 - key))
    t_decay = _timecents_to_sec(
        region.decay_vol_env + region.keynum_to_vol_decay * (60 - key))
    t_release = _timecents_to_sec(region.release_vol_env)
    sus_db = min(max(region.sustain_vol_env, 0), 1440) / 10.0

    a0 = t_delay
    a1 = a0 + t_attack
    h1 = a1 + t_hold
    d1 = h1 + t_decay

    # held portion
    amp = np.zeros(n_total, np.float64)
    in_attack = (t >= a0) & (t < a1)
    if t_attack > 0:
        amp[in_attack] = (t[in_attack] - a0) / t_attack
    amp[(t >= a1) & (t < h1)] = 1.0
    in_decay = (t >= h1) & (t < d1)
    if t_decay > 0:
        frac = (t[in_decay] - h1) / t_decay
        amp[in_decay] = 10.0 ** (-sus_db * frac / 20.0)
    sus_amp = 10.0 ** (-sus_db / 20.0)
    amp[t >= d1] = sus_amp

    # release from the level at note-off
    if n_on < n_total:
        level_off = amp[n_on] if n_on > 0 else 0.0
        tr = t[n_on:] - t[n_on]
        if t_release > 0:
            # -100 dB over t_release scaled from current level (linear dB)
            rel = level_off * 10.0 ** (-100.0 * (tr / t_release) / 20.0)
        else:
            rel = np.zeros(n_total - n_on)
        rel[tr >= t_release] = 0.0
        amp[n_on:] = np.minimum(amp[n_on:], rel)
    return amp.astype(F32)


def sample_positions(region: Region, ratio: float, n_total: int,
                     key_held_frames: int) -> Tuple[np.ndarray, np.ndarray]:
    """(positions f64, active mask) for n_total output frames.

    Loop modes: 0/2 play start..end once; 1 loops [start_loop, end_loop)
    forever; 3 loops while the key is held, then runs to `end`."""
    pos = region.start + np.arange(n_total, dtype=np.float64) * ratio
    mode = region.sample_modes
    loop_len = max(region.end_loop - region.start_loop, 1)
    if mode == 1:
        over = pos >= region.end_loop
        pos = np.where(over,
                       region.start_loop
                       + np.mod(pos - region.start_loop, loop_len), pos)
        active = np.ones(n_total, bool)
    elif mode == 3:
        held = np.arange(n_total) < key_held_frames
        wrapped = np.where(pos >= region.end_loop,
                           region.start_loop
                           + np.mod(pos - region.start_loop, loop_len), pos)
        # after release, continue from the wrapped position at release
        # time and run linearly to the sample end
        if key_held_frames < n_total and key_held_frames > 0:
            p_rel = wrapped[key_held_frames - 1]
            tail = p_rel + (np.arange(n_total - key_held_frames) + 1) * ratio
            pos = np.concatenate([wrapped[:key_held_frames], tail])
        else:
            pos = wrapped
        active = pos < region.end
        active[:min(key_held_frames, n_total)] = True
    else:
        active = pos < region.end
    return pos, active


# ---------------------------------------------------------------------------
# Modulators (rustysynth voice model: mod/vib LFO, modulation envelope,
# resonant low-pass — the parts audio.rs:516-700's Synthesizer applies to
# every voice beyond the volume envelope)
# ---------------------------------------------------------------------------

BLOCK = 64          # rustysynth processes voices in 64-frame blocks
_CENTS_REF_HZ = 8.176  # absolute-cent frequency reference (SF2 spec 8.1.2)


def _abs_cents_to_hz(c: int) -> float:
    return _CENTS_REF_HZ * float(2.0 ** (c / 1200.0))


def lfo_values(delay_tc: int, freq_cents: int, t: np.ndarray) -> np.ndarray:
    """Triangle LFO: 0 until the delay elapses, then 0 -> 1 -> -1 -> 0 per
    period (rustysynth Lfo)."""
    delay = _timecents_to_sec(delay_tc)
    freq = _abs_cents_to_hz(freq_cents)
    phase = np.mod((t - delay) * freq, 1.0)
    val = np.where(phase < 0.25, 4.0 * phase,
                   np.where(phase < 0.75, 2.0 - 4.0 * phase,
                            4.0 * phase - 4.0))
    return np.where(t < delay, 0.0, val)


def mod_envelope(region: Region, key: int, n_on: int, n_total: int,
                 out_rate: int) -> np.ndarray:
    """DAHDSR modulation envelope, value 0..1 (rustysynth
    ModulationEnvelope: linear attack, linear decay to the sustain level,
    linear release to zero).  Sustain is 1 - sustainModEnv/1000; hold and
    decay stretch by keynumToModEnv{Hold,Decay} * (60 - key)."""
    t = np.arange(n_total, dtype=np.float64) / out_rate
    t_delay = _timecents_to_sec(region.delay_mod_env)
    t_attack = _timecents_to_sec(region.attack_mod_env)
    t_hold = _timecents_to_sec(
        region.hold_mod_env + region.keynum_to_mod_hold * (60 - key))
    t_decay = _timecents_to_sec(
        region.decay_mod_env + region.keynum_to_mod_decay * (60 - key))
    t_release = _timecents_to_sec(region.release_mod_env)
    sus = min(max(1.0 - region.sustain_mod_env / 1000.0, 0.0), 1.0)

    a0 = t_delay
    a1 = a0 + t_attack
    h1 = a1 + t_hold
    d1 = h1 + t_decay

    val = np.zeros(n_total, np.float64)
    in_attack = (t >= a0) & (t < a1)
    if t_attack > 0:
        val[in_attack] = (t[in_attack] - a0) / t_attack
    val[(t >= a1) & (t < h1)] = 1.0
    in_decay = (t >= h1) & (t < d1)
    if t_decay > 0:
        frac = (t[in_decay] - h1) / t_decay
        val[in_decay] = sus + (1.0 - sus) * (1.0 - frac)
    val[t >= d1] = sus

    if n_on < n_total:
        level_off = val[n_on] if n_on > 0 else 0.0
        tr = t[n_on:] - t[n_on]
        if t_release > 0:
            rel = level_off * np.maximum(1.0 - tr / t_release, 0.0)
        else:
            rel = np.zeros(n_total - n_on)
        val[n_on:] = np.minimum(val[n_on:], rel)
    return val


def _block_starts(arr: np.ndarray) -> np.ndarray:
    """Sample the array at block starts (rustysynth updates modulators
    once per 64-frame block)."""
    return arr[::BLOCK]


def lowpass_coeffs(fc: float, q_linear: float, out_rate: int):
    """Normalized RBJ low-pass (b0, b1, b2, a1, a2) — the rustysynth
    BiQuadFilter.set_low_pass_filter design."""
    w = 2.0 * math.pi * fc / out_rate
    alpha = math.sin(w) / (2.0 * q_linear)
    cosw = math.cos(w)
    a0 = 1.0 + alpha
    return ((1 - cosw) / 2 / a0, (1 - cosw) / a0, (1 - cosw) / 2 / a0,
            -2 * cosw / a0, (1 - alpha) / a0)


def _lowpass_blocks(sig: np.ndarray, cutoff_hz: np.ndarray, q_linear: float,
                    out_rate: int) -> np.ndarray:
    """Per-block RBJ low-pass biquad (rustysynth BiQuadFilter:
    set_low_pass_filter once per block, direct-form-I x/y history carried
    across coefficient changes).  Blocks whose cutoff reaches 0.499 * fs
    pass through unfiltered."""
    from scipy.signal import lfilter, lfiltic

    out = np.empty_like(sig)
    x1 = x2 = y1 = y2 = 0.0
    n = len(sig)
    for b0 in range(0, n, BLOCK):
        blk = sig[b0:b0 + BLOCK]
        fc = float(cutoff_hz[b0 // BLOCK])
        if fc >= 0.499 * out_rate:
            out[b0:b0 + BLOCK] = blk
            if len(blk) >= 2:
                x2, x1 = blk[-2], blk[-1]
                y2, y1 = blk[-2], blk[-1]
            continue
        c0, c1, c2, d1, d2 = lowpass_coeffs(fc, q_linear, out_rate)
        b = np.array([c0, c1, c2])
        a = np.array([1.0, d1, d2])
        zi = lfiltic(b, a, [y1, y2], [x1, x2])
        res, _ = lfilter(b, a, blk, zi=zi)
        out[b0:b0 + BLOCK] = res
        if len(blk) >= 2:
            x2, x1 = blk[-2], blk[-1]
            y2, y1 = res[-2], res[-1]
    return out


def _has_modulators(region: Region, out_rate: int) -> bool:
    """True when the rustysynth block path changes the output: an audible
    low-pass cutoff or any nonzero LFO/mod-env routing."""
    fc_hz = _abs_cents_to_hz(region.initial_filter_fc)
    return (fc_hz < 0.499 * out_rate
            or region.mod_lfo_to_pitch != 0
            or region.vib_lfo_to_pitch != 0
            or region.mod_env_to_pitch != 0
            or region.mod_lfo_to_volume != 0
            or region.mod_lfo_to_filter_fc < 0
            or region.mod_env_to_filter_fc < 0)


def render_voice(sf: SoundFont, region: Region, key: int, vel: int,
                 n_on: int, n_total: int, out_rate: int
                 ) -> Tuple[np.ndarray, float, float]:
    """One voice's mono signal over n_total frames plus (left, right)
    gains.  n_on = frames until note-off.

    Fast path (no modulators): affine position ramp, fully vectorized.
    Modulated path: per-block pitch from mod/vib LFO + mod env, resonant
    low-pass with per-block cutoff, mod-LFO tremolo — the rustysynth voice
    model the reference's Synthesizer runs (audio.rs:516-700)."""
    ratio = region_pitch_ratio(region, sf, key, out_rate)
    t = np.arange(n_total, dtype=np.float64) / out_rate

    modulated = _has_modulators(region, out_rate)
    if modulated:
        mod_lfo = lfo_values(region.delay_mod_lfo, region.freq_mod_lfo, t)
        vib_lfo = lfo_values(region.delay_vib_lfo, region.freq_vib_lfo, t)
        menv = mod_envelope(region, key, n_on, n_total, out_rate)
        pitch_cents = (region.mod_lfo_to_pitch * mod_lfo
                       + region.vib_lfo_to_pitch * vib_lfo
                       + region.mod_env_to_pitch * menv)
        if (region.mod_lfo_to_pitch or region.vib_lfo_to_pitch
                or region.mod_env_to_pitch):
            # per-block rate (rustysynth updates pitch per block), then a
            # cumulative position ramp
            blk_cents = np.repeat(_block_starts(pitch_cents),
                                  BLOCK)[:n_total]
            rates = ratio * np.exp2(blk_cents / 1200.0)
            deltas = np.concatenate([[0.0], rates[:-1]])
            pos_ramp = np.cumsum(deltas)
        else:
            pos_ramp = np.arange(n_total, dtype=np.float64) * ratio
        pos, active = _positions_from_ramp(region, pos_ramp, n_total, n_on)
    else:
        pos, active = sample_positions(region, ratio, n_total, n_on)

    smp = sf.samples
    i0 = np.clip(pos.astype(np.int64), 0, len(smp) - 1)
    i1 = np.clip(i0 + 1, 0, len(smp) - 1)
    frac = (pos - np.floor(pos)).astype(np.float64)
    wave = (smp[i0] * (1.0 - frac) + smp[i1] * frac) / 32768.0

    if modulated:
        fc0_hz = _abs_cents_to_hz(region.initial_filter_fc)
        if (fc0_hz < 0.499 * out_rate or region.mod_lfo_to_filter_fc
                or region.mod_env_to_filter_fc):
            fc_cents_mod = (region.mod_lfo_to_filter_fc
                            * _block_starts(mod_lfo)
                            + region.mod_env_to_filter_fc
                            * _block_starts(menv))
            cutoff = fc0_hz * np.exp2(fc_cents_mod / 1200.0)
            # initialFilterQ (centibels) -> linear resonance
            q_linear = max(10.0 ** (region.initial_filter_q / 200.0),
                           math.sqrt(0.5))
            wave = _lowpass_blocks(wave, cutoff, q_linear, out_rate)
        if region.mod_lfo_to_volume:
            trem_db = 0.1 * region.mod_lfo_to_volume \
                * np.repeat(_block_starts(mod_lfo), BLOCK)[:n_total]
            wave = wave * 10.0 ** (trem_db / 20.0)

    env = envelope(region, n_on, n_total, out_rate, key=key)
    att_db = min(max(region.initial_attenuation, 0), 1440) / 10.0
    vgain = (vel / 127.0) ** 2 * 10.0 ** (-att_db / 20.0)
    sig = (wave * env * active * vgain).astype(F32)

    # constant-power pan, -500..500 -> 0..1
    p = (min(max(region.pan, -500), 500) + 500) / 1000.0
    gl = math.cos(p * math.pi / 2.0)
    gr = math.sin(p * math.pi / 2.0)
    return sig, gl, gr


def _positions_from_ramp(region: Region, ramp: np.ndarray, n_total: int,
                         key_held_frames: int
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """sample_positions generalized to a non-affine position ramp (pitch
    modulation); same loop-mode semantics."""
    pos = region.start + ramp
    mode = region.sample_modes
    loop_len = max(region.end_loop - region.start_loop, 1)
    if mode == 1:
        over = pos >= region.end_loop
        pos = np.where(over,
                       region.start_loop
                       + np.mod(pos - region.start_loop, loop_len), pos)
        active = np.ones(n_total, bool)
    elif mode == 3:
        wrapped = np.where(pos >= region.end_loop,
                           region.start_loop
                           + np.mod(pos - region.start_loop, loop_len), pos)
        if 0 < key_held_frames < n_total:
            p_rel = wrapped[key_held_frames - 1]
            tail = p_rel + (ramp[key_held_frames:]
                            - ramp[key_held_frames - 1])
            pos = np.concatenate([wrapped[:key_held_frames], tail])
        else:
            pos = wrapped
        active = pos < region.end
        active[:min(key_held_frames, n_total)] = True
    else:
        active = pos < region.end
    return pos, active


class NoteEvent(NamedTuple):
    start_frame: int
    off_frame: int           # key release frame (absolute)
    end_frame: int           # render cutoff (absolute, incl. release tail)
    key: int
    vel: int
    bank: int
    program: int


def render_events(sf: SoundFont, events: List[NoteEvent], n_frames: int,
                  out_rate: int) -> Tuple[np.ndarray, np.ndarray]:
    """Mix note events into stereo f32 buffers."""
    left = np.zeros(n_frames, F32)
    right = np.zeros(n_frames, F32)
    for ev in events:
        preset = sf.find_preset(ev.bank, ev.program)
        if preset is None:
            continue
        n_total = min(ev.end_frame, n_frames) - ev.start_frame
        if n_total <= 0:
            continue
        n_on = max(min(ev.off_frame, ev.end_frame) - ev.start_frame, 0)
        for region in preset.regions:
            if not (region.key_lo <= ev.key <= region.key_hi
                    and region.vel_lo <= ev.vel <= region.vel_hi):
                continue
            sig, gl, gr = render_voice(sf, region, ev.key, ev.vel,
                                       n_on, n_total, out_rate)
            sl = ev.start_frame
            left[sl:sl + n_total] += sig * F32(gl)
            right[sl:sl + n_total] += sig * F32(gr)
    return left, right
