"""The port's song rendering (audio/engine.py `render_song`) and streamed
rendering (audio/stream.py `AudioStream.render_audio`) on the CPU:

  * `render_song(device="cpu")` against the JAX package's `render_song`
    on short songs built in code (tests/torch_scenes.py `demo_song`: five
    channels, one per oscillator family, at 1,200 bpm, so a few rows are
    some 3,300 samples that the plain twins can loop over), through the
    oscillators and through `sine_font`, with the reverb, with the 22 kHz
    resampler, and with both: within 2e-6 (XLA:CPU contracts the reverb's
    mix and the Gaussian taps into FMAs); with the DSP off, exactly;
  * streamed equals offline in the port, bit for bit (`np.array_equal`),
    with ragged render_audio deltas: oscillators with the reverb,
    oscillators with the resampler, the SoundFont with the reverb;
  * the accumulator, the catch-up cap, the ring's back-pressure and
    wrap-around, the program -> oscillator mapping (as the JAX package's);
  * without a card, the entry points refuse the default device.
"""

import numpy as np
import pytest
import torch

import torch_scenes as ts
from bonnie32_tpu.audio import engine as jengine
from bonnie32_tpu.audio import sf2 as jsf2
from bonnie32_tpu.audio import song as jsong
from bonnie32_tpu.audio import stream as jstream
from bonnie32_tpu_torch.audio import engine
from bonnie32_tpu_torch.audio import sf2
from bonnie32_tpu_torch.audio import song as tsong
from bonnie32_tpu_torch.audio import stream as strm

torch.set_num_threads(1)
SHORT = dict(patterns=1, rows=6, channels=5, bpm=1200)
# (reverb preset, channel 0's sample-rate setting, SoundFont)
CASES = {"osc_reverb": (5, 0, False), "osc_resampler": (0, 2, False),
         "osc_both": (4, 3, False), "font_both": (6, 2, True),
         "font_dry": (0, 0, True)}


def _song(mod, case, seed=1):
    reverb, rate0, _ = CASES[case]
    return ts.demo_song(mod, reverb=reverb, rate0=rate0, seed=seed, **SHORT)


@pytest.mark.parametrize("case", sorted(CASES))
def test_render_song_matches_jax(case):
    font = CASES[case][2]
    got_l, got_r = engine.render_song(
        _song(tsong, case), soundfont=ts.sine_font(sf2) if font else None,
        device="cpu")
    ref_l, ref_r = jengine.render_song(
        _song(jsong, case), soundfont=ts.sine_font(jsf2) if font else None)
    assert got_l.dtype == np.float32 and got_l.shape == ref_l.shape
    assert got_l.shape[0] > 3000
    if case == "font_dry":
        np.testing.assert_array_equal(got_l, ref_l)
        np.testing.assert_array_equal(got_r, ref_r)
    np.testing.assert_allclose(got_l, ref_l, rtol=0, atol=2e-6)
    np.testing.assert_allclose(got_r, ref_r, rtol=0, atol=2e-6)
    assert np.abs(got_l).max() > 0.01


def _ragged_deltas(total_frames, rate, seed, overshoot=300):
    """Irregular call intervals (odd chunk lengths and sub-sample
    leftovers) until `overshoot` frames past the horizon."""
    rng = np.random.default_rng(seed)
    sizes = np.array([37, 256, 441, 1000, 1361]) + 0.25
    deltas, produced = [], 0.0
    while produced < total_frames + overshoot:
        k = float(sizes[rng.integers(len(sizes))])
        deltas.append(k / rate)
        produced += k
    return deltas


def _stream_all(stream, deltas):
    l_parts, r_parts = [], []
    for d in deltas:
        stream.render_audio(d)
        l, r = stream.read(stream.ring.available)
        l_parts.append(l)
        r_parts.append(r)
    return np.concatenate(l_parts), np.concatenate(r_parts)


@pytest.mark.parametrize("case", ["osc_reverb", "osc_resampler",
                                  "font_both"])
def test_stream_matches_offline(case):
    font = ts.sine_font(sf2) if CASES[case][2] else None
    song = _song(tsong, case, seed=2)
    off_l, off_r = engine.render_song(song, soundfont=font, device="cpu")
    stream = strm.AudioStream(song, soundfont=font, device="cpu")
    st_l, st_r = _stream_all(stream, _ragged_deltas(stream.total,
                                                    stream.rate, 5))
    assert stream.position >= stream.total
    n = len(off_l)
    assert np.array_equal(off_l, st_l[:n])
    assert np.array_equal(off_r, st_r[:n])
    assert np.abs(off_l).max() > 0.01
    dl, dr = stream.synth.dry_chunk(stream.total, stream.total + 500)
    assert not dl.any() and not dr.any()


def test_stream_carries_device_state():
    """The reverb's and resampler's states stay tensors on the stream's
    device and move on with every chunk."""
    stream = strm.AudioStream(_song(tsong, "osc_both"), device="cpu")
    stream.render_audio(300 / stream.rate)
    rs = stream.chain.reverb_state
    assert rs.buffer_l.device.type == "cpu" and int(rs.pos) == 150
    stream.render_audio(300 / stream.rate)
    assert int(stream.chain.reverb_state.pos) == 300
    assert int(stream.chain.resampler_state.accum_count) == 600 % 4


def test_accumulator_and_cap_semantics():
    song = _song(tsong, "osc_reverb")
    song.reverb.preset = 0
    stream = strm.AudioStream(song, seconds=0.2, device="cpu")
    assert stream.render_audio(0.5 / stream.rate) == 0
    assert 0 < stream.accumulator < 1
    assert stream.render_audio(0.6 / stream.rate) == 1
    w = stream.render_audio(1.0)
    assert w == strm.MAX_CHUNK
    stream.read(stream.ring.available)


def test_ring_backpressure():
    song = _song(tsong, "osc_reverb")
    song.reverb.preset = 0
    stream = strm.AudioStream(song, ring_capacity=256, device="cpu")
    stream.render_audio(512 / stream.rate)
    assert stream.ring.available == 256
    l1, _ = stream.read(256)
    assert stream.render_audio(0.0) == 256
    stream.render_audio(256 / stream.rate)
    l2, _ = stream.read(stream.ring.available)
    off_l, _ = engine.render_song(song, device="cpu")
    got = np.concatenate([l1, l2])
    assert np.array_equal(got, off_l[:len(got)])


def test_ring_wraparound():
    rb = strm.RingBuffer(8)
    x = np.arange(6, dtype=np.float32)
    assert rb.write(x, x) == 6
    l, _ = rb.read(4)
    assert np.array_equal(l, x[:4])
    y = np.arange(10, 16, dtype=np.float32)
    assert rb.write(y, y) == 6
    l, r = rb.read(8)
    assert np.array_equal(l, np.concatenate([x[4:6], y]))
    assert np.array_equal(r, l)


def test_program_wave_mapping_matches_jax():
    for prog in range(128):
        assert strm._program_wave(prog) == jstream._program_wave(prog)
    assert [strm._program_wave(p) for p in ts.DEMO_PROGRAMS[:5]] == [
        "triangle", "sine", "saw", "square", "noise"]


def test_entry_points_refuse_the_default_device_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    song = _song(tsong, "osc_reverb")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        engine.render_song(song)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        strm.AudioStream(song)
