"""The port's SoundFont parser (audio/sf2.py) and voice model
(audio/sf2_synth.py), host copies of the JAX package's, against it on the
same bytes: the parsed font field for field, and `render_voice` /
`render_events` bit for bit, over the fonts of tests/test_sf2.py (a
two-zone font with tuning, envelope, pan and loop settings; a font that
routes the vibrato and modulation LFOs, the modulation envelope and the
low-pass filter) and `torch_scenes.sine_font`, which equals the JAX
suite's fixture byte for byte.  A SoundFont song renders through the port
as through the JAX package, exactly, with the DSP off.
"""

import numpy as np
import pytest

import torch_scenes as ts
from bonnie32_tpu.audio import engine as jengine
from bonnie32_tpu.audio import sf2 as JS
from bonnie32_tpu.audio import sf2_synth as JSY
from bonnie32_tpu.audio import song as jsong
from bonnie32_tpu_torch.audio import engine
from bonnie32_tpu_torch.audio import sf2 as S
from bonnie32_tpu_torch.audio import sf2_synth as SY
from bonnie32_tpu_torch.audio import song as tsong
from golden import sf2_fixture as FX


def _two_zone_font(mod):
    n = 1000
    rng = np.random.default_rng(7)
    pool = np.concatenate([
        (np.sin(2 * np.pi * 25 * np.arange(n) / n) * 18000).astype(np.int16),
        (rng.uniform(-12000, 12000, 500)).astype(np.int16)])
    sample_defs = [
        dict(name="sine", start=0, end=n, start_loop=100, end_loop=900,
             sample_rate=32000, original_key=57, correction=11),
        dict(name="noise", start=n, end=n + 500, start_loop=n,
             end_loop=n + 500, sample_rate=44100, original_key=60)]
    zones = [
        {mod.G_KEY_RANGE: 0 | (63 << 8), mod.G_SAMPLE_MODES: 1,
         mod.G_ATTACK_VOL_ENV: -7000, mod.G_RELEASE_VOL_ENV: -3000,
         mod.G_SUSTAIN_VOL_ENV: 200, mod.G_DECAY_VOL_ENV: -2000,
         mod.G_PAN: -300, "sample": 0},
        {mod.G_KEY_RANGE: 64 | (127 << 8), mod.G_SAMPLE_MODES: 0,
         mod.G_COARSE_TUNE: 2, mod.G_FINE_TUNE: -45,
         mod.G_INITIAL_ATTENUATION: 60, mod.G_OVERRIDE_ROOT_KEY: 72,
         "sample": 1}]
    return ts.build_sf2(mod, pool, sample_defs,
                        [dict(name="dual", bank=0, patch=5, zones=zones)])


def _modulated_font(mod):
    n = 4000
    pool = (np.sin(2 * np.pi * 40 * np.arange(n) / n) * 16000
            + np.sin(2 * np.pi * 900 * np.arange(n) / n) * 8000
            ).astype(np.int16)
    zones = [{mod.G_KEY_RANGE: 0 | (127 << 8), mod.G_SAMPLE_MODES: 1,
              mod.G_VIB_LFO_TO_PITCH: 80, mod.G_FREQ_VIB_LFO: 200,
              mod.G_DELAY_VIB_LFO: -6000,
              mod.G_MOD_LFO_TO_VOLUME: 60, mod.G_FREQ_MOD_LFO: 100,
              mod.G_INITIAL_FILTER_FC: 9500, mod.G_INITIAL_FILTER_Q: 100,
              mod.G_MOD_ENV_TO_FILTER_FC: 2400,
              mod.G_ATTACK_MOD_ENV: -4000, mod.G_DECAY_MOD_ENV: -2000,
              mod.G_SUSTAIN_MOD_ENV: 600, mod.G_RELEASE_MOD_ENV: -4000,
              "sample": 0}]
    return ts.build_sf2(
        mod, pool,
        [dict(name="rich", start=0, end=n, start_loop=200, end_loop=3800,
              sample_rate=44100, original_key=60)],
        [dict(name="Mod", bank=0, patch=0, zones=zones)])


FONTS = {"two_zone": _two_zone_font, "modulated": _modulated_font,
         "sine": ts.sine_font}


def _fonts(name):
    data, jdata = FONTS[name](S), FONTS[name](JS)
    assert data == jdata
    return S.load(data), JS.load(data)


def test_generator_opcodes_match_jax():
    names = [n for n in dir(JS) if n.startswith("G_")]
    assert names and all(getattr(S, n) == getattr(JS, n) for n in names)


def test_sine_font_is_the_jax_fixtures():
    assert ts.sine_font(S) == FX.sine_font()
    assert ts.sine_font(S, n=1000, root=48, loop=False) == FX.sine_font(
        n=1000, root=48, loop=False)


@pytest.mark.parametrize("name", sorted(FONTS))
def test_parser_matches_jax(name):
    sf, jsf = _fonts(name)
    assert sf.info == jsf.info
    np.testing.assert_array_equal(sf.samples, jsf.samples)
    assert sf.samples.dtype == jsf.samples.dtype
    assert [tuple(h) for h in sf.sample_headers] == [
        tuple(h) for h in jsf.sample_headers]
    assert len(sf.presets) == len(jsf.presets)
    for p, jp in zip(sf.presets, jsf.presets):
        assert (p.name, p.bank, p.patch) == (jp.name, jp.bank, jp.patch)
        assert [tuple(r) for r in p.regions] == [
            tuple(r) for r in jp.regions]
    for bank, patch in ((0, 5), (0, 0), (3, 9)):
        a, b = sf.find_preset(bank, patch), jsf.find_preset(bank, patch)
        assert (a is None) == (b is None)
        assert a is None or a.name == b.name


VOICES = [("two_zone", 0, 45, 100, 800, 1200),
          ("two_zone", 0, 60, 127, 400, 400),
          ("two_zone", 1, 70, 64, 300, 900),
          ("two_zone", 1, 100, 30, 100, 500),
          ("modulated", 0, 60, 127, 2000, 3000),
          ("modulated", 0, 72, 90, 500, 1500),
          ("sine", 0, 67, 110, 1500, 2500)]


@pytest.mark.parametrize("name,region_idx,key,vel,n_on,n_total", VOICES)
def test_render_voice_matches_jax(name, region_idx, key, vel, n_on,
                                  n_total):
    sf, jsf = _fonts(name)
    region = sf.presets[0].regions[region_idx]
    sig, gl, gr = SY.render_voice(sf, region, key, vel, n_on, n_total,
                                  44100)
    jsig, jgl, jgr = JSY.render_voice(jsf, jsf.presets[0].regions[
        region_idx], key, vel, n_on, n_total, 44100)
    np.testing.assert_array_equal(sig, jsig)
    assert sig.dtype == jsig.dtype and (gl, gr) == (jgl, jgr)
    assert np.abs(sig).max() > 0.01


def test_render_events_matches_jax():
    sf, jsf = _fonts("two_zone")
    events = [(0, 800, 1800, 45, 100), (300, 700, 1500, 70, 64),
              (900, 2000, 2600, 100, 30)]
    got = SY.render_events(
        sf, [SY.NoteEvent(a, b, c, k, v, 0, 5) for a, b, c, k, v in events],
        2400, 44100)
    ref = JSY.render_events(
        jsf, [JSY.NoteEvent(a, b, c, k, v, 0, 5)
              for a, b, c, k, v in events], 2400, 44100)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def test_soundfont_song_matches_jax_without_dsp():
    """tests/test_sf2.py's SoundFont song, port and JAX package, with the
    reverb and the resampler off: the gain alone runs on the device, one
    f32 multiply as the JAX package's numpy one."""
    def song(mod):
        pat = mod.Pattern.new(16, 2)
        pat.channels[0][0] = mod.Note(pitch=60, instrument=0, volume=110)
        pat.channels[0][8] = mod.Note(pitch=67, instrument=0, volume=90)
        pat.channels[1][4] = mod.Note(pitch=48, instrument=0, volume=120)
        s = mod.Song(patterns=[pat], arrangement=[0],
                     channel_instruments=[0, 0], master_volume=85)
        s.reverb.preset = 4
        return s
    got = engine.render_song(song(tsong), soundfont=ts.sine_font(S),
                             apply_reverb=False, apply_resampler=False,
                             device="cpu")
    ref = jengine.render_song(song(jsong), soundfont=FX.sine_font(),
                              apply_reverb=False, apply_resampler=False)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    assert np.abs(got[0]).max() > 0.01
