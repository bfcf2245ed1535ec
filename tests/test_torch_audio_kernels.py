"""The designs of csrc/audio.cu's two SPU kernels, held on the CPU:

  * `reverb.window_layout`, the shared-memory layout of a window of W
    ticks, on all ten presets, W in {1, 2, 32, 368, 2048}, from pos 0 and
    from 300 words before the wrap: two (access, tick) pairs share a
    shared-memory word exactly when they address the same buffer word,
    each slot lies in the run staged for it, and the layout fits the
    budget (28 runs of W words; at the kernel's window, 48 KB);
  * a numpy emulation of `spu_reverb`'s windowed schedule, read from
    `layout_table` as the kernel reads it (stage the runs, run the chain
    over the slots with every read of a tick loaded at its start and the
    tick's own writes forwarded, store the written runs back, mix):
    against `reverb.process_ref` on ROOM, HALF_ECHO, HALL, CHAOS_ECHO and
    DELAY (distances 0, 1, 2, 4 and 5 between a write and a later read),
    buffers pre-filled with seeded int16 words, pos near the wrap, calls
    of 1, 37 and 735 samples with the state carried, at the kernel's
    window and at one of 37 ticks: 0 differing samples, words, pos, accum;
  * the parallel `resampler.process_ref` (block sums in order, the
    closed-form Gaussian index) against a float32 numpy transcription of
    the JAX package's per-sample step, exactly, and against the JAX
    `resampler.process` and the golden `GoldResampler` within 2e-6
    (XLA:CPU contracts the taps into FMAs; the golden sums in f64), at
    the three pitches: lengths 1, ratio - 1 and 37 with the state
    carried, a pitch change between calls (a carried count at or above
    the new ratio pushes on the first sample), and `enabled=False`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bonnie32_tpu.audio import resampler as jrsp
from bonnie32_tpu_torch import interop
from bonnie32_tpu_torch.audio import resampler as rsp
from bonnie32_tpu_torch.audio import reverb as rvb
from bonnie32_tpu_torch.audio.spu_tables import GAUSSIAN_TABLE
from golden import audio_golden as gold

torch.set_num_threads(1)
CPU = torch.device("cpu")
B = rvb.BUFFER_SIZE
NEAR_WRAP = B - 300
PITCHES = (rsp.PITCH_22K, rsp.PITCH_11K, rsp.PITCH_5K)
# ROOM, HALF_ECHO, HALL, CHAOS_ECHO, DELAY
EMULATED = (1, 6, 5, 8, 9)


# ---------------------------------------------------------------------------
# the reverb's window layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pos", [0, NEAR_WRAP])
@pytest.mark.parametrize("window", [1, 2, 32, 368, 2048])
@pytest.mark.parametrize("preset", range(10))
def test_window_layout_aliases_exactly_the_same_words(preset, window, pos):
    lay = rvb.window_layout(rvb.preset_params(preset), window)
    t = np.arange(window)
    for side in range(2):
        word = (pos + lay.offsets[side][:, None] + t) % B      # (14, W)
        slot = lay.slots[side][:, None] + t
        pairs = np.unique(np.stack([word.ravel(), slot.ravel()]), axis=1)
        # one word per slot and one slot per word
        assert (len(np.unique(word)) == len(np.unique(slot))
                == pairs.shape[1])
        # each slot lies in a run, which stages exactly that word
        staged = np.full(lay.words[side], -1)
        for start, length, base, _ in lay.runs[side]:
            staged[base:base + length] = (pos + start + np.arange(length)) % B
        assert (staged >= 0).all()
        np.testing.assert_array_equal(staged[slot], word)
        writes = [k for k, a in enumerate(rvb._SIDE_ACCESS) if a[2]]
        for start, length, base, written in lay.runs[side]:
            inside = (lay.slots[side][writes] >= base) & (
                lay.slots[side][writes] < base + length)
            assert written == bool(inside.any())
        assert lay.words[side] <= len(rvb._SIDE_ACCESS) * window
    if window == rvb.WINDOW:
        assert rvb.shared_bytes(*lay.words) <= rvb.SHARED_BYTES
    table = rvb.layout_table(lay)
    assert table.shape == (rvb.LAYOUT_WORDS,) and table.dtype == np.int32


def test_layout_refuses_windows_that_could_wrap_onto_themselves():
    with pytest.raises(ValueError):
        rvb.window_layout(rvb.preset_params(5), B // 28 + 1)


def test_layout_tables_follow_the_rows_and_their_changes():
    params = torch.from_numpy(np.stack([rvb.preset_params(p)
                                        for p in (5, 1, 5)]))
    got = rvb._layout_tables(params, params)
    for row, p in enumerate((5, 1, 5)):
        np.testing.assert_array_equal(
            got.table[row].numpy(),
            rvb.layout_table(rvb.window_layout(rvb.preset_params(p))))
    assert got.shared_bytes == max(
        rvb.shared_bytes(*rvb.window_layout(rvb.preset_params(p)).words)
        for p in (5, 1))
    assert rvb._layout_tables(params, params) is got      # kept
    params[1] = torch.from_numpy(rvb.preset_params(7))
    again = rvb._layout_tables(params, params)            # changed: anew
    np.testing.assert_array_equal(
        again.table[1].numpy(),
        rvb.layout_table(rvb.window_layout(rvb.preset_params(7))))


# ---------------------------------------------------------------------------
# a numpy emulation of spu_reverb's windowed schedule
# ---------------------------------------------------------------------------

def _wrap32(x):
    return ((int(x) + 2 ** 31) % 2 ** 32) - 2 ** 31


def _clamp16(x):
    return min(max(int(x), -32768), 32767)


def _mul_vol(s, v):
    return _clamp16(_wrap32(int(s) * int(v)) >> 15)


def _q15(x):
    t = np.trunc(np.float32(x) * np.float32(32767.0))
    if np.isnan(t):
        return 0
    return int(min(max(t, np.float32(-32768.0)), np.float32(32767.0)))


def _tick(a, l_in, r_in, p, store, same_word):
    """One tick's chain (reverb.py:93-164) on the words `a[side][slot]`
    loaded at its start; `store(side, slot, value)` writes.  With
    `same_word(side, read, write)` (None: no forwarding), a read takes the
    value of the last write of its side made earlier in the tick to the
    same word.  Returns the clamped outputs."""
    (S_D_SAME, S_SAME_PREV, S_SAME, S_DIFF_PREV, S_DIFF, S_D_DIFF, S_COMB1,
     _, _, _, S_APF1_PREV, S_APF1, S_APF2_PREV, S_APF2) = range(14)
    written = {}

    def val(side, k):
        x = a[side][k]
        if same_word is not None:
            for w in rvb._EARLIER_WRITES[side].get(k, ()):
                if (side, w) in written and same_word(side, k, w):
                    x = written[(side, w)]
        return x

    def wr(side, k, v):
        v = _clamp16(v)
        store(side, k, v)
        written[(side, k)] = v

    def iir(side, d, prev, x_in, k_out):
        x = x_in + _mul_vol(d, p["v_wall"])
        wr(side, k_out, _mul_vol(x - prev, p["v_iir"]) + prev)

    iir(0, val(0, S_D_SAME), val(0, S_SAME_PREV), l_in, S_SAME)
    iir(1, val(1, S_D_SAME), val(1, S_SAME_PREV), r_in, S_SAME)
    iir(0, val(1, S_D_DIFF), val(0, S_DIFF_PREV), l_in, S_DIFF)
    iir(1, val(0, S_D_DIFF), val(1, S_DIFF_PREV), r_in, S_DIFF)
    outs = [sum(_mul_vol(val(side, S_COMB1 + c), p[f"v_comb{c + 1}"])
                for c in range(4)) for side in range(2)]
    for k_prev, k_w, v in ((S_APF1_PREV, S_APF1, p["v_apf1"]),
                           (S_APF2_PREV, S_APF2, p["v_apf2"])):
        for side in range(2):
            ap = val(side, k_prev)
            o = outs[side] - _mul_vol(ap, v)
            wr(side, k_w, o)
            outs[side] = _mul_vol(o, v) + ap
    return _clamp16(outs[0]), _clamp16(outs[1])


def _emulate_reverb(buf_l, buf_r, pos, accum, left, right, params, wet,
                    window, window_samples):
    """spu_reverb's schedule for one stream, word for word as
    csrc/audio.cu runs it, from the layout table alone: stage the runs,
    walk the accumulator, run the chain two ticks a step (every read of
    both loaded first) where the table says `paired`, else one tick a
    step with its own writes forwarded, store the written runs, mix."""
    table = rvb.layout_table(rvb.window_layout(params, window))
    words, nruns, paired = table[0:2], table[2:4], bool(table[4])
    slots = table[5:33].reshape(2, 14)
    runs = table[33:].reshape(2, 14, 4)

    def same_word(side, r, w):
        return slots[side][r] == slots[side][w]
    p = {k: int(params[i]) for k, i in rvb._IDX.items()}
    bufs = [buf_l.copy(), buf_r.copy()]
    wet_f, dry_f, vol_f, inc_f = rvb._scalars(wet, 1.0, 2.0)
    accum = np.float32(accum)
    out_l = np.empty_like(left)
    out_r = np.empty_like(right)
    reads = [k for k, a in enumerate(rvb._SIDE_ACCESS) if not a[2]]
    i0, n = 0, len(left)
    while i0 < n:
        pos0 = pos
        length = min(window_samples, n - i0)
        sh = [np.zeros(words[side], np.int64) for side in range(2)]
        for side in range(2):
            for start, ln, base, _ in runs[side][:nruns[side]]:
                sh[side][base:base + ln] = bufs[side][
                    (pos0 + start + np.arange(ln)) % B]
        tick_at, j = [], 0
        while j < length and len(tick_at) < window:
            accum = np.float32(accum + inc_f)
            if accum >= np.float32(1.0):
                tick_at.append(j)
                accum = np.float32(accum - np.float32(1.0))
            j += 1
        used = j
        ins = [(_mul_vol(_q15(left[i0 + jj]), p["v_l_in"]),
                _mul_vol(_q15(right[i0 + jj]), p["v_r_in"]))
               for jj in tick_at]

        def load(t):
            return [{k: int(sh[side][slots[side][k] + t]) for k in reads}
                    for side in range(2)]

        def store_at(t):
            def store(side, k, v):
                sh[side][slots[side][k] + t] = v
            return store

        outs = []
        t = 0
        step = 2 if paired else 1
        while t < len(tick_at):
            group = range(t, min(t + step, len(tick_at)))
            loaded = [load(u) for u in group]
            for u, a in zip(group, loaded):
                outs.append(_tick(a, *ins[u], p, store_at(u),
                                  None if paired else same_word))
            t += step
        if tick_at:
            pos = (pos0 + len(tick_at)) % B
        for side in range(2):
            for start, ln, base, w in runs[side][:nruns[side]]:
                if w:
                    bufs[side][(pos0 + start + np.arange(ln)) % B] = \
                        sh[side][base:base + ln]
        out_l[i0:i0 + used] = left[i0:i0 + used]
        out_r[i0:i0 + used] = right[i0:i0 + used]
        for jj, (tl, tr) in zip(tick_at, outs):
            for out, x, tv in ((out_l, left, tl), (out_r, right, tr)):
                w = np.float32(tv) / np.float32(32767.0)
                out[i0 + jj] = (x[i0 + jj] * dry_f + w * wet_f) * vol_f
        i0 += used
    return bufs[0], bufs[1], pos, accum, out_l, out_r


def _prefilled_state(seed):
    """Buffers of seeded int16 words, pos 300 words before the wrap, the
    accumulator half way to a tick."""
    rng = np.random.default_rng(seed)
    words = rng.integers(-32768, 32768, (2, B)).astype(np.int32)
    return rvb.ReverbState(buffer_l=torch.from_numpy(words[0]),
                           buffer_r=torch.from_numpy(words[1]),
                           pos=torch.tensor(NEAR_WRAP, dtype=torch.int32),
                           accum=torch.tensor(0.5, dtype=torch.float32))


@pytest.mark.parametrize("window", [rvb.WINDOW, 37])
@pytest.mark.parametrize("preset", EMULATED)
def test_windowed_schedule_matches_process_ref(preset, window):
    params = rvb.preset_params(preset)
    st = _prefilled_state(preset)
    rng = np.random.default_rng(100 + preset)
    lengths = (1, 37, 735)
    x = (rng.standard_normal((2, sum(lengths)))
         * 0.6).astype(np.float32)
    x[:, 300:420] = np.where((np.arange(120) // 30) % 2, 1.0, -1.0)
    em = (st.buffer_l.numpy(), st.buffer_r.numpy(), int(st.pos),
          np.float32(st.accum))
    a = 0
    for ln in lengths:
        seg = slice(a, a + ln)
        st, ol, orr = rvb.process_ref(st, x[0, seg], x[1, seg], params, 0.7)
        *em, el, er = _emulate_reverb(*em, x[0, seg], x[1, seg], params,
                                      0.7, window, 2 * window)
        np.testing.assert_array_equal(el, ol.numpy())
        np.testing.assert_array_equal(er, orr.numpy())
        np.testing.assert_array_equal(em[0], st.buffer_l.numpy())
        np.testing.assert_array_equal(em[1], st.buffer_r.numpy())
        assert em[2] == int(st.pos)
        assert em[3] == st.accum.numpy()
        a += ln
    assert int(st.pos) < NEAR_WRAP        # the run crossed the wrap


# ---------------------------------------------------------------------------
# the parallel resampler twin
# ---------------------------------------------------------------------------

def _seq_resampler(state, left, right, pitch, enabled=True):
    """The JAX package's per-sample step (resampler.py:58-102) in float32
    numpy, one rounding an operation: (state, out_l, out_r)."""
    f = np.float32
    hl = [f(v) for v in state.history_l.numpy()]
    hr = [f(v) for v in state.history_r.numpy()]
    pc = int(state.pitch_counter)
    al, ar = f(state.accum_l), f(state.accum_r)
    ac = int(state.accum_count)
    ratio = rsp.PITCH_NATIVE // pitch
    out_l = np.empty(len(left), np.float32)
    out_r = np.empty(len(left), np.float32)

    def gauss(h, i):
        g = [f(GAUSSIAN_TABLE[k]) for k in (0xFF - i, 0x1FF - i, 0x100 + i,
                                            i)]
        acc = f(f(g[0] * h[0]) + f(g[1] * h[1]))
        acc = f(acc + f(g[2] * h[2]))
        acc = f(acc + f(g[3] * h[3]))
        return min(max(f(acc / f(32768.0)), f(-1.5)), f(1.5))

    for i in range(len(left)):
        al = f(al + left[i])
        ar = f(ar + right[i])
        ac += 1
        if ac >= ratio:
            hl = hl[1:] + [min(max(f(al / f(ac)), f(-1.5)), f(1.5))]
            hr = hr[1:] + [min(max(f(ar / f(ac)), f(-1.5)), f(1.5))]
            al, ar, ac = f(0.0), f(0.0), 0
        pc += pitch
        idx = (pc >> 4) & 0xFF
        out_l[i] = gauss(hl, idx) if enabled else left[i]
        out_r[i] = gauss(hr, idx) if enabled else right[i]
        if pc >= 0x1000:
            pc &= 0xFFF
    new = rsp.ResamplerState(
        history_l=torch.tensor(np.array(hl, np.float32)),
        history_r=torch.tensor(np.array(hr, np.float32)),
        pitch_counter=torch.tensor(pc, dtype=torch.int32),
        accum_l=torch.tensor(al, dtype=torch.float32),
        accum_r=torch.tensor(ar, dtype=torch.float32),
        accum_count=torch.tensor(ac, dtype=torch.int32))
    return new, out_l, out_r


def _assert_resampler_state(got, want):
    for name in rsp.ResamplerState._fields:
        a, b = getattr(got, name), getattr(want, name)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=name)


def _jax_resampler(pitch, left, right, lengths, pitches=None):
    """The JAX `resampler.process` over `left`/`right` cut into
    `lengths`, the state carried (and the pitch of each call from
    `pitches`): the states after each call and the outputs."""
    fn = jax.jit(jrsp.process, static_argnames=("pitch", "enabled"))
    st = jrsp.init_state()
    states, outs_l, outs_r = [], [], []
    a = 0
    for k, ln in enumerate(lengths):
        p = pitch if pitches is None else pitches[k]
        st, jl, jr = fn(st, jnp.asarray(left[a:a + ln]),
                        jnp.asarray(right[a:a + ln]), pitch=p)
        states.append(jax.tree_util.tree_map(np.asarray, st))
        outs_l.append(np.asarray(jl))
        outs_r.append(np.asarray(jr))
        a += ln
    return states, np.concatenate(outs_l), np.concatenate(outs_r)


@pytest.mark.parametrize("pitch", PITCHES)
def test_parallel_resampler_matches_jax_golden_and_per_sample_step(pitch):
    ratio = rsp.PITCH_NATIVE // pitch
    lengths = (1, ratio - 1, 37, 1, ratio - 1, 37, 200)
    rng = np.random.default_rng(pitch)
    n = sum(lengths)
    left = (rng.standard_normal(n) * 0.5).astype(np.float32)
    right = (rng.standard_normal(n) * 0.9).astype(np.float32)
    jstates, jl, jr = _jax_resampler(pitch, left, right, lengths)
    st = rsp.init_state(CPU)
    seq = rsp.init_state(CPU)
    outs_l, outs_r = [], []
    a = 0
    for k, ln in enumerate(lengths):
        seg = slice(a, a + ln)
        st, ol, orr = rsp.process_ref(st, left[seg], right[seg], pitch)
        seq, sl, sr = _seq_resampler(seq, left[seg], right[seg], pitch)
        np.testing.assert_array_equal(ol.numpy(), sl)
        np.testing.assert_array_equal(orr.numpy(), sr)
        _assert_resampler_state(st, seq)
        for name in ("pitch_counter", "accum_count"):
            assert int(getattr(st, name)) == int(getattr(jstates[k], name))
        for name in ("history_l", "history_r", "accum_l", "accum_r"):
            np.testing.assert_allclose(getattr(st, name).numpy(),
                                       getattr(jstates[k], name), rtol=0,
                                       atol=2e-6)
        outs_l.append(ol.numpy())
        outs_r.append(orr.numpy())
        a += ln
    tl, tr = np.concatenate(outs_l), np.concatenate(outs_r)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=2e-6)
    np.testing.assert_allclose(tr, jr, rtol=0, atol=2e-6)
    gl, gr = gold.GoldResampler(pitch).process(left.copy(), right.copy())
    np.testing.assert_allclose(tl, gl, rtol=0, atol=2e-6)
    np.testing.assert_allclose(tr, gr, rtol=0, atol=2e-6)


@pytest.mark.parametrize("first,second", [(rsp.PITCH_5K, rsp.PITCH_22K),
                                          (rsp.PITCH_22K, rsp.PITCH_5K),
                                          (rsp.PITCH_11K, rsp.PITCH_22K)])
def test_parallel_resampler_across_a_pitch_change(first, second):
    """The count carried from the first pitch can reach the second's
    ratio: the step then pushes on the first sample with count + 1."""
    rng = np.random.default_rng(first + 7 * second)
    lengths = (7, 3, 37, 64)
    pitches = (first, first, second, second)
    n = sum(lengths)
    left = (rng.standard_normal(n) * 0.5).astype(np.float32)
    right = (rng.standard_normal(n) * 0.5).astype(np.float32)
    jstates, jl, jr = _jax_resampler(None, left, right, lengths, pitches)
    st = rsp.init_state(CPU)
    seq = rsp.init_state(CPU)
    outs = []
    a = 0
    carried_counts = []
    for k, ln in enumerate(lengths):
        seg = slice(a, a + ln)
        carried_counts.append(int(st.accum_count))
        st, ol, orr = rsp.process_ref(st, left[seg], right[seg], pitches[k])
        seq, sl, sr = _seq_resampler(seq, left[seg], right[seg], pitches[k])
        np.testing.assert_array_equal(ol.numpy(), sl)
        np.testing.assert_array_equal(orr.numpy(), sr)
        _assert_resampler_state(st, seq)
        assert int(st.accum_count) == int(jstates[k].accum_count)
        assert int(st.pitch_counter) == int(jstates[k].pitch_counter)
        outs.append(ol.numpy())
        a += ln
    np.testing.assert_allclose(np.concatenate(outs), jl, rtol=0, atol=2e-6)
    if first < second:     # 5K -> 22K, 11K -> 22K: a count >= new ratio
        assert carried_counts[2] >= rsp.PITCH_NATIVE // second


@pytest.mark.parametrize("pitch", PITCHES)
def test_parallel_resampler_disabled_passes_through(pitch):
    rng = np.random.default_rng(3 * pitch)
    x = (rng.standard_normal((2, 45)) * 0.5).astype(np.float32)
    on = rsp.process_ref(rsp.init_state(CPU), x[0], x[1], pitch)
    off = rsp.process_ref(rsp.init_state(CPU), x[0], x[1], pitch,
                          enabled=False)
    seq = _seq_resampler(rsp.init_state(CPU), x[0], x[1], pitch,
                         enabled=False)
    np.testing.assert_array_equal(off[1].numpy(), x[0])
    np.testing.assert_array_equal(off[2].numpy(), x[1])
    _assert_resampler_state(off[0], on[0])
    _assert_resampler_state(off[0], seq[0])


def test_parallel_resampler_batched_streams_carry_their_own_counts():
    """Streams whose carried counts differ push on different samples."""
    rng = np.random.default_rng(11)
    st = rsp.init_state(CPU, streams=3)
    st = st._replace(accum_count=torch.tensor([0, 3, 9], dtype=torch.int32),
                     accum_l=torch.tensor([0.0, 0.25, -0.5]),
                     pitch_counter=torch.tensor([0, 0x7F0, 0xFFF],
                                                dtype=torch.int32))
    x = (rng.standard_normal((2, 3, 29)) * 0.5).astype(np.float32)
    got, gl, gr = rsp.process_ref(st, x[0], x[1], rsp.PITCH_5K)
    for k in range(3):
        one = rsp.ResamplerState(*(t[k] for t in st))
        want, wl, wr = _seq_resampler(one, x[0, k], x[1, k], rsp.PITCH_5K)
        np.testing.assert_array_equal(gl[k].numpy(), wl)
        np.testing.assert_array_equal(gr[k].numpy(), wr)
        _assert_resampler_state(rsp.ResamplerState(*(t[k] for t in got)),
                                want)


def test_kernel_constants_match_the_source():
    """The wrappers' copies of csrc/audio.cu's sizes."""
    import pathlib
    import re
    src = (pathlib.Path(rvb.__file__).resolve().parent.parent / "csrc"
           / "audio.cu").read_text()
    assert int(re.search(r"constexpr int kSegment = (\d+);", src)
               .group(1)) == rsp.SEGMENT
    enum = {name: int(v) for name, v in re.findall(
        r"(LW_\w+) = (\d+),", src)}
    # layout_table's places: words, runs, paired, slots, runs' table
    assert enum == {"LW_WORDS": 0, "LW_RUNS": 2, "LW_PAIRED": 4,
                    "LW_SLOTS": 5, "LW_RUN_TABLE": 33}
    assert "kLayoutWords = LW_RUN_TABLE + 2 * kSideSlots * 4" in src
    assert rvb.LAYOUT_WORDS == 33 + 2 * 14 * 4
    order = re.search(r"enum Slot \{([^}]*)\}", src).group(1)
    names = [w.strip().split("=")[0].strip() for w in order.split(",")
             if w.strip()]
    assert len(names) == len(rvb._SIDE_ACCESS) == 14


def test_resampler_state_from_jax_carries_into_the_parallel_twin():
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((2, 41)) * 0.5).astype(np.float32)
    jstates, _, _ = _jax_resampler(rsp.PITCH_11K, x[0], x[1], (13,))
    st = interop.resampler_state(jstates[0], CPU)
    got = rsp.process_ref(st, x[0, 13:], x[1, 13:], rsp.PITCH_11K)
    want = _seq_resampler(st, x[0, 13:], x[1, 13:], rsp.PITCH_11K)
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    _assert_resampler_state(got[0], want[0])
