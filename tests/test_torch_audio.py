"""The port's SPU DSP (audio/reverb.py, audio/resampler.py: the plain
twins that the CPU runs) and its song model against the JAX package, on
the CPU, with numpy-seeded inputs fed to both:

  * the reverb, presets 1-9 as nine streams of one batched call, 2,000
    samples of 0.3-sigma noise carried over two calls, against the jitted
    JAX `reverb.process` per preset: work buffers, pos and accum exact,
    outputs within 1e-6 (XLA:CPU contracts the mix into FMAs); preset 1
    unbatched against the scalar golden `GoldReverb` too;
  * a loud input (a +-1.0 square wave, period 100 samples, 4,000
    samples) on presets 4 and 6, where the product in `_mul_vol` passes
    the int32 range: the port wraps it as the JAX package's int32
    multiply does (state exact, outputs within 1e-6), and the golden,
    whose Python integers do not wrap, parts from both;
  * `enabled=False` passes the input through exactly and runs the state
    on;
  * the resampler at pitches 0x0800, 0x0400 and 0x0200, 3,000 samples
    over two calls (the second fed the JAX state through
    interop.resampler_state): pitch counter and accum_count exact,
    history, sums and outputs within 2e-6; against `GoldResampler` too;
  * batched streams equal single-stream calls, exactly; the stream-axis
    helpers give views and refuse shapes that do not fit; `inplace`
    leaves the CPU twin pure;
  * the tables (preset registers, the Gaussian ROM and the kernel's
    `__constant__` copy of it in csrc/audio.cu) equal the JAX package's;
  * songs cross between the packages through RON, both ways.
"""

import dataclasses
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_scenes as ts
from bonnie32_tpu.audio import resampler as jrsp
from bonnie32_tpu.audio import reverb as jrvb
from bonnie32_tpu.audio import song as jsong
from bonnie32_tpu.audio import spu_tables as jtables
from bonnie32_tpu_torch import interop
from bonnie32_tpu_torch.audio import resampler as rsp
from bonnie32_tpu_torch.audio import reverb as rvb
from bonnie32_tpu_torch.audio import song as tsong
from bonnie32_tpu_torch.audio import spu_tables as tables
from golden import audio_golden as gold

torch.set_num_threads(1)
CPU = torch.device("cpu")
PRESETS = tuple(range(1, 10))
N_REVERB = 2000
N_RESAMPLE = 3000


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_reverb(params, left, right, wet, splits):
    """The jitted JAX reverb over `left`/`right` cut at `splits`, its
    state carried: (state as numpy, left_out, right_out)."""
    fn = jax.jit(jrvb.process)
    st = jrvb.init_state()
    outs_l, outs_r = [], []
    for a, b in zip((0,) + splits, splits + (len(left),)):
        st, l2, r2 = fn(st, jnp.asarray(left[a:b]), jnp.asarray(right[a:b]),
                        jnp.asarray(params), jnp.float32(wet))
        outs_l.append(np.asarray(l2))
        outs_r.append(np.asarray(r2))
    return _np(st), np.concatenate(outs_l), np.concatenate(outs_r)


def _port_reverb(params, left, right, wet, splits, streams=None):
    st = rvb.init_state(CPU, streams=streams)
    outs_l, outs_r = [], []
    for a, b in zip((0,) + splits, splits + (left.shape[-1],)):
        st, l2, r2 = rvb.process(st, left[..., a:b], right[..., a:b], params,
                                 wet)
        outs_l.append(l2.numpy())
        outs_r.append(r2.numpy())
    return st, np.concatenate(outs_l, -1), np.concatenate(outs_r, -1)


def _assert_reverb_state(port, ref):
    np.testing.assert_array_equal(port.buffer_l.numpy(), ref.buffer_l)
    np.testing.assert_array_equal(port.buffer_r.numpy(), ref.buffer_r)
    assert int(port.pos) == int(ref.pos)
    assert port.accum.numpy() == ref.accum


def _noise(seed, n, sigma):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal(n) * sigma).astype(np.float32),
            (rng.standard_normal(n) * sigma).astype(np.float32))


def _square(n):
    return np.where((np.arange(n) // 50) % 2 == 0, 1.0, -1.0
                    ).astype(np.float32)


@pytest.fixture(scope="module")
def presets_run():
    """Presets 1-9 as nine streams of one batched port call, each stream
    its own numpy-seeded noise, and the JAX reference per preset."""
    inputs = [_noise(10 + p, N_REVERB, 0.3) for p in PRESETS]
    left = np.stack([i[0] for i in inputs])
    right = np.stack([i[1] for i in inputs])
    params = np.stack([rvb.preset_params(p) for p in PRESETS])
    splits = (N_REVERB // 2,)
    port = _port_reverb(params, left, right, 0.5, splits,
                        streams=len(PRESETS))
    refs = {p: _jax_reverb(jrvb.preset_params(p), left[k], right[k], 0.5,
                           splits) for k, p in enumerate(PRESETS)}
    return port, refs


@pytest.mark.parametrize("preset", PRESETS)
def test_reverb_presets_match_jax(presets_run, preset):
    (st, out_l, out_r), refs = presets_run
    ref_st, ref_l, ref_r = refs[preset]
    k = PRESETS.index(preset)
    _assert_reverb_state(rvb.ReverbState(*(t[k] for t in st)), ref_st)
    np.testing.assert_allclose(out_l[k], ref_l, rtol=0, atol=1e-6)
    np.testing.assert_allclose(out_r[k], ref_r, rtol=0, atol=1e-6)
    assert np.abs(out_l[k]).max() > 0.01


def test_reverb_matches_golden_and_jax_unbatched():
    """Preset 1 unbatched; the second half starts from the JAX state
    carried across by interop.reverb_state."""
    left, right = _noise(0, N_REVERB, 0.3)
    params = rvb.preset_params(1)
    g = gold.GoldReverb({k: int(params[v]) for k, v in rvb._IDX.items()})
    gl, gr = g.process(left.copy(), right.copy(), wet=0.5)
    half = N_REVERB // 2 + 1
    st, tl1, tr1 = _port_reverb(params, left[:half], right[:half], 0.5, ())
    ref_half, _, _ = _jax_reverb(params, left[:half], right[:half], 0.5, ())
    _assert_reverb_state(st, ref_half)
    st, tl2, tr2 = rvb.process(interop.reverb_state(ref_half, CPU),
                               left[half:], right[half:], params, 0.5)
    tl = np.concatenate([tl1, tl2.numpy()])
    tr = np.concatenate([tr1, tr2.numpy()])
    ref_st, jl, jr = _jax_reverb(params, left, right, 0.5, (half,))
    assert tl1.shape == (half,) and st.buffer_l.shape == (
        rvb.BUFFER_SIZE,) and st.pos.shape == ()
    np.testing.assert_allclose(tl, gl, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tr, gr, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tr, jr, rtol=0, atol=1e-6)
    _assert_reverb_state(st, ref_st)
    assert not np.allclose(tl, left)


@pytest.fixture(scope="module")
def loud_run():
    sq = _square(4000)
    params = np.stack([rvb.preset_params(p) for p in (4, 6)])
    port = _port_reverb(params, np.stack([sq, sq]), np.stack([-sq, -sq]),
                        0.5, (), streams=2)
    return sq, port


@pytest.mark.parametrize("k,preset", [(0, 4), (1, 6)])
def test_loud_reverb_wraps_as_jax(loud_run, k, preset):
    """`_mul_vol`'s product passes the int32 range on this input; the JAX
    package wraps it, so does the port, and the golden does not."""
    sq, (st, out_l, out_r) = loud_run
    params = rvb.preset_params(preset)
    ref_st, jl, jr = _jax_reverb(params, sq, -sq, 0.5, ())
    _assert_reverb_state(rvb.ReverbState(*(t[k] for t in st)), ref_st)
    np.testing.assert_allclose(out_l[k], jl, rtol=0, atol=1e-6)
    np.testing.assert_allclose(out_r[k], jr, rtol=0, atol=1e-6)
    g = gold.GoldReverb({n: int(params[v]) for n, v in rvb._IDX.items()})
    gl, _ = g.process(sq.copy(), -sq.copy(), wet=0.5)
    assert (np.abs(gl - out_l[k]) > 1e-3).sum() > 100


def test_mul_vol_wraps_like_int32():
    rng = np.random.default_rng(3)
    s = rng.integers(-98303, 98304, 4096).astype(np.int32)
    v = rng.integers(-32768, 32768, 4096).astype(np.int32)
    with np.errstate(over="ignore"):
        ref = np.clip((s * v) >> 15, -32768, 32767)     # int32, wraps
    got = rvb._mul_vol(torch.from_numpy(s), torch.from_numpy(v).long())
    np.testing.assert_array_equal(got.numpy(), ref)
    assert ((s.astype(np.int64) * v) > 2 ** 31 - 1).any()


def test_reverb_disabled_passes_through():
    left = np.linspace(-0.5, 0.5, 500).astype(np.float32)
    params = rvb.preset_params(3)
    st_off, ol, orr = rvb.process(rvb.init_state(CPU), left, -left, params,
                                  0.5, enabled=False)
    st_on, _, _ = rvb.process(rvb.init_state(CPU), left, -left, params, 0.5)
    np.testing.assert_array_equal(ol.numpy(), left)
    np.testing.assert_array_equal(orr.numpy(), -left)
    for a, b in zip(st_off, st_on):
        assert torch.equal(a, b)
    assert int(st_on.pos) == 250 and st_on.buffer_l.abs().sum() > 0


def test_reverb_leaves_its_input_state_alone():
    st0 = rvb.init_state(CPU)
    st1, _, _ = rvb.process(st0, np.full(64, 0.5, np.float32),
                            np.full(64, 0.5, np.float32),
                            rvb.preset_params(5), 0.5)
    assert int(st0.pos) == 0 and int(st0.buffer_l.abs().sum()) == 0
    assert int(st1.pos) == 32


@pytest.mark.parametrize("pitch", [rsp.PITCH_22K, rsp.PITCH_11K,
                                   rsp.PITCH_5K])
def test_resampler_matches_jax_and_golden(pitch):
    left, right = _noise(1, N_RESAMPLE, 0.4)
    half = N_RESAMPLE // 2 + 1      # odd: the averaging window straddles
    fn = jax.jit(jrsp.process, static_argnames=("pitch",))
    jst, jl1, jr1 = fn(jrsp.init_state(), jnp.asarray(left[:half]),
                       jnp.asarray(right[:half]), pitch=pitch)
    jst2, jl2, jr2 = fn(jst, jnp.asarray(left[half:]),
                        jnp.asarray(right[half:]), pitch=pitch)
    st, tl1, tr1 = rsp.process(rsp.init_state(CPU), left[:half],
                               right[:half], pitch)
    for name in ("pitch_counter", "accum_count"):
        assert int(getattr(st, name)) == int(getattr(jst, name))
    # the second call continues from the JAX state, carried across
    st2, tl2, tr2 = rsp.process(interop.resampler_state(_np(jst), CPU),
                                left[half:], right[half:], pitch)
    ref = _np(jst2)
    for name in ("pitch_counter", "accum_count"):
        assert int(getattr(st2, name)) == int(getattr(ref, name))
    for name in ("history_l", "history_r", "accum_l", "accum_r"):
        np.testing.assert_allclose(getattr(st2, name).numpy(),
                                   getattr(ref, name), rtol=0, atol=2e-6)
    tl = np.concatenate([tl1.numpy(), tl2.numpy()])
    tr = np.concatenate([tr1.numpy(), tr2.numpy()])
    np.testing.assert_allclose(tl, np.concatenate([jl1, jl2]), rtol=0,
                               atol=2e-6)
    np.testing.assert_allclose(tr, np.concatenate([jr1, jr2]), rtol=0,
                               atol=2e-6)
    g = gold.GoldResampler(pitch)
    gl, gr = g.process(left.copy(), right.copy())
    np.testing.assert_allclose(tl, gl, rtol=0, atol=2e-6)
    np.testing.assert_allclose(tr, gr, rtol=0, atol=2e-6)

    def hf(x):
        return np.abs(np.diff(x)).mean()
    assert hf(tl) < hf(left)


def test_resampler_native_pitch_and_disabled_pass_through():
    left, right = _noise(2, 300, 0.4)
    st0 = rsp.init_state(CPU)
    st, ol, orr = rsp.process(st0, left, right, rsp.PITCH_NATIVE)
    assert st is st0
    np.testing.assert_array_equal(ol.numpy(), left)
    st, ol, orr = rsp.process(st0, left, right, rsp.PITCH_22K,
                              enabled=False)
    np.testing.assert_array_equal(ol.numpy(), left)
    np.testing.assert_array_equal(orr.numpy(), right)
    st_on, _, _ = rsp.process(st0, left, right, rsp.PITCH_22K)
    for a, b in zip(st, st_on):
        assert torch.equal(a, b)


def test_batched_streams_equal_single_calls():
    left = np.stack([_noise(20 + k, 400, 0.5)[0] for k in range(3)])
    right = np.stack([_noise(30 + k, 400, 0.5)[0] for k in range(3)])
    st, bl, br = rsp.process(rsp.init_state(CPU, streams=3), left, right,
                             rsp.PITCH_11K)
    params = np.stack([rvb.preset_params(p) for p in (1, 5, 7)])
    rst, rl, rr = rvb.process(rvb.init_state(CPU, streams=3), left, right,
                              params, 0.3)
    for k, p in enumerate((1, 5, 7)):
        s1, l1, r1 = rsp.process(rsp.init_state(CPU), left[k], right[k],
                                 rsp.PITCH_11K)
        assert torch.equal(bl[k], l1) and torch.equal(br[k], r1)
        for a, b in zip(st, s1):
            assert torch.equal(a[k], b)
        s2, l2, r2 = rvb.process(rvb.init_state(CPU), left[k], right[k],
                                 rvb.preset_params(p), 0.3)
        assert torch.equal(rl[k], l2) and torch.equal(rr[k], r2)
        for a, b in zip(rst, s2):
            assert torch.equal(a[k], b)


@pytest.mark.parametrize("module", [rvb, rsp], ids=["reverb", "resampler"])
def test_stream_axis_helpers(module):
    from bonnie32_tpu_torch.audio import _streams
    st = module.init_state(CPU)
    x = np.zeros(8, np.float32)
    bst, bl, br, single = _streams.batched(st, x, x)
    assert single and bl.shape == (1, 8) and bl.is_contiguous()
    assert all(b.shape == (1,) + a.shape for a, b in zip(st, bst))
    bst[0].fill_(1)     # views: what a kernel writes reaches the caller
    assert bool((st[0] == 1).all())
    back, ol, _ = _streams.unbatched(bst, bl, br, single)
    assert ol.shape == (8,) and back[0].shape == st[0].shape
    with pytest.raises(ValueError, match="does not hold 2 streams"):
        _streams.batched(module.init_state(CPU, streams=3),
                         np.zeros((2, 8)), np.zeros((2, 8)))
    with pytest.raises(ValueError, match="expected one"):
        _streams.batched(st, x, np.zeros(9, np.float32))


def test_inplace_option_leaves_the_cpu_twin_pure():
    """`inplace` only spares the card a copy: the CPU twin returns a new
    state, the same as without it, and leaves its input as it was."""
    left = _noise(41, 300, 0.5)[0]
    params = rvb.preset_params(5)
    st0 = rvb.init_state(CPU)
    a = rvb.process(st0, left, -left, params, 0.4, inplace=True)
    b = rvb.process(rvb.init_state(CPU), left, -left, params, 0.4)
    q0 = rsp.init_state(CPU)
    c = rsp.process(q0, left, -left, rsp.PITCH_22K, inplace=True)
    d = rsp.process(rsp.init_state(CPU), left, -left, rsp.PITCH_22K)
    for got, want in ((a, b), (c, d)):
        for x, y in zip(got[0], want[0]):
            assert torch.equal(x, y)
        assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    assert int(st0.pos) == 0 and int(st0.buffer_l.abs().sum()) == 0
    assert int(q0.pitch_counter) == 0 and int(q0.accum_count) == 0


def test_tables_match_jax_and_the_kernels_copy():
    assert tables.GAUSSIAN_TABLE == jtables.GAUSSIAN_TABLE
    assert tables.REVERB_PRESETS == jtables.REVERB_PRESETS
    assert tables.REVERB_ORDER == jtables.REVERB_ORDER
    for p in range(len(tables.REVERB_ORDER)):
        np.testing.assert_array_equal(rvb.preset_params(p),
                                      jrvb.preset_params(p))
    assert rvb._IDX == jrvb._IDX
    src = (pathlib.Path(rvb.__file__).resolve().parent.parent / "csrc"
           / "audio.cu").read_text()
    body = re.search(r"__constant__ int kGauss\[512\] = \{([^}]*)\}",
                     src).group(1)
    assert [int(v) for v in body.replace("\n", " ").split(",")] \
        == tables.GAUSSIAN_TABLE


def _song_fields(song):
    """A song of either package as plain data (Tags as name/value)."""
    def plain(v):
        if dataclasses.is_dataclass(v):
            return {f.name: plain(getattr(v, f.name))
                    for f in dataclasses.fields(v)}
        if isinstance(v, list):
            return [plain(x) for x in v]
        return v
    return plain(song)


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_song_ron_round_trip_across_packages(tmp_path, direction):
    src_mod, dst_mod = ((tsong, jsong) if direction == "port_to_jax"
                        else (jsong, tsong))
    song = ts.demo_song(src_mod, patterns=2, rows=12, channels=6,
                        reverb=5, rate0=3, seed=4)
    song.patterns[0].channels[1][3] = src_mod.Note(
        pitch=50, effect=src_mod.Effect("Arpeggio", 3, 7))
    song.patterns[1].channels[2][5] = src_mod.Note.off()
    song.patterns[1].reverb[2] = 6
    song.instrument_names = ["a", "b"]
    song.master_volume = 80
    path = tmp_path / "song.ron"
    src_mod.save_song(song, str(path))
    loaded = dst_mod.load_song(str(path))
    assert _song_fields(loaded) == _song_fields(song)
    assert dst_mod.parse_song(path.read_bytes()).total_rows() == 24
