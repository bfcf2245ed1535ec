"""Colour and fixed-point ops of the port vs the JAX package and the
scalar golden models (tests/golden).  Integer ops: bit-exact, no
tolerance.  The float -> int conversions are held to XLA's convert."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bonnie32_tpu.ops import color as jcol
from bonnie32_tpu.ops import fixed as jfx
from bonnie32_tpu.ops import raster_batch as jrb
from bonnie32_tpu_torch.ops import color as tcol
from bonnie32_tpu_torch.ops import fixed as tfx
from golden import color_golden as cgold
from golden import fixed_golden as fgold

WORDS = np.arange(65536, dtype=np.int32)


@pytest.mark.parametrize("name", ["r5", "g5", "b5"])
def test_channels_and_expand_exhaustive(name):
    ours = getattr(tcol, name)(torch.from_numpy(WORDS))
    theirs = np.asarray(getattr(jcol, name)(jnp.asarray(WORDS)))
    np.testing.assert_array_equal(ours.numpy(), theirs)
    np.testing.assert_array_equal(
        tcol.expand_5_to_8(ours).numpy(),
        np.asarray(jcol.expand_5_to_8(jnp.asarray(theirs))))


def test_dither_quantize_and_offsets_exhaustive():
    v = np.arange(256, dtype=np.int32)
    ys, xs = np.meshgrid(np.arange(8, dtype=np.int32),
                         np.arange(8, dtype=np.int32), indexing="ij")
    off = tcol.dither_offsets(torch.from_numpy(xs), torch.from_numpy(ys))
    gold = np.array([[cgold.PS1_DITHER_MATRIX[y & 3][x & 3]
                      for x in range(8)] for y in range(8)])
    np.testing.assert_array_equal(off.numpy(), gold)
    np.testing.assert_array_equal(
        off.numpy(), np.asarray(jrb._dither_offsets(jnp.asarray(xs),
                                                     jnp.asarray(ys))))
    for o in range(-4, 4):
        ours = tcol.dither_and_quantize8(torch.from_numpy(v),
                                         torch.tensor(o, dtype=torch.int32))
        theirs = np.asarray(jcol.dither_and_quantize8(jnp.asarray(v),
                                                      jnp.int32(o)))
        np.testing.assert_array_equal(ours.numpy(), theirs)


def test_pack_rgba8_matches_jax():
    rng = np.random.default_rng(1)
    ch = [rng.integers(0, 256, 4096).astype(np.int32) for _ in range(3)]
    a = np.full(4096, 255, np.int32)
    ours = tcol.pack_rgba8(*(torch.from_numpy(c) for c in ch + [a]))
    theirs = np.asarray(jcol.pack_rgba8(*(jnp.asarray(c) for c in ch + [a])))
    np.testing.assert_array_equal(ours.numpy(), theirs)


def test_f32_to_i32_matches_xla_convert():
    rng = np.random.default_rng(2)
    vals = np.concatenate([
        rng.uniform(-3e9, 3e9, 2000), rng.uniform(-100, 100, 2000),
        [np.nan, np.inf, -np.inf, 2147483520.0, 2147483648.0,
         -2147483648.0, -2147483904.0, 0.5, -0.5, -0.0]]).astype(np.float32)
    ours = tfx.f32_to_i32(torch.from_numpy(vals)).numpy()
    theirs = np.asarray(jnp.asarray(vals).astype(jnp.int32))
    np.testing.assert_array_equal(ours, theirs)


def test_from_f32_and_mul_fixed_match_golden():
    rng = np.random.default_rng(0)
    vals = np.concatenate([rng.uniform(-10, 10, 500),
                           rng.uniform(-600000, 600000, 500),
                           [0.0, -0.0, 1.0, -1.0, 524288.0, -524289.0,
                            np.nan]]).astype(np.float32)
    ours = tfx.from_f32(torch.from_numpy(vals)).numpy()
    np.testing.assert_array_equal(
        ours, np.array([fgold.from_f32(v) for v in vals], np.int32))
    a = rng.integers(-2**31, 2**31, 4000, dtype=np.int64).astype(np.int32)
    b = rng.integers(-2**31, 2**31, 4000, dtype=np.int64).astype(np.int32)
    prod = tfx.mul_fixed(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(
        prod, np.array([fgold.mul_fixed(int(x), int(y))
                        for x, y in zip(a, b)], np.int32))
    np.testing.assert_array_equal(
        prod, np.asarray(jfx.mul_fixed(jnp.asarray(a), jnp.asarray(b))))


def test_div_unr_matches_golden_and_jax():
    rng = np.random.default_rng(2)
    num = rng.integers(-2**31, 2**31, 8000, dtype=np.int64).astype(np.int32)
    den = rng.integers(-2**31, 2**31, 8000, dtype=np.int64).astype(np.int32)
    den[:16] = 0
    den[16:64] = rng.integers(-64, 64, 48)
    num[64] = np.iinfo(np.int32).min
    den[65] = np.iinfo(np.int32).min
    ours = tfx.div_unr(torch.from_numpy(num), torch.from_numpy(den)).numpy()
    np.testing.assert_array_equal(
        ours, np.array([fgold.div_unr(int(n), int(d))
                        for n, d in zip(num, den)], np.int32))
    np.testing.assert_array_equal(
        ours, np.asarray(jfx.div_unr(jnp.asarray(num), jnp.asarray(den))))


@pytest.mark.parametrize("size", [(320, 240), (64, 48)])
def test_project_fixed_matches_golden_and_jax(size):
    w, h = size
    rng = np.random.default_rng(3)
    world = rng.uniform(-5000, 5000, (600, 3)).astype(np.float32)
    campos = np.array([10.0, -20.0, 5.0], np.float32)
    basis = np.array([[0.8, 0.0, 0.6], [0.0, 1.0, 0.0], [-0.6, 0.0, 0.8]],
                     np.float32)
    sx, sy, d = tfx.project_fixed(torch.from_numpy(world),
                                  torch.from_numpy(campos),
                                  torch.from_numpy(basis), w, h)
    jsx, jsy, jd = jfx.project_fixed(jnp.asarray(world), jnp.asarray(campos),
                                     jnp.asarray(basis), w, h)
    np.testing.assert_array_equal(sx.numpy(), np.asarray(jsx))
    np.testing.assert_array_equal(sy.numpy(), np.asarray(jsy))
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    for i in range(0, 600, 7):
        gx, gy, gd = fgold.project_fixed(tuple(world[i]), tuple(campos),
                                         *(tuple(r) for r in basis), w, h)
        assert (int(sx[i]), int(sy[i])) == (gx, gy)
        assert np.float32(d[i]) == np.float32(gd)


# the colour helpers of the sequential renderer's pixel pipeline, on
# every 16-bit word or a seeded sample of channel values: exact
_RNG = np.random.default_rng(17)
_R, _G, _B = (_RNG.integers(0, 40, 4096).astype(np.int32) for _ in range(3))
_STP = _RNG.random(4096) < 0.5
_V8A, _V8B = (_RNG.integers(0, 256, 4096).astype(np.int32) for _ in range(2))
_MODE = _RNG.integers(0, 6, 4096).astype(np.int32)
_XY = (_RNG.integers(0, 400, 4096).astype(np.int32),
       _RNG.integers(0, 300, 4096).astype(np.int32))
COLOR_HELPERS = {
    "pack15": lambda m, a: m.pack15(a(_R), a(_G), a(_B), a(_STP)),
    "pack15_no_stp": lambda m, a: m.pack15(a(_R), a(_G), a(_B)),
    "is_transparent": lambda m, a: m.is_transparent(a(WORDS)),
    "is_semi_transparent": lambda m, a: m.is_semi_transparent(a(WORDS)),
    "r8": lambda m, a: m.r8(a(WORDS)),
    "g8": lambda m, a: m.g8(a(WORDS)),
    "b8": lambda m, a: m.b8(a(WORDS)),
    "from_rgb888": lambda m, a: m.from_rgb888(a(_V8A), a(_V8B), a(_V8A)),
    "to_rgba_channels": lambda m, a: m.to_rgba_channels(a(WORDS)),
    "modulate8": lambda m, a: m.modulate8(a(_V8A), a(_V8B)),
    "dither_offset": lambda m, a: m.dither_offset(a(_XY[0]), a(_XY[1])),
    "quantize8": lambda m, a: m.quantize8(a(_V8A)),
    "blend_rgb555": lambda m, a: m.blend_rgb555(
        (a(_V8A), a(_V8B), a(_V8A)), (a(_V8B), a(_V8A), a(_V8B)),
        a(_MODE)),
    "unpack_rgba8": lambda m, a: m.unpack_rgba8(a(
        (WORDS.astype(np.int64) * 40503 % (1 << 32) - (1 << 31))
        .astype(np.int32))),
}


@pytest.mark.parametrize("name", sorted(COLOR_HELPERS))
def test_color_helpers_match_jax(name):
    ours = COLOR_HELPERS[name](tcol, torch.from_numpy)
    theirs = COLOR_HELPERS[name](jcol, jnp.asarray)
    if not isinstance(ours, tuple):
        ours, theirs = (ours,), (theirs,)
    assert len(ours) == len(theirs)
    for o, t in zip(ours, theirs):
        t = np.asarray(t)
        np.testing.assert_array_equal(o.numpy().astype(t.dtype), t)


@pytest.mark.parametrize("name", ["sample_texture", "texel_flat_index",
                                  "sample_keyed_bit", "sample_and_key"])
def test_pixel_sampling_matches_jax(name):
    """The texel fetch and colour key of ops/pixel.py against the JAX
    package's on seeded (u, v) over and around [0, 1) (negatives wrap,
    NaN reads texel 0), texture ids -1..2 and both black_transparent
    flags: exact."""
    import torch_scenes as ts
    from bonnie32_tpu.models import build as jbuild
    from bonnie32_tpu.ops import pixel as jpx
    from bonnie32_tpu_torch.models import build as tbuild
    from bonnie32_tpu_torch.ops import pixel as tpx
    tex = [ts.checker_texture15(32, 32, with_black=True,
                                with_transparent=True),
           ts.checker_texture15(16, 8, c1=0x7C00, c2=0x0000),
           ts.checker_texture15(8, 8, c1=0x8000, c2=0x03E0)]
    rng = np.random.default_rng(23)
    u = rng.uniform(-2.5, 3.5, 8192).astype(np.float32)
    v = rng.uniform(-2.5, 3.5, 8192).astype(np.float32)
    u[:16] = np.nan
    tid = rng.integers(-1, 3, 8192).astype(np.int32)
    bt = rng.random(8192) < 0.5
    ta, ja = tbuild.build_atlas(tex), jbuild.build_atlas(tex)

    def call(mod, atlas, conv):
        args = (atlas, conv(tid), conv(u), conv(v))
        if name in ("sample_keyed_bit", "sample_and_key"):
            args += (conv(bt),)
        return getattr(mod, name)(*args)

    ours = call(tpx, ta, torch.from_numpy)
    theirs = call(jpx, ja, jnp.asarray)
    if not isinstance(ours, tuple):
        ours, theirs = (ours,), (theirs,)
    for o, t in zip(ours, theirs):
        t = np.asarray(t)
        np.testing.assert_array_equal(o.numpy().astype(t.dtype), t)
        assert len(np.unique(t)) > 1
