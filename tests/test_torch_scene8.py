"""The port's scene compile with the 8-bit tables and render_level under
use_rgb555=False (models/scene.py, ops/raster8.py) against the JAX
package's, on the CPU:

  * compile_level(with_8bit=True) field by field, exact, on the asset
    level (tests/torch_scenes.py) and on test_raster8.py's dispatch level;
  * render_level(use_rgb555=False) on a frame cleared to F32_MAX, the
    depth the 8-bit pipeline tests against, within test_raster8.py's
    budget max(4, pixels / 2000) at its frame size, 120x160: the dispatch
    level's camera and the asset level's three (XLA:CPU contracts FMAs:
    on the asset level the 8-bit frames differ from the JAX package's on
    as many seam pixels as the RGB555 frames do, 20 and 26 of 57,600);
  * on the inverse-z clear (0) the z-buffered 8-bit pipeline draws no
    face, as in the JAX package, whose frame is the same blank one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax_refs
import torch_scenes as ts
import torch_seq_cases as sc
from bonnie32_tpu.models import build as jbuild
from bonnie32_tpu.models import level as JL
from bonnie32_tpu.models import scene as JS
from bonnie32_tpu.ops import raster_ref as jrr
from bonnie32_tpu_torch import interop, types
from bonnie32_tpu_torch.config import RasterSettings
from bonnie32_tpu_torch.models import build
from bonnie32_tpu_torch.models import level as TL
from bonnie32_tpu_torch.models import scene as tscene
from bonnie32_tpu_torch.ops import raster_ref

torch.set_num_threads(1)

S8 = RasterSettings.game(use_rgb555=False)
DH, DW = 120, 160
DISPATCH_CAM = ((1536.0, 900.0, 300.0), 0.5, 0.2)
DISPATCH_NAMES = {"A": (0, 16), "B": (1, 8)}


def dispatch_level(L):
    """test_raster8.py's dispatch level: one 3x3 room, its floor
    checkered with two textures."""
    level = L.Level()
    room = L.Room.new(0, (0.0, 0.0, 0.0), 3, 3)
    t0, t1 = L.TextureRef("p", "A"), L.TextureRef("p", "B")
    for x in range(3):
        for z in range(3):
            room.set_floor(x, z, 0.0, t1 if (x + z) % 2 else t0)
    room.recalculate_bounds()
    level.add_room(room)
    return level


def dispatch_textures():
    return [ts.checker_texture15(16, 16, with_black=False),
            ts.checker_texture15(8, 8, with_black=True)]


def dispatch_resolver(ref):
    if not getattr(ref, "is_valid", False):
        return (0, 16)
    return DISPATCH_NAMES.get(ref.name)


def _compile(name, L, S, device=None):
    if name == "dispatch":
        kw = {} if device is None else dict(device=device)
        return S.compile_level(dispatch_level(L), dispatch_textures(),
                               dispatch_resolver, with_8bit=True, **kw)
    level, tex, kw, _ = sc.level_args(name, **(
        jax_refs.JAX_MODULES if L is JL else {}))
    if device is not None:
        kw["device"] = device
    return S.compile_level(level, tex, ts.resolver, with_8bit=True, **kw)


def _cams(name):
    """The level's cameras (numpy leaves, batched) and frame size."""
    if name == "dispatch":
        p, pi, ya = DISPATCH_CAM
        cam = jbuild.make_camera(np.asarray(p, np.float32),
                                 jbuild.camera_basis(pi, ya))
        return jax.tree_util.tree_map(
            lambda x: np.asarray(x)[None], cam), DH, DW
    return jax_refs._np(jax_refs.jax_cams("cave")), DH, DW


@pytest.fixture(scope="module")
def scenes():
    return {name: (jax_refs._np(_compile(name, JL, JS)),
                   _compile(name, TL, tscene, device="cpu"))
            for name in ("dispatch", "asset")}


@pytest.fixture(scope="module")
def jax_frames(scenes):
    """The JAX render_level(use_rgb555=False) of each level's cameras on
    the F32_MAX and the inverse-z clear: name -> {clear: (N, H, W)}."""
    out = {}
    js = jax_refs.jax_settings(S8)
    for name in scenes:
        jsc = jax.tree_util.tree_map(jnp.asarray, scenes[name][0])
        cams, h, w = _cams(name)
        out[name] = {}
        for clear in ("harmonic", "inv"):
            fb0 = jrr.new_framebuffer(h, w, depth_mode=clear)
            out[name][clear] = np.asarray(jax.vmap(
                lambda c: JS.render_level(fb0, jsc, c, js).color)(
                    jax.tree_util.tree_map(jnp.asarray, cams)))
    return out


def _port_frame(scenes, name, clear):
    cams, h, w = _cams(name)
    cams = interop.camera_arrays(cams)
    fb = raster_ref.new_framebuffer(h, w, depth_mode=clear,
                                    n=cams.position.shape[0], device="cpu")
    return tscene.render_level(fb, scenes[name][1], cams, S8)


def fields8():
    paths = ["tex_map"]
    for prefix in ("", "a_"):
        paths += [f"{prefix}atlas8.{f}" for f in types.TextureAtlas8._fields]
    return paths


@pytest.mark.parametrize("path", fields8() + sc.scene_fields())
@pytest.mark.parametrize("name", ["dispatch", "asset"])
def test_compile_level_8bit_matches_jax(scenes, name, path):
    jsc, tsc = scenes[name]
    ours, theirs = sc.field(tsc, path), sc.field(jsc, path)
    assert ours.dtype == theirs.dtype, (ours.dtype, theirs.dtype)
    np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("name", ["dispatch", "asset"])
def test_render_level8_matches_jax(scenes, jax_frames, name):
    out = _port_frame(scenes, name, "harmonic")
    theirs = jax_frames[name]["harmonic"]
    ours = out.color.numpy()
    assert sc.lit_share(ours) > 0.2, "the 8-bit frame draws little"
    diff = int((ours != theirs).sum())
    assert diff <= max(4, ours.size // 2000), diff
    # every drawn pixel wrote its z
    drawn = ((ours >> 24) & 255) == 255
    assert bool((out.depth.numpy()[drawn] < 3e38).all())


@pytest.mark.parametrize("name", ["dispatch", "asset"])
def test_jax_scene_carried_across_renders_the_same(scenes, name):
    """interop.compiled_scene of the JAX package's compile (with its
    8-bit tables) renders the port's frame, pixel for pixel."""
    jsc, tsc = scenes[name]
    carried = interop.compiled_scene(jsc)
    assert carried.a_count == tsc.a_count
    ours = _port_frame({name: (None, tsc)}, name, "harmonic")
    theirs = _port_frame({name: (None, carried)}, name, "harmonic")
    assert torch.equal(ours.color, theirs.color)
    assert torch.equal(ours.depth, theirs.depth)


def test_render_level8_draws_its_own_pipeline(scenes):
    """The toggle changes the frame: the RGB555 frame of the same cameras
    differs from the 8-bit one."""
    cams, h, w = _cams("dispatch")
    cams = interop.camera_arrays(cams)
    fb = raster_ref.new_framebuffer(h, w, depth_mode="inv", device="cpu")
    f15 = tscene.render_level(fb, scenes["dispatch"][1], cams,
                              RasterSettings.game()).color
    f8 = _port_frame(scenes, "dispatch", "harmonic").color
    assert int((f15 != fb.color).sum()) > 500
    assert bool((f8 != f15).any())


@pytest.mark.parametrize("name", ["dispatch", "asset"])
def test_render_level8_on_inverse_z_clear_is_blank(scenes, jax_frames,
                                                   name):
    """The JAX package's behaviour, kept: the 8-bit pipeline tests
    z < depth with linear z, so on a frame cleared to 0 for inverse z no
    face draws, and the frame equals the JAX package's (as blank)."""
    out = _port_frame(scenes, name, "inv")
    assert not bool(out.color.any())
    assert not bool(out.depth.any())
    np.testing.assert_array_equal(out.color.numpy(),
                                  jax_frames[name]["inv"])


def test_render_level8_needs_the_8bit_tables():
    tsc = tscene.compile_level(dispatch_level(TL), dispatch_textures(),
                               dispatch_resolver, device="cpu")
    assert tsc.atlas8 is None
    fb = raster_ref.new_framebuffer(8, 8, device="cpu")
    cams = types.CameraArrays(torch.zeros(1, 3),
                              torch.from_numpy(build.camera_basis(0, 0))[None])
    with pytest.raises(ValueError, match="with_8bit"):
        tscene.render_level(fb, tsc, cams, S8)
