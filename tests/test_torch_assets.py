"""Placed asset draws in `compile_level_flat`, and a level lit by point
and spot lights, the port vs the JAX package.

The sample assets are not in the repository, so tests/torch_scenes.py
builds one in code: an asset with two mesh parts — a cube with an
embedded 4-bit atlas, and a double-sided upright quad whose texture is a
user texture with transparent texels — and a Light component, placed
twice in the Cave-size level (once raised and turned).  The host helpers
(`models/scene.py`: collect_scene_lights, transform_part_vertices,
resolve_part_texture15) and the compiled tables are exact (the same host
numpy in the same order); frames are within the seam budget max(64*N,
pixels/500), because XLA:CPU contracts a*b+c into FMAs (the JAX kernel in
interpret mode and its shading), the port never.

The lit level compiles the Cave-size level with test_torch_scene.py's
LIGHT_SPECS (directional, point, spot, one disabled).  With point lights
the JAX compile does not fold the shade tables (`sh_mode` is None), so
its kernel evaluates the general per-corner Gouraud columns, as the
port always does.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_scenes as ts
from bonnie32_tpu import rollout as jrollout
from bonnie32_tpu.config import RasterSettings as JRS
from bonnie32_tpu.game import step as jstep
from bonnie32_tpu.models import asset as JA
from bonnie32_tpu.models import level as JL
from bonnie32_tpu.models import mesh as JM
from bonnie32_tpu.models import scene as jscene
from bonnie32_tpu.models import scene_flat as jsf
from bonnie32_tpu.models import user_texture as JU
from bonnie32_tpu.ops import camera as jcam
from bonnie32_tpu_torch import interop
from bonnie32_tpu_torch import rollout as trollout
from bonnie32_tpu_torch.config import RasterSettings
from bonnie32_tpu_torch.game import step as tstep
from bonnie32_tpu_torch.models import asset as TA
from bonnie32_tpu_torch.models import level as TL
from bonnie32_tpu_torch.models import mesh as TM
from bonnie32_tpu_torch.models import scene as tscene
from bonnie32_tpu_torch.models import scene_flat as tsf
from bonnie32_tpu_torch.models import user_texture as TU
from bonnie32_tpu_torch.ops import wireframe as wf
from test_torch_composite import CLEAR, _budget, _jax_render, _np
from test_torch_scene import LIGHT_SPECS, _FLAT_FIELDS, _field

torch.set_num_threads(1)

H, W = 120, 160
N_ROLL = 2


def _jax_side():
    level = ts.asset_level(JL)
    return level, ts.asset_library(JA, JM), ts.user_textures(JU)


def _port_side():
    level = ts.asset_level(TL)
    return level, ts.asset_library(TA, TM), ts.user_textures(TU)


def _cams():
    """Three cameras that see the placed parts: two on the first
    placement, one between both."""
    a = jcam.orbit_cameras(jnp.asarray([0.5, 2.6], jnp.float32), 0.35,
                           1600.0, target=(2560.0, 900.0, 2560.0))
    b = jcam.orbit_cameras(jnp.asarray([4.0], jnp.float32), 0.3, 2600.0,
                           target=(4100.0, 800.0, 3100.0))
    return jax.tree_util.tree_map(lambda x, y: jnp.concatenate([x, y]), a, b)


@pytest.fixture(scope="module")
def refs():
    """Every JAX reference of the module, computed once."""
    out = {}
    level, lib, utex = _jax_side()
    lights = jscene.collect_scene_lights(level, lib)
    jflat, jstatic = jsf.compile_level_flat(
        level, ts.textures(), ts.resolver, light_specs=lights,
        asset_library=lib, user_textures=utex)
    out["lights"] = lights
    out["flat"], out["static"] = _np(jflat), jstatic
    cams = _cams()
    out["cams"] = _np(cams)
    out["frame"] = _jax_render(jflat, jstatic, cams, JRS.game(), H, W)
    # the lit Cave-size level
    lflat, lstatic = jsf.compile_level_flat(ts.cave_size_level(JL),
                                            ts.textures(), ts.resolver,
                                            light_specs=LIGHT_SPECS)
    assert lstatic.sh_mode is None
    lcams = jcam.orbit_cameras(jnp.asarray([0.3, 2.1], jnp.float32), 0.3,
                               3500.0, target=(4096.0, 1200.0, 4096.0))
    out["lit_cams"] = _np(lcams)
    out["lit"] = _jax_render(lflat, lstatic, lcams, JRS.game(), H, W)
    # one frame of rollout.step_and_render on the asset level
    env = jrollout.build_env(level, ts.textures(), ts.resolver,
                             light_specs=lights, asset_library=lib,
                             user_textures=utex, flat=True)
    states = jrollout.initial_states(level, ts.spawn_point(level), N_ROLL)
    acts = ts.actions_np(np.random.default_rng(17), N_ROLL)
    _, fb = jrollout.step_and_render(
        states, env, jstep.Actions(**{k: jnp.asarray(v)
                                      for k, v in acts.items()}),
        JRS.game(), height=48, width=64, instance_chunk=None)
    out["rollout"] = (_np(states), acts, np.asarray(fb.color))
    return out


@pytest.fixture(scope="module")
def port():
    level, lib, utex = _port_side()
    lights = tscene.collect_scene_lights(level, lib)
    flat, static = tsf.compile_level_flat(
        level, ts.textures(), ts.resolver, light_specs=lights,
        asset_library=lib, user_textures=utex, device="cpu")
    return level, lib, utex, lights, flat, static


def test_collect_scene_lights_matches_jax(refs, port):
    lights = port[3]
    assert lights == refs["lights"]
    assert len(lights) == 2 and all(s["kind"] == "point" for s in lights)
    # an override replaces what it names
    level, lib, _ = _port_side()
    jlevel, jlib, _ = _jax_side()
    for lv, mod in ((level, TL), (jlevel, JL)):
        lv.rooms[0].objects[1].light_override = mod.LightOverride(
            color=(10, 20, 30), intensity=None, radius=99.0, offset=None)
    ours = tscene.collect_scene_lights(level, lib)
    assert ours == jscene.collect_scene_lights(jlevel, jlib)
    assert ours[1]["color"] == (10, 20, 30) and ours[1]["radius"] == 99.0
    assert tscene.collect_scene_lights(level, None) == []


@pytest.mark.parametrize("facing, pos", [(0.0, (0.0, 0.0, 0.0)),
                                         (0.0, (2560.0, 700.5, 2560.0)),
                                         (0.7, (5632.0, 830.25, 3584.0)),
                                         (-2.9, (-10.0, 0.0, 3.0))])
def test_transform_part_vertices_matches_jax(facing, pos):
    part = ts.asset_library(TA, TM).get_by_id(ts.ASSET_ID).mesh()[0]
    verts, _ = part.mesh.to_render_data_textured()
    ours = tscene.transform_part_vertices(verts, facing, pos)
    assert ours == jscene.transform_part_vertices(verts, facing, pos)
    assert (ours is verts) == (facing == 0.0 and not any(pos))


def test_resolve_part_texture15_matches_jax():
    tparts = ts.asset_library(TA, TM).get_by_id(ts.ASSET_ID).mesh()
    jparts = ts.asset_library(JA, JM).get_by_id(ts.ASSET_ID).mesh()
    tut, jut = ts.user_textures(TU), ts.user_textures(JU)
    cases = [(tparts[0], jparts[0], tut, jut),       # embedded atlas
             (tparts[1], jparts[1], tut, jut),       # user texture by id
             (tparts[1], jparts[1], None, None),     # no library: default
             (TM.MeshPart(), JM.MeshPart(), tut, jut)]   # checkerboard
    shapes = []
    for tp, jp, tu, ju in cases:
        ours = tscene.resolve_part_texture15(tp, tu)
        theirs = jscene.resolve_part_texture15(jp, ju)
        assert ours.dtype == theirs.dtype == np.uint16
        np.testing.assert_array_equal(ours, theirs)
        shapes.append(ours.shape)
    assert shapes == [(16, 16), (32, 32), (128, 128), (128, 128)]
    assert (tscene.resolve_part_texture15(tparts[1], tut) == 0).any()


@pytest.mark.parametrize("path", _FLAT_FIELDS)
def test_asset_level_tables_match_jax(refs, port, path):
    flat = port[4]
    ours, theirs = _field(flat, path), _field(refs["flat"], path)
    assert ours.dtype == theirs.dtype, (ours.dtype, theirs.dtype)
    np.testing.assert_array_equal(ours, theirs)


def test_asset_level_static_matches_jax(refs, port):
    static, jstatic = port[5], refs["static"]
    for f in dataclasses.fields(static):
        assert getattr(static, f.name) == getattr(jstatic, f.name), f.name
    room_faces = tsf.compile_level_flat(
        ts.cave_size_level(TL), ts.textures(), ts.resolver,
        device="cpu")[1].n_faces
    # two placements x (12 cube + 2 quad triangles), five draw groups
    assert static.n_faces == room_faces + 2 * (12 + 2)
    assert static.n_draw_groups == 5 and static.n_textures == 4 + 4
    ds = port[4].faces.double_sided
    assert int(ds.sum()) == 4 and not bool(ds[:room_faces].any())


def test_asset_level_frame_matches_jax(refs, port):
    flat, static = port[4], port[5]
    cams = interop.camera_arrays(refs["cams"])
    out = tsf.render_level_flat(flat, static, cams, RasterSettings.game(),
                                H, W, background=CLEAR)
    jcolor, jdepth = refs["frame"]
    diff = int((out.color.numpy() != jcolor).sum())
    assert diff <= _budget(jcolor.size, 3), diff
    ddiff = int((~np.isclose(out.depth.numpy(), jdepth, rtol=1e-6,
                             atol=0)).sum())
    assert ddiff <= _budget(jcolor.size, 3), ddiff
    # the placed parts draw: the level without them differs widely
    bare, bstatic = tsf.compile_level_flat(
        ts.cave_size_level(TL), ts.textures(), ts.resolver,
        light_specs=port[3], device="cpu")
    plain = tsf.render_level_flat(bare, bstatic, cams, RasterSettings.game(),
                                  H, W, background=CLEAR)
    assert int((plain.color != out.color).sum()) > 2000


def test_asset_rollout_matches_jax(refs, port):
    level, lib, utex, lights = port[:4]
    env = trollout.build_env(level, ts.textures(), ts.resolver,
                             light_specs=lights, asset_library=lib,
                             user_textures=utex, device="cpu")
    assert env.flat_static.n_draw_groups == 5
    jstates, acts, jcolor = refs["rollout"]
    _, fb = trollout.step_and_render(
        interop.game_state(jstates), env,
        tstep.Actions(**{k: torch.from_numpy(v) for k, v in acts.items()}),
        RasterSettings.game(), height=48, width=64)
    diff = int((fb.color.numpy() != jcolor).sum())
    assert diff <= _budget(jcolor.size, N_ROLL), diff
    # the editor's backface wires over the level's five draw groups are
    # the sequential renderer's: the kernel route refuses them and
    # step_and_render takes the sequential route (held against the JAX
    # package in tests/test_torch_rollout_refused.py)
    editor = RasterSettings()
    assert not trollout.kernel_route(env, editor)
    with pytest.raises(NotImplementedError):
        tsf.check_slice(env.flat_static, editor)
    _, efb = trollout.step_and_render(
        interop.game_state(jstates), env,
        tstep.Actions(**{k: torch.from_numpy(v) for k, v in acts.items()}),
        editor, height=48, width=64)
    assert bool((efb.color == wf._pack_rgb(wf.BACKFACE_COLOR)).any())


def test_point_and_spot_lights_level_matches_jax(refs):
    flat, static = tsf.compile_level_flat(ts.cave_size_level(TL),
                                          ts.textures(), ts.resolver,
                                          light_specs=LIGHT_SPECS,
                                          device="cpu")
    cams = interop.camera_arrays(refs["lit_cams"])
    out = tsf.render_level_flat(flat, static, cams, RasterSettings.game(),
                                H, W, background=CLEAR)
    jcolor, jdepth = refs["lit"]
    assert ((jcolor >> 24) & 255 == 255).mean() > 0.5
    diff = int((out.color.numpy() != jcolor).sum())
    assert diff <= _budget(jcolor.size, 2), diff
    # the lights shade the level: unlit, the same frame differs widely
    unlit = tsf.render_level_flat(
        tsf.compile_level_flat(ts.cave_size_level(TL), ts.textures(),
                               ts.resolver, device="cpu")[0],
        static, cams, RasterSettings.game(), H, W, background=CLEAR)
    assert int((unlit.color != out.color).sum()) > out.color.numel() // 4
