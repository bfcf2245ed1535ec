"""X-ray mode with perspective-correct UVs: the port's composite kernel
vs the JAX package, which hands this configuration to its sequential
renderer (its `kernel_path_ok` is False for it): `scene.render_level`,
room by room, x-ray's 50% blend over every face in draw order
(render.rs:507-526), each pixel's UV divided by its face's own 1/z with
`exact_div`.  On the transparent Cave-size level and on the two-room
level (two draw groups, fog) at 48x64 from the same cameras, and through
`rollout.step_and_render` on the transparent level.

Tolerance: the seam budget max(64*N, pixels/500).  The sequential
renderer builds its surfaces per room (`ops/surface.build_surfaces`,
shading at run time) and XLA:CPU contracts a*b+c into FMAs in both its
surfaces and its pixel loop, so the divided UV of a pixel lands on the
other side of a texel edge along a few lines of pixels (a whole texel's
colour, unlike the one-step seams of the affine path).
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
from bonnie32_tpu.models import level as JL
from bonnie32_tpu.models import scene as jscene
from bonnie32_tpu.models import scene_flat as jsf
from bonnie32_tpu.ops import raster_ref
from bonnie32_tpu_torch import interop
from bonnie32_tpu_torch import rollout as trollout
from bonnie32_tpu_torch.config import RasterSettings
from bonnie32_tpu_torch.game import step as tstep
from bonnie32_tpu_torch.models import level as TL
from bonnie32_tpu_torch.models import scene_flat as tsf
from test_torch_composite import _budget, _np
from test_torch_composite_levels import (CAVE_POSES, TWO_ROOM_POSES,
                                         _level_cams)

torch.set_num_threads(1)

H, W = 48, 64
N_ROLL = 2
LEVELS = {"cave": (ts.transparent_cave_level, ts.transparent_textures,
                   CAVE_POSES),
          "two_room": (ts.two_room_level, ts.textures, TWO_ROOM_POSES)}


@pytest.fixture(scope="module")
def refs():
    """The JAX sequential renders of the module, computed once."""
    settings = JRS.game(xray_mode=True, affine_textures=False)
    out = {}
    for name, (build, textures, poses) in LEVELS.items():
        level = build(JL)
        _, jstatic = jsf.compile_level_flat(level, textures(), ts.resolver)
        assert not jsf.kernel_path_ok(jstatic, settings)
        seq = jscene.compile_level(level, textures(), ts.resolver)
        cams = _level_cams(poses)
        fb0 = raster_ref.new_framebuffer(H, W, depth_mode="inv")
        color = jax.vmap(lambda c: jscene.render_level(
            fb0, seq, c, settings).color)(cams)
        out[name] = (_np(cams), np.asarray(color))
    # one frame of rollout.step_and_render on the transparent level
    level = ts.transparent_cave_level(JL)
    env = jrollout.build_env(level, ts.transparent_textures(), ts.resolver,
                             flat=True)
    states = jrollout.initial_states(level, ts.spawn_point(level), N_ROLL)
    acts = ts.actions_np(np.random.default_rng(9), N_ROLL)
    _, fb = jrollout.step_and_render(
        states, env, jstep.Actions(**{k: jnp.asarray(v)
                                      for k, v in acts.items()}),
        settings, height=H, width=W, instance_chunk=None)
    out["rollout"] = (_np(states), acts, np.asarray(fb.color))
    return out


@pytest.mark.parametrize("level", sorted(LEVELS))
def test_xray_perspective_matches_the_sequential_renderer(refs, level):
    build, textures, _ = LEVELS[level]
    flat, static = tsf.compile_level_flat(build(TL), textures(), ts.resolver,
                                          device="cpu")
    settings = RasterSettings.game(xray_mode=True, affine_textures=False)
    cams, jcolor = refs[level]
    out = tsf.render_level_flat(flat, static, interop.camera_arrays(cams),
                                settings, H, W)
    assert ((jcolor >> 24) & 255 == 255).mean() > 0.5
    diff = int((out.color.numpy() != jcolor).sum())
    assert diff <= _budget(jcolor.size, jcolor.shape[0]), diff
    assert not bool(out.depth.any())
    affine = tsf.render_level_flat(
        flat, static, interop.camera_arrays(cams),
        dataclasses.replace(settings, affine_textures=True), H, W)
    assert int((affine.color != out.color).sum()) > 2 * diff


def test_xray_perspective_rollout_matches_jax(refs):
    jstates, acts, jcolor = refs["rollout"]
    level = ts.transparent_cave_level(TL)
    env = trollout.build_env(level, ts.transparent_textures(), ts.resolver,
                             device="cpu")
    settings = RasterSettings.game(xray_mode=True, affine_textures=False)
    _, fb = trollout.step_and_render(
        interop.game_state(jstates), env,
        tstep.Actions(**{k: torch.from_numpy(v) for k, v in acts.items()}),
        settings, height=H, width=W)
    diff = int((fb.color.numpy() != jcolor).sum())
    assert diff <= _budget(jcolor.size, N_ROLL), diff
