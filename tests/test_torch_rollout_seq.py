"""The port's sequential route of rollout.step_and_render (models/
scene.render_level over the level's CompiledScene) on the CPU:

  * `build_env(flat=False)` + `step_and_render` against the JAX package's
    (which renders flat=False envs with the same renderer): the port's
    render of the JAX cameras within the seam budget max(64 N,
    pixels / 500), its own free-running frame within 1% of the pixels
    (tests/test_torch_rollout.py's tolerances), states within rtol 1e-5;
  * the kernel route (its plain twins here) and the sequential route
    agree on every pixel on the game settings, on the Cave-size level,
    its transparent variant and the asset level: both are uncontracted
    f32 in the JAX package's order;
  * transparent faces in the first of two draw groups, which the kernels
    cannot draw, through step_and_render against the JAX package's
    sequential renderer (test_torch_rollout_refused.py holds ortho and
    the editor's settings on the asset level);
  * routing: decided by the settings and the level's static facts.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax_refs
import torch_scenes as ts
import torch_seq_cases as sc
from bonnie32_tpu import rollout as jrollout
from bonnie32_tpu.game import step as jstep
from bonnie32_tpu.models import level as JL
from bonnie32_tpu_torch import config
from bonnie32_tpu_torch import interop
from bonnie32_tpu_torch import rollout as trollout
from bonnie32_tpu_torch.config import RasterSettings
from bonnie32_tpu_torch.game import step as tstep
from bonnie32_tpu_torch.models import level as TL

torch.set_num_threads(1)
GAME = RasterSettings.game()


@pytest.fixture(scope="module")
def non_flat():
    """One frame of flat=False envs on both sides (Cave-size level), four
    instances in chunks of two."""
    jlevel, tlevel = ts.cave_size_level(JL), ts.cave_size_level(TL)
    jenv = jrollout.build_env(jlevel, ts.textures(), ts.resolver)
    tenv = trollout.build_env(tlevel, ts.textures(), ts.resolver,
                              flat=False, device="cpu")
    n = 4
    jstates = jrollout.initial_states(jlevel, ts.spawn_point(jlevel), n)
    tstates = interop.game_state(jax.tree_util.tree_map(np.asarray,
                                                        jstates))
    acts = ts.actions_np(np.random.default_rng(11), n)
    jstates, jfb = jrollout.step_and_render(
        jstates, jenv, jstep.Actions(**{k: jnp.asarray(v)
                                        for k, v in acts.items()}),
        jax_refs.jax_settings(GAME), height=sc.H, width=sc.W, instance_chunk=2)
    jcams = jax.vmap(lambda s: jstep.character_camera(s, jenv.params))(
        jstates)
    tstates, tfb = trollout.step_and_render(
        tstates, tenv, tstep.Actions(**{k: torch.from_numpy(v)
                                        for k, v in acts.items()}),
        GAME, height=sc.H, width=sc.W, instance_chunk=2)
    return dict(tenv=tenv, jcolor=np.asarray(jfb.color), tfb=tfb,
                jcams=jax.tree_util.tree_map(np.asarray, jcams),
                jstates=jax.tree_util.tree_map(np.asarray, jstates),
                tstates=tstates)


def test_non_flat_env_has_no_flat_scene(non_flat):
    env = non_flat["tenv"]
    assert env.flat is None and env.flat_static is None
    assert env.scene is not None and not trollout.kernel_route(env, GAME)


def test_non_flat_frame_matches_jax(non_flat):
    jcolor = non_flat["jcolor"]
    ours = trollout.render_cameras(
        non_flat["tenv"], interop.camera_arrays(non_flat["jcams"]), GAME,
        sc.H, sc.W).color.numpy()
    assert sc.lit_share(jcolor) > 0.25
    diff = int((ours != jcolor).sum())
    assert diff <= sc.seam_budget(jcolor), diff
    free = int((non_flat["tfb"].color.numpy() != jcolor).sum())
    assert free <= jcolor.size // 100, free


@pytest.mark.parametrize("field", ["pos", "vel", "facing", "char_cam_yaw",
                                   "char_cam_pitch"])
def test_non_flat_states_match_jax(non_flat, field):
    ours = getattr(non_flat["tstates"], field).numpy()
    theirs = getattr(non_flat["jstates"], field)
    np.testing.assert_allclose(ours, theirs, rtol=1e-5, atol=1e-4)


FLAT_VS_SEQ = {
    "cave": (lambda: ts.cave_size_level(TL), ts.textures, {}),
    "transparent": (lambda: ts.transparent_cave_level(TL),
                    ts.transparent_textures, {}),
    "asset": (None, ts.textures, None),
}


@pytest.mark.parametrize("name", sorted(FLAT_VS_SEQ))
def test_flat_and_sequential_routes_agree(name):
    """Game settings, N=2 at 120x160 after one tick: the kernel route's
    frame equals the sequential renderer's on every pixel."""
    if name == "asset":
        level, tex, kw, _ = sc.level_args("asset")
    else:
        build, textures, kw = FLAT_VS_SEQ[name]
        level, tex = build(), textures()
    env = trollout.build_env(level, tex, ts.resolver, device="cpu", **kw)
    assert trollout.kernel_route(env, GAME)
    states = trollout.initial_states(level, ts.spawn_point(level), 2,
                                     device="cpu")
    acts = ts.actions_np(np.random.default_rng(5), 2)
    states = tstep.tick(states, env.grid, env.params, tstep.Actions(
        **{k: torch.from_numpy(v) for k, v in acts.items()}), 1.0 / 60.0)
    cams = tstep.character_camera(states, env.params)
    flat = trollout.render_cameras(env, cams, GAME, 120, 160)
    seq = trollout.render_sequential(env, cams, GAME, 120, 160)
    assert sc.lit_share(flat.color.numpy()) > 0.5
    assert int((flat.color != seq.color).sum()) == 0
    assert int((flat.depth != seq.depth).sum()) == 0


def test_transparent_first_room_through_step_and_render():
    """Transparent faces outside the last draw group: the port routes
    them to the sequential renderer, as the JAX package does."""
    r = jax_refs.rollout_pair("transparent_first_room", GAME)
    env = r["tenv"]
    assert not env.flat_static.transparent_last
    assert not trollout.kernel_route(env, GAME)
    ours = trollout.render_cameras(env, interop.camera_arrays(r["jcams"]),
                                   GAME, sc.H, sc.W).color.numpy()
    assert sc.lit_share(r["jcolor"]) > 0.25
    diff = int((ours != r["jcolor"]).sum())
    assert diff <= sc.seam_budget(r["jcolor"]), diff
    assert int((r["tcolor"] != r["jcolor"]).sum()) <= r["jcolor"].size // 100


ROUTES = {
    "game": (GAME, "cave", True),
    "ortho": (ts.ortho_settings(config), "cave", False),
    "xray_perspective": (dataclasses.replace(
        GAME, xray_mode=True, affine_textures=False), "cave", True),
    "editor_one_group": (RasterSettings(), "cave", True),
    "editor_asset_level": (RasterSettings(), "asset", False),
    "overlay_asset_level": (RasterSettings(wireframe_overlay=True,
                                           backface_wireframe=False),
                            "asset", True),
    "game_first_room_transparent": (GAME, "transparent_first_room", False),
    "xray_first_room_transparent": (dataclasses.replace(GAME,
                                                        xray_mode=True),
                                    "transparent_first_room", True),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_kernel_route_is_chosen_by_settings_and_level(route):
    settings, name, kernels = ROUTES[route]
    level, tex, kw, _ = sc.level_args(name)
    from bonnie32_tpu_torch.models import scene_flat as tsf
    _, static = tsf.compile_level_flat(level, tex, ts.resolver,
                                       device="cpu", **kw)
    assert tsf.kernel_route_ok(static, settings) == kernels
    if not kernels:
        with pytest.raises(NotImplementedError, match="render_level"):
            tsf.check_slice(static, settings)
