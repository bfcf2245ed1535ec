"""The port's datagen frame vs the JAX package's, end to end.

Both sides start from the same states (carried across by `interop`) and
take the same numpy-seeded actions for three frames of
`rollout.step_and_render` on the flat kernel path (JAX: Pallas interpret
mode on the CPU; port: the plain twins, since the tensors are on the CPU).

Tolerances:
  * states: rtol 1e-5, atol 1e-4 (positions are ~1e3-1e4 units) —
    sin/cos/atan2/asin differ by ulps between XLA:CPU and torch;
  * the port rendering the JAX package's own cameras: the seam budget
    max(64*N, pixels/500), for XLA:CPU's FMA contraction;
  * free-running frames (each side renders its own cameras): <= 1% of the
    pixels — a one-ulp camera difference can move a fixed-point-snapped
    vertex by a whole pixel, so frames drift by silhouette pixels while
    the states stay within the tolerance above.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_scenes as ts
from bonnie32_tpu import rollout as jrollout
from bonnie32_tpu.config import RasterSettings
from bonnie32_tpu.game import step as jstep
from bonnie32_tpu.models import level as JL
from bonnie32_tpu_torch import batch as tbatch
from bonnie32_tpu_torch import interop
from bonnie32_tpu_torch import rollout as trollout
from bonnie32_tpu_torch import types as ttypes
from bonnie32_tpu_torch.models import level as TL
from bonnie32_tpu_torch.game import collision as tcol
from bonnie32_tpu_torch.game import state as tstate
from bonnie32_tpu_torch.game import step as tstep
from bonnie32_tpu_torch.models import scene as tscene
from bonnie32_tpu_torch.models import scene_flat as tsf
from bonnie32_tpu_torch.ops import raster_ref

N, H, W, FRAMES = 3, 48, 64, 3
_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731


@pytest.fixture(scope="module")
def runs():
    """Three frames on both sides from the same start, computed once."""
    settings = RasterSettings.game()
    jlevel = ts.cave_size_level(JL)
    tlevel = ts.cave_size_level(TL)
    jenv = jrollout.build_env(jlevel, ts.textures(), ts.resolver, flat=True)
    tenv = trollout.build_env(tlevel, ts.textures(), ts.resolver,
                             device="cpu")
    jstates = jrollout.initial_states(jlevel, ts.spawn_point(jlevel), N)
    tinit = trollout.initial_states(tlevel, ts.spawn_point(tlevel), N,
                                    device="cpu")
    tstates = interop.game_state(_np(jstates))
    rng = np.random.default_rng(7)
    out = dict(settings=settings, tenv=tenv, tinit=tinit,
               jinit=_np(jstates), frames=[])
    for _ in range(FRAMES):
        acts = ts.actions_np(rng, N)
        jstates, jfb = jrollout.step_and_render(
            jstates, jenv, jstep.Actions(**{k: jnp.asarray(v)
                                            for k, v in acts.items()}),
            settings, height=H, width=W, instance_chunk=None)
        jcams = jax.vmap(lambda s: jstep.character_camera(
            s, jenv.params))(jstates)
        tstates, tfb = trollout.step_and_render(
            tstates, tenv, tstep.Actions(**{k: torch.from_numpy(v)
                                            for k, v in acts.items()}),
            settings, height=H, width=W)
        out["frames"].append(dict(jstates=_np(jstates), jfb=_np(jfb),
                                  jcams=_np(jcams), tstates=tstates,
                                  tfb=tfb))
    return out


def test_initial_states_match(runs):
    for f in tstate.GameState._fields:
        np.testing.assert_array_equal(getattr(runs["tinit"], f).numpy(),
                                      getattr(runs["jinit"], f), err_msg=f)


@pytest.mark.parametrize("field", tstate.GameState._fields)
def test_states_match_after_three_frames(runs, field):
    last = runs["frames"][-1]
    ours = getattr(last["tstates"], field).numpy()
    theirs = getattr(last["jstates"], field)
    assert ours.dtype == theirs.dtype and ours.shape == theirs.shape
    if theirs.dtype.kind in "biu":
        np.testing.assert_array_equal(ours, theirs)
    else:
        np.testing.assert_allclose(ours, theirs, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("frame", range(FRAMES))
def test_port_renders_jax_cameras_within_seam_budget(runs, frame):
    fr = runs["frames"][frame]
    cams = interop.camera_arrays(fr["jcams"])
    env = runs["tenv"]
    out = tsf.render_level_flat(env.flat, env.flat_static, cams,
                                runs["settings"], H, W)
    jcolor = fr["jfb"].color
    budget = max(64 * N, jcolor.size // 500)
    assert ((jcolor >> 24) & 255 == 255).mean() > 0.25
    diff = int((out.color.numpy() != jcolor).sum())
    assert diff <= budget, f"{diff} colour diffs (budget {budget})"
    ddiff = int((~np.isclose(out.depth.numpy(), fr["jfb"].depth,
                             rtol=1e-6, atol=0)).sum())
    assert ddiff <= budget, f"{ddiff} depth diffs (budget {budget})"


ENTRY_POINTS = {
    "build_env": lambda lv: trollout.build_env(lv, ts.textures(),
                                               ts.resolver),
    "initial_states": lambda lv: trollout.initial_states(
        lv, ts.spawn_point(lv), 2),
    "compile_level_flat": lambda lv: tsf.compile_level_flat(
        lv, ts.textures(), ts.resolver),
    "compile_scene_flat": lambda lv: tsf.compile_scene_flat(
        *ts.cube_scene(), [ts.checker_texture15()]),
    "compile_collision": lambda lv: tcol.compile_collision(lv),
    "player_params": lambda lv: tcol.player_params(lv),
    "new_state": lambda lv: tstate.new_state(2, 4),
    "compile_level": lambda lv: tscene.compile_level(lv, ts.textures(),
                                                     ts.resolver),
    "new_framebuffer": lambda lv: raster_ref.new_framebuffer(4, 4),
    "batched_framebuffers": lambda lv: tbatch.batched_framebuffers(2, 4, 4),
    "batched_cameras": lambda lv: tbatch.batched_cameras(
        np.zeros((2, 3)), np.zeros((2, 3, 3))),
    "no_fog": lambda lv: ttypes.no_fog(),
    "empty_lights": lambda lv: ttypes.empty_lights(),
    "default_lights": lambda lv: ttypes.default_lights(),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_default_to_the_card(monkeypatch, name):
    """Without a device argument an entry point runs on the card; with no
    card it raises and never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ENTRY_POINTS[name](ts.cave_size_level(TL))


@pytest.mark.parametrize("frame", range(FRAMES))
def test_free_running_frames_within_one_percent(runs, frame):
    fr = runs["frames"][frame]
    tcolor = fr["tfb"].color.numpy()
    jcolor = fr["jfb"].color
    assert tcolor.shape == (N, H, W)
    cover = ((tcolor >> 24) & 255 == 255).mean(axis=(1, 2))
    assert (cover > 0.25).all(), cover
    assert not np.array_equal(tcolor[0], tcolor[1])
    diff = int((tcolor != jcolor).sum())
    assert diff <= tcolor.size // 100, f"{diff} of {tcolor.size} differ"
