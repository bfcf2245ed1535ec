"""Perspective-correct UVs under the in-kernel sky: `rollout.step_and_render`
with `game(affine_textures=False)` on the open-air level under the night
sky (tests/torch_scenes.py), the port vs the JAX package.  Both take the
in-kernel route: visibility, then resolve with the sky behind the faces
(the port's sky-fused `raster_resolve` in its perspective instantiation),
then the stars on the pixels still at depth 0.

One frame from the same states and numpy-seeded actions at N=2, 120x160
(JAX: the Pallas kernel in interpret mode, which takes minutes to compile
the sky alone: this file holds nothing else).  The port renders the JAX
package's cameras, within `assert_sky_frame`'s budgets
(test_torch_sky_kernel.py: one 8-bit step on sky pixels, the seam budget
beyond), and free-running within 1% of the pixels, as
test_torch_sky_rollout.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import torch_scenes as ts
from bonnie32_tpu import rollout as jrollout
from bonnie32_tpu.config import RasterSettings as JRS
from bonnie32_tpu.game import step as jstep
from bonnie32_tpu.models import level as JL
from bonnie32_tpu.models import skybox as JS
from bonnie32_tpu.ops import skybox as jsky
from bonnie32_tpu_torch import interop
from bonnie32_tpu_torch import rollout as trollout
from bonnie32_tpu_torch.config import RasterSettings
from bonnie32_tpu_torch.game import step as tstep
from bonnie32_tpu_torch.models import level as TL
from bonnie32_tpu_torch.models import skybox as TS
from bonnie32_tpu_torch.ops import skybox as tsky
from test_torch_sky_kernel import assert_sky_frame

torch.set_num_threads(1)

N, H, W = 2, 120, 160
_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731


def test_perspective_night_sky_matches_jax():
    jlevel = ts.open_air_level(JL, JS, "night")
    tlevel = ts.open_air_level(TL, TS, "night")
    jenv = jrollout.build_env(jlevel, ts.textures(), ts.resolver, flat=True)
    tenv = trollout.build_env(tlevel, ts.textures(), ts.resolver,
                              device="cpu")
    jsettings = JRS.game(affine_textures=False)
    settings = RasterSettings.game(affine_textures=False)
    assert jsky.sky_kernel_ok(jenv.sky, jenv.flat_static, jsettings)
    assert tsky.sky_kernel_ok(tenv.sky, tenv.flat_static, settings)
    jstates = jrollout.initial_states(jlevel, ts.spawn_point(jlevel), N)
    tstates = interop.game_state(_np(jstates))
    acts = ts.actions_np(np.random.default_rng(31), N)
    jstates, jfb = jrollout.step_and_render(
        jstates, jenv, jstep.Actions(**{k: jnp.asarray(v)
                                        for k, v in acts.items()}),
        jsettings, height=H, width=W, instance_chunk=None)
    tstates, tfb = trollout.step_and_render(
        tstates, tenv, tstep.Actions(**{k: torch.from_numpy(v)
                                        for k, v in acts.items()}),
        settings, height=H, width=W)
    jcolor, jdepth = np.asarray(jfb.color), np.asarray(jfb.depth)
    # the sky shows, and faces draw over it
    assert 0.2 < (jdepth == 0).mean() < 0.9
    jcams = _np(jax.vmap(lambda s: jstep.character_camera(
        s, jenv.params))(jstates))
    ours = trollout.render_cameras(tenv, interop.camera_arrays(jcams),
                                   settings, H, W)
    assert_sky_frame("perspective, night sky", (ours.color, ours.depth),
                     (jcolor, jdepth))
    free = int((tfb.color.numpy() != jcolor).sum())
    assert free <= jcolor.size // 100, free
    affine = trollout.render_cameras(
        tenv, interop.camera_arrays(jcams), RasterSettings.game(), H, W)
    assert int((affine.color != ours.color).sum()) > 200
