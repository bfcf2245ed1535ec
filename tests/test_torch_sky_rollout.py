"""`rollout.step_and_render` on levels with a skybox, the port vs the JAX
package, over both sky routes (tests/torch_scenes.py's open-air levels):

  * kernel: the open-air level under the night sky, `game()` settings —
    the in-kernel sky, then the stars on pixels still at depth 0;
  * buffer: its transparent variant under the same sky — stars with
    transparent faces send both packages down the sky-buffer route (the
    whole sky plane with its stars first, the rasterizer over it, the
    composite last);
  * xray: x-ray over the two-range sunset sky (the composite of every
    face starts from the sky plane);
  * painters: painter's mode on the transparent level under that sky.

Both sides start from the same states and take the same numpy-seeded
actions for two frames at N=2, 120x160 (JAX: the Pallas kernel in
interpret mode).  The second frame is compared twice: the port rendering
the JAX package's cameras, within `assert_sky_frame`'s budgets
(test_torch_sky_kernel.py: one step on sky pixels, the seam budget
beyond), and free-running (each side its own cameras) within 1% of the
pixels, as test_torch_rollout.py.
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
from bonnie32_tpu.models import skybox as JS
from bonnie32_tpu.ops import skybox as jsky
from bonnie32_tpu_torch import interop
from bonnie32_tpu_torch import rollout as trollout
from bonnie32_tpu_torch.game import step as tstep
from bonnie32_tpu_torch.models import level as TL
from bonnie32_tpu_torch.models import skybox as TS
from bonnie32_tpu_torch.ops import skybox as tsky
from test_torch_sky_kernel import assert_sky_frame

torch.set_num_threads(1)

N, H, W, FRAMES = 2, 120, 160, 2
_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731

# case -> (level function, textures, sky, settings, in-kernel route?)
CASES = {
    "kernel": (ts.open_air_level, ts.textures, "night",
               RasterSettings.game(), True),
    "buffer": (ts.transparent_open_air_level, ts.transparent_textures,
               "night", RasterSettings.game(), False),
    "xray": (ts.open_air_level, ts.textures, "sunset",
             RasterSettings.game(xray_mode=True), False),
    "painters": (ts.transparent_open_air_level, ts.transparent_textures,
                 "sunset", RasterSettings.game(use_zbuffer=False), False),
}


def _run(case):
    build, textures, sky, settings, in_kernel = CASES[case]
    jlevel, tlevel = build(JL, JS, sky), build(TL, TS, sky)
    jenv = jrollout.build_env(jlevel, textures(), ts.resolver, flat=True)
    tenv = trollout.build_env(tlevel, textures(), ts.resolver, device="cpu")
    assert jsky.sky_kernel_ok(jenv.sky, jenv.flat_static,
                              settings) is in_kernel
    assert tsky.sky_kernel_ok(tenv.sky, tenv.flat_static,
                              settings) is in_kernel
    jstates = jrollout.initial_states(jlevel, ts.spawn_point(jlevel), N)
    tstates = interop.game_state(_np(jstates))
    rng = np.random.default_rng(21)
    for _ in range(FRAMES):
        acts = ts.actions_np(rng, N)
        jstates, jfb = jrollout.step_and_render(
            jstates, jenv, jstep.Actions(**{k: jnp.asarray(v)
                                            for k, v in acts.items()}),
            settings, height=H, width=W, instance_chunk=None)
        tstates, tfb = trollout.step_and_render(
            tstates, tenv, tstep.Actions(**{k: torch.from_numpy(v)
                                            for k, v in acts.items()}),
            settings, height=H, width=W)
    jcams = jax.vmap(lambda s: jstep.character_camera(s, jenv.params))(
        jstates)
    return dict(tenv=tenv, settings=settings, jfb=_np(jfb), tfb=tfb,
                jcams=_np(jcams))


@pytest.fixture(scope="module")
def runs():
    """Two frames of every case on both sides, computed once."""
    return {case: _run(case) for case in CASES}


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_renders_jax_cameras_over_the_sky(runs, case):
    r = runs[case]
    settings = r["settings"]
    cleared = settings.xray_mode or not settings.use_zbuffer
    out = trollout.render_cameras(r["tenv"], interop.camera_arrays(
        r["jcams"]), settings, H, W)
    jcolor, jdepth = r["jfb"].color, r["jfb"].depth
    assert (((jcolor >> 24) & 255) == 255).all(), "the sky fills the frame"
    if not cleared:
        assert 0.3 < (jdepth == 0).mean() < 0.9, "sky and level in view"
    assert_sky_frame(case, (out.color, out.depth), (jcolor, jdepth),
                     cleared_depth=cleared)


@pytest.mark.parametrize("case", sorted(CASES))
def test_free_running_sky_frames_within_one_percent(runs, case):
    r = runs[case]
    tcolor = r["tfb"].color.numpy()
    jcolor = r["jfb"].color
    assert tcolor.shape == (N, H, W)
    assert not np.array_equal(tcolor[0], tcolor[1])
    diff = int((tcolor != jcolor).sum())
    assert diff <= tcolor.size // 100, f"{diff} of {tcolor.size} differ"


def test_level_without_skybox_has_no_sky():
    env = trollout.build_env(ts.cave_size_level(TL), ts.textures(),
                             ts.resolver, device="cpu")
    assert env.sky is None


def test_xray_differs_from_the_bare_sky(runs):
    """X-ray blends every face onto the sky plane: the frame is neither
    the sky nor a frame over a constant background."""
    r = runs["xray"]
    cams = interop.camera_arrays(r["jcams"])
    sky = tsky.render_skybox(r["tenv"].sky, cams, H, W).color
    out = trollout.render_cameras(r["tenv"], cams, r["settings"], H, W)
    changed = (out.color != sky).float().mean()
    assert 0.05 < float(changed) < 0.95
