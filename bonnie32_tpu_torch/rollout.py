"""Headless batched rollout: fused game step + third-person render
(bonnie32_tpu/rollout.py), on the flat kernel path only.

`step_and_render` ticks every instance, updates its character camera and
renders its view through models/scene_flat.render_level_flat — for CUDA
tensors the visibility, resolve, composite and sky kernels of
csrc/raster.cu, routed by the settings (z-buffer, painter's, x-ray,
affine or perspective-correct UVs, the editor's wireframes), the level's
transparent faces and placed assets, and its skybox (ops/skybox.py: the
in-kernel sky where `sky_kernel_ok` allows it, else the sky-buffer
route).  Any frame size runs.  The sequential per-instance renderer of
the JAX package, and the configurations only it draws, are not ported
and raise (scene_flat.check_slice).
"""

from typing import NamedTuple

from .config import HEIGHT, WIDTH, RasterSettings
from .game import collision as col
from .game import state as st
from .game import step as stp
from .models import scene_flat
from .models.skybox import Skybox
from .ops import skybox as sky_ops
from .types import resolve_device


class RolloutEnv(NamedTuple):
    grid: col.CollisionGrid
    params: col.PlayerParams
    flat: scene_flat.FlatScene
    flat_static: scene_flat.FlatSceneStatic
    sky: object = None      # ops.skybox.SkyTables, or None (no skybox)


def build_env(level, textures, resolve, light_specs=None,
              asset_library=None, user_textures=None, flat: bool = True,
              device=None) -> RolloutEnv:
    """Compile `level` for the flat kernel path on `device` (default: the
    card; the tests pass device="cpu"); with an `asset_library`, its
    placed objects draw after the rooms (scene_flat.compile_level_flat).
    `light_specs` are the caller's, as in the JAX package: placed Light
    components add none by themselves (models.scene.collect_scene_lights
    lists them)."""
    device = resolve_device(device)
    if not flat:
        raise NotImplementedError(
            "the sequential (non-flat) renderer is not ported; use flat=True")
    sky_cfg = Skybox.from_ron(level.skybox) if level.skybox else None
    sky = (sky_ops.build_sky_tables(sky_cfg, device=device) if sky_cfg
           else None)
    fscene, fstatic = scene_flat.compile_level_flat(
        level, textures, resolve, light_specs=light_specs,
        asset_library=asset_library, user_textures=user_textures,
        device=device)
    return RolloutEnv(grid=col.compile_collision(level, device=device),
                      params=col.player_params(level, device=device),
                      flat=fscene, flat_static=fstatic, sky=sky)


def initial_states(level, spawn_pos, n_instances: int, capacity: int = 4,
                   device=None) -> st.GameState:
    """N identical instances with a spawned player; `capacity` entity
    slots each (the datagen default pads the one player 4x, as the JAX
    package does).  `device` defaults to the card."""
    base = st.new_state(n_instances, capacity, device=device)
    base, _ = st.spawn_player(base, spawn_pos, level.player_settings)
    return base


def step_and_render(states: st.GameState, env: RolloutEnv,
                    actions: stp.Actions, settings: RasterSettings,
                    height: int = HEIGHT, width: int = WIDTH,
                    dt: float = 1.0 / 60.0):
    """One batched frame: tick, character camera, flat render over the
    level's sky (routed as the JAX package routes it) or, without one, a
    constant background 0.  Returns (new_states, FrameBuffers
    (I, H, W))."""
    if not isinstance(env, RolloutEnv):
        raise NotImplementedError("only the flat kernel env is ported")
    states = stp.tick(states, env.grid, env.params, actions, dt)
    cams = stp.character_camera(states, env.params)
    return states, render_cameras(env, cams, settings, height, width)


def render_cameras(env: RolloutEnv, cams, settings: RasterSettings,
                   height: int = HEIGHT, width: int = WIDTH):
    """The frames of `cams` ((I,) CameraArrays) in the env's level, over
    its sky if it has one: the render half of `step_and_render`.  Under
    `wireframe_overlay` no sky is drawn, as on the JAX kernel path (its
    sequential renderer draws the sky under the overlay)."""
    kw = {}
    if env.sky is not None and not settings.wireframe_overlay:
        if sky_ops.sky_kernel_ok(env.sky, env.flat_static, settings):
            # the resolve kernel draws the sky behind the faces; stars
            # land afterwards on the pixels still at depth 0
            kw["sky"] = env.sky
        else:
            # sky-buffer route: the whole sky plane and its stars first,
            # then the rasterizer over it
            kw["fb_color"] = sky_ops.render_skybox(env.sky, cams, height,
                                                   width).color
    return scene_flat.render_level_flat(env.flat, env.flat_static, cams,
                                        settings, height=height, width=width,
                                        **kw)
