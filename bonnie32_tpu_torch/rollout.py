"""Headless batched rollout: fused game step + third-person render
(bonnie32_tpu/rollout.py), on the flat kernel path only.

`step_and_render` ticks every instance, updates its character camera and
renders its view through models/scene_flat.render_level_flat — for CUDA
tensors the visibility and resolve kernels of csrc/raster.cu.  The
sequential per-instance renderer of the JAX package, skyboxes and every
other non-slice configuration are not ported and raise.
"""

from typing import NamedTuple

from ._host.config import HEIGHT, WIDTH, RasterSettings
from .game import collision as col
from .game import state as st
from .game import step as stp
from .models import scene_flat


class RolloutEnv(NamedTuple):
    grid: col.CollisionGrid
    params: col.PlayerParams
    flat: scene_flat.FlatScene
    flat_static: scene_flat.FlatSceneStatic


def build_env(level, textures, resolve, light_specs=None, flat: bool = True,
              device="cpu") -> RolloutEnv:
    """Compile `level` for the flat kernel path on `device`."""
    if not flat:
        raise NotImplementedError(
            "the sequential (non-flat) renderer is not ported; use flat=True")
    if level.skybox:
        raise NotImplementedError(
            "skyboxes (the kernel's in-kernel sky) are not ported yet "
            "(ROADMAP.md queue 1)")
    fscene, fstatic = scene_flat.compile_level_flat(
        level, textures, resolve, light_specs=light_specs, device=device)
    return RolloutEnv(grid=col.compile_collision(level, device=device),
                      params=col.player_params(level, device=device),
                      flat=fscene, flat_static=fstatic)


def initial_states(level, spawn_pos, n_instances: int, capacity: int = 4,
                   device="cpu") -> st.GameState:
    """N identical instances with a spawned player; `capacity` entity
    slots each (the datagen default pads the one player 4x, as the JAX
    package does)."""
    base = st.new_state(n_instances, capacity, device=device)
    base, _ = st.spawn_player(base, spawn_pos, level.player_settings)
    return base


def step_and_render(states: st.GameState, env: RolloutEnv,
                    actions: stp.Actions, settings: RasterSettings,
                    height: int = HEIGHT, width: int = WIDTH,
                    dt: float = 1.0 / 60.0):
    """One batched frame: tick, character camera, flat render with a
    constant background 0.  Returns (new_states, FrameBuffers (I, H, W))."""
    if not isinstance(env, RolloutEnv):
        raise NotImplementedError("only the flat kernel env is ported")
    if height % 8:
        raise NotImplementedError(
            "the flat kernel path needs height % 8 == 0, as in the JAX "
            "package")
    states = stp.tick(states, env.grid, env.params, actions, dt)
    cams = stp.character_camera(states, env.params)
    fbs = scene_flat.render_level_flat(env.flat, env.flat_static, cams,
                                       settings, height=height, width=width,
                                       background=0)
    return states, fbs

