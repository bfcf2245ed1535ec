"""Headless batched rollout: fused game step + third-person render
(bonnie32_tpu/rollout.py).

`step_and_render` ticks every instance, updates its character camera and
renders its view (`render_cameras`) by one of two routes, chosen from the
settings and the level's static facts before any launch:

  * the kernel route, models/scene_flat.render_level_flat — for CUDA
    tensors the visibility, resolve, composite and sky kernels of
    csrc/raster.cu, routed by the settings (z-buffer, painter's, x-ray,
    affine or perspective-correct UVs, the editor's wireframes), the
    level's transparent faces and placed assets, and its skybox
    (ops/skybox.py: the in-kernel sky where `sky_kernel_ok` allows it,
    else the sky-buffer route);
  * the sequential renderer, models/scene.render_level over the level's
    CompiledScene, instance_chunk instances at a time, on a frame cleared
    to inverse z and the sky's plane where the level has one (the JAX
    package's `render_one`) — where the env has no flat scene
    (`build_env(flat=False)`) or the kernels cannot draw the settings
    (scene_flat.kernel_route_ok: ortho projection, backface wires over
    several draw groups, transparent faces outside the last draw group).

Any frame size runs.  On the card everything runs on the card; on the CPU
only where the caller built the env with device="cpu".

`demo_env` builds the JAX package's demo: the Cave sample level and every
sample texture pack, read from the reference's asset tree (absent files
raise FileNotFoundError).
"""

from typing import NamedTuple

from .config import HEIGHT, WIDTH, RasterSettings
from .game import collision as col
from .game import state as st
from .game import step as stp
from .models import scene as scene_mod
from .models import scene_flat
from .models.skybox import Skybox
from .ops import raster_ref
from .ops import skybox as sky_ops
from .batch import INSTANCE_CHUNK, in_chunks
from .types import CameraArrays, resolve_device

# the JAX package's demo assets (rollout.demo_env)
SAMPLES = "/root/reference/assets/samples"
DEMO_LEVEL = f"{SAMPLES}/levels/Cave.ron"
DEMO_PACKS = f"{SAMPLES}/texture-packs"


class RolloutEnv(NamedTuple):
    grid: col.CollisionGrid
    params: col.PlayerParams
    flat: object            # scene_flat.FlatScene, or None (flat=False)
    flat_static: object     # scene_flat.FlatSceneStatic, or None
    sky: object = None      # ops.skybox.SkyTables, or None (no skybox)
    scene: object = None    # models.scene.CompiledScene (the sequential
    #                         renderer's)


def build_env(level, textures, resolve, light_specs=None,
              asset_library=None, user_textures=None, flat: bool = True,
              device=None) -> RolloutEnv:
    """Compile `level` on `device` (default: the card; the tests pass
    device="cpu"): always for the sequential renderer
    (models.scene.compile_level), as the JAX package does, and with
    `flat` (the default; the JAX package's default is False) for the
    kernel route too (scene_flat.compile_level_flat).  With an
    `asset_library`, its placed objects draw after the rooms.
    `light_specs` are the caller's, as in the JAX package: placed Light
    components add none by themselves (models.scene.collect_scene_lights
    lists them)."""
    device = resolve_device(device)
    sky_cfg = Skybox.from_ron(level.skybox) if level.skybox else None
    sky = (sky_ops.build_sky_tables(sky_cfg, device=device) if sky_cfg
           else None)
    fscene = fstatic = None
    if flat:
        fscene, fstatic = scene_flat.compile_level_flat(
            level, textures, resolve, light_specs=light_specs,
            asset_library=asset_library, user_textures=user_textures,
            device=device)
    return RolloutEnv(
        grid=col.compile_collision(level, device=device),
        params=col.player_params(level, device=device),
        flat=fscene, flat_static=fstatic, sky=sky,
        scene=scene_mod.compile_level(
            level, textures, resolve, light_specs=light_specs,
            asset_library=asset_library, user_textures=user_textures,
            device=device))


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
                    dt: float = 1.0 / 60.0,
                    instance_chunk: int = INSTANCE_CHUNK):
    """One batched frame: tick, character camera, render (`render_cameras`:
    the kernel route or the sequential renderer, instance_chunk instances
    a call).  Returns (new_states, FrameBuffers (I, H, W))."""
    if not isinstance(env, RolloutEnv):
        raise NotImplementedError("only rollout.RolloutEnv is ported")
    states = stp.tick(states, env.grid, env.params, actions, dt)
    cams = stp.character_camera(states, env.params)
    return states, render_cameras(env, cams, settings, height, width,
                                  instance_chunk)


def kernel_route(env: RolloutEnv, settings: RasterSettings) -> bool:
    """Whether `render_cameras` takes the kernel route: the env has a flat
    scene and its kernels can draw the settings."""
    return (env.flat is not None
            and scene_flat.kernel_route_ok(env.flat_static, settings))


def render_cameras(env: RolloutEnv, cams, settings: RasterSettings,
                   height: int = HEIGHT, width: int = WIDTH,
                   instance_chunk: int = INSTANCE_CHUNK):
    """The frames of `cams` ((I,) CameraArrays) in the env's level, over
    its sky if it has one: the render half of `step_and_render`.  On the
    kernel route, under `wireframe_overlay` no sky is drawn, as on the JAX
    kernel path; the sequential renderer draws the sky under the overlay,
    as the JAX package's does."""
    if not kernel_route(env, settings):
        return render_sequential(env, cams, settings, height, width,
                                 instance_chunk)
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


def render_sequential(env: RolloutEnv, cams, settings: RasterSettings,
                      height: int = HEIGHT, width: int = WIDTH,
                      instance_chunk: int = INSTANCE_CHUNK):
    """The sequential renderer's frames (the JAX package's `render_one`):
    a frame cleared to inverse z, the sky's plane and stars where the
    level has a sky (ops.skybox.render_skybox: `raster_sky` on the card),
    then models.scene.render_level in "fast" depth mode, instance_chunk
    instances a call (None: all at once)."""
    if env.scene is None:
        raise ValueError("the env holds no CompiledScene for the "
                         "sequential renderer")

    def render(sl):
        sub = CameraArrays(cams.position[sl], cams.basis[sl])
        if env.sky is not None:
            fb = sky_ops.render_skybox(env.sky, sub, height, width)
        else:
            fb = raster_ref.new_framebuffer(height, width, depth_mode="inv",
                                            n=sub.position.shape[0],
                                            device=sub.position.device)
        return scene_mod.render_level(fb, env.scene, sub, settings,
                                      depth_mode="fast")

    return in_chunks(cams.position.shape[0], instance_chunk, render)


def spawn_point(level):
    """The demo's spawn: the centre of the first room's first sector with
    a floor, 10 units above that floor."""
    r0 = level.rooms[0]
    for x, z, s in r0.iter_sectors():
        if s.floor is not None:
            px = float(r0.position[0]) + (x + 0.5) * 1024.0
            pz = float(r0.position[2]) + (z + 0.5) * 1024.0
            fi = level.get_floor_info((px, 0.0, pz))
            return (px, fi.floor + 10.0, pz)
    return None


def demo_env(level_path=DEMO_LEVEL, flat: bool = False, device=None,
             packs_root=DEMO_PACKS):
    """The level at `level_path` with every texture pack under
    `packs_root` (sorted pack directories, each a folder of PNGs), built
    on `device` (default: the card): (level, env, spawn).  `flat`
    compiles the kernel route too."""
    from .models import level as L
    from .models import texture_pack as tp

    level = L.load_level(level_path)
    textures = tp.load_texture_packs(packs_root)
    env = build_env(level, textures, tp.make_resolver(textures), flat=flat,
                    device=device)
    return level, env, spawn_point(level)
