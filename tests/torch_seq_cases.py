"""Levels and cameras of the tests of the port's sequential renderer
(models/scene.compile_level + render_level and the rollout's sequential
route), shared by tests/test_torch_scene_seq*.py,
tests/test_torch_rollout_*.py and chip_smoke.py; tests/jax_refs.py
renders them with the JAX package.  Imports no jax."""

import numpy as np
import torch

import torch_scenes as ts
from bonnie32_tpu_torch import interop
from bonnie32_tpu_torch.models import asset as TA
from bonnie32_tpu_torch.models import level as TL
from bonnie32_tpu_torch.models import mesh as TM
from bonnie32_tpu_torch.models import scene as tscene
from bonnie32_tpu_torch.models import user_texture as TU
from bonnie32_tpu_torch.ops import raster_ref

H, W = 48, 64
# camera poses (position, pitch, yaw), as test_torch_scene.py's: the
# two-room level adds views in its fogged room and one from the first
# room whose fog culls room 1
POSES = {
    "cave": [((512.0, 2000.0, -300.0), 0.25, 0.6),
             ((4096.0, 2400.0, 1500.0), 0.45, 0.2),
             ((6000.0, 1200.0, 6500.0), 0.1, 3.6)],
    "two_room": [((2048.0, 1500.0, 10500.0), 0.15, 0.1),
                 ((3600.0, 2500.0, 14000.0), 0.4, 3.9),
                 ((4096.0, 2000.0, 1000.0), 0.0, 0.0)],
}


def level_args(name, L=TL, A=TA, M=TM, U=TU, S=tscene):
    """(level, textures, compile keywords, poses key) of a test level
    built with the given modules (the JAX package's or the port's)."""
    if name == "cave":
        return ts.cave_size_level(L), ts.textures(), {}, "cave"
    if name == "two_room":
        return ts.two_room_level(L), ts.textures(), {}, "two_room"
    if name == "transparent_first_room":
        return (ts.transparent_first_room_level(L),
                ts.transparent_textures(), {}, "two_room")
    if name == "asset":
        level = ts.asset_level(L)
        lib = ts.asset_library(A, M)
        return level, ts.textures(), dict(
            light_specs=S.collect_scene_lights(level, lib),
            asset_library=lib, user_textures=ts.user_textures(U)), "cave"
    raise ValueError(name)


def port_render_level(tsc, cams_np, settings, clear="inv", **kw):
    cams = interop.camera_arrays(cams_np)
    fb = raster_ref.new_framebuffer(H, W, depth_mode=clear,
                                    n=cams.position.shape[0], device="cpu")
    return tscene.render_level(fb, tsc, cams, settings, **kw).color.numpy()


def seam_budget(frame):
    """max(64 N, pixels / 500): XLA:CPU contracts FMAs, the port does
    not (tests/test_raster_batch.py's _seam_budget)."""
    return max(64 * frame.shape[0], frame.size // 500)


def lit_share(frame):
    return float(((frame >> 24) & 255 == 255).mean())


def field(tree, path):
    for p in path.split("."):
        tree = getattr(tree, p)
    return np.asarray(tree.numpy() if isinstance(tree, torch.Tensor)
                      else tree)


def scene_fields():
    """Every CompiledScene field path the two packages share (the port's
    atlas has no TPU key-bit planes; its 8-bit tables are not ported)."""
    from bonnie32_tpu_torch import types as tt
    paths = []
    for prefix in ("", "a_"):
        paths += [f"{prefix}mesh.{f}" for f in tt.MeshArrays._fields]
        paths += [f"{prefix}faces.{f}" for f in tt.FaceArrays._fields]
        paths += [f"{prefix}atlas.{f}" for f in tt.TextureAtlas._fields]
        paths += [f"{prefix}fog.{f}" for f in tt.Fog._fields]
        paths.append(f"{prefix}ambient")
    return paths + [f"lights.{f}" for f in tt.Lights._fields] + ["a_room"]
