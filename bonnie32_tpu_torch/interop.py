"""Carry the JAX package's structures across into the port's tensors.

Every function takes the JAX NamedTuple with its leaves already converted
to numpy (`jax.tree_util.tree_map(np.asarray, x)`; this module never
imports jax) and returns the port's counterpart on `device`.  Tests use it
to feed both implementations the same state, scene and prep.
"""

import numpy as np
import torch

from .game.collision import CollisionGrid, PlayerParams
from .game.state import GameState
from .models.scene_flat import FlatScene, FogFaces
from .ops import raster_batch as rb
from .types import (CameraArrays, FaceArrays, Lights, MeshArrays, Surfaces,
                    TextureAtlas)


def _t(a, device):
    return torch.from_numpy(np.array(a)).to(device)


def _same_fields(cls, src, device):
    return cls(**{f: _t(getattr(src, f), device) for f in cls._fields})


def game_state(src, device="cpu") -> GameState:
    return _same_fields(GameState, src, device)


def player_params(src, device="cpu") -> PlayerParams:
    return _same_fields(PlayerParams, src, device)


def collision_grid(src, device="cpu") -> CollisionGrid:
    """The packed hot-path tables; the JAX grid's unpacked per-field
    tables are for its editor and are not carried."""
    return CollisionGrid(room_pos=_t(src.room_pos, device),
                         bounds_min=_t(src.bounds_min, device),
                         bounds_max=_t(src.bounds_max, device),
                         sector_tab=_t(src.sector_tab, device),
                         room_tab=_t(src.room_tab, device),
                         n_gx=int(src.has_sector.shape[1]),
                         n_gz=int(src.has_sector.shape[2]))


def camera_arrays(src, device="cpu") -> CameraArrays:
    return _same_fields(CameraArrays, src, device)


def surfaces(src, device="cpu") -> Surfaces:
    return _same_fields(Surfaces, src, device)


def flat_scene(src, device="cpu") -> FlatScene:
    """FlatScene without the TPU kernel tables (texel planes, key rows,
    packed encodings, metadata rows) and atlas bit planes."""
    return FlatScene(
        mesh=_same_fields(MeshArrays, src.mesh, device),
        faces=_same_fields(FaceArrays, src.faces, device),
        fog=_same_fields(FogFaces, src.fog, device),
        ambient=_t(src.ambient, device),
        lights=_same_fields(Lights, src.lights, device),
        atlas=_same_fields(TextureAtlas, src.atlas, device),
        **{f: _t(getattr(src, f), device) for f in FlatScene._fields[6:]})


def batch_prep(src, n_faces: int, device="cpu") -> rb.BatchPrep:
    """The JAX single-segment BatchPrep (batched over instances) in the
    port's layout.  JAX keeps ctrl/fscal column-major in original face
    order with the compacted order in column K_ORDER, and the resolve
    table attrsT in DRAW order; the port keeps everything (I, T, cols) in
    original order with a separate order column."""
    k_count, k_order, k_tid, k_key = 10, 11, 8, 9     # JAX ctrl columns
    ctrl = np.asarray(src.ctrl)                         # (I, 16, Tp)
    n = ctrl.shape[0]
    t = n_faces
    order = ctrl[:, k_order, :t].astype(np.int32)
    attrs_draw = np.asarray(src.attrsT).reshape(n, rb.N_COLS, -1)
    attrs = np.empty((n, t, rb.N_COLS), np.float32)
    for i in range(n):
        attrs[i, order[i]] = attrs_draw[i, :, :t].T
    port_ctrl = np.zeros((n, t, rb.N_CTRL), np.int32)
    port_ctrl[..., :4] = ctrl[:, :4, :t].transpose(0, 2, 1)
    port_ctrl[..., rb.K_TID] = ctrl[:, k_tid, :t]
    port_ctrl[..., rb.K_KEY] = ctrl[:, k_key, :t]
    return rb.BatchPrep(
        count=_t(ctrl[:, k_count, 0].astype(np.int32), device),
        order=_t(order, device), ctrl=_t(port_ctrl, device),
        attrs=_t(attrs, device))
