"""Carry the JAX package's structures across into the port's tensors.

Every function takes the JAX NamedTuple with its leaves already converted
to numpy (`jax.tree_util.tree_map(np.asarray, x)`; this module never
imports jax) and returns the port's counterpart on `device`.  Tests use it
to feed both implementations the same state, scene and prep.
"""

import numpy as np
import torch

from .audio import resampler as rsp
from .audio import reverb as rvb
from .game import events as ev
from .game.collision import CollisionGrid, PlayerParams
from .game.state import GameState
from .models.scene import CompiledScene
from .models.scene_flat import FlatScene, FogFaces
from .ops import raster_batch as rb
from .ops import skybox as sky_ops
from .types import (CameraArrays, FaceArrays, Fog, Lights, MeshArrays,
                    Surfaces, TextureAtlas, TextureAtlas8)


def _t(a, device):
    return torch.from_numpy(np.array(a)).to(device)


def _same_fields(cls, src, device):
    return cls(**{f: _t(getattr(src, f), device) for f in cls._fields})


def game_state(src, device="cpu") -> GameState:
    return _same_fields(GameState, src, device)


def stacked_game_state(src, n: int, device="cpu") -> GameState:
    """A single-instance JAX GameState repeated to `n` instances."""
    return GameState(**{
        f: _t(np.repeat(np.asarray(getattr(src, f))[None], n, 0), device)
        for f in GameState._fields})


def event_queue(src, device="cpu") -> ev.EventQueue:
    """A JAX EventQueue batched over instances (vmapped: count (I,),
    lanes (I, C)) -> the port's."""
    return _same_fields(ev.EventQueue, src, device)


def events(src, device="cpu") -> ev.Events:
    return ev.Events(*(event_queue(q, device) for q in src))


def texture_atlas8(src, device="cpu") -> TextureAtlas8:
    return _same_fields(TextureAtlas8, src, device)


def compiled_scene(src, device="cpu") -> CompiledScene:
    """A JAX CompiledScene (the per-room sequential renderer's), with its
    8-bit tables where it was compiled with them, without the atlas's
    TPU key-bit planes.  `a_count` is the number of draws, or 0 where
    no draw has a face (the JAX scene's one dummy draw of a level without
    assets)."""
    def atlas(a):
        return _same_fields(TextureAtlas, a, device)

    a_valid = np.asarray(src.a_faces.valid).any(axis=1)
    eight = src.atlas8 is not None
    return CompiledScene(
        mesh=_same_fields(MeshArrays, src.mesh, device),
        faces=_same_fields(FaceArrays, src.faces, device),
        atlas=atlas(src.atlas), fog=_same_fields(Fog, src.fog, device),
        ambient=_t(src.ambient, device),
        lights=_same_fields(Lights, src.lights, device),
        a_mesh=_same_fields(MeshArrays, src.a_mesh, device),
        a_faces=_same_fields(FaceArrays, src.a_faces, device),
        a_atlas=atlas(src.a_atlas),
        a_fog=_same_fields(Fog, src.a_fog, device),
        a_ambient=_t(src.a_ambient, device),
        a_room=_t(src.a_room, device),
        a_count=len(a_valid) if a_valid.any() else 0,
        atlas8=texture_atlas8(src.atlas8, device) if eight else None,
        tex_map=_t(src.tex_map, device) if eight else None,
        a_atlas8=texture_atlas8(src.a_atlas8, device) if eight else None)


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


def trans_prep(src, n_entries: int, device="cpu") -> rb.TransPrep:
    """The JAX TransPrep (batched over instances: (I, 8, NTp) i32 and
    (I, 12, NTp) f32, padded to a multiple of 8 entries) in the port's
    (I, NT, cols) layout, without the padding."""
    tctrl = np.asarray(src.tctrl)[:, :, :n_entries].transpose(0, 2, 1)
    tfscal = np.asarray(src.tfscal)[:, :, :n_entries].transpose(0, 2, 1)
    return rb.TransPrep(tctrl=_t(tctrl.astype(np.int32), device),
                        tfscal=_t(tfscal.astype(np.float32), device))


def sky_tables(src, skybox, device="cpu") -> sky_ops.SkyTables:
    """The JAX SkyTables (array leaves as numpy; its static descriptor
    `kstat` passes through tree_map untouched) plus the port's own host
    `skybox` -> the port's SkyTables, so that both sides render from the
    same directions, colours, faces and star phases.  The JAX package's
    padded face list and vertex colours are folded into `face_table` (its
    own static face descriptor); the exact path's mesh tables are carried
    as they are."""
    ks = src.kstat
    face_table = np.asarray(
        [[f[0], f[1], f[2], *f[3], *f[4], *f[5]] for f in ks.faces],
        np.int32).reshape(len(ks.faces), sky_ops.N_FACE_COLS)
    return sky_ops.SkyTables(
        skybox=skybox, time=float(ks.time), vpad=int(ks.vpad),
        mtn_dirs=_t(src.mtn_dirs, device),
        face_table=_t(face_table, device),
        star_dirs=_t(src.star_dirs, device),
        star_phase=_t(src.star_phase, device),
        star_color=_t(src.star_color, device),
        star_size=float(src.star_size),
        star_twinkle=float(src.star_twinkle),
        stars_enabled=bool(src.stars_enabled),
        all_dirs=_t(src.all_dirs, device),
        all_colors=_t(src.all_colors, device),
        all_faces=_t(src.all_faces, device),
        all_valid=_t(src.all_valid, device))


def reverb_state(src, device="cpu") -> rvb.ReverbState:
    """A JAX audio ReverbState (buffers, pos, accum; vmapped or not)."""
    return _same_fields(rvb.ReverbState, src, device)


def resampler_state(src, device="cpu") -> rsp.ResamplerState:
    """A JAX audio ResamplerState (vmapped or not)."""
    return _same_fields(rsp.ResamplerState, src, device)
