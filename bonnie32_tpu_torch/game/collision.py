"""Sector collision (bonnie32_tpu/game/collision.py).

`compile_collision` packs the level's sector heights into the same two
tables the JAX package queries (one (R*GX*GZ, 16) sector row, one (R, 8)
room row per query); the device functions batch over any leading shape,
here (instances, entity slots) and the 20 corner probes.  Every explicit
clamp of the JAX gathers is mirrored, since torch raises (CPU) or
device-asserts (CUDA) on an out-of-range index where JAX clamps.
"""

from typing import NamedTuple

import numpy as np
import torch

from ..models.level import SECTOR_SIZE
from ..ops.fixed import f32_to_i32
from ..types import resolve_device

TERMINAL_VELOCITY = 4000.0  # game/components.rs:39
_SEC = float(SECTOR_SIZE)

# sector_tab columns
_SC_HAS_SECTOR, _SC_HAS_FLOOR, _SC_FH, _SC_FSPLIT = 0, 1, 2, 6
_SC_HAS_CEIL, _SC_CH, _SC_CSPLIT = 7, 8, 12
# room_tab columns
_RC_POS, _RC_WIDTH, _RC_DEPTH = 0, 3, 4


class CollisionGrid(NamedTuple):
    room_pos: torch.Tensor    # (R, 3) f32
    bounds_min: torch.Tensor  # (R, 3) f32 room-relative
    bounds_max: torch.Tensor  # (R, 3) f32
    sector_tab: torch.Tensor  # (R*GX*GZ, 16) f32
    room_tab: torch.Tensor    # (R, 8) f32
    n_gx: int                 # GX, sector columns of the padded grid
    n_gz: int                 # GZ


class PlayerParams(NamedTuple):
    """PlayerSettings (world/geometry.rs:2177) as f32 scalars."""

    radius: torch.Tensor
    height: torch.Tensor
    step_height: torch.Tensor
    walk_speed: torch.Tensor
    run_speed: torch.Tensor
    gravity: torch.Tensor
    jump_velocity: torch.Tensor
    sprint_jump_multiplier: torch.Tensor
    camera_distance: torch.Tensor
    camera_vertical_offset: torch.Tensor
    camera_pitch_min: torch.Tensor
    camera_pitch_max: torch.Tensor


def player_params(level, device=None) -> PlayerParams:
    """The level's PlayerSettings on `device` (default: the card)."""
    device = resolve_device(device)
    s = level.player_settings
    return PlayerParams(**{
        f: torch.tensor(np.float32(getattr(s, f)), device=device)
        for f in PlayerParams._fields})


def compile_collision(level, device=None) -> CollisionGrid:
    """The packed sector and room tables on `device` (default: the
    card)."""
    device = resolve_device(device)
    r = max(len(level.rooms), 1)
    gx = max((room.width for room in level.rooms), default=1)
    gz = max((room.depth for room in level.rooms), default=1)
    room_pos = np.zeros((r, 3), np.float32)
    bmin = np.zeros((r, 3), np.float32)
    bmax = np.zeros((r, 3), np.float32)
    sec = np.zeros((r, gx, gz, 16), np.float32)
    room_tab = np.zeros((r, 8), np.float32)
    for i, room in enumerate(level.rooms):
        room_pos[i] = room.position
        bmin[i] = room.bounds_min
        bmax[i] = room.bounds_max
        room_tab[i, _RC_POS:_RC_POS + 3] = room.position
        room_tab[i, _RC_WIDTH] = room.width
        room_tab[i, _RC_DEPTH] = room.depth
        for x, z, sector in room.iter_sectors():
            row = sec[i, x, z]
            row[_SC_HAS_SECTOR] = 1.0
            if sector.floor is not None:
                row[_SC_HAS_FLOOR] = 1.0
                row[_SC_FH:_SC_FH + 4] = sector.floor.heights
                row[_SC_FSPLIT] = sector.floor.split_direction
            if sector.ceiling is not None:
                row[_SC_HAS_CEIL] = 1.0
                row[_SC_CH:_SC_CH + 4] = sector.ceiling.heights
                row[_SC_CSPLIT] = sector.ceiling.split_direction

    def t(a):
        return torch.from_numpy(a).to(device)

    return CollisionGrid(room_pos=t(room_pos), bounds_min=t(bmin),
                         bounds_max=t(bmax),
                         sector_tab=t(sec.reshape(r * gx * gz, 16)),
                         room_tab=t(room_tab), n_gx=gx, n_gz=gz)


def _interpolate_height(heights, split, u, v):
    """HorizontalFace::interpolate_height (geometry.rs:1283), f32."""
    u = torch.clamp(u, 0.0, 1.0)
    v = torch.clamp(v, 0.0, 1.0)
    h0, h1, h2, h3 = (heights[..., 0], heights[..., 1], heights[..., 2],
                      heights[..., 3])
    nwse = torch.where(u >= v, h0 + u * (h1 - h0) + v * (h2 - h1),
                       h0 + u * (h2 - h3) + v * (h3 - h0))
    nesw = torch.where(u + v <= 1.0, h0 + u * (h1 - h0) + v * (h3 - h0),
                       h3 + u * (h2 - h3) + (1.0 - v) * (h1 - h2))
    return torch.where(split == 0, nwse, nesw)


def find_room_at(grid: CollisionGrid, point, hint):
    """Level::find_room_at_with_hint (geometry.rs:3576): the hint first,
    else the first containing room; -1 if none.  point (..., 3), hint
    (...) i32."""
    rel = point[..., None, :] - grid.room_pos                # (..., R, 3)
    inside = ((rel >= grid.bounds_min) & (rel <= grid.bounds_max)).all(-1)
    n = grid.room_pos.shape[0]
    idxs = torch.arange(n, dtype=torch.int32, device=point.device)
    first = torch.where(inside, idxs, torch.full_like(idxs, n)).amin(-1)
    first = torch.where(first >= n, torch.full_like(first, -1), first)
    hint_in = torch.gather(inside, -1,
                           torch.clamp(hint, 0, n - 1).long()[..., None])
    hint_ok = (hint >= 0) & (hint < n) & hint_in[..., 0]
    return torch.where(hint_ok, hint, first)


class FloorQuery(NamedTuple):
    found: torch.Tensor
    room: torch.Tensor
    floor: torch.Tensor
    ceiling: torch.Tensor


def get_floor_info(grid: CollisionGrid, point, hint) -> FloorQuery:
    """Level::get_floor_info (geometry.rs:3597-3643): one room row and one
    sector row per query."""
    room = find_room_at(grid, point, hint)
    safe = torch.clamp(room, min=0).long()
    rrow = grid.room_tab[safe]
    rx, ry, rz = rrow[..., 0], rrow[..., 1], rrow[..., 2]
    local_x = point[..., 0] - rx
    local_z = point[..., 2] - rz
    sx = f32_to_i32(torch.floor(local_x / _SEC))
    sz = f32_to_i32(torch.floor(local_z / _SEC))
    in_grid = ((sx >= 0) & (sz >= 0)
               & (sx.to(torch.float32) < rrow[..., _RC_WIDTH])
               & (sz.to(torch.float32) < rrow[..., _RC_DEPTH]))
    gx = torch.clamp(sx, 0, grid.n_gx - 1).long()
    gz = torch.clamp(sz, 0, grid.n_gz - 1).long()
    srow = grid.sector_tab[(safe * grid.n_gx + gx) * grid.n_gz + gz]
    found = (room >= 0) & in_grid & (srow[..., _SC_HAS_SECTOR] > 0.5)

    u = (local_x - sx.to(torch.float32) * _SEC) / _SEC
    v = (local_z - sz.to(torch.float32) * _SEC) / _SEC
    fl = _interpolate_height(srow[..., _SC_FH:_SC_FH + 4],
                             srow[..., _SC_FSPLIT], u, v)
    floor_y = torch.where(srow[..., _SC_HAS_FLOOR] > 0.5, ry + fl, ry)
    cl = _interpolate_height(srow[..., _SC_CH:_SC_CH + 4],
                             srow[..., _SC_CSPLIT], u, v)
    ceil_y = torch.where(srow[..., _SC_HAS_CEIL] > 0.5, ry + cl,
                         ry + 2048.0)
    return FloorQuery(found=found, room=room, floor=floor_y, ceiling=ceil_y)


def collide_cylinder(grid: CollisionGrid, position, velocity, radius,
                     height, step_height, grounded_in, room_in,
                     vert_vel_in, gravity, dt):
    """game/collision.rs:37-165 over a leading batch shape; position and
    velocity (..., 3).  Returns (position, grounded, room, hit_ceiling,
    vertical_velocity)."""
    px, py, pz = position[..., 0], position[..., 1], position[..., 2]
    new_x = px + velocity[..., 0] * dt
    new_z = pz + velocity[..., 2] * dt
    vert_vel = torch.where(
        grounded_in, vert_vel_in,
        torch.clamp(vert_vel_in - gravity * dt, min=-TERMINAL_VELOCITY))
    new_y = py + vert_vel * dt

    info = get_floor_info(grid, torch.stack([new_x, new_y, new_z], -1),
                          room_in)
    current_room = torch.where(info.found, info.room, room_in)

    # centre test (collision.rs:66-111)
    below = new_y < info.floor
    height_diff = info.floor - new_y
    step_up = below & (height_diff <= step_height)
    wall_block = below & (height_diff > step_height)
    on_ground = ~below & (new_y <= info.floor + 1.0)
    y1 = torch.where(step_up | on_ground, info.floor, new_y)
    x1 = torch.where(wall_block, px, new_x)
    z1 = torch.where(wall_block, pz, new_z)
    grounded = step_up | on_ground
    hit_ceiling = (new_y + height) > info.ceiling
    y1 = torch.where(hit_ceiling, info.ceiling - height, y1)

    # void fallback (collision.rs:102-111)
    x1 = torch.where(info.found, x1, px)
    y1 = torch.where(info.found, y1, py)
    z1 = torch.where(info.found, z1, pz)
    grounded = torch.where(info.found, grounded, grounded_in)
    hit_ceiling = hit_ceiling & info.found
    vert_vel = torch.where(info.found, vert_vel, torch.zeros_like(vert_vel))

    # four corner probes (collision.rs:113-148), corners fixed from
    # (x1, z1), per-axis pushback carried in corner order; the loop can
    # only ever query a closed set of 20 points, evaluated in one batch
    cxs = torch.stack([x1 - radius, x1 + radius, x1 + radius, x1 - radius],
                      -1)
    czs = torch.stack([z1 - radius, z1 - radius, z1 + radius, z1 + radius],
                      -1)
    y4 = y1[..., None].expand_as(cxs)

    def pts(xs, zs):
        return torch.stack([xs.expand_as(cxs), y4, zs.expand_as(cxs)], -1)

    probes = torch.cat([pts(cxs, czs), pts(cxs, z1[..., None]),
                        pts(cxs, pz[..., None]), pts(x1[..., None], czs),
                        pts(px[..., None], czs)], dim=-2)   # (..., 20, 3)
    q = get_floor_info(grid, probes,
                       current_room[..., None].expand(probes.shape[:-1]))
    blocked = q.found & ((q.floor - y1[..., None]) > step_height[..., None])
    cx_orig = torch.zeros_like(grounded)
    cz_orig = torch.zeros_like(grounded)
    for k in range(4):
        x_block = blocked[..., k] & torch.where(cz_orig, blocked[..., 8 + k],
                                                blocked[..., 4 + k])
        cx_orig = cx_orig | x_block
        z_block = blocked[..., k] & torch.where(cx_orig,
                                                blocked[..., 16 + k],
                                                blocked[..., 12 + k])
        cz_orig = cz_orig | z_block
        void = ~q.found[..., k]
        cx_orig = cx_orig | void
        cz_orig = cz_orig | void

    final = torch.stack([torch.where(cx_orig, px, x1), y1,
                         torch.where(cz_orig, pz, z1)], -1)
    return final, grounded, current_room, hit_ceiling, vert_vel


def move_and_slide(grid: CollisionGrid, position, velocity, radius, height,
                   step_height, grounded, room, vert_vel, gravity, dt):
    """game/collision.rs:170-193: collide + controller state update.
    Returns (position, grounded, room, vertical_velocity)."""
    pos, grounded, room, hit_ceiling, vv = collide_cylinder(
        grid, position, velocity, radius, height, step_height, grounded,
        room, vert_vel, gravity, dt)
    new_vert = torch.where(grounded | hit_ceiling, torch.zeros_like(vv), vv)
    return pos, grounded, room, new_vert
