"""The fused game step, batched over instances (bonnie32_tpu/game/step.py).

input -> controller -> physics -> camera, as the JAX package's vmapped
`tick` and `character_camera`: the player input of renderer.rs:310-418,
GameToolState::tick (runtime.rs:405-482) and update_character_camera
(runtime.rs:318-350).  sin/cos/atan2/asin differ from XLA's by ulps, so
states agree with the JAX package to a tolerance, not bit for bit.
"""

import math
from typing import NamedTuple

import numpy as np
import torch

from ..types import CameraArrays
from .collision import CollisionGrid, PlayerParams, move_and_slide
from .state import GameState

LOOK_SENSITIVITY = 2.5  # renderer.rs:319
TURN_SPEED = 10.0       # renderer.rs:381
TAU = float(np.float32(2.0 * math.pi))
PI = float(np.float32(math.pi))


class Actions(NamedTuple):
    """Per-instance input snapshot, each (I,)."""

    move_x: torch.Tensor  # f32 left stick x
    move_y: torch.Tensor  # f32 left stick y (forward +)
    cam_x: torch.Tensor   # f32 right stick x
    cam_y: torch.Tensor   # f32 right stick y
    sprint: torch.Tensor  # bool (Dodge held)
    jump: torch.Tensor    # bool (Jump held; edge-detected inside)


def _player_input(state: GameState, params: PlayerParams, actions: Actions,
                  dt: torch.Tensor) -> GameState:
    """renderer.rs:310-418 for every instance's player slot."""
    mx, my = actions.move_x, actions.move_y
    cx, cy = actions.cam_x, actions.cam_y
    zero = torch.zeros_like(mx)
    stick = torch.sqrt(cx * cx + cy * cy) > 0.0
    yaw = state.char_cam_yaw - torch.where(
        stick, cx * LOOK_SENSITIVITY * dt, zero)
    pitch = torch.clamp(
        state.char_cam_pitch - torch.where(
            stick, cy * LOOK_SENSITIVITY * dt, zero),
        params.camera_pitch_min, params.camera_pitch_max)

    rows = torch.arange(mx.shape[0], device=mx.device)
    p = torch.clamp(state.player, min=0).long()
    has_player = state.player >= 0

    # camera-relative movement (renderer.rs:345-398)
    sy, cyw = torch.sin(yaw), torch.cos(yaw)
    use = torch.sqrt(mx * mx + my * my) > 0.1
    mv0 = torch.where(use, sy * my + cyw * (-mx), zero)
    mv1 = torch.where(use, cyw * my + (-sy) * (-mx), zero)
    mv_len = torch.sqrt(mv0 * mv0 + mv1 * mv1)
    moving = mv_len > 0.1
    sprinting = actions.sprint & moving
    safe_len = torch.where(mv_len == 0, torch.ones_like(mv_len), mv_len)
    d0, d1 = mv0 / safe_len, mv1 / safe_len

    # smooth facing toward the movement (renderer.rs:374-384); jnp.mod is
    # a floor-mod: fmod, then + TAU where the remainder is negative
    target = torch.atan2(d0, d1)
    facing = state.facing[rows, p]
    diff = torch.fmod(target - facing, TAU)
    diff = torch.where(diff < 0, diff + TAU, diff)
    diff = torch.where(diff > PI, diff - TAU, diff)
    new_facing = facing + diff * TURN_SPEED * dt
    facing_out = torch.where(moving & has_player, new_facing, facing)

    speed = torch.where(sprinting, params.run_speed, params.walk_speed)
    vx = torch.where(moving, d0 * speed, zero)
    vz = torch.where(moving, d1 * speed, zero)
    vel = state.vel.clone()
    vel[rows, p, 0] = torch.where(has_player, vx, vel[rows, p, 0])
    vel[rows, p, 2] = torch.where(has_player, vz, vel[rows, p, 2])

    # jump on the press edge while grounded (renderer.rs:401-416)
    can_jump = (actions.jump & ~state.jump_was_down
                & state.grounded[rows, p] & has_player)
    jump_vel = torch.where(
        sprinting, params.jump_velocity * params.sprint_jump_multiplier,
        params.jump_velocity)
    vvel = state.vertical_velocity.clone()
    vvel[rows, p] = torch.where(can_jump, jump_vel, vvel[rows, p])
    grounded = state.grounded.clone()
    grounded[rows, p] = grounded[rows, p] & ~can_jump
    facing_all = state.facing.clone()
    facing_all[rows, p] = torch.where(has_player, facing_out, facing)

    return state._replace(char_cam_yaw=yaw, char_cam_pitch=pitch,
                          facing=facing_all, vel=vel,
                          vertical_velocity=vvel, grounded=grounded,
                          jump_was_down=actions.jump)


def tick(state: GameState, grid: CollisionGrid, params: PlayerParams,
         actions: Actions, dt: float) -> GameState:
    """One simulation frame for every instance (runtime.rs:405-482)."""
    dt = torch.tensor(dt, dtype=torch.float32, device=state.pos.device)
    state = _player_input(state, params, actions, dt)

    new_pos, new_grounded, new_room, new_vvel = move_and_slide(
        grid, state.pos, state.vel, state.radius, state.height,
        state.step_height, state.grounded, state.room,
        state.vertical_velocity, params.gravity, dt)
    ctrl = state.has_controller & state.alive
    pos = torch.where(ctrl[..., None], new_pos, state.pos)
    grounded = torch.where(ctrl, new_grounded, state.grounded)
    room = torch.where(ctrl, new_room, state.room)
    vvel = torch.where(ctrl, new_vvel, state.vertical_velocity)

    # plain velocity integration for non-controller entities
    plain = state.alive & ~state.has_controller
    pos = torch.where(plain[..., None], state.pos + state.vel * dt, pos)

    # health i-frames (components.rs:103)
    inv = torch.where(state.has_health,
                      torch.clamp(state.invincibility - dt, min=0.0),
                      state.invincibility)
    return state._replace(pos=pos, grounded=grounded, room=room,
                          vertical_velocity=vvel, invincibility=inv,
                          time=state.time + dt)


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def _norm(v):
    return torch.sqrt((v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1])
                      + v[..., 2] * v[..., 2])


def character_camera(state: GameState, params: PlayerParams
                     ) -> CameraArrays:
    """update_character_camera (runtime.rs:318-350) for every instance:
    position (I, 3), basis (I, 3, 3)."""
    rows = torch.arange(state.player.shape[0], device=state.pos.device)
    p = torch.clamp(state.player, min=0).long()
    player_pos = state.pos[rows, p]
    zero = torch.zeros_like(state.char_cam_yaw)
    look_at = player_pos + torch.stack(
        [zero, zero + params.camera_vertical_offset, zero], -1)

    yaw, pitch = state.char_cam_yaw, state.char_cam_pitch
    hd = params.camera_distance * torch.cos(pitch)
    vo = params.camera_distance * torch.sin(pitch)
    cam_pos = look_at + torch.stack(
        [-torch.sin(yaw) * hd, vo, -torch.cos(yaw) * hd], -1)

    to_target = look_at - cam_pos
    norm = _norm(to_target)
    to_target = to_target / torch.where(norm == 0, torch.ones_like(norm),
                                        norm)[..., None]
    rot_y = torch.atan2(to_target[..., 0], to_target[..., 2])
    rot_x = torch.asin(-to_target[..., 1])

    # Camera::update_basis (camera.rs:76-91)
    cxr, sxr = torch.cos(rot_x), torch.sin(rot_x)
    cyr, syr = torch.cos(rot_y), torch.sin(rot_y)
    bz = torch.stack([cxr * syr, -sxr, cxr * cyr], -1)
    up = torch.tensor([0.0, -1.0, 0.0], device=bz.device).expand_as(bz)
    bx = _cross(up, bz)
    bxn = _norm(bx)
    bx = bx / torch.where(bxn == 0, torch.ones_like(bxn), bxn)[..., None]
    by = _cross(bz, bx)
    return CameraArrays(position=cam_pos, basis=torch.stack([bx, by, bz], 1))
