"""SoA ECS state with a leading instance dimension
(bonnie32_tpu/game/state.py).

Every field of the JAX GameState, batched: per-entity fields are (I, E),
(I, E, 3) for vectors, and the per-instance scalars are (I,).  The entity
functions work on every instance at once: an entity argument is one slot
per instance, (I,), or one slot for all; a value is one for all or one
per instance.

Entity kinds (game/components.rs:223-380 marker components): 0 none,
1 player, 2 enemy, 3 projectile, 4 item, 5 door, 6 checkpoint, 7 spawn
point, 8 key.
"""

from typing import NamedTuple

import torch

from ..types import resolve_device

KIND_NONE, KIND_PLAYER, KIND_ENEMY, KIND_PROJECTILE, KIND_ITEM, \
    KIND_DOOR, KIND_CHECKPOINT, KIND_SPAWN, KIND_KEY = range(9)

# Team (components.rs:209): Neutral damages everyone.
TEAM_NEUTRAL, TEAM_PLAYER, TEAM_ENEMY = range(3)

# AiState (components.rs:358).
AI_IDLE, AI_PATROL, AI_CHASE, AI_ATTACK, AI_RECOVER, AI_FLEE, AI_DEAD = \
    range(7)

# EnemyType (components.rs:231).
ENEMY_GRUNT, ENEMY_ARCHER, ENEMY_HEAVY, ENEMY_SWARM, ENEMY_ELITE, \
    ENEMY_BOSS = range(6)


class GameState(NamedTuple):
    alive: torch.Tensor              # (I, E) bool
    generation: torch.Tensor         # (I, E) i32
    kind: torch.Tensor               # (I, E) i32
    pos: torch.Tensor                # (I, E, 3) f32
    vel: torch.Tensor                # (I, E, 3) f32
    has_controller: torch.Tensor     # (I, E) bool
    radius: torch.Tensor             # (I, E) f32
    height: torch.Tensor             # (I, E) f32
    step_height: torch.Tensor        # (I, E) f32
    grounded: torch.Tensor           # (I, E) bool
    room: torch.Tensor               # (I, E) i32
    facing: torch.Tensor             # (I, E) f32
    vertical_velocity: torch.Tensor  # (I, E) f32
    has_health: torch.Tensor         # (I, E) bool
    hp: torch.Tensor                 # (I, E) i32
    max_hp: torch.Tensor             # (I, E) i32
    invincibility: torch.Tensor      # (I, E) f32
    rot: torch.Tensor                # (I, E, 3) f32
    parent: torch.Tensor             # (I, E) i32
    team: torch.Tensor               # (I, E) i32
    hitbox_active: torch.Tensor      # (I, E) bool
    hitbox_radius: torch.Tensor      # (I, E) f32
    hitbox_damage: torch.Tensor      # (I, E) i32
    hurtbox_radius: torch.Tensor     # (I, E) f32
    hurtbox_mult: torch.Tensor       # (I, E) f32
    door_open: torch.Tensor          # (I, E) bool
    door_key: torch.Tensor           # (I, E) i32
    key_type: torch.Tensor           # (I, E) i32
    item_amount: torch.Tensor        # (I, E) i32
    checkpoint_active: torch.Tensor  # (I, E) bool
    respawn_offset: torch.Tensor     # (I, E, 3) f32
    spawned_entity: torch.Tensor     # (I, E) i32
    ai_state: torch.Tensor           # (I, E) i32
    owner: torch.Tensor              # (I, E) i32
    subtype: torch.Tensor            # (I, E) i32
    player: torch.Tensor             # (I,) i32, -1 = none
    char_cam_yaw: torch.Tensor       # (I,) f32
    char_cam_pitch: torch.Tensor     # (I,) f32
    jump_was_down: torch.Tensor      # (I,) bool
    time: torch.Tensor               # (I,) f32


def new_state(n_instances: int, capacity: int = 64,
              device=None) -> GameState:
    """Empty entity tables for `n_instances` instances on `device`
    (default: the card)."""
    device = resolve_device(device)
    i, e = n_instances, capacity
    f32, i32, b = torch.float32, torch.int32, torch.bool

    def z(*shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    def full(val, *shape, dtype):
        return torch.full(shape, val, dtype=dtype, device=device)

    return GameState(
        alive=z(i, e, dtype=b), generation=z(i, e, dtype=i32),
        kind=z(i, e, dtype=i32), pos=z(i, e, 3, dtype=f32),
        vel=z(i, e, 3, dtype=f32), has_controller=z(i, e, dtype=b),
        radius=z(i, e, dtype=f32), height=z(i, e, dtype=f32),
        step_height=z(i, e, dtype=f32), grounded=z(i, e, dtype=b),
        room=z(i, e, dtype=i32), facing=z(i, e, dtype=f32),
        vertical_velocity=z(i, e, dtype=f32), has_health=z(i, e, dtype=b),
        hp=z(i, e, dtype=i32), max_hp=z(i, e, dtype=i32),
        invincibility=z(i, e, dtype=f32), rot=z(i, e, 3, dtype=f32),
        parent=full(-1, i, e, dtype=i32), team=z(i, e, dtype=i32),
        hitbox_active=z(i, e, dtype=b), hitbox_radius=z(i, e, dtype=f32),
        hitbox_damage=z(i, e, dtype=i32),
        hurtbox_radius=z(i, e, dtype=f32),
        hurtbox_mult=full(1.0, i, e, dtype=f32),
        door_open=z(i, e, dtype=b), door_key=full(-1, i, e, dtype=i32),
        key_type=full(-1, i, e, dtype=i32), item_amount=z(i, e, dtype=i32),
        checkpoint_active=z(i, e, dtype=b),
        respawn_offset=z(i, e, 3, dtype=f32),
        spawned_entity=full(-1, i, e, dtype=i32),
        ai_state=z(i, e, dtype=i32), owner=full(-1, i, e, dtype=i32),
        subtype=z(i, e, dtype=i32), player=full(-1, i, dtype=i32),
        char_cam_yaw=z(i, dtype=f32),
        char_cam_pitch=full(0.2, i, dtype=f32),   # runtime.rs:230
        jump_was_down=z(i, dtype=b), time=z(i, dtype=f32))


def spawn(state: GameState, kind: int, pos, hp: int = 0, controller=None,
          **fields):
    """Allocate into every instance's first free slot (lowest free index,
    generation bumped: entity.rs:64-151).  Returns (state, slot (I,))."""
    e = torch.argmin(state.alive.to(torch.int8), dim=1)   # first False
    rows = torch.arange(e.shape[0], device=e.device)
    new = {k: v.clone() for k, v in state._asdict().items()}

    def seti(name, val):
        new[name][rows, e] = torch.as_tensor(
            val, dtype=new[name].dtype, device=e.device)

    seti("alive", True)
    new["generation"][rows, e] += 1
    seti("kind", kind)
    seti("pos", pos)
    seti("vel", [0.0, 0.0, 0.0])
    seti("has_health", hp > 0)
    seti("hp", hp)
    seti("max_hp", hp)
    seti("invincibility", 0.0)
    seti("rot", [0.0, 0.0, 0.0])
    seti("parent", -1)
    seti("team", TEAM_NEUTRAL)
    seti("hitbox_active", False)
    seti("hitbox_radius", 0.0)
    seti("hitbox_damage", 0)
    seti("hurtbox_radius", 0.0)
    seti("hurtbox_mult", 1.0)
    seti("door_open", False)
    seti("door_key", -1)
    seti("key_type", -1)
    seti("item_amount", 0)
    seti("checkpoint_active", False)
    seti("respawn_offset", [0.0, 0.0, 0.0])
    seti("spawned_entity", -1)
    seti("ai_state", AI_IDLE)
    seti("owner", -1)
    seti("subtype", 0)
    if controller is not None:
        radius, height, step_height = controller
        seti("has_controller", True)
        seti("radius", radius)
        seti("height", height)
        seti("step_height", step_height)
        seti("grounded", False)
        seti("room", 0)
        seti("facing", 0.0)
        seti("vertical_velocity", 0.0)
    for name, val in fields.items():
        seti(name, val)
    return GameState(**new), e


def spawn_player(state: GameState, pos, player_settings, hp: int = 100):
    """World::spawn_player (game/world.rs:264): controller + health +
    hurtbox(radius) + player marker."""
    state, e = spawn(state, KIND_PLAYER, pos, hp=hp,
                     controller=(player_settings.radius,
                                 player_settings.height,
                                 player_settings.step_height),
                     team=TEAM_PLAYER,
                     hurtbox_radius=player_settings.radius)
    return state._replace(player=e.to(torch.int32)), e


def spawn_enemy(state: GameState, pos, hp: int,
                enemy_type: int = ENEMY_GRUNT):
    """world.rs:278 — health + velocity + unit-sphere hurtbox."""
    return spawn(state, KIND_ENEMY, pos, hp=hp, team=TEAM_ENEMY,
                 subtype=enemy_type, hurtbox_radius=1.0)


def spawn_projectile(state: GameState, pos, velocity, damage: int, owner,
                     team: int = TEAM_NEUTRAL):
    """world.rs:288 — velocity + 0.5-sphere hitbox, damage attributed to
    `owner`."""
    state, e = spawn(state, KIND_PROJECTILE, pos, team=team,
                     hitbox_active=True, hitbox_radius=0.5,
                     hitbox_damage=damage, owner=owner)
    rows = torch.arange(e.shape[0], device=e.device)
    vel = state.vel.clone()
    vel[rows, e] = torch.as_tensor(velocity, dtype=vel.dtype,
                                   device=vel.device)
    return state._replace(vel=vel), e


def spawn_door(state: GameState, pos, required_key: int = -1):
    """world.rs:297 — closed door, optionally keyed."""
    return spawn(state, KIND_DOOR, pos, door_key=required_key)


def spawn_checkpoint(state: GameState, pos):
    """world.rs:307 — inactive, respawn offset (0, 1, 0)."""
    return spawn(state, KIND_CHECKPOINT, pos, respawn_offset=[0.0, 1.0, 0.0])


def _slots(state: GameState, e):
    """(instance rows, entity slots), each (I,) i64, of `e`: one slot per
    instance or one for all."""
    n = state.alive.shape[0]
    dev = state.alive.device
    e = torch.as_tensor(e, device=dev).long().expand(n)
    return torch.arange(n, device=dev), e


def despawn(state: GameState, e) -> GameState:
    rows, e = _slots(state, e)
    new = {}
    for name, val in (("alive", False), ("kind", KIND_NONE),
                      ("has_controller", False), ("has_health", False),
                      ("hitbox_active", False), ("hurtbox_radius", 0.0)):
        new[name] = getattr(state, name).clone()
        new[name][rows, e] = val
    return state._replace(**new)


def entity_ref(state: GameState, e):
    """Generational handle (entity.rs:20): (index, generation), each (I,)
    i32."""
    rows, e = _slots(state, e)
    return e.to(torch.int32), state.generation[rows, e]


def is_ref_alive(state: GameState, ref) -> torch.Tensor:
    """Stale handles (a reused slot bumped the generation) read as dead;
    (I,) bool."""
    idx, gen = ref
    rows, idx = _slots(state, idx)
    return state.alive[rows, idx] & (state.generation[rows, idx] == gen)
