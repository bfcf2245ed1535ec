"""ECS systems: health and damage, combat overlap, interactions,
transforms, batched over instances (bonnie32_tpu/game/systems.py).

Reference behaviour: Health::damage / heal / i-frames (components.rs:
103-142); the tick's system order (runtime.rs:405-482); Hitbox / Hurtbox
and Team filtering (components.rs:146-215), on which `combat_system` is
the batched sphere-overlap damage pass; Door / Key / Checkpoint / Item
(components.rs:278-351).

The JAX package vmaps these over a leading instance axis; here they take
it as it is.  An entity argument is one slot per instance, (I,), or one
slot for all, and so is an amount.
"""

import torch

from . import events as ev
from .state import (AI_DEAD, GameState, KIND_CHECKPOINT, KIND_DOOR,
                    KIND_ITEM, KIND_KEY, TEAM_NEUTRAL, _slots)

_F32 = torch.float32
_I32 = torch.int32


def _set(arr, rows, e, val):
    out = arr.clone()
    out[rows, e] = val
    return out


def _per_instance(v, like):
    return torch.as_tensor(v, dtype=like.dtype,
                           device=like.device).expand(like.shape[0])


# ---- Health (components.rs:103-142) ----

def apply_damage(state: GameState, target, amount, source=-1,
                 iframes: float = 0.0, events: ev.Events = None):
    """Health::damage: a no-op during i-frames, clamped at 0; a hit
    grants `iframes` seconds (set_invincible).  Returns (state, died
    (I,), events)."""
    rows, t = _slots(state, target)
    hp0 = state.hp[rows, t]
    has = state.has_health[rows, t] & state.alive[rows, t]
    vulnerable = has & (state.invincibility[rows, t] <= 0.0)
    amount = _per_instance(amount, hp0)
    hp = torch.where(vulnerable, torch.clamp(hp0 - amount, min=0), hp0)
    died = vulnerable & (hp == 0) & (hp0 > 0)
    inv0 = state.invincibility[rows, t]
    state = state._replace(
        hp=_set(state.hp, rows, t, hp),
        invincibility=_set(state.invincibility, rows, t, torch.where(
            vulnerable, torch.full_like(inv0, iframes), inv0)))
    if events is not None:
        pos = state.pos[rows, t]
        events = events._replace(
            damage=ev.push(events.damage, a=t, b=source, c=amount, pos=pos,
                           enabled=vulnerable),
            death=ev.push(events.death, a=t, c=state.team[rows, t],
                          pos=pos, enabled=died))
    return state, died, events


def heal(state: GameState, target, amount) -> GameState:
    """Health::heal — clamped at the maximum."""
    rows, t = _slots(state, target)
    hp0 = state.hp[rows, t]
    has = state.has_health[rows, t] & state.alive[rows, t]
    hp = torch.minimum(hp0 + _per_instance(amount, hp0),
                       state.max_hp[rows, t])
    return state._replace(hp=_set(state.hp, rows, t,
                                  torch.where(has, hp, hp0)))


def tick_invincibility(state: GameState, dt) -> GameState:
    """tick_invincibility (components.rs:140), a saturating countdown;
    the reference counts frames, this holds seconds and subtracts dt."""
    dt = torch.as_tensor(dt, dtype=_F32, device=state.pos.device)
    return state._replace(
        invincibility=torch.clamp(state.invincibility - dt, min=0.0))


# ---- Combat: hitbox vs hurtbox sphere overlap, team filtered ----

def combat_system(state: GameState, events: ev.Events, dt,
                  iframes: float = 0.5):
    """Every active hitbox against every hurtbox of its instance,
    O(E^2).  Team rule (components.rs:209): same-team pairs never damage;
    NEUTRAL damages everyone.  Damage = hitbox damage x hurtbox
    multiplier (truncated), attributed to the hitbox's owner when it has
    one."""
    n, e = state.alive.shape
    dev = state.pos.device
    pos = state.pos
    d = pos[:, :, None, :] - pos[:, None, :, :]
    dist_sq = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) \
        + d[..., 2] * d[..., 2]                              # (I, E, E)
    reach = state.hitbox_radius[:, :, None] + state.hurtbox_radius[:, None]
    overlap = dist_sq <= reach * reach

    att_ok = state.alive & state.hitbox_active & (state.hitbox_radius > 0)
    vic_ok = (state.alive & (state.hurtbox_radius > 0) & state.has_health
              & (state.invincibility <= 0.0))
    team_a, team_v = state.team[:, :, None], state.team[:, None, :]
    teams_differ = (team_a != team_v) | (team_a == TEAM_NEUTRAL)
    ids = torch.arange(e, device=dev, dtype=_I32)
    not_self = ids[:, None] != ids[None, :]
    not_owner = state.owner[:, :, None] != ids[None, None, :]
    hits = (overlap & att_ok[:, :, None] & vic_ok[:, None, :] & teams_differ
            & not_self & not_owner)                  # (I, E_att, E_vic)

    dmg_pair = torch.trunc(state.hitbox_damage[:, :, None].to(_F32)
                           * state.hurtbox_mult[:, None, :]).to(_I32)
    dmg_taken = torch.where(hits, dmg_pair, torch.zeros_like(dmg_pair)).sum(
        1, dtype=_I32)
    was_hit = hits.any(1)

    hp = torch.clamp(state.hp - dmg_taken, min=0)
    died = was_hit & (hp == 0) & (state.hp > 0)
    state = state._replace(
        hp=torch.where(was_hit, hp, state.hp),
        invincibility=torch.where(
            was_hit, torch.full_like(state.invincibility, iframes),
            state.invincibility),
        ai_state=torch.where(died, torch.full_like(state.ai_state, AI_DEAD),
                             state.ai_state))

    # attribution: the first attacker of each victim
    first_att = hits.to(torch.int8).argmax(1)                # (I, E)
    owner = state.owner.gather(1, first_att)
    src = torch.where(owner >= 0, owner, first_att.to(_I32))
    ids_i = ids.expand(n, -1)
    events = events._replace(
        damage=ev.push_many(events.damage, was_hit, a=ids_i, b=src,
                            c=dmg_taken, pos=pos),
        death=ev.push_many(events.death, died, a=ids_i, c=state.team,
                           pos=pos))
    return state, events


# ---- Interactions (components.rs:278-351) ----

def try_open_door(state: GameState, door, opener, held_keys,
                  events: ev.Events):
    """Door::required_key: a closed door opens if it is unlocked or its
    key is held.  held_keys: (K,) or (I, K) i32 key types the opener
    owns (-1 padding).  One door event per attempt on a closed door
    (c = 1 opened, 0 blocked).  Returns (state, opened (I,), events)."""
    rows, dr = _slots(state, door)
    is_door = state.alive[rows, dr] & (state.kind[rows, dr] == KIND_DOOR)
    was_open = state.door_open[rows, dr]
    need = state.door_key[rows, dr]
    keys = torch.as_tensor(held_keys, device=need.device)
    keys = keys.expand((need.shape[0],) + tuple(keys.shape[-1:]))
    have = (need < 0) | (keys == need[:, None]).any(1)
    opened = is_door & ~was_open & have
    state = state._replace(door_open=_set(state.door_open, rows, dr,
                                          was_open | opened))
    events = events._replace(door=ev.push(
        events.door, a=dr, b=opener, c=opened.to(_I32),
        pos=state.pos[rows, dr], enabled=is_door & ~was_open))
    return state, opened, events


def activate_checkpoint(state: GameState, checkpoint, player,
                        events: ev.Events):
    """Checkpoint::is_activated; the respawn point is pos + offset."""
    rows, cp = _slots(state, checkpoint)
    is_cp = (state.alive[rows, cp]
             & (state.kind[rows, cp] == KIND_CHECKPOINT))
    active = state.checkpoint_active[rows, cp]
    state = state._replace(checkpoint_active=_set(
        state.checkpoint_active, rows, cp, active | is_cp))
    events = events._replace(checkpoint=ev.push(
        events.checkpoint, a=cp, b=player,
        pos=state.pos[rows, cp] + state.respawn_offset[rows, cp],
        enabled=is_cp & ~active))
    return state, events


def collect_item(state: GameState, item, collector, events: ev.Events):
    """ItemType semantics: a health pickup heals item_amount; keys land
    in the pickup queue (b carries key_type) for the inventory layer; a
    collected item despawns."""
    rows, it = _slots(state, item)
    kind = state.kind[rows, it]
    is_item = state.alive[rows, it] & ((kind == KIND_ITEM)
                                       | (kind == KIND_KEY))
    amount = state.item_amount[rows, it]
    state = heal(state, collector,
                 torch.where(is_item, amount, torch.zeros_like(amount)))
    events = events._replace(pickup=ev.push(
        events.pickup, a=it, b=state.key_type[rows, it], c=amount,
        pos=state.pos[rows, it], enabled=is_item))
    state = state._replace(alive=_set(state.alive, rows, it,
                                      state.alive[rows, it] & ~is_item))
    return state, events


# ---- Movement and transforms (runtime.rs:449-470) ----

def integrate_velocities(state: GameState, dt) -> GameState:
    """Plain velocity integration of the entities WITHOUT controllers
    (runtime.rs:449-460); controllers move through move_and_slide."""
    dt = torch.as_tensor(dt, dtype=_F32, device=state.pos.device)
    move = (state.alive & ~state.has_controller)[..., None]
    return state._replace(pos=torch.where(move, state.pos + state.vel * dt,
                                          state.pos))


def global_positions(state: GameState) -> torch.Tensor:
    """GlobalTransform pass (runtime.rs:464): one parent level deep, as
    the reference's single-pass update; (I, E, 3)."""
    has_parent = state.parent >= 0
    pidx = torch.clamp(state.parent, min=0).long()
    parent_pos = state.pos.gather(1, pidx[..., None].expand(-1, -1, 3))
    return torch.where(has_parent[..., None], parent_pos + state.pos,
                       state.pos)
