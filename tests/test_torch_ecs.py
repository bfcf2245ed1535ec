"""The port's entity functions, event queues and ECS systems
(game/state.py, game/events.py, game/systems.py), batched over
instances, against the JAX package's vmapped over the same stacked
states, on test_ecs.py's cases.  Each case is one script run by both
packages: the JAX functions under jax.vmap over I instances, the port's
on the batch; per-instance inputs (positions, amounts, masks, keys) make
the instances differ.  Every state field, event lane and returned value
must be equal (integers and floats alike), and the port's results must
show what test_ecs.py asserts of the JAX package's."""

import types as pytypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bonnie32_tpu.game import events as jev
from bonnie32_tpu.game import state as jst
from bonnie32_tpu.game import systems as jsys
from bonnie32_tpu_torch import interop
from bonnie32_tpu_torch.game import events as tev
from bonnie32_tpu_torch.game import state as tst
from bonnie32_tpu_torch.game import systems as tsys

torch.set_num_threads(1)

CAPACITY = 8


def jax_api():
    def set_field(s, name, e, val):
        arr = getattr(s, name)
        return s._replace(**{name: arr.at[e].set(jnp.asarray(val,
                                                             arr.dtype))})
    return pytypes.SimpleNamespace(
        st=jst, sys=jsys, ev=jev, new_events=jev.new_events,
        new_queue=jev.new_queue,
        vec=lambda *xs: jnp.stack([jnp.asarray(x, jnp.float32)
                                   for x in xs]),
        arange=lambda n: jnp.arange(n, dtype=jnp.int32),
        full=lambda n, v: jnp.full(n, v, jnp.int32),
        keys=lambda *k: jnp.asarray(k, jnp.int32), set_field=set_field,
        rows=lambda v, k: jnp.broadcast_to(v[None], (k,) + v.shape))


def port_api(n):
    def set_field(s, name, e, val):
        arr = getattr(s, name).clone()
        rows, e = tst._slots(s, e)
        arr[rows, e] = torch.as_tensor(val, dtype=arr.dtype)
        return s._replace(**{name: arr})
    return pytypes.SimpleNamespace(
        st=tst, sys=tsys, ev=tev,
        new_events=lambda c: tev.new_events(n, c, device="cpu"),
        new_queue=lambda c: tev.new_queue(n, c, device="cpu"),
        vec=lambda *xs: torch.stack([torch.as_tensor(
            x, dtype=torch.float32).expand(n) for x in xs], -1),
        arange=lambda k: torch.arange(k, dtype=torch.int32),
        full=lambda k, v: torch.full((k,), v, dtype=torch.int32),
        keys=lambda *k: torch.tensor(k, dtype=torch.int32),
        set_field=set_field,
        rows=lambda v, k: v[:, None].expand(-1, k, *v.shape[1:]))


def run_both(script, inputs):
    """`script(api, state, x)` run by both packages from an empty state
    (CAPACITY slots) of each of the I instances, x the per-instance
    inputs (a dict of (I, ...) numpy arrays).  Returns (JAX result with
    numpy leaves, the port's)."""
    n = len(next(iter(inputs.values())))
    jstate = jax.tree_util.tree_map(
        lambda v: jnp.stack([v] * n), jst.new_state(CAPACITY))
    jx = {k: jnp.asarray(v) for k, v in inputs.items()}
    theirs = jax.vmap(lambda s, x: script(jax_api(), s, x))(jstate, jx)
    theirs = jax.tree_util.tree_map(np.asarray, theirs)
    state = interop.stacked_game_state(
        jax.tree_util.tree_map(np.asarray, jst.new_state(CAPACITY)), n)
    ours = script(port_api(n), state,
                  {k: torch.from_numpy(v) for k, v in inputs.items()})
    return theirs, ours


def assert_equal(theirs, ours, path="result"):
    if isinstance(ours, torch.Tensor):
        a, b = ours.numpy(), np.asarray(theirs)
        assert a.shape == b.shape, (path, a.shape, b.shape)
        np.testing.assert_array_equal(a, b.astype(a.dtype), err_msg=path)
    elif hasattr(ours, "_fields"):
        for f in ours._fields:
            assert_equal(getattr(theirs, f), getattr(ours, f),
                         f"{path}.{f}")
    else:
        for i, (t, o) in enumerate(zip(theirs, ours)):
            assert_equal(t, o, f"{path}[{i}]")


def handles(m, s, x):
    """entity.rs:20 — stale handles die when the slot is reused."""
    s, e = m.st.spawn_enemy(s, m.vec(x["px"], 0.0, 0.0), hp=5)
    ref = m.st.entity_ref(s, e)
    alive0 = m.st.is_ref_alive(s, ref)
    s = m.st.despawn(s, e)
    alive1 = m.st.is_ref_alive(s, ref)
    s, e2 = m.st.spawn(s, m.st.KIND_ITEM, m.vec(1.0, x["px"], 0.0))
    alive2 = m.st.is_ref_alive(s, ref)
    alive3 = m.st.is_ref_alive(s, m.st.entity_ref(s, e2))
    s, door = m.st.spawn_door(s, m.vec(0.0, 0.0, x["px"]),
                              required_key=x["key"])
    s, cp = m.st.spawn_checkpoint(s, m.vec(x["px"], 1.0, 2.0))
    return s, (e, e2, door, cp), (alive0, alive1, alive2, alive3)


def queue_push_clear(m, s, x):
    q = m.new_queue(4)
    q = m.ev.push(q, a=7, b=8, c=9, pos=m.vec(1.0, 2.0, x["px"]))
    q = m.ev.push(q, a=1, enabled=x["flag"])
    q1 = m.ev.push(q, a=x["amount"])
    q = q1
    for i in range(5):
        q = m.ev.push(q, a=i)
    return q1, q, m.ev.clear(q)


def queue_push_many(m, s, x):
    q = m.new_queue(8)
    q = m.ev.push_many(q, x["mask"], a=m.arange(5), c=m.arange(5) * 10)
    q1 = m.ev.push_many(q, x["mask2"], a=m.full(5, 9))
    q2 = m.ev.push_many(q1, x["mask"], b=m.arange(5),
                        pos=m.rows(m.vec(x["px"], 0.0, 1.0), 5))
    return q, q1, q2


def damage(m, s, x):
    s, e = m.st.spawn_enemy(s, m.vec(0.0, 0.0, 0.0), hp=10)
    evs = m.new_events(8)
    s, died0, evs = m.sys.apply_damage(s, e, x["amount"], iframes=0.5,
                                       events=evs)
    s, died1, evs = m.sys.apply_damage(s, e, 4, events=evs)
    s = m.sys.tick_invincibility(s, 1.0)
    s, died2, evs = m.sys.apply_damage(s, e, 99, source=x["key"],
                                       events=evs)
    s = m.sys.heal(s, e, 1000)
    return s, evs, (died0, died1, died2)


def combat_teams(m, s, x):
    s, player = m.st.spawn(s, m.st.KIND_PLAYER, m.vec(0.0, 0.0, 0.0),
                           hp=20, team=m.st.TEAM_PLAYER, hurtbox_radius=1.0)
    s, enemy = m.st.spawn(s, m.st.KIND_ENEMY, m.vec(1.0, 0.0, 0.0), hp=20,
                          team=m.st.TEAM_ENEMY, hurtbox_radius=1.0)
    s, _ = m.st.spawn(s, m.st.KIND_PROJECTILE, m.vec(x["px"], 0.0, 0.0),
                      team=m.st.TEAM_ENEMY, hitbox_active=True,
                      hitbox_radius=0.6, hitbox_damage=5, owner=enemy)
    evs = m.new_events(8)
    s2, evs = m.sys.combat_system(s, evs, 1.0 / 60.0)
    s3, evs = m.sys.combat_system(s2, evs, 1.0 / 60.0)
    return s2, s3, evs, (player, enemy)


def combat_multiplier(m, s, x):
    s, victim = m.st.spawn(s, m.st.KIND_ENEMY, m.vec(0.0, 0.0, 0.0), hp=6,
                           team=m.st.TEAM_ENEMY, hurtbox_radius=1.0,
                           hurtbox_mult=x["mult"])
    s, _ = m.st.spawn(s, m.st.KIND_PROJECTILE, m.vec(0.2, 0.0, 0.0),
                      team=m.st.TEAM_PLAYER, hitbox_active=True,
                      hitbox_radius=0.5, hitbox_damage=3)
    s, _ = m.st.spawn(s, m.st.KIND_PROJECTILE, m.vec(x["px"], 0.0, 0.0),
                      team=m.st.TEAM_NEUTRAL, hitbox_active=True,
                      hitbox_radius=0.5, hitbox_damage=2)
    evs = m.new_events(8)
    s, evs = m.sys.combat_system(s, evs, 1.0 / 60.0)
    return s, evs, victim


def doors(m, s, x):
    s, door = m.st.spawn_door(s, m.vec(0.0, 0.0, 0.0), required_key=3)
    evs = m.new_events(8)
    s, opened0, evs = m.sys.try_open_door(s, door, 0, m.keys(-1, -1, -1, -1),
                                          evs)
    s, opened1, evs = m.sys.try_open_door(s, door, 0, x["keys"], evs)
    s, opened2, evs = m.sys.try_open_door(s, door, 0, m.keys(3, -1, -1, -1),
                                          evs)
    s, opened3, evs = m.sys.try_open_door(s, door, 0, m.keys(3, -1, -1, -1),
                                          evs)
    s, door2 = m.st.spawn_door(s, m.vec(1.0, 0.0, 0.0))
    s, opened4, evs = m.sys.try_open_door(s, door2, 0,
                                          m.keys(-1, -1, -1, -1), evs)
    return s, evs, (opened0, opened1, opened2, opened3, opened4)


def checkpoint_items(m, s, x):
    s, cp = m.st.spawn_checkpoint(s, m.vec(5.0, 0.0, x["px"]))
    s, player = m.st.spawn(s, m.st.KIND_PLAYER, m.vec(0.0, 0.0, 0.0), hp=10)
    s = m.set_field(s, "hp", player, 4)
    evs = m.new_events(8)
    s, evs = m.sys.activate_checkpoint(s, cp, player, evs)
    s, evs = m.sys.activate_checkpoint(s, cp, player, evs)
    s, potion = m.st.spawn(s, m.st.KIND_ITEM, m.vec(0.0, 0.0, 0.0),
                           item_amount=x["amount"])
    s, key = m.st.spawn(s, m.st.KIND_KEY, m.vec(0.0, 1.0, 0.0),
                        key_type=x["key"])
    s, evs = m.sys.collect_item(s, potion, player, evs)
    s, evs = m.sys.collect_item(s, key, player, evs)
    s, evs = m.sys.collect_item(s, key, player, evs)      # gone
    return s, evs, m.ev.clear_all(evs), (cp, player, potion)


def projectile_parenting(m, s, x):
    s, owner = m.st.spawn_enemy(s, m.vec(0.0, 0.0, 0.0), hp=5)
    s, proj = m.st.spawn_projectile(s, m.vec(0.0, 0.0, 0.0),
                                    m.vec(x["px"], 0.0, 0.0), 3, owner,
                                    team=m.st.TEAM_ENEMY)
    s2 = m.sys.integrate_velocities(s, 0.5)
    s2 = m.set_field(s2, "parent", proj, owner)
    s2 = m.set_field(s2, "pos", owner, m.vec(10.0, 0.0, x["px"]))
    return s, s2, m.sys.global_positions(s2), (owner, proj)


def vmap_case(m, s, x):
    """test_systems_vmap_over_instances: one instance hit, one missed."""
    s, _ = m.st.spawn(s, m.st.KIND_PLAYER, m.vec(0.0, 0.0, 0.0), hp=10,
                      team=m.st.TEAM_PLAYER, hurtbox_radius=1.0)
    s, _ = m.st.spawn(s, m.st.KIND_PROJECTILE, m.vec(x["px"], 0.0, 0.0),
                      team=m.st.TEAM_ENEMY, hitbox_active=True,
                      hitbox_radius=0.5, hitbox_damage=4)
    evs = m.new_events(4)
    s, evs = m.sys.combat_system(s, evs, 1.0 / 60.0)
    return s, evs


F = np.float32
I32 = np.int32
CASES = {
    "handles": (handles, dict(px=F([0.0, 2.0, 3.5]), key=I32([-1, 3, 5]))),
    "queue_push_clear": (queue_push_clear, dict(
        px=F([3.0, -1.0]), flag=np.array([False, True]),
        amount=I32([2, 6]))),
    "queue_push_many": (queue_push_many, dict(
        px=F([0.5, 1.5, 2.5, 3.5]),
        mask=np.array([[0, 1, 0, 1, 1], [1, 1, 1, 1, 1], [0, 0, 0, 0, 0],
                       [1, 0, 0, 0, 1]], bool),
        mask2=np.array([[1, 0, 0, 0, 0], [1, 1, 0, 0, 0], [0, 0, 0, 0, 1],
                        [1, 1, 1, 1, 1]], bool))),
    "damage": (damage, dict(amount=I32([4, 10, 0]), key=I32([7, -1, 2]))),
    "combat_teams": (combat_teams, dict(px=F([0.5, 3.0, 1.2]))),
    "combat_multiplier": (combat_multiplier, dict(
        mult=F([2.0, 1.5, 0.5]), px=F([0.1, 9.0, -0.3]))),
    "doors": (doors, dict(keys=np.array([[-1, -1, -1, -1], [3, -1, -1, -1],
                                         [1, 2, 3, 4]], I32))),
    "checkpoint_items": (checkpoint_items, dict(
        px=F([5.0, -2.0]), amount=I32([5, 100]), key=I32([2, 9]))),
    "projectile_parenting": (projectile_parenting, dict(
        px=F([2.0, -4.0, 0.25]))),
    "vmap": (vmap_case, dict(px=F([0.2, 5.0]))),
}


@pytest.fixture(scope="module")
def results():
    return {name: run_both(script, inputs)
            for name, (script, inputs) in CASES.items()}


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_matches_jax_vmapped(results, name):
    theirs, ours = results[name]
    assert_equal(theirs, ours)


def test_generational_handles(results):
    _, (s, (e, e2, door, cp), alive) = results["handles"]
    assert alive[0].all() and not alive[1].any()
    assert torch.equal(e2, e)                     # lowest free slot reused
    assert not alive[2].any() and alive[3].all()
    assert (s.door_key[torch.arange(3), door] == torch.tensor(
        [-1, 3, 5])).all()
    assert (s.respawn_offset[torch.arange(3), cp]
            == torch.tensor([0.0, 1.0, 0.0])).all()


def test_event_queue_push_clear(results):
    _, (q1, q, cleared) = results["queue_push_clear"]
    assert q1.count.tolist() == [2, 3]
    assert q1.a[0, :2].tolist() == [7, 2] and q1.a[1, :3].tolist() == [7, 1,
                                                                       6]
    assert q1.pos[0, 0].tolist() == [1.0, 2.0, 3.0]
    assert q.count.tolist() == [4, 4] and q.dropped.tolist() == [3, 4]
    assert cleared.count.tolist() == [0, 0]
    assert cleared.dropped.tolist() == [0, 0]


def test_event_queue_push_many(results):
    _, (q, q1, q2) = results["queue_push_many"]
    assert q.count.tolist() == [3, 5, 0, 2]
    assert q.a[0, :3].tolist() == [1, 3, 4]       # original order kept
    assert q.c[0, :3].tolist() == [10, 30, 40]
    assert q1.count.tolist() == [4, 7, 1, 7]
    assert int(q1.a[0, 3]) == 9
    assert q2.count.tolist() == [7, 8, 1, 8]
    assert q2.dropped.tolist() == [0, 4, 0, 1]


def test_damage_iframes_death(results):
    _, (s, evs, died) = results["damage"]
    # amount 10 kills at the first hit; a dead entity does not die again
    assert died[0].tolist() == [False, True, False]
    assert not died[1].any()                       # i-frames
    assert died[2].tolist() == [True, False, True]
    assert s.hp[:, 0].tolist() == [10, 10, 10]     # healed back to max
    assert evs.damage.count.tolist() == [2, 2, 2]
    assert evs.death.count.tolist() == [1, 1, 1]


def test_combat_team_filtering(results):
    _, (s2, s3, evs, (player, enemy)) = results["combat_teams"]
    rows = torch.arange(3)
    # sword at 0.5 and 1.2 reaches the player, at 3.0 does not
    assert s2.hp[rows, player].tolist() == [15, 20, 15]
    assert s2.hp[rows, enemy].tolist() == [20, 20, 20]
    assert s3.hp[rows, player].tolist() == [15, 20, 15]   # i-frames
    assert evs.damage.b[:, 0].tolist() == [1, 0, 1]       # the owner


def test_combat_multiplier_and_death(results):
    _, (s, evs, victim) = results["combat_multiplier"]
    rows = torch.arange(3)
    # trunc(3 x mult) + trunc(2 x mult) where the neutral one reaches
    assert s.hp[rows, victim].tolist() == [0, 2, 4]
    assert evs.death.count.tolist() == [1, 0, 0]
    assert s.ai_state[rows, victim].tolist() == [tst.AI_DEAD, 0, 0]


def test_doors_and_keys(results):
    _, (s, evs, opened) = results["doors"]
    assert not opened[0].any()
    assert opened[1].tolist() == [False, True, True]
    assert opened[2].tolist() == [True, False, False]
    assert not opened[3].any() and opened[4].all()
    assert evs.door.count.tolist() == [4, 3, 3]


def test_checkpoint_and_items(results):
    _, (s, evs, cleared, (cp, player, potion)) = results["checkpoint_items"]
    rows = torch.arange(2)
    assert s.checkpoint_active[rows, cp].all()
    assert evs.checkpoint.count.tolist() == [1, 1]
    assert evs.checkpoint.pos[:, 0].tolist() == [[5.0, 1.0, 5.0],
                                                 [5.0, 1.0, -2.0]]
    assert s.hp[rows, player].tolist() == [9, 10]
    assert not s.alive[rows, potion].any()
    assert evs.pickup.count.tolist() == [2, 2]
    assert evs.pickup.b[:, 1].tolist() == [2, 9]
    assert cleared.pickup.count.tolist() == [0, 0]


def test_projectile_and_parenting(results):
    _, (s, s2, gp, (owner, proj)) = results["projectile_parenting"]
    rows = torch.arange(3)
    assert (s.owner[rows, proj] == owner).all()
    assert s2.pos[rows, proj, 0].tolist() == [1.0, -2.0, 0.125]
    assert gp[rows, proj, 0].tolist() == [11.0, 8.0, 10.125]


def test_systems_batch_over_instances(results):
    _, (s, evs) = results["vmap"]
    assert s.hp[:, 0].tolist() == [6, 10]
    assert evs.damage.count.tolist() == [1, 0]


def test_carried_state_and_events_continue_like_jax(results):
    """The JAX package's vmapped state and events after the team-filter
    case, carried across by interop.game_state / interop.events: one
    more combat pass and a door attempt on the port equal the JAX
    package's on its own arrays."""
    (s2, s3, evs, (player, enemy)), _ = results["combat_teams"]

    def step(api, s, e, who):
        s, e = api.sys.combat_system(s, e, 1.0 / 60.0, iframes=0.25)
        s, opened, e = api.sys.try_open_door(s, who, 0,
                                             api.keys(3, -1, -1, -1), e)
        return s, e, opened

    jarr = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    theirs = jax.vmap(lambda s, e, w: step(jax_api(), s, e, w))(
        jarr(s3), jarr(evs), jnp.asarray(enemy))
    ours = step(port_api(len(enemy)), interop.game_state(s3),
                interop.events(evs), torch.from_numpy(np.array(enemy)))
    assert_equal(jax.tree_util.tree_map(np.asarray, theirs), ours)
    assert ours[1].damage.count.tolist() == evs.damage.count.tolist()
