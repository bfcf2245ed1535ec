"""The port's sector collision vs the host level model, the scalar golden
model (tests/golden/collision_golden.py) and the JAX package, on the
Cave-size level of tests/torch_scenes.py.

Tolerances, as tests/test_game.py holds the JAX package: floor and
ceiling heights to rtol 1e-6 / atol 1e-3 against the host's f32 scalar
code; a 120-step walk to atol 0.5 units against the golden model, with
grounded and room exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_scenes as ts
from bonnie32_tpu.game import collision as jcol
from bonnie32_tpu.models import level as JL
from bonnie32_tpu_torch.models import level as TL
from bonnie32_tpu_torch.game import collision as tcol
from golden import collision_golden as gold


@pytest.fixture(scope="module")
def level():
    lv = ts.cave_size_level(TL)
    return lv, tcol.compile_collision(lv, device="cpu")


def _points(lv, n, seed):
    r0 = lv.rooms[0]
    lo = np.asarray(r0.position) + np.asarray(r0.bounds_min)
    hi = np.asarray(r0.position) + np.asarray(r0.bounds_max)
    rng = np.random.default_rng(seed)
    return rng.uniform(lo - 500, hi + 500, (n, 3)).astype(np.float32)


def test_floor_info_matches_host_level(level):
    lv, grid = level
    pts = _points(lv, 500, 0)
    q = tcol.get_floor_info(grid, torch.from_numpy(pts),
                            torch.full((500,), -1, dtype=torch.int32))
    hits = 0
    for i, p in enumerate(pts):
        fi = lv.get_floor_info(p)
        if fi is None:
            assert not bool(q.found[i]), (i, p)
            continue
        hits += 1
        assert bool(q.found[i]) and int(q.room[i]) == fi.room
        np.testing.assert_allclose(float(q.floor[i]), fi.floor,
                                   rtol=1e-6, atol=1e-3)
        np.testing.assert_allclose(float(q.ceiling[i]), fi.ceiling,
                                   rtol=1e-6, atol=1e-3)
    assert 0 < hits < 500


def test_floor_info_matches_jax(level):
    lv, grid = level
    jgrid = jcol.compile_collision(ts.cave_size_level(JL))
    pts = _points(lv, 500, 1)
    hint = np.where(np.arange(500) % 3 == 0, 0, -1).astype(np.int32)
    q = tcol.get_floor_info(grid, torch.from_numpy(pts),
                            torch.from_numpy(hint))
    jq = jax.vmap(lambda p, h: jcol.get_floor_info(jgrid, p, h))(
        jnp.asarray(pts), jnp.asarray(hint))
    np.testing.assert_array_equal(q.found.numpy(), np.asarray(jq.found))
    np.testing.assert_array_equal(q.room.numpy(), np.asarray(jq.room))
    np.testing.assert_allclose(q.floor.numpy(), np.asarray(jq.floor),
                               rtol=1e-6, atol=1e-3)
    np.testing.assert_allclose(q.ceiling.numpy(), np.asarray(jq.ceiling),
                               rtol=1e-6, atol=1e-3)


def test_room_lookup_across_two_rooms():
    """find_room_at with hints on a two-room level, against the host."""
    lv = ts.two_room_level(TL)
    grid = tcol.compile_collision(lv, device="cpu")
    pts = np.concatenate([_points(lv, 200, 2),
                          _points(lv, 200, 3) + np.float32([0, 0, 10240])])
    pts = pts.astype(np.float32)
    hints = np.random.default_rng(4).integers(-1, 2, len(pts)).astype(
        np.int32)
    q = tcol.get_floor_info(grid, torch.from_numpy(pts),
                            torch.from_numpy(hints))
    rooms = set()
    for i, p in enumerate(pts):
        fi = lv.get_floor_info(p, int(hints[i]) if hints[i] >= 0 else None)
        assert bool(q.found[i]) == (fi is not None), (i, p)
        if fi is not None:
            rooms.add(fi.room)
            assert int(q.room[i]) == fi.room
            np.testing.assert_allclose(float(q.floor[i]), fi.floor,
                                       rtol=1e-6, atol=1e-3)
    assert rooms == {0, 1}


def test_move_and_slide_matches_golden_walk(level):
    """Four batched walkers against four scalar golden walks."""
    lv, grid = level
    s = lv.player_settings
    n, dt = 4, 1.0 / 60.0
    rng = np.random.default_rng(1)
    start = np.asarray(ts.spawn_point(lv), np.float32)
    pos = np.repeat(start[None], n, 0)
    gstate = [dict(position=tuple(float(x) for x in pos[i]), grounded=False,
                   room=0, vertical_velocity=0.0) for i in range(n)]
    tpos = torch.from_numpy(pos)
    tgr = torch.zeros(n, dtype=torch.bool)
    troom = torch.zeros(n, dtype=torch.int32)
    tvv = torch.zeros(n, dtype=torch.float32)
    f = lambda v: torch.full((n,), np.float32(v))  # noqa: E731
    walled = 0
    for step in range(120):
        ang = rng.uniform(0, 2 * np.pi, n)
        speed = rng.choice([0.0, s.walk_speed, s.run_speed], n)
        vel = np.stack([np.sin(ang) * speed, np.zeros(n),
                        np.cos(ang) * speed], -1).astype(np.float32)
        for i in range(n):
            gstate[i] = gold.move_and_slide(
                lv, gstate[i]["position"], vel[i], s.radius, s.height,
                s.step_height, gstate[i]["grounded"], gstate[i]["room"],
                gstate[i]["vertical_velocity"], s.gravity, dt)
            walled += gstate[i]["hit_wall"]
        tpos, tgr, troom, tvv = tcol.move_and_slide(
            grid, tpos, torch.from_numpy(vel), f(s.radius), f(s.height),
            f(s.step_height), tgr, troom, tvv,
            torch.tensor(np.float32(s.gravity)),
            torch.tensor(np.float32(dt)))
        for i in range(n):
            np.testing.assert_allclose(
                tpos[i].numpy(), np.asarray(gstate[i]["position"],
                                            np.float32),
                atol=0.5, err_msg=f"walker {i} step {step}")
            assert bool(tgr[i]) == gstate[i]["grounded"], (i, step)
            assert int(troom[i]) == gstate[i]["room"], (i, step)
    assert walled > 0, "the walk should reach a wall"
