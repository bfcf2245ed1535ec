"""A Cave-size level built in code, shared by the port's tests and
chip_smoke.py.  Imports no jax: every builder takes the level module as
an argument, so the JAX tests build the identical Level from
`bonnie32_tpu.models.level` and the port from
`bonnie32_tpu_torch._host.models.level`.

The sample levels are not in the repository, so this stands in for Cave
(290 faces, 64x64 textures): one 8x8-sector room over rolling terrain
with a flat ceiling, perimeter walls and two interior wall pieces —
8*8*2 floor + 8*8*2 ceiling + 32*2 perimeter + 4*2 interior = 328 faces,
all opaque; two of the four 64x64 checker textures carry black texels,
so keyed faces occur.
"""

import math

import numpy as np

ROOM = 8              # sectors per side
CEILING = 4096.0
TEX = 64
TEXTURE_NAMES = ("FLOOR", "WALL", "CEIL", "PILLAR")


def checker_texture15(w=32, h=32, c1=0x7FFF, c2=0x0C63, block=4,
                      with_black=False):
    """A Color15 checkerboard, optionally with drawable-black texels
    (tests/scenes.py's, without its jax imports)."""
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    pix = np.where(((xs // block) + (ys // block)) % 2 == 0, c1,
                   c2).astype(np.uint16)
    if with_black:
        pix[1::7, 1::5] = 0x8000
    return pix, 0


def textures():
    """Four 64x64 textures (pixels, blend); FLOOR and PILLAR have black
    texels."""
    return [checker_texture15(TEX, TEX, c1=0x7FFF, c2=0x0C63, block=8,
                              with_black=True),
            checker_texture15(TEX, TEX, c1=0x5294, c2=0x2108, block=16),
            checker_texture15(TEX, TEX, c1=0x3DEF, c2=0x1CE7, block=4),
            checker_texture15(TEX, TEX, c1=0x7C1F, c2=0x03E0, block=8,
                              with_black=True)]


def resolver(ref):
    """TextureRef -> (texture id, width), as texture_pack.make_resolver."""
    return (TEXTURE_NAMES.index(ref.name) if ref.name in TEXTURE_NAMES
            else 0, TEX)


def _terrain(x, z):
    return float(np.float32(
        256.0 * (math.sin(0.9 * x) + math.cos(0.7 * z)) + 512.0))


def cave_size_level(L):
    """The level, built with level module `L`."""
    level = L.Level()
    room = L.Room.new(0, (0.0, 0.0, 0.0), ROOM, ROOM)
    tex = {n: L.TextureRef("torch-scenes", n) for n in TEXTURE_NAMES}
    for x in range(ROOM):
        for z in range(ROOM):
            sec = room.ensure_sector(x, z)
            sec.floor = L.HorizontalFace(
                heights=[_terrain(x, z), _terrain(x + 1, z),
                         _terrain(x + 1, z + 1), _terrain(x, z + 1)],
                texture=tex["FLOOR"], split_direction=(x + z) % 2)
            sec.ceiling = L.HorizontalFace.flat(CEILING, tex["CEIL"])
    for i in range(ROOM):
        room.add_wall(i, 0, L.NORTH, 0.0, CEILING, tex["WALL"])
        room.add_wall(ROOM - 1, i, L.EAST, 0.0, CEILING, tex["WALL"])
        room.add_wall(i, ROOM - 1, L.SOUTH, 0.0, CEILING, tex["WALL"])
        room.add_wall(0, i, L.WEST, 0.0, CEILING, tex["WALL"])
    for x, z, d in ((3, 3, L.NORTH), (3, 3, L.EAST), (5, 4, L.SOUTH),
                    (2, 5, L.WEST)):
        room.add_wall(x, z, d, 0.0, CEILING * 0.75, tex["PILLAR"])
    room.recalculate_bounds()
    level.add_room(room)
    return level


def two_room_level(L):
    """The Cave-size room plus a fogged 4x4 room beside it, with its own
    ambient: 328 + 96 faces in two draw groups, for the per-room fog,
    ambient and room-lookup paths."""
    level = cave_size_level(L)
    room = L.Room.new(1, (0.0, 0.0, 10240.0), 4, 4)
    room.ambient = 0.8
    room.fog = L.RoomFog(enabled=True, color=(0.3, 0.2, 0.1), start=1500.0,
                         falloff=5000.0, cull_offset=2000.0)
    floor = L.TextureRef("torch-scenes", "PILLAR")
    wall = L.TextureRef("torch-scenes", "WALL")
    for x in range(4):
        for z in range(4):
            room.set_floor(x, z, 0.0, floor)
            room.set_ceiling(x, z, 3072.0, floor)
    for i in range(4):
        room.add_wall(i, 0, L.NORTH, 0.0, 3072.0, wall)
        room.add_wall(3, i, L.EAST, 0.0, 3072.0, wall)
        room.add_wall(i, 3, L.SOUTH, 0.0, 3072.0, wall)
        room.add_wall(0, i, L.WEST, 0.0, 3072.0, wall)
    room.recalculate_bounds()
    level.add_room(room)
    return level


def spawn_point(level):
    """First floored sector's centre, 10 units above the floor (as
    rollout.demo_env)."""
    r0 = level.rooms[0]
    for x, z, s in r0.iter_sectors():
        if s.floor is not None:
            px = float(r0.position[0]) + (x + 0.5) * 1024.0
            pz = float(r0.position[2]) + (z + 0.5) * 1024.0
            fi = level.get_floor_info((px, 0.0, pz))
            return (px, fi.floor + 10.0, pz)
    raise ValueError("level has no floor")


def actions_np(rng, n):
    """Numpy-seeded datagen actions as a dict of arrays, for both sides."""
    ang = rng.uniform(0, 2 * np.pi, n).astype(np.float32)
    return dict(move_x=np.sin(ang), move_y=np.cos(ang),
                cam_x=rng.uniform(-1, 1, n).astype(np.float32),
                cam_y=np.zeros(n, np.float32),
                sprint=rng.random(n) < 0.3, jump=rng.random(n) < 0.05)
