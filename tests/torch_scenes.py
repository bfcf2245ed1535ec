"""Scenes built in code, shared by the port's tests and chip_smoke.py.
Imports no jax: every level builder takes the level module as an
argument, so a JAX test builds the identical Level from the JAX package's
`models/level.py` and the port from `bonnie32_tpu_torch/models/level.py`
(its own copy of that module).

The sample levels are not in the repository, so this stands in for Cave
(290 faces, 64x64 textures): one 8x8-sector room over rolling terrain
with a flat ceiling, perimeter walls and four interior wall pieces —
8*8*2 floor + 8*8*2 ceiling + 32*2 perimeter + 4*2 interior = 328 faces,
all opaque; two of the four 64x64 checker textures carry black texels,
so keyed faces occur.  `transparent_cave_level` glazes 20 of those faces
with the PS1 blend modes, `transparent_two_room_level` glazes 8 faces of
the second room only (the kernel route draws it),
`transparent_first_room_level` 6 faces of the first (the sequential
renderer draws it), and `cube_scene` is tests/scenes.py's cube.
`ortho_settings` puts game settings under an orthographic view.

`asset_level` places an asset of `asset_library` (two mesh parts, one
double-sided with a user texture from `user_textures`, one with an
embedded atlas, and a Light component) twice in the Cave-size level.

`open_air_level` is the same room under a sky: no ceiling, the perimeter
walls lowered to OPEN_WALL, so that a third or more of a typical frame is
sky, and `level.skybox` set from `sky_config` (the skybox module is an
argument too, like the level module: each package parses the RON dict of
its own Skybox class).  `transparent_open_air_level` glazes it like
`transparent_cave_level`; with the night sky's stars that level takes the
sky-buffer route.

Audio: `build_sf2(S, ...)` and `sine_font(S)` write a SoundFont in memory
(a jax-free copy of tests/golden/sf2_fixture.py, taking the sf2 module
`S` for its generator opcodes); `demo_song(M, ...)` builds a tracker song
from the song module `M`: one channel per oscillator family and more,
seeded notes, a reverb preset and channel 0's sample rate.
"""

import math
import struct

import numpy as np

ROOM = 8              # sectors per side
CEILING = 4096.0
TEX = 64
TEXTURE_NAMES = ("FLOOR", "WALL", "CEIL", "PILLAR",
                 "GLASS", "GLOW", "SMOKE", "TINT", "VEIL")
# BlendMode codes (config.BlendMode)
OPAQUE, AVERAGE, ADD, SUBTRACT, ADD_QUARTER, ERASE = range(6)


def checker_texture15(w=32, h=32, c1=0x7FFF, c2=0x0C63, block=4,
                      with_black=False, with_transparent=False,
                      blend_mode=OPAQUE):
    """A Color15 checkerboard, optionally with drawable-black (0x8000) or
    transparent (0x0000) texels (tests/scenes.py's, without its jax
    imports).  Returns (pixels, blend_mode)."""
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    pix = np.where(((xs // block) + (ys // block)) % 2 == 0, c1,
                   c2).astype(np.uint16)
    if with_black:
        pix[1::7, 1::5] = 0x8000
    if with_transparent:
        pix[3::8, 2::6] = 0x0000
    return pix, blend_mode


def textures():
    """Four 64x64 textures (pixels, blend); FLOOR and PILLAR have black
    texels."""
    return [checker_texture15(TEX, TEX, c1=0x7FFF, c2=0x0C63, block=8,
                              with_black=True),
            checker_texture15(TEX, TEX, c1=0x5294, c2=0x2108, block=16),
            checker_texture15(TEX, TEX, c1=0x3DEF, c2=0x1CE7, block=4),
            checker_texture15(TEX, TEX, c1=0x7C1F, c2=0x03E0, block=8,
                              with_black=True)]


def transparent_textures():
    """textures() plus five 64x64 textures with their own blend mode, one
    of each non-opaque mode; their first checker colour has the STP bit
    (0x8000), so those texels blend and the others draw opaque.  GLASS
    carries drawable-black texels and VEIL transparent ones: both key out
    on black-transparent faces."""
    return textures() + [
        checker_texture15(TEX, TEX, c1=0xBDEF, c2=0x2D6B, block=8,
                          with_black=True, blend_mode=AVERAGE),
        checker_texture15(TEX, TEX, c1=0x83FF, c2=0x0210, block=4,
                          blend_mode=ADD),
        checker_texture15(TEX, TEX, c1=0xA529, c2=0x1084, block=16,
                          blend_mode=SUBTRACT),
        checker_texture15(TEX, TEX, c1=0xFC00, c2=0x4000, block=8,
                          blend_mode=ADD_QUARTER),
        checker_texture15(TEX, TEX, c1=0x801F, c2=0x0010, block=8,
                          with_transparent=True, blend_mode=ERASE)]


def resolver(ref):
    """TextureRef -> (texture id, width), as texture_pack.make_resolver."""
    return (TEXTURE_NAMES.index(ref.name) if ref.name in TEXTURE_NAMES
            else 0, TEX)


def _terrain(x, z):
    return float(np.float32(
        256.0 * (math.sin(0.9 * x) + math.cos(0.7 * z)) + 512.0))


OPEN_WALL = 1536.0    # perimeter wall top of the open-air level


def sky_config(S, name="night"):
    """A Skybox of skybox module `S`.  "night": the night preset (one
    mountain range, moon, haze, 150 twinkling stars) with the star size
    raised from 1.8 to 3.0, so that all nine offsets of a sparkle draw
    (at 1.8 only its centre does).  "sunset": the sunset preset (tint,
    sun, haze, two cloud layers, one mountain range, no stars) plus a
    second mountain range, so that every branch of the sky function and
    both range slots run; "sunset_preset" is the preset as it is (the
    JAX kernel's interpret-mode compile time grows with the number of
    mountain faces, so its references use this one)."""
    import dataclasses
    if name == "night":
        sb = S.Skybox.preset_night()
        return dataclasses.replace(
            sb, stars=dataclasses.replace(sb.stars, size=3.0))
    if name == "sunset_preset":
        return S.Skybox.preset_sunset()
    if name == "sunset":
        sb = S.Skybox.preset_sunset()
        return dataclasses.replace(sb, mountain_ranges=[
            sb.mountain_ranges[0],
            S.MountainRange((150, 110, 150), (70, 50, 90), (230, 180, 190),
                            0.22, 0.3, 0.7, 77777)])
    raise ValueError(f"unknown sky {name!r}")


def repeated_sky_faces(sky, k):
    """The port's SkyTables `sky` with its mountain faces k times over in
    draw order, copy j with its corner colours rotated by j corners (so
    that the order in which a pixel's covering copies are drawn shows),
    and its scalar table widened to hold them: a face list longer than
    one round of the sky kernels' cull."""
    nf = sky.face_table.shape[0]
    ft = sky.face_table.repeat(k, 1)
    for j in range(1, k):
        rows = ft[j * nf:(j + 1) * nf]
        rows[:, 3:] = rows[:, 3:].roll(3 * j, dims=1)
    v = max(sky.mtn_dirs.shape[0], k * nf, 10)
    return sky._replace(face_table=ft.contiguous(),
                        vpad=max(8, -(-v // 8) * 8))


def open_air_level(L, S, sky="night"):
    """The Cave-size level without its ceiling and with the perimeter
    walls lowered, under the sky `sky_config(S, sky)`."""
    level = cave_size_level(L, ceiling=False, wall_top=OPEN_WALL)
    level.skybox = sky_config(S, sky).to_ron()
    return level


def transparent_open_air_level(L, S, sky="night"):
    """The open-air level with transparent_cave_level's 20 glazed
    faces.  Render with transparent_textures()."""
    level = transparent_cave_level(L, ceiling=False, wall_top=OPEN_WALL)
    level.skybox = sky_config(S, sky).to_ron()
    return level


def cave_size_level(L, ceiling=True, wall_top=CEILING):
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
            if ceiling:
                sec.ceiling = L.HorizontalFace.flat(CEILING, tex["CEIL"])
    for i in range(ROOM):
        room.add_wall(i, 0, L.NORTH, 0.0, wall_top, tex["WALL"])
        room.add_wall(ROOM - 1, i, L.EAST, 0.0, wall_top, tex["WALL"])
        room.add_wall(i, ROOM - 1, L.SOUTH, 0.0, wall_top, tex["WALL"])
        room.add_wall(0, i, L.WEST, 0.0, wall_top, tex["WALL"])
    for x, z, d in ((3, 3, L.NORTH), (3, 3, L.EAST), (5, 4, L.SOUTH),
                    (2, 5, L.WEST)):
        room.add_wall(x, z, d, 0.0, CEILING * 0.75, tex["PILLAR"])
    room.recalculate_bounds()
    level.add_room(room)
    return level


def _glaze(L, face, name, blend):
    """Give a level face a transparent texture and the face blend mode."""
    face.texture = L.TextureRef("torch-scenes", name)
    face.blend_mode = blend


def transparent_cave_level(L, **kw):
    """The Cave-size level (`kw` to cave_size_level) with 20 transparent
    faces: the four interior
    wall pieces (GLASS, GLOW, SMOKE, TINT) and a 3x2 pool of floor
    sectors beside the spawn point, one per blend mode (VEIL, GLASS,
    GLOW, SMOKE, TINT) plus the opaque FLOOR texture under an AVERAGE face
    blend, transparent by the face flag alone.  Render with
    transparent_textures()."""
    level = cave_size_level(L, **kw)
    room = level.rooms[0]
    for (x, z, d), name in zip(((3, 3, L.NORTH), (3, 3, L.EAST),
                                (5, 4, L.SOUTH), (2, 5, L.WEST)),
                               ("GLASS", "GLOW", "SMOKE", "TINT")):
        wall = room.get_sector(x, z).walls(d)[-1]
        _glaze(L, wall, name, TEXTURE_BLENDS[name])
    for (x, z), name in zip(((1, 1), (2, 1), (3, 1), (1, 2), (2, 2)),
                            ("VEIL", "GLASS", "GLOW", "SMOKE", "TINT")):
        _glaze(L, room.get_sector(x, z).floor, name, TEXTURE_BLENDS[name])
    room.get_sector(3, 2).floor.blend_mode = AVERAGE
    return level


TEXTURE_BLENDS = {"GLASS": AVERAGE, "GLOW": ADD, "SMOKE": SUBTRACT,
                  "TINT": ADD_QUARTER, "VEIL": ERASE}


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


def transparent_two_room_level(L):
    """The two-room level with 8 transparent faces, all in the second
    room (the last draw group): a 2x2 patch of its floor.  Render with
    transparent_textures()."""
    level = two_room_level(L)
    room = level.rooms[1]
    for (x, z), name in zip(((1, 1), (2, 1), (1, 2), (2, 2)),
                            ("GLASS", "GLOW", "VEIL", "SMOKE")):
        _glaze(L, room.get_sector(x, z).floor, name, TEXTURE_BLENDS[name])
    return level


def transparent_first_room_level(L):
    """The two-room level with 6 transparent faces in its first room (a
    draw group before the last): a 2x2 pool of its floor and two of its
    interior wall pieces, so that the reference composites them before
    the second room draws.  Render with transparent_textures()."""
    level = two_room_level(L)
    room = level.rooms[0]
    for (x, z), name in zip(((1, 1), (2, 1), (1, 2), (2, 2)),
                            ("GLASS", "GLOW", "VEIL", "SMOKE")):
        _glaze(L, room.get_sector(x, z).floor, name, TEXTURE_BLENDS[name])
    for (x, z, d), name in zip(((3, 3, L.NORTH), (5, 4, L.SOUTH)),
                               ("TINT", "GLASS")):
        _glaze(L, room.get_sector(x, z).walls(d)[-1], name,
               TEXTURE_BLENDS[name])
    return level


def ortho_settings(C, zoom=0.05, center_x=0.0, center_y=0.0, **kw):
    """Game settings of config module `C` under an orthographic view
    (the editor's ortho views, math.rs:140): `zoom` pixels a world unit
    (0.05 shows about 6,400 units of a level across 320 pixels), centred
    on (center_x, center_y) of camera space."""
    return C.RasterSettings.game(ortho_projection=C.OrthoProjection(
        zoom=zoom, center_x=center_x, center_y=center_y), **kw)


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


def write_png_pack(pack_dir, names=TEXTURE_NAMES, texs=None):
    """Write `texs` (default: textures()) as PNGs `<name>.png` into
    `pack_dir`: Color15 -> RGBA8 (5-bit channels shifted up), the
    transparent word 0x0000 at alpha 0; the STP bit is lost, so a
    drawable-black 0x8000 texel loads back transparent.  Needs Pillow."""
    import os
    from PIL import Image
    os.makedirs(pack_dir, exist_ok=True)
    for name, (pix, _) in zip(names, texs or textures()):
        c = pix.astype(np.uint16)
        rgba = np.stack([((c >> 10) & 31) << 3, ((c >> 5) & 31) << 3,
                         (c & 31) << 3,
                         np.where(c == 0, 0, 255)], -1).astype(np.uint8)
        Image.fromarray(rgba, "RGBA").save(
            os.path.join(pack_dir, f"{name}.png"))


def write_demo_files(L, root, names=TEXTURE_NAMES[:4]):
    """cave_size_level saved with level module `L`'s save_level as
    `root`/Cave.ron and a pack `root`/packs/torch-scenes of the textures
    `names` (write_png_pack): the files rollout.demo_env reads.  Returns
    (level path, packs root)."""
    import os
    os.makedirs(root, exist_ok=True)
    level_path = os.path.join(root, "Cave.ron")
    L.save_level(cave_size_level(L), level_path)
    packs = os.path.join(root, "packs")
    write_png_pack(os.path.join(packs, "torch-scenes"), names,
                   [textures()[TEXTURE_NAMES.index(n)] for n in names])
    return level_path, packs


def actions_np(rng, n):
    """Numpy-seeded datagen actions as a dict of arrays, for both sides."""
    ang = rng.uniform(0, 2 * np.pi, n).astype(np.float32)
    return dict(move_x=np.sin(ang), move_y=np.cos(ang),
                cam_x=rng.uniform(-1, 1, n).astype(np.float32),
                cam_y=np.zeros(n, np.float32),
                sprint=rng.random(n) < 0.3, jump=rng.random(n) < 0.05)


def cube_scene(tex_ids=(0, 0, 0, None, None, 0), size=1.0,
               center=(0.0, 0.0, 0.0), vertex_colors=None, blend_modes=None,
               black_transparent=True, editor_alpha=255):
    """A 24-vertex, 12-triangle cube with per-face uv/normals, as vertex
    and face dicts (tests/scenes.py's cube_scene, without jax)."""
    s = size / 2.0
    cx, cy, cz = center
    # 6 faces: +x, -x, +y, -y, +z, -z; outward normals
    quads = [
        ([(+s, -s, -s), (+s, +s, -s), (+s, +s, +s), (+s, -s, +s)], (1, 0, 0)),
        ([(-s, -s, +s), (-s, +s, +s), (-s, +s, -s), (-s, -s, -s)],
         (-1, 0, 0)),
        ([(-s, +s, -s), (-s, +s, +s), (+s, +s, +s), (+s, +s, -s)], (0, 1, 0)),
        ([(-s, -s, +s), (-s, -s, -s), (+s, -s, -s), (+s, -s, +s)],
         (0, -1, 0)),
        ([(+s, -s, +s), (+s, +s, +s), (-s, +s, +s), (-s, -s, +s)], (0, 0, 1)),
        ([(-s, -s, -s), (-s, +s, -s), (+s, +s, -s), (+s, -s, -s)],
         (0, 0, -1)),
    ]
    uvs = [(0.0, 0.0), (0.0, 1.0), (1.0, 1.0), (1.0, 0.0)]
    vertices, faces = [], []
    if vertex_colors is None:
        vertex_colors = [(128, 128, 128)] * 6
    if blend_modes is None:
        blend_modes = [0] * 6
    for qi, (corners, normal) in enumerate(quads):
        base = len(vertices)
        col = vertex_colors[qi % len(vertex_colors)]
        for ci, c in enumerate(corners):
            vertices.append(dict(
                pos=(c[0] + cx, c[1] + cy, c[2] + cz),
                uv=uvs[ci], normal=normal, color=col, color_blend=0))
        tid = tex_ids[qi % len(tex_ids)]
        for tri in ((0, 1, 2), (0, 2, 3)):
            faces.append(dict(
                v0=base + tri[0], v1=base + tri[1], v2=base + tri[2],
                tex_id=tid, black_transparent=black_transparent,
                blend_mode=blend_modes[qi % len(blend_modes)],
                editor_alpha=editor_alpha))
    return vertices, faces


DEFAULT_LIGHT_SPECS = [dict(kind="directional", direction=(-1.0, -1.0, -1.0),
                            intensity=0.7, color=(255, 255, 255))]


ASSET_ID = 4242          # the placed asset of asset_level
SIGN_TEXTURE_ID = 77     # the user texture of its second part


def asset_library(A, M):
    """An AssetLibrary of asset module `A` (built with mesh module `M`) that
    holds, beside the built-ins, one asset ASSET_ID with two mesh parts
    and a Light component: "crate", a 384-unit cube with an embedded
    16x16 4-bit atlas, and "sign", a double-sided upright 512x448 quad
    whose texture is the user texture SIGN_TEXTURE_ID (user_textures),
    which has transparent texels (palette entry 0 is 0x0000)."""
    ys, xs = np.meshgrid(np.arange(16), np.arange(16), indexing="ij")
    crate_tex = M.IndexedAtlas(
        width=16, height=16, depth=0,
        indices=((xs // 4 + ys // 4) % 2 * 9 + (xs + ys) % 3 + 3).astype(
            np.uint8).reshape(-1))
    crate = M.MeshPart(name="crate", mesh=M.EditableMesh.cube(384.0),
                       texture_ref=M.TextureRef(kind="Embedded",
                                                embedded=crate_tex))
    v = M.MeshVertex
    quad = M.EditableMesh(
        vertices=[v((-256.0, 200.0, 0.0), (0.0, 1.0), (0.0, 0.0, 1.0),
                    (200, 160, 120)),
                  v((256.0, 200.0, 0.0), (1.0, 1.0), (0.0, 0.0, 1.0),
                    (120, 200, 160)),
                  v((256.0, 648.0, 0.0), (1.0, 0.0), (0.0, 0.0, 1.0)),
                  v((-256.0, 648.0, 0.0), (0.0, 0.0), (0.0, 0.0, 1.0))],
        faces=[M.EditFace([0, 3, 2, 1])])
    sign = M.MeshPart(name="sign", mesh=quad, double_sided=True,
                      texture_ref=M.TextureRef(kind="Id",
                                               id=SIGN_TEXTURE_ID))
    light = A.AssetComponent("Light", {
        "color": (255, 190, 120), "intensity": 1.4, "radius": 3500.0,
        "offset": (0.0, 400.0, 0.0)})
    lib = A.AssetLibrary()
    lib.assets[ASSET_ID] = A.Asset(
        id=ASSET_ID, name="crate_and_sign",
        components=[A.AssetComponent("Mesh", {"parts_obj": [crate, sign]}),
                    light])
    return lib


def user_textures(U):
    """A TextureLibrary of user-texture module `U` holding
    SIGN_TEXTURE_ID: 32x32, 4-bit, diagonal stripes over a 16-entry
    palette whose entry 0 is transparent."""
    lib = U.TextureLibrary()
    ys, xs = np.meshgrid(np.arange(32), np.arange(32), indexing="ij")
    palette = [0x0000] + [((i * 2) << 10) | ((31 - i) << 5) | (i + 8)
                          for i in range(1, 16)]
    lib.textures[SIGN_TEXTURE_ID] = U.UserTexture(
        id=SIGN_TEXTURE_ID, name="sign", width=32, height=32, depth=0,
        indices=((xs + ys) // 3 % 16).astype(np.uint8).reshape(-1),
        palette=palette)
    return lib


def asset_level(L):
    """The Cave-size level with the asset ASSET_ID placed twice: in
    sector (2, 2) as it is, and in sector (5, 3) raised by 128 and turned
    by 0.7 rad.  Five draw groups: the room, then each placement's two
    parts."""
    level = cave_size_level(L)
    room = level.rooms[0]
    room.objects.append(L.AssetInstance(sector_x=2, sector_z=2,
                                        asset_id=ASSET_ID))
    room.objects.append(L.AssetInstance(sector_x=5, sector_z=3,
                                        asset_id=ASSET_ID, height=128.0,
                                        facing=0.7))
    return level


# ---------------------------------------------------------------------------
# audio: an in-memory SoundFont and a tracker song
# ---------------------------------------------------------------------------

def _riff_chunk(cid: bytes, payload: bytes) -> bytes:
    pad = b"\0" if len(payload) & 1 else b""
    return cid + struct.pack("<I", len(payload)) + payload + pad


def _riff_list(list_type: bytes, payload: bytes) -> bytes:
    return _riff_chunk(b"LIST", list_type + payload)


def _name20(s: str) -> bytes:
    return s.encode("ascii")[:19].ljust(20, b"\0")


def build_sf2(S, samples: np.ndarray, sample_defs, presets) -> bytes:
    """A spec-conformant RIFF sfbk: the int16 PCM pool `samples`;
    sample_defs: dicts(name, start, end, start_loop, end_loop,
    sample_rate, original_key, correction); presets: dicts(name, bank,
    patch, zones), each zone a dict of generator opcode (of the sf2
    module `S`) -> amount plus 'sample' index, one instrument a preset."""
    smpl = samples.astype("<i2").tobytes()
    phdr = pbag = pgen = inst = ibag = igen = b""
    for i, p in enumerate(presets):
        phdr += _name20(p["name"]) + struct.pack(
            "<HHHIII", p["patch"], p["bank"], i, 0, 0, 0)
        pbag += struct.pack("<HH", len(pgen) // 4, 0)
        pgen += struct.pack("<Hh", S.G_INSTRUMENT, i)
    phdr += _name20("EOP") + struct.pack("<HHHIII", 0, 0, len(presets), 0,
                                         0, 0)
    pbag += struct.pack("<HH", len(pgen) // 4, 0)
    for p in presets:
        inst += _name20(p["name"] + "-i") + struct.pack("<H", len(ibag) // 4)
        for zone in p["zones"]:
            ibag += struct.pack("<HH", len(igen) // 4, 0)
            items = [(k, v) for k, v in zone.items() if k != "sample"]
            # keyRange first, sampleID last (spec 8.1.2)
            items.sort(key=lambda kv: (kv[0] != S.G_KEY_RANGE,))
            for oper, amount in items:
                igen += struct.pack("<Hh", oper, struct.unpack(
                    "<h", struct.pack("<H", amount & 0xFFFF))[0])
            igen += struct.pack("<Hh", S.G_SAMPLE_ID, zone["sample"])
    inst += _name20("EOI") + struct.pack("<H", len(ibag) // 4)
    ibag += struct.pack("<HH", len(igen) // 4, 0)
    shdr = b""
    for sd in sample_defs:
        shdr += _name20(sd["name"]) + struct.pack(
            "<IIIIIBbHH", sd["start"], sd["end"], sd["start_loop"],
            sd["end_loop"], sd["sample_rate"], sd["original_key"],
            sd.get("correction", 0), 0, 1)
    shdr += _name20("EOS") + struct.pack("<IIIIIBbHH", *[0] * 9)
    info = (_riff_chunk(b"ifil", struct.pack("<HH", 2, 1))
            + _riff_chunk(b"isng", b"EMU8000\0")
            + _riff_chunk(b"INAM", b"test-font\0"))
    pdta = b"".join(_riff_chunk(cid, body) for cid, body in (
        (b"phdr", phdr), (b"pbag", pbag), (b"pmod", b"\0" * 10),
        (b"pgen", pgen), (b"inst", inst), (b"ibag", ibag),
        (b"imod", b"\0" * 10), (b"igen", igen), (b"shdr", shdr)))
    body = (_riff_list(b"INFO", info)
            + _riff_list(b"sdta", _riff_chunk(b"smpl", smpl))
            + _riff_list(b"pdta", pdta))
    return _riff_chunk(b"RIFF", b"sfbk" + body)


def sine_font(S, n: int = 2048, rate: int = 44100, root: int = 60,
              loop: bool = True) -> bytes:
    """One looping sine sample across the full key range, preset 0:0
    (tests/golden/sf2_fixture.py `sine_font`, byte for byte)."""
    t = np.arange(n)
    wave = (np.sin(2 * np.pi * 32 * t / n) * 20000).astype(np.int16)
    zone = {S.G_KEY_RANGE: 0 | (127 << 8),
            S.G_SAMPLE_MODES: 1 if loop else 0, "sample": 0}
    return build_sf2(
        S, wave,
        [dict(name="sine", start=0, end=n, start_loop=0, end_loop=n,
              sample_rate=rate, original_key=root)],
        [dict(name="sinepre", bank=0, patch=0, zones=[zone])])


# GM programs whose oscillator families (stream._program_wave) are
# triangle, sine, saw, square, noise, then three more
DEMO_PROGRAMS = (0, 10, 30, 60, 110, 5, 40, 80)


def demo_song(M, patterns: int = 1, rows: int = 16, channels: int = 5,
              bpm: int = 120, reverb: int = 2, wet: int = 80,
              rate0: int = 0, seed: int = 0):
    """A song of the song module `M`: `patterns` patterns of `rows` rows
    played in order, `channels` channels whose programs run through
    DEMO_PROGRAMS (every oscillator family from five channels on), a note
    on every row with probability 0.4 (seeded), some with a volume or an
    instrument change, channel pans and expressions spread, reverb
    preset `reverb` at wet `wet`, and channel 0's sample-rate setting
    `rate0` (2: 22 kHz, so the resampler runs)."""
    rng = np.random.default_rng(seed)
    progs = [DEMO_PROGRAMS[c % len(DEMO_PROGRAMS)] for c in range(channels)]
    pats = []
    for _ in range(patterns):
        pat = M.Pattern.new(rows, channels)
        for c in range(channels):
            for r in range(rows):
                if r and rng.random() >= 0.4:
                    continue
                vol = int(rng.integers(60, 128)) if rng.random() < 0.5 \
                    else None
                inst = progs[c] if rng.random() < 0.2 else None
                pat.channels[c][r] = M.Note(
                    pitch=int(rng.integers(36, 85)), instrument=inst,
                    volume=vol)
        pats.append(pat)
    settings = [M.ChannelSettings(pan=int(p), expression=int(e))
                for p, e in zip(rng.integers(0, 128, channels),
                                rng.integers(90, 128, channels))]
    settings[0].sample_rate = rate0
    song = M.Song(name="demo", bpm=bpm, patterns=pats,
                  arrangement=list(range(patterns)),
                  channel_instruments=progs, channel_settings=settings)
    song.reverb.preset = reverb
    song.reverb.wet = wet
    return song
