"""Editor and modeler scenes built in code, shared by the port's editor
tests (tests/test_torch_editor_viewport.py, test_torch_modeler.py,
test_torch_ui_paint.py, test_torch_gpu.py) and chip_smoke.py.  Imports
no jax: every function takes the modules it builds with, so a JAX test
builds the same scene from the JAX package and the port from its own
copies.

  * `editor_case(name, ...)`: a level of tests/torch_seq_cases.py in an
    EditorState, with what its editor view draws over it —
      - "cave": the Cave-size level under the DRAW_FLOOR tool, a selected
        floor face, a hovered floor face and the floor-placement preview;
      - "two_room": the two-room level seen from inside its first room,
        with a wall portal and a horizontal portal added to that room
        (its rooms do not touch, so recalculate_portals finds none);
      - "asset": the level with the two-part asset placed twice, its
        AssetLibrary set as the state's, and a player-spawn object added,
        so that the light octahedra and the spawn cylinder draw;
  * `mesh_project`, `viewports`, `rig`, `pose`: the modeler's project of
    two visible cubes and a hidden one, its four panes, a five-bone rig
    and a seeded pose;
  * `paint_queue`: a UiContext queue that holds every command kind.
"""

import numpy as np

import torch_scenes as ts
import torch_seq_cases as sc

# (camera position, pitch, yaw) of each editor case
POSES = {"cave": ((512.0, 2000.0, -300.0), 0.25, 0.6),
         "two_room": ((4096.0, 2000.0, 1000.0), 0.0, 0.0),
         "asset": ((1500.0, 1900.0, 900.0), 0.355, 0.785)}
EDITOR_CASES = tuple(POSES)


def editor_case(name, L, ES, VE, A, M, U, S):
    """(state, viewport editor, hover, textures, compile_level keywords)
    of editor case `name`, built with the level, editor-state,
    viewport-edit, asset, mesh, user-texture and scene modules given."""
    level, tex, kw, _ = sc.level_args(name, L=L, A=A, M=M, U=U, S=S)
    state = ES.EditorState(level)
    pos, pitch, yaw = POSES[name]
    state.camera_pos = np.asarray(pos, np.float32)
    state.camera_rot_x, state.camera_rot_y = pitch, yaw
    editor, hover = None, None
    room = level.rooms[0]
    if name == "cave":
        face = ES.SectorFace(kind="floor")
        state.selection = ES.Selection(kind="sector_face", room=0, x=2, z=3,
                                       face=face)
        state.tool = ES.EditorTool.DRAW_FLOOR
        editor = VE.ViewportEditor(state=state)
        size = L.SECTOR_SIZE
        editor.preview_sector = (3.0 * size, 2.0 * size, 0.0, False)
        hover = (0, 3, 4, face)
    elif name == "two_room":
        ceiling = ts.CEILING
        room.portals.append(L.Portal(
            target_room=1,
            vertices=np.array([[3072, 0, 8192], [5120, 0, 8192],
                               [5120, 3072, 8192], [3072, 3072, 8192]],
                              np.float32),
            normal=np.array([0, 0, 1], np.float32)))
        room.portals.append(L.Portal(
            target_room=1,
            vertices=np.array([[3072, ceiling, 6656], [5120, ceiling, 6656],
                               [5120, ceiling, 7680],
                               [3072, ceiling, 7680]], np.float32),
            normal=np.array([0, 1, 0], np.float32)))
        state.selection = ES.Selection(
            kind="sector_face", room=0, x=4, z=7,
            face=ES.SectorFace(kind="wall", direction=L.SOUTH))
    elif name == "asset":
        state.asset_library = kw["asset_library"]
        room.objects.append(L.AssetInstance(sector_x=3, sector_z=3,
                                            asset_id=A.PLAYER_SPAWN_ID))
    return state, editor, hover, tex, kw


def mesh_project(M):
    """A MeshProject of a 1024 cube, a 256 cube moved aside and recoloured,
    and a hidden 2048 cube."""
    small = M.EditableMesh.cube(256.0)
    for v in small.vertices:
        v.pos = (v.pos[0] + 600.0, v.pos[1] + 300.0, v.pos[2] - 100.0)
        v.color = (220, 90, 40)
    return M.MeshProject(name="m", objects=[
        M.MeshPart(name="big", mesh=M.EditableMesh.cube(1024.0)),
        M.MeshPart(name="small", mesh=small),
        M.MeshPart(name="hidden", mesh=M.EditableMesh.cube(2048.0),
                   visible=False)])


def viewports(MV):
    """The four panes framing mesh_project: ortho zoom 1/16 (exact
    products), the front pane panned, the orbit camera backed off."""
    vp = MV.ModelerViewports()
    for cam in vp.cameras.values():
        cam.zoom = 0.0625
    vp.cameras[MV.ViewportId.FRONT].center = (96.0, -48.0)
    vp.perspective.distance = 3500.0
    vp.perspective.target = (100.0, 100.0, 0.0)
    return vp


def rig(AN):
    """Five bones beside the cubes: a root, a chain of three and a branch
    off the first."""
    B = AN.RigBone
    return [B("root", None, (-900.0, 0.0, -900.0), (0.0, 0.0, 0.0), 200.0),
            B("spine", 0, (0.0, 200.0, 0.0), (10.0, 0.0, 15.0), 180.0),
            B("neck", 1, (0.0, 180.0, 0.0), (-20.0, 0.0, 5.0), 90.0, 30.0),
            B("arm", 1, (40.0, 120.0, 0.0), (0.0, 0.0, -80.0), 150.0),
            B("hand", 3, (0.0, 150.0, 0.0), (35.0, 0.0, 25.0), 60.0)]


def pose(AN, seed=0):
    r = np.random.default_rng(seed)
    return [AN.BoneTransform(tuple(r.uniform(-30, 30, 3)),
                             tuple(r.uniform(-40, 40, 3)))
            for _ in range(5)]


def paint_queue(ui, scale=1):
    """A UiContext whose queue holds every command kind: fills at alpha
    128 and 255 (one clipped away), an outline, opaque and overlapping
    alpha lines (also clipped), triangles (one clipped, one at alpha
    100), circles and rings, text (scaled, clipped) and an image.  `scale`
    multiplies the coordinates (1 for 160x120, 4 for 640x480)."""
    R = ui.Rect
    k = scale
    ctx = ui.UiContext()
    ctx.begin_frame(40.0 * k, 30.0 * k, True)
    ctx.fill(R(0, 0, 160 * k, 20 * k), (30, 30, 40))
    ctx.fill(R(10 * k, 10 * k, 60 * k, 50 * k), (200, 40, 40), alpha=128)
    ctx.fill(R(40 * k, 30 * k, 60 * k, 50 * k), (40, 200, 40), alpha=128)
    ctx.outline(R(5 * k, 25 * k, 100 * k, 60 * k), (250, 250, 250))
    ctx.line(0, 119 * k, 159 * k, 0, (255, 255, 0))
    ctx.line(0, 60 * k, 159 * k, 70 * k, (0, 128, 255), alpha=128)
    ctx.line(80 * k, 0, 70 * k, 119 * k, (255, 0, 128), alpha=128)
    ctx.line(20 * k, 100 * k, 150 * k, 100 * k, (120, 90, 60), alpha=180)
    ctx.tri(20.5 * k, 90.0 * k, 70.25 * k, 115.5 * k, 5.0 * k, 118.0 * k,
            (90, 200, 250))
    ctx.circle(120 * k, 40 * k, 15 * k, (250, 150, 0))
    ctx.circle_lines(120 * k, 40 * k, 20 * k, (255, 255, 255))
    ctx.text(4 * k, 4 * k, "UI paint 42%", (255, 255, 255), scale=k)
    ctx.text(100 * k, 100 * k, "scaled", (200, 200, 0), scale=2 * k)
    ctx.set_clip(R(30 * k, 40 * k, 70 * k, 40 * k))
    ctx.fill(R(0, 0, 160 * k, 120 * k), (10, 60, 10), alpha=200)
    ctx.fill(R(200 * k, 200 * k, 10, 10), (255, 0, 0))     # clipped away
    ctx.line(0, 0, 159 * k, 119 * k, (255, 255, 255))
    ctx.line(0, 119 * k, 159 * k, 0, (255, 60, 60), alpha=128)
    ctx.tri(0.0, 40.0 * k, 150.0 * k, 60.0 * k, 40.0 * k, 119.0 * k,
            (250, 250, 120), alpha=100)
    ctx.circle(35 * k, 45 * k, 12 * k, (0, 0, 255))
    ctx.circle_lines(95 * k, 75 * k, 9 * k, (0, 255, 255))
    ctx.text(25 * k, 50 * k, "clipped text runs on", (255, 200, 200),
             scale=k)
    ctx.set_clip(None)
    img = np.random.default_rng(2).integers(
        -(1 << 31), 1 << 31, (16 * k, 24 * k)).astype(np.int32)
    ctx.commands.append(("image", (140 * k, 108 * k), img))
    return ctx


ICONS = (("save", 1, (10, 10, 20, 20)), ("bone", 2, (50, 30, 30, 30)),
         ("no_such_icon", 1, (0, 0, 9, 9)), ("grid", 3, (150, 110, 20, 20)),
         ("play", 1, (-4, -3, 7, 7)))
