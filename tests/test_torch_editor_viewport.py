"""The port's world-editor modules (editor/state.py, grid_view.py,
hover.py, viewport_edit.py, viewport_render.py) against the JAX
package's, on the CPU, with both packages' Level and EditorState built
by the same calls:

  * the overlay scenarios of tests/test_viewport_render.py at 120x160 —
    the placement grid, the wall preview (new and gap), room bounds and
    portals (wall and horizontal), selection and hover edges, the vertex
    point, the hidden room, the asset gizmos (light octahedron, spawn
    cylinder, the selected light) and the paste preview, each drawn on a
    cleared frame: a frame may differ from the JAX package's on at most
    max(2, drawn / 50) pixels, 2% of the pixels the reference's overlay
    drew (the projections are floats, and XLA:CPU contracts FMAs; the
    measured count is 0), so an overlay drawn in the wrong place fails;
    each scenario's colours must also occur;
  * render_editor_viewport on the three levels of
    tests/torch_editor_cases.py (the Cave-size level with a selected
    floor face, a hovered face and the floor-placement preview; the
    two-room level with its portals; the asset level with its gizmos):
    colour within the seam budget, depth to rtol 1e-6 outside it, every
    overlay colour of the level present; render_player_camera_preview on
    the Cave-size level within the budget, the green cylinder drawn;
  * the 2D grid view painted through UiContext, exact;
  * EditorState edits (copy, paste, undo, redo), hover.detect_hover and
    detect_object_hover, and ViewportEditor gestures through
    picking (pick_plane, placement, walls, object placement, the box
    selector): equal results.
"""

import types

import numpy as np
import pytest
import torch

import torch_editor_cases as ec
import torch_scenes as ts

torch.set_num_threads(1)

H, W = 120, 160


def _pkg(which):
    """The modules of one package, and its framebuffer helpers."""
    if which == "jax":
        from bonnie32_tpu import ui
        from bonnie32_tpu.editor import grid_view, hover, state
        from bonnie32_tpu.editor import viewport_edit, viewport_render
        from bonnie32_tpu.models import asset, level, mesh, scene
        from bonnie32_tpu.models import user_texture
        from bonnie32_tpu.ops import raster_ref
        from bonnie32_tpu.types import FrameBuffers
        import jax.numpy as jnp

        def new_fb(h=H, w=W):
            return raster_ref.new_framebuffer(h, w, depth_mode="inv")

        def blank(h=H, w=W):
            return FrameBuffers(color=jnp.zeros((h, w), jnp.int32),
                                depth=jnp.zeros((h, w), jnp.float32))

        def frame(fb):
            return np.asarray(fb.color), np.asarray(fb.depth)

        def compile_level(lv, tex, ckw):
            return scene.compile_level(lv, tex, ts.resolver, **ckw)
        kw = {}
    else:
        from bonnie32_tpu_torch import ui
        from bonnie32_tpu_torch.editor import grid_view, hover, state
        from bonnie32_tpu_torch.editor import viewport_edit, viewport_render
        from bonnie32_tpu_torch.models import asset, level, mesh, scene
        from bonnie32_tpu_torch.models import user_texture
        from bonnie32_tpu_torch.ops import raster_ref
        from bonnie32_tpu_torch.types import FrameBuffers

        def new_fb(h=H, w=W):
            return raster_ref.new_framebuffer(h, w, depth_mode="inv",
                                              device="cpu")

        def blank(h=H, w=W):
            return FrameBuffers(
                color=torch.zeros((1, h, w), dtype=torch.int32),
                depth=torch.zeros((1, h, w)))

        def frame(fb):
            return fb.color[0].numpy(), fb.depth[0].numpy()

        def compile_level(lv, tex, ckw):
            return scene.compile_level(lv, tex, ts.resolver, device="cpu",
                                       **ckw)
        kw = dict(device="cpu")
    return types.SimpleNamespace(
        ui=ui, GV=grid_view, HV=hover, ES=state, VE=viewport_edit,
        VR=viewport_render, A=asset, L=level, M=mesh, U=user_texture,
        S=scene, new_fb=new_fb, blank=blank,
        frame=frame, compile_level=compile_level, kw=kw)


PKGS = {k: _pkg(k) for k in ("jax", "port")}


def _word(rgb):
    return np.uint32(rgb[0] | (rgb[1] << 8) | (rgb[2] << 16)
                     | (255 << 24)).astype(np.int32)


def _count(color, rgb):
    return int((color == _word(rgb)).sum())


def seam_budget(npixels, n_inst=1):
    """The budget of a full rendered frame (tests/test_raster_batch.py)."""
    return max(64 * n_inst, npixels // 500)


def drawn_budget(drawn):
    """The budget of an overlay on a cleared frame, or of a skeleton over
    a render: 2% of the pixels the reference drew, at least 2."""
    return max(2, drawn // 50)


def _state(p, with_floor=True):
    """test_viewport_render.py's one-room state, built with package p."""
    L, ES = p.L, p.ES
    level = L.Level()
    room = L.Room.new(0, (0.0, 0.0, 0.0), 4, 4)
    if with_floor:
        room.set_floor(1, 1, 0.0, L.TextureRef("p", "T"))
    room.recalculate_bounds()
    level.add_room(room)
    s = ES.EditorState(level)
    s.selection = ES.Selection(kind="sector", room=0, x=1, z=1)
    s.camera_mode = "orbit"
    s.orbit_distance = 6000.0
    s.center_camera_on_selection()
    s.selection = ES.Selection()
    return s


def _overlays(p, s, **kw):
    return p.frame(p.VR.draw_viewport_overlays(p.new_fb(), s, **kw))[0]


# ---- the overlay scenarios: each returns [(frame, {colour: minimum})] ----

def sc_placement_grid(p):
    s = _state(p)
    s.tool = p.ES.EditorTool.DRAW_FLOOR
    ed = p.VE.ViewportEditor(state=s)
    size = p.L.SECTOR_SIZE
    ed.preview_sector = (1.0 * size, 1.0 * size, 0.0, False)
    vr = p.VR
    return [(_overlays(p, s, editor=ed), {vr.GRID_INNER: 20,
                                          vr.GRID_OUTER: 20,
                                          vr.VERTEX_WHITE: 4})]


def _wall_editor(p):
    s = _state(p)
    s.tool = p.ES.EditorTool.DRAW_WALL
    ed = p.VE.ViewportEditor(state=s)
    ed.wall_direction = p.L.NORTH
    ed.wall_drag_start = (1, 1, p.L.NORTH)
    ed.wall_drag_current = (1, 1, p.L.NORTH)
    return s, ed


def sc_wall_preview_new(p):
    s, ed = _wall_editor(p)
    return [(_overlays(p, s, editor=ed), {p.VR.NEW_WALL: 10})]


def sc_wall_preview_gap(p):
    s, ed = _wall_editor(p)
    room = s.level.rooms[0]
    tex = p.L.TextureRef("p", "T")
    room.add_wall(1, 1, p.L.NORTH, 0.0, 512.0, tex)
    room.add_wall(1, 1, p.L.NORTH, 896.0, 2048.0, tex)
    room.recalculate_bounds()
    return [(_overlays(p, s, editor=ed), {p.VR.GAP_FILL: 10})]


def sc_room_bounds_and_portals(p):
    s = _state(p)
    room = s.level.rooms[0]
    room.portals.append(p.L.Portal(
        target_room=1,
        vertices=np.array([[0, 0, 0], [1024, 0, 0], [1024, 1024, 0],
                           [0, 1024, 0]], np.float32),
        normal=np.array([0, 0, 1], np.float32)))
    out = [(_overlays(p, s), {p.VR.ROOM_CURRENT: 30, p.VR.PORTAL_WALL: 5})]
    room.portals[0].normal = np.array([0, 1, 0], np.float32)
    out.append((_overlays(p, s), {p.VR.PORTAL_HORIZONTAL: 5}))
    return out


def sc_selection_and_hover(p):
    s = _state(p)
    face = p.ES.SectorFace(kind="floor")
    s.selection = p.ES.Selection(kind="sector_face", room=0, x=1, z=1,
                                 face=face)
    hover = (0, 1, 1, face)
    out = [(_overlays(p, s), {p.VR.SELECT_COLOR: 15}),
           (_overlays(p, s, hover=hover), {p.VR.SELECT_COLOR: 15})]
    s.selection = p.ES.Selection()
    out.append((_overlays(p, s, hover=hover), {p.VR.HOVER_COLOR: 15}))
    return out


def sc_vertex_point(p):
    s = _state(p)
    s.selection = p.ES.Selection(kind="vertex", room=0, x=1, z=1,
                                 face=p.ES.SectorFace(kind="floor"),
                                 corner_idx=2)
    return [(_overlays(p, s), {p.VR.SELECT_COLOR: 20})]


def sc_hidden_room(p):
    s = _state(p)
    s.hidden_rooms.add(0)
    return [(_overlays(p, s), {})]


def sc_asset_gizmos(p):
    s = _state(p)
    lib = p.A.AssetLibrary()
    lib.assets = {a.id: a for a in p.A.builtin_assets()}
    s.asset_library = lib
    by_name = {a.name: a for a in lib.assets.values()}
    room = s.level.rooms[0]
    spawn = by_name.get("Player Spawn") or by_name.get("player_spawn")
    light = by_name.get("Point Light") or by_name.get("point_light")
    room.objects.append(p.L.AssetInstance(sector_x=1, sector_z=1,
                                          asset_id=spawn.id))
    room.objects.append(p.L.AssetInstance(sector_x=2, sector_z=1,
                                          asset_id=light.id, height=1024.0))
    room.set_floor(2, 1, 0.0, p.L.TextureRef("p", "T"))
    room.recalculate_bounds()
    sel = p.ES.Selection
    vr = p.VR
    out = []
    for target, dist, select, want in (
            ((2, 1), 1500.0, None, {vr.GIZMO_LIGHT: 10}),
            ((1, 1), 4000.0, None, {vr.GIZMO_PLAIN: 5}),
            ((2, 1), 1500.0, 1, {(255, 255, 255): 10})):
        s.selection = sel(kind="sector", room=0, x=target[0], z=target[1])
        s.orbit_distance = dist
        s.center_camera_on_selection()
        s.selection = (sel() if select is None
                       else sel(kind="object", room=0, index=select))
        out.append((_overlays(p, s), want))
    return out


def sc_paste_preview(p):
    s = _state(p)
    s.selection = p.ES.Selection(kind="sector", room=0, x=1, z=1)
    assert s.copy_selected_geometry() >= 1
    out = [(_overlays(p, s, paste_hover=(2, 2)), {p.VR.PASTE_PREVIEW: 10})]
    s.geometry_clipboard.faces = []
    out.append((_overlays(p, s, paste_hover=(2, 2)), {}))
    return out


SCENARIOS = {f.__name__[3:]: f for f in (
    sc_placement_grid, sc_wall_preview_new, sc_wall_preview_gap,
    sc_room_bounds_and_portals, sc_selection_and_hover, sc_vertex_point,
    sc_hidden_room, sc_asset_gizmos, sc_paste_preview)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_overlay_scenarios_match_jax(name):
    ours = SCENARIOS[name](PKGS["port"])
    theirs = SCENARIOS[name](PKGS["jax"])
    assert len(ours) == len(theirs)
    clear = PKGS["jax"].frame(PKGS["jax"].new_fb())[0]
    for i, ((a, _), (b, _)) in enumerate(zip(ours, theirs)):
        diff = int((a != b).sum())
        drawn = int((b != clear).sum())
        budget = drawn_budget(drawn)
        print(f"{name}[{i}]: {diff} differing pixels, the reference drew "
              f"{drawn} (budget {budget})")
        assert diff <= budget
    for color, want in ours:
        for rgb, least in want.items():
            assert _count(color, rgb) >= least, (rgb, _count(color, rgb))
    if name == "hidden_room":
        assert _count(ours[0][0], PKGS["port"].VR.ROOM_CURRENT) == 0
    if name == "selection_and_hover":
        hov = PKGS["port"].VR.HOVER_COLOR
        assert _count(ours[1][0], hov) == 0   # the hovered face is selected
    if name == "paste_preview":
        assert _count(ours[1][0], PKGS["port"].VR.PASTE_PREVIEW) == 0


# ---- the full editor view on the three levels of torch_editor_cases ----

def _case(p, name):
    s, ed, hover, tex, kw = ec.editor_case(name, p.L, p.ES, p.VE, p.A, p.M,
                                           p.U, p.S)
    return s, ed, hover, p.compile_level(s.level, tex, kw)


@pytest.fixture(scope="module")
def cave():
    return {k: _case(p, "cave") for k, p in PKGS.items()}


# the colours each level's view must show
WANT = {"cave": ("GRID_INNER", "GRID_OUTER", "VERTEX_WHITE", "ROOM_CURRENT",
                 "SELECT_COLOR", "HOVER_COLOR"),
        "two_room": ("ROOM_CURRENT", "PORTAL_WALL", "PORTAL_HORIZONTAL",
                     "SELECT_COLOR"),
        "asset": ("ROOM_CURRENT", "GIZMO_LIGHT", "GIZMO_PLAIN")}


@pytest.mark.parametrize("name", ec.EDITOR_CASES)
def test_render_editor_viewport(cave, name):
    frames = {}
    for k, p in PKGS.items():
        s, ed, hover, sc = cave[k] if name == "cave" else _case(p, name)
        fb = p.VR.render_editor_viewport(s, sc, W, H, editor=ed,
                                         hover=hover, **p.kw)
        frames[k] = p.frame(fb)
    (c, d), (jc, jd) = frames["port"], frames["jax"]
    dc = int((c != jc).sum())
    # the inverse-z plane's interpolation rounds differently where
    # XLA:CPU contracts an FMA: depth agrees to rtol 1e-6 (~8 ulp)
    far = ~np.isclose(d, jd, rtol=1e-6, atol=0.0)
    dd = int(far.sum())
    budget = seam_budget(H * W)
    print(f"editor view, {name}: colour {dc} differing pixels, "
          f"depth {int((d != jd).sum())} not bit-equal, {dd} beyond rtol "
          f"1e-6 (budget {budget})")
    assert dc <= budget and dd <= budget
    vr = PKGS["port"].VR
    for colour in WANT[name]:
        assert _count(c, getattr(vr, colour)) > 0, colour
    assert (d > 0).mean() > 0.5          # the level drew


def test_render_player_camera_preview_cave(cave):
    frames = {}
    for k, p in PKGS.items():
        s, _, _, sc = cave[k]
        room = s.level.rooms[0]
        obj = p.L.AssetInstance(sector_x=4, sector_z=4, asset_id=0)
        frames[k] = p.VR.render_player_camera_preview(s, room, obj, W, H,
                                                      scene=sc, **p.kw)
    ours, theirs = frames["port"], np.asarray(frames["jax"])
    assert ours.shape == theirs.shape == (H, W)
    diff = int((ours != theirs).sum())
    print(f"camera preview: {diff} differing pixels")
    assert diff <= seam_budget(H * W)
    assert _count(ours, (100, 255, 100)) > 20


def test_render_entry_points_need_a_device_without_a_card(cave):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is the card")
    p = PKGS["port"]
    s, ed, hover, sc = cave["port"]
    with pytest.raises(RuntimeError, match="no CUDA card"):
        p.VR.render_editor_viewport(s, sc, W, H)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        p.VR.render_player_camera_preview(
            s, s.level.rooms[0], p.L.AssetInstance(1, 1, 0), W, H)


# ---- the 2D grid view through UiContext.paint ----

def test_grid_view_paint_matches_jax():
    out = {}
    for k, p in PKGS.items():
        s = _state(p)
        room = s.level.rooms[0]
        tex = p.L.TextureRef("p", "T")
        room.set_floor(2, 2, 256.0, tex)
        room.add_wall(1, 1, p.L.NORTH, 0.0, 1024.0, tex)
        room.objects.append(p.L.AssetInstance(sector_x=2, sector_z=1,
                                              asset_id=7))
        s.selection = p.ES.Selection(kind="sector", room=0, x=2, z=2)
        ctx = p.ui.UiContext()
        ctx.begin_frame(60.0, 50.0, False)
        p.GV.draw_grid_view(ctx, p.ui.Rect(0, 0, W, H), s)
        kinds = {c[0] for c in ctx.commands}
        out[k] = (kinds, p.frame(ctx.paint(p.blank()))[0])
    assert out["port"][0] == out["jax"][0]
    assert {"fill", "line", "tri"} <= out["port"][0]
    np.testing.assert_array_equal(out["port"][1], out["jax"][1])
    assert (out["port"][1] != 0).sum() > 1000


# ---- host state and picking through the editor ----

def _edits(p):
    s = _state(p)
    room = s.level.rooms[0]
    tex = p.L.TextureRef("p", "T")
    room.set_floor(2, 1, 128.0, tex)
    room.add_wall(1, 1, p.L.EAST, 0.0, 900.0, tex)
    s.set_selection(p.ES.Selection(kind="sector", room=0, x=1, z=1))
    s.add_to_multi_selection(p.ES.Selection(kind="sector", room=0, x=2, z=1))
    copied = s.copy_selected_geometry()
    s.save_undo()
    pasted = s.paste_geometry(0, 0, 3)
    after_paste = p.L.ron.dumps(s.level.to_ron()) \
        if hasattr(p.L, "ron") else None
    undone = s.undo()
    redone = s.redo()
    return (copied, pasted, undone, redone, s.selected_sectors(),
            len(s.undo_stack), len(s.redo_stack), after_paste,
            [(r.width, r.depth) for r in s.level.rooms],
            sorted((x, z) for x in range(room.width) for z in range(
                room.depth) if room.get_sector(x, z) is not None))


def test_editor_state_edits_match():
    assert _edits(PKGS["port"]) == _edits(PKGS["jax"])


def _hovers(p):
    basis = np.eye(3, dtype=np.float32)
    cam = np.array([0, 0, -10], np.float32)

    def quad(z, size=2.0, cx=0.0, cy=0.0):
        s = size / 2
        return np.array([[cx - s, cy - s, z], [cx + s, cy - s, z],
                         [cx + s, cy + s, z], [cx - s, cy + s, z]],
                        np.float32)
    quads = [("a", quad(2.0)), ("b", quad(2.05, 3.0, 0.4)),
             ("c", quad(6.0, 4.0, -1.0, 1.0))]
    out = []
    for mx, my in ((160.0, 120.0), (137.5, 97.5), (135.0, 120.0),
                   (200.0, 160.0), (20.0, 20.0), (149.0, 101.0)):
        r = p.HV.detect_hover(mx, my, quads, cam, basis, 320, 240)
        out.append((r.kind, r.tag, r.corner, r.edge))
        o = p.HV.detect_object_hover(
            mx, my, [("x", np.array([0, 0, 2], np.float32)),
                     ("y", np.array([0.5, 0.2, 3], np.float32))], cam, basis,
            320, 240)
        out.append(None if o is None else o[0])
    return out


def test_hover_detection_matches():
    ours = _hovers(PKGS["port"])
    assert ours == _hovers(PKGS["jax"])
    assert {"vertex", "edge", "face", None} <= {o[0] for o in ours[::2]}


def _gestures(p):
    """test_viewport_edit.py's gestures: a camera above the room aims the
    mouse at cells through pick_plane and world_to_screen."""
    from bonnie32_tpu_torch.models import build
    L, ES = p.L, p.ES
    level = L.Level()
    room = L.Room.new(0, (0.0, 0.0, 0.0), 6, 6)
    tex = L.TextureRef("p", "T")
    for x, z in ((1, 1), (2, 1), (3, 1)):
        room.set_floor(x, z, 0.0, tex)
    room.recalculate_bounds()
    level.add_room(room)
    ed = p.VE.ViewportEditor(state=ES.EditorState(level))
    cam_pos = np.asarray([3 * 1024.0, 4000.0, 3 * 1024.0], np.float32)
    basis = build.camera_basis(1.2, 0.0)

    def aim(cx, cz, fb_w=320, fb_h=240):
        rel = np.asarray([(cx + 0.5) * 1024.0, 0.0, (cz + 0.5) * 1024.0],
                         np.float32) - cam_pos
        c = np.asarray(basis) @ rel
        vs = (min(fb_w, fb_h) / 2.0) * 0.75
        return (float((c[0] * 4.0) / (c[2] + 5.0) * vs + fb_w / 2.0),
                float((c[1] * 4.0) / (c[2] + 5.0) * vs + fb_h / 2.0))

    out = [p.VE.pick_plane(aim(1, 4), cam_pos, basis, 320, 240, 0.0)]
    ed.state.tool = ES.EditorTool.DRAW_FLOOR
    ed.update_placement_preview(aim(4, 3), cam_pos, basis)
    out.append(ed.preview_sector)
    ed.press_placement()
    ed.move_placement(aim(5, 5), cam_pos, basis)
    out.append(ed.release_placement(tex))
    ed.state.tool = ES.EditorTool.DRAW_WALL
    ed.wall_direction = L.NORTH
    ed.press_wall(aim(1, 1), cam_pos, basis)
    ed.move_wall(aim(3, 4), cam_pos, basis)
    out.append(ed.release_wall(tex))
    ed.state.tool = ES.EditorTool.PLACE_OBJECT
    ed.selected_asset = 42
    out.append(ed.place_object(aim(2, 2), cam_pos, basis))
    box = p.VE.BoxSelector(ed)
    box.press(aim(0.6, 0.6))
    box.move(aim(4.4, 2.4))
    out.append(box.release(cam_pos, basis))
    out.append(ed.state.selection)
    out.append(sorted((x, z, s.floor is not None)
                      for (x, z), s in _sectors(room)))
    return out


def _sectors(room):
    return [((x, z), room.get_sector(x, z)) for x in range(room.width)
            for z in range(room.depth) if room.get_sector(x, z) is not None]


def test_viewport_editor_gestures_match():
    ours, theirs = _gestures(PKGS["port"]), _gestures(PKGS["jax"])
    np.testing.assert_allclose(np.asarray(ours[0]), np.asarray(theirs[0]),
                               rtol=1e-5, atol=1e-2)
    assert ours[1][3] == theirs[1][3]
    np.testing.assert_allclose(ours[1][:3], theirs[1][:3], atol=1e-2)
    assert ours[2:6] == theirs[2:6]
    assert ours[2] > 0 and ours[3] > 0 and ours[4] == 0 and ours[5] > 0
    assert repr(ours[6]) == repr(theirs[6]).replace("bonnie32_tpu.",
                                                    "bonnie32_tpu_torch.")
    assert ours[7] == theirs[7]
