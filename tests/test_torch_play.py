"""The port's play-mode runtime (input/, game/runtime.py,
game/viewport.py) against the JAX package's, on the CPU:

  * viewport_fb_size and present_rect on test_viewport.py's cases, equal;
  * FpsLimit, FrameLimiter, FreeflyCamera and GameToolState on
    test_runtime.py's cases; GameToolState's state and cameras after the
    same input against the JAX package's, rtol 1e-5 / atol 1e-4 as the
    port's tick is held (sin, cos and atan2 differ by ulps), integers
    exact;
  * InputState.to_actions on test_input.py's case: (1,) tensors equal to
    the JAX package's scalars, and one tick of the port's sim;
  * render_game_view of the open-air night level (tests/torch_scenes.py)
    with the view's size set to 120x160 (the sizing is held above): the
    port's frames against the JAX package's, faces within the seam
    budget max(64 N, pixels / 500) (XLA:CPU contracts FMAs), sky pixels
    within one 8-bit step; without the sky, and with it; and under
    use_rgb555=False, where the 8-bit pipeline draws no face on the
    view's inverse-z clear, in both packages.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import jax_refs
import torch_scenes as ts
import torch_seq_cases as sc
from bonnie32_tpu import config as jconfig
from bonnie32_tpu.game import collision as jcol
from bonnie32_tpu.game import runtime as jrt
from bonnie32_tpu.game import viewport as jvp
from bonnie32_tpu.input import InputState as JInputState
from bonnie32_tpu.input import VirtualGamepad as JVirtualGamepad
from bonnie32_tpu.input import VirtualKeyboard as JVirtualKeyboard
from bonnie32_tpu.models import level as JL
from bonnie32_tpu.models import scene as JScene
from bonnie32_tpu.models import skybox as JSky
from bonnie32_tpu.ops import skybox as jsky
from bonnie32_tpu_torch import interop
from bonnie32_tpu_torch.config import (HEIGHT, HEIGHT_HI, WIDTH, WIDTH_HI,
                                       RasterSettings)
from bonnie32_tpu_torch.game import collision as tcol
from bonnie32_tpu_torch.game import runtime as trt
from bonnie32_tpu_torch.game import state as tst
from bonnie32_tpu_torch.game import step as tstep
from bonnie32_tpu_torch.game import viewport as tvp
from bonnie32_tpu_torch.input import (InputState, VirtualGamepad,
                                      VirtualKeyboard)
from bonnie32_tpu_torch.models import level as TL
from bonnie32_tpu_torch.models import scene as TScene
from bonnie32_tpu_torch.models import skybox as TSky
from bonnie32_tpu_torch.ops import skybox as tsky

torch.set_num_threads(1)

VH, VW = 120, 160
_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731


def _s(**kw):
    return RasterSettings.game(**kw)


# ---- framebuffer size and presentation (test_viewport.py's cases) ----

SIZE_CASES = [
    (dict(stretch_to_fill=False, low_resolution=True), (800, 600),
     (WIDTH, HEIGHT)),
    (dict(stretch_to_fill=False, low_resolution=False), (800, 600),
     (WIDTH_HI, HEIGHT_HI)),
    (dict(stretch_to_fill=True, low_resolution=True), (960, 480),
     (480, HEIGHT)),
    (dict(stretch_to_fill=True, low_resolution=False), (960, 480),
     (960, HEIGHT_HI)),
    (dict(stretch_to_fill=True, low_resolution=False), (1, 10000),
     (1, HEIGHT_HI)),
]


@pytest.mark.parametrize("kw,rect,want", SIZE_CASES)
def test_viewport_fb_size(kw, rect, want):
    ours = trt.viewport_fb_size(_s(**kw), *rect)
    theirs = jrt.viewport_fb_size(
        dataclasses.replace(jconfig.RasterSettings.game(), **kw), *rect)
    assert ours == want == theirs


PRESENT_CASES = [
    (dict(stretch_to_fill=True), (480, 240, 5, 7, 960, 480),
     (5, 7, 960, 480)),
    (dict(stretch_to_fill=False, low_resolution=True),
     (WIDTH, HEIGHT, 0, 0, 800, 300), (200, 0, 400, 300)),
    (dict(stretch_to_fill=False, low_resolution=True),
     (WIDTH, HEIGHT, 0, 0, 400, 600), (0, 150, 400, 300)),
]


@pytest.mark.parametrize("kw,args,want", PRESENT_CASES)
def test_present_rect(kw, args, want):
    ours = trt.present_rect(_s(**kw), *args)
    theirs = jrt.present_rect(
        dataclasses.replace(jconfig.RasterSettings.game(), **kw), *args)
    assert ours == theirs
    assert ours == pytest.approx(want)


# ---- runtime shell (test_runtime.py's cases) ----

def test_fps_limit_cycle():
    F = trt.FpsLimit
    assert F.FPS30.frame_time() == 1.0 / 30.0
    assert F.FPS60.frame_time() == 1.0 / 60.0
    assert F.UNLOCKED.frame_time() is None
    assert F.FPS30.next() == F.FPS60 and F.UNLOCKED.next() == F.FPS30
    assert F.FPS30.prev() == F.UNLOCKED and F.FPS60.label == "60"
    assert [f.value for f in F] == [f.value for f in jrt.FpsLimit]


def test_frame_limiter_paces():
    t = [0.0]
    sleeps = []

    def clock():
        t[0] += 1e-5
        return t[0]

    def sleep(s):
        sleeps.append(s)
        t[0] += s

    lim = trt.FrameLimiter(trt.FpsLimit.FPS60, sleep_fn=sleep, clock=clock)
    lim.begin_frame()
    t[0] += 0.005
    dt = lim.end_frame()
    assert abs(dt - 1.0 / 60.0) < 0.003, dt
    assert sleeps and sleeps[0] > 0.005
    lim = trt.FrameLimiter(trt.FpsLimit.UNLOCKED, sleep_fn=sleep,
                           clock=clock)
    lim.begin_frame()
    t[0] += 0.001
    assert abs(lim.end_frame() - 0.001) < 1e-3


def _freefly_script(mod, kb, gp, inp):
    """test_freefly_camera's moves, for either package: the cameras'
    (yaw, pitch, position) after each."""
    out = []
    cam = mod.FreeflyCamera()
    cam.update(inp, 1 / 60, mouse_delta=(100.0, 0.0), rmb_down=True)
    out.append((cam.yaw, cam.pitch, cam.position.copy()))
    cam.update(inp, 1 / 60, mouse_delta=(0.0, 10000.0), rmb_down=True)
    out.append((cam.yaw, cam.pitch, cam.position.copy()))
    cam2 = mod.FreeflyCamera()
    kb.update({"q"})
    cam2.update(inp, 1.0)
    out.append((cam2.yaw, cam2.pitch, cam2.position.copy()))
    kb.update(set())
    gp.update(axes=dict(lx=0.0, ly=1.0, rx=0.3, ry=-0.2))
    cam3 = mod.FreeflyCamera()
    cam3.update(inp, 1.0)
    out.append((cam3.yaw, cam3.pitch, cam3.position.copy()))
    return out, cam3


def test_freefly_camera():
    kb, gp = VirtualKeyboard(), VirtualGamepad()
    ours, cam3 = _freefly_script(trt, kb, gp, InputState(kb, gp))
    jkb, jgp = JVirtualKeyboard(), JVirtualGamepad()
    theirs, jcam3 = _freefly_script(jrt, jkb, jgp, JInputState(jkb, jgp))
    assert ours[0][0] < 0 and ours[1][1] == 1.5
    assert ours[2][2][1] == 1500.0
    assert ours[3][2][2] > 1000
    for (y, p, pos), (jy, jp, jpos) in zip(ours, theirs):
        assert y == jy and p == jp
        np.testing.assert_array_equal(pos, jpos)
    c = cam3.camera(device="cpu")
    assert c.position.shape == (1, 3) and c.basis.shape == (1, 3, 3)
    jc = jcam3.camera()
    np.testing.assert_array_equal(c.position[0].numpy(),
                                  np.asarray(jc.position))
    np.testing.assert_array_equal(c.basis[0].numpy(), np.asarray(jc.basis))


def _tool_script(g, kb, inp, spawn):
    """test_game_tool_state's script; the snapshots along the way."""
    snaps = []
    g.tick(inp)                        # paused: nothing moves
    snaps.append(("paused", g.camera()))
    e = g.spawn_player(spawn)
    g.playing = True
    kb.update({"w"})
    g.tick(inp)
    g.tick(inp)
    snaps.append(("walked", g.camera()))
    g.toggle_camera_mode()
    before = g.freefly.position.copy()
    kb.update({"q", "w"})
    g.tick(inp)
    snaps.append(("flew", g.camera()))
    flew = g.freefly.position[1] > before[1]
    g.toggle_camera_mode()
    return e, snaps, flew


def _cam_np(cam, batched):
    pos, basis = np.asarray(cam.position), np.asarray(cam.basis)
    return (pos[0], basis[0]) if batched else (pos, basis)


def test_game_tool_state_matches_jax():
    spawn = (512.0, -10.0, 512.0)
    tlevel = TL.create_test_level()
    g = trt.GameToolState(tcol.compile_collision(tlevel, device="cpu"),
                          tcol.player_params(tlevel, device="cpu"),
                          capacity=8, device="cpu")
    kb, gp = VirtualKeyboard(), VirtualGamepad()
    e, snaps, flew = _tool_script(g, kb, InputState(kb, gp), spawn)

    jlevel = JL.create_test_level()
    jg = jrt.GameToolState(jcol.compile_collision(jlevel),
                           jcol.player_params(jlevel), capacity=8)
    jkb, jgp = JVirtualKeyboard(), JVirtualGamepad()
    je, jsnaps, jflew = _tool_script(jg, jkb, JInputState(jkb, jgp), spawn)

    assert e == je == int(g.state.player[0]) and flew and jflew
    assert g.camera_mode == trt.CameraMode.CHARACTER
    assert float(g.state.time[0]) > 0
    for (label, cam), (_, jcam) in zip(snaps, jsnaps):
        pos, basis = _cam_np(cam, True)
        jpos, jbasis = _cam_np(jcam, False)
        np.testing.assert_allclose(pos, jpos, rtol=1e-5, atol=1e-4,
                                   err_msg=label)
        np.testing.assert_allclose(basis, jbasis, rtol=1e-5, atol=1e-5,
                                   err_msg=label)
    paused_pos = _cam_np(snaps[0][1], True)[0]
    assert np.linalg.norm(paused_pos - g.orbit_target) > 1000
    theirs = _np(jg.state)
    for f in tst.GameState._fields:
        a = getattr(g.state, f)[0].numpy()
        b = np.asarray(getattr(theirs, f))
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-4,
                                       err_msg=f)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)


def test_game_tool_state_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    level = TL.create_test_level()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        trt.GameToolState(tcol.compile_collision(level, device="cpu"),
                          tcol.player_params(level, device="cpu"))


# ---- input (test_input.py's case) ----

def test_to_actions_bridge():
    kb, gp = VirtualKeyboard(), VirtualGamepad()
    inp = InputState(kb, gp)
    kb.update({"w", "left_shift", "space"})
    gp.update(axes=dict(rx=0.8, ry=0.0))
    acts = inp.to_actions(device="cpu")
    assert all(t.shape == (1,) for t in acts)
    assert float(acts.move_y[0]) == 1.0
    assert bool(acts.sprint[0]) and bool(acts.jump[0])
    assert float(acts.cam_x[0]) > 0.7
    jkb, jgp = JVirtualKeyboard(), JVirtualGamepad()
    jinp = JInputState(jkb, jgp)
    jkb.update({"w", "left_shift", "space"})
    jgp.update(axes=dict(rx=0.8, ry=0.0))
    for ours, theirs in zip(acts, jinp.to_actions()):
        assert ours.dtype == torch.from_numpy(np.array(theirs)).dtype
        assert ours[0].item() == np.asarray(theirs).item()

    # drives the port's batched sim one step
    level = TL.create_test_level()
    grid = tcol.compile_collision(level, device="cpu")
    params = tcol.player_params(level, device="cpu")
    s = tst.new_state(1, 8, device="cpu")
    pos = (2.5 * 1024, 0.0, 2.5 * 1024)
    info = level.get_floor_info(pos)
    start_y = (info.floor_height if info is not None else 0.0) - 10.0
    s, _ = tst.spawn_player(s, (pos[0], start_y, pos[2]),
                            level.player_settings)
    s2 = tstep.tick(s, grid, params, acts, 1.0 / 60.0)
    assert bool(s2.jump_was_down[0])
    assert bool(torch.isfinite(s2.pos).all())


# ---- render_game_view ----

SETTINGS = {"rgb555": dict(low_resolution=True),
            "8bit": dict(low_resolution=True, use_rgb555=False)}


@pytest.fixture(scope="module")
def views():
    """The JAX and the port's render_game_view of the open-air night
    level from sc.POSES' Cave cameras at 120x160, each with and without
    the sky, in both pipelines."""
    jlevel = ts.open_air_level(JL, JSky)
    tlevel = ts.open_air_level(TL, TSky)
    jscene = JScene.compile_level(jlevel, ts.textures(), ts.resolver,
                                  with_8bit=True)
    tscene = TScene.compile_level(tlevel, ts.textures(), ts.resolver,
                                  with_8bit=True, device="cpu")
    jtables = jsky.build_sky_tables(JSky.Skybox.from_ron(jlevel.skybox))
    ttables = tsky.build_sky_tables(TSky.Skybox.from_ron(tlevel.skybox),
                                    device="cpu")
    jcams = jax_refs.jax_cams("cave")
    n = jcams.position.shape[0]
    tcams = interop.camera_arrays(_np(jcams))
    size = lambda settings, w, h: (VW, VH)  # noqa: E731
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jvp, "viewport_fb_size", size)
        mp.setattr(tvp, "viewport_fb_size", size)
        for name, kw in SETTINGS.items():
            for with_sky in (False, True):
                js = dataclasses.replace(jconfig.RasterSettings.game(), **kw)
                frames = [jvp.render_game_view(
                    jscene, jax.tree_util.tree_map(lambda x: x[i], jcams),
                    js, (0, 0, 800, 600),
                    sky=jtables if with_sky else None) for i in range(n)]
                ours = tvp.render_game_view(
                    tscene, tcams, _s(**kw), (0, 0, 800, 600),
                    sky=ttables if with_sky else None)
                out[name, with_sky] = (
                    ours, np.stack([np.asarray(f.fb.color) for f in frames]),
                    np.stack([np.asarray(f.fb.depth) for f in frames]),
                    frames[0])
    return out


def _steps(a, b):
    step = np.zeros(a.shape, np.int64)
    for sh in (0, 8, 16, 24):
        step = np.maximum(step, np.abs(((a >> sh) & 255).astype(np.int64)
                                       - ((b >> sh) & 255)))
    return step


@pytest.mark.parametrize("with_sky", [False, True])
def test_render_game_view_matches_jax(views, with_sky):
    ours, jcolor, jdepth, jframe = views["rgb555", with_sky]
    color = ours.fb.color.numpy()
    assert ours.fb_size == jframe.fb_size == (VW, VH)
    assert ours.dest == jframe.dest
    budget = sc.seam_budget(jcolor)
    step = _steps(color, jcolor)
    faces = jdepth != 0.0
    assert faces.mean() > 0.2 and (~faces).mean() > 0.05
    assert int((step[faces] > 0).sum()) <= budget
    if with_sky:
        # the sky (analytic on both sides) within one 8-bit step
        assert int((step[~faces] > 1).sum()) <= budget
        assert int((step[~faces] > 0).sum()) <= budget + jcolor.size // 1000
        assert bool(((color >> 24) & 255 == 255).all())
    else:
        assert not bool(color[~faces].any())


@pytest.mark.parametrize("with_sky", [False, True])
def test_render_game_view_8bit_draws_no_face(views, with_sky):
    """use_rgb555=False on the view's inverse-z clear: the 8-bit pipeline
    draws no face (the JAX package's behaviour, kept); what is left is
    the sky, or the blank clear."""
    ours, jcolor, jdepth, _ = views["8bit", with_sky]
    color = ours.fb.color.numpy()
    assert not bool(ours.fb.depth.any()) and not jdepth.any()
    if with_sky:
        sky_only = views["rgb555", True][0].fb
        # where the RGB555 view drew faces the 8-bit one shows the sky
        assert int(_steps(color, jcolor).max()) <= 1
        assert bool((color != sky_only.color.numpy()).any())
    else:
        assert not color.any() and not jcolor.any()
