"""The port's game debug overlay, options menu (game/overlay.py) and
controller view (input/debug.py) against the JAX package's, on the CPU:
the overlay's text lines, the menu's D-pad navigation and toggles on the
same scripted input, and the painted frames — the overlay with its
frame-time bar, the menu, and the controller view (with and without a
gamepad, the deadzone slider dragged) painted over a frame of seeded
words through UiContext.paint — every word equal (all host geometry and
integer pixels: no seam to allow for).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bonnie32_tpu.game import collision as jcol
from bonnie32_tpu.game import overlay as jov
from bonnie32_tpu.game import runtime as jrt
from bonnie32_tpu.game import state as jst
from bonnie32_tpu.input import InputState as JInputState
from bonnie32_tpu.input import debug as jdebug
from bonnie32_tpu.input.state import VirtualGamepad as JVirtualGamepad
from bonnie32_tpu.input.state import VirtualKeyboard as JVirtualKeyboard
from bonnie32_tpu.models import level as JL
from bonnie32_tpu.profiling import FrameTimings as JFrameTimings
from bonnie32_tpu.types import FrameBuffers as JFB
from bonnie32_tpu import ui as jui
from bonnie32_tpu_torch import ui as tui
from bonnie32_tpu_torch.config import RasterSettings
from bonnie32_tpu_torch.game import collision as tcol
from bonnie32_tpu_torch.game import overlay as tov
from bonnie32_tpu_torch.game import runtime as trt
from bonnie32_tpu_torch.game import state as tst
from bonnie32_tpu_torch.input import InputState, debug as tdebug
from bonnie32_tpu_torch.input.state import VirtualGamepad, VirtualKeyboard
from bonnie32_tpu_torch.models import level as TL
from bonnie32_tpu_torch.profiling import FrameTimings
from bonnie32_tpu_torch.types import FrameBuffers

torch.set_num_threads(1)
H, W = 240, 320
POS = (100.0, 50.0, 200.0)
# the player's fields after the spawn: airborne, rising, turned 30 deg
PLAYER = dict(vel=(30.0, 12.5, -40.0), vertical_velocity=12.5,
              grounded=False, room=0, facing=0.5235988)


def _games(with_player):
    """(port GameToolState, JAX GameToolState), the same player."""
    g = trt.GameToolState(
        None, tcol.player_params(TL.create_test_level(), device="cpu"),
        device="cpu")
    jg = jrt.GameToolState(
        grid=None, params=jcol.player_params(JL.create_test_level()))
    if with_player:
        g.state, _ = tst.spawn_player(g.state, POS,
                                      TL.Level().player_settings)
        jg.state, _ = jst.spawn_player(jg.state, POS,
                                       JL.Level().player_settings)
        p = int(g.state.player[0])
        assert p == int(jg.state.player)
        for f, v in PLAYER.items():
            t = getattr(g.state, f).clone()
            t[0, p] = torch.tensor(v, dtype=t.dtype)
            g.state = g.state._replace(**{f: t})
            j = getattr(jg.state, f)
            jg.state = jg.state._replace(
                **{f: j.at[p].set(jnp.asarray(v, j.dtype))})
    return g, jg


def _inputs():
    kb, gp = VirtualKeyboard(), VirtualGamepad()
    jkb, jgp = JVirtualKeyboard(), JVirtualGamepad()
    return (InputState(kb, gp), kb, gp), (JInputState(jkb, jgp), jkb, jgp)


def _lines(lines):
    return [(t, tuple(c)) for t, c in lines]


@pytest.mark.parametrize("with_player", [False, True])
@pytest.mark.parametrize("fps", [60.0, 40.0, 12.0])
def test_overlay_lines_match_jax(with_player, fps):
    g, jg = _games(with_player)
    (inp, kb, gp), (jinp, jkb, jgp) = _inputs()
    for k in (kb, jkb):
        k.update({"left_shift", "w"})       # dodge held + forward
    for p in (gp, jgp):
        p.update(axes=dict(rx=0.4, ry=-0.7))
    got = tov.overlay_lines(g, inp, fps, floor_height=12.0)
    want = jov.overlay_lines(jg, jinp, fps, floor_height=12.0)
    assert _lines(got) == _lines(want)
    texts = [t for t, _ in got]
    if with_player:
        assert "Pos: 100, 50, 200" in texts and "JUMPING" in texts
        assert "SPRINTING" in texts
    else:
        assert "No Player" in texts


# (buttons pressed in turn, starting selection)
SCRIPTS = {
    "down_from_overlay": ([{"dpad_down"}], 1),
    "up_from_affine": ([{"dpad_up"}], 3),
    "down_to_the_end": ([{"dpad_down"}] * 14, 0),
    "up_to_the_top": ([{"dpad_up"}] * 14, 12),
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_menu_navigation_matches_jax(name):
    presses, start = SCRIPTS[name]
    g, jg = _games(False)
    (inp, _, gp), (jinp, _, jgp) = _inputs()
    g.debug_menu_selection = jg.debug_menu_selection = start
    for buttons in presses:
        for pad, game, mod, i in ((gp, g, tov, inp), (jgp, jg, jov, jinp)):
            pad.update(buttons=set())
            pad.update(buttons=buttons)
            mod.menu_navigate(game, i)
        assert g.debug_menu_selection == jg.debug_menu_selection
    assert tov.MENU_ITEMS[g.debug_menu_selection] != "---"


@pytest.mark.parametrize("item", [i for i in tov.MENU_ITEMS if i != "---"])
def test_menu_toggle_matches_jax(item):
    """The toggle of each row, pressed twice (D-pad left the second
    time), on a player's state: settings, FPS limit, overlay flag and
    camera mode follow the JAX package's."""
    assert tov.MENU_ITEMS == jov.MENU_ITEMS
    g, jg = _games(True)
    g.settings = RasterSettings.game(use_rgb555=False, dithering=False)
    jg.settings = dataclasses.replace(jg.settings, use_rgb555=False,
                                      dithering=False)
    (inp, _, gp), (jinp, _, jgp) = _inputs()
    g.debug_menu_selection = jg.debug_menu_selection = \
        tov.MENU_ITEMS.index(item)
    for buttons in ({"a"}, {"dpad_left"}):
        for pad, game, mod, i in ((gp, g, tov, inp), (jgp, jg, jov, jinp)):
            pad.update(buttons=set())
            pad.update(buttons=buttons)
            mod.menu_apply(game, i)
        assert dataclasses.asdict(g.settings) == \
            dataclasses.asdict(jg.settings)
        assert g.fps_limit.value == jg.fps_limit.value
        assert g.show_debug_overlay == jg.show_debug_overlay
        assert g.camera_mode.value == jg.camera_mode.value


def test_tool_state_fields_match_jax():
    g, jg = _games(False)
    for f in ("options_menu_open", "show_debug_overlay",
              "debug_menu_selection", "camera_initialized"):
        assert getattr(g, f) == getattr(jg, f), f
    assert g.fps_limit.value == jg.fps_limit.value
    assert dataclasses.asdict(g.settings) == dataclasses.asdict(jg.settings)
    custom = RasterSettings.game(dithering=False)
    assert trt.GameToolState(None, None, device="cpu",
                             settings=custom).settings == custom


def _frame():
    r = np.random.default_rng(5)
    color = (r.integers(0, 1 << 24, (H, W)) | (255 << 24)).astype(
        np.uint32).view(np.int32)
    return color, np.full((H, W), 3.0, np.float32)


def _paint(ctx, jctx):
    color, depth = _frame()
    out = ctx.paint(FrameBuffers(torch.from_numpy(color.copy())[None],
                                 torch.from_numpy(depth)[None]))
    ref = jctx.paint(JFB(color=jnp.asarray(color), depth=jnp.asarray(depth)))
    got, want = out.color[0].numpy(), np.asarray(ref.color)
    painted = int((want != color).sum())
    print(f"{int((got != want).sum())} differing words, {painted} painted")
    assert painted > 500
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(out.depth[0].numpy(), np.asarray(ref.depth))


@pytest.mark.parametrize("with_player", [False, True])
def test_painted_overlay_and_menu_match_jax(with_player):
    g, jg = _games(with_player)
    g.show_debug_overlay = jg.show_debug_overlay = True
    (inp, _, gp), (jinp, _, jgp) = _inputs()
    for pad in (gp, jgp):
        pad.update(axes=dict(lx=0.6, ly=0.3), buttons={"b", "dpad_down"})
    t, jt = FrameTimings(), JFrameTimings()
    for tt in (t, jt):
        for phase, s in (("input", 0.0012), ("clear", 0.0031),
                         ("render", 0.0104), ("ui", 0.0021)):
            tt.add(phase, s)
    ctx, jctx = tui.UiContext(), jui.UiContext()
    rect, jrect = tui.Rect(0, 0, W, H), jui.Rect(0, 0, W, H)
    for c in (ctx, jctx):
        c.begin_frame(0, 0, False)
    tov.draw_debug_overlay(ctx, g, rect, inp, fps=47.0, timings=t,
                           floor_height=3.0)
    jov.draw_debug_overlay(jctx, jg, jrect, jinp, fps=47.0, timings=jt,
                           floor_height=3.0)
    tov.draw_debug_menu(ctx, g, rect, inp)
    jov.draw_debug_menu(jctx, jg, jrect, jinp)
    assert g.debug_menu_selection == jg.debug_menu_selection == 1
    _paint(ctx, jctx)


@pytest.mark.parametrize("gamepad", [True, False])
def test_painted_controller_view_matches_jax(gamepad):
    (inp, kb, gp), (jinp, jkb, jgp) = _inputs()
    for k in (kb, jkb):
        k.update({"space", "e"})
    if gamepad:            # a pad is connected once it reports
        for pad in (gp, jgp):
            pad.update(axes=dict(lx=-0.5, ly=0.8, rx=0.3, ry=0.0),
                       buttons={"a", "rb", "dpad_up"})
    ctx, jctx = tui.UiContext(), jui.UiContext()
    # the mouse held over the deadzone slider's track (it sets the
    # deadzone to 30%)
    for c in (ctx, jctx):
        c.begin_frame(16 + 60, 36 + 2, True)
    tdebug.draw_controller_debug(ctx, tui.Rect(0, 0, W, H), inp)
    jdebug.draw_controller_debug(jctx, jui.Rect(0, 0, W, H), jinp)
    assert inp.deadzone() == pytest.approx(jinp.deadzone())
    assert inp.deadzone() == pytest.approx(0.3)
    assert inp.has_gamepad() == gamepad
    assert tdebug.build_action_labels(inp.button_labels()) == [
        (tdebug.Action(a.value), s) for a, s in
        jdebug.build_action_labels(jinp.button_labels())]
    _paint(ctx, jctx)
