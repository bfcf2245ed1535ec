"""Cases of the datagen fleet's surroundings shared by
tests/test_torch_gpu.py and chip_smoke.py (`run_fleet`); imports no jax.

`room_tables(scene)` cuts one room's tables out of a CompiledScene (the
inputs `profiling.raster_stats` takes); `paint_debug_views(fb)` paints
the game's debug overlay (with its frame-time bar), the options menu and
the controller view, with a spawned player and scripted gamepad input,
over the frame `fb` on its device.
"""

import torch

from bonnie32_tpu_torch.types import FrameBuffers

SPAWN = (4096.0, 900.0, 4096.0)
# the player's fields after the spawn: airborne, rising, turned 30 deg
PLAYER = dict(vel=(30.0, 12.5, -40.0), vertical_velocity=12.5,
              grounded=False, facing=0.5235988)


def room_tables(scene, room: int = 0):
    """(mesh, faces, atlas, lights, fog) of room `room` of a
    CompiledScene, the lights at the room's ambient."""
    def pick(tree):
        return type(tree)(*(x[room] for x in tree))
    return (pick(scene.mesh), pick(scene.faces), pick(scene.atlas),
            scene.lights._replace(ambient=scene.ambient[room]),
            pick(scene.fog))


def paint_debug_views(fb: FrameBuffers) -> FrameBuffers:
    """The debug overlay, the menu (cursor moved one row down) and the
    controller view (a gamepad reporting sticks and buttons, the mouse
    dragging the deadzone slider) painted over `fb` ((I, H, W)) on its
    device; the game state lives there too."""
    from bonnie32_tpu_torch import ui
    from bonnie32_tpu_torch.game import overlay as ov
    from bonnie32_tpu_torch.game import runtime as rt
    from bonnie32_tpu_torch.game import state as st
    from bonnie32_tpu_torch.input import InputState, debug
    from bonnie32_tpu_torch.input.state import VirtualGamepad, VirtualKeyboard
    from bonnie32_tpu_torch.models import level as L
    from bonnie32_tpu_torch.profiling import FrameTimings

    dev = fb.color.device
    h, w = fb.color.shape[-2:]
    game = rt.GameToolState(None, None, device=dev)
    game.state, _ = st.spawn_player(game.state, SPAWN,
                                    L.Level().player_settings)
    p = int(game.state.player[0])
    for f, v in PLAYER.items():
        t = getattr(game.state, f).clone()
        t[0, p] = torch.tensor(v, dtype=t.dtype, device=dev)
        game.state = game.state._replace(**{f: t})
    game.show_debug_overlay = True
    kb, gp = VirtualKeyboard(), VirtualGamepad()
    kb.update({"left_shift", "w"})
    gp.update(axes=dict(lx=0.6, ly=0.3, rx=0.3, ry=-0.2),
              buttons={"b", "dpad_down"})
    inp = InputState(kb, gp)
    timings = FrameTimings()
    for phase, s in (("input", 0.0012), ("clear", 0.0031),
                     ("render", 0.0104), ("ui", 0.0021)):
        timings.add(phase, s)
    ctx = ui.UiContext()
    ctx.begin_frame(16 + 60, h // 2 + 36 + 2, True)
    rect = ui.Rect(0, 0, w, h)
    ov.draw_debug_overlay(ctx, game, rect, inp, fps=47.0, timings=timings,
                          floor_height=512.0)
    ov.draw_debug_menu(ctx, game, rect, inp)
    debug.draw_controller_debug(ctx, ui.Rect(0, h // 2, w, h - h // 2),
                                inp)
    return ctx.paint(fb)
