"""The port's widgets, panels, radial menu, text input and landing page
against the JAX package's, on the CPU (scripts in tests/torch_ui_cases.py,
jax-free, run through both packages):

  * every case of `WIDGET_CASES` (each widget of ui/widgets.py, the split
    and collapsible panels, the radial menu and its submenus) over its
    scripted mouse: per frame the widget's result, the hot and active
    ids, the case's state (DropdownState, the pickers' drag state,
    RadialMenuState, SplitPanel) and the command queue equal; the last
    frame's queue painted by `UiContext.paint` into a 120x320 frame of two
    instances of random words equals the JAX package's paint of each
    instance on every word;
  * the full widget frame of chip_smoke.py (every widget at once at
    640x480, a knob dragged along a seeded path while a dropdown is open):
    trace and painted words equal;
  * `draw_text_input` over a scripted mouse and keyboard run (a
    double-click word selection, typing, shift-extended selections, the
    caret shown) at scale 1 and 2, and `x_to_char_index`: state and words
    equal;
  * the landing page (`draw_landing`, scrolled to its end with a link
    hovered, `draw_landing_ctx`, `draw_link_row`) at 240x320: hovered
    urls, scroll state, link rects, queue and words equal.

Tolerance: none.  Everything compared is host data or integer words
(the UI's layout is host Python in both packages, and the painted pixels
are integers), so every comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ui_cases as uc
from bonnie32_tpu import ui as jui
from bonnie32_tpu.types import FrameBuffers as JFB
from bonnie32_tpu_torch import ui as tui
from bonnie32_tpu_torch.types import FrameBuffers

torch.set_num_threads(1)

H, W, N = 120, 320, 2


def _frames(n, h, w, seed=1):
    r = np.random.default_rng(seed)
    color = (r.integers(0, 1 << 24, (n, h, w)) | (255 << 24)).astype(
        np.uint32).view(np.int32)
    return color, np.full((n, h, w), 7.0, np.float32)


def _fb(color, depth):
    return FrameBuffers(torch.from_numpy(color.copy()),
                        torch.from_numpy(depth.copy()))


def _jfb(color, depth, i):
    return JFB(color=jnp.asarray(color[i]), depth=jnp.asarray(depth[i]))


def _assert_painted_equal(tctx, jctx, color, depth):
    out = tctx.paint(_fb(color, depth))
    for i in range(color.shape[0]):
        ref = jctx.paint(_jfb(color, depth, i))
        want = np.asarray(ref.color)
        print(f"instance {i}: {int((out.color[i].numpy() != want).sum())} "
              f"differing words, {int((want != color[i]).sum())} painted")
        np.testing.assert_array_equal(out.color[i].numpy(), want)
        np.testing.assert_array_equal(out.depth[i].numpy(),
                                      np.asarray(ref.depth))
    return out


@pytest.mark.parametrize("name", sorted(uc.WIDGET_CASES))
def test_widget_case_matches_jax(name):
    tctx, trace = uc.run_case(tui, name)
    jctx, jtrace = uc.run_case(jui, name)
    assert len(trace) == len(uc.WIDGET_CASES[name][1])
    for k, (a, b) in enumerate(zip(trace, jtrace)):
        assert a == b, f"frame {k}"
    assert tctx.commands, "the case queued nothing"
    color, depth = _frames(N, H, W)
    out = _assert_painted_equal(tctx, jctx, color, depth)
    assert (out.color.numpy() != color).any()


def test_cases_exercise_their_widgets():
    """The scripts reach the states they are there for (on the port)."""
    res = {name: [f[0] for f in uc.run_case(tui, name)[1]]
           for name in uc.WIDGET_CASES}
    assert res["button"][2] is True
    assert res["dropdown_pick"][2] == 2
    assert res["dropdown_block"][0][0] is False     # the press swallowed
    assert res["vlist"][1] == 1
    assert res["knob"][-1][1] is True               # started editing
    assert {r[0] for r in res["knob"][:3]} == {95, 127, 0}
    assert res["tab_bar_with_auth"][2][1] is True
    assert res["split_panel"][-1][3] is True        # the header clicked
    assert res["radial_submenu"][-1][0] == ("d", "d", None)
    _, trace = uc.run_case(tui, "dropdown")
    assert dict(trace[-1][3])["state"][1][0][1] == "dd"   # still open


def test_widget_frame_matches_jax():
    """Every widget at once on the editor's 640x480 window."""
    tctx, trace = uc.widget_frame(tui, 0)
    jctx, jtrace = uc.widget_frame(jui, 0)
    assert trace == jtrace
    assert len(trace) == uc.FRAME_COUNT
    knob = [f[0][-1] for f in trace]
    assert all(v[0] is not None for v in knob), knob
    kinds = {c[0] for c in tctx.commands}
    assert {"fill", "outline", "line", "text", "circle"} <= kinds
    w, h = uc.FRAME_SIZE
    color, depth = _frames(1, h, w, seed=4)
    _assert_painted_equal(tctx, jctx, color, depth)


def test_widget_frame_mouse_is_seeded_inside_the_knob():
    a, b = uc.frame_mouse(0), uc.frame_mouse(0)
    assert a == b and a != uc.frame_mouse(1)
    for x, y, down in a:
        assert down
        assert (x - uc.KNOB_CENTER[0]) ** 2 + (y - uc.KNOB_CENTER[1]) ** 2 \
            < 20.0 ** 2


@pytest.mark.parametrize("scale", [1, 2])
def test_text_input_matches_jax(scale):
    color, depth = _frames(N, H, W, seed=3)
    fb, trace = uc.text_input_calls(tui, _fb(color, depth), scale)
    assert trace[-2][4] is not None                 # a selection shows
    for i in range(N):
        jfb, jtrace = uc.text_input_calls(jui, _jfb(color, depth, i), scale)
        assert trace == jtrace
        np.testing.assert_array_equal(fb.color[i].numpy(),
                                      np.asarray(jfb.color))
    assert (fb.color.numpy() != color).any()


def test_landing_matches_jax():
    h, w = 240, 320
    color, depth = _frames(1, h, w, seed=5)
    fb, out = uc.landing_calls(tui, _fb(color, depth), w, h)
    jfb, jout = uc.landing_calls(jui, _jfb(color, depth, 0), w, h)
    assert out == jout
    assert out[0] is None and out[1] == out[2] == out[3] \
        == uc.sub(tui, "landing").LINKS[0][1]
    assert out[5][0] == out[5][1] < 0.0             # scrolled to the end
    np.testing.assert_array_equal(fb.color[0].numpy(), np.asarray(jfb.color))
