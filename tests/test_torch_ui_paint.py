"""The port's ui/ (rect, theme, font, context, icons) against the JAX
package's, on the CPU: UiContext.paint of a queue that holds every
command kind — fills at alpha 128 and 255 (also clipped away), outlines,
opaque and overlapping alpha lines (also clipped), triangles (one
clipped), circles and rings, clipped text, an image — and
draw_icon_centered, into a 120x160 frame of two instances.  Every word
must match (the painted pixels are integers and host data, except the
triangles' edge functions, which agree here too).  The host modules
(Rect, Theme, the font masks, the icon masks, the layout bookkeeping)
are the JAX package's, value for value.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_editor_cases as ec
from bonnie32_tpu import ui as jui
from bonnie32_tpu.types import FrameBuffers as JFB
from bonnie32_tpu_torch import ui as tui
from bonnie32_tpu_torch.types import FrameBuffers

torch.set_num_threads(1)

H, W, N = 120, 160, 2


def _frames():
    r = np.random.default_rng(1)
    color = (r.integers(0, 1 << 24, (N, H, W)) | (255 << 24)).astype(
        np.uint32).view(np.int32)
    return color, np.full((N, H, W), 7.0, np.float32)


def test_paint_every_command_kind():
    color, depth = _frames()
    tctx, jctx = ec.paint_queue(tui), ec.paint_queue(jui)
    assert [c[0] for c in tctx.commands] == [c[0] for c in jctx.commands]
    assert {c[0] for c in tctx.commands} == {
        "fill", "outline", "line", "tri", "circle", "circle_lines", "text",
        "image"}
    out = tctx.paint(FrameBuffers(torch.from_numpy(color.copy()),
                                  torch.from_numpy(depth)))
    for i in range(N):
        ref = jctx.paint(JFB(color=jnp.asarray(color[i]),
                             depth=jnp.asarray(depth[i])))
        got = out.color[i].numpy()
        want = np.asarray(ref.color)
        print(f"instance {i}: {int((got != want).sum())} differing words, "
              f"{int((want != color[i]).sum())} painted")
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(out.depth[i].numpy(),
                                      np.asarray(ref.depth))
    assert np.array_equal(color, _frames()[0]), "the input was written"


@pytest.mark.parametrize("name,scale,rect", ec.ICONS)
def test_draw_icon_centered(name, scale, rect):
    color, depth = _frames()
    out = tui.icons.draw_icon_centered(
        FrameBuffers(torch.from_numpy(color.copy()), torch.from_numpy(depth)),
        name, tui.Rect(*rect), (255, 300, 7), scale=scale)
    for i in range(N):
        ref = jui.icons.draw_icon_centered(
            JFB(color=jnp.asarray(color[i]), depth=jnp.asarray(depth[i])),
            name, jui.Rect(*rect), (255, 300, 7), scale=scale)
        np.testing.assert_array_equal(out.color[i].numpy(),
                                      np.asarray(ref.color))


def test_host_modules_match():
    """Rect, Theme, the font and the icon masks are the JAX package's."""
    a, b = tui.Rect(3, 4, 50, 20), jui.Rect(3, 4, 50, 20)
    assert (a.right, a.bottom, a.contains(10, 10)) == \
        (b.right, b.bottom, b.contains(10, 10))
    assert vars(tui.DEFAULT_THEME) == vars(jui.DEFAULT_THEME)
    for s in ("The quick brown fox 0123456789", "~{}|\x7f", ""):
        for scale in (1, 2):
            np.testing.assert_array_equal(
                tui.font.render_text_mask(s, scale=scale),
                jui.font.render_text_mask(s, scale=scale))
    assert set(tui.icons.ICONS) == set(jui.icons.ICONS)
    for n in tui.icons.ICONS:
        np.testing.assert_array_equal(tui.icons.icon_mask(n, 2),
                                      jui.icons.icon_mask(n, 2))


def test_interaction_state_matches():
    """clicked / held / hover across frames, the same in both packages."""
    trace = []
    for ui in (tui, jui):
        ctx = ui.UiContext()
        r = ui.Rect(10, 10, 40, 20)
        seq = []
        for x, y, down in ((20, 15, False), (20, 15, True), (21, 16, True),
                           (22, 15, False), (80, 80, True), (80, 80, False)):
            ctx.begin_frame(x, y, down)
            seq.append((ctx.hover("h", r), ctx.held("b", r),
                        ctx.clicked("b", r), ctx.hot, ctx.active))
        trace.append(seq)
    assert trace[0] == trace[1]
