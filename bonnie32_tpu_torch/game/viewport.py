"""Game viewport rendering: framebuffer size, sky, scene, presentation
(bonnie32_tpu/game/viewport.py).

The headless counterpart of the reference's `draw_test_viewport`
(renderer.rs:20-230): size the framebuffer from the resolution settings
(:34-49), draw the sky and the level through the sequential scene
renderer, and report where the frame lands in the viewport rect
(:183-199).  The texture upload of renderer.rs:179 becomes returning the
framebuffer.
"""

from typing import NamedTuple, Tuple

from ..config import RasterSettings
from ..models import scene as scene_mod
from ..ops import raster_ref
from ..ops import skybox as sky_ops
from ..types import CameraArrays, FrameBuffers
from .runtime import present_rect, viewport_fb_size

# Letterbox bar colour (renderer.rs:202): rgb(10, 10, 12).
LETTERBOX_RGBA = (10, 10, 12, 255)


class ViewportFrame(NamedTuple):
    fb: FrameBuffers          # (I, H, W) packed RGBA8 colour + depth
    fb_size: Tuple[int, int]  # (W, H)
    dest: Tuple[float, float, float, float]  # draw x, y, w, h in the rect


def render_game_view(scene: scene_mod.CompiledScene, cams: CameraArrays,
                     settings: RasterSettings,
                     rect: Tuple[float, float, float, float],
                     sky=None, depth_mode: str = "fast") -> ViewportFrame:
    """One game-view frame per camera of `cams` ((I,) CameraArrays),
    sized by `low_resolution` / `stretch_to_fill`, on the cameras'
    device.  rect: (x, y, w, h) of the viewport in screen units.

    The frame is cleared for inverse z; with a `sky` (ops.skybox
    SkyTables) its plane and stars are drawn first (`raster_sky` on the
    card), at time 0 as the JAX package draws it; then
    models.scene.render_level.  Under `use_rgb555=False` the 8-bit
    pipeline tests z < depth on that inverse-z clear and draws no face
    (the JAX package's behaviour, kept).  Returns the framebuffers and
    the destination rectangle (letterboxed in 4:3 mode)."""
    x, y, w, h = rect
    fb_w, fb_h = viewport_fb_size(settings, w, h)
    if sky is not None:
        fb = sky_ops.render_skybox(sky, cams, fb_h, fb_w, time=0.0)
    else:
        fb = raster_ref.new_framebuffer(fb_h, fb_w, depth_mode="inv",
                                        n=cams.position.shape[0],
                                        device=cams.position.device)
    fb = scene_mod.render_level(fb, scene, cams, settings,
                                depth_mode=depth_mode)
    return ViewportFrame(fb=fb, fb_size=(fb_w, fb_h),
                         dest=present_rect(settings, fb_w, fb_h, x, y, w, h))
