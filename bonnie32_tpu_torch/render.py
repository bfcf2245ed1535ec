"""Mesh rendering, `render_mesh_15` (bonnie32_tpu/render.py;
render.rs:2302), batched over cameras: the vertex/cull/fog stage
(ops/surface.py) and then one rasterizer:

  * "fast": the visibility-reduction path (ops/raster_fast.py), for the
    z-buffer without x-ray under perspective projection; otherwise the
    sequential compositor in "inv" mode, or "harmonic" under ortho;
  * "inv": the sequential compositor (ops/raster_ref.py), inverse-z depth;
  * "harmonic": the same with the reference's z semantics.

The wireframe phases (render.rs:2573-2633) run after the solids when the
settings enable them; in `wireframe_overlay` mode the solid passes are
skipped (render.rs:2550).  Everything is torch code: on CUDA tensors it
runs on the card, on CPU tensors on the CPU.
"""

from .config import RasterSettings
from .ops import wireframe as wf
from .ops.raster_fast import rasterize_surfaces_fast
from .ops.raster_ref import rasterize_surfaces
from .ops.surface import build_surfaces
from .types import (CameraArrays, FaceArrays, Fog, FrameBuffers, Lights,
                    MeshArrays, TextureAtlas)

DEPTH_MODES = ("fast", "inv", "harmonic")


def _fast_ok(settings: RasterSettings) -> bool:
    return (settings.use_zbuffer and not settings.xray_mode
            and settings.ortho_projection is None)


def raster_mode(settings: RasterSettings, depth_mode: str = "fast") -> str:
    """The rasterizer `render_mesh_15` takes: "fast" where it can draw
    the settings; otherwise "fast" falls back to "inv", or to "harmonic"
    under ortho, whose depth can be <= 0, where inverse-z ordering breaks
    (render.rs:1545 divides 1/z whatever the projection)."""
    if depth_mode not in DEPTH_MODES:
        raise ValueError(f"unknown depth mode {depth_mode!r}")
    if depth_mode != "fast":
        return depth_mode
    if _fast_ok(settings):
        return "fast"
    return "harmonic" if settings.ortho_projection is not None else "inv"


def render_mesh_15(fb: FrameBuffers, mesh: MeshArrays, faces: FaceArrays,
                   atlas: TextureAtlas, cams: CameraArrays, lights: Lights,
                   fog: Fog, settings: RasterSettings,
                   depth_mode: str = "fast") -> FrameBuffers:
    """One mesh into (I, H, W) framebuffers, one camera of `cams` ((I,)
    CameraArrays) each.  `fb.depth` must be cleared for the rasterizer
    the mode takes (raster_ref.new_framebuffer: 0 for "fast" and "inv",
    F32_MAX for "harmonic")."""
    n, height, width = fb.color.shape
    mode = raster_mode(settings, depth_mode)
    if not settings.wireframe_overlay:
        surfaces = build_surfaces(mesh, faces, atlas, cams, lights, fog,
                                  settings, width, height)
        if mode == "fast":
            fb = rasterize_surfaces_fast(fb, surfaces, atlas, settings)
        else:
            fb = rasterize_surfaces(fb, surfaces, atlas, settings,
                                    depth_mode=mode)
    if wf.wires_on(settings):
        fb = wf.render_wireframes(fb, mesh, faces, cams, fog, settings,
                                  depth_mode="inv" if mode == "fast"
                                  else mode)
    return fb
