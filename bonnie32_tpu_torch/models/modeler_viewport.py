"""Modeler 4-panel viewport: Top / Front / Side ortho + Perspective
(bonnie32_tpu/models/modeler_viewport.py).

Headless port of the reference's `src/modeler/viewport.rs` (view setup
:660-790) and `rasterizer/camera.rs:27-74` (canned ortho bases): each
pane renders the edited mesh part through the real pipeline —
orthographic panes via `OrthoProjection` (zoom/pan state per pane),
the perspective pane via an orbit camera — plus the 2x2 split layout
and pan/zoom camera controls.

The layout and cameras are host data.  `render_view`,
`render_all_views` and `render_view_with_skeleton` render on the card
unless the caller passes `device="cpu"`: the mesh, atlas, lights and
camera (models/build makes CPU tensors) move to that device first, and
each pane is one view, FrameBuffers (1, H, W).  The skeleton's octahedra
are built on the host (animation.skeleton_to_triangles).
"""

import dataclasses
import enum
from typing import Dict, Optional, Tuple

import numpy as np

from ..config import OrthoProjection, RasterSettings
from ..render import render_mesh_15
from ..ops import raster_ref
from ..types import (CameraArrays, FrameBuffers, no_fog, resolve_device,
                     to_device)
from ..ui import Rect, UiContext
from . import build

VIEW_DISTANCE = 50000.0   # viewport.rs:741


class ViewportId(enum.Enum):
    TOP = "top"
    FRONT = "front"
    SIDE = "side"
    PERSPECTIVE = "perspective"


# camera.rs:27-74 — rows are basis_x / basis_y / basis_z
ORTHO_BASES = {
    ViewportId.TOP: np.array([[-1.0, 0.0, 0.0],
                              [0.0, 0.0, 1.0],
                              [0.0, 1.0, 0.0]], np.float32),
    ViewportId.FRONT: np.array([[1.0, 0.0, 0.0],
                                [0.0, 1.0, 0.0],
                                [0.0, 0.0, -1.0]], np.float32),
    ViewportId.SIDE: np.array([[0.0, 0.0, 1.0],
                               [0.0, 1.0, 0.0],
                               [-1.0, 0.0, 0.0]], np.float32),
}

# camera positions along the view axis (viewport.rs:742-756)
ORTHO_POSITIONS = {
    ViewportId.TOP: np.array([0.0, VIEW_DISTANCE, 0.0], np.float32),
    ViewportId.FRONT: np.array([0.0, 0.0, VIEW_DISTANCE], np.float32),
    ViewportId.SIDE: np.array([VIEW_DISTANCE, 0.0, 0.0], np.float32),
}


@dataclasses.dataclass
class OrthoCamera:
    """Per-pane pan/zoom (state.rs get_ortho_camera)."""

    zoom: float = 0.2
    center: Tuple[float, float] = (0.0, 0.0)

    def pan(self, dx_px: float, dy_px: float) -> None:
        """Drag pans in world units (screen px / zoom); screen y is
        flipped for the vertical axis like project_ortho."""
        self.center = (self.center[0] - dx_px / self.zoom,
                       self.center[1] + dy_px / self.zoom)

    def zoom_by(self, factor: float) -> None:
        self.zoom = min(max(self.zoom * factor, 1e-4), 100.0)


@dataclasses.dataclass
class PerspectiveCamera:
    """Orbit camera for the perspective pane."""

    azimuth: float = 0.8
    elevation: float = 0.35
    distance: float = 6.0
    target: Tuple[float, float, float] = (0.0, 0.0, 0.0)

    def camera(self) -> CameraArrays:
        basis = build.camera_basis(self.elevation, self.azimuth)
        offset = -basis[2] * self.distance
        pos = np.asarray(self.target, np.float32) + offset
        return build.make_camera(pos.astype(np.float32), basis)


@dataclasses.dataclass
class ModelerViewports:
    """The 2x2 pane grid + per-pane cameras."""

    cameras: Dict[ViewportId, OrthoCamera] = dataclasses.field(
        default_factory=lambda: {v: OrthoCamera()
                                 for v in (ViewportId.TOP, ViewportId.FRONT,
                                           ViewportId.SIDE)})
    perspective: PerspectiveCamera = dataclasses.field(
        default_factory=PerspectiveCamera)
    single_pane: Optional[ViewportId] = None   # maximized pane, if any

    def pane_rects(self, bounds: Rect) -> Dict[ViewportId, Rect]:
        """2x2 quad layout: Top | Perspective / Front | Side."""
        if self.single_pane is not None:
            return {self.single_pane: bounds}
        hw = bounds.w / 2
        hh = bounds.h / 2
        return {
            ViewportId.TOP: Rect(bounds.x, bounds.y, hw, hh),
            ViewportId.PERSPECTIVE: Rect(bounds.x + hw, bounds.y, hw, hh),
            ViewportId.FRONT: Rect(bounds.x, bounds.y + hh, hw, hh),
            ViewportId.SIDE: Rect(bounds.x + hw, bounds.y + hh, hw, hh),
        }


def view_settings(settings: RasterSettings, view: ViewportId,
                  cam: Optional[OrthoCamera]) -> RasterSettings:
    """Install the pane's OrthoProjection (viewport.rs:760-774)."""
    if view == ViewportId.PERSPECTIVE:
        return dataclasses.replace(settings, ortho_projection=None)
    assert cam is not None
    return dataclasses.replace(
        settings, ortho_projection=OrthoProjection(
            zoom=cam.zoom, center_x=cam.center[0],
            center_y=cam.center[1]))


def view_camera(viewports: ModelerViewports,
                view: ViewportId) -> CameraArrays:
    if view == ViewportId.PERSPECTIVE:
        return viewports.perspective.camera()
    return build.make_camera(ORTHO_POSITIONS[view], ORTHO_BASES[view])


def _draw(fb: FrameBuffers, viewports: ModelerViewports, view: ViewportId,
          mesh, faces, atlas, lights, settings: RasterSettings):
    """One mesh into the pane's frame on fb's device, harmonic depth."""
    dev = fb.color.device
    s = view_settings(settings, view, viewports.cameras.get(view))
    camera = view_camera(viewports, view)
    camera = CameraArrays(position=camera.position.reshape(1, 3).to(dev),
                          basis=camera.basis.reshape(1, 3, 3).to(dev))
    mesh, faces, atlas, lights = (to_device(x, dev)
                                  for x in (mesh, faces, atlas, lights))
    return render_mesh_15(fb, mesh, faces, atlas, camera, lights,
                          no_fog(device=dev), s, depth_mode="harmonic")


def render_view(viewports: ModelerViewports, view: ViewportId,
                mesh, faces, atlas, lights, settings: RasterSettings,
                height: int, width: int, device=None) -> FrameBuffers:
    """One pane's frame through the real pipeline, (1, height, width) on
    the card unless `device` names another."""
    # harmonic depth (the literal reference semantics): ortho panes have
    # arbitrary-sign camera-space z, which the inverse-z fast mode assumes
    # positive
    fb = raster_ref.new_framebuffer(height, width, depth_mode="harmonic",
                                    device=resolve_device(device))
    return _draw(fb, viewports, view, mesh, faces, atlas, lights, settings)


def render_all_views(viewports: ModelerViewports, mesh, faces, atlas,
                     lights, settings: RasterSettings, bounds: Rect,
                     pane_h: int = 120, pane_w: int = 160, device=None
                     ) -> Dict[ViewportId, FrameBuffers]:
    """All visible panes rendered at (pane_h, pane_w) each."""
    out = {}
    for view in viewports.pane_rects(bounds):
        out[view] = render_view(viewports, view, mesh, faces, atlas,
                                lights, settings, pane_h, pane_w, device)
    return out


def composite_views(ctx: UiContext, viewports: ModelerViewports,
                    frames: Dict[ViewportId, FrameBuffers],
                    bounds: Rect) -> None:
    """Blit each pane's framebuffer into its rect + label + border (the
    pane's words stay on their device until `paint`)."""
    rects = viewports.pane_rects(bounds)
    for view, rect in rects.items():
        fb = frames.get(view)
        if fb is not None:
            ctx.commands.append(("image", (rect.x, rect.y), fb.color[0]))
        ctx.outline(rect, (70, 70, 80))
        ctx.text(rect.x + 3, rect.y + 3, view.value.upper(),
                 (160, 160, 170))


def skeleton_arrays(bones, alpha: int = 200, pose=None):
    """skeleton_to_triangles -> CPU tensors (models/build) for a
    render_mesh_15 overlay pass (the host cost is per-edit, not per-frame
    — cache by caller)."""
    from . import build
    from .animation import skeleton_to_triangles

    verts, faces = skeleton_to_triangles(bones, alpha=alpha, pose=pose)
    if not faces:
        return None
    pos = np.array([v["pos"] for v in verts], np.float32)
    normal = np.array([v["normal"] for v in verts], np.float32)
    color = np.array([v["color"] for v in verts], np.int32)
    mesh = build.make_mesh_arrays(pos, normal=normal, color=color)
    vidx = np.array([(f["v0"], f["v1"], f["v2"]) for f in faces], np.int32)
    fa = build.make_face_arrays(
        vidx,
        black_transparent=np.array([f["black_transparent"] for f in faces]),
        editor_alpha=np.array([f["editor_alpha"] for f in faces], np.int32))
    atlas = build.build_atlas([(np.full((1, 1), 0x7FFF, np.uint16), 0)])
    return mesh, fa, atlas


def render_view_with_skeleton(viewports: ModelerViewports, view: ViewportId,
                              mesh, faces, atlas, lights,
                              settings: RasterSettings,
                              height: int, width: int, bones,
                              pose=None, device=None) -> FrameBuffers:
    """draw_viewport's rigging mode (modeler/viewport.rs:1407-1410): the
    mesh pass, then the bone octahedrons alpha-composited on top through
    the same pipeline (skeleton.rs:42 draw_skeleton)."""
    fb = render_view(viewports, view, mesh, faces, atlas, lights,
                     settings, height, width, device)
    sk = skeleton_arrays(bones, alpha=200, pose=pose)
    if sk is None:
        return fb
    return _draw(fb, viewports, view, *sk, lights, settings)


def project_arrays(project, resolve_texture15=None):
    """Merge every VISIBLE part of a MeshProject into one mesh (CPU
    tensors, models/build) for the pane renders (the reference renders
    parts in order into the same framebuffer, modeler/viewport.rs:1376).
    Hidden parts are excluded; untextured parts render with vertex colors
    only."""
    from . import build

    pos, uv, normal, color, cblend, vidx = [], [], [], [], [], []
    base = 0
    for part in project.objects:
        if not part.visible:
            continue
        verts, faces = part.mesh.to_render_data_textured()
        if not verts:
            continue
        for v in verts:
            pos.append(v["pos"])
            uv.append(v["uv"])
            normal.append(v["normal"])
            color.append(v["color"])
            cblend.append(v.get("color_blend", 0))
        for f in faces:
            vidx.append((f["v0"] + base, f["v1"] + base, f["v2"] + base))
        base += len(verts)
    if not vidx:
        pos = [(0.0, 0.0, 0.0)]
        uv = [(0.0, 0.0)]
        normal = [(0.0, 0.0, 0.0)]
        color = [(128, 128, 128)]
        cblend = [0]
        vidx = [(0, 0, 0)]
    mesh = build.make_mesh_arrays(
        np.asarray(pos, np.float32), uv=np.asarray(uv, np.float32),
        normal=np.asarray(normal, np.float32),
        color=np.asarray(color, np.int32),
        color_blend=np.asarray(cblend, np.int32))
    fa = build.make_face_arrays(np.asarray(vidx, np.int32))
    atlas = build.build_atlas([(np.full((1, 1), 0x7FFF, np.uint16), 0)])
    return mesh, fa, atlas
