"""Asset/model browser: discovery, selection, and orbit preview
(bonnie32_tpu/editor/model_browser.py).

Headless port of the reference's `src/modeler/model_browser.rs`:
sample/user asset discovery with namespaced library keys
(`sample:`/`user:` prefixes), the browser state machine (category
sections, selection, rename), and the orbit-camera preview that renders
the selected asset's mesh parts through the real pipeline into a
320x240 framebuffer (:184-257 defaults: yaw 0.5, pitch 0.3, distance
4096, center (0, 1024, 0)).

Discovery and the browser state are host code, copied from the JAX
package.  `render_preview` renders on the card unless the caller passes
`device="cpu"`: the part arrays, atlas, lights and camera that
models/build makes on the CPU move to that device first.
"""

import dataclasses
import enum
import os
from typing import List, Optional, Tuple

import numpy as np

from ..config import RasterSettings
from ..models import build
from ..ops import raster_ref
from ..render import render_mesh_15
from ..types import (CameraArrays, FrameBuffers, no_fog, resolve_device,
                     to_device)


class AssetCategory(enum.Enum):
    SAMPLE = "sample"
    USER = "user"

    @property
    def prefix(self) -> str:
        return f"{self.value}:"


@dataclasses.dataclass(frozen=True)
class AssetInfo:
    """model_browser.rs:39-56."""

    name: str
    path: str
    category: AssetCategory

    @property
    def library_key(self) -> str:
        return f"{self.category.prefix}{self.name}"


def discover_assets_from_dir(path: str, category: AssetCategory
                             ) -> List[AssetInfo]:
    """.ron files sorted by name (model_browser.rs discover_*)."""
    try:
        names = sorted(os.listdir(path))
    except OSError:
        return []
    return [AssetInfo(name=os.path.splitext(n)[0],
                      path=os.path.join(path, n), category=category)
            for n in names if n.endswith(".ron")]


@dataclasses.dataclass
class AssetBrowser:
    """model_browser.rs:184 — browser state + orbit preview camera."""

    open: bool = False
    samples: List[AssetInfo] = dataclasses.field(default_factory=list)
    user_assets: List[AssetInfo] = dataclasses.field(default_factory=list)
    samples_collapsed: bool = False
    user_collapsed: bool = False
    selected_category: Optional[AssetCategory] = None
    selected_index: Optional[int] = None
    orbit_yaw: float = 0.5
    orbit_pitch: float = 0.3
    orbit_distance: float = 4096.0
    orbit_center: Tuple[float, float, float] = (0.0, 1024.0, 0.0)
    scroll_offset: float = 0.0
    rename_text: Optional[str] = None

    def open_with_assets(self, samples: List[AssetInfo],
                         user_assets: List[AssetInfo]) -> None:
        self.open = True
        self.samples = list(samples)
        self.user_assets = list(user_assets)
        self.selected_category = None
        self.selected_index = None

    def close(self) -> None:
        self.open = False

    def select(self, category: AssetCategory, index: int
               ) -> Optional[AssetInfo]:
        items = self.samples if category == AssetCategory.SAMPLE \
            else self.user_assets
        if not (0 <= index < len(items)):
            return None
        self.selected_category = category
        self.selected_index = index
        return items[index]

    def selected(self) -> Optional[AssetInfo]:
        if self.selected_category is None or self.selected_index is None:
            return None
        items = self.samples \
            if self.selected_category == AssetCategory.SAMPLE \
            else self.user_assets
        if self.selected_index >= len(items):
            return None
        return items[self.selected_index]

    def orbit(self, dx: float, dy: float) -> None:
        """Preview drag: yaw/pitch, pitch clamped (model_browser.rs)."""
        self.orbit_yaw += dx * 0.01
        self.orbit_pitch = max(-1.4, min(self.orbit_pitch + dy * 0.01, 1.4))

    def zoom(self, factor: float) -> None:
        self.orbit_distance = max(256.0, min(self.orbit_distance * factor,
                                             65536.0))

    def preview_camera(self):
        basis = build.camera_basis(self.orbit_pitch, self.orbit_yaw)
        center = np.asarray(self.orbit_center, np.float32)
        pos = center - basis[2] * np.float32(self.orbit_distance)
        return build.make_camera(pos.astype(np.float32), basis)

    def render_preview(self, asset, user_textures=None,
                       height: int = 240, width: int = 320,
                       settings: Optional[RasterSettings] = None,
                       device=None) -> FrameBuffers:
        """Render the asset's visible mesh parts with the orbit camera
        (the preview_fb path), resolving each part's texture like the
        scene renderer does: one view, (1, height, width), on the card
        unless `device` names another."""
        from ..models.scene import resolve_part_texture15

        settings = settings or (RasterSettings.modeler()
                                if hasattr(RasterSettings, "modeler")
                                else RasterSettings.game())
        dev = resolve_device(device)
        cam = self.preview_camera()
        cam = CameraArrays(position=cam.position.reshape(1, 3).to(dev),
                           basis=cam.basis.reshape(1, 3, 3).to(dev))
        lights = to_device(build.lights_from_list([], ambient=0.7), dev)
        fog = no_fog(device=dev)
        fb = raster_ref.new_framebuffer(height, width,
                                        depth_mode="harmonic", device=dev)
        parts = asset.mesh() if hasattr(asset, "mesh") else []
        for part in parts:
            if not getattr(part, "visible", True):
                continue
            verts, faces = part.mesh.to_render_data_textured()
            if not verts:
                continue
            tex15 = resolve_part_texture15(part, user_textures)
            mesh, fa = _part_arrays(verts, faces)
            atlas = build.build_atlas([(tex15, 0)])
            fb = render_mesh_15(fb, to_device(mesh, dev), to_device(fa, dev),
                                to_device(atlas, dev), cam, lights, fog,
                                settings, depth_mode="harmonic")
        return fb


def _part_arrays(verts, faces):
    """A part's render data as CPU tensors (models/build)."""
    pos = np.array([v["pos"] for v in verts], np.float32)
    uv = np.array([v["uv"] for v in verts], np.float32)
    normal = np.array([v["normal"] for v in verts], np.float32)
    color = np.array([v["color"] for v in verts], np.int32)
    cblend = np.array([v.get("color_blend", 0) for v in verts], np.int32)
    mesh = build.make_mesh_arrays(pos, uv, normal, color, cblend)
    vidx = np.array([(f["v0"], f["v1"], f["v2"]) for f in faces], np.int32)
    tid = np.array([0 if f.get("tex_id") is not None else -1
                    for f in faces], np.int32)
    fa = build.make_face_arrays(vidx, tid)
    return mesh, fa
