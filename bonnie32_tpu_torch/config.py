"""Rasterizer settings and enums (the port's own copy of the JAX package's
`config.py`, which imports nothing of jax).

Mirrors the behavioural toggles of the reference renderer
(the reference's `src/rasterizer/types.rs:1289-1495`): shading mode, blend
modes, and the full PS1 quirk set (affine textures, z-buffer vs painter's,
dithering, RGB555, fixed-point projection, x-ray, ...).

Unlike the reference, lights are NOT part of the settings struct here — they
are device arrays (see ops/lighting.py) so they can vary per instance without
recompilation.  `RasterSettings` is a frozen, hashable dataclass: it is passed
as a *static* argument to jitted functions because its fields select compiled
control flow.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple


class ShadingMode(enum.IntEnum):
    """Reference: `rasterizer/types.rs:1289` (ShadingMode)."""

    NONE = 0
    FLAT = 1
    GOURAUD = 2


class BlendMode(enum.IntEnum):
    """PS1 semi-transparency blend modes.

    Reference: `rasterizer/types.rs:1380` (BlendMode).  B = back (framebuffer)
    pixel, F = front (incoming) pixel.
    """

    OPAQUE = 0       # overwrite
    AVERAGE = 1      # mode 0: 0.5*B + 0.5*F
    ADD = 2          # mode 1: B + F, clamped
    SUBTRACT = 3     # mode 2: B - F, clamped
    ADD_QUARTER = 4  # mode 3: B + 0.25*F, clamped
    ERASE = 5        # write transparent


@dataclasses.dataclass(frozen=True)
class OrthoProjection:
    """Reference: `rasterizer/types.rs:1432` (OrthoProjection)."""

    zoom: float
    center_x: float
    center_y: float


@dataclasses.dataclass(frozen=True)
class RasterSettings:
    """Reference: `rasterizer/types.rs:1392` (RasterSettings), minus lights.

    Defaults match `RasterSettings::default()` (`types.rs:1475-1494`).
    """

    affine_textures: bool = True
    use_zbuffer: bool = True
    shading: ShadingMode = ShadingMode.GOURAUD
    backface_cull: bool = True
    backface_wireframe: bool = True
    ambient: float = 0.3
    low_resolution: bool = False
    dithering: bool = True
    stretch_to_fill: bool = True
    wireframe_overlay: bool = False
    ortho_projection: Optional[OrthoProjection] = None
    use_rgb555: bool = True
    use_fixed_point: bool = True
    xray_mode: bool = False

    @classmethod
    def game(cls, **kw) -> "RasterSettings":
        """In-game rendering settings (`types.rs:1455`)."""
        return cls(backface_wireframe=False, **kw)

    @classmethod
    def modeler(cls, **kw) -> "RasterSettings":
        """Asset-modeler settings (`types.rs:1465`); ambient-only lighting.

        The reference also empties the light list; pass empty light arrays.
        """
        kw.setdefault("ambient", 0.7)
        return cls(backface_wireframe=False, **kw)


# Native PS1 resolutions. Reference: `rasterizer/constants.rs:5-15`.
WIDTH = 320
HEIGHT = 240
WIDTH_HI = 640
HEIGHT_HI = 480

# Near plane. Reference: `rasterizer/math.rs:155`.
NEAR_PLANE = 0.1

# Projection constants. Reference: `rasterizer/math.rs:117-136`.
PROJ_DISTANCE = 5.0
PROJ_SCALE = 0.75
