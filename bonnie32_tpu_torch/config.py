"""Raster settings and enums: the JAX package's `config.py`, loaded as is
through the `_host` alias (it imports nothing of jax)."""

from ._host.config import (HEIGHT, HEIGHT_HI, NEAR_PLANE,  # noqa: F401
                           PROJ_DISTANCE, PROJ_SCALE, WIDTH, WIDTH_HI,
                           BlendMode, OrthoProjection, RasterSettings,
                           ShadingMode)
