"""Vertex transform and projection (bonnie32_tpu/ops/vertex.py).

The TRANSFORM phase of `render_mesh_15` (render.rs:2313-2360) on tensors
of any leading shape: camera-space transform, then the PS1 fixed-point
projection or the float perspective projection.  The JAX package routes
divisions through ops/exactf (f64 residuals) because the TPU's f32
divide is not correctly rounded; torch's `/` is IEEE on the CPU and the
GPU, so plain division gives the same correctly rounded quotient.
"""

from typing import NamedTuple

import torch

from .._host.config import PROJ_DISTANCE, RasterSettings
from ..types import CameraArrays
from . import fixed as fx


class TransformedVerts(NamedTuple):
    sx: torch.Tensor   # (...,) f32 screen x
    sy: torch.Tensor   # (...,) f32 screen y
    sz: torch.Tensor   # (...,) f32 screen-space depth
    cam: torch.Tensor  # (..., 3) f32 camera-space position


def perspective_transform(v, basis):
    """math.rs:103: rotate (..., 3) by basis rows (..., 3, 3)."""
    def dot(row):
        return (v[..., 0] * row[..., 0] + v[..., 1] * row[..., 1]
                + v[..., 2] * row[..., 2])

    return torch.stack([dot(basis[..., 0, :]), dot(basis[..., 1, :]),
                        dot(basis[..., 2, :])], dim=-1)


def project_float(cam, width: int, height: int):
    """math.rs:117: float perspective projection (z = cam_z + DISTANCE,
    or the screen centre and cam_z in the |denom| < 0.001 guard)."""
    us = PROJ_DISTANCE - 1.0
    vs = (min(width, height) / 2.0) * 0.75
    hw = width / 2.0
    hh = height / 2.0
    x, y, z = cam[..., 0], cam[..., 1], cam[..., 2]
    denom = z + PROJ_DISTANCE
    tiny = denom.abs() < 0.001
    safe = torch.where(tiny, torch.ones_like(denom), denom)
    sx = (x * us) / safe * vs + hw
    sy = (y * us) / safe * vs + hh
    sx = torch.where(tiny, torch.full_like(sx, hw), sx)
    sy = torch.where(tiny, torch.full_like(sy, hh), sy)
    return sx, sy, torch.where(tiny, z, denom)


def transform_vertices(pos, camera: CameraArrays, settings: RasterSettings,
                       width: int, height: int) -> TransformedVerts:
    """Camera transform + projection of world points `pos` (..., 3); the
    camera's position (..., 3) and basis (..., 3, 3) broadcast against
    them.  Ortho projection is not part of the ported slice."""
    if settings.ortho_projection is not None:
        raise NotImplementedError(
            "ortho projection is not ported yet (ROADMAP.md queue 1)")
    rel = pos - camera.position
    cam = perspective_transform(rel, camera.basis)
    if settings.use_fixed_point:
        # PS1 path (render.rs:2329-2345): integer screen coords from the
        # fixed pipeline; screen depth = float cam_z + DISTANCE
        isx, isy, _ = fx.project_fixed(pos, camera.position, camera.basis,
                                       width, height)
        return TransformedVerts(sx=isx.to(torch.float32),
                                sy=isy.to(torch.float32),
                                sz=cam[..., 2] + PROJ_DISTANCE, cam=cam)
    sx, sy, sz = project_float(cam, width, height)
    return TransformedVerts(sx=sx, sy=sy, sz=sz, cam=cam)
