"""Device-side camera bases (bonnie32_tpu/ops/camera.py): Camera::
update_basis (camera.rs:76-91) on tensors, for orbiting test and bench
cameras.  up = (0, -1, 0), the screen-space convention.  Trig rounding is
libm's, so bit parity with the JAX side is not promised here; for that,
compute the basis on the host (models/build.camera_basis).
"""

import torch

from ..types import CameraArrays
from .lighting import normalize_rows


def basis_from_angles(pitch, yaw) -> torch.Tensor:
    """pitch/yaw tensors (...,) -> basis (..., 3, 3), rows (bx, by, bz)."""
    pitch = torch.as_tensor(pitch, dtype=torch.float32)
    yaw = torch.as_tensor(yaw, dtype=torch.float32)
    cx, sx = torch.cos(pitch), torch.sin(pitch)
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    bz = torch.stack([cx * sy, -sx, cx * cy], dim=-1)
    up = torch.tensor([0.0, -1.0, 0.0], device=bz.device).expand_as(bz)
    bx = normalize_rows(torch.linalg.cross(up, bz))
    by = torch.linalg.cross(bz, bx)
    return torch.stack([bx, by, bz], dim=-2)


def orbit_cameras(angles, pitch, distance,
                  target=(0.0, 0.0, 0.0)) -> CameraArrays:
    """Cameras orbiting `target` at `distance`, one per angle, looking
    inward."""
    angles = torch.as_tensor(angles, dtype=torch.float32)
    basis = basis_from_angles(
        torch.as_tensor(pitch, dtype=torch.float32).expand(angles.shape),
        angles)
    tgt = torch.tensor(target, dtype=torch.float32, device=basis.device)
    pos = tgt - basis[..., 2, :] * distance
    return CameraArrays(position=pos, basis=basis)
