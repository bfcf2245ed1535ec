"""Multi-light vertex shading (bonnie32_tpu/ops/lighting.py).

`shade_multi_light_color` (render.rs:1013-1071): ambient plus per-light
directional / point / spot contributions, channel-clamped to 1.0.  The
flat level compile evaluates it once per scene (the shade tables are
camera-independent), so it runs on the host.  sqrt and divide are IEEE
in torch; spot lights' acos is libm-defined, as in the JAX package.
"""

import torch

from ..types import Lights
from .fixed import sqrt_rn


def _dot3(ax, ay, az, bx, by, bz):
    """x*x' + y*y' + z*z', left-associated (math.rs:23)."""
    return ax * bx + ay * by + az * bz


def _normalize3(x, y, z):
    """Vec3::normalize (math.rs:39-49), zero-length guarded."""
    ln = sqrt_rn(_dot3(x, y, z, x, y, z))
    zero = ln == 0.0
    safe = torch.where(zero, torch.ones_like(ln), ln)
    zf = torch.zeros_like(ln)
    return (torch.where(zero, zf, x / safe), torch.where(zero, zf, y / safe),
            torch.where(zero, zf, z / safe))


def normalize_rows(v):
    """Vec3::normalize on (..., 3) rows."""
    return torch.stack(_normalize3(v[..., 0], v[..., 1], v[..., 2]), dim=-1)


def shade_points(normal, world_pos, lights: Lights, ambient=None):
    """Per-point RGB shade in [0, 1] (render.rs:1013).  `ambient`
    overrides lights.ambient per point (the flat scene's per-room
    ambient).  Lights accumulate in array order."""
    nx, ny, nz = normal[..., 0], normal[..., 1], normal[..., 2]
    px, py, pz = world_pos[..., 0], world_pos[..., 1], world_pos[..., 2]
    amb = lights.ambient if ambient is None else ambient
    total_r = torch.broadcast_to(amb, nx.shape).to(torch.float32)
    total_g = total_r
    total_b = total_r
    zero = torch.zeros_like(nx)

    for i in range(lights.kind.shape[0]):
        kind = int(lights.kind[i])
        if kind == 0:
            continue     # disabled: the JAX select adds an exact 0.0 * color
        ldir = lights.direction[i]
        inten = lights.intensity[i]
        radius = lights.radius[i]
        angle = lights.angle[i]
        if kind == 1:
            c = torch.clamp(_dot3(nx, ny, nz, -ldir[0], -ldir[1], -ldir[2]),
                            min=0.0) * inten
        else:
            lpos = lights.position[i]
            tx, ty, tz = lpos[0] - px, lpos[1] - py, lpos[2] - pz
            dist = sqrt_rn(_dot3(tx, ty, tz, tx, ty, tz))
            out_of_range = (dist > radius) | (dist < 0.001)
            ux, uy, uz = _normalize3(tx, ty, tz)
            att = 1.0 - dist / torch.where(radius == 0,
                                           torch.ones_like(radius), radius)
            ndl = torch.clamp(_dot3(nx, ny, nz, ux, uy, uz), min=0.0)
            if kind == 2:
                c = torch.where(out_of_range, zero, ndl * inten * att * att)
            else:
                spot_cos = _dot3(-ux, -uy, -uz, ldir[0], ldir[1], ldir[2])
                spot_angle = torch.acos(spot_cos)
                safe_angle = torch.where(angle == 0,
                                         torch.ones_like(angle), angle)
                edge = 1.0 - spot_angle / safe_angle
                c = torch.where(out_of_range | (spot_angle > angle), zero,
                                ndl * inten * att * att * edge)
        total_r = total_r + c * lights.color01[i, 0]
        total_g = total_g + c * lights.color01[i, 1]
        total_b = total_b + c * lights.color01[i, 2]

    return torch.stack([torch.clamp(total_r, max=1.0),
                        torch.clamp(total_g, max=1.0),
                        torch.clamp(total_b, max=1.0)], dim=-1)
