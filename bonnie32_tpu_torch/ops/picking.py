"""Ray picking and viewport-geometry math (bonnie32_tpu/ops/picking.py).

Everything the editors use to turn mouse positions into 3D intent:
screen->ray inverse projection, world->screen overlays, ray/line and
ray/plane queries for drag gizmos, Moller-Trumbore triangle picking,
near-plane clipping, and 4x4 transform helpers (the reference's
`src/rasterizer/ray.rs` and `src/rasterizer/math.rs:194-807`).  Option<T>
returns become (value, valid_mask) pairs so every function broadcasts over
batched inputs.

Inputs may be tensors, numpy arrays or Python numbers; each function runs
on the device of its first tensor input (the host callers, editor/hover.py
and editor/viewport_edit.py, pass numpy and run on the CPU).  Card and CPU
agree bit for bit: no `@` (cuBLAS contracts into FMAs), every 3-term sum
and cross product written out left to right as
`vertex.perspective_transform` does, every divisor a tensor (torch on CUDA
turns `x / python_scalar` into a multiply by the reciprocal), every square
root `fixed.sqrt_rn` (torch's CPU sqrt is not correctly rounded).
"""

import numpy as np
import torch

from ..config import NEAR_PLANE, PROJ_DISTANCE, PROJ_SCALE
from ..types import as_f32, device_of, f32_scalar
from .fixed import sqrt_rn
from .vertex import normalize_rows, perspective_transform

_F32 = torch.float32

def _dot(a, b):
    """a . b over the last axis of (..., 3) tensors, left to right."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def _cross(a, b):
    """a x b over the last axis, each component one product difference."""
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]],
                       dim=-1)


# ---------------------------------------------------------------------------
# Screen <-> world (ray.rs:46-143, math.rs:503-650)
# ---------------------------------------------------------------------------

def screen_to_ray(screen_x, screen_y, width: int, height: int,
                  cam_pos, basis):
    """ray.rs:46: perspective inverse of project().

    basis: (..., 3, 3) rows = camera x/y/z axes in world space.  Returns
    (origin (..., 3), direction (..., 3) normalized).  The virtual camera
    sits DISTANCE behind the eye, so directions use dz=1, dx=ndc/us."""
    dev = device_of(screen_x, screen_y, cam_pos, basis)
    screen_x = as_f32(screen_x, dev)
    screen_y = as_f32(screen_y, dev)
    basis = as_f32(basis, dev)
    vs = f32_scalar(min(width, height) / 2.0 * PROJ_SCALE, dev)
    us = f32_scalar(PROJ_DISTANCE - 1.0, dev)
    ndc_x = (screen_x - float(np.float32(width / 2.0))) / vs
    ndc_y = (screen_y - float(np.float32(height / 2.0))) / vs
    dx, dy = ndc_x / us, ndc_y / us
    # d_cam @ basis: the sum of the axes weighted by (dx, dy, 1)
    world_dir = (dx[..., None] * basis[..., 0, :]
                 + dy[..., None] * basis[..., 1, :] + basis[..., 2, :])
    origin = torch.broadcast_to(as_f32(cam_pos, dev), world_dir.shape)
    return origin, normalize_rows(world_dir)


def screen_to_ray_ortho(screen_x, screen_y, width: int, height: int,
                        cam_pos, basis, zoom, center_x, center_y):
    """ray.rs:108: parallel rays from the ortho view plane."""
    dev = device_of(screen_x, screen_y, cam_pos, basis)
    screen_x = as_f32(screen_x, dev)
    screen_y = as_f32(screen_y, dev)
    basis = as_f32(basis, dev)
    z = f32_scalar(zoom, dev)
    cx = ((screen_x - float(np.float32(width / 2.0))) / z
          + float(np.float32(center_x)))
    cy = (-((screen_y - float(np.float32(height / 2.0))) / z)
          + float(np.float32(center_y)))
    origin = (as_f32(cam_pos, dev) + cx[..., None] * basis[..., 0, :]
              + cy[..., None] * basis[..., 1, :])
    direction = torch.broadcast_to(basis[..., 2, :], origin.shape)
    return origin, direction


def screen_to_ray_auto(screen_x, screen_y, width: int, height: int,
                       cam_pos, basis, ortho=None):
    """ray.rs:131."""
    if ortho is None:
        return screen_to_ray(screen_x, screen_y, width, height, cam_pos,
                             basis)
    return screen_to_ray_ortho(screen_x, screen_y, width, height, cam_pos,
                               basis, ortho.zoom, ortho.center_x,
                               ortho.center_y)


def world_to_screen(world_pos, cam_pos, basis, width: int, height: int):
    """math.rs:509: forward projection for UI overlays.  The basis
    (..., 3, 3) broadcasts against the points' leading axes (a camera per
    instance: basis (I, 1, 3, 3) over points (I, E, 3)).

    Returns (sx, sy, cam_z, valid); valid is False behind the camera
    (cam_z <= 0.1)."""
    dev = device_of(world_pos, cam_pos, basis)
    rel = as_f32(world_pos, dev) - as_f32(cam_pos, dev)
    cam = perspective_transform(rel, as_f32(basis, dev))
    cam_z = cam[..., 2]
    valid = cam_z > 0.1
    vs = float(np.float32(min(width, height) / 2.0 * PROJ_SCALE))
    us = float(np.float32(PROJ_DISTANCE - 1.0))
    denom = torch.where(valid, cam_z + float(PROJ_DISTANCE),
                        torch.ones_like(cam_z))
    sx = (cam[..., 0] * us) / denom * vs + float(np.float32(width / 2.0))
    sy = (cam[..., 1] * us) / denom * vs + float(np.float32(height / 2.0))
    return sx, sy, cam_z, valid


def world_to_screen_ortho(world_pos, cam_pos, basis, width: int, height: int,
                          zoom, center_x, center_y):
    """math.rs:538 (ortho arm): matches project_ortho()."""
    dev = device_of(world_pos, cam_pos, basis)
    rel = as_f32(world_pos, dev) - as_f32(cam_pos, dev)
    cam = perspective_transform(rel, as_f32(basis, dev))
    z = float(np.float32(zoom))
    sx = ((cam[..., 0] - float(np.float32(center_x))) * z
          + float(np.float32(width / 2.0)))
    sy = (-((cam[..., 1] - float(np.float32(center_y))) * z)
          + float(np.float32(height / 2.0)))
    valid = torch.ones(sx.shape, dtype=torch.bool, device=dev)
    return sx, sy, cam[..., 2], valid


# ---------------------------------------------------------------------------
# Ray queries (ray.rs:151-262)
# ---------------------------------------------------------------------------

def ray_at(origin, direction, t):
    dev = device_of(origin, direction, t)
    return (as_f32(origin, dev)
            + as_f32(t, dev)[..., None] * as_f32(direction, dev))


def ray_line_closest_point(origin, direction, line_origin, line_dir):
    """ray.rs:151: closest point on an infinite line to a ray.

    Returns (point (..., 3), s, valid); valid False when near-parallel
    (|denom| < 1e-4)."""
    dev = device_of(origin, direction, line_origin, line_dir)
    lo = as_f32(line_origin, dev)
    w = as_f32(origin, dev) - lo
    d1 = as_f32(direction, dev)
    d2 = as_f32(line_dir, dev)
    a = _dot(d1, d1)
    b = _dot(d1, d2)
    c = _dot(d2, d2)
    d = _dot(w, d1)
    e = _dot(w, d2)
    denom = a * c - b * b
    valid = denom.abs() >= 0.0001
    s = (a * e - d * b) / torch.where(valid, denom, torch.ones_like(denom))
    point = lo + s[..., None] * d2
    return point, s, valid


def ray_plane_intersection(origin, direction, plane_point, plane_normal):
    """ray.rs:214: (t, valid); invalid when parallel or behind the
    origin."""
    dev = device_of(origin, direction, plane_point, plane_normal)
    d = as_f32(direction, dev)
    n = as_f32(plane_normal, dev)
    denom = _dot(d, n)
    ok = denom.abs() >= 0.0001
    t = (_dot(as_f32(plane_point, dev) - as_f32(origin, dev), n)
         / torch.where(ok, denom, torch.ones_like(denom)))
    return t, ok & (t >= 0.0)


def ray_circle_angle(origin, direction, center, axis, ref_vector):
    """ray.rs:239: rotation-gizmo angle; (angle, valid)."""
    dev = device_of(origin, direction, center, axis, ref_vector)
    t, ok = ray_plane_intersection(origin, direction, center, axis)
    hit = ray_at(as_f32(origin, dev), as_f32(direction, dev), t)
    from_center = hit - as_f32(center, dev)
    dist = sqrt_rn(_dot(from_center, from_center))
    ok = ok & (dist >= 0.0001)
    ref = as_f32(ref_vector, dev)
    perp = _cross(as_f32(axis, dev), ref)
    x = _dot(from_center, ref)
    y = _dot(from_center, perp)
    return torch.atan2(y, x), ok


def ray_triangle_intersect(origin, direction, v0, v1, v2):
    """math.rs:413: Moller-Trumbore; (t, hit).  Broadcasts over triangle
    arrays for one-shot scene picking."""
    dev = device_of(origin, direction, v0, v1, v2)
    eps = 1e-7
    v0 = as_f32(v0, dev)
    e1 = as_f32(v1, dev) - v0
    e2 = as_f32(v2, dev) - v0
    d = as_f32(direction, dev)
    h = _cross(d, e2)
    a = _dot(e1, h)
    ok = a.abs() >= float(np.float32(eps))
    f = torch.ones_like(a) / torch.where(ok, a, torch.ones_like(a))
    s = as_f32(origin, dev) - v0
    u = f * _dot(s, h)
    ok = ok & (u >= 0.0) & (u <= 1.0)
    q = _cross(s, e1)
    v = f * _dot(d, q)
    ok = ok & (v >= 0.0) & (u + v <= 1.0)
    t = f * _dot(e2, q)
    ok = ok & (t > float(np.float32(eps)))
    return t, ok


def pick_triangle(origin, direction, tri_verts, valid=None):
    """Nearest hit over (..., T, 3, 3) triangles -> (index, t, any_hit),
    one per ray of `origin`/`direction` (..., 3).

    index is -1 when nothing is hit.  The editors' hover/click picking
    (viewport_3d.rs hover detection) as one vectorized query.  The first
    of equal nearest hits wins (torch.argmin, like jnp.argmin, returns
    the first minimum; with no hit every t is inf and index 0 is taken,
    then masked to -1)."""
    dev = device_of(origin, direction, tri_verts)
    o = as_f32(origin, dev)[..., None, :]
    d = as_f32(direction, dev)[..., None, :]
    tv = as_f32(tri_verts, dev)
    t, hit = ray_triangle_intersect(o, d, tv[..., 0, :], tv[..., 1, :],
                                    tv[..., 2, :])
    if valid is not None:
        hit = hit & torch.as_tensor(valid, device=dev)
    t_masked = torch.where(hit, t, torch.full_like(t, float("inf")))
    idx = torch.argmin(t_masked, dim=-1)
    any_hit = hit.any(dim=-1)
    best = torch.gather(t_masked, -1, idx[..., None])[..., 0]
    return (torch.where(any_hit, idx.to(torch.int32),
                        torch.full_like(idx, -1, dtype=torch.int32)),
            best, any_hit)


# ---------------------------------------------------------------------------
# 2D helpers (math.rs:655-711)
# ---------------------------------------------------------------------------

def point_to_segment_distance(px, py, x1, y1, x2, y2):
    """math.rs:655."""
    dev = device_of(px, py, x1, y1, x2, y2)
    px, py, x1, y1, x2, y2 = [as_f32(v, dev) for v in (px, py, x1, y1, x2, y2)]
    dx = x2 - x1
    dy = y2 - y1
    len_sq = dx * dx + dy * dy
    degen = len_sq < 1e-6
    t = torch.clamp(((px - x1) * dx + (py - y1) * dy)
                    / torch.where(degen, torch.ones_like(len_sq), len_sq),
                    0.0, 1.0)
    cx = torch.where(degen, x1, x1 + t * dx)
    cy = torch.where(degen, y1, y1 + t * dy)
    ex, ey = px - cx, py - cy
    return sqrt_rn(ex * ex + ey * ey)


def point_in_triangle_2d(px, py, x1, y1, x2, y2, x3, y3):
    """math.rs:687: sign test, winding-independent."""
    dev = device_of(px, py, x1, y1, x2, y2, x3, y3)
    px, py, x1, y1, x2, y2, x3, y3 = [as_f32(v, dev) for v in
                                      (px, py, x1, y1, x2, y2, x3, y3)]

    def sign(ax, ay, bx, by):
        return (px - bx) * (ay - by) - (ax - bx) * (py - by)
    d1 = sign(x1, y1, x2, y2)
    d2 = sign(x2, y2, x3, y3)
    d3 = sign(x3, y3, x1, y1)
    has_neg = (d1 < 0) | (d2 < 0) | (d3 < 0)
    has_pos = (d1 > 0) | (d2 > 0) | (d3 > 0)
    return ~(has_neg & has_pos)


def barycentric_2d(p, v1, v2, v3):
    """math.rs:390: screen-space barycentric; degenerate -> (-1,-1,-1)."""
    dev = device_of(p, v1, v2, v3)
    p, v1, v2, v3 = [as_f32(v, dev) for v in (p, v1, v2, v3)]
    d = ((v2[..., 1] - v3[..., 1]) * (v1[..., 0] - v3[..., 0])
         + (v3[..., 0] - v2[..., 0]) * (v1[..., 1] - v3[..., 1]))
    degen = d.abs() < 0.00001
    dd = torch.where(degen, torch.ones_like(d), d)
    u = ((v2[..., 1] - v3[..., 1]) * (p[..., 0] - v3[..., 0])
         + (v3[..., 0] - v2[..., 0]) * (p[..., 1] - v3[..., 1])) / dd
    v = ((v3[..., 1] - v1[..., 1]) * (p[..., 0] - v3[..., 0])
         + (v1[..., 0] - v3[..., 0]) * (p[..., 1] - v3[..., 1])) / dd
    w = 1.0 - u - v
    bad = torch.full_like(u, -1.0)
    return (torch.where(degen, bad, u), torch.where(degen, bad, v),
            torch.where(degen, bad, w))


# ---------------------------------------------------------------------------
# Near-plane clipping (math.rs:194-377)
# ---------------------------------------------------------------------------

def clip_edge_to_near_plane(v1, v2):
    """math.rs:366: ((a, b), visible); endpoints clipped at z=NEAR_PLANE."""
    dev = device_of(v1, v2)
    v1 = as_f32(v1, dev)
    v2 = as_f32(v2, dev)
    f1 = v1[..., 2] > NEAR_PLANE
    f2 = v2[..., 2] > NEAR_PLANE
    visible = f1 | f2
    near = float(np.float32(NEAR_PLANE))

    def clip_from(front, back):
        t = (near - front[..., 2]) / (back[..., 2] - front[..., 2])
        return front + t[..., None] * (back - front)

    a = torch.where(f1[..., None], v1, clip_from(v2, v1))
    b = torch.where(f2[..., None], v2, clip_from(v1, v2))
    return (a, b), visible


def clip_triangle_to_near_plane(v1, v2, v3):
    """math.rs:194: clip one triangle, fixed-shape output.

    Returns (tris (2, 3, 3), weights (2, 3, 3), tri_valid (2,)):
      * 3 in front  -> tri 0 = original, identity weights, tri 1 invalid.
      * 1 in front  -> tri 0 = (front, clip1, clip2), tri 1 invalid.
      * 2 in front  -> both tris valid (the reference's quad split).
      * 0 in front  -> both invalid.
    weights[i, j] are barycentric weights of output corner j in the
    ORIGINAL corner basis, as the reference hands back for attribute
    lerp."""
    dev = device_of(v1, v2, v3)
    verts = torch.stack([as_f32(v1, dev), as_f32(v2, dev),
                         as_f32(v3, dev)])  # (3, 3)
    eye = torch.eye(3, dtype=_F32, device=dev)
    in_front = verts[:, 2] > NEAR_PLANE
    n_front = in_front.to(torch.int32).sum()
    near = float(np.float32(NEAR_PLANE))

    def pick(mask):
        # the first True index (the reference takes the first match)
        return torch.argmax(mask.to(torch.int32))

    # --- case 1: exactly one vertex in front ---
    fi = pick(in_front)
    b1 = (fi + 1) % 3
    b2 = (fi + 2) % 3
    front, back1, back2 = verts[fi], verts[b1], verts[b2]
    t1 = (near - front[2]) / (back1[2] - front[2])
    t2 = (near - front[2]) / (back2[2] - front[2])
    one_tri = torch.stack([front, front + t1 * (back1 - front),
                           front + t2 * (back2 - front)])
    one_w = torch.stack([eye[fi],
                         (1.0 - t1) * eye[fi] + t1 * eye[b1],
                         (1.0 - t2) * eye[fi] + t2 * eye[b2]])

    # --- case 2: exactly two vertices in front ---
    bi = pick(~in_front)
    f1i = (bi + 1) % 3
    f2i = (bi + 2) % 3
    back, front1, front2 = verts[bi], verts[f1i], verts[f2i]
    s1 = (near - front1[2]) / (back[2] - front1[2])
    s2 = (near - front2[2]) / (back[2] - front2[2])
    clip1 = front1 + s1 * (back - front1)
    clip2 = front2 + s2 * (back - front2)
    w_clip1 = (1.0 - s1) * eye[f1i] + s1 * eye[bi]
    w_clip2 = (1.0 - s2) * eye[f2i] + s2 * eye[bi]
    two_tri_a = torch.stack([front1, clip1, front2])
    two_w_a = torch.stack([eye[f1i], w_clip1, eye[f2i]])
    two_tri_b = torch.stack([clip1, clip2, front2])
    two_w_b = torch.stack([w_clip1, w_clip2, eye[f2i]])

    tri0 = torch.where(n_front == 3, verts,
                       torch.where(n_front == 1, one_tri, two_tri_a))
    w0 = torch.where(n_front == 3, eye,
                     torch.where(n_front == 1, one_w, two_w_a))
    tris = torch.stack([tri0, two_tri_b])
    weights = torch.stack([w0, two_w_b])
    tri_valid = torch.stack([n_front > 0, n_front == 2])
    return tris, weights, tri_valid


# ---------------------------------------------------------------------------
# Mat4 (math.rs:713-777)
# ---------------------------------------------------------------------------

def mat4_identity(device=None):
    return torch.eye(4, dtype=_F32, device=device)


def mat4_translation(t):
    dev = device_of(t)
    m = torch.eye(4, dtype=_F32, device=dev)
    m[:3, 3] = as_f32(t, dev)
    return m


def mat4_rotation(rot_deg):
    """math.rs:738: ZYX Euler (degrees), Blender order."""
    dev = device_of(rot_deg)
    r = torch.deg2rad(as_f32(rot_deg, dev))
    sx, cx = torch.sin(r[0]), torch.cos(r[0])
    sy, cy = torch.sin(r[1]), torch.cos(r[1])
    sz, cz = torch.sin(r[2]), torch.cos(r[2])
    zero = torch.zeros_like(sx)
    one = torch.ones_like(sx)
    return torch.stack([
        torch.stack([cy * cz, sx * sy * cz - cx * sz,
                     cx * sy * cz + sx * sz, zero]),
        torch.stack([cy * sz, sx * sy * sz + cx * cz,
                     cx * sy * sz - sx * cz, zero]),
        torch.stack([-sy, sx * cy, cx * cy, zero]),
        torch.stack([zero, zero, zero, one])])


def mat4_mul(a, b):
    """a @ b, each entry's 4-term sum written out left to right."""
    dev = device_of(a, b)
    a = as_f32(a, dev)
    b = as_f32(b, dev)
    rows = []
    for i in range(4):
        rows.append(torch.stack([
            a[..., i, 0] * b[..., 0, j] + a[..., i, 1] * b[..., 1, j]
            + a[..., i, 2] * b[..., 2, j] + a[..., i, 3] * b[..., 3, j]
            for j in range(4)], dim=-1))
    return torch.stack(rows, dim=-2)


def mat4_transform_point(m, p):
    """p @ m[:3, :3].T + m[:3, 3]."""
    dev = device_of(m, p)
    m = as_f32(m, dev)
    return (perspective_transform(as_f32(p, dev), m[..., :3, :3])
            + m[..., :3, 3])


def mat4_from_position_rotation(position, rotation_deg):
    return mat4_mul(mat4_translation(position), mat4_rotation(rotation_deg))

