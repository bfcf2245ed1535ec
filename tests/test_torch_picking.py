"""The port's ops/picking.py against the JAX package's, on the CPU, on
numpy-seeded inputs: every function, rays behind the camera, rays
parallel to a plane, pick_triangle with no hit and with ties.

Floats agree within rtol 1e-5 / atol 1e-4 (XLA:CPU may contract a
product and a sum into one FMA where torch rounds twice, and its dot
products may sum in another order); masks and indices are exact.
"""

import numpy as np
import pytest
import torch

from bonnie32_tpu.config import OrthoProjection as JOrtho
from bonnie32_tpu.ops import picking as jpk
from bonnie32_tpu_torch.config import OrthoProjection
from bonnie32_tpu_torch.models import build
from bonnie32_tpu_torch.ops import picking as pk

torch.set_num_threads(1)

W, H = 320, 240
RTOL, ATOL = 1e-5, 1e-4
BASIS = build.camera_basis(0.3, 0.7)
CAMPOS = np.array([1.0, -2.0, -5.0], np.float32)


def _close(ours, theirs, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(theirs),
                               rtol=rtol, atol=atol)


def _same(ours, theirs):
    np.testing.assert_array_equal(np.asarray(ours), np.asarray(theirs))


def _rng(seed=0):
    return np.random.default_rng(seed)


def _points(n=64, seed=0):
    """World points in front of and behind the camera."""
    cam = (_rng(seed).standard_normal((n, 3)) * 4.0).astype(np.float32)
    cam[: n // 4, 2] = -np.abs(cam[: n // 4, 2]) - 0.5     # behind
    cam[n // 4:, 2] = np.abs(cam[n // 4:, 2]) + 0.2
    return (CAMPOS + cam @ BASIS).astype(np.float32)


def _pixels(n=64, seed=1):
    r = _rng(seed)
    return (r.uniform(-20, W + 20, n).astype(np.float32),
            r.uniform(-20, H + 20, n).astype(np.float32))


@pytest.mark.parametrize("ortho", [False, True], ids=["persp", "ortho"])
def test_screen_to_ray(ortho):
    sx, sy = _pixels()
    o = OrthoProjection(2.5, 0.3, -1.2) if ortho else None
    jo = JOrtho(2.5, 0.3, -1.2) if ortho else None
    ours = pk.screen_to_ray_auto(torch.from_numpy(sx), torch.from_numpy(sy),
                                 W, H, CAMPOS, BASIS, o)
    theirs = jpk.screen_to_ray_auto(sx, sy, W, H, CAMPOS, BASIS, jo)
    for a, b in zip(ours, theirs):
        assert tuple(a.shape) == tuple(b.shape)
        _close(a, b)


@pytest.mark.parametrize("ortho", [False, True], ids=["persp", "ortho"])
def test_world_to_screen(ortho):
    pts = _points()
    if ortho:
        ours = pk.world_to_screen_ortho(torch.from_numpy(pts), CAMPOS,
                                        BASIS, W, H, 2.5, 0.3, -1.2)
        theirs = jpk.world_to_screen_ortho(pts, CAMPOS, BASIS, W, H, 2.5,
                                           0.3, -1.2)
    else:
        ours = pk.world_to_screen(torch.from_numpy(pts), CAMPOS, BASIS, W,
                                  H)
        theirs = jpk.world_to_screen(pts, CAMPOS, BASIS, W, H)
    for a, b in zip(ours[:3], theirs[:3]):
        _close(a, b)
    _same(ours[3], theirs[3])
    if not ortho:
        assert not bool(ours[3][:16].any()) and bool(ours[3][16:].all())


def test_world_to_screen_batched_cameras():
    """A camera per instance: basis (I, 1, 3, 3) over points (I, E, 3)
    equals each camera alone."""
    pts = _points(12)
    bases = np.stack([build.camera_basis(p, y) for p, y in
                      ((0.1, 0.2), (-0.3, 2.0), (0.5, -1.0))])
    pos = np.stack([CAMPOS, CAMPOS + 1.0, CAMPOS - 2.0]).astype(np.float32)
    got = pk.world_to_screen(torch.from_numpy(pts)[None],
                             torch.from_numpy(pos)[:, None],
                             torch.from_numpy(bases)[:, None], W, H)
    for i in range(3):
        one = pk.world_to_screen(torch.from_numpy(pts), pos[i], bases[i], W,
                                 H)
        for a, b in zip(got, one):
            _same(a[i], b)


def test_ray_plane_and_line():
    r = _rng(2)
    o = r.standard_normal((48, 3)).astype(np.float32) * 3
    d = r.standard_normal((48, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    n = np.array([0.0, 1.0, 0.0], np.float32)
    d[:6, 1] = 0.0                       # parallel to the plane
    d[6:12, 1] = np.abs(d[6:12, 1]) * np.sign(o[6:12, 1] + 1e-3)  # behind
    pp = np.array([0.5, -0.25, 2.0], np.float32)
    t, ok = pk.ray_plane_intersection(torch.from_numpy(o),
                                      torch.from_numpy(d), pp, n)
    jt, jok = jpk.ray_plane_intersection(o, d, pp, n)
    _same(ok, jok)
    assert not bool(ok[:6].any()) and not bool(ok[6:12].any())
    _close(t[ok], np.asarray(jt)[np.asarray(jok)])

    lo = np.array([0.0, 0.0, 0.0], np.float32)
    ld = np.array([1.0, 0.0, 0.0], np.float32)
    d[:4] = ld                           # parallel to the line
    got = pk.ray_line_closest_point(torch.from_numpy(o), torch.from_numpy(d),
                                    lo, ld)
    want = jpk.ray_line_closest_point(o, d, lo, ld)
    _same(got[2], want[2])
    assert not bool(got[2][:4].any())
    for a, b in zip(got[:2], want[:2]):
        _close(a, b, rtol=1e-4, atol=1e-3)


def test_ray_circle_angle_and_ray_at():
    r = _rng(3)
    o = (r.standard_normal((32, 3)) * 2 + [0, 5, 0]).astype(np.float32)
    d = np.tile(np.array([0.0, -1.0, 0.0], np.float32), (32, 1))
    d[:, 0] = r.uniform(-0.3, 0.3, 32)
    d[:3] = (1.0, 0.0, 0.0)              # parallel to the gizmo plane
    args = (np.zeros(3, np.float32), np.array([0, 1, 0], np.float32),
            np.array([1, 0, 0], np.float32))
    a, ok = pk.ray_circle_angle(torch.from_numpy(o), torch.from_numpy(d),
                                *args)
    ja, jok = jpk.ray_circle_angle(o, d, *args)
    _same(ok, jok)
    _close(a[ok], np.asarray(ja)[np.asarray(jok)], atol=1e-4)
    t = r.uniform(-2, 2, 32).astype(np.float32)
    _close(pk.ray_at(torch.from_numpy(o), d, t), jpk.ray_at(o, d, t))


def _triangles(n=40, seed=4):
    r = _rng(seed)
    c = r.uniform(-6, 6, (n, 1, 3)).astype(np.float32)
    c[:, :, 2] = r.uniform(2, 30, (n, 1))
    return (c + r.standard_normal((n, 3, 3)).astype(np.float32) * 2.5)


def test_ray_triangle_intersect():
    tris = _triangles()
    o = np.zeros(3, np.float32)
    d = np.array([0.05, -0.02, 1.0], np.float32)
    t, hit = pk.ray_triangle_intersect(o, torch.from_numpy(d), tris[:, 0],
                                       tris[:, 1], tris[:, 2])
    jt, jhit = jpk.ray_triangle_intersect(o, d, tris[:, 0], tris[:, 1],
                                          tris[:, 2])
    _same(hit, jhit)
    _close(t[hit], np.asarray(jt)[np.asarray(jhit)])


def test_pick_triangle_seeded_rays():
    """64 seeded rays over the triangles, one query for all of them,
    against the JAX package ray by ray: index and hit exact, t close."""
    tris = _triangles()
    r = _rng(5)
    o = r.uniform(-1, 1, (64, 3)).astype(np.float32)
    d = np.concatenate([r.uniform(-0.3, 0.3, (64, 2)),
                        np.ones((64, 1))], 1).astype(np.float32)
    d[:8, 2] = -1.0                      # pointing away: no hit
    idx, t, any_hit = pk.pick_triangle(torch.from_numpy(o),
                                       torch.from_numpy(d),
                                       torch.from_numpy(tris))
    n_hit = 0
    for i in range(64):
        ji, jt, jany = jpk.pick_triangle(o[i], d[i], tris)
        assert int(idx[i]) == int(ji) and bool(any_hit[i]) == bool(jany)
        if bool(jany):
            n_hit += 1
            _close(t[i], jt)
        else:
            assert int(idx[i]) == -1 and float(t[i]) == float("inf")
    assert 8 < n_hit < 64 and not bool(any_hit[:8].any())


def test_pick_triangle_ties_and_valid_mask():
    """Equal nearest hits: the first wins, in both packages; a masked
    triangle never wins; all masked -> -1."""
    tri = np.array([[-1.0, -1.0, 5.0], [1.0, -1.0, 5.0], [0.0, 1.0, 5.0]],
                   np.float32)
    far = tri + np.array([0.0, 0.0, 3.0], np.float32)
    tris = np.stack([far, tri, tri, far, tri])
    o = np.zeros(3, np.float32)
    d = np.array([0.0, 0.0, 1.0], np.float32)
    for valid in (None, np.array([1, 0, 1, 1, 1], bool),
                  np.array([1, 0, 0, 1, 0], bool), np.zeros(5, bool)):
        got = pk.pick_triangle(o, d, torch.from_numpy(tris), valid)
        want = jpk.pick_triangle(o, d, tris, valid)
        assert int(got[0]) == int(want[0])
        assert bool(got[2]) == bool(want[2])
        assert float(got[1]) == float(want[1])
    assert int(pk.pick_triangle(o, d, tris)[0]) == 1


def test_2d_helpers():
    r = _rng(6)
    p = r.uniform(-50, 50, (6, 64)).astype(np.float32)
    px, py = r.uniform(-60, 60, (2, 64)).astype(np.float32)
    p[:, :4] = p[:, :1]                     # degenerate segments
    _close(pk.point_to_segment_distance(torch.from_numpy(px), py, *p[:4]),
           jpk.point_to_segment_distance(px, py, *p[:4]))
    _same(pk.point_in_triangle_2d(torch.from_numpy(px), py, *p),
          jpk.point_in_triangle_2d(px, py, *p))
    pts = torch.from_numpy(np.stack([px, py], -1))
    v = [np.stack([p[2 * i], p[2 * i + 1]], -1) for i in range(3)]
    v[1][:3] = v[0][:3]                     # degenerate -> -1
    for a, b in zip(pk.barycentric_2d(pts, *v),
                    jpk.barycentric_2d(np.asarray(pts), *v)):
        _close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("zs", [(1.0, 2.0, 3.0), (1.0, -1.0, -2.0),
                                (1.0, 2.0, -3.0), (-1.0, -2.0, -0.5),
                                (-1.0, 2.0, 3.0), (0.05, 4.0, 0.1)])
def test_clip_triangle_to_near_plane(zs):
    """Every case of in-front counts: 3, 1, 2, 0, 2 with the back vertex
    first, and two vertices just behind the near plane."""
    r = _rng(7)
    v = r.uniform(-2, 2, (3, 3)).astype(np.float32)
    v[:, 2] = zs
    got = pk.clip_triangle_to_near_plane(*v)
    want = jpk.clip_triangle_to_near_plane(*v)
    _same(got[2], want[2])
    _close(got[0], want[0])
    _close(got[1], want[1])


def test_clip_edge_to_near_plane():
    r = _rng(8)
    a = r.uniform(-3, 3, (32, 3)).astype(np.float32)
    b = r.uniform(-3, 3, (32, 3)).astype(np.float32)
    (ga, gb), gv = pk.clip_edge_to_near_plane(torch.from_numpy(a), b)
    (ja, jb), jv = jpk.clip_edge_to_near_plane(a, b)
    _same(gv, jv)
    _close(ga[gv], np.asarray(ja)[np.asarray(jv)])
    _close(gb[gv], np.asarray(jb)[np.asarray(jv)])


def test_mat4():
    rot = np.array([30.0, -45.0, 110.0], np.float32)
    pos = np.array([1.5, -2.0, 0.25], np.float32)
    _same(pk.mat4_identity(), jpk.mat4_identity())
    _same(pk.mat4_translation(pos), jpk.mat4_translation(pos))
    _close(pk.mat4_rotation(rot), jpk.mat4_rotation(rot), atol=1e-6)
    m = pk.mat4_from_position_rotation(pos, rot)
    jm = jpk.mat4_from_position_rotation(pos, rot)
    _close(m, jm, atol=1e-5)
    a = _rng(9).standard_normal((4, 4)).astype(np.float32)
    _close(pk.mat4_mul(torch.from_numpy(a), m), jpk.mat4_mul(a, jm),
           atol=1e-5)
    p = _rng(10).standard_normal((16, 3)).astype(np.float32)
    _close(pk.mat4_transform_point(m, p), jpk.mat4_transform_point(jm, p),
           atol=1e-5)
