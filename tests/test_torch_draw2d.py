"""The port's ops/draw2d.py against the JAX package's, on the CPU, each
primitive on a 120x160 frame of two instances (the port draws both at
once; the JAX package draws each instance's frame alone):

  * the primitives computed from integers or host data must match
    exactly: the clears, the filled, alpha and outlined rects, the
    circles and rings (also clipped), the text (clipped), the image, and
    draw_lines / draw_lines_alpha with overlapping lines at alpha 128;
  * the primitives computed from floats (the triangles, the scanline
    triangle, the thick line, the clipped 3D lines, the floor grid, the
    cylinder, draw_lines_3d_alpha in both depth modes) get the seam
    budget max(64 N, pixels / 500) of tests/test_raster_batch.py
    (XLA:CPU contracts a product and a sum into one FMA where torch
    rounds twice); the measured count is printed.

Depth planes are never written: they must come back unchanged (the
clears reset them, exactly).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bonnie32_tpu.models import build as jbuild
from bonnie32_tpu.ops import draw2d as jd
from bonnie32_tpu.types import CameraArrays as JCam
from bonnie32_tpu.types import FrameBuffers as JFB
from bonnie32_tpu_torch.models import build
from bonnie32_tpu_torch.ops import draw2d as td
from bonnie32_tpu_torch.types import CameraArrays, FrameBuffers

torch.set_num_threads(1)

H, W, N = 120, 160, 2
CAMS = [((0.0, 6.0, -12.0), 0.25, 0.15), ((2.0, 8.0, -9.0), 0.45, -0.3)]


def seam_budget(npixels, n_inst):
    return max(64 * n_inst, npixels // 500)


def _frames(seed=0, depth_mode="harmonic"):
    """Two instances: random opaque words; harmonic z in 2..60 or its
    inverse, with a cleared patch."""
    r = np.random.default_rng(seed)
    color = r.integers(0, 1 << 24, (N, H, W)).astype(np.int64)
    color = (color | (255 << 24)).astype(np.uint32).view(np.int32)
    z = r.uniform(2.0, 60.0, (N, H, W)).astype(np.float32)
    if depth_mode == "harmonic":
        depth = z
        depth[:, :20, :30] = np.float32(3.4028235e38)
    else:
        depth = (np.float32(1.0) / z).astype(np.float32)
        depth[:, :20, :30] = 0.0
    return color, depth


def _cams():
    pos = np.array([c[0] for c in CAMS], np.float32)
    basis = np.stack([build.camera_basis(p, y) for _, p, y in CAMS])
    return pos, basis


def _compare(case, exact, depth_mode="harmonic", seed=0):
    """Run `case(mod, fb, cam)` in the port on both instances at once and
    in JAX instance by instance; compare colour and depth."""
    color, depth = _frames(seed, depth_mode)
    pos, basis = _cams()
    ours = case(td, FrameBuffers(torch.from_numpy(color.copy()),
                                 torch.from_numpy(depth.copy())),
                CameraArrays(torch.from_numpy(pos), torch.from_numpy(basis)))
    assert tuple(ours.color.shape) == (N, H, W)
    diff = 0
    for i in range(N):
        ref = case(jd, JFB(color=jnp.asarray(color[i]),
                           depth=jnp.asarray(depth[i])),
                   JCam(position=jnp.asarray(pos[i]),
                        basis=jnp.asarray(basis[i])))
        np.testing.assert_array_equal(ours.depth[i].numpy(),
                                      np.asarray(ref.depth))
        diff += int((ours.color[i].numpy() != np.asarray(ref.color)).sum())
        changed = int((np.asarray(ref.color) != color[i]).sum())
        assert changed > 0, "the case drew nothing"
    budget = 0 if exact else seam_budget(N * H * W, N)
    print(f"{diff} differing pixels (budget {budget})")
    assert diff <= budget


# ---- integer and host-data primitives: exact ----

def _lines(mod, fb, alpha=None):
    ex = np.array([[5, 150], [150, 10], [80, 80], [-30, 200], [20, 140],
                   [10, 10]], np.int32)
    ey = np.array([[5, 110], [8, 100], [-20, 140], [60, 55], [100, 2],
                   [50, 50]], np.int32)
    valid = np.array([1, 1, 1, 1, 0, 1], bool)
    if alpha is None:
        return mod.draw_lines(fb, ex, ey, (255, 40, 10), valid=valid)
    return mod.draw_lines_alpha(fb, ex, ey, (20, 240, 90), alpha,
                                valid=valid)


def _text(mod, fb):
    fb = mod.draw_text(fb, 3, 4, "Hello, TPU 0123!", (250, 250, 0))
    fb = mod.draw_text(fb, 100, 100, "clipped text", (0, 250, 250),
                       scale=2, clip=(110, 90, 150, 112))
    return mod.draw_text(fb, -8, 115, "edge", (255, 0, 255))


def _image(mod, fb):
    img = np.random.default_rng(3).integers(
        -(1 << 31), 1 << 31, (30, 40)).astype(np.int32)
    fb = mod.draw_image(fb, 130, -10, img)
    return mod.draw_image(fb, 10, 20, img)


EXACT = {
    "clear": lambda m, fb, c: m.clear(fb, (10, 20, 30)),
    "clear_alpha": lambda m, fb, c: m.clear(fb, (10, 20, 30), alpha=100),
    "clear_transparent": lambda m, fb, c: m.clear_transparent(fb),
    "clear_gradient": lambda m, fb, c: m.clear_gradient(
        fb, (200, 100, 0), (0, 50, 250)),
    "filled_rect": lambda m, fb, c: m.draw_filled_rect(
        fb, 150, 100, 10, 5, (255, 0, 0)),
    "filled_rect_alpha": lambda m, fb, c: m.draw_filled_rect(
        m.draw_filled_rect(fb, -5, 10, 90, 70, (0, 0, 255), alpha=128),
        40, 40, 200, 200, (255, 255, 0), alpha=77),
    "rect_outline": lambda m, fb, c: m.draw_rect(
        m.draw_rect(fb, 150, 100, 10, 5, (0, 255, 0)), -3, -3, 30, 30,
        (9, 9, 9)),
    "circle": lambda m, fb, c: m.draw_circle(
        m.draw_circle(fb, 60, 50, 25, (255, 128, 0)), 150, 110, 30,
        (1, 2, 3), clip=(0, 0, 155, 115)),
    "circle_alpha": lambda m, fb, c: m.draw_circle(
        fb, 80, 60, 40, (255, 255, 255), alpha=128),
    "circle_outline": lambda m, fb, c: m.draw_circle_outline(
        m.draw_circle_outline(fb, 80, 60, 40, (0, 200, 0), thickness=3),
        10, 10, 12, (200, 0, 0), clip=(5, 5, 100, 100)),
    "lines": lambda m, fb, c: _lines(m, fb),
    "lines_alpha_128": lambda m, fb, c: _lines(m, fb, alpha=128),
    "text": lambda m, fb, c: _text(m, fb),
    "image": lambda m, fb, c: _image(m, fb),
}


@pytest.mark.parametrize("name", sorted(EXACT))
def test_exact_primitives(name):
    _compare(EXACT[name], exact=True)


# ---- float primitives: within the seam budget ----

def _segments():
    r = np.random.default_rng(5)
    p0 = r.uniform(-6, 6, (24, 3)).astype(np.float32)
    p1 = r.uniform(-6, 6, (24, 3)).astype(np.float32)
    p0[:4, 2] = -20.0                    # behind the cameras: clipped
    return p0, p1


def _lines3d(m, fb, c):
    p0, p1 = _segments()
    return m.draw_3d_lines_clipped(fb, p0, p1, c, (255, 100, 40))


def _alpha3d(depth_mode, alpha):
    def case(m, fb, c):
        h, w = H, W
        r = np.random.default_rng(6)
        ex = r.integers(-20, w + 20, (16, 2)).astype(np.int32)
        ey = r.integers(-20, h + 20, (16, 2)).astype(np.int32)
        ez = r.uniform(1.0, 70.0, (16, 2)).astype(np.float32)
        valid = np.arange(16) % 5 != 3
        return m.draw_lines_3d_alpha(fb, ex, ey, ez, (40, 250, 200), alpha,
                                     valid=valid, depth_mode=depth_mode)
    return case


def _cylinder(depth_mode, depth_test, segments=12):
    def case(m, fb, c):
        return m.draw_wireframe_cylinder(
            fb, c, (0.5, 1.0, 2.0), 3.0, -4.0, segments=segments,
            depth_mode=depth_mode, depth_test=depth_test)
    return case


FLOAT = {
    "filled_triangle": (lambda m, fb, c: m.draw_filled_triangle(
        fb, 10.3, 5.7, 150.2, 40.9, 60.5, 115.1, (200, 10, 10)), "harmonic"),
    "filled_triangle_alpha_clip": (lambda m, fb, c: m.draw_filled_triangle(
        fb, 150.2, 40.9, 10.3, 5.7, 60.5, 115.1, (10, 200, 10), alpha=100,
        clip=(20, 10, 120, 100)), "harmonic"),
    "scanline_triangle": (lambda m, fb, c: m.draw_filled_triangle_scanline(
        m.draw_filled_triangle_scanline(fb, (10, 100), (150, 10),
                                        (90, 130), (255, 255, 100)),
        (-40, 20), (60, 20), (10, 90), (0, 90, 255)), "harmonic"),
    "thick_line": (lambda m, fb, c: m.draw_thick_line(
        m.draw_thick_line(fb, 10, 10, 150, 100, 6, (255, 0, 128)),
        20, 110, 140, 15, 1, (0, 0, 255)), "harmonic"),
    "lines_3d_clipped": (_lines3d, "harmonic"),
    "floor_grid": (lambda m, fb, c: m.draw_floor_grid(
        fb, c, 2.0, 1.0, 5.0), "harmonic"),
    "cylinder_strict_harmonic": (_cylinder("harmonic", "strict"),
                                 "harmonic"),
    "cylinder_equal_inv": (_cylinder("inv", "equal"), "inv"),
    "cylinder_none_8": (_cylinder("harmonic", "none", 8), "harmonic"),
    "alpha3d_harmonic_128": (_alpha3d("harmonic", 128), "harmonic"),
    "alpha3d_inv_128": (_alpha3d("inv", 128), "inv"),
    "alpha3d_harmonic_255": (_alpha3d("harmonic", 255), "harmonic"),
    "alpha3d_inv_255": (_alpha3d("inv", 255), "inv"),
}


@pytest.mark.parametrize("name", sorted(FLOAT))
def test_float_primitives(name):
    case, depth_mode = FLOAT[name]
    _compare(case, exact=False, depth_mode=depth_mode)


def test_clip_segments_to_screen_matches_jax():
    """The clipped endpoints themselves: integer endpoints within one
    pixel (a truncation can land either side), valid masks equal on the
    segments wholly in front of the near plane.  A segment clipped at the
    near plane projects its new endpoint at cam_z = NEAR_PLANE up to
    rounding, where world_to_screen's `cam_z > 0.1` decides: a tie in
    the JAX package itself, so those masks may differ (count printed)."""
    p0, p1 = _segments()
    pos, basis = _cams()
    ex, ey, ok = td.clip_segments_to_screen(
        p0, p1, CameraArrays(torch.from_numpy(pos),
                             torch.from_numpy(basis)), W, H)
    for i in range(N):
        jex, jey, jok = jd.clip_segments_to_screen(
            p0, p1, JCam(jnp.asarray(pos[i]), jnp.asarray(basis[i])), W, H)
        z0 = (p0 - pos[i]) @ basis[i][2]
        z1 = (p1 - pos[i]) @ basis[i][2]
        whole = (z0 > 0.2) & (z1 > 0.2)
        np.testing.assert_array_equal(ok[i].numpy()[whole],
                                      np.asarray(jok)[whole])
        print(f"camera {i}: {int((~whole).sum())} segments clipped or "
              f"behind, masks differing there "
              f"{int((ok[i].numpy() != np.asarray(jok))[~whole].sum())}")
        m = np.asarray(jok) & ok[i].numpy()
        assert m[whole].sum() > 10
        assert np.abs(ex[i].numpy()[m] - np.asarray(jex)[m]).max() <= 1
        assert np.abs(ey[i].numpy()[m] - np.asarray(jey)[m]).max() <= 1


def test_create_test_cube_is_the_jax_packages():
    assert td.create_test_cube() == jd.create_test_cube()


def test_inputs_are_left_as_they_were():
    color, depth = _frames()
    fb = FrameBuffers(torch.from_numpy(color.copy()),
                      torch.from_numpy(depth.copy()))
    for case in (EXACT["lines_alpha_128"], EXACT["text"],
                 FLOAT["alpha3d_inv_128"][0], _cylinder("harmonic", "none")):
        pos, basis = _cams()
        case(td, fb, CameraArrays(torch.from_numpy(pos),
                                  torch.from_numpy(basis)))
        assert np.array_equal(fb.color.numpy(), color)
        assert np.array_equal(fb.depth.numpy(), depth)


def test_jax_build_agrees_on_camera_basis():
    # the two packages' host camera bases are the same numbers, so the
    # 3D cases above see the same cameras
    for _, p, y in CAMS:
        np.testing.assert_array_equal(build.camera_basis(p, y),
                                      np.asarray(jbuild.camera_basis(p, y)))
