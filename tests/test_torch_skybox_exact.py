"""The port's render_skybox(exact=True) (ops/skybox.py: the generated sky
mesh rasterized triangle by triangle, then the stars) on the CPU:

  * against the numpy transcription of fb.render_skybox + render_stars
    (tests/golden/skybox_golden.py), 0 differing pixels, under the night
    and the sunset sky of tests/torch_scenes.py;
  * against the JAX package's render_skybox(exact=True) within
    tests/test_skybox.py's budget: at most one step a channel, on under
    5% of the pixels (XLA:CPU contracts FMAs);
  * the chunked walk (faces in chunks, the covering face of highest index
    winning a pixel) against a face-by-face loop, exact, with chunks of
    one face, of a few faces and of all of them, over a random start
    frame.
"""

import numpy as np
import pytest
import torch

import torch_scenes as ts
from bonnie32_tpu.models import build as jbuild
from bonnie32_tpu.models import skybox as JS
from bonnie32_tpu.ops import raster_ref as jrr
from bonnie32_tpu.ops import skybox as jsky
from bonnie32_tpu_torch import types
from bonnie32_tpu_torch.models import build
from bonnie32_tpu_torch.models import skybox as TS
from bonnie32_tpu_torch.ops import color as col
from bonnie32_tpu_torch.ops import raster_ref
from bonnie32_tpu_torch.ops import skybox as tsky
from golden import skybox_golden as G

torch.set_num_threads(1)

H, W = 120, 160
SKIES = ("night", "sunset")
POSE = (0.15, 0.9)                     # test_skybox.py's exact camera
# more (pitch, yaw) poses: looking down, up past the zenith band, along
# the horizon
GOLDEN_POSES = (POSE, (-0.2, 2.5), (0.4, 4.0), (-1.2, 1.0))


def _cams(poses):
    basis = np.stack([build.camera_basis(p, y) for p, y in poses])
    return types.CameraArrays(torch.zeros(len(poses), 3),
                              torch.from_numpy(basis))


def _tables(name):
    return tsky.build_sky_tables(ts.sky_config(TS, name), device="cpu")


def _rgb(word):
    word = np.asarray(word)
    return np.stack([(word >> s) & 255 for s in (0, 8, 16)],
                    -1).astype(np.int64)


def _exact(tables, cams, h=H, w=W, fb=None):
    fb = fb or raster_ref.new_framebuffer(h, w, depth_mode="inv",
                                          n=cams.position.shape[0],
                                          device="cpu")
    return tsky.render_skybox(tables, cams, h, w, exact=True, fb=fb)


@pytest.fixture(scope="module")
def jax_frames():
    """The JAX render_skybox(exact=True) of each sky, computed once."""
    out = {}
    cam = jbuild.make_camera((0.0, 0.0, 0.0), jbuild.camera_basis(*POSE))
    fb = jrr.new_framebuffer(H, W, depth_mode="inv")
    for name in SKIES:
        tables = jsky.build_sky_tables(ts.sky_config(JS, name))
        out[name] = np.asarray(jsky.render_skybox(fb, tables, cam, time=0.0,
                                                  exact=True).color)
    return out


@pytest.mark.parametrize("pose", GOLDEN_POSES)
@pytest.mark.parametrize("name", SKIES)
def test_exact_sky_matches_golden(name, pose):
    tables = _tables(name)
    out = _exact(tables, _cams([pose]))
    gpix = np.zeros((H, W, 3), np.uint8)
    star_spec = dict(dirs=tables.star_dirs.numpy(),
                     phase=tables.star_phase.numpy(),
                     color=tables.star_color.numpy(),
                     size=tables.star_size, twinkle=tables.star_twinkle,
                     enabled=tables.stars_enabled)
    G.render_skybox_scalar(gpix, tables.all_dirs.numpy(),
                           tables.all_colors.numpy(),
                           tables.all_faces.numpy(),
                           build.camera_basis(*pose), star_spec=star_spec,
                           time=tables.time)
    ours = _rgb(out.color[0].numpy())
    assert (gpix != 0).any(-1).mean() > 0.9, "the sky covers the frame"
    diff = int((ours != gpix).any(-1).sum())
    assert diff == 0, f"{diff} pixels differ"
    assert bool((((out.color >> 24) & 255) == 255).all())
    assert not bool(out.depth.any())


@pytest.mark.parametrize("name", SKIES)
def test_exact_sky_matches_jax(jax_frames, name):
    ours = _rgb(_exact(_tables(name), _cams([POSE])).color[0].numpy())
    theirs = _rgb(jax_frames[name])
    step = np.abs(ours - theirs).max(-1)
    assert step.max() <= 1, f"{(step > 1).sum()} pixels beyond one step"
    assert (step > 0).mean() < 0.05, f"{(step > 0).mean():.1%} differ"


def _face_by_face(tables, cams, start):
    """Every mesh face in order over `start`, the last covering face
    winning: the walk without chunks."""
    n, h, w = start.shape
    ok, xs, ys, inv, cols = tsky.exact_face_setup(tables, cams, h, w)
    px = torch.arange(w, dtype=torch.float32)[None, None, :] + 0.5
    py = torch.arange(h, dtype=torch.float32)[None, :, None] + 0.5
    chans = list(col.unpack_rgba8(start)[:3])
    for f in range(ok.shape[1]):
        def at(v):
            return v[:, f, None, None]
        wts, cov = tsky.exact_face_cover([at(x) for x in xs],
                                         [at(y) for y in ys], at(inv),
                                         px, py)
        cov = cov & at(ok)
        new = tsky.exact_face_color(wts, cols[f])
        chans = [torch.where(cov, nc, c) for nc, c in zip(new, chans)]
    return chans


@pytest.mark.parametrize("chunk_faces", [1, 7, None])
def test_chunked_walk_equals_face_by_face(monkeypatch, chunk_faces):
    h, w = 30, 40
    poses = [POSE, (-0.3, 2.2)]
    tables = _tables("sunset")
    cams = _cams(poses)
    rng = np.random.default_rng(5)
    start = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (2, h, w),
                                          dtype=np.int64).astype(np.int32))
    if chunk_faces is not None:
        monkeypatch.setattr(tsky, "EXACT_CHUNK_ELEMS",
                            chunk_faces * 2 * h * w)
    got = tsky._exact_mesh_pass(start, tables, cams)
    want = _face_by_face(tables, cams, start)
    for g, wnt in zip(got, want):
        assert torch.equal(g, wnt)
    # the mesh covers most of the frame, and not every pixel the same
    assert bool((got[0] != col.unpack_rgba8(start)[0]).any())


def test_exact_sky_draws_over_the_frame_it_is_given():
    """Pixels no face covers keep the start frame's colour (alpha 255); a
    frame is required."""
    tables = _tables("night")
    cams = _cams([POSE])
    no_faces = tables._replace(all_valid=torch.zeros_like(
        tables.all_valid))._replace(stars_enabled=False)
    start = raster_ref.new_framebuffer(
        H, W, clear_color=raster_ref.clear_color_word(10, 20, 30, 0),
        device="cpu")
    out = _exact(no_faces, cams, fb=start)
    assert bool((out.color == raster_ref.clear_color_word(
        10, 20, 30, 255) - (1 << 32)).all())
    with pytest.raises(ValueError, match="fb"):
        tsky.render_skybox(tables, cams, H, W, exact=True)
