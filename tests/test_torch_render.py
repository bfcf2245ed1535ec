"""The port's render_mesh_15 (bonnie32_tpu_torch/render.py) on the
configurations of test_raster_parity.py (tests/torch_render_cases.py),
on the CPU:

  * against the numpy golden model in each depth mode: 0 differing pixels
    under the PS1 fixed-point projection; the float projection within
    0.5% and ortho within 1% of the pixels, the tolerances the JAX package
    is held to there (direct vs incremental edge functions);
  * the three depth modes ("fast", "inv", "harmonic") give the same
    frame, pixel for pixel (the port contracts no FMA);
  * against the JAX package's render_mesh_15 in "fast" mode, within that
    file's seam budget (XLA:CPU contracts FMAs);
    test_torch_render_inv.py and _harmonic.py hold the other two modes,
    so that the test workers compute the JAX references in parallel;
  * ops/vertex.transform_vertices (all three projections, camera-space
    normals) against the JAX package's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax_refs
import torch_render_cases as rc
import torch_scenes as ts
from bonnie32_tpu.models import build as jbuild
from bonnie32_tpu.ops import vertex as jvertex
from bonnie32_tpu_torch import config, types
from bonnie32_tpu_torch.config import RasterSettings
from bonnie32_tpu_torch.models import build
from bonnie32_tpu_torch.ops import vertex as tvertex

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def golden():
    return {}


def _golden(cache, name):
    if name not in cache:
        cache[name] = rc.golden_frame(name)
    return cache[name]


@pytest.mark.parametrize("mode", rc.MODES)
@pytest.mark.parametrize("name", sorted(rc.CONFIGS))
def test_render_mesh_15_matches_golden(golden, name, mode):
    gpix = _golden(golden, name)
    pix = rc.rgba(rc.port_frame(name, mode))
    lit = pix[..., 3] == 255
    assert lit.any(), "the configuration draws nothing"
    diff = np.any(gpix != pix, axis=-1)
    if rc.CONFIGS[name][3]:
        assert int(diff.sum()) == 0, f"{int(diff.sum())} pixels differ"
    else:
        assert diff.mean() < rc.GOLDEN_LIMIT[name], diff.mean()
    if name == "backface_wireframe":
        assert np.all(pix[..., :3] == (80, 80, 100), axis=-1).any()
    if name == "overlay":
        # no solids: every lit pixel is a front edge
        assert np.all(np.all(pix[lit][:, :3] == (200, 200, 220), axis=-1))


@pytest.mark.parametrize("name", sorted(rc.CONFIGS))
def test_depth_modes_identical(name):
    frames = [rc.port_frame(name, mode) for mode in rc.MODES]
    for mode, frame in zip(rc.MODES[1:], frames[1:]):
        assert int((frame != frames[0]).sum()) == 0, mode


@pytest.mark.parametrize("name", sorted(rc.CONFIGS))
def test_render_mesh_15_matches_jax_fast(name):
    ours = rc.port_frame(name, "fast")
    theirs = jax_refs.jax_frame(name, "fast")
    diff = int((ours != theirs).sum())
    assert diff <= rc.seam_budget(ours.size), diff


@pytest.mark.parametrize("projection", ["fixed", "float", "ortho"])
def test_transform_vertices_matches_jax(projection):
    """The full TRANSFORM phase of ops/vertex.py (camera-space position,
    the projection, the normalized camera-space normal) against the JAX
    package's on seeded vertices and two cameras: the fixed-point screen
    coordinates exact, floats to rtol 1e-6 (XLA:CPU contracts FMAs)."""
    settings = {"fixed": RasterSettings.game(),
                "float": RasterSettings.game(use_fixed_point=False),
                "ortho": ts.ortho_settings(config, zoom=12.5,
                                           center_x=0.5, center_y=-0.25)
                }[projection]
    rng = np.random.default_rng(29)
    pos = rng.uniform(-4, 4, (500, 3)).astype(np.float32)
    nrm = rng.normal(size=(500, 3)).astype(np.float32)
    nrm[:3] = 0.0
    for campos, (pitch, yaw) in ((rc.CAMPOS, (0.35, 0.6)),
                                 (np.float32([0.5, -9.0, 2.0]), (1.1, -2.0))):
        basis = build.camera_basis(pitch, yaw)
        ours = tvertex.transform_vertices(
            torch.from_numpy(pos), types.CameraArrays(
                torch.from_numpy(campos), torch.from_numpy(basis)),
            settings, rc.W, rc.H, normal=torch.from_numpy(nrm))
        theirs = jvertex.transform_vertices(
            jnp.asarray(pos), jnp.asarray(nrm),
            jbuild.make_camera(campos, basis),
            jax_refs.jax_settings(settings), rc.W, rc.H)
        for f in ("sx", "sy", "sz", "cam", "cam_normal"):
            o, t = getattr(ours, f).numpy(), np.asarray(getattr(theirs, f))
            if projection == "fixed" and f in ("sx", "sy"):
                np.testing.assert_array_equal(o, t, err_msg=f)
            else:
                np.testing.assert_allclose(o, t, rtol=1e-6, atol=1e-6,
                                           err_msg=f)
        assert not ours.cam_normal[:3].any()
