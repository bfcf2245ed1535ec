"""The composite (the TPU kernel's phase 3: transparency and x-ray) and
the painter's merge of the port vs the JAX package: the cube's
editor-alpha and shading cases here, its x-ray and painter's cases in
test_torch_composite_modes.py, the levels in
test_torch_composite_levels.py (one file each, so that the test workers
compile their JAX references in parallel).

The JAX references run the fused Pallas kernel in interpret mode on the
CPU and are computed once per module, at N=2 and 120x160 as
tests/test_transparent_kernel.py does (XLA:CPU tolerates only a few
hundred compilations per process).  Tolerances:

  * frames: the JAX package's seam budget, max(64*N, pixels/500)
    differing pixels (tests/test_transparent_kernel.py), because XLA:CPU
    contracts a*b+c into FMAs inside the interpreted kernel while the
    port (like the TPU) never does, so near-integer colour and coverage
    decisions can flip.  The two-room level is compared at 48x64 with
    three cameras, as tests/test_torch_raster.py compares it: its fogged
    room interpolates vertex colours that vary per corner, and the
    contracted interpolation flips a one-step colour on about 0.75% of
    that room's pixels at any frame size (the opaque frame alone shows
    it; no composite involved);
  * depth: rtol 1e-6 in z-buffer mode (the contracted inverse-z), and
    exactly the cleared plane in x-ray and painter's mode;
  * composite tables and draw orders: exact on every valid entry, from
    the same surfaces (invalid faces draw nothing, and their NaN keys may
    sort differently under XLA's total order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scenes
import torch_scenes as ts
from bonnie32_tpu.config import BlendMode, RasterSettings, ShadingMode
from bonnie32_tpu.models import scene_flat as jsf
from bonnie32_tpu.ops import camera as jcam
from bonnie32_tpu.ops import raster_ref
from bonnie32_tpu_torch import interop
from bonnie32_tpu_torch.models import scene_flat as tsf
from bonnie32_tpu_torch.ops import camera as tcam

# One intra-op thread for torch in every test worker (the workers collect,
# so import, this module): the workers share the machine's cores, and
# torch's thread pool competing with the other workers' and XLA's threads
# made the plain CPU renders of these tests some 50 times slower.
torch.set_num_threads(1)

H, W, N = 120, 160, 2
CLEAR = 0x40302010
_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731


def _budget(npix, n):
    return max(64 * n, npix // 500)


def _mixed_blend_cube(editor_alpha):
    """tests/test_transparent_kernel.py's cube: every non-opaque blend
    mode, keyed textures, a texture whose own mode is AVERAGE and an
    untextured blended face."""
    tex = [ts.checker_texture15(32, 32, with_black=True,
                                with_transparent=True),
           ts.checker_texture15(16, 16, c1=0x03E0, c2=0x7C1F,
                                blend_mode=int(BlendMode.AVERAGE))]
    verts, faces = ts.cube_scene(
        tex_ids=(0, 1, 0, None, 1, 0),
        vertex_colors=[(200, 120, 60), (60, 200, 120), (120, 60, 200),
                       (230, 230, 40), (40, 230, 230), (128, 128, 128)],
        blend_modes=(int(BlendMode.AVERAGE), int(BlendMode.ADD),
                     int(BlendMode.SUBTRACT), int(BlendMode.ADD_QUARTER),
                     int(BlendMode.ERASE), int(BlendMode.OPAQUE)),
        editor_alpha=editor_alpha)
    return verts, faces, tex


CUBE_CASES = {
    "ea255": (255, RasterSettings.game()),
    "ea128": (128, RasterSettings.game()),
    "ea0": (0, RasterSettings.game()),
    "flat": (255, RasterSettings.game(shading=ShadingMode.FLAT)),
    "none": (255, RasterSettings.game(shading=ShadingMode.NONE,
                                      dithering=False)),
    "xray": (255, RasterSettings.game(xray_mode=True)),
    "painters": (255, RasterSettings.game(use_zbuffer=False)),
}


def _jax_render(flat, static, cams, settings, height, width):
    fb0 = raster_ref.new_framebuffer(height, width, depth_mode="inv",
                                     clear_color=CLEAR)
    n = cams.position.shape[0]
    fbs = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (n,) + x.shape), fb0)
    out = jsf.render_level_flat(fbs, flat, static, cams, settings,
                                height=height, width=width, interpret=True)
    return np.asarray(out.color), np.asarray(out.depth)


def cube_refs(names):
    """JAX references of the cube cases `names`, computed once per module
    (the cases are spread over three test files so that the test workers
    compile them in parallel)."""
    cams = jcam.orbit_cameras(
        jnp.asarray(np.arange(N, dtype=np.float32) * 0.9 + 0.2), 0.4, 3.2)
    out = {"cams": _np(cams)}
    for name in names:
        ea, settings = CUBE_CASES[name]
        verts, faces, tex = _mixed_blend_cube(ea)
        flat, static = jsf.compile_scene_flat(verts, faces, tex,
                                              scenes.DEFAULT_LIGHT_SPECS)
        assert jsf.kernel_path_ok(static, settings)
        out[name] = _jax_render(flat, static, cams, settings, H, W)
    return out


def _port_cube(name):
    ea, settings = CUBE_CASES[name]
    verts, faces, tex = _mixed_blend_cube(ea)
    flat, static = tsf.compile_scene_flat(verts, faces, tex,
                                          ts.DEFAULT_LIGHT_SPECS,
                                          device="cpu")
    return flat, static, settings


def check_cube(refs, name):
    """The port's plain path on the cube case `name` vs its reference."""
    flat, static, settings = _port_cube(name)
    assert static.transparent_idx and tsf.kernel_path_ok(static, settings)
    cams = interop.camera_arrays(refs["cams"])
    out = tsf.render_level_flat(flat, static, cams, settings, H, W,
                                background=CLEAR)
    _assert_frame(name, (out.color, out.depth), refs[name], settings)


CUBE_HERE = ("ea255", "ea128", "ea0", "flat")


@pytest.fixture(scope="module")
def cube():
    return cube_refs(CUBE_HERE)


def _assert_frame(name, ours, theirs, settings):
    color, depth = ours
    jcolor, jdepth = theirs
    n = jcolor.shape[0]
    budget = _budget(jcolor.size, n)
    if name == "ea0":
        # editor alpha 0 on every face: nothing draws
        assert (jcolor == CLEAR).all()
    else:
        assert ((jcolor >> 24) & 255 == 255).mean() > 0.02, "not visible"
    cdiff = int((color.numpy() != jcolor).sum())
    assert cdiff <= budget, f"{name}: {cdiff} colour diffs (budget {budget})"
    if settings.xray_mode or not settings.use_zbuffer:
        # neither x-ray nor painter's writes depth
        assert not jdepth.any()
        assert not depth.any()
    else:
        ddiff = int((~np.isclose(depth.numpy(), jdepth, rtol=1e-6,
                                 atol=0)).sum())
        assert ddiff <= budget, f"{name}: {ddiff} depth diffs"


@pytest.mark.parametrize("name", CUBE_HERE)
def test_cube_matches_jax(cube, name):
    check_cube(cube, name)


def test_cube_scene_matches_original():
    for kw in ({}, dict(tex_ids=(0, 1, 0, None, 1, 0), size=4.0,
                        center=(1.0, -2.0, 0.5),
                        vertex_colors=[(200, 120, 60), (60, 200, 120)],
                        blend_modes=(1, 2, 3, 4, 5, 0),
                        black_transparent=False, editor_alpha=128)):
        assert ts.cube_scene(**kw) == scenes.cube_scene(**kw)
    for kw in ({}, dict(w=16, h=8, c1=0x03E0, c2=0x7C1F, block=2,
                        with_black=True, with_transparent=True,
                        blend_mode=3)):
        ours, theirs = ts.checker_texture15(**kw), scenes.checker_texture15(
            **kw)
        np.testing.assert_array_equal(ours[0], theirs[0])
        assert ours[1] == theirs[1]


def test_compile_scene_flat_matches_jax():
    verts, faces, tex = _mixed_blend_cube(128)
    jflat, jstatic = jsf.compile_scene_flat(verts, faces, tex,
                                            scenes.DEFAULT_LIGHT_SPECS)
    tflat, tstatic = tsf.compile_scene_flat(verts, faces, tex,
                                            ts.DEFAULT_LIGHT_SPECS,
                                            device="cpu")
    for f in dataclasses.fields(tstatic):
        assert getattr(tstatic, f.name) == getattr(jstatic, f.name), f.name
    carried = interop.flat_scene(_np(jflat))
    for ours, theirs in zip(jax.tree_util.tree_leaves(tuple(tflat)),
                            jax.tree_util.tree_leaves(tuple(carried))):
        np.testing.assert_array_equal(ours.numpy(), theirs.numpy())


def test_camera_ops_match_jax():
    angles = np.linspace(-3.0, 3.0, 7).astype(np.float32)
    ours = tcam.orbit_cameras(torch.from_numpy(angles), 0.4, 3.2,
                              target=(1.0, 0.5, -2.0))
    theirs = _np(jcam.orbit_cameras(jnp.asarray(angles), 0.4, 3.2,
                                    target=(1.0, 0.5, -2.0)))
    np.testing.assert_allclose(ours.basis.numpy(), theirs.basis, rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(ours.position.numpy(), theirs.position,
                               rtol=1e-6, atol=1e-6)
