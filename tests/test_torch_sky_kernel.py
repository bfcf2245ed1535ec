"""The port's sky through the rasterizer vs the JAX package's fused
Pallas kernel, on the cube of tests/test_skybox.py
(`test_sky_kernel_path_matches_buffer_path`): `render_level_flat(sky=...)`,
the in-kernel sky with the star pass after it, and
`render_level_flat(fb_color=...)`, the sky-buffer route, for the night
sky (mountains, moon, haze, stars) here and the sunset preset (tint,
sun, haze, clouds, mountains) in test_torch_sky_kernel_sunset.py; the
levels are in test_torch_sky_rollout.py (one file each, so that the test
workers compile their JAX references in parallel: the in-kernel sky
alone takes the interpreter 80-120 s to compile for one sky).

The JAX references run the kernel in interpret mode on the CPU, once per
module, at N=2 and 120x160.  Tolerances (`assert_sky_frame`):

  * at most one 8-bit step a channel on the pixels that differ, apart
    from the seam budget below: the sky truncates a float gradient to 8
    bits, and acos, atan2, sin and pow differ by ulps between torch and
    XLA:CPU (whose in-kernel sky also runs minimax acos/atan2); the JAX
    suite allows its own two routes one step on 0.1% of the pixels;
  * pixels beyond one step: the JAX package's seam budget,
    max(64*N, pixels/500) — XLA:CPU contracts a*b+c into FMAs inside the
    interpreted kernel, the port never does, so a face or mountain
    silhouette, or a star's truncated screen position, can move a pixel;
  * pixels that differ at all: that budget plus 0.1% of the frame;
  * depth: rtol 1e-6 within the seam budget (the contracted inverse-z),
    and the pixels at depth 0.0, where the sky shows, the same set but
    for that budget.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scenes
import torch_scenes as ts
from bonnie32_tpu.config import RasterSettings
from bonnie32_tpu.models import scene_flat as jsf
from bonnie32_tpu.models import skybox as JS
from bonnie32_tpu.ops import camera as jcam
from bonnie32_tpu.ops import raster_ref
from bonnie32_tpu.ops import skybox as jsky
from bonnie32_tpu.types import FrameBuffers
from bonnie32_tpu_torch import interop
from bonnie32_tpu_torch.models import scene_flat as tsf
from bonnie32_tpu_torch.models import skybox as TS
from bonnie32_tpu_torch.ops import skybox as tsky

torch.set_num_threads(1)

H, W, N = 120, 160, 2
ROUTES = ("kernel", "buffer")
_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731


def seam_budget(npix, n):
    return max(64 * n, npix // 500)


def assert_sky_frame(name, ours, theirs, cleared_depth=False):
    """`ours`, `theirs`: (colour, depth) of the port and the JAX package."""
    color, depth = (np.asarray(x) for x in ours)
    jcolor, jdepth = theirs
    n = jcolor.shape[0]
    budget = seam_budget(jcolor.size, n)
    step = np.zeros(jcolor.shape, np.int64)
    for s in (0, 8, 16, 24):
        step = np.maximum(step, np.abs(((color >> s) & 255).astype(np.int64)
                                       - ((jcolor >> s) & 255)))
    beyond = int((step > 1).sum())
    assert beyond <= budget, \
        f"{name}: {beyond} pixels beyond one step (budget {budget})"
    differ = int((step > 0).sum())
    assert differ <= budget + jcolor.size // 1000, \
        f"{name}: {differ} differing pixels"
    if cleared_depth:
        assert not depth.any() and not jdepth.any()
        return
    ddiff = int((~np.isclose(depth, jdepth, rtol=1e-6, atol=0)).sum())
    assert ddiff <= budget, f"{name}: {ddiff} depth diffs"
    assert int(((depth == 0) != (jdepth == 0)).sum()) <= budget


def _cube(mod, scene_mod, **kw):
    verts, faces = scene_mod.cube_scene(tex_ids=(0, 0, 0, None, None, 0))
    tex = [scene_mod.checker_texture15(32, 32, with_black=False)]
    return mod.compile_scene_flat(verts, faces, tex,
                                  scene_mod.DEFAULT_LIGHT_SPECS, **kw)


def cube_refs(names):
    """The JAX frames of the skies `names`, both routes each."""
    flat, static = _cube(jsf, scenes)
    settings = RasterSettings.game()
    fb0 = raster_ref.new_framebuffer(H, W, depth_mode="inv")
    fbs = FrameBuffers(
        color=jnp.broadcast_to(fb0.color, (N,) + fb0.color.shape),
        depth=jnp.broadcast_to(fb0.depth, (N,) + fb0.depth.shape))
    cams = jcam.orbit_cameras(np.asarray([0.3, 2.2], np.float32), 0.35, 3.5)
    out = {"cams": _np(cams)}
    for name in names:
        tables = jsky.build_sky_tables(ts.sky_config(JS, name))
        assert jsky.sky_kernel_ok(tables, static, settings)
        skyc = jax.vmap(lambda c, t=tables: jsky.render_skybox_layout(
            t, c, H, W))(cams)
        for route, kw in (("kernel", dict(sky=tables)),
                          ("buffer", dict(fb_layout_color=skyc))):
            fr = jsf.render_level_flat(fbs, flat, static, cams, settings,
                                       height=H, width=W, interpret=True,
                                       **kw)
            out[name, route] = (np.asarray(fr.color), np.asarray(fr.depth))
    return out


@pytest.fixture(scope="module")
def refs():
    return cube_refs(("night",))


def _port_frame(refs, name, route):
    flat, static = _cube(tsf, ts, device="cpu")
    settings = RasterSettings.game()
    tables = tsky.build_sky_tables(ts.sky_config(TS, name), device="cpu")
    cams = interop.camera_arrays(refs["cams"])
    assert tsky.sky_kernel_ok(tables, static, settings)
    if route == "kernel":
        kw = dict(sky=tables)
    else:
        kw = dict(fb_color=tsky.render_skybox(tables, cams, H, W).color)
    return tsf.render_level_flat(flat, static, cams, settings, H, W, **kw)


def check_cube_over_sky(refs, name, route):
    out = _port_frame(refs, name, route)
    jcolor, jdepth = refs[name, route]
    assert 0.02 < (jdepth != 0).mean() < 0.9, "cube and sky both in view"
    assert_sky_frame(f"{name} {route}", (out.color, out.depth),
                     refs[name, route])


def check_port_routes_agree(refs, name):
    """The port's two routes run one sky function on one scalar table:
    unlike the JAX package's (minimax acos in its kernel, the real one in
    its buffer), they give the same frame bit for bit."""
    a = _port_frame(refs, name, "kernel")
    b = _port_frame(refs, name, "buffer")
    assert torch.equal(a.color, b.color)
    assert torch.equal(a.depth, b.depth)


@pytest.mark.parametrize("route", ROUTES)
def test_cube_over_night_sky_matches_jax(refs, route):
    check_cube_over_sky(refs, "night", route)


def test_port_routes_agree_exactly_night(refs):
    check_port_routes_agree(refs, "night")


def test_sky_argument_checks(refs):
    flat, static = _cube(tsf, ts, device="cpu")
    tables = tsky.build_sky_tables(ts.sky_config(TS, "night"), device="cpu")
    cams = interop.camera_arrays(refs["cams"])
    plane = torch.zeros((N, H, W), dtype=torch.int32)
    game = RasterSettings.game()
    with pytest.raises(ValueError, match="excludes"):
        tsf.render_level_flat(flat, static, cams, game, H, W, sky=tables,
                              fb_color=plane)
    with pytest.raises(ValueError, match="excludes"):
        tsf.render_level_flat(flat, static, cams, game, H, W, background=7,
                              fb_color=plane)
    with pytest.raises(ValueError, match="sky_kernel_ok"):
        tsf.render_level_flat(flat, static, cams,
                              RasterSettings.game(xray_mode=True), H, W,
                              sky=tables)
    with pytest.raises(ValueError, match="background plane"):
        tsf.render_level_flat(flat, static, cams, game, H, W,
                              fb_color=plane[:, :8])


def test_background_plane_shows_where_no_face_drew(refs):
    flat, static = _cube(tsf, ts, device="cpu")
    cams = interop.camera_arrays(refs["cams"])
    rng = np.random.default_rng(3)
    plane = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (N, H, W),
                                          dtype=np.int64).astype(np.int32))
    game = RasterSettings.game()
    over = tsf.render_level_flat(flat, static, cams, game, H, W,
                                 fb_color=plane)
    const = tsf.render_level_flat(flat, static, cams, game, H, W,
                                  background=0x123456)
    drew = const.color != 0x123456
    assert 0 < int(drew.sum()) < drew.numel()
    assert torch.equal(over.color[drew], const.color[drew])
    assert torch.equal(over.color[~drew], plane[~drew])
    assert torch.equal(over.depth, const.depth)
    # x-ray composites onto a copy: the caller's plane is left alone
    before = plane.clone()
    xr = tsf.render_level_flat(flat, static, cams,
                               RasterSettings.game(xray_mode=True), H, W,
                               fb_color=plane)
    assert torch.equal(plane, before) and (xr.color != plane).any()
