"""The wireframe passes of the port (bonnie32_tpu_torch/ops/wireframe.py)
vs the JAX package's ops/wireframe.py: the closed-form Bresenham strips,
the per-group edge dedup, the edge tables, and the frames of the editor's
settings through `render_level_flat` — backface wires (RasterSettings(),
the editor's default) on the cube and on the Cave-size level, and the
front-edge overlay on the two-room level, whose two draw groups the
overlay handles and the backface wires refuse.

Tolerances: line_pixels (integer arithmetic and one IEEE division), the
dedup mask and the integer edge tables are exact; the edges' screen
depth to rtol 1e-6 (XLA:CPU contracts the camera transform's a*b+c into
FMAs, torch does not); the overlay frame is exact (integer strips, one
colour, no depth test); frames with backface wires within the seam
budget max(64*N, pixels/500) of tests/test_raster_batch.py: the wires
test 1/z against the depth plane, whose contracted interpolation flips
near-equal comparisons along the edges the faces share.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scenes
import torch_scenes as ts
from bonnie32_tpu.config import RasterSettings as JRS
from bonnie32_tpu.models import level as JL
from bonnie32_tpu.models import scene_flat as jsf
from bonnie32_tpu.ops import camera as jcam
from bonnie32_tpu.ops import raster_ref
from bonnie32_tpu.ops import wireframe as jwf
from bonnie32_tpu_torch import interop
from bonnie32_tpu_torch.config import RasterSettings
from bonnie32_tpu_torch.models import level as TL
from bonnie32_tpu_torch.models import scene_flat as tsf
from bonnie32_tpu_torch.ops import wireframe as twf

from test_torch_composite import _budget, _np
from test_torch_composite_levels import (CAVE_POSES, TWO_ROOM_POSES,
                                         _level_cams)

torch.set_num_threads(1)

H, W = 120, 160
LH, LW = 48, 64            # the levels' frames


def _segments(rng, n, width, height):
    """Seeded segments: on screen, far off screen on every side, crossing
    it, vertical, horizontal, diagonal and single points."""
    lo = np.array([-3 * width, -3 * height])
    hi = np.array([4 * width, 4 * height])
    a = rng.integers(lo, hi, (n, 2))
    b = rng.integers(lo, hi, (n, 2))
    k = n // 8
    b[:k] = a[:k]                                   # single points
    b[k:2 * k, 0] = a[k:2 * k, 0]                   # vertical
    b[2 * k:3 * k, 1] = a[2 * k:3 * k, 1]           # horizontal
    d = rng.integers(-200, 200, k)
    b[3 * k:4 * k] = a[3 * k:4 * k] + d[:, None]    # diagonal
    on = rng.integers(0, [width, height], (k, 2))
    a[4 * k:5 * k] = on
    b[4 * k:5 * k] = rng.integers(0, [width, height], (k, 2))
    far = np.array([1 << 20, 1 << 20])
    a[5 * k:6 * k] = rng.integers(-far, far, (k, 2))
    b[5 * k:6 * k] = rng.integers(-far, far, (k, 2))
    return a.astype(np.int32), b.astype(np.int32)


@pytest.mark.parametrize("hw", [(48, 64), (240, 320)])
def test_line_pixels_matches_jax(hw):
    height, width = hw
    a, b = _segments(np.random.default_rng(11), 4096, width, height)
    ours = twf.line_pixels(*(torch.from_numpy(np.ascontiguousarray(v))
                             for v in (a[:, 0], a[:, 1], b[:, 0], b[:, 1])),
                           width, height, twf.MAX_STEPS)
    theirs = jax.vmap(lambda x0, y0, x1, y1: jwf.line_pixels(
        x0, y0, x1, y1, width, height, twf.MAX_STEPS))(
        *(jnp.asarray(v) for v in (a[:, 0], a[:, 1], b[:, 0], b[:, 1])))
    for name, o, t in zip(("xs", "ys", "t", "valid"), ours, theirs):
        t = np.asarray(t)
        assert o.numpy().dtype == t.dtype, name
        np.testing.assert_array_equal(o.numpy(), t, err_msg=name)
    xs, ys, valid = (v.numpy() for v in (ours[0], ours[1], ours[3]))
    on = valid & (xs >= 0) & (xs < width) & (ys >= 0) & (ys < height)
    assert on.any() and (valid & ~on).any()


def test_dedup_and_edge_order_match_jax():
    """Random edges with repeats in both orientations, three groups and
    invalid edges: the first valid occurrence per group survives."""
    rng = np.random.default_rng(5)
    n, e = 3, 600
    pts = rng.integers(-20, 20, (n, 40, 2)).astype(np.int32)
    pick = rng.integers(0, 40, (n, e, 2))
    flip = rng.random((n, e)) < 0.5
    inst = np.arange(n)[:, None]
    ex = np.stack([pts[inst, pick[..., 0], 0], pts[inst, pick[..., 1], 0]],
                  -1)
    ey = np.stack([pts[inst, pick[..., 0], 1], pts[inst, pick[..., 1], 1]],
                  -1)
    ex = np.where(flip[..., None], ex[..., ::-1], ex).astype(np.int32)
    ey = np.where(flip[..., None], ey[..., ::-1], ey).astype(np.int32)
    ez = rng.uniform(1, 9, (n, e, 2)).astype(np.float32)
    valid = rng.random((n, e)) < 0.7
    group = np.repeat(np.arange(3, dtype=np.int32), e // 3)
    ours = twf._dedup_mask_grouped(torch.from_numpy(ex), torch.from_numpy(ey),
                                   torch.from_numpy(valid),
                                   torch.from_numpy(group)).numpy()
    oex, oey, oez = (v.numpy() for v in twf._normalize_edge_order(
        torch.from_numpy(ex), torch.from_numpy(ey), torch.from_numpy(ez)))
    for i in range(n):
        theirs = np.asarray(jwf._dedup_mask_grouped(
            jnp.asarray(ex[i]), jnp.asarray(ey[i]), jnp.asarray(valid[i]),
            jnp.asarray(group)))
        np.testing.assert_array_equal(ours[i], theirs)
        jx, jy, jz, _ = jwf._normalize_edge_order(
            jnp.asarray(ex[i]), jnp.asarray(ey[i]), jnp.asarray(ez[i]),
            jnp.asarray(valid[i]))
        np.testing.assert_array_equal(oex[i], np.asarray(jx))
        np.testing.assert_array_equal(oey[i], np.asarray(jy))
        np.testing.assert_array_equal(oez[i], np.asarray(jz))
    assert 0 < ours.sum() < valid.sum()


def _jax_frame(flat, static, cams, settings, height, width):
    fb0 = raster_ref.new_framebuffer(height, width, depth_mode="inv")
    n = cams.position.shape[0]
    fbs = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (n,) + x.shape), fb0)
    out = jsf.render_level_flat(fbs, flat, static, cams, settings,
                                height=height, width=width, interpret=True)
    return np.asarray(out.color), np.asarray(out.depth)


def _cube():
    tex = [scenes.checker_texture15(32, 32, with_black=False)]
    verts, faces = scenes.cube_scene(tex_ids=(0, 0, 0, 0, 0, 0))
    return verts, faces, tex


@pytest.fixture(scope="module")
def refs():
    """Every JAX reference of the module, computed once: the levels and
    their edge tables, the cube and the level frames."""
    out = {}
    editor = JRS()
    # the overlay alone: with backface wires too, the reference draws each
    # group's back edges before its front edges, which two groups
    # interleave (check_slice refuses that)
    overlay = JRS(wireframe_overlay=True, backface_wireframe=False)
    verts, faces, tex = _cube()
    jflat, jstatic = jsf.compile_scene_flat(verts, faces, tex,
                                            scenes.DEFAULT_LIGHT_SPECS)
    cams = jcam.orbit_cameras(jnp.asarray(np.arange(2, dtype=np.float32)
                                          * 0.7), 0.35, 3.5)
    out["cube_cams"] = _np(cams)
    out["cube"] = _jax_frame(jflat, jstatic, cams, editor, H, W)
    for name, build, poses in (("cave", ts.cave_size_level, CAVE_POSES),
                               ("two_room", ts.two_room_level,
                                TWO_ROOM_POSES)):
        jf, js = jsf.compile_level_flat(build(JL), ts.textures(),
                                        ts.resolver)
        tf, tst = tsf.compile_level_flat(build(TL), ts.textures(),
                                         ts.resolver, device="cpu")
        cams = _level_cams(poses)
        out[name] = dict(tflat=tf, tstatic=tst, cams=_np(cams))
        out[name, "edges"] = _np(jax.vmap(lambda c: jwf.wireframe_edges_flat(
            jf, c, editor, LW, LH))(cams))
        if name == "cave":
            out[name, "editor"] = _jax_frame(jf, js, cams, editor, LH, LW)
        else:
            out[name, "overlay"] = _jax_frame(jf, js, cams, overlay, H, W)
    return out


@pytest.mark.parametrize("level", ["cave", "two_room"])
def test_wireframe_edges_flat_matches_jax(refs, level):
    r = refs[level]
    ours = twf.wireframe_edges_flat(r["tflat"], interop.camera_arrays(
        r["cams"]), RasterSettings(), LW, LH)
    theirs = refs[level, "edges"]
    names = ("ex", "ey", "ez", "back", "front", "group")
    for name, o, t in zip(names, ours, theirs):
        o = o.numpy()
        t = t if name != "group" else t[0]
        assert o.dtype == t.dtype, name
        if name == "ez":
            np.testing.assert_allclose(o, t, rtol=1e-6, atol=0, err_msg=name)
        else:
            np.testing.assert_array_equal(o, t, err_msg=name)
    assert ours[3].any() and ours[4].any()
    if level == "two_room":
        assert set(ours[5].tolist()) == {0, 1}


def _wire_pixels(color, rgb):
    return int((color == twf._pack_rgb(rgb)).sum())


def test_backface_wires_on_the_cube_match_jax(refs):
    verts, faces, tex = _cube()
    flat, static = tsf.compile_scene_flat(verts, faces, tex,
                                          ts.DEFAULT_LIGHT_SPECS,
                                          device="cpu")
    assert static.n_draw_groups == 1
    settings = RasterSettings()
    out = tsf.render_level_flat(flat, static, interop.camera_arrays(
        refs["cube_cams"]), settings, H, W)
    jcolor, jdepth = refs["cube"]
    assert _wire_pixels(jcolor, twf.BACKFACE_COLOR) > 50
    diff = int((out.color.numpy() != jcolor).sum())
    assert diff <= _budget(jcolor.size, 2), diff
    np.testing.assert_allclose(out.depth.numpy(), jdepth, rtol=1e-6, atol=0)


def test_backface_wires_on_the_cave_level_match_jax(refs):
    r = refs["cave"]
    assert r["tstatic"].n_draw_groups == 1
    out = tsf.render_level_flat(r["tflat"], r["tstatic"],
                                interop.camera_arrays(r["cams"]),
                                RasterSettings(), LH, LW)
    jcolor = refs["cave", "editor"][0]
    assert _wire_pixels(jcolor, twf.BACKFACE_COLOR) > 0
    diff = int((out.color.numpy() != jcolor).sum())
    assert diff <= _budget(jcolor.size, 2), diff


def test_overlay_on_the_two_room_level_matches_jax(refs):
    r = refs["two_room"]
    assert r["tstatic"].n_draw_groups == 2
    settings = RasterSettings(wireframe_overlay=True,
                              backface_wireframe=False)
    out = tsf.render_level_flat(r["tflat"], r["tstatic"],
                                interop.camera_arrays(r["cams"]), settings,
                                H, W)
    jcolor, jdepth = refs["two_room", "overlay"]
    # the front edges and nothing else, on the cleared frame
    assert _wire_pixels(jcolor, twf.FRONTFACE_COLOR) > 100
    assert ((jcolor == 0)
            | (jcolor == twf._pack_rgb(twf.FRONTFACE_COLOR))).all()
    np.testing.assert_array_equal(out.color.numpy(), jcolor)
    assert not out.depth.any() and not jdepth.any()


def test_overlay_ignores_the_sky_and_takes_the_background_word(refs):
    """Overlay mode draws the edges on the cleared frame: the word
    `background`, or 0 where a sky or a sky plane is given (the JAX kernel
    path draws no sky under the overlay)."""
    r = refs["two_room"]
    cams = interop.camera_arrays(r["cams"])
    settings = RasterSettings(wireframe_overlay=True,
                              backface_wireframe=False)
    base = tsf.render_level_flat(r["tflat"], r["tstatic"], cams, settings,
                                 LH, LW)
    word = 0x11223344
    worded = tsf.render_level_flat(r["tflat"], r["tstatic"], cams, settings,
                                   LH, LW, background=word)
    edge = base.color != 0
    assert bool(edge.any())
    assert torch.equal(worded.color[edge], base.color[edge])
    assert bool((worded.color[~edge] == word).all())
    plane = torch.full_like(base.color, word)
    over_plane = tsf.render_level_flat(r["tflat"], r["tstatic"], cams,
                                       settings, LH, LW, fb_color=plane)
    assert torch.equal(over_plane.color, base.color)


def test_wire_chunks_agree():
    """The instance chunks of the strip pass change nothing."""
    level = ts.cave_size_level(TL)
    flat, static = tsf.compile_level_flat(level, ts.textures(), ts.resolver,
                                          device="cpu")
    cams = interop.camera_arrays(_np(_level_cams(CAVE_POSES * 2)))
    settings = dataclasses.replace(RasterSettings(), wireframe_overlay=True)
    color = torch.zeros((4, LH, LW), dtype=torch.int32)
    depth = torch.zeros((4, LH, LW))
    whole = twf.render_wireframes_flat(color, depth, flat, cams, settings)
    parts = twf.render_wireframes_flat(color, depth, flat, cams, settings,
                                       chunk=3)
    assert torch.equal(whole, parts) and bool((whole != 0).any())
    assert not bool(color.any())          # the input plane is not written
