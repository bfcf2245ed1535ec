"""The composite (transparency, x-ray) and the painter's merge of the
port vs the JAX package on levels built in code: the transparent
Cave-size level in x-ray mode, the transparent two-room level in
painter's mode, and the composite tables and draw orders of both (the
tolerances, and why the two-room level is compared at 48x64, are in
test_torch_composite.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_scenes as ts
from bonnie32_tpu.config import RasterSettings
from bonnie32_tpu.models import build as jbuild
from bonnie32_tpu.models import level as JL
from bonnie32_tpu.models import scene_flat as jsf
from bonnie32_tpu.ops import raster_batch as jrb
from bonnie32_tpu_torch import interop
from bonnie32_tpu_torch.models import level as TL
from bonnie32_tpu_torch.models import scene_flat as tsf
from bonnie32_tpu_torch.ops import raster_batch as trb
from test_torch_composite import CLEAR, H, W, _assert_frame, _jax_render, _np


def _level_cams(poses):
    cams = [jbuild.make_camera(np.asarray(p, np.float32),
                               jbuild.camera_basis(pi, ya))
            for p, pi, ya in poses]
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *cams)


CAVE_POSES = [((512.0, 2100.0, -300.0), 0.25, 0.6),
              ((4096.0, 2400.0, 1500.0), 0.45, 0.2)]
TWO_ROOM_POSES = [((2048.0, 1500.0, 10500.0), 0.15, 0.1),
                  ((3600.0, 2500.0, 14000.0), 0.4, 3.9),
                  ((1500.0, 2200.0, 9000.0), 0.3, 0.4)]
TWO_ROOM_HW = (48, 64)


def _levels():
    """(JAX flat, JAX static, port flat, port static) per level."""
    out = {}
    for name, build in (("cave", ts.transparent_cave_level),
                        ("two_room", ts.transparent_two_room_level)):
        jflat, jstatic = jsf.compile_level_flat(
            build(JL), ts.transparent_textures(), ts.resolver)
        tflat, tstatic = tsf.compile_level_flat(
            build(TL), ts.transparent_textures(), ts.resolver, device="cpu")
        out[name] = (jflat, jstatic, tflat, tstatic)
    return out


@pytest.fixture(scope="module")
def refs():
    """Every JAX reference of the module, computed once."""
    out = {}
    levels = _levels()
    out["levels"] = levels
    jflat, jstatic = levels["cave"][:2]
    cave_cams = _level_cams(CAVE_POSES)
    out["cave_cams"] = _np(cave_cams)
    xray = RasterSettings.game(xray_mode=True)
    out["cave_xray"] = _jax_render(jflat, jstatic, cave_cams, xray, H, W)
    jflat2, jstatic2 = levels["two_room"][:2]
    room_cams = _level_cams(TWO_ROOM_POSES)
    out["room_cams"] = _np(room_cams)
    painters = RasterSettings.game(use_zbuffer=False)
    out["room_painters"] = _jax_render(jflat2, jstatic2, room_cams,
                                       painters, *TWO_ROOM_HW)
    # surfaces, preps and composite tables from the same cameras
    tables = {}
    game = RasterSettings.game()
    for lname, cams, hw in (("cave", cave_cams, (H, W)),
                            ("two_room", room_cams, TWO_ROOM_HW)):
        jf, js = levels[lname][:2]
        surf = jax.vmap(lambda c: jsf.build_surfaces_flat(
            jf, c, game, hw[1], hw[0]))(cams)
        tables[lname, "surf"] = _np(surf)
        tables[lname, "transparent"] = _np(jax.vmap(
            lambda s: jrb.prep_transparent(s, js.transparent_idx))(surf))
        for zb in (True, False):
            tables[lname, f"xray_z{int(zb)}"] = _np(jax.vmap(
                lambda s: jrb.prep_xray(s, group_id=jf.f_group,
                                        use_zbuffer=zb))(surf))
        tables[lname, "painters_prep"] = _np(jax.vmap(
            lambda s: jrb.prep_instance(
                s, jf.atlas, painters, hw[1], hw[0], js.t_pad,
                group_id=jf.f_group))(surf))
    out["tables"] = tables
    return out


def test_cave_xray_matches_jax(refs):
    tflat, tstatic = refs["levels"]["cave"][2:]
    settings = RasterSettings.game(xray_mode=True)
    cams = interop.camera_arrays(refs["cave_cams"])
    out = tsf.render_level_flat(tflat, tstatic, cams, settings, H, W,
                                background=CLEAR)
    jcolor = refs["cave_xray"][0]
    assert (jcolor != CLEAR).mean() > 0.5
    _assert_frame("cave xray", (out.color, out.depth), refs["cave_xray"],
                  settings)


def test_two_room_painters_matches_jax(refs):
    tflat, tstatic = refs["levels"]["two_room"][2:]
    assert tstatic.n_draw_groups == 2 and tstatic.transparent_last
    settings = RasterSettings.game(use_zbuffer=False)
    cams = interop.camera_arrays(refs["room_cams"])
    out = tsf.render_level_flat(tflat, tstatic, cams, settings,
                                *TWO_ROOM_HW, background=CLEAR)
    _assert_frame("two-room painters", (out.color, out.depth),
                  refs["room_painters"], settings)


@pytest.mark.parametrize("level", ["cave", "two_room"])
def test_composite_leaves_depth_untouched(refs, level):
    """Depth after the composite equals the opaque phases' depth exactly,
    and the composite changed the frame."""
    tflat, tstatic = refs["levels"][level][2:]
    settings = RasterSettings.game()
    hw = (H, W) if level == "cave" else TWO_ROOM_HW
    surf = interop.surfaces(refs["tables"][level, "surf"])
    prep = trb.prep_instance(surf, tflat.atlas, hw[1], hw[0])
    color, depth = trb.rasterize_batch(prep, tflat.atlas, settings, *hw)
    out = tsf.render_surfaces_flat(tflat, tstatic, surf, settings, *hw)
    assert torch.equal(out.depth, depth)
    assert (out.color != color).sum() > 0


def _assert_tables(ours, theirs):
    assert ours.tctrl.shape == theirs.tctrl.shape
    for i in range(ours.tctrl.shape[0]):
        v = ours.tctrl[i, :, trb.T_VALID] != 0
        vj = theirs.tctrl[i, :, trb.T_VALID] != 0
        assert int(v.sum()) == int(vj.sum()) > 0
        np.testing.assert_array_equal(ours.tctrl[i][v].numpy(),
                                      theirs.tctrl[i][vj].numpy())
        np.testing.assert_array_equal(ours.tfscal[i][v].numpy(),
                                      theirs.tfscal[i][vj].numpy())


@pytest.mark.parametrize("level", ["cave", "two_room"])
@pytest.mark.parametrize("kind", ["transparent", "xray_z1", "xray_z0"])
def test_composite_tables_match_jax(refs, level, kind):
    jflat, jstatic, tflat, tstatic = refs["levels"][level]
    surf = interop.surfaces(refs["tables"][level, "surf"])
    if kind == "transparent":
        ours = trb.prep_transparent(surf, tstatic.transparent_idx)
        n_entries = len(tstatic.transparent_idx)
    else:
        ours = trb.prep_xray(surf, group_id=tflat.f_group,
                             use_zbuffer=kind.endswith("1"))
        n_entries = tstatic.n_faces
    theirs = interop.trans_prep(refs["tables"][level, kind], n_entries)
    _assert_tables(ours, theirs)


@pytest.mark.parametrize("level", ["cave", "two_room"])
def test_painters_order_matches_jax(refs, level):
    jflat, jstatic, tflat, tstatic = refs["levels"][level]
    surf = interop.surfaces(refs["tables"][level, "surf"])
    hw = (H, W) if level == "cave" else TWO_ROOM_HW
    ours = trb.prep_instance(surf, tflat.atlas, hw[1], hw[0], painters=True,
                             group_id=tflat.f_group)
    theirs = interop.batch_prep(refs["tables"][level, "painters_prep"],
                                tstatic.n_faces)
    np.testing.assert_array_equal(ours.count.numpy(), theirs.count.numpy())
    for i in range(ours.count.shape[0]):
        k = int(ours.count[i])     # the kept faces: every one is valid
        np.testing.assert_array_equal(ours.order[i, :k].numpy(),
                                      theirs.order[i, :k].numpy())
    # per group, back to front: the order is not the z-buffer one
    zbuf = trb.prep_instance(surf, tflat.atlas, hw[1], hw[0])
    assert not torch.equal(ours.order, zbuf.order)


def test_kernel_path_ok_matches_jax(refs):
    game = RasterSettings.game()
    variants = [game, dataclasses.replace(game, xray_mode=True),
                dataclasses.replace(game, use_zbuffer=False),
                dataclasses.replace(game, xray_mode=True,
                                    affine_textures=False),
                dataclasses.replace(game, backface_wireframe=True)]
    for level in ("cave", "two_room"):
        _, jstatic, _, tstatic = refs["levels"][level]
        for not_last in (False, True):
            js = dataclasses.replace(jstatic, transparent_last=not not_last)
            ts_ = dataclasses.replace(tstatic, transparent_last=not not_last)
            for s in variants:
                assert tsf.kernel_path_ok(ts_, s) == jsf.kernel_path_ok(js, s)
