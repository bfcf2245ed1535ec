"""Perspective-correct UVs (`affine_textures=False`) of the port vs the
JAX package on the cube of test_torch_composite.py (every blend mode,
keyed and transparent texels, an untextured face), and the hand-off of
the winner's 1/z from the merge to resolve, held directly on the twins.
The levels are in test_torch_perspective_levels.py, x-ray in
test_torch_perspective_xray.py and the night sky in
test_torch_perspective_sky.py (one file each, so that the test workers
compute the JAX references in parallel).

The references: JAX `render_level_flat(..., interpret=True)`, whose
kernel draws the opaque faces with perspective UVs and whose sequential
compositor `_transparent_pass` draws the transparent ones
(`raster_ref._raster_one`, `exact_div`).  Tolerances as in
test_torch_composite.py: frames within the seam budget max(64*N,
pixels/500), because XLA:CPU contracts a*b+c into FMAs in the
interpreted kernel and in the compositor; depth to rtol 1e-6 in z-buffer
mode and exactly the cleared plane in painter's mode.  The twins'
identities are exact.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scenes
import torch_scenes as ts
from bonnie32_tpu.config import RasterSettings as JRS
from bonnie32_tpu.models import scene_flat as jsf
from bonnie32_tpu.ops import camera as jcam
from bonnie32_tpu_torch import interop
from bonnie32_tpu_torch.config import RasterSettings, ShadingMode
from bonnie32_tpu_torch.models import level as TL
from bonnie32_tpu_torch.models import scene_flat as tsf
from bonnie32_tpu_torch.ops import camera as tcam
from bonnie32_tpu_torch.ops import raster_batch as trb
from test_torch_composite import (CLEAR, H, N, W, _assert_frame,
                                  _jax_render, _mixed_blend_cube, _np)

torch.set_num_threads(1)

PERSP = dict(affine_textures=False)
CASES = {
    "zbuffer": dict(PERSP),
    "painters": dict(PERSP, use_zbuffer=False),
    "flat_ea128": dict(PERSP, shading=ShadingMode.FLAT),
}


def _ea(name):
    return 128 if name.endswith("ea128") else 255


@pytest.fixture(scope="module")
def cube():
    cams = jcam.orbit_cameras(
        jnp.asarray(np.arange(N, dtype=np.float32) * 0.9 + 0.2), 0.4, 3.2)
    out = {"cams": _np(cams)}
    for name, kw in CASES.items():
        verts, faces, tex = _mixed_blend_cube(_ea(name))
        flat, static = jsf.compile_scene_flat(verts, faces, tex,
                                              scenes.DEFAULT_LIGHT_SPECS)
        out[name] = _jax_render(flat, static, cams, JRS.game(**kw), H, W)
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_cube_matches_jax(cube, name):
    verts, faces, tex = _mixed_blend_cube(_ea(name))
    flat, static = tsf.compile_scene_flat(verts, faces, tex,
                                          ts.DEFAULT_LIGHT_SPECS,
                                          device="cpu")
    assert static.transparent_idx
    settings = RasterSettings.game(**CASES[name])
    cams = interop.camera_arrays(cube["cams"])
    out = tsf.render_level_flat(flat, static, cams, settings, H, W,
                                background=CLEAR)
    _assert_frame(name, (out.color, out.depth), cube[name], settings)
    # the UVs are not the affine ones
    affine = tsf.render_level_flat(
        flat, static, cams, dataclasses.replace(settings,
                                                affine_textures=True),
        H, W, background=CLEAR)
    assert int((affine.color != out.color).sum()) > 50


def _prep(painters, hw=(H, W)):
    """The transparent Cave-size level's prep, from two cameras."""
    level = ts.transparent_cave_level(TL)
    flat, _ = tsf.compile_level_flat(level, ts.transparent_textures(),
                                     ts.resolver, device="cpu")
    cams = tcam.orbit_cameras(torch.tensor([0.3, 2.1]), 0.3, 3500.0,
                              target=(4096.0, 1200.0, 4096.0))
    settings = RasterSettings.game(affine_textures=False,
                                   use_zbuffer=not painters)
    surf = tsf.build_surfaces_flat(flat, cams, settings, hw[1], hw[0])
    return flat, trb.prep_instance(surf, flat.atlas, hw[1], hw[0],
                                   painters=painters,
                                   group_id=flat.f_group)


def _winner_izi(prep, winner, bcx, bcy):
    """The winner's interpolated 1/z at each pixel, from its attribute
    row and the barycentrics, in the merge's expression."""
    inst = torch.arange(winner.shape[0])[:, None, None]
    a = prep.attrs[inst, winner.clamp(min=0).long()]
    bcz = (1.0 - bcx) - bcy
    return ((bcx * a[..., trb.C_IZA] + bcy * a[..., trb.C_IZB])
            + bcz * a[..., trb.C_IZC])


def test_resolve_recomputes_the_merged_inverse_z():
    """The z-buffer merge keeps the winner's 1/z in the depth plane;
    resolve recomputes it from the winner's row and barycentrics, bit for
    bit the same value, so no plane has to carry it (painter's mode
    clears its depth plane)."""
    flat, prep = _prep(painters=False)
    depth, winner, bcx, bcy = trb.visibility_ref(prep, flat.atlas, H, W,
                                                 perspective=True)
    has = winner >= 0
    assert has.float().mean() > 0.5
    assert torch.equal(_winner_izi(prep, winner, bcx, bcy)[has], depth[has])
    assert not bool(depth[~has].any())


def test_painters_izi_hand_off():
    """Painter's mode with perspective UVs: the merge returns a cleared
    depth plane, and resolve divides by the winner's own 1/z, not by the
    1 that a cleared plane would give."""
    flat, prep = _prep(painters=True)
    depth, winner, bcx, bcy = trb.visibility_ref(prep, flat.atlas, H, W,
                                                 painters=True,
                                                 perspective=True)
    assert not bool(depth.any())
    has = winner >= 0
    izi = _winner_izi(prep, winner, bcx, bcy)
    assert bool((izi[has] > 0).all()) and bool((izi[has] != 1.0).any())
    shading = int(ShadingMode.GOURAUD)
    color = trb.resolve_ref(prep, flat.atlas, winner, bcx, bcy, shading,
                            CLEAR, perspective=True)
    # the same pipeline with the UVs divided by the winner's 1/z, by hand
    inst = torch.arange(winner.shape[0])[:, None, None]
    a = prep.attrs[inst, winner.clamp(min=0).long()].permute(3, 0, 1, 2)
    bcz = (1.0 - bcx) - bcy

    def by_hand(safe):
        u = (((bcx * a[trb.C_U0]) * a[trb.C_IZA]
              + (bcy * a[trb.C_U1]) * a[trb.C_IZB])
             + (bcz * a[trb.C_U2]) * a[trb.C_IZC]) / safe
        v = (((bcx * a[trb.C_VV0]) * a[trb.C_IZA]
              + (bcy * a[trb.C_VV1]) * a[trb.C_IZB])
             + (bcz * a[trb.C_VV2]) * a[trb.C_IZC]) / safe
        return u, v

    safe = torch.where(izi == 0, torch.ones_like(izi), izi)
    tex = flat.atlas
    tid = a[trb.C_TID].to(torch.int32).clamp(min=0)
    for safe_, same in ((safe, True), (torch.ones_like(izi), False)):
        u, v = by_hand(safe_)
        texel = tex.data[trb._texel_index(tex, tid, u, v).long()]
        ours_u, ours_v = trb._face_uv(bcx, bcy, bcz, lambda c: a[c], izi)
        ours = tex.data[trb._texel_index(tex, tid, ours_u, ours_v).long()]
        assert bool(torch.equal(ours[has], texel[has])) is same
    # and the frame is the perspective one, not the affine one
    affine = trb.resolve_ref(prep, flat.atlas, winner, bcx, bcy, shading,
                             CLEAR)
    assert int((affine != color).sum()) > 100


def test_rasterize_batch_painters_keeps_depth_cleared():
    flat, prep = _prep(painters=True, hw=(48, 64))
    settings = RasterSettings.game(affine_textures=False, use_zbuffer=False)
    color, depth = trb.rasterize_batch(prep, flat.atlas, settings, 48, 64)
    assert not bool(depth.any())
    planes = trb.visibility_ref(prep, flat.atlas, 48, 64, painters=True,
                                perspective=True)
    assert torch.equal(color, trb.resolve_ref(
        prep, flat.atlas, *planes[1:], int(settings.shading), 0,
        perspective=True))
