"""The port's rasterizer twins vs the JAX Pallas kernel.

`visibility_ref` + `resolve_ref` (the plain torch versions of the CUDA
kernels, bonnie32_tpu_torch/ops/raster_batch.py) take the JAX package's
own prep — the same compacted faces, bboxes and attribute rows, carried
across by `interop.batch_prep` — and must reproduce
`raster_batch.rasterize_batch(..., interpret=True)`.  Tolerance: the
JAX package's own seam budget, max(64*N, pixels/500) differing pixels
(tests/test_raster_batch.py), because XLA:CPU contracts a*b+c into FMAs
inside the interpreted kernel while the port (like the TPU) never does;
near-tie coverage and depth decisions on triangle seams can flip, and
the contracted depth expression differs in its last bits, so depth is
compared to rtol 1e-6.

The CUDA kernels themselves run only on a card: tests/test_torch_gpu.py
holds them against these twins bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import scenes
import torch_scenes as ts
from bonnie32_tpu.config import RasterSettings, ShadingMode
from bonnie32_tpu.models import build as jbuild
from bonnie32_tpu.models import level as JL
from bonnie32_tpu.models import scene_flat as jsf
from bonnie32_tpu.ops import raster_batch as jrb
from bonnie32_tpu_torch import interop
from bonnie32_tpu_torch.ops import raster_batch as trb

H, W = 48, 64


def _budget(npix, n):
    return max(64 * n, npix // 500)


def _jax_frame(flat, static, cams, settings):
    """JAX prep and kernel output (interpret mode), both as numpy."""
    surf = jax.vmap(lambda c: jsf.build_surfaces_flat(
        flat, c, settings, W, H))(cams)
    prep = jax.vmap(lambda s: jrb.prep_instance(
        s, flat.atlas, settings, W, H, static.t_pad,
        group_id=flat.f_group))(surf)
    n = cams.position.shape[0]
    zero8 = jnp.zeros((n, 8, 128), jnp.int32)
    color, depth = jrb.rasterize_batch(
        zero8, zero8.astype(jnp.float32), prep, flat.keyrows, flat.texmeta,
        flat.tex_lo, flat.tex_hi, flat.tex_pack, flat.tex_pal, settings,
        W, H, static.t_pad, static.n_textures, static.atlas_rows,
        static.key_wrows, atlas_rows_data=static.atlas_rows_data,
        tex_enc=static.tex_enc, interpret=True, clear_color=0,
        bt_const=static.bt_const, vc_mode=static.vc_mode,
        tex_wh=static.tex_wh, sh_mode=static.sh_mode)
    return (jax.tree_util.tree_map(np.asarray, prep),
            np.asarray(jrb.from_layout(color, W, H)),
            np.asarray(jrb.from_layout(depth, W, H)))


def _cameras(positions, angles):
    cams = [jbuild.make_camera(np.asarray(p, np.float32),
                               jbuild.camera_basis(pitch, yaw))
            for p, (pitch, yaw) in zip(positions, angles)]
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *cams)


def _level_case():
    level = ts.cave_size_level(JL)
    flat, static = jsf.compile_level_flat(level, ts.textures(), ts.resolver)
    sx, sy, sz = ts.spawn_point(level)
    cams = _cameras([(sx, sy + 1500.0, sz - 800.0),
                     (4096.0, 2400.0, 1500.0),
                     (6000.0, 1200.0, 6500.0)],
                    [(0.25, 0.6), (0.45, 0.2), (0.1, 3.6)])
    return flat, static, cams


def _two_room_case():
    """Views inside the fogged second room (per-face fog and ambient)."""
    level = ts.two_room_level(JL)
    flat, static = jsf.compile_level_flat(level, ts.textures(), ts.resolver)
    cams = _cameras([(2048.0, 1500.0, 10500.0), (3600.0, 2500.0, 14000.0),
                     (500.0, 1000.0, 12000.0)],
                    [(0.15, 0.1), (0.4, 3.9), (-0.2, 1.5)])
    return flat, static, cams


def _cube_case():
    tex = [scenes.checker_texture15(32, 32, with_black=True)]
    verts, faces = scenes.cube_scene(size=4.0)   # two faces untextured
    flat, static = jsf.compile_scene_flat(verts, faces, tex,
                                          scenes.DEFAULT_LIGHT_SPECS)
    angles = [(0.35, 0.0), (0.35, 0.7), (-0.3, 2.1)]
    pos = [-jbuild.camera_basis(p, y)[2] * 4.0 for p, y in angles]
    return flat, static, _cameras(pos, angles)


_CASES = {"level": _level_case, "two_room": _two_room_case,
          "cube": _cube_case}
_SETTINGS = {"game": RasterSettings.game(),
             "flat_nodither": RasterSettings.game(shading=ShadingMode.FLAT,
                                                  dithering=False)}


@pytest.fixture(scope="module")
def frames():
    """JAX references, computed once per module (XLA:CPU tolerates only
    a few hundred compilations per process)."""
    out = {}
    for cname, make in _CASES.items():
        flat, static, cams = make()
        for sname, settings in _SETTINGS.items():
            if cname != "level" and sname != "game":
                continue
            prep, color, depth = _jax_frame(flat, static, cams, settings)
            out[cname, sname] = (flat, static, settings, prep, color, depth)
    return out


def _twins(case):
    flat, static, settings, prep, _, _ = case
    tprep = interop.batch_prep(prep, static.n_faces)
    atlas = interop.flat_scene(
        jax.tree_util.tree_map(np.asarray, flat)).atlas
    depth, winner, bcx, bcy = trb.visibility_ref(tprep, atlas, H, W)
    color = trb.resolve_ref(tprep, atlas, winner, bcx, bcy,
                            int(settings.shading), 0)
    return tprep, color.numpy(), depth.numpy(), winner.numpy()


@pytest.mark.parametrize("key", [("level", "game"), ("level", "flat_nodither"),
                                 ("two_room", "game"), ("cube", "game")],
                         ids=lambda k: "-".join(k))
def test_twins_match_pallas_kernel(frames, key):
    case = frames[key]
    _, _, _, _, jcolor, jdepth = case
    tprep, color, depth, winner = _twins(case)
    n = color.shape[0]
    budget = _budget(color.size, n)
    assert ((jcolor >> 24) & 255 == 255).mean() > 0.2, "scene not visible"
    cdiff = int((color != jcolor).sum())
    ddiff = int((~np.isclose(depth, jdepth, rtol=1e-6, atol=0)).sum())
    assert cdiff <= budget, f"{key}: {cdiff} colour diffs (budget {budget})"
    assert ddiff <= budget, f"{key}: {ddiff} depth diffs (budget {budget})"
    # both keyed and clean faces won pixels
    won = np.unique(winner[winner >= 0])
    keyable = tprep.ctrl[0, :, trb.K_KEY].numpy()[won] != 0
    assert keyable.any() and (~keyable).any()


def test_keyed_faces_drop_black_texels(frames):
    """Without the key test the keyed faces' black texels would win pixels:
    turning keyability off must change the frame (K2 is exercised)."""
    case = frames["level", "game"]
    tprep, color, _, _ = _twins(case)
    atlas = interop.flat_scene(
        jax.tree_util.tree_map(np.asarray, case[0])).atlas
    ctrl = tprep.ctrl.clone()
    ctrl[..., trb.K_KEY] = 0
    unkeyed = tprep._replace(ctrl=ctrl)
    depth, winner, bcx, bcy = trb.visibility_ref(unkeyed, atlas, H, W)
    color2 = trb.resolve_ref(unkeyed, atlas, winner, bcx, bcy,
                             int(ShadingMode.GOURAUD), 0).numpy()
    assert (color2 != color).sum() > 0


def test_rasterize_batch_cpu_routes_to_twins(frames):
    flat, static, settings, prep, _, _ = frames["cube", "game"]
    tprep, color, depth, _ = _twins(frames["cube", "game"])
    atlas = interop.flat_scene(jax.tree_util.tree_map(np.asarray, flat)).atlas
    c2, d2 = trb.rasterize_batch(tprep, atlas, settings, H, W, 0)
    np.testing.assert_array_equal(c2.numpy(), color)
    np.testing.assert_array_equal(d2.numpy(), depth)

