"""The sky kernels' per-tile cull of the mountain faces, on the CPU.

The sky kernels (`raster_sky`, and the sky fused into `raster_resolve`)
cut a frame into SKY_TILE_H x SKY_TILE_W tiles and stage, per tile, only
the mountain faces whose box holds one of its pixel centres, in draw
order.  Its plain version is `ops/skybox.sky_tile_faces_ref`; here it is
held against a brute-force loop over every tile, face and pixel, and the
plain twin `sky_plane_ref` with each tile restricted to its own faces is
held against the twin without the restriction (every pixel, exact) and
against the JAX package's `render_skybox_layout` (the sky-buffer route,
XLA, no Pallas) on the pixels a mountain covers, exact: the mountains use
only + - * / in the same order on both sides.

Skies: night (one range) and sunset (two ranges, tint, two cloud layers),
and the sunset's faces three times over (282 faces, more than one round
of the kernels' cull), at 48x64 and at a ragged 50x75 that the tile shape
divides in neither direction.  Cameras from fixed poses.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_scenes as ts
from bonnie32_tpu.models import build as jbuild
from bonnie32_tpu.models import skybox as JS
from bonnie32_tpu.ops import raster_batch as jrb
from bonnie32_tpu.ops import skybox as jsky
from bonnie32_tpu_torch import interop
from bonnie32_tpu_torch.models import skybox as TS
from bonnie32_tpu_torch.ops import skybox as tsky

torch.set_num_threads(1)

POSES = ((0.15, 0.9), (-0.2, 2.5), (0.4, 4.0), (0.05, 5.6))
SIZES = ((48, 64), (50, 75))          # (rows, columns); the second ragged
SKIES = ("night", "sunset", "sunset x3")
TIME = 0.25


def _cams():
    cams = [jbuild.make_camera((0.0, 0.0, 0.0), jbuild.camera_basis(p, y))
            for p, y in POSES]
    stacked = jax.tree_util.tree_map(lambda *xs: np.stack(xs), *cams)
    return cams, interop.camera_arrays(stacked)


def _tables(name):
    tables = tsky.build_sky_tables(
        ts.sky_config(TS, name.split()[0]), device="cpu")
    if name.endswith("x3"):
        tables = ts.repeated_sky_faces(tables, 3)
    return tables


def _scal(name, hw):
    tables = _tables(name)
    return tables, tsky.prep_sky_scal(tables, _cams()[1], hw[1], hw[0],
                                      time=TIME)


def _faces_of(words, f):
    return ((words[..., f // 32] >> (f % 32)) & 1) != 0


@pytest.mark.parametrize("hw", SIZES, ids=lambda hw: f"{hw[1]}x{hw[0]}")
@pytest.mark.parametrize("name", SKIES)
def test_tile_faces_match_brute_force(name, hw):
    h, w = hw
    tables, scal = _scal(name, hw)
    words = tsky.sky_tile_faces_ref(tables, scal, h, w)
    nf = tables.face_table.shape[0]
    tiles_y, tiles_x = tsky.sky_tile_grid(h, w)
    assert words.shape == (len(POSES), tiles_y, tiles_x, (nf + 31) // 32)
    s = scal.numpy()
    want = np.zeros((len(POSES), tiles_y, tiles_x, nf), bool)
    for ty in range(tiles_y):
        for tx in range(tiles_x):
            ys = np.arange(ty * tsky.SKY_TILE_H,
                           min((ty + 1) * tsky.SKY_TILE_H, h)) + 0.5
            xs = np.arange(tx * tsky.SKY_TILE_W,
                           min((tx + 1) * tsky.SKY_TILE_W, w)) + 0.5
            for f in range(nf):
                box = [s[:, r, f, None] for r in (
                    tsky.R_XMIN, tsky.R_XMAX, tsky.R_YMIN, tsky.R_YMAX)]
                want[:, ty, tx, f] = (
                    ((xs[None] >= box[0]) & (xs[None] <= box[1])).any(1)
                    & ((ys[None] >= box[2]) & (ys[None] <= box[3])).any(1))
    got = np.stack([_faces_of(words, f).numpy() for f in range(nf)], -1)
    np.testing.assert_array_equal(got, want)
    per_tile = want.sum(-1)
    # the cull has work to do: tiles without faces, tiles with several,
    # and a tile holds well under half of the faces its frame shows
    assert (per_tile == 0).any() and per_tile.max() > 1
    assert per_tile.mean() < 0.5 * want.any((1, 2)).sum(-1).mean()


@pytest.mark.parametrize("hw", SIZES, ids=lambda hw: f"{hw[1]}x{hw[0]}")
@pytest.mark.parametrize("name", SKIES)
def test_tile_restricted_twin_equals_full_twin(name, hw):
    h, w = hw
    tables, scal = _scal(name, hw)
    words = tsky.sky_tile_faces_ref(tables, scal, h, w)
    full = tsky.sky_plane_ref(tables, scal, h, w)
    tiled = tsky.sky_plane_ref(tables, scal, h, w, tile_faces=words)
    mtn = tsky.mountain_mask(tables, scal, h, w)
    assert int(mtn.sum()) > 50 and not bool(mtn.all())
    assert torch.equal(tiled, full)
    # dropping a face a tile does hold changes the tile
    bare = tsky.sky_plane_ref(tables, scal, h, w,
                              tile_faces=torch.zeros_like(words))
    assert torch.equal(bare[~mtn], full[~mtn])
    assert bool((bare[mtn] != full[mtn]).any())


@pytest.fixture(scope="module")
def jax_layouts():
    """render_skybox_layout of the JAX package, per sky and camera."""
    cams, _ = _cams()
    h, w = SIZES[0]
    out = {}
    for name in SKIES[:2]:
        tables = jsky.build_sky_tables(ts.sky_config(JS, name))
        planes = [jsky.render_skybox_layout(tables, c, h, w, time=TIME,
                                            parts="lut mtn") for c in cams]
        out[name] = np.asarray(jrb.from_layout(jnp.stack(planes), w, h))
    return out


@pytest.mark.parametrize("name", SKIES[:2])
def test_tile_restricted_twin_matches_jax_on_mountains(jax_layouts, name):
    h, w = SIZES[0]
    tables, scal = _scal(name, SIZES[0])
    words = tsky.sky_tile_faces_ref(tables, scal, h, w)
    ours = tsky.sky_plane_ref(tables, scal, h, w, tile_faces=words).numpy()
    mtn = tsky.mountain_mask(tables, scal, h, w).numpy()
    assert mtn.sum() > 50
    np.testing.assert_array_equal(ours[mtn], jax_layouts[name][mtn])
