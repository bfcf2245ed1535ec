"""The per-tile binning of the port's rasterizer (`tile_bins_ref`, the
plain version of the CUDA kernel `raster_bin`).

The CUDA visibility and composite kernels walk, for each tile of the
frame, only the list entries whose bit is set in that tile's mask words.
Held here, on the CPU: the plain binning against a brute-force numpy loop
over (instance, tile, entry) that asks pixel by pixel whether the bbox
holds a pixel of the tile — exact, on the level tables and on random
bboxes, for both list kinds; the edge cases (ragged frame sizes, a bbox
that ends on a tile border, empty bboxes, empty lists, list lengths
around a word); and the property the kernels rely on: dropping, for one
tile, the entries whose bit is clear changes nothing in that tile.  The
JAX package has no counterpart to compare with: its kernel clips each
face to row blocks inside the kernel.
"""

import dataclasses

import numpy as np
import pytest
import torch

import torch_scenes as ts
from bonnie32_tpu_torch import rollout
from bonnie32_tpu_torch.config import RasterSettings
from bonnie32_tpu_torch.game import step as stp
from bonnie32_tpu_torch.models import level as L
from bonnie32_tpu_torch.models import scene_flat
from bonnie32_tpu_torch.ops import raster_batch as rb

torch.set_num_threads(1)

N = 2
SIZES = [(96, 128), (100, 150)]       # whole tiles; ragged right and bottom


def brute_bins(ctrl, fids, live, height, width):
    """Bit b of word w of tile (a, c) of instance i: list position
    32 w + b is live and some pixel of the frame inside the tile lies in
    its half-open bbox."""
    ctrl, fids, live = (np.asarray(x) for x in (ctrl, fids, live))
    n, length = fids.shape
    tiles_y, tiles_x = rb.tile_grid(height, width)
    out = np.zeros((n, tiles_y, tiles_x, (length + 31) // 32), np.uint32)
    ys, xs = np.arange(height), np.arange(width)
    for i in range(n):
        for e in range(length):
            if not live[i, e]:
                continue
            x_lo, x_hi, y_lo, y_hi = ctrl[i, fids[i, e], :4]
            in_x = (xs >= x_lo) & (xs < x_hi)
            in_y = (ys >= y_lo) & (ys < y_hi)
            for a in range(tiles_y):
                if not in_y[a * rb.TILE_H:(a + 1) * rb.TILE_H].any():
                    continue
                for c in range(tiles_x):
                    if in_x[c * rb.TILE_W:(c + 1) * rb.TILE_W].any():
                        out[i, a, c, e // 32] |= np.uint32(1 << (e % 32))
    return out.view(np.int32)


def brute_work(bins):
    n_tiles = int(np.prod(bins.shape[:-1]))
    flat = np.asarray(bins).reshape(n_tiles, bins.shape[-1])
    return {i for i in range(n_tiles) if flat[i].any()}


def _tables(transparent, settings, height, width):
    build = ts.transparent_cave_level if transparent else ts.cave_size_level
    textures = ts.transparent_textures if transparent else ts.textures
    level = build(L)
    env = rollout.build_env(level, textures(), ts.resolver, device="cpu")
    states = rollout.initial_states(level, ts.spawn_point(level), N,
                                    device="cpu")
    acts = stp.Actions(**{k: torch.from_numpy(v) for k, v in ts.actions_np(
        np.random.default_rng(7), N).items()})
    states = stp.tick(states, env.grid, env.params, acts, 1.0 / 60.0)
    cams = stp.character_camera(states, env.params)
    surf = scene_flat.build_surfaces_flat(env.flat, cams, settings, width,
                                          height)
    return env, surf


@pytest.fixture(scope="module")
def level_lists():
    """The four lists the kernels bin, per frame size: name ->
    (ctrl, kwargs of tile_bins_ref)."""
    game = RasterSettings.game()
    out = {}
    for height, width in SIZES:
        env, surf = _tables(False, game, height, width)
        prep = rb.prep_instance(surf, env.flat.atlas, width, height)
        out["opaque", height] = (prep.ctrl, dict(order=prep.order,
                                                 count=prep.count))
        tenv, tsurf = _tables(True, game, height, width)
        pprep = rb.prep_instance(tsurf, tenv.flat.atlas, width, height,
                                 painters=True, group_id=tenv.flat.f_group)
        out["painters", height] = (pprep.ctrl, dict(order=pprep.order,
                                                    count=pprep.count))
        tr = rb.prep_transparent(tsurf, tenv.flat_static.transparent_idx)
        out["transparent", height] = (pprep.ctrl, dict(tctrl=tr.tctrl))
        xsurf = _tables(True, dataclasses.replace(game, xray_mode=True),
                        height, width)[1]
        xtab = rb.face_tables(xsurf, tenv.flat.atlas, width, height)
        xtr = rb.prep_xray(xsurf, tenv.flat.f_group, True)
        out["xray", height] = (xtab.ctrl, dict(tctrl=xtr.tctrl))
    return out


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[1]}x{s[0]}")
@pytest.mark.parametrize("name", ["opaque", "painters", "transparent",
                                  "xray"])
def test_level_bins_match_brute_force(level_lists, name, size):
    height, width = size
    ctrl, kw = level_lists[name, height]
    bins = rb.tile_bins_ref(ctrl, height, width, **kw)
    fids, live = rb.bin_list(**kw)
    tiles_y, tiles_x = rb.tile_grid(height, width)
    assert bins.dtype == torch.int32
    assert bins.shape == (N, tiles_y, tiles_x, (fids.shape[1] + 31) // 32)
    want = brute_bins(ctrl, fids, live, height, width)
    np.testing.assert_array_equal(bins.numpy(), want)
    assert live.any() and (bins != 0).any()
    # the composite's work list, as a set
    assert set(rb.work_list_ref(bins).tolist()) == brute_work(want)
    if name != "transparent":
        assert not live.all(), "no dead entry in the list"


def _random_tables(rng, length, n_faces, height, width):
    """Random bboxes: inside, across and outside the frame, empty ones."""
    lo_x = rng.integers(-20, width + 10, (N, n_faces))
    lo_y = rng.integers(-20, height + 10, (N, n_faces))
    w = rng.integers(-5, width // 2, (N, n_faces))
    h = rng.integers(-5, height // 2, (N, n_faces))
    ctrl = np.zeros((N, n_faces, rb.N_CTRL), np.int32)
    ctrl[..., rb.K_XLO], ctrl[..., rb.K_XHI] = lo_x, lo_x + w
    ctrl[..., rb.K_YLO], ctrl[..., rb.K_YHI] = lo_y, lo_y + h
    return torch.from_numpy(ctrl)


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[1]}x{s[0]}")
@pytest.mark.parametrize("length", [0, 31, 32, 33, 328])
@pytest.mark.parametrize("kind", ["order", "tctrl"])
def test_random_bins_match_brute_force(kind, length, size):
    height, width = size
    rng = np.random.default_rng(100 + length)
    if kind == "order":
        # the visibility list is a permutation of every face
        ctrl = _random_tables(rng, length, length, height, width)
        order = np.stack([rng.permutation(length) for _ in range(N)]).astype(
            np.int32).reshape(N, length)
        count = np.array([length // 2, length], np.int32)
        kw = dict(order=torch.from_numpy(order),
                  count=torch.from_numpy(count))
    else:
        n_faces = 40
        ctrl = _random_tables(rng, length, n_faces, height, width)
        tctrl = np.zeros((N, length, rb.N_TCTRL), np.int32)
        tctrl[..., rb.T_FID] = rng.integers(0, n_faces, (N, length))
        tctrl[..., rb.T_VALID] = rng.integers(0, 4, (N, length)) != 0
        tctrl[..., rb.T_EA] = rng.choice([0, 128, 255], (N, length))
        kw = dict(tctrl=torch.from_numpy(tctrl))
    bins = rb.tile_bins_ref(ctrl, height, width, **kw)
    fids, live = rb.bin_list(**kw)
    want = brute_bins(ctrl, fids, live, height, width)
    assert bins.shape == want.shape
    np.testing.assert_array_equal(bins.numpy(), want)
    assert set(rb.work_list_ref(bins).tolist()) == brute_work(want)
    if kind == "tctrl" and length >= 31:
        t = kw["tctrl"]
        assert ((t[..., rb.T_VALID] == 0).any()
                and (t[..., rb.T_EA] == 0).any()), "no dead entry"


def _one_box(box, height=100, width=150, count=1):
    ctrl = torch.zeros((1, 1, rb.N_CTRL), dtype=torch.int32)
    ctrl[0, 0, :4] = torch.tensor(box, dtype=torch.int32)
    return rb.tile_bins_ref(ctrl, height, width,
                            order=torch.zeros((1, 1), dtype=torch.int32),
                            count=torch.tensor([count], dtype=torch.int32))


TH, TW = rb.TILE_H, rb.TILE_W

EDGE_CASES = {
    # (x_lo, x_hi, y_lo, y_hi) -> the tiles (row, column) it must mark
    "one_pixel": ((0, 1, 0, 1), {(0, 0)}),
    "ends_on_the_tile_border": ((3, TW, 2, TH), {(0, 0)}),
    "starts_on_the_tile_border": ((TW, TW + 1, TH, TH + 1), {(1, 1)}),
    "one_pixel_past_the_border": ((3, TW + 1, 2, TH + 1),
                                  {(0, 0), (0, 1), (1, 0), (1, 1)}),
    "empty_in_x": ((5, 5, 0, 50), set()),
    "empty_in_y": ((0, 50, 9, 9), set()),
    "inverted": ((20, 10, 30, 5), set()),
    "beyond_the_frame": ((150, 170, 0, 20), set()),
    "above_the_frame": ((0, 20, -30, 0), set()),
    "ragged_corner": ((149, 150, 99, 100), {(99 // TH, 149 // TW)}),
    "ragged_tile_past_the_frame": ((150, 160, 100, 104), set()),
    "whole_frame": ((0, 150, 0, 100),
                    {(a, c) for a in range(-(-100 // TH))
                     for c in range(-(-150 // TW))}),
}


@pytest.mark.parametrize("case", EDGE_CASES)
def test_bbox_edge_cases(case):
    box, want = EDGE_CASES[case]
    bins = _one_box(box)
    assert bins.shape == (1, -(-100 // TH), -(-150 // TW), 1)
    got = {(a, c) for a, c in torch.nonzero(bins[0, :, :, 0]).tolist()}
    assert got == want
    assert set(bins.unique().tolist()) <= {0, 1}


def test_count_zero_and_empty_list_mark_nothing():
    assert not _one_box((0, 150, 0, 100), count=0).any()
    ctrl = torch.zeros((3, 5, rb.N_CTRL), dtype=torch.int32)
    for kw in (dict(order=torch.zeros((3, 0), dtype=torch.int32),
                    count=torch.zeros(3, dtype=torch.int32)),
               dict(tctrl=torch.zeros((3, 0, rb.N_TCTRL),
                                      dtype=torch.int32))):
        bins = rb.tile_bins_ref(ctrl, 100, 150, **kw)
        assert bins.shape == (3, -(-100 // TH), -(-150 // TW), 0)
        assert rb.work_list_ref(bins).numel() == 0


def test_bit_31_is_the_sign_bit():
    ctrl = torch.zeros((1, 32, rb.N_CTRL), dtype=torch.int32)
    ctrl[0, 31, :4] = torch.tensor([0, 4, 0, 4], dtype=torch.int32)
    bins = rb.tile_bins_ref(
        ctrl, 16, 64, order=torch.arange(32, dtype=torch.int32)[None],
        count=torch.tensor([32], dtype=torch.int32))
    assert int(bins[0, 0, 0, 0]) == -2 ** 31
    assert not bins[0, 0, 1:].any()


def test_bin_list_wants_one_list():
    ctrl = torch.zeros((1, 1, rb.N_CTRL), dtype=torch.int32)
    order = torch.zeros((1, 1), dtype=torch.int32)
    with pytest.raises(ValueError):
        rb.tile_bins_ref(ctrl, 8, 8)
    with pytest.raises(ValueError):
        rb.tile_bins_ref(ctrl, 8, 8, order=order)
    with pytest.raises(ValueError):
        rb.tile_bins_ref(ctrl, 8, 8, order=order,
                         count=torch.ones(1, dtype=torch.int32),
                         tctrl=torch.zeros((1, 1, 8), dtype=torch.int32))


# ---- what the kernels rely on: clear bits change nothing in the tile ----

H2, W2 = 40, 72          # ragged in both directions


def _tile_slices(height, width):
    tiles_y, tiles_x = rb.tile_grid(height, width)
    for a in range(tiles_y):
        for c in range(tiles_x):
            yield a, c, (slice(None), slice(a * TH, (a + 1) * TH),
                         slice(c * TW, (c + 1) * TW))


@pytest.mark.parametrize("painters", [False, True],
                         ids=["zbuffer", "painters"])
def test_visibility_needs_only_the_tile_s_faces(painters):
    settings = RasterSettings.game(use_zbuffer=not painters)
    env, surf = _tables(True, settings, H2, W2)
    atlas = env.flat.atlas
    prep = rb.prep_instance(surf, atlas, W2, H2, painters=painters,
                            group_id=env.flat.f_group)
    full = rb.visibility_ref(prep, atlas, H2, W2, painters=painters)
    assert (full[1] >= 0).float().mean() > 0.25
    bins = rb.tile_bins_ref(prep.ctrl, H2, W2, order=prep.order,
                            count=prep.count)
    length = prep.order.shape[1]
    bit = torch.arange(length)
    dropped = 0
    for a, c, sl in _tile_slices(H2, W2):
        words = bins[:, a, c]                              # (I, n_words)
        keep = ((words[:, bit // 32] >> (bit % 32)) & 1).bool()
        dropped += int((~keep & (bit[None] < prep.count[:, None])).sum())
        # the list of this tile alone: its set bits, still in draw order
        pos = torch.sort((~keep).to(torch.int8), dim=1, stable=True).indices
        sub = prep._replace(order=prep.order.gather(1, pos).contiguous(),
                            count=keep.sum(1, dtype=torch.int32))
        part = rb.visibility_ref(sub, atlas, H2, W2, painters=painters)
        for whole, tile in zip(full, part):
            assert torch.equal(whole[sl], tile[sl])
    assert dropped > 0


@pytest.mark.parametrize("mode", ["zbuffer", "xray"])
def test_composite_needs_only_the_tile_s_entries(mode):
    xray = mode == "xray"
    settings = RasterSettings.game(xray_mode=xray)
    env, surf = _tables(True, settings, H2, W2)
    atlas = env.flat.atlas
    cmode = rb.composite_mode(settings)
    if xray:
        tables = rb.face_tables(surf, atlas, W2, H2)
        tr = rb.prep_xray(surf, env.flat.f_group, True)
        color = torch.full((N, H2, W2), 0x10203040, dtype=torch.int32)
        depth = torch.zeros((N, H2, W2))
    else:
        tables = rb.prep_instance(surf, atlas, W2, H2)
        tr = rb.prep_transparent(surf, env.flat_static.transparent_idx)
        depth, winner, bcx, bcy = rb.visibility_ref(tables, atlas, H2, W2)
        color = rb.resolve_ref(tables, atlas, winner, bcx, bcy, 2, 0)
    full = rb.composite_ref(color, depth, tr, tables, atlas, 2, cmode)
    assert (full != color).any()
    bins = rb.tile_bins_ref(tables.ctrl, H2, W2, tctrl=tr.tctrl)
    bit = torch.arange(tr.tctrl.shape[1])
    live = rb.bin_list(tctrl=tr.tctrl)[1]
    listed = set(rb.work_list_ref(bins).tolist())
    tiles = rb.tile_grid(H2, W2)
    dropped = 0
    for a, c, sl in _tile_slices(H2, W2):
        words = bins[:, a, c]
        keep = ((words[:, bit // 32] >> (bit % 32)) & 1).bool()
        dropped += int((~keep & live).sum())
        tctrl = tr.tctrl.clone()
        tctrl[..., rb.T_VALID] *= keep.to(torch.int32)
        part = rb.composite_ref(color, depth, tr._replace(tctrl=tctrl),
                                tables, atlas, 2, cmode)
        assert torch.equal(full[sl], part[sl])
        # a tile off the work list is a tile the composite leaves alone
        for i in range(N):
            if (i * tiles[0] + a) * tiles[1] + c not in listed:
                assert torch.equal(full[sl][i], color[sl][i])
    assert dropped > 0
