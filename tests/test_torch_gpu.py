"""CUDA kernels of the port on a card (marker `gpu`; skipped without one).

Imports no jax, so it runs where the card is; tests/conftest.py imports
jax, hence --noconftest there:

    python -m pytest tests/test_torch_gpu.py -q -m gpu --noconftest -o addopts=""

The kernels of csrc/raster.cu are held against their plain torch twins
bit for bit (both sides are uncontracted IEEE f32 in the same order), and
the main paths (opaque, transparent, x-ray, painter's) are shown to
launch them once per frame and to equal the CPU render.  The binning
(`raster_bin`, which the visibility and composite wrappers launch first)
is held against `tile_bins_ref` word for word, and the kernels that read
its masks also on a 150x100 frame, whose right and bottom tiles are
ragged.  The sky
(`raster_sky`, and `raster_resolve` with the sky behind the faces) is
exact on face and mountain pixels and within one 8-bit step on the other
sky pixels (acos, atan2, sin and pow differ by ulps between nvcc's and
torch's libraries), at 320x240 and at 150x100, and the mountain faces
each sky tile stages equal `sky_tile_faces_ref`, also for a face list
longer than one round of the kernel's cull; `select_gather` of
csrc/gather.cu is exact.  The perspective-UV instantiations of
visibility, resolve (also sky-fused) and the composite equal their twins
at both sizes, and `step_and_render` with perspective UVs, the editor's
backface wires, the overlay and placed assets equals the CPU render.
The sequential renderer (torch code: render_mesh_15 in its three depth
modes, render_level through the rollout's sequential route, with ortho
projection, the editor's settings over five draw groups and transparent
faces in the first of two rooms) equals the CPU on every pixel and
launches no raster kernel; on the game settings it equals the kernel
route on the card.  The play path: the 8-bit pipeline on an F32_MAX
clear, the exact sky mesh walk (also against the numpy golden) and one
render_game_view (one `raster_sky` launch, the sky within one step)
equal the CPU.  The editor path (torch code): every draw2d primitive,
UiContext.paint with the icons, render_editor_viewport on the three
editor levels (no raster kernel launched) and pick_triangle equal the
CPU bit for bit.  The audio path: csrc/audio.cu's `spu_reverb` (all ten
presets, buffers pre-filled near the wrap, square waves loud enough to
wrap `_mul_vol`'s product) and `spu_resample` (short calls, several
segments, pitch changes) equal their twins on the card, output and
state, with the state carried; `render_song` and a 60 Hz `AudioStream`
on the card equal the CPU render.  The game tick on the card stays
within the CPU tick's tolerance of the CPU's over frames 1-3
(tests/torch_tick_drift.py).  The rest of ui/ (tests/torch_ui_cases.py):
the full widget frame painted at 640x480, the text input and the landing
page equal the CPU on every word; the drag tracker's pickers with the
camera on the card equal the CPU's positions bit for bit and its angles
within 1e-5 rad (atan2 differs by ulps between the libraries).  The
imported texture (quantized at 4 and 8 bpp) on the main path
(`entry.entry`) equals the CPU frame, and a checkpoint of card states
goes through storage/ on three routes and restores bit for bit.
"""

import numpy as np
import pytest
import torch

import torch_render_cases as rc
import torch_scenes as ts
import torch_seq_cases as sc
from bonnie32_tpu_torch import config, rollout
from bonnie32_tpu_torch.models import level as L
from bonnie32_tpu_torch.models import skybox as S
from bonnie32_tpu_torch.config import RasterSettings
from bonnie32_tpu_torch.game import step as stp
from bonnie32_tpu_torch.models import build
from bonnie32_tpu_torch.models import scene_flat
from bonnie32_tpu_torch.ops import gather as tg
from bonnie32_tpu_torch.ops import raster_batch as rb
from bonnie32_tpu_torch.ops import skybox as sky_ops
from bonnie32_tpu_torch.types import CameraArrays

pytestmark = pytest.mark.gpu
H, W, N = 240, 320, 4
RAGGED = (100, 150)      # rows, columns: no tile shape divides it


@pytest.fixture(scope="module")
def env():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    level = ts.cave_size_level(L)
    dev = torch.device("cuda", 0)
    return level, dev, rollout.build_env(level, ts.textures(), ts.resolver,
                                         device=dev)


def _actions(rng, dev):
    return stp.Actions(**{k: torch.from_numpy(v).to(dev)
                          for k, v in ts.actions_np(rng, N).items()})


def test_kernels_match_twins_bit_for_bit(env):
    from bonnie32_tpu_torch.ops import _cuda
    level, dev, e = env
    settings = RasterSettings.game()
    states = rollout.initial_states(level, ts.spawn_point(level), N,
                                    device=dev)
    states = stp.tick(states, e.grid, e.params,
                      _actions(np.random.default_rng(0), dev), 1.0 / 60.0)
    cams = stp.character_camera(states, e.params)
    surf = scene_flat.build_surfaces_flat(e.flat, cams, settings, W, H)
    prep = rb.prep_instance(surf, e.flat.atlas, W, H)
    kern = _cuda.raster_visibility(prep, e.flat.atlas, H, W)
    plain = rb.visibility_ref(prep, e.flat.atlas, H, W)
    kc = _cuda.raster_resolve(prep, e.flat.atlas, *kern[1:], 2, 0)
    pc = rb.resolve_ref(prep, e.flat.atlas, *plain[1:], 2, 0)
    torch.cuda.synchronize()
    for k, p in zip(kern + (kc,), plain + (pc,)):
        assert torch.equal(k, p)


def test_main_path_launches_kernels_and_matches_cpu(env):
    from bonnie32_tpu_torch.ops import _cuda
    level, dev, e = env
    settings = RasterSettings.game()
    states = rollout.initial_states(level, ts.spawn_point(level), N,
                                    device=dev)
    rng = np.random.default_rng(1)
    v0, r0 = _cuda.raster_visibility.launches, _cuda.raster_resolve.launches
    for _ in range(2):
        states, fbs = rollout.step_and_render(states, e, _actions(rng, dev),
                                              settings, height=H, width=W)
    assert _cuda.raster_visibility.launches - v0 == 2
    assert _cuda.raster_resolve.launches - r0 == 2
    # the CPU path (plain twins) from the same cameras gives the same frame
    cams = stp.character_camera(states, e.params)
    cpu_env = rollout.build_env(level, ts.textures(), ts.resolver,
                                device="cpu")
    out = scene_flat.render_level_flat(
        cpu_env.flat, cpu_env.flat_static,
        CameraArrays(*(x.cpu() for x in cams)), settings, H, W)
    assert torch.equal(out.color, fbs.color.cpu())
    assert torch.equal(out.depth, fbs.depth.cpu())


def test_wrappers_reject_bad_inputs(env):
    from bonnie32_tpu_torch.ops import _cuda
    level, dev, e = env
    prep = rb.BatchPrep(count=torch.zeros(1, dtype=torch.int32, device=dev),
                        order=torch.zeros((1, 4), dtype=torch.int64,
                                          device=dev),
                        ctrl=torch.zeros((1, 4, 8), dtype=torch.int32,
                                         device=dev),
                        attrs=torch.zeros((1, 4, 32), device=dev))
    with pytest.raises(ValueError):
        _cuda.raster_visibility(prep, e.flat.atlas, H, W)
    order = prep.order.to(torch.int32)
    with pytest.raises(ValueError):       # an i64 list
        _cuda.raster_bin(prep.ctrl, H, W, order=prep.order, count=prep.count)
    with pytest.raises(ValueError):       # neither list, both lists
        _cuda.raster_bin(prep.ctrl, H, W)
    with pytest.raises(ValueError):
        _cuda.raster_bin(prep.ctrl, H, W, order=order, count=prep.count,
                         tctrl=torch.zeros((1, 2, 8), dtype=torch.int32,
                                           device=dev))
    with pytest.raises(ValueError):       # order without its count
        _cuda.raster_bin(prep.ctrl, H, W, order=order)
    with pytest.raises(ValueError):       # a count of the wrong length
        _cuda.raster_bin(prep.ctrl, H, W, order=order,
                         count=torch.zeros(2, dtype=torch.int32, device=dev))
    with pytest.raises(ValueError):       # tables on the CPU
        _cuda.raster_bin(prep.ctrl.cpu(), H, W, order=order.cpu(),
                         count=prep.count.cpu())
    with pytest.raises(ValueError):       # rows not 16-byte aligned
        _cuda.raster_bin(torch.zeros(8 * 5 + 1, dtype=torch.int32,
                                     device=dev)[1:].view(1, 5, 8), H, W,
                         order=torch.zeros((1, 5), dtype=torch.int32,
                                           device=dev), count=prep.count)
    before = _cuda.raster_bin.launches
    bins, work, work_len = _cuda.raster_bin(prep.ctrl, H, W, order=order,
                                            count=prep.count, want_work=True)
    torch.cuda.synchronize()
    assert _cuda.raster_bin.launches == before + 1
    assert not bins.any() and work_len.tolist() == [0, 0]
    # empty lists launch nothing and mark nothing
    for kw in (dict(order=order[:, :0], count=prep.count),
               dict(tctrl=torch.zeros((1, 0, 8), dtype=torch.int32,
                                      device=dev))):
        bins, work, work_len = _cuda.raster_bin(prep.ctrl, *RAGGED,
                                                want_work=True, **kw)
        assert bins.shape == (1, *rb.tile_grid(*RAGGED), 0)
        assert work_len.tolist() == [0, 0]


@pytest.fixture(scope="module")
def tenv(env):
    _, dev, _ = env
    level = ts.transparent_cave_level(L)
    return level, dev, rollout.build_env(level, ts.transparent_textures(),
                                         ts.resolver, device=dev)


def _transparent_inputs(tenv, settings, hw=(H, W)):
    H, W = hw
    level, dev, e = tenv
    states = rollout.initial_states(level, ts.spawn_point(level), N,
                                    device=dev)
    states = stp.tick(states, e.grid, e.params,
                      _actions(np.random.default_rng(2), dev), 1.0 / 60.0)
    cams = stp.character_camera(states, e.params)
    surf = scene_flat.build_surfaces_flat(e.flat, cams, settings, W, H)
    prep = rb.prep_instance(surf, e.flat.atlas, W, H,
                            painters=not settings.use_zbuffer,
                            group_id=e.flat.f_group)
    return e, surf, prep


def _bin_lists(tenv, hw):
    """The four lists the wrappers bin: name -> (ctrl, list)."""
    game = RasterSettings.game()
    e, surf, prep = _transparent_inputs(tenv, game, hw)
    _, _, pprep = _transparent_inputs(
        tenv, RasterSettings.game(use_zbuffer=False), hw)
    tr = rb.prep_transparent(surf, e.flat_static.transparent_idx)
    xsurf = _transparent_inputs(tenv, RasterSettings.game(xray_mode=True),
                                hw)[1]
    xtab = rb.face_tables(xsurf, e.flat.atlas, hw[1], hw[0])
    xtr = rb.prep_xray(xsurf, e.flat.f_group)
    return {"opaque": (prep.ctrl, dict(order=prep.order, count=prep.count)),
            "painters": (pprep.ctrl, dict(order=pprep.order,
                                          count=pprep.count)),
            "transparent": (prep.ctrl, dict(tctrl=tr.tctrl)),
            "xray": (xtab.ctrl, dict(tctrl=xtr.tctrl))}


@pytest.mark.parametrize("hw", [(H, W), RAGGED],
                         ids=lambda hw: f"{hw[1]}x{hw[0]}")
def test_raster_bin_matches_plain(tenv, hw):
    from bonnie32_tpu_torch.ops import _cuda
    for name, (ctrl, kw) in _bin_lists(tenv, hw).items():
        before = _cuda.raster_bin.launches
        bins, work, work_len = _cuda.raster_bin(ctrl, *hw, want_work=True,
                                                **kw)
        want = rb.tile_bins_ref(ctrl, *hw, **kw)
        torch.cuda.synchronize()
        assert _cuda.raster_bin.launches == before + 1
        assert want.any(), name
        assert torch.equal(bins, want), name
        # the work list: the tiles with any bit, in no fixed order
        assert int(work_len[1]) == 0
        got = work[:int(work_len[0])].sort().values
        assert torch.equal(got, rb.work_list_ref(want)), name
        bins, work, work_len = _cuda.raster_bin(ctrl, *hw, **kw)
        assert work is None and work_len is None
        assert torch.equal(bins, want), name


def test_raster_bin_random_boxes(env):
    """Boxes across, outside and on the borders of the frame; list lengths
    around a word; dead entries."""
    from bonnie32_tpu_torch.ops import _cuda
    _, dev, _ = env
    rng = np.random.default_rng(8)
    h, w = RAGGED
    for length in (1, 31, 32, 33, 97, 328, 1100):
        ctrl = np.zeros((N, length, 8), np.int32)
        lo_x = rng.integers(-20, w + 10, (N, length))
        lo_y = rng.integers(-20, h + 10, (N, length))
        ctrl[..., 0], ctrl[..., 1] = lo_x, lo_x + rng.integers(
            -5, w // 2, (N, length))
        ctrl[..., 2], ctrl[..., 3] = lo_y, lo_y + rng.integers(
            -5, h // 2, (N, length))
        ctrl = torch.from_numpy(ctrl).to(dev)
        order = torch.from_numpy(np.stack(
            [rng.permutation(length) for _ in range(N)]).astype(
                np.int32)).to(dev)
        count = torch.from_numpy(rng.integers(0, length + 1, N).astype(
            np.int32)).to(dev)
        tctrl = np.zeros((N, length, 8), np.int32)
        tctrl[..., rb.T_FID] = rng.integers(0, length, (N, length))
        tctrl[..., rb.T_VALID] = rng.integers(0, 4, (N, length)) != 0
        tctrl[..., rb.T_EA] = rng.choice([0, 128, 255], (N, length))
        for kw in (dict(order=order, count=count),
                   dict(tctrl=torch.from_numpy(tctrl).to(dev))):
            bins, work, work_len = _cuda.raster_bin(ctrl, h, w,
                                                    want_work=True, **kw)
            want = rb.tile_bins_ref(ctrl, h, w, **kw)
            torch.cuda.synchronize()
            assert torch.equal(bins, want), (length, list(kw))
            got = work[:int(work_len[0])].sort().values
            assert torch.equal(got, rb.work_list_ref(want))


@pytest.mark.parametrize("hw", [(H, W), RAGGED],
                         ids=lambda hw: f"{hw[1]}x{hw[0]}")
@pytest.mark.parametrize("mode", ["zbuffer", "painters", "xray"])
def test_binned_kernels_match_twins_at_both_sizes(tenv, mode, hw):
    """Visibility (both merges) and composite (three modes) against their
    twins on whole and on ragged tiles."""
    from bonnie32_tpu_torch.ops import _cuda
    H, W = hw
    settings = RasterSettings.game(xray_mode=mode == "xray",
                                   use_zbuffer=mode != "painters")
    e, surf, prep = _transparent_inputs(tenv, settings, hw)
    atlas = e.flat.atlas
    cmode = rb.composite_mode(settings)
    if mode == "xray":
        prep = rb.face_tables(surf, atlas, W, H)
        tr = rb.prep_xray(surf, e.flat.f_group)
        color = torch.full((N, H, W), 0x10203040, dtype=torch.int32,
                           device=prep.attrs.device)
        depth = torch.zeros(color.shape, device=color.device)
    else:
        tr = rb.prep_transparent(surf, e.flat_static.transparent_idx)
        planes = _cuda.raster_visibility(prep, atlas, H, W,
                                         painters=mode == "painters")
        twin = rb.visibility_ref(prep, atlas, H, W,
                                 painters=mode == "painters")
        torch.cuda.synchronize()
        for k, p in zip(planes, twin):
            assert torch.equal(k, p)
        assert (planes[1] >= 0).any()
        depth, winner, bcx, bcy = planes
        color = _cuda.raster_resolve(prep, atlas, winner, bcx, bcy, 2, 0)
    plain = rb.composite_ref(color, depth, tr, prep, atlas, 2, cmode)
    kern = _cuda.raster_composite(color.clone(), depth, tr, prep, atlas, 2,
                                  cmode)
    torch.cuda.synchronize()
    assert (kern != color).sum() > 0
    assert torch.equal(kern, plain)


def test_long_lists_take_several_rounds(tenv):
    """Lists of more than 32 mask words with more entries in a tile than one
    staged batch holds: every face of the level four times over (1312
    faces, 41 words), and the x-ray list of those."""
    from bonnie32_tpu_torch.ops import _cuda
    game = RasterSettings.game()
    e, surf, prep = _transparent_inputs(tenv, game)
    atlas = e.flat.atlas
    dev = prep.attrs.device
    k, t = 4, prep.order.shape[1]
    offset = (torch.arange(k, device=dev, dtype=torch.int32)
              * t).repeat_interleave(t)
    live = (torch.arange(t, device=dev)[None] < prep.count[:, None]).repeat(
        1, k)
    kept_first = torch.sort((~live).to(torch.int8), dim=1,
                            stable=True).indices
    deep = rb.BatchPrep(
        count=prep.count * k,
        order=(prep.order.repeat(1, k) + offset).gather(
            1, kept_first).contiguous(),
        ctrl=prep.ctrl.repeat(1, k, 1), attrs=prep.attrs.repeat(1, k, 1))
    bins = _cuda.raster_bin(deep.ctrl, H, W, order=deep.order,
                            count=deep.count)[0]
    assert bins.shape[-1] > 32
    kern = _cuda.raster_visibility(deep, atlas, H, W)
    plain = rb.visibility_ref(deep, atlas, H, W)
    torch.cuda.synchronize()
    for a, b in zip(kern, plain):
        assert torch.equal(a, b)
    # x-ray over the same faces: every entry blends, so order shows
    xsurf = _transparent_inputs(tenv, RasterSettings.game(xray_mode=True))[1]
    xtab = rb.face_tables(xsurf, atlas, W, H)
    xtr = rb.prep_xray(xsurf, e.flat.f_group)
    tctrl = xtr.tctrl.repeat(1, k, 1)
    tctrl[..., rb.T_FID] += offset
    deep_tr = rb.TransPrep(tctrl=tctrl.contiguous(),
                           tfscal=xtr.tfscal.repeat(1, k, 1))
    deep_tab = rb.FaceTables(ctrl=xtab.ctrl.repeat(1, k, 1),
                             attrs=xtab.attrs.repeat(1, k, 1))
    color = torch.full((N, H, W), 0x10203040, dtype=torch.int32, device=dev)
    depth = torch.zeros(color.shape, device=dev)
    xbins = _cuda.raster_bin(deep_tab.ctrl, H, W, tctrl=deep_tr.tctrl)[0]
    x = xbins.long() & 0xFFFFFFFF
    per_tile = sum(((x >> b) & 1) for b in range(32)).sum(-1)
    assert int(per_tile.max()) > 64      # more than one staged batch
    want = rb.composite_ref(color, depth, deep_tr, deep_tab, atlas, 2,
                            rb.COMPOSITE_XRAY)
    got = _cuda.raster_composite(color.clone(), depth, deep_tr, deep_tab,
                                 atlas, 2, rb.COMPOSITE_XRAY)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("mode", ["zbuffer", "painters", "xray"])
def test_composite_kernel_matches_twin_bit_for_bit(tenv, mode):
    from bonnie32_tpu_torch.ops import _cuda
    settings = RasterSettings.game(xray_mode=mode == "xray",
                                   use_zbuffer=mode != "painters")
    e, surf, prep = _transparent_inputs(tenv, settings)
    atlas = e.flat.atlas
    cmode = rb.composite_mode(settings)
    if mode == "xray":
        prep = rb.face_tables(surf, atlas, W, H)
        tr = rb.prep_xray(surf, e.flat.f_group)
        color = torch.full((N, H, W), 0x10203040, dtype=torch.int32,
                           device=prep.attrs.device)
        depth = torch.zeros(color.shape, device=color.device)
    else:
        tr = rb.prep_transparent(surf, e.flat_static.transparent_idx)
        depth, winner, bcx, bcy = _cuda.raster_visibility(
            prep, atlas, H, W, painters=mode == "painters")
        color = _cuda.raster_resolve(prep, atlas, winner, bcx, bcy, 2, 0)
    depth_before = depth.clone()
    plain = rb.composite_ref(color, depth, tr, prep, atlas, 2, cmode)
    kern = _cuda.raster_composite(color.clone(), depth, tr, prep, atlas, 2,
                                  cmode)
    torch.cuda.synchronize()
    assert (kern != color).sum() > 0
    assert torch.equal(kern, plain)
    assert torch.equal(depth, depth_before)


def test_painters_visibility_matches_twin_bit_for_bit(tenv):
    from bonnie32_tpu_torch.ops import _cuda
    settings = RasterSettings.game(use_zbuffer=False)
    e, _, prep = _transparent_inputs(tenv, settings)
    kern = _cuda.raster_visibility(prep, e.flat.atlas, H, W, painters=True)
    plain = rb.visibility_ref(prep, e.flat.atlas, H, W, painters=True)
    torch.cuda.synchronize()
    for k, p in zip(kern, plain):
        assert torch.equal(k, p)
    assert not kern[0].any()


@pytest.mark.parametrize("mode", ["zbuffer", "xray", "painters"])
def test_transparent_main_path_matches_cpu(tenv, mode):
    from bonnie32_tpu_torch.ops import _cuda
    level, dev, e = tenv
    settings = RasterSettings.game(xray_mode=mode == "xray",
                                   use_zbuffer=mode != "painters")
    states = rollout.initial_states(level, ts.spawn_point(level), N,
                                    device=dev)
    counts = [k.launches for k in (_cuda.raster_visibility,
                                   _cuda.raster_resolve,
                                   _cuda.raster_composite)]
    states, fbs = rollout.step_and_render(
        states, e, _actions(np.random.default_rng(3), dev), settings,
        height=H, width=W)
    ran = [k.launches - c for k, c in zip(
        (_cuda.raster_visibility, _cuda.raster_resolve,
         _cuda.raster_composite), counts)]
    assert ran == ([0, 0, 1] if mode == "xray" else [1, 1, 1])
    cams = stp.character_camera(states, e.params)
    cpu_env = rollout.build_env(level, ts.transparent_textures(),
                                ts.resolver, device="cpu")
    out = scene_flat.render_level_flat(
        cpu_env.flat, cpu_env.flat_static,
        CameraArrays(*(x.cpu() for x in cams)), settings, H, W)
    assert torch.equal(out.color, fbs.color.cpu())
    assert torch.equal(out.depth, fbs.depth.cpu())


# ---- the sky (K5) and the gather (K7) ----

def _step(a, b):
    """Largest per-channel difference of two packed RGBA8 planes."""
    out = torch.zeros(a.shape, dtype=torch.int64, device=a.device)
    for s in (0, 8, 16, 24):
        out = torch.maximum(out, (((a >> s) & 255).long()
                                  - ((b >> s) & 255).long()).abs())
    return out


@pytest.fixture(scope="module", params=["night", "sunset"])
def sky_env(request, env):
    _, dev, _ = env
    level = ts.open_air_level(L, S, request.param)
    return level, dev, rollout.build_env(level, ts.textures(), ts.resolver,
                                         device=dev)


def _sky_cams(sky_env):
    level, dev, e = sky_env
    states = rollout.initial_states(level, ts.spawn_point(level), N,
                                    device=dev)
    states = stp.tick(states, e.grid, e.params,
                      _actions(np.random.default_rng(4), dev), 1.0 / 60.0)
    return stp.character_camera(states, e.params)


@pytest.mark.parametrize("hw", [(H, W), RAGGED],
                         ids=lambda hw: f"{hw[1]}x{hw[0]}")
def test_sky_kernels_match_twin(sky_env, hw):
    from bonnie32_tpu_torch.ops import _cuda
    H, W = hw
    level, dev, e = sky_env
    settings = RasterSettings.game()
    cams = _sky_cams(sky_env)
    scal = sky_ops.prep_sky_scal(e.sky, cams, W, H)
    kern = _cuda.raster_sky(e.sky, scal, H, W)
    plain = sky_ops.sky_plane_ref(e.sky, scal, H, W)
    mtn = sky_ops.mountain_mask(e.sky, scal, H, W)
    torch.cuda.synchronize()
    assert int(mtn.sum()) > 0
    assert torch.equal(kern[mtn], plain[mtn])
    step = _step(kern, plain)
    assert int(step.max()) <= 1
    assert float((step > 0).float().mean()) < 0.01
    # fused: the sky behind the faces
    surf = scene_flat.build_surfaces_flat(e.flat, cams, settings, W, H)
    prep = rb.prep_instance(surf, e.flat.atlas, W, H)
    depth, winner, bcx, bcy = _cuda.raster_visibility(prep, e.flat.atlas, H,
                                                      W)
    bg = sky_ops.SkyBackground(e.sky, scal)
    kc = _cuda.raster_resolve(prep, e.flat.atlas, winner, bcx, bcy, 2, bg)
    pc = rb.resolve_ref(prep, e.flat.atlas, winner, bcx, bcy, 2, bg)
    over = _cuda.raster_resolve(prep, e.flat.atlas, winner, bcx, bcy, 2,
                                kern)
    torch.cuda.synchronize()
    face = depth != 0
    assert 0 < int(face.sum()) < face.numel()
    assert torch.equal(kc[face], pc[face])
    assert torch.equal(kc[mtn & ~face], pc[mtn & ~face])
    assert int(_step(kc, pc).max()) <= 1
    # one sky function behind both entry points: fused == plane route
    assert torch.equal(kc, over)


@pytest.mark.parametrize("deep", [False, True], ids=["faces", "repeated"])
def test_sky_tile_faces_match_plain(sky_env, deep):
    """The faces each sky tile stages, as the kernel reports them, equal
    `sky_tile_faces_ref`; with the faces repeated past 256 (more than one
    round of the cull: the sunset's 94 three times, the night's 30 nine
    times) the plane still equals the twin on mountain pixels, where the
    last of a pixel's covering copies decides its colour."""
    from bonnie32_tpu_torch.ops import _cuda
    _, _, e = sky_env
    nf = e.sky.face_table.shape[0]
    sky = ts.repeated_sky_faces(e.sky, -(-257 // nf) if deep else 1)
    cams = _sky_cams(sky_env)
    for h, w in ((H, W), RAGGED):
        scal = sky_ops.prep_sky_scal(sky, cams, w, h)
        plane, words = _cuda.raster_sky(sky, scal, h, w, want_tiles=True)
        want = sky_ops.sky_tile_faces_ref(sky, scal, h, w)
        mtn = sky_ops.mountain_mask(sky, scal, h, w)
        twin = sky_ops.sky_plane_ref(sky, scal, h, w)
        torch.cuda.synchronize()
        assert torch.equal(words, want)
        assert torch.equal(plane[mtn], twin[mtn])
        assert int(_step(plane, twin).max()) <= 1
        x = words.long() & 0xFFFFFFFF
        per_tile = sum(((x >> b) & 1) for b in range(32)).sum(-1)
        assert int(per_tile.max()) > 1 and bool((per_tile == 0).any())
        assert sky.face_table.shape[0] > 256 or not deep


@pytest.mark.parametrize("transparent", [False, True])
def test_sky_main_path_routes_and_matches_cpu(env, transparent):
    from bonnie32_tpu_torch.ops import _cuda
    _, dev, _ = env
    build = ts.transparent_open_air_level if transparent \
        else ts.open_air_level
    textures = ts.transparent_textures if transparent else ts.textures
    level = build(L, S, "night")
    e = rollout.build_env(level, textures(), ts.resolver, device=dev)
    settings = RasterSettings.game()
    states = rollout.initial_states(level, ts.spawn_point(level), N,
                                    device=dev)
    ks = (_cuda.raster_sky, _cuda.raster_visibility, _cuda.raster_resolve,
          _cuda.raster_composite)
    before = [k.launches for k in ks]
    states, fbs = rollout.step_and_render(
        states, e, _actions(np.random.default_rng(5), dev), settings,
        height=H, width=W)
    ran = [k.launches - b for k, b in zip(ks, before)]
    # stars with transparent faces: the sky-buffer route
    assert ran == ([1, 1, 1, 1] if transparent else [0, 1, 1, 0])
    cams = stp.character_camera(states, e.params)
    cpu_env = rollout.build_env(level, textures(), ts.resolver, device="cpu")
    out = rollout.render_cameras(
        cpu_env, CameraArrays(*(x.cpu() for x in cams)), settings, H, W)
    assert torch.equal(out.depth, fbs.depth.cpu())
    face = out.depth != 0
    if not transparent:
        assert torch.equal(out.color[face], fbs.color.cpu()[face])
    step = _step(out.color, fbs.color.cpu())
    # a sky pixel one step off under a blended face can move the blend's
    # 5-bit result by one, which is 8 in 8 bits
    assert int(step.max()) <= (8 if transparent else 1)
    assert float((step > 1).float().mean()) < 0.001
    assert float((step > 0).float().mean()) < 0.01


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
def test_select_gather_matches_twin(env, dtype):
    _, dev, _ = env
    rng = np.random.default_rng(6)
    size = 32768
    table = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, size,
                                          dtype=np.int64).astype(np.int32))
    table = (table if dtype == torch.int32
             else table.to(torch.float32)).to(dev)
    idx = torch.from_numpy(rng.integers(-5000, size + 5000, (4, 240, 320))
                           .astype(np.int32)).to(dev)
    before = tg.select_gather.launches
    out = tg.select_gather(table, idx)
    torch.cuda.synchronize()
    assert tg.select_gather.launches == before + 1
    assert torch.equal(out, tg.select_gather_ref(table, idx))
    with pytest.raises(ValueError):
        tg.select_gather(table, idx.long())


# ---- perspective-correct UVs, the wireframe passes, placed assets ----

@pytest.mark.parametrize("hw", [(H, W), RAGGED],
                         ids=lambda hw: f"{hw[1]}x{hw[0]}")
@pytest.mark.parametrize("mode", ["zbuffer", "painters", "xray"])
def test_perspective_kernels_match_twins_bit_for_bit(tenv, mode, hw):
    """The perspective instantiations of visibility (keyed faces),
    resolve and the composite against their twins."""
    from bonnie32_tpu_torch.ops import _cuda
    h, w = hw
    settings = RasterSettings.game(xray_mode=mode == "xray",
                                   use_zbuffer=mode != "painters",
                                   affine_textures=False)
    e, surf, prep = _transparent_inputs(tenv, settings, hw)
    atlas = e.flat.atlas
    cmode = rb.composite_mode(settings)
    if mode == "xray":
        prep = rb.face_tables(surf, atlas, w, h)
        tr = rb.prep_xray(surf, e.flat.f_group)
        color = torch.full((N, h, w), 0x10203040, dtype=torch.int32,
                           device=prep.attrs.device)
        depth = torch.zeros(color.shape, device=color.device)
    else:
        painters = mode == "painters"
        tr = rb.prep_transparent(surf, e.flat_static.transparent_idx)
        kern = _cuda.raster_visibility(prep, atlas, h, w, painters=painters,
                                       perspective=True)
        plain = rb.visibility_ref(prep, atlas, h, w, painters=painters,
                                  perspective=True)
        kc = _cuda.raster_resolve(prep, atlas, *kern[1:], 2, 0,
                                  perspective=True)
        pc = rb.resolve_ref(prep, atlas, *plain[1:], 2, 0, perspective=True)
        affine = rb.resolve_ref(prep, atlas, *plain[1:], 2, 0)
        torch.cuda.synchronize()
        for k, p in zip(kern + (kc,), plain + (pc,)):
            assert torch.equal(k, p)
        assert int((affine != pc).sum()) > 0
        depth, color = kern[0], kc
    plain = rb.composite_ref(color, depth, tr, prep, atlas, 2, cmode,
                             perspective=True)
    kern = _cuda.raster_composite(color.clone(), depth, tr, prep, atlas, 2,
                                  cmode, perspective=True)
    torch.cuda.synchronize()
    assert (kern != color).sum() > 0
    assert torch.equal(kern, plain)


def test_perspective_sky_resolve_matches_twin(env):
    """The sky-fused resolve's perspective instantiation: face and
    mountain pixels exact, other sky pixels within one step."""
    from bonnie32_tpu_torch.ops import _cuda
    _, dev, _ = env
    level = ts.open_air_level(L, S, "night")
    e = rollout.build_env(level, ts.textures(), ts.resolver, device=dev)
    cams = _sky_cams((level, dev, e))
    settings = RasterSettings.game(affine_textures=False)
    surf = scene_flat.build_surfaces_flat(e.flat, cams, settings, W, H)
    prep = rb.prep_instance(surf, e.flat.atlas, W, H)
    planes = _cuda.raster_visibility(prep, e.flat.atlas, H, W,
                                     perspective=True)
    scal = sky_ops.prep_sky_scal(e.sky, cams, W, H)
    bg = sky_ops.SkyBackground(e.sky, scal)
    kc = _cuda.raster_resolve(prep, e.flat.atlas, *planes[1:], 2, bg,
                              perspective=True)
    pc = rb.resolve_ref(prep, e.flat.atlas, *planes[1:], 2, bg,
                        perspective=True)
    torch.cuda.synchronize()
    face = planes[0] != 0
    mtn = sky_ops.mountain_mask(e.sky, scal, H, W)
    assert 0 < int(face.sum()) < face.numel()
    assert torch.equal(kc[face], pc[face])
    assert torch.equal(kc[mtn & ~face], pc[mtn & ~face])
    assert int(_step(kc, pc).max()) <= 1


# settings name -> (level function, textures, settings, asset library?)
EDITOR_PATHS = {
    "perspective": (ts.transparent_cave_level, ts.transparent_textures,
                    RasterSettings.game(affine_textures=False), False),
    "backface_wires": (ts.cave_size_level, ts.textures, RasterSettings(),
                       False),
    "overlay": (ts.transparent_cave_level, ts.transparent_textures,
                RasterSettings(wireframe_overlay=True), False),
    "assets": (ts.asset_level, ts.textures, RasterSettings.game(), True),
}


@pytest.mark.parametrize("name", sorted(EDITOR_PATHS))
def test_editor_and_asset_paths_match_cpu(env, name):
    """step_and_render on the card equals the CPU render of the same
    cameras: perspective UVs, the editor's backface wires and overlay,
    and the level with placed assets."""
    from bonnie32_tpu_torch.models import asset as A
    from bonnie32_tpu_torch.models import mesh as M
    from bonnie32_tpu_torch.models import user_texture as U
    _, dev, _ = env
    build, textures, settings, assets = EDITOR_PATHS[name]
    level = build(L)
    kw = (dict(asset_library=ts.asset_library(A, M),
               user_textures=ts.user_textures(U)) if assets else {})
    e = rollout.build_env(level, textures(), ts.resolver, device=dev, **kw)
    states = rollout.initial_states(level, ts.spawn_point(level), N,
                                    device=dev)
    states, fbs = rollout.step_and_render(
        states, e, _actions(np.random.default_rng(8), dev), settings,
        height=H, width=W)
    cams = stp.character_camera(states, e.params)
    cpu_env = rollout.build_env(level, textures(), ts.resolver,
                                device="cpu", **kw)
    out = rollout.render_cameras(
        cpu_env, CameraArrays(*(x.cpu() for x in cams)), settings, H, W)
    assert torch.equal(out.color, fbs.color.cpu())
    assert torch.equal(out.depth, fbs.depth.cpu())
    if name != "perspective" and name != "assets":
        from bonnie32_tpu_torch.ops import wireframe as wf
        rgb = wf.FRONTFACE_COLOR if name == "overlay" else wf.BACKFACE_COLOR
        assert bool((fbs.color == wf._pack_rgb(rgb)).any())


# ---- the sequential renderer (models/scene.render_level, render.py) ----

def _seq_env(dev, name):
    level, tex, kw, _ = sc.level_args(name)
    return level, tex, kw, rollout.build_env(level, tex, ts.resolver,
                                             device=dev, **kw)


def _kernel_counts():
    from bonnie32_tpu_torch.ops import _cuda
    return [k.launches for k in (_cuda.raster_visibility,
                                 _cuda.raster_resolve,
                                 _cuda.raster_composite)]


# case -> (level, settings, instances in the room's poses (ortho) or the
# character cameras after a tick)
SEQ_CASES = {
    "non_flat": ("cave", RasterSettings.game()),
    "ortho": ("cave", None),
    "editor_asset_level": ("asset", RasterSettings()),
    "transparent_first_room": ("transparent_first_room",
                               RasterSettings.game()),
}


@pytest.mark.parametrize("case", sorted(SEQ_CASES))
def test_sequential_route_matches_cpu(env, case):
    """rollout.render_cameras on the sequential route, on the card, equals
    the same call on the CPU on every pixel (the port's torch code on both
    devices), and launches none of the raster kernels."""
    _, dev, _ = env
    name, settings = SEQ_CASES[case]
    settings = settings or ts.ortho_settings(config)
    level, tex, kw, e = _seq_env(dev, name)
    if case == "non_flat":
        e = e._replace(flat=None, flat_static=None)
    assert not rollout.kernel_route(e, settings)
    if case == "ortho":
        poses = sc.POSES["cave"]
        cams = CameraArrays(
            torch.tensor([p for p, _, _ in poses], device=dev),
            torch.from_numpy(np.stack([build.camera_basis(pi, ya)
                                       for _, pi, ya in poses])).to(dev))
    else:
        states = rollout.initial_states(level, ts.spawn_point(level), N,
                                        device=dev)
        states = stp.tick(states, e.grid, e.params,
                          _actions(np.random.default_rng(4), dev),
                          1.0 / 60.0)
        cams = stp.character_camera(states, e.params)
    before = _kernel_counts()
    fbs = rollout.render_cameras(e, cams, settings, H, W)
    torch.cuda.synchronize()
    assert _kernel_counts() == before
    assert fbs.color.is_cuda
    cpu_env = rollout.build_env(level, tex, ts.resolver, device="cpu", **kw)
    out = rollout.render_cameras(
        cpu_env, CameraArrays(*(x.cpu() for x in cams)), settings, H, W)
    assert bool(((out.color >> 24) & 255 == 255).any())
    assert torch.equal(out.color, fbs.color.cpu())
    assert torch.equal(out.depth, fbs.depth.cpu())


@pytest.mark.parametrize("name", ["cave", "transparent", "asset"])
def test_flat_and_sequential_routes_agree_on_card(env, name):
    """Game settings: the kernel route and the sequential renderer give
    the same frame on the card, pixel for pixel."""
    _, dev, _ = env
    if name == "transparent":
        level = ts.transparent_cave_level(L)
        e = rollout.build_env(level, ts.transparent_textures(), ts.resolver,
                              device=dev)
    else:
        level, _, _, e = _seq_env(dev, name)
    settings = RasterSettings.game()
    assert rollout.kernel_route(e, settings)
    states = rollout.initial_states(level, ts.spawn_point(level), N,
                                    device=dev)
    states = stp.tick(states, e.grid, e.params,
                      _actions(np.random.default_rng(6), dev), 1.0 / 60.0)
    cams = stp.character_camera(states, e.params)
    flat = rollout.render_cameras(e, cams, settings, H, W)
    seq = rollout.render_sequential(e, cams, settings, H, W)
    assert torch.equal(flat.color, seq.color)
    assert torch.equal(flat.depth, seq.depth)


@pytest.mark.parametrize("mode", ["fast", "inv", "harmonic"])
@pytest.mark.parametrize("name", ["ps1_default", "ortho", "blend_modes",
                                  "backface_wireframe"])
def test_render_mesh_15_matches_cpu(env, name, mode):
    """render_mesh_15 of tests/torch_render_cases.py's cube on the card
    equals the CPU's, in each depth mode."""
    _, dev, _ = env
    assert np.array_equal(rc.port_frame(name, mode, device=dev),
                          rc.port_frame(name, mode))


def test_flat_centroids_match_cpu(env):
    """build_surfaces_flat's centroid z (the sort key of transparent faces
    and of painter's mode) divides by a tensor 3: on the card as on the
    CPU, where a Python divisor would become a multiply by its
    reciprocal, an ulp off on a third of the faces."""
    level, dev, e = env
    states = rollout.initial_states(level, ts.spawn_point(level), N,
                                    device=dev)
    cams = stp.character_camera(states, e.params)
    settings = RasterSettings.game()
    card = scene_flat.build_surfaces_flat(e.flat, cams, settings, W, H)
    cpu_env = rollout.build_env(level, ts.textures(), ts.resolver,
                                device="cpu")
    cpu = scene_flat.build_surfaces_flat(
        cpu_env.flat, CameraArrays(*(x.cpu() for x in cams)), settings, W, H)
    assert torch.equal(card.centroid_z.cpu(), cpu.centroid_z)


@pytest.mark.parametrize("name", ["cave", "asset"])
def test_render_level8_matches_cpu(env, name):
    """The 8-bit pipeline (render_level with use_rgb555=False) on a frame
    cleared to F32_MAX, on the card, equals the CPU's in colour and depth
    and launches no raster kernel."""
    from bonnie32_tpu_torch.game import collision as col
    from bonnie32_tpu_torch.models import scene
    from bonnie32_tpu_torch.ops import raster_ref
    _, dev, _ = env
    level, tex, kw, _ = sc.level_args(name)
    grid = col.compile_collision(level, device=dev)
    params = col.player_params(level, device=dev)
    states = stp.tick(rollout.initial_states(level, ts.spawn_point(level),
                                             N, device=dev),
                      grid, params, _actions(np.random.default_rng(8), dev),
                      1.0 / 60.0)
    cams = stp.character_camera(states, params)
    s8 = RasterSettings.game(use_rgb555=False)
    out = {}
    for device, c in ((dev, cams), ("cpu", CameraArrays(*(x.cpu()
                                                          for x in cams)))):
        compiled = scene.compile_level(level, tex, ts.resolver,
                                       with_8bit=True, device=device, **kw)
        fb = raster_ref.new_framebuffer(H, W, "harmonic", n=N, device=device)
        before = _kernel_counts()
        out[str(device)] = scene.render_level(fb, compiled, c, s8)
        torch.cuda.synchronize()
        assert _kernel_counts() == before
    card, cpu = out[str(dev)], out["cpu"]
    assert bool(((cpu.color >> 24) & 255 == 255).any())
    assert torch.equal(card.color.cpu(), cpu.color)
    assert torch.equal(card.depth.cpu(), cpu.depth)


@pytest.mark.parametrize("sky", ["night", "sunset"])
def test_exact_sky_matches_cpu_and_golden(env, sky):
    """render_skybox(exact=True) on the card equals the CPU's (0 pixels)
    at 320x240 and the numpy golden (tests/golden/skybox_golden.py) at
    160x120."""
    from golden import skybox_golden as G
    from bonnie32_tpu_torch.ops import raster_ref
    _, dev, _ = env
    poses = [(0.15, 0.9), (-0.3, 2.2), (0.35, 4.4)]
    basis = torch.from_numpy(np.stack([build.camera_basis(p, y)
                                       for p, y in poses]))
    cfg = ts.sky_config(S, sky)

    def walk(device, h, w, n):
        tables = sky_ops.build_sky_tables(cfg, device=device)
        cams = CameraArrays(torch.zeros(n, 3, device=device),
                            basis[:n].to(device))
        fb = raster_ref.new_framebuffer(h, w, "inv", n=n, device=device)
        return tables, sky_ops.render_skybox(tables, cams, h, w, exact=True,
                                             fb=fb)

    _, card = walk(dev, H, W, len(poses))
    _, cpu = walk("cpu", H, W, len(poses))
    assert torch.equal(card.color.cpu(), cpu.color)
    tables, small = walk(dev, 120, 160, 1)
    gpix = np.zeros((120, 160, 3), np.uint8)
    G.render_skybox_scalar(
        gpix, tables.all_dirs.cpu().numpy(), tables.all_colors.cpu().numpy(),
        tables.all_faces.cpu().numpy(), basis[0].numpy(),
        star_spec=dict(dirs=tables.star_dirs.cpu().numpy(),
                       phase=tables.star_phase.cpu().numpy(),
                       color=tables.star_color.cpu().numpy(),
                       size=tables.star_size, twinkle=tables.star_twinkle,
                       enabled=tables.stars_enabled), time=tables.time)
    word = small.color[0].cpu().numpy()
    ours = np.stack([(word >> sh) & 255 for sh in (0, 8, 16)], -1)
    assert int((ours != gpix).any(-1).sum()) == 0


def test_render_game_view_matches_cpu(env):
    """One 320x240 game view of the open-air night level from a
    GameToolState on the card after scripted input: one `raster_sky`
    launch; face pixels and depth equal the CPU's, sky pixels within one
    8-bit step."""
    from bonnie32_tpu_torch.game import collision as col
    from bonnie32_tpu_torch.game import runtime as rt
    from bonnie32_tpu_torch.game import viewport as vp
    from bonnie32_tpu_torch.input import InputState, VirtualGamepad
    from bonnie32_tpu_torch.models import scene
    from bonnie32_tpu_torch.ops import _cuda
    _, dev, _ = env
    level = ts.open_air_level(L, S)
    tool = rt.GameToolState(col.compile_collision(level, device=dev),
                            col.player_params(level, device=dev),
                            device=dev)
    tool.spawn_player(ts.spawn_point(level))
    tool.playing = True
    gp = VirtualGamepad()
    inp = InputState(gamepad=gp)
    for _ in range(3):
        gp.update(axes=dict(lx=0.2, ly=1.0, rx=0.4, ry=0.0), buttons={"b"})
        tool.tick(inp)
    cams = tool.camera()
    settings = RasterSettings.game(low_resolution=True,
                                   stretch_to_fill=False)
    cfg = S.Skybox.from_ron(level.skybox)
    out = {}
    for device, c in ((dev, cams), ("cpu", CameraArrays(*(x.cpu()
                                                          for x in cams)))):
        compiled = scene.compile_level(level, ts.textures(), ts.resolver,
                                       with_8bit=True, device=device)
        sky = sky_ops.build_sky_tables(cfg, device=device)
        before = _cuda.raster_sky.launches
        out[str(device)] = vp.render_game_view(compiled, c, settings,
                                               (0, 0, 800, 600), sky=sky)
        torch.cuda.synchronize()
        assert _cuda.raster_sky.launches - before == (
            1 if str(device) != "cpu" else 0)
    card, cpu = out[str(dev)].fb, out["cpu"].fb
    assert card.color.shape == (1, 240, 320)
    step = torch.zeros(cpu.color.shape, dtype=torch.int64)
    for sh in (0, 8, 16, 24):
        step = torch.maximum(step, (((card.color.cpu() >> sh) & 255).long()
                                    - ((cpu.color >> sh) & 255).long()).abs())
    faces = cpu.depth != 0
    assert bool(faces.any()) and bool((~faces).any())
    assert not bool((step[faces] > 0).any())
    assert not bool((step[~faces] > 1).any())
    assert torch.equal(card.depth.cpu(), cpu.depth)


# ---- the editor and modeler viewports (torch code, no kernel launch) ----

def _draw2d_cases(td, cams):
    """draw2d primitives of every kind on a 120x160 frame, as functions of
    a FrameBuffers."""
    r = np.random.default_rng(8)
    ex = r.integers(-20, 180, (12, 2)).astype(np.int32)
    ey = r.integers(-20, 140, (12, 2)).astype(np.int32)
    ez = r.uniform(1.0, 60.0, (12, 2)).astype(np.float32)
    p0 = r.uniform(-6, 6, (16, 3)).astype(np.float32)
    p1 = r.uniform(-6, 6, (16, 3)).astype(np.float32)
    return {
        "gradient": lambda fb: td.clear_gradient(fb, (200, 100, 0),
                                                 (0, 50, 250)),
        "rects": lambda fb: td.draw_rect(td.draw_filled_rect(
            fb, 10, 5, 150, 100, (255, 0, 0), alpha=128), 3, 3, 90, 60,
            (0, 255, 0)),
        "circles": lambda fb: td.draw_circle_outline(td.draw_circle(
            fb, 60, 50, 25, (255, 128, 0), alpha=90), 80, 60, 40,
            (0, 200, 0), thickness=3),
        "triangle": lambda fb: td.draw_filled_triangle(
            fb, 10.3, 5.7, 150.2, 40.9, 60.5, 115.1, (200, 10, 10),
            alpha=100, clip=(20, 10, 120, 100)),
        "scanline": lambda fb: td.draw_filled_triangle_scanline(
            fb, (10, 100), (150, 10), (90, 130), (255, 255, 100)),
        "thick_line": lambda fb: td.draw_thick_line(fb, 10, 10, 150, 100, 6,
                                                    (255, 0, 128)),
        "lines": lambda fb: td.draw_lines(fb, ex, ey, (255, 40, 10)),
        "lines_alpha": lambda fb: td.draw_lines_alpha(fb, ex, ey,
                                                      (20, 240, 90), 128),
        "lines_3d_alpha": lambda fb: td.draw_lines_3d_alpha(
            fb, ex, ey, ez, (40, 250, 200), 128, depth_mode="harmonic"),
        "lines_3d_255": lambda fb: td.draw_lines_3d_alpha(
            fb, ex, ey, ez, (40, 250, 200), 255, depth_mode="harmonic"),
        "clipped_3d": lambda fb: td.draw_3d_lines_clipped(
            fb, p0, p1, cams(fb), (255, 100, 40)),
        "floor_grid": lambda fb: td.draw_floor_grid(fb, cams(fb), 2.0, 1.0,
                                                    5.0),
        "cylinder": lambda fb: td.draw_wireframe_cylinder(
            fb, cams(fb), (0.5, 1.0, 2.0), 3.0, -4.0, depth_test="equal"),
        "text_image": lambda fb: td.draw_image(td.draw_text(
            fb, 3, 4, "Hello 0123", (250, 250, 0), scale=2,
            clip=(0, 0, 100, 60)), 130, -10, ex.reshape(4, 6)),
    }


def test_draw2d_primitives_match_cpu(env):
    """Every draw2d primitive on two instances: card = CPU, bit for bit."""
    from bonnie32_tpu_torch.ops import draw2d as td
    from bonnie32_tpu_torch.types import FrameBuffers
    _, dev, _ = env
    r = np.random.default_rng(9)
    color = torch.from_numpy((r.integers(0, 1 << 24, (2, 120, 160))
                              | (255 << 24)).astype(np.uint32).view(np.int32))
    depth = torch.from_numpy(r.uniform(2, 60, (2, 120, 160)).astype(
        np.float32))
    pos = torch.tensor([[0.0, 6.0, -12.0], [2.0, 8.0, -9.0]])
    basis = torch.from_numpy(np.stack([build.camera_basis(0.25, 0.15),
                                       build.camera_basis(0.45, -0.3)]))

    def cams(fb):
        d = fb.color.device
        return CameraArrays(pos.to(d), basis.to(d))

    for name, case in _draw2d_cases(td, cams).items():
        card = case(FrameBuffers(color.to(dev), depth.to(dev)))
        cpu = case(FrameBuffers(color.clone(), depth.clone()))
        assert card.color.device.type == "cuda", name
        assert torch.equal(card.color.cpu(), cpu.color), name
        assert torch.equal(card.depth.cpu(), cpu.depth), name
        assert bool((cpu.color != color).any()), name


def test_paint_and_icons_match_cpu(env):
    import torch_editor_cases as ec
    from bonnie32_tpu_torch import ui
    from bonnie32_tpu_torch.types import FrameBuffers
    _, dev, _ = env
    bg = torch.from_numpy((np.random.default_rng(3).integers(
        0, 1 << 24, (1, 480, 640)) | (255 << 24)).astype(np.uint32).view(
        np.int32))
    out = {}
    for device in (dev, torch.device("cpu")):
        fb = FrameBuffers(bg.to(device), torch.zeros((1, 480, 640),
                                                      device=device))
        fb = ec.paint_queue(ui, scale=4).paint(fb)
        for name, scale, rect in ec.ICONS:
            fb = ui.icons.draw_icon_centered(
                fb, name, ui.Rect(*(4 * v for v in rect)), (9, 200, 90),
                scale=4 * scale)
        out[device.type] = fb.color
    assert out["cuda"].device.type == "cuda"
    assert torch.equal(out["cuda"].cpu(), out["cpu"])


@pytest.mark.parametrize("name", ["cave", "two_room", "asset"])
def test_render_editor_viewport_matches_cpu(env, name):
    """The world editor's 3-D view at 320x240 on the card by default:
    colour and depth equal the CPU's, and no raster kernel launches."""
    import torch_editor_cases as ec
    from bonnie32_tpu_torch.editor import state as ES
    from bonnie32_tpu_torch.editor import viewport_edit as VE
    from bonnie32_tpu_torch.editor import viewport_render as VR
    from bonnie32_tpu_torch.models import asset as A
    from bonnie32_tpu_torch.models import mesh as M
    from bonnie32_tpu_torch.models import scene
    from bonnie32_tpu_torch.models import user_texture as U
    from bonnie32_tpu_torch.ops import _cuda
    _, dev, _ = env
    st, ed, hv, tex, kw = ec.editor_case(name, L, ES, VE, A, M, U, scene)
    sc_c = scene.compile_level(st.level, tex, ts.resolver, device="cpu",
                               **kw)
    before = (_cuda.raster_visibility.launches, _cuda.raster_resolve.launches)
    card = VR.render_editor_viewport(st, sc_c, 320, 240, editor=ed,
                                     hover=hv)
    torch.cuda.synchronize()
    assert (_cuda.raster_visibility.launches,
            _cuda.raster_resolve.launches) == before
    cpu = VR.render_editor_viewport(st, sc_c, 320, 240, editor=ed, hover=hv,
                                    device="cpu")
    assert card.color.device.type == "cuda"
    assert torch.equal(card.color.cpu(), cpu.color)
    assert torch.equal(card.depth.cpu(), cpu.depth)


def test_pick_triangle_matches_cpu(env):
    """64 seeded rays over the Cave-size level's triangles, and a ray per
    pixel onto a plane: equal indices, t and masks."""
    from bonnie32_tpu_torch.models import scene
    from bonnie32_tpu_torch.ops import picking as pk
    level, dev, _ = env
    sc_c = scene.compile_level(level, ts.textures(), ts.resolver,
                               device="cpu")
    tris = sc_c.mesh.pos[0][sc_c.faces.vidx[0][sc_c.faces.valid[0]].long()]
    r = np.random.default_rng(4)
    px = torch.from_numpy(r.uniform(0, 320, 64).astype(np.float32))
    py = torch.from_numpy(r.uniform(0, 240, 64).astype(np.float32))
    cam = torch.tensor([512.0, 2000.0, -300.0])
    basis = torch.from_numpy(build.camera_basis(0.25, 0.6))
    out = []
    for d in (dev, torch.device("cpu")):
        o, v = pk.screen_to_ray(px.to(d), py.to(d), 320, 240, cam.to(d),
                                basis.to(d))
        out.append(pk.pick_triangle(o, v, tris.to(d))
                   + pk.ray_plane_intersection(o, v, cam.to(d) * 0,
                                               basis[1].to(d)))
    for a, b in zip(*out):
        assert torch.equal(a.cpu(), b)
    assert int(out[1][2].sum()) > 32


# ---------------------------------------------------------------------------
# the tracker's audio path: csrc/audio.cu's spu_reverb and spu_resample
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    return torch.device("cuda", 0)


def _audio_noise(seed, shape, loud=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) * rng.uniform(0.05, 1.5, shape[:1] + (1,))
    if loud:    # a +-1 square wave: `_mul_vol`'s product wraps
        x[0] = np.where((np.arange(shape[1]) // 50) % 2 == 0, 1.0, -1.0)
    return torch.from_numpy(x.astype(np.float32))


def _prefilled_reverb(card, streams, seed):
    """A reverb state of seeded int16 words, pos 300 words before the
    wrap, so that windows straddle it and far reads return words."""
    from bonnie32_tpu_torch.audio import reverb as rvb
    rng = np.random.default_rng(seed)
    words = rng.integers(-32768, 32768, (2, streams, rvb.BUFFER_SIZE))
    return rvb.ReverbState(
        buffer_l=torch.from_numpy(words[0].astype(np.int32)).to(card),
        buffer_r=torch.from_numpy(words[1].astype(np.int32)).to(card),
        pos=torch.full((streams,), rvb.BUFFER_SIZE - 300, dtype=torch.int32,
                       device=card),
        accum=torch.full((streams,), 0.5, device=card))


@pytest.mark.parametrize("preset", range(10))
def test_spu_reverb_matches_twin(card, preset):
    """Every preset (OFF too) from pre-filled buffers near the wrap, calls
    of 1, 37 and 735 samples with the state carried."""
    from bonnie32_tpu_torch.audio import reverb as rvb
    lengths = (1, 37, 735)
    left = _audio_noise(preset, (4, sum(lengths)), loud=True).to(card)
    right = _audio_noise(preset + 50, (4, sum(lengths)), loud=True).to(card)
    params = rvb.preset_params(preset)
    st_k = _prefilled_reverb(card, 4, preset)
    st_p = rvb.ReverbState(*(t.clone() for t in st_k))
    before = rvb.spu_reverb.launches
    a = 0
    for n in lengths:
        seg = slice(a, a + n)
        st_k, kl, kr = rvb.process(st_k, left[:, seg], right[:, seg],
                                   params, 0.6)
        st_p, pl, pr = rvb.process_ref(st_p, left[:, seg], right[:, seg],
                                       params, 0.6)
        assert torch.equal(kl, pl) and torch.equal(kr, pr)
        for x, y in zip(st_k, st_p):
            assert torch.equal(x, y)
        a += n
    assert rvb.spu_reverb.launches == before + len(lengths)
    assert int(st_k.pos.max()) < rvb.BUFFER_SIZE - 300   # crossed the wrap


@pytest.mark.parametrize("pitch", [0x0800, 0x0400, 0x0200])
def test_spu_resample_matches_twin(card, pitch):
    """Short calls (1, ratio - 1, 37), a call over several of the
    kernel's segments, then the other pitches in turn with the count
    carried across the change."""
    from bonnie32_tpu_torch.audio import resampler as rsp
    ratio = rsp.PITCH_NATIVE // pitch
    calls = [(1, pitch), (ratio - 1, pitch), (37, pitch), (451, pitch),
             (2 * rsp.SEGMENT + 99, pitch)]
    calls += [(n, p) for p in (0x0800, 0x0400, 0x0200) if p != pitch
              for n in (3, 37)]
    total = sum(n for n, _ in calls)
    left = _audio_noise(pitch, (3, total)).to(card)
    right = _audio_noise(pitch + 1, (3, total)).to(card)
    st_k = rsp.init_state(card, streams=3)
    st_p = rsp.init_state(card, streams=3)
    a = 0
    for n, p in calls:
        seg = slice(a, a + n)
        st_k, kl, kr = rsp.process(st_k, left[:, seg], right[:, seg], p)
        st_p, pl, pr = rsp.process_ref(st_p, left[:, seg], right[:, seg], p)
        assert torch.equal(kl, pl) and torch.equal(kr, pr)
        for x, y in zip(st_k, st_p):
            assert torch.equal(x, y)
        a += n


@pytest.mark.parametrize("preset", [1, 5])
def test_spu_reverb_other_rates_and_disabled_match_twin(card, preset):
    """Output rates of 48 kHz and 22.05 kHz (every sample ticks, so a
    window ends on its tick limit before its sample limit), with the mix
    on and off, the state carried."""
    from bonnie32_tpu_torch.audio import reverb as rvb
    left = _audio_noise(preset + 7, (2, 800)).to(card)
    right = _audio_noise(preset + 9, (2, 800)).to(card)
    params = rvb.preset_params(preset)
    for rate_ratio in (48000 / 22050, 1.0):
        for enabled in (True, False):
            st_k = _prefilled_reverb(card, 2, preset)
            st_p = rvb.ReverbState(*(t.clone() for t in st_k))
            for seg in (slice(0, 450), slice(450, 800)):
                st_k, kl, kr = rvb.process(st_k, left[:, seg], right[:, seg],
                                           params, 0.6, 0.9, rate_ratio,
                                           enabled)
                st_p, pl, pr = rvb.process_ref(st_p, left[:, seg],
                                               right[:, seg], params, 0.6,
                                               0.9, rate_ratio, enabled)
                assert torch.equal(kl, pl) and torch.equal(kr, pr)
                for x, y in zip(st_k, st_p):
                    assert torch.equal(x, y)
            if not enabled:
                assert torch.equal(kl, left[:, 450:])


def test_spu_resample_disabled_matches_twin(card):
    from bonnie32_tpu_torch.audio import resampler as rsp
    left = _audio_noise(11, (2, 1500)).to(card)
    right = _audio_noise(12, (2, 1500)).to(card)
    st_k = rsp.init_state(card, streams=2)
    st_p = rsp.init_state(card, streams=2)
    for seg in (slice(0, 5), slice(5, 1500)):
        st_k, kl, kr = rsp.process(st_k, left[:, seg], right[:, seg],
                                   rsp.PITCH_11K, enabled=False)
        st_p, pl, pr = rsp.process_ref(st_p, left[:, seg], right[:, seg],
                                       rsp.PITCH_11K, enabled=False)
        assert torch.equal(kl, left[:, seg]) and torch.equal(kl, pl)
        assert torch.equal(kr, pr)
        for x, y in zip(st_k, st_p):
            assert torch.equal(x, y)


def test_game_tick_card_matches_cpu(env):
    """The same N=64 states and seeded actions ticked on the card and on
    the CPU for 300 frames: frames 1-3 within the CPU tick's tolerance
    against the JAX package (integers exact, floats rtol 1e-5 / atol
    1e-4); the drift after 30 and 300 frames is printed, held to
    nothing."""
    import torch_tick_drift as td
    level, dev, e = env
    cpu_env = rollout.build_env(level, ts.textures(), ts.resolver,
                                device="cpu")
    report = td.tick_drift(level, [(e, dev), (cpu_env, torch.device("cpu"))],
                           64, 300, 0)
    print(td.summary(report))
    assert td.held_faults(report) == []


def test_inplace_process_updates_the_given_state(card):
    """SpuChain's calls: (N,) inputs on an unbatched state, `inplace`: the
    kernels write the caller's tensors, with the results of the pure
    call."""
    from bonnie32_tpu_torch.audio import resampler as rsp
    from bonnie32_tpu_torch.audio import reverb as rvb
    x = _audio_noise(7, (2, 735), loud=True).to(card)
    params = rvb.preset_params(5)
    st = rvb.init_state(card)
    ref = rvb.process(rvb.init_state(card), x[0], x[1], params, 0.6)
    got = rvb.process(st, x[0], x[1], params, 0.6, inplace=True)
    q = rsp.init_state(card)
    qref = rsp.process(rsp.init_state(card), x[0], x[1], 0x0800)
    qgot = rsp.process(q, x[0], x[1], 0x0800, inplace=True)
    for given, out, want in ((st, got, ref), (q, qgot, qref)):
        for a, b, c in zip(given, out[0], want[0]):
            assert a.data_ptr() == b.data_ptr() and torch.equal(b, c)
        assert torch.equal(out[1], want[1]) and torch.equal(out[2], want[2])
    assert int(st.pos) == 367


def test_render_song_and_stream_match_cpu(card):
    from bonnie32_tpu_torch.audio import engine
    from bonnie32_tpu_torch.audio import song as M
    from bonnie32_tpu_torch.audio import stream as strm
    song = ts.demo_song(M, patterns=1, rows=6, channels=5, bpm=1200,
                        reverb=5, rate0=2, seed=3)
    got = engine.render_song(song)          # the default device: the card
    ref = engine.render_song(song, device="cpu")
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    st = strm.AudioStream(song)
    assert st.chain.reverb_state.buffer_l.is_cuda
    parts = []
    while st.position < st.total:
        st.render_audio(1 / 60)
        parts.append(st.read(st.ring.available)[0])
    np.testing.assert_array_equal(np.concatenate(parts)[:len(ref[0])],
                                  ref[0])


# ---- the datagen fleet's surroundings: sharded step, checkpoint resume,
# raster counters, debug overlay ----

def _fleet_frames(states, e, dev, frames, seed, step=None, mesh=None):
    """`frames` chained frames of seeded actions at H x W: unsharded, or
    through `step` over `mesh` (states given as shards).  Returns the
    states and the frames (gathered onto `dev`)."""
    from bonnie32_tpu_torch.parallel import mesh as pmesh
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(frames):
        acts = stp.Actions(**{k: torch.from_numpy(v).to(dev)
                              for k, v in ts.actions_np(rng, N * 16).items()})
        if step is None:
            states, fb = rollout.step_and_render(
                states, e, acts, RasterSettings.game(), height=H, width=W,
                instance_chunk=None)
        else:
            states, fbs = step(states, pmesh.shard_instances(acts, mesh))
            fb = pmesh.gather_instances(fbs, dev)
        out.append(fb)
    return states, out


def test_sharded_step_on_card_equals_unsharded(env):
    """N=64 over the visible cards and over cuda:0 named four times, 3
    chained frames: frames and every state word equal the unsharded
    step's; each shard launches the visibility and resolve kernels."""
    from bonnie32_tpu_torch.ops import _cuda
    from bonnie32_tpu_torch.parallel import mesh as pmesh
    level, dev, e = env
    n = N * 16
    start = rollout.initial_states(level, ts.spawn_point(level), n,
                                   device=dev)
    ref_states, ref = _fleet_frames(start, e, dev, 3, 21)
    for mesh in (pmesh.instance_mesh(), pmesh.instance_mesh([dev] * 4)):
        step = pmesh.sharded_step_and_render(mesh, e, RasterSettings.game(),
                                             H, W)
        before = _cuda.raster_visibility.launches
        shards, got = _fleet_frames(pmesh.shard_instances(start, mesh), e,
                                    dev, 3, 21, step, mesh)
        assert _cuda.raster_visibility.launches - before == 3 * len(mesh)
        for a, b in zip(got, ref):
            assert torch.equal(a.color, b.color)
            assert torch.equal(a.depth.view(torch.int32),
                               b.depth.view(torch.int32))
        out = pmesh.gather_instances(shards, dev)
        for f in out._fields:
            a, b = getattr(out, f), getattr(ref_states, f)
            if a.dtype.is_floating_point:
                a, b = a.view(torch.int32), b.view(torch.int32)
            assert torch.equal(a, b), f


def test_checkpoint_resume_on_card(env, tmp_path):
    """2 frames, save, restore into a fresh template on the card, 2 more:
    equal to 4 frames run straight through."""
    from bonnie32_tpu_torch import checkpoint as ckpt
    level, dev, e = env
    n = N * 16
    fresh = lambda: rollout.initial_states(  # noqa: E731
        level, ts.spawn_point(level), n, device=dev)
    straight, fbs = _fleet_frames(fresh(), e, dev, 4, 22)
    half, _ = _fleet_frames(fresh(), e, dev, 2, 22)
    p = str(tmp_path / "fleet.npz")
    ckpt.save(p, half)
    back = ckpt.restore(p, fresh())
    assert all(t.is_cuda for t in back)
    # the resumed run takes frames 3-4 of the same action stream
    rng = np.random.default_rng(22)
    for _ in range(2):
        ts.actions_np(rng, n)
    for _ in range(2):
        acts = stp.Actions(**{k: torch.from_numpy(v).to(dev)
                              for k, v in ts.actions_np(rng, n).items()})
        back, fb = rollout.step_and_render(back, e, acts,
                                           RasterSettings.game(), height=H,
                                           width=W, instance_chunk=None)
    assert torch.equal(fb.color, fbs[-1].color)
    for f in back._fields:
        a, b = getattr(back, f), getattr(straight, f)
        if a.dtype.is_floating_point:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), f


@pytest.mark.parametrize("cull", [True, False])
def test_raster_stats_card_matches_cpu(env, cull):
    import torch_fleet_cases as fc
    from bonnie32_tpu_torch import profiling
    from bonnie32_tpu_torch.types import to_device
    level, dev, e = env
    states = rollout.initial_states(level, ts.spawn_point(level), 64,
                                    device=dev)
    rng = np.random.default_rng(23)
    acts = stp.Actions(**{k: torch.from_numpy(v).to(dev)
                          for k, v in ts.actions_np(rng, 64).items()})
    states = stp.tick(states, e.grid, e.params, acts, 1.0 / 60.0)
    cams = stp.character_camera(states, e.params)
    settings = RasterSettings.game(backface_cull=cull)
    tables = fc.room_tables(e.scene)
    got = profiling.raster_stats(*tables[:3], cams, *tables[3:], settings,
                                 W, H)
    want = profiling.raster_stats(*to_device(tables[:3], "cpu"),
                                  to_device(cams, "cpu"),
                                  *to_device(tables[3:], "cpu"), settings,
                                  W, H)
    for a, b in zip(got, want):
        assert a.is_cuda and torch.equal(a.cpu(), b)
    assert int(got.triangles_drawn.min()) > 0


def test_debug_views_card_match_cpu(env):
    import torch_fleet_cases as fc
    from bonnie32_tpu_torch.types import FrameBuffers
    level, dev, e = env
    r = np.random.default_rng(24)
    color = torch.from_numpy((r.integers(0, 1 << 24, (1, H, W))
                              | (255 << 24)).astype(np.uint32).view(np.int32))
    depth = torch.full((1, H, W), 2.0)
    got = fc.paint_debug_views(FrameBuffers(color.to(dev), depth.to(dev)))
    want = fc.paint_debug_views(FrameBuffers(color.clone(), depth))
    assert got.color.is_cuda
    assert int((want.color != color).sum()) > 5000
    assert torch.equal(got.color.cpu(), want.color)
    assert torch.equal(got.depth.cpu(), want.depth)


def test_widget_frame_paint_matches_cpu(env):
    import torch_ui_cases as uc
    from bonnie32_tpu_torch import ui
    from bonnie32_tpu_torch.types import FrameBuffers
    _, dev, _ = env
    ctx, _ = uc.widget_frame(ui, 0)
    w, h = uc.FRAME_SIZE
    r = np.random.default_rng(25)
    color = torch.from_numpy((r.integers(0, 1 << 24, (2, h, w))
                              | (255 << 24)).astype(np.uint32).view(np.int32))
    depth = torch.full((2, h, w), 2.0)
    got = ctx.paint(FrameBuffers(color.to(dev), depth.to(dev)))
    want = ctx.paint(FrameBuffers(color.clone(), depth))
    assert got.color.is_cuda
    assert int((want.color != color).sum()) > 50000
    assert torch.equal(got.color.cpu(), want.color)


def test_text_input_and_landing_match_cpu(env):
    import torch_ui_cases as uc
    from bonnie32_tpu_torch import ui
    from bonnie32_tpu_torch.types import FrameBuffers
    _, dev, _ = env
    color = torch.zeros((2, H, W), dtype=torch.int32)
    depth = torch.zeros((2, H, W))
    for scale in (1, 2):
        got, trace = uc.text_input_calls(
            ui, FrameBuffers(color.to(dev), depth.to(dev)), scale)
        want, ctrace = uc.text_input_calls(
            ui, FrameBuffers(color.clone(), depth.clone()), scale)
        assert trace == ctrace and got.color.is_cuda
        assert torch.equal(got.color.cpu(), want.color)
    got, out = uc.landing_calls(ui, FrameBuffers(color.to(dev),
                                                 depth.to(dev)), W, H)
    want, cout = uc.landing_calls(ui, FrameBuffers(color.clone(),
                                                   depth.clone()), W, H)
    assert out == cout and out[1] is not None
    assert torch.equal(got.color.cpu(), want.color)


def test_drag_tracker_on_card_matches_cpu(env):
    import torch_ui_cases as uc
    from bonnie32_tpu_torch import ui
    _, dev, _ = env
    for seed in range(3):
        pos, basis = uc.drag_camera(seed)
        got = uc.run_drags(ui, torch.from_numpy(pos).to(dev),
                           torch.from_numpy(basis).to(dev), seed)
        want = uc.run_drags(ui, pos, basis, seed)
        for (name, snap, a), (_, _, b) in zip(got, want):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x[0], y[0], name)
                assert x[4] == y[4]
                if snap != "none" or not name.startswith("circle"):
                    assert (x[1], x[3]) == (y[1], y[3]), name
                else:
                    assert abs(x[1] - y[1]) <= 1e-5, name


@pytest.mark.parametrize("depth", [0, 1])
def test_imported_texture_on_card_matches_cpu(env, depth):
    import torch_ui_cases as uc
    from bonnie32_tpu_torch import entry, texture
    level, dev, _ = env
    _, tex = uc.imported_texture(texture, uc.import_rgba(0), depth)
    textures = ts.textures()
    textures[ts.TEXTURE_NAMES.index("FLOOR")] = (tex.to_texture15(), 0)
    frames = {}
    for d in (dev, torch.device("cpu")):
        fn, args = entry.entry(level, n=N, device=d, textures=textures,
                               resolve=ts.resolver)
        frames[d.type] = fn(*args)
    assert frames["cuda"].color.is_cuda
    assert torch.equal(frames["cuda"].color.cpu(), frames["cpu"].color)
    assert torch.equal(frames["cuda"].depth.cpu(), frames["cpu"].depth)


def test_checkpoint_through_storage_on_card(env, tmp_path):
    import torch_cloud_server as fake
    from bonnie32_tpu_torch import checkpoint as ckpt
    from bonnie32_tpu_torch import storage
    from bonnie32_tpu_torch.storage.cloud import HttpCloudBackend
    level, dev, _ = env
    spawn = ts.spawn_point(level)
    states = rollout.initial_states(level, spawn, 64, device=dev)
    data = ckpt.save_bytes(states)
    path = "assets/userdata/fleet/states.npz"
    with fake.serve() as (url, _):
        clouds = (None, storage.CloudStorage(),
                  storage.CloudStorage(HttpCloudBackend(
                      url, token_provider=lambda: fake.TOKEN)))
        for cloud in clouds:
            s = storage.Storage(local=storage.LocalStorage(str(tmp_path)),
                                cloud=cloud)
            s.write(path, data).wait()
            back = ckpt.restore_bytes(s.read(path).wait(),
                                      rollout.initial_states(
                                          level, spawn, 64, device=dev))
            for f in back._fields:
                a, b = getattr(back, f), getattr(states, f)
                assert a.is_cuda and torch.equal(a, b), f
    big = ckpt.save_bytes(rollout.initial_states(level, spawn, 1024,
                                                 device=dev))
    with pytest.raises(storage.StorageError) as err:
        storage.CloudStorage().write(path, big).take()
    assert err.value.kind == "FileTooLarge"
