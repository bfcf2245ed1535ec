"""CUDA kernels of the port on a card (marker `gpu`; skipped without one).

Imports no jax, so it runs where the card is; tests/conftest.py imports
jax, hence --noconftest there:

    python -m pytest tests/test_torch_gpu.py -q -m gpu --noconftest -o addopts=""

The kernels of csrc/raster.cu are held against their plain torch twins
bit for bit (both sides are uncontracted IEEE f32 in the same order), and
the main paths (opaque, transparent, x-ray, painter's) are shown to
launch them once per frame and to equal the CPU render.  The sky
(`raster_sky`, and `raster_resolve` with the sky behind the faces) is
exact on face and mountain pixels and within one 8-bit step on the other
sky pixels (acos, atan2, sin and pow differ by ulps between nvcc's and
torch's libraries); `select_gather` of csrc/gather.cu is exact.
"""

import numpy as np
import pytest
import torch

import torch_scenes as ts
from bonnie32_tpu_torch import rollout
from bonnie32_tpu_torch.models import level as L
from bonnie32_tpu_torch.models import skybox as S
from bonnie32_tpu_torch.config import RasterSettings
from bonnie32_tpu_torch.game import step as stp
from bonnie32_tpu_torch.models import scene_flat
from bonnie32_tpu_torch.ops import gather as tg
from bonnie32_tpu_torch.ops import raster_batch as rb
from bonnie32_tpu_torch.ops import skybox as sky_ops
from bonnie32_tpu_torch.types import CameraArrays

pytestmark = pytest.mark.gpu
H, W, N = 240, 320, 4


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


@pytest.fixture(scope="module")
def tenv(env):
    _, dev, _ = env
    level = ts.transparent_cave_level(L)
    return level, dev, rollout.build_env(level, ts.transparent_textures(),
                                         ts.resolver, device=dev)


def _transparent_inputs(tenv, settings):
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


def test_sky_kernels_match_twin(sky_env):
    from bonnie32_tpu_torch.ops import _cuda
    level, dev, e = sky_env
    settings = RasterSettings.game()
    states = rollout.initial_states(level, ts.spawn_point(level), N,
                                    device=dev)
    states = stp.tick(states, e.grid, e.params,
                      _actions(np.random.default_rng(4), dev), 1.0 / 60.0)
    cams = stp.character_camera(states, e.params)
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
