"""CUDA kernels of the port on a card (marker `gpu`; skipped without one).

Imports no jax, so it runs where the card is; tests/conftest.py imports
jax, hence --noconftest there:

    python -m pytest tests/test_torch_gpu.py -q -m gpu --noconftest -o addopts=""

The kernels of csrc/raster.cu are held against their plain torch twins
bit for bit (both sides are uncontracted IEEE f32 in the same order), and
the main path is shown to launch them once per frame.
"""

import numpy as np
import pytest
import torch

import torch_scenes as ts
from bonnie32_tpu_torch import rollout
from bonnie32_tpu_torch._host.models import level as L
from bonnie32_tpu_torch.config import RasterSettings
from bonnie32_tpu_torch.game import step as stp
from bonnie32_tpu_torch.models import scene_flat
from bonnie32_tpu_torch.ops import raster_batch as rb
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
    cpu_env = rollout.build_env(level, ts.textures(), ts.resolver)
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
