"""The port's per-room scene compile and sequential renderer on the
asset level (tests/torch_scenes.py: a two-part asset placed twice in the
Cave-size level, lit by its Light components) against the JAX package's
on the CPU: the compiled draws exact, frames within the seam budget
max(64 N, pixels / 500), with the asset draws and without them
(`render_assets=False`)."""

import numpy as np
import pytest
import torch

import jax_refs
import torch_seq_cases as sc
from bonnie32_tpu_torch.config import RasterSettings

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def compiled():
    return jax_refs.compile_both("asset")


@pytest.mark.parametrize("path", sc.scene_fields())
def test_compile_level_assets_match_jax(compiled, path):
    jsc, tsc = compiled
    ours, theirs = sc.field(tsc, path), sc.field(jsc, path)
    assert ours.dtype == theirs.dtype, (ours.dtype, theirs.dtype)
    np.testing.assert_array_equal(ours, theirs)


def test_asset_draws_counted(compiled):
    _, tsc = compiled
    assert tsc.a_count == 4 and tsc.a_ambient.shape[0] == 4
    assert bool(tsc.lights.kind.ne(0).any())


@pytest.mark.parametrize("render_assets", [True, False])
def test_render_level_assets_match_jax(compiled, render_assets):
    settings = RasterSettings.game()
    cams, jcolor = jax_refs.jax_render_level("asset", settings,
                                       render_assets=render_assets)
    ours = sc.port_render_level(compiled[1], cams, settings,
                                render_assets=render_assets)
    assert sc.lit_share(jcolor) > 0.5
    diff = int((ours != jcolor).sum())
    assert diff <= sc.seam_budget(jcolor), diff
    other = sc.port_render_level(compiled[1], cams, settings,
                                 render_assets=not render_assets)
    assert (ours != other).any(), "the asset draws show in no frame"
