"""The port's per-room scene compile and sequential renderer
(models/scene.compile_level, render_level) against the JAX package's, on
the CPU, on the Cave-size level (tests/torch_scenes.py): the game
settings in "fast" mode, the sequential compositor ("inv"), and ortho
projection over a harmonic depth plane.  tests/test_torch_scene_seq_rooms.py
holds the two-room level and the render options, _assets.py the asset
level; each file computes its own JAX references, so that the test
workers compute them in parallel.

Tolerances: the compiled tables are exact (the same host numpy); frames
within the seam budget max(64 N, pixels / 500) at 48x64 (XLA:CPU
contracts FMAs, the port does not).
"""

import numpy as np
import pytest
import torch

import jax_refs
import torch_scenes as ts
import torch_seq_cases as sc
from bonnie32_tpu_torch.config import RasterSettings

torch.set_num_threads(1)
LEVELS = ("cave",)


@pytest.fixture(scope="module")
def compiled():
    return {name: jax_refs.compile_both(name) for name in LEVELS}


@pytest.mark.parametrize("path", sc.scene_fields())
@pytest.mark.parametrize("level", LEVELS)
def test_compile_level_matches_jax(compiled, level, path):
    jsc, tsc = compiled[level]
    ours, theirs = sc.field(tsc, path), sc.field(jsc, path)
    assert ours.dtype == theirs.dtype, (ours.dtype, theirs.dtype)
    np.testing.assert_array_equal(ours, theirs)


def _ortho():
    from bonnie32_tpu_torch import config
    return ts.ortho_settings(config)


# case -> (level, settings, depth clear, render_level keywords)
CASES = {
    "cave": ("cave", RasterSettings.game(), "inv", {}),
    "cave_inv": ("cave", RasterSettings.game(), "inv",
                 dict(depth_mode="inv")),
    "cave_ortho": ("cave", _ortho(), "harmonic", {}),
}


@pytest.fixture(scope="module")
def refs():
    return {}


@pytest.mark.parametrize("case", sorted(CASES))
def test_render_level_matches_jax(compiled, refs, case):
    level, settings, clear, kw = CASES[case]
    if case not in refs:
        refs[case] = jax_refs.jax_render_level(level, settings, clear, **kw)
    cams, jcolor = refs[case]
    ours = sc.port_render_level(compiled[level][1], cams, settings, clear,
                                **kw)
    assert sc.lit_share(jcolor) > 0.5
    diff = int((ours != jcolor).sum())
    assert diff <= sc.seam_budget(jcolor), diff
