"""The port's per-room scene compile and sequential renderer
(models/scene.compile_level, render_level) against the JAX package's, on
the CPU, on the two-room level (tests/torch_scenes.py: the Cave-size room
and a fogged room with its own ambient), with the options of
SceneRenderOptions the world editor sets: `skip_rooms` and
`use_fog=False`.

Tolerances: the compiled tables are exact (the same host numpy); frames
within the seam budget max(64 N, pixels / 500), at 48x64, where the
fogged room stays inside it (PERF.md, "the fogged room's seam").
"""

import numpy as np
import pytest
import torch

import jax_refs
import torch_seq_cases as sc
from bonnie32_tpu_torch.config import RasterSettings

torch.set_num_threads(1)
LEVELS = ("two_room",)


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


def test_compiled_scene_statics(compiled):
    _, two = compiled["two_room"]
    assert two.a_count == 0
    assert int(two.fog.enabled.sum()) == 1
    assert tuple(two.faces.valid.sum(1).tolist()) == (328, 96)


# case -> (level, settings, depth clear, render_level keywords)
CASES = {
    "two_room": ("two_room", RasterSettings.game(), "inv", {}),
    "two_room_skip_rooms": ("two_room", RasterSettings.game(), "inv",
                            dict(skip_rooms=(1,))),
    "two_room_no_fog": ("two_room", RasterSettings.game(), "inv",
                        dict(use_fog=False)),
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
    # two of the three cameras stand in room 1: skipping it leaves
    # their frames empty
    assert sc.lit_share(jcolor) > (0.25 if kw.get("skip_rooms") else 0.5)
    diff = int((ours != jcolor).sum())
    assert diff <= sc.seam_budget(jcolor), diff
    if case == "two_room_skip_rooms":
        full = sc.port_render_level(compiled[level][1], cams, settings,
                                    clear)
        assert (ours != full).any()
