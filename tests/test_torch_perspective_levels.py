"""Perspective-correct UVs of the port vs the JAX package on levels
built in code: the Cave-size level (opaque faces, keyed texels on two of
its textures) at 120x160, its transparent variant (z-buffer transparency
over every blend mode) at 48x64, and painter's mode on the transparent
two-room level at 48x64 (why that level is compared at 48x64:
test_torch_composite.py).  The references: JAX `render_level_flat(...,
interpret=True)` — its kernel for the opaque faces, its sequential
`_transparent_pass` for the transparent ones.  Tolerances: frames within
the seam budget max(64*N, pixels/500) (XLA:CPU contracts FMAs, the port
does not); depth to rtol 1e-6, or exactly the cleared plane in painter's
mode.
"""

import pytest
import torch

import torch_scenes as ts
from bonnie32_tpu.config import RasterSettings as JRS
from bonnie32_tpu.models import level as JL
from bonnie32_tpu.models import scene_flat as jsf
from bonnie32_tpu_torch import interop
from bonnie32_tpu_torch.config import RasterSettings
from bonnie32_tpu_torch.models import level as TL
from bonnie32_tpu_torch.models import scene_flat as tsf
from test_torch_composite import CLEAR, _assert_frame, _jax_render, _np
from test_torch_composite_levels import (CAVE_POSES, TWO_ROOM_POSES,
                                         _level_cams)

torch.set_num_threads(1)

# case -> (level function, textures, poses, (H, W), settings keywords)
CASES = {
    "cave_opaque": (ts.cave_size_level, ts.textures, CAVE_POSES, (120, 160),
                    {}),
    "cave_transparent": (ts.transparent_cave_level, ts.transparent_textures,
                         CAVE_POSES, (48, 64), {}),
    "two_room_painters": (ts.transparent_two_room_level,
                          ts.transparent_textures, TWO_ROOM_POSES, (48, 64),
                          dict(use_zbuffer=False)),
}


@pytest.fixture(scope="module")
def refs():
    """Every JAX reference of the module, computed once."""
    out = {}
    for name, (build, textures, poses, hw, kw) in CASES.items():
        jflat, jstatic = jsf.compile_level_flat(build(JL), textures(),
                                                ts.resolver)
        cams = _level_cams(poses)
        settings = JRS.game(affine_textures=False, **kw)
        assert jsf.kernel_path_ok(jstatic, settings)
        out[name] = (_np(cams), _jax_render(jflat, jstatic, cams, settings,
                                            *hw))
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_level_matches_jax(refs, name):
    build, textures, _, hw, kw = CASES[name]
    flat, static = tsf.compile_level_flat(build(TL), textures(), ts.resolver,
                                          device="cpu")
    settings = RasterSettings.game(affine_textures=False, **kw)
    cams, ref = refs[name]
    out = tsf.render_level_flat(flat, static, interop.camera_arrays(cams),
                                settings, *hw, background=CLEAR)
    assert ((ref[0] >> 24) & 255 == 255).mean() > 0.5
    _assert_frame(name, (out.color, out.depth), ref, settings)
