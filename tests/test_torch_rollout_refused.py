"""Two configurations the port's kernels cannot draw, routed by
rollout.render_cameras to the sequential renderer, on the CPU, against
the JAX package's sequential renderer: the editor's default settings
(backface wires) on the asset level's five draw groups through
step_and_render (the JAX flat=False env), and ortho projection on the
Cave-size level.  The port's render of the JAX cameras within the seam
budget max(64 N, pixels / 500); its free-running frame within 1%.

Under ortho, the sequential route clears the depth plane to inverse z
(0) and draws in harmonic mode (the JAX package's `render_one`), so only
faces with z < 0, behind the camera, pass the z-test: the character
camera outside the room draws nothing, so the ortho frames are taken
from cameras inside the room, as the JAX package's render_one draws
them (render_level in "fast" mode on an inverse-z plane);
tests/test_torch_scene_seq.py holds ortho over a harmonic plane.
"""

import pytest
import torch

import jax_refs
import torch_scenes as ts
import torch_seq_cases as sc
from bonnie32_tpu_torch import config
from bonnie32_tpu_torch import interop
from bonnie32_tpu_torch import rollout as trollout
from bonnie32_tpu_torch.config import RasterSettings

torch.set_num_threads(1)

ORTHO = ts.ortho_settings(config)


def test_ortho_route_matches_jax_render_one():
    level, tex, kw, _ = sc.level_args("cave")
    env = trollout.build_env(level, tex, ts.resolver, device="cpu", **kw)
    assert not trollout.kernel_route(env, ORTHO)
    cams, jcolor = jax_refs.jax_render_level("cave", ORTHO, clear="inv")
    ours = trollout.render_cameras(env, interop.camera_arrays(cams), ORTHO,
                                   sc.H, sc.W).color.numpy()
    assert sc.lit_share(jcolor) > 0.05
    diff = int((ours != jcolor).sum())
    assert diff <= sc.seam_budget(jcolor), diff


CASES = {"editor_asset_level": ("asset", RasterSettings())}


@pytest.mark.parametrize("case", sorted(CASES))
def test_refused_route_matches_jax_sequential(case):
    name, settings = CASES[case]
    r = jax_refs.rollout_pair(name, settings)
    env = r["tenv"]
    assert env.flat is not None and not trollout.kernel_route(env, settings)
    ours = trollout.render_cameras(env, interop.camera_arrays(r["jcams"]),
                                   settings, sc.H, sc.W).color.numpy()
    jcolor = r["jcolor"]
    assert sc.lit_share(jcolor) > 0.05
    diff = int((ours != jcolor).sum())
    assert diff <= sc.seam_budget(jcolor), diff
    assert int((r["tcolor"] != jcolor).sum()) <= jcolor.size // 100
    assert env.flat_static.n_draw_groups == 5
    assert ((jcolor & 0xFFFFFF) == (80 | 80 << 8 | 100 << 16)).any()
