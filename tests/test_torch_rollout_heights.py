"""`rollout.step_and_render` at a frame height that is not a multiple of
8, the port vs the JAX package.

The JAX package's kernel path needs height % 8 == 0 (its TPU tiling) and
sends other heights to its sequential renderer (bonnie32_tpu/rollout.py);
the port's kernels run any frame size.  Both sides start from the same
states and take the same numpy-seeded actions for one frame at N=3,
100x160 on the Cave-size level; the frames agree within the seam budget
max(64*N, pixels/500) (XLA:CPU contracts FMAs, the port does not), the
states within test_torch_rollout.py's tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_scenes as ts
from bonnie32_tpu import rollout as jrollout
from bonnie32_tpu.config import RasterSettings as JRS
from bonnie32_tpu.game import step as jstep
from bonnie32_tpu.models import level as JL
from bonnie32_tpu_torch import interop
from bonnie32_tpu_torch import rollout as trollout
from bonnie32_tpu_torch.config import RasterSettings
from bonnie32_tpu_torch.game import step as tstep
from bonnie32_tpu_torch.models import level as TL

torch.set_num_threads(1)

N, H, W = 3, 100, 160
_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731


@pytest.fixture(scope="module")
def frames():
    jlevel, tlevel = ts.cave_size_level(JL), ts.cave_size_level(TL)
    jenv = jrollout.build_env(jlevel, ts.textures(), ts.resolver, flat=True)
    tenv = trollout.build_env(tlevel, ts.textures(), ts.resolver,
                              device="cpu")
    jstates = jrollout.initial_states(jlevel, ts.spawn_point(jlevel), N)
    tstates = interop.game_state(_np(jstates))
    acts = ts.actions_np(np.random.default_rng(3), N)
    jstates, jfb = jrollout.step_and_render(
        jstates, jenv, jstep.Actions(**{k: jnp.asarray(v)
                                        for k, v in acts.items()}),
        JRS.game(), height=H, width=W, instance_chunk=None)
    tstates, tfb = trollout.step_and_render(
        tstates, tenv, tstep.Actions(**{k: torch.from_numpy(v)
                                        for k, v in acts.items()}),
        RasterSettings.game(), height=H, width=W)
    return _np(jstates), np.asarray(jfb.color), tstates, tfb


def test_frame_at_height_100_matches_jax(frames):
    _, jcolor, _, tfb = frames
    assert tfb.color.shape == (N, H, W) and jcolor.shape == (N, H, W)
    assert ((jcolor >> 24) & 255 == 255).mean() > 0.25
    diff = int((tfb.color.numpy() != jcolor).sum())
    assert diff <= max(64 * N, jcolor.size // 500), diff


def test_states_at_height_100_match_jax(frames):
    jstates, _, tstates, _ = frames
    for f in tstates._fields:
        ours, theirs = getattr(tstates, f).numpy(), getattr(jstates, f)
        if theirs.dtype.kind in "biu":
            np.testing.assert_array_equal(ours, theirs, err_msg=f)
        else:
            np.testing.assert_allclose(ours, theirs, rtol=1e-5, atol=1e-4,
                                       err_msg=f)
