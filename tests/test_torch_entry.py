"""The port's entry points on the CPU against the JAX package's:

  * `game/step.zero_actions` against the JAX `zero_actions` (0-dim) and
    broadcast to (n,): fields, shapes, dtypes, values;
  * `rollout.demo_env` over a level written by `models/level.save_level`
    and a two-texture PNG pack (FLOOR, WALL; the level's other texture
    names fall back to texture 0), both in tmp_path: the same textures,
    spawn, collision tables and player parameters as the JAX package's
    `build_env` + spawn rule on the same files, and one frame at 24x32
    on both sides from the same states (the sequential route, the JAX
    default flat=False) — the port rendering the JAX cameras within the
    seam budget below (25 of 3,072 pixels differ), and the kernel route
    of demo_env(flat=True) equal to it on every pixel; absent files raise
    FileNotFoundError;
  * `entry.entry(level=..., device="cpu")` on the Cave-size level: its
    frames against the JAX kernel path (Pallas interpret mode) at 24x32,
    N=4, within tests/test_raster_batch.py's `_seam_budget`
    (max(64 N, pixels / 500), for XLA:CPU's FMA contraction).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_scenes as ts
from bonnie32_tpu import rollout as jrollout
from bonnie32_tpu.config import RasterSettings as JRasterSettings
from bonnie32_tpu.game import step as jstep
from bonnie32_tpu.models import level as JL
from bonnie32_tpu.models import texture_pack as jtp
from bonnie32_tpu_torch import entry, interop, rollout
from bonnie32_tpu_torch.config import RasterSettings
from bonnie32_tpu_torch.game import step as tstep
from bonnie32_tpu_torch.models import level as TL
from bonnie32_tpu_torch.models import texture_pack as ttp

torch.set_num_threads(1)
H, W, N = 24, 32, 4
_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731


def _seam_budget(npixels, n_inst):
    """tests/test_raster_batch.py's budget on the CPU."""
    return max(64 * n_inst, npixels // 500)


@pytest.mark.parametrize("n", [None, 5])
def test_zero_actions_match_jax(n):
    ours = tstep.zero_actions(n, device="cpu")
    theirs = jstep.zero_actions()
    assert ours._fields == theirs._fields
    for f in ours._fields:
        a = getattr(ours, f).numpy()
        b = np.asarray(getattr(theirs, f))
        want = b if n is None else np.broadcast_to(b, (n,))
        assert a.dtype == want.dtype and a.shape == want.shape, f
        np.testing.assert_array_equal(a, want, err_msg=f)


def test_zero_actions_run_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tstep.zero_actions(3)


@pytest.fixture(scope="module")
def demo(tmp_path_factory):
    """The demo files (the Cave-size level, a pack of FLOOR and WALL),
    the port's demo_env and the JAX package's env on the same files."""
    root = str(tmp_path_factory.mktemp("demo"))
    level_path, packs = ts.write_demo_files(TL, root, names=("FLOOR", "WALL"))
    level, env, spawn = rollout.demo_env(level_path, device="cpu",
                                         packs_root=packs)
    jlevel = JL.load_level(level_path)
    jtex = jtp.load_texture_packs(packs)
    jenv = jrollout.build_env(jlevel, jtex, jtp.make_resolver(jtex))
    return dict(level_path=level_path, packs=packs, level=level, env=env,
                spawn=spawn, jlevel=jlevel, jtex=jtex, jenv=jenv,
                jspawn=ts.spawn_point(jlevel))


def test_demo_env_reads_what_jax_reads(demo):
    tex = ttp.load_texture_packs(demo["packs"])
    assert [t.name for t in tex] == [t.name for t in demo["jtex"]] == \
        ["FLOOR", "WALL"]
    for a, b in zip(tex, demo["jtex"]):
        np.testing.assert_array_equal(a.pixels15, b.pixels15)
        np.testing.assert_array_equal(a.rgba8, b.rgba8)
    # the PNG keeps the checker words and turns drawable black to 0x0000
    want = ts.textures()[0][0].copy()
    want[want == 0x8000] = 0
    np.testing.assert_array_equal(tex[0].pixels15, want)
    resolve, jresolve = ttp.make_resolver(tex), jtp.make_resolver(demo["jtex"])
    for ref in (TL.TextureRef("torch-scenes", n) for n in ts.TEXTURE_NAMES):
        assert resolve(ref) == jresolve(JL.TextureRef(ref.pack, ref.name))
    assert demo["spawn"] == demo["jspawn"] is not None
    env, jenv = demo["env"], demo["jenv"]
    assert env.flat is None and env.scene is not None
    for f in env.params._fields:
        np.testing.assert_array_equal(getattr(env.params, f).numpy(),
                                      np.asarray(getattr(jenv.params, f)))
    grid = interop.collision_grid(_np(jenv.grid))
    for f in env.grid._fields:
        a, b = getattr(env.grid, f), getattr(grid, f)
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                else a == b), f
    np.testing.assert_array_equal(env.scene.atlas.data.numpy(),
                                  np.asarray(jenv.scene.atlas.data))


def test_demo_env_frame_matches_jax(demo):
    """One step from the same states and actions at 24x32: the port's
    frame of the JAX cameras within the seam budget of the JAX frame; its
    own frame and states within tests/test_torch_rollout.py's
    tolerances."""
    level, env, jenv = demo["level"], demo["env"], demo["jenv"]
    jstates = jrollout.initial_states(demo["jlevel"], demo["jspawn"], N)
    tstates = rollout.initial_states(level, demo["spawn"], N, device="cpu")
    for f in tstates._fields:
        np.testing.assert_array_equal(getattr(tstates, f).numpy(),
                                      np.asarray(getattr(jstates, f)))
    acts = ts.actions_np(np.random.default_rng(12), N)
    game = RasterSettings.game()
    jstates, jfb = jrollout.step_and_render(
        jstates, jenv, jstep.Actions(**{k: jnp.asarray(v)
                                        for k, v in acts.items()}),
        JRasterSettings.game(), height=H, width=W)
    jcams = jax.vmap(lambda s: jstep.character_camera(s, jenv.params))(
        jstates)
    tstates, tfb = rollout.step_and_render(
        tstates, env, tstep.Actions(**{k: torch.from_numpy(v)
                                       for k, v in acts.items()}),
        game, height=H, width=W)
    jcolor = np.asarray(jfb.color)
    assert ((jcolor >> 24) & 255 == 255).mean() > 0.25
    ours = rollout.render_cameras(env, interop.camera_arrays(_np(jcams)),
                                  game, H, W).color.numpy()
    diff = int((ours != jcolor).sum())
    budget = _seam_budget(jcolor.size, N)
    print(f"demo_env frame: {diff} of {jcolor.size} pixels differ from JAX "
          f"(budget {budget})")
    assert diff <= budget
    assert int((tfb.color.numpy() != jcolor).sum()) <= jcolor.size // 100
    np.testing.assert_allclose(tstates.pos.numpy(), np.asarray(jstates.pos),
                               rtol=1e-5, atol=1e-4)
    # the kernel route of demo_env(flat=True) draws the same frame
    _, fenv, _ = rollout.demo_env(demo["level_path"], flat=True,
                                  device="cpu", packs_root=demo["packs"])
    assert rollout.kernel_route(fenv, game)
    flat = rollout.render_cameras(fenv, interop.camera_arrays(_np(jcams)),
                                  game, H, W).color.numpy()
    np.testing.assert_array_equal(flat, ours)


def test_demo_env_raises_on_absent_files(tmp_path, demo):
    with pytest.raises(FileNotFoundError):
        rollout.demo_env(str(tmp_path / "missing.ron"), device="cpu",
                         packs_root=demo["packs"])
    with pytest.raises(FileNotFoundError):
        rollout.demo_env(demo["level_path"], device="cpu",
                         packs_root=str(tmp_path / "no-packs"))
    with pytest.raises(FileNotFoundError):
        entry.entry(device="cpu")     # the reference's files are absent


def test_entry_frames_match_the_jax_kernel_path():
    level, jlevel = ts.cave_size_level(TL), ts.cave_size_level(JL)
    fn, (states, env, acts) = entry.entry(
        level, n=N, device="cpu", textures=ts.textures(),
        resolve=ts.resolver, height=H, width=W)
    assert rollout.kernel_route(env, RasterSettings.game())
    assert states.pos.shape[0] == N
    assert acts.move_x.tolist() == acts.move_y.tolist() == [0.5] * N
    assert not acts.sprint.any() and not acts.jump.any()
    fbs = fn(states, env, acts)
    assert tuple(fbs.color.shape) == (N, H, W)

    jenv = jrollout.build_env(jlevel, ts.textures(), ts.resolver, flat=True)
    jstates = jrollout.initial_states(jlevel, ts.spawn_point(jlevel), N)
    for f in states._fields:
        np.testing.assert_array_equal(getattr(states, f).numpy(),
                                      np.asarray(getattr(jstates, f)))
    jacts = jstep.Actions(
        move_x=jnp.full(N, 0.5, jnp.float32),
        move_y=jnp.full(N, 0.5, jnp.float32),
        cam_x=jnp.zeros(N, jnp.float32), cam_y=jnp.zeros(N, jnp.float32),
        sprint=jnp.zeros(N, bool), jump=jnp.zeros(N, bool))
    _, jfbs = jrollout.step_and_render(jstates, jenv, jacts,
                                       JRasterSettings.game(), height=H,
                                       width=W)
    jcolor = np.asarray(jfbs.color)
    assert ((jcolor >> 24) & 255 == 255).mean() > 0.25
    diff = int((fbs.color.numpy() != jcolor).sum())
    budget = _seam_budget(jcolor.size, N)
    print(f"entry: {diff} of {jcolor.size} pixels differ (budget {budget})")
    assert diff <= budget


def test_entry_needs_textures_for_a_level(monkeypatch):
    level = ts.cave_size_level(TL)
    with pytest.raises(ValueError, match="textures and resolver"):
        entry.entry(level, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        entry.entry(level, textures=ts.textures(), resolve=ts.resolver)
