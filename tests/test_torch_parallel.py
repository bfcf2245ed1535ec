"""The port's instance-sharded step (bonnie32_tpu_torch/parallel/) on the
CPU, a mesh naming the CPU four times:

  * 4 shards of N=8 (and of N=10, which 4 does not divide: shards of 3,
    3, 2, 2) at 24x32 over 3 chained frames equal the unsharded step bit
    for bit, frames and every state field, on the kernel route (its
    plain twins here) and on the sequential route: each shard loops to
    its own longest instance, and no instance's result may depend on it;
  * `replicate` copies every tensor of a RolloutEnv — the nested
    FlatScene, SkyTables and CompiledScene included — to each device
    (the `meta` device stands in for a second one) and shares the host
    statics; `shard_instances` / `gather_instances` round-trip;
  * `instance_mesh()` raises without a card;
  * `python -m bonnie32_tpu_torch.parallel.dryrun 4 --device cpu
    --level ... --packs ...` (through `entry.dryrun_multichip`) on the
    Cave-size level and a PNG pack of its textures written to tmp_path,
    and the same module without a card and without `--device` exits
    non-zero.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_scenes as ts
from bonnie32_tpu_torch import entry, rollout
from bonnie32_tpu_torch.config import RasterSettings
from bonnie32_tpu_torch.game import state as tst
from bonnie32_tpu_torch.game import step as stp
from bonnie32_tpu_torch.models import level as TL
from bonnie32_tpu_torch.models import skybox as TS
from bonnie32_tpu_torch.parallel import mesh as pmesh
from bonnie32_tpu_torch.tree import leaves_with_paths

torch.set_num_threads(1)
H, W, FRAMES = 24, 32, 3
MESH = pmesh.instance_mesh(["cpu"] * 4)


@pytest.fixture(scope="module")
def cave():
    level = ts.cave_size_level(TL)
    return level, rollout.build_env(level, ts.textures(), ts.resolver,
                                    device="cpu")


def _bits(t):
    return t.view(torch.int32) if t.dtype.is_floating_point else t


@pytest.mark.parametrize("n", [8, 10])
@pytest.mark.parametrize("route", ["kernel", "sequential"])
def test_sharded_step_equals_unsharded(cave, route, n):
    level, env = cave
    if route == "sequential":
        env = env._replace(flat=None, flat_static=None)
    settings = RasterSettings.game()
    assert rollout.kernel_route(env, settings) == (route == "kernel")
    states = rollout.initial_states(level, ts.spawn_point(level), n,
                                    device="cpu")
    step = pmesh.sharded_step_and_render(MESH, env, settings, H, W)
    shards = pmesh.shard_instances(states, MESH)
    assert [s.pos.shape[0] for s in shards] == \
        [len(c) for c in np.array_split(np.arange(n), 4)]
    rng = np.random.default_rng(9)
    for frame in range(FRAMES):
        acts = stp.Actions(**{k: torch.from_numpy(v) for k, v in
                              ts.actions_np(rng, n).items()})
        states, fb = rollout.step_and_render(states, env, acts, settings,
                                             height=H, width=W,
                                             instance_chunk=None)
        shards, fbs = step(shards, pmesh.shard_instances(acts, MESH))
        got = pmesh.gather_instances(fbs, "cpu")
        assert ((fb.color >> 24) & 255).eq(255).float().mean() > 0.25
        assert torch.equal(got.color, fb.color), frame
        assert torch.equal(_bits(got.depth), _bits(fb.depth)), frame
        out = pmesh.gather_instances(shards, "cpu")
        for f in tst.GameState._fields:
            assert torch.equal(_bits(getattr(out, f)),
                               _bits(getattr(states, f))), (frame, f)


def test_shard_and_gather_round_trip():
    rng = np.random.default_rng(2)
    tree = {"x": torch.from_numpy(rng.standard_normal((7, 3))),
            "y": (torch.arange(7), None, 5)}
    shards = pmesh.shard_instances(tree, MESH)
    assert [s["x"].shape[0] for s in shards] == [2, 2, 2, 1]
    assert all(s["y"][2] == 5 and s["y"][1] is None for s in shards)
    # each shard owns its storage: writing one leaves the source alone
    shards[0]["x"].zero_()
    assert tree["x"][0].abs().sum() > 0
    back = pmesh.gather_instances(pmesh.shard_instances(tree, MESH), "cpu")
    assert torch.equal(back["x"], tree["x"])
    assert torch.equal(back["y"][0], tree["y"][0])


def _all_tensors(obj, seen=None):
    """Every tensor reachable from `obj` through NamedTuples, tuples,
    lists, dicts and dataclass fields."""
    seen = set() if seen is None else seen
    if id(obj) in seen:
        return []
    seen.add(id(obj))
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        kids = list(obj.values())
    elif isinstance(obj, (tuple, list)):
        kids = list(obj)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        kids = [getattr(obj, f.name) for f in dataclasses.fields(obj)]
    else:
        return []
    return [t for k in kids for t in _all_tensors(k, seen)]


def test_replicate_moves_every_tensor_of_the_env():
    """The open-air level under the night sky (FlatScene, SkyTables with
    its host Skybox, CompiledScene) replicated over [cpu, meta, cpu]."""
    level = ts.open_air_level(TL, TS, "night")
    env = rollout.build_env(level, ts.textures(), ts.resolver, device="cpu")
    assert env.sky is not None and env.scene is not None
    mesh = pmesh.instance_mesh(["cpu", "meta", "cpu"])
    reps = pmesh.replicate(env, mesh)
    src = _all_tensors(env)
    assert len(src) > 80 and len(_all_tensors(reps[1])) == len(src)
    assert all(t.device.type == "meta" for t in _all_tensors(reps[1]))
    assert reps[0] is reps[2]
    assert all(t.device.type == "cpu" for t in _all_tensors(reps[0]))
    # host statics are shared, not copied
    assert reps[1].flat_static is env.flat_static
    assert reps[1].sky.skybox is env.sky.skybox
    assert reps[1].scene.a_count == env.scene.a_count
    assert reps[1].grid.n_gx == env.grid.n_gx
    assert [p for p, _ in leaves_with_paths(reps[1])] == \
        [p for p, _ in leaves_with_paths(env)]


def test_instance_mesh_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        pmesh.instance_mesh()
    assert MESH == [torch.device("cpu")] * 4


def test_dryrun_module_on_the_cpu(tmp_path, monkeypatch, capsys):
    level_path, packs = ts.write_demo_files(TL, str(tmp_path / "demo"))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    entry.dryrun_multichip(4, device="cpu", level_path=level_path,
                           packs=packs)
    out = capsys.readouterr().out
    assert out.count("dryrun_multichip OK") == 3, out
    assert "kernel route" in out and "sequential route" in out
    assert "320x240 N=64 over 4 shards" in out


def test_dryrun_module_refuses_without_a_card(tmp_path):
    """No card visible and no --device: the module exits non-zero before
    it reads a file (none exists at the given paths)."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "bonnie32_tpu_torch.parallel.dryrun", "2",
         "--level", str(tmp_path / "none.ron"), "--packs", str(tmp_path)],
        cwd=str(entry.REPO), env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode != 0
    assert "no CUDA card" in proc.stderr
