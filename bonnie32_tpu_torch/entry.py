"""Entry points of the port: the datagen frame and the multi-card dry run
(the counterparts of the repository's `__graft_entry__.py`).

    from bonnie32_tpu_torch import entry
    fn, args = entry.entry()              # the demo level, on the card
    frames = fn(*args)
    entry.dryrun_multichip(4)             # a subprocess, raises on failure

`entry` returns the fused datagen step (game tick, collision, character
camera, the level's render on the kernel route) and example arguments for
a small batch.  `dryrun_multichip` runs `parallel/dryrun.py`, which holds
the instance-sharded step against the unsharded one.
"""

import os
import subprocess
import sys

import torch

from . import rollout
from .config import HEIGHT, WIDTH, RasterSettings
from .game import step as stp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def entry(level=None, n: int = 4, device=None, textures=None, resolve=None,
          height: int = HEIGHT, width: int = WIDTH):
    """(fn, example_args): `fn(states, env, acts)` runs one
    `rollout.step_and_render` under `RasterSettings.game()` at
    `height` x `width` and returns the frames (FrameBuffers (n, H, W)).

    With `level=None` the env is `rollout.demo_env(flat=True)`; a level
    built in code comes with its `textures` and `resolve` (as
    `rollout.build_env` takes them).  The env is compiled for the kernel
    route on `device` (default: the card); the example states are `n`
    spawned players walking forward-left at half speed."""
    if level is None:
        level, env, spawn = rollout.demo_env(flat=True, device=device)
    else:
        if textures is None or resolve is None:
            raise ValueError("a level needs its textures and resolver")
        env = rollout.build_env(level, textures, resolve, flat=True,
                                device=device)
        spawn = rollout.spawn_point(level)
    dev = env.grid.room_pos.device
    states = rollout.initial_states(level, spawn, n, device=dev)
    acts = stp.zero_actions(n, device=dev)._replace(
        move_x=torch.full((n,), 0.5, device=dev),
        move_y=torch.full((n,), 0.5, device=dev))
    settings = RasterSettings.game()

    def fn(states, env, acts):
        _, fbs = rollout.step_and_render(states, env, acts, settings,
                                         height=height, width=width)
        return fbs

    return fn, (states, env, acts)


def dryrun_multichip(n_devices: int, device=None, level_path=None,
                     packs=None) -> None:
    """Run `python -m bonnie32_tpu_torch.parallel.dryrun n_devices` in a
    subprocess from the repository's root (its options: `--device`,
    `--level`, `--packs`), echo its output and raise RuntimeError when it
    exits non-zero."""
    cmd = [sys.executable, "-m", "bonnie32_tpu_torch.parallel.dryrun",
           str(n_devices)]
    for flag, value in (("--device", device), ("--level", level_path),
                        ("--packs", packs)):
        if value is not None:
            cmd += [flag, str(value)]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, env.get("PYTHONPATH", "")) if p)
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=1200)
    sys.stdout.write(proc.stdout)
    sys.stderr.write(proc.stderr[-4000:])
    if proc.returncode != 0:
        raise RuntimeError(
            f"dryrun_multichip subprocess failed rc={proc.returncode}")


if __name__ == "__main__":
    fn, args = entry()
    print("entry OK:", tuple(fn(*args).color.shape))
    dryrun_multichip(max(torch.cuda.device_count(), 1))
