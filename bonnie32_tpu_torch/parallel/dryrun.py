"""Multi-device dry run: shard the FULL fused step over an n-device
instance mesh and hold it against the unsharded run
(bonnie32_tpu/parallel/dryrun.py).

    python -m bonnie32_tpu_torch.parallel.dryrun N [--device cpu]
        [--level PATH] [--packs DIR]

The mesh has N entries: the visible cards in turn (one card named N times
on a one-card machine), or `--device` N times.  Without a card and
without `--device` it exits non-zero.  The level and texture packs are
`rollout.demo_env`'s (the Cave sample level and the sample packs) unless
`--level` (a level file) and `--packs` (a directory of pack folders of
PNGs) point elsewhere.

  1. 2N instances, 24x32, one step: the sharded step (`parallel.mesh.
     sharded_step_and_render`) equals the unsharded `step_and_render`
     bit for bit, in frames (colour and depth) and in every state field,
     on the kernel route and on the sequential route;
  2. one frame at 320x240 of max(8N, 64) instances over the mesh on the
     kernel route: finite states, frames of the expected shape, gathered
     back onto the first device.
"""

import argparse
import sys

import numpy as np
import torch


def _actions(stp, n, device):
    ang = torch.arange(n, dtype=torch.float32, device=device)
    return stp.zero_actions(n, device=device)._replace(
        move_x=torch.sin(ang), move_y=torch.cos(ang))


def _assert_equal(name, got, want):
    a, b = got.cpu().numpy(), want.cpu().numpy()
    if a.dtype.kind == "f":
        a, b = a.view(np.int32), b.view(np.int32)
    bad = int((a != b).sum())
    if bad:
        raise AssertionError(f"{name}: {bad} of {a.size} words differ "
                             "between the sharded and the unsharded step")


def _mesh_of(n_devices: int, device=None):
    """N mesh entries: `device` N times, else the visible cards in turn."""
    from .mesh import instance_mesh
    if device is not None:
        return instance_mesh([device] * n_devices)
    cards = instance_mesh()
    return [cards[i % len(cards)] for i in range(n_devices)]


def main(n_devices: int, device=None, level_path=None, packs=None) -> None:
    from .. import rollout
    from ..config import RasterSettings
    from ..game import state as st
    from ..game import step as stp
    from . import mesh as pmesh

    mesh = _mesh_of(n_devices, device)
    home = mesh[0]
    level, env, spawn = rollout.demo_env(
        level_path or rollout.DEMO_LEVEL, flat=True, device=home,
        packs_root=packs or rollout.DEMO_PACKS)
    settings = RasterSettings.game()
    routes = (("kernel route", env),
              ("sequential route", env._replace(flat=None,
                                                flat_static=None)))

    n = 2 * n_devices
    states = rollout.initial_states(level, spawn, n, device=home)
    acts = _actions(stp, n, home)
    for route, e in routes:
        ref_states, ref_fbs = rollout.step_and_render(
            states, e, acts, settings, height=24, width=32,
            instance_chunk=None)
        step = pmesh.sharded_step_and_render(mesh, e, settings, 24, 32)
        sh_states, sh_fbs = step(pmesh.shard_instances(states, mesh),
                                 pmesh.shard_instances(acts, mesh))
        fbs = pmesh.gather_instances(sh_fbs, home)
        out_states = pmesh.gather_instances(sh_states, home)
        if tuple(fbs.color.shape) != (n, 24, 32):
            raise AssertionError(f"frames {tuple(fbs.color.shape)}")
        _assert_equal(f"{route} colour", fbs.color, ref_fbs.color)
        _assert_equal(f"{route} depth", fbs.depth, ref_fbs.depth)
        for f in st.GameState._fields:
            _assert_equal(f"{route} {f}", getattr(out_states, f),
                          getattr(ref_states, f))
        print(f"dryrun_multichip OK: {n} game instances (step+render, "
              f"{route}) over {n_devices} shards on "
              f"{sorted({str(d) for d in mesh})}: frames and states == "
              f"unsharded baseline", flush=True)

    n_full = max(n_devices * 8, 64)
    full_states = rollout.initial_states(level, spawn, n_full, device=home)
    step = pmesh.sharded_step_and_render(mesh, env, settings, 240, 320)
    sh_states, sh_fbs = step(
        pmesh.shard_instances(full_states, mesh),
        pmesh.shard_instances(_actions(stp, n_full, home), mesh))
    fbs = pmesh.gather_instances(sh_fbs, home)
    pos = pmesh.gather_instances(sh_states, home).pos
    if tuple(fbs.color.shape) != (n_full, 240, 320):
        raise AssertionError(f"frames {tuple(fbs.color.shape)}")
    if not bool(torch.isfinite(pos).all()):
        raise AssertionError("non-finite positions")
    lit = float(((fbs.color >> 24) & 255).eq(255).float().mean())
    print(f"dryrun_multichip OK: 320x240 N={n_full} over {n_devices} "
          f"shards ran one frame on the kernel route ({lit:.3f} of the "
          f"pixels drawn)", flush=True)


def _parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("n_devices", nargs="?", type=int, default=8)
    p.add_argument("--device", default=None,
                   help="run every shard on this device (e.g. cpu)")
    p.add_argument("--level", default=None, help="level file")
    p.add_argument("--packs", default=None,
                   help="directory of texture pack folders")
    return p.parse_args(argv)


if __name__ == "__main__":
    a = _parse(sys.argv[1:])
    main(a.n_devices, a.device, a.level, a.packs)
