"""The game tick on two devices, side by side (jax-free: chip_smoke.py and
tests/test_torch_gpu.py import it).

Both devices start from the same `rollout.initial_states` on the same
level and take the same numpy-seeded actions (`torch_scenes.actions_np`)
through `game/step.tick` and `character_camera`, each from its own
states.  At the checkpoint frames every `GameState` field and camera
array is compared: how many values differ bit for bit, the largest
difference, and whether the field is within the CPU tick's own tolerance
against the JAX package (tests/test_torch_rollout.py): integers and
booleans exact, floats rtol 1e-5 / atol 1e-4.
"""

from typing import NamedTuple

import numpy as np
import torch

import torch_scenes as ts

CHECKPOINTS = (1, 3, 30, 300)
HELD = 3            # frames 1 .. HELD are held to the tolerance
RTOL, ATOL = 1e-5, 1e-4


class FieldDrift(NamedTuple):
    differing: int          # values not equal bit for bit
    total: int
    largest: float          # largest absolute difference (0 for equal)
    within: bool            # inside the tolerance above


def compare(a: torch.Tensor, b: torch.Tensor) -> FieldDrift:
    """One field of the two devices' states, on the CPU."""
    a, b = a.cpu(), b.cpu()
    if a.dtype.is_floating_point:
        same = (a == b) | (torch.isnan(a) & torch.isnan(b))
        gap = (a.double() - b.double()).abs()
        gap = torch.where(same, torch.zeros_like(gap), gap)
        largest = float(gap.max()) if gap.numel() else 0.0
        within = bool(torch.isclose(a, b, rtol=RTOL, atol=ATOL,
                                    equal_nan=True).all())
    else:
        same = a == b
        largest = (float((a.long() - b.long()).abs().max())
                   if a.numel() else 0.0)
        within = bool(same.all())
    return FieldDrift(int((~same).sum()), a.numel(), largest, within)


def tick_drift(level, sides, n: int, frames: int, seed: int,
               checkpoints=CHECKPOINTS):
    """Tick `n` instances of `level` for `frames` frames on each of two
    `sides`, (env, device) pairs (`rollout.build_env` of `level` on that
    device): {frame: {name: FieldDrift}} at each checkpoint, for every
    GameState field and the camera's `position` and `basis`."""
    from bonnie32_tpu_torch import rollout
    from bonnie32_tpu_torch.game import step as stp

    spawn = ts.spawn_point(level)
    sides = [[env, dev, rollout.initial_states(level, spawn, n, device=dev)]
             for env, dev in sides]
    rng = np.random.default_rng(seed)
    report = {}
    for frame in range(1, frames + 1):
        acts = ts.actions_np(rng, n)
        cams = []
        for side in sides:
            env, dev, states = side
            side[2] = stp.tick(states, env.grid, env.params, stp.Actions(
                **{k: torch.from_numpy(v).to(dev) for k, v in acts.items()}),
                1.0 / 60.0)
            cams.append(stp.character_camera(side[2], env.params))
        if frame in checkpoints:
            a, b = sides[0][2], sides[1][2]
            rows = {f: compare(getattr(a, f), getattr(b, f))
                    for f in a._fields}
            rows.update({f"camera.{f}": compare(getattr(cams[0], f),
                                                getattr(cams[1], f))
                         for f in cams[0]._fields})
            report[frame] = rows
    return report


def summary(report) -> str:
    """Per checkpoint: the fields that differ, their differing values
    and largest difference."""
    lines = []
    for frame, rows in report.items():
        moved = {k: v for k, v in rows.items() if v.differing}
        lines.append(
            f"frame {frame}: {sum(v.differing for v in rows.values())} of "
            f"{sum(v.total for v in rows.values())} values differ bit for "
            f"bit; " + (", ".join(
                f"{k} {v.differing}/{v.total} (largest {v.largest:.3g}"
                f"{'' if v.within else ', OUTSIDE the tolerance'})"
                for k, v in moved.items()) or "none"))
    return "\n".join(lines)


def held_faults(report):
    """The (frame, field) pairs of frames 1 .. HELD outside the
    tolerance."""
    return [(frame, k) for frame, rows in report.items() if frame <= HELD
            for k, v in rows.items() if not v.within]
