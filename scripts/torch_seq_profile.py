#!/usr/bin/env python3
"""Where the sequential renderer's frame goes on the card.

    python3 scripts/torch_seq_profile.py [--n 1 128] [--frames 3]

On the Cave-size level of tests/torch_scenes.py at 320x240, game
settings, for each batch size N: one step_and_render on the sequential
route (the env without its flat scene) as warm-up, then

  * its stages, each between synchronizes, CUDA events, mean of
    `--frames` frames: the tick and character camera, the surfaces
    (ops/surface.build_surfaces), the fast rasterizer
    (ops/raster_fast.rasterize_surfaces_fast: passes 1a, 1b, resolve and
    the transparent pass); and the faces each pass walks: valid,
    keyable (pass 1b, the longest instance's count), transparent;
  * one unsynchronized frame under torch.profiler (CPU and CUDA
    activities): the CUDA kernels launched, the device's busy time (the
    kernels' summed self time), the frame's wall time and the idle
    share (1 - busy / wall), and the kernels that took the most device
    time.

Needs a CUDA card; prints the card's name and power limit beside every
number and exits non-zero without one.
"""

import argparse
import os
import subprocess
import sys
import time


def main():
    import numpy as np
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, nargs="+", default=[1, 128])
    ap.add_argument("--frames", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_seq_profile: needs a CUDA card")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path[:0] = [repo, os.path.join(repo, "tests")]
    import torch_scenes as ts
    from bonnie32_tpu_torch import rollout
    from bonnie32_tpu_torch.config import RasterSettings
    from bonnie32_tpu_torch.game import step as stp
    from bonnie32_tpu_torch.models import level as L
    from bonnie32_tpu_torch.models.scene import _index
    from bonnie32_tpu_torch.ops import raster_fast, raster_ref
    from bonnie32_tpu_torch.ops.surface import build_surfaces

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    card = f"[{smi}]"
    dev = torch.device("cuda", 0)
    height, width = 240, 320
    game = RasterSettings.game()
    level = ts.cave_size_level(L)
    env = rollout.build_env(level, ts.textures(), ts.resolver, flat=False,
                            device=dev)
    sc = env.scene
    room = [_index(t, 0) for t in (sc.mesh, sc.faces, sc.atlas, sc.fog)]
    lights = sc.lights._replace(ambient=sc.ambient[0])
    evs = [torch.cuda.Event(enable_timing=True) for _ in range(2)]

    def timed(fn):
        torch.cuda.synchronize()
        evs[0].record()
        out = fn()
        evs[1].record()
        torch.cuda.synchronize()
        return out, evs[0].elapsed_time(evs[1])

    for n in args.n:
        rng = np.random.default_rng(0)
        acts = [stp.Actions(**{k: torch.from_numpy(v).to(dev) for k, v in
                               ts.actions_np(rng, n).items()})
                for _ in range(args.frames + 2)]
        states = rollout.initial_states(level, ts.spawn_point(level), n,
                                        device=dev)
        states, _ = rollout.step_and_render(states, env, acts[0], game,
                                            height=height, width=width)
        stage = dict(tick=0.0, surfaces=0.0, raster=0.0)
        for f in range(1, args.frames + 1):
            def tick(s=states, a=acts[f]):
                s = stp.tick(s, env.grid, env.params, a, 1.0 / 60.0)
                return s, stp.character_camera(s, env.params)
            (states, cams), ms = timed(tick)
            stage["tick"] += ms / args.frames
            surf, ms = timed(lambda c=cams: build_surfaces(
                *room[:3], c, lights, room[3], game, width, height))
            stage["surfaces"] += ms / args.frames
            fb = raster_ref.new_framebuffer(height, width, "inv", n=n,
                                            device=dev)
            _, ms = timed(lambda b=fb, s=surf: raster_fast.
                          rasterize_surfaces_fast(b, s, room[2], game))
            stage["raster"] += ms / args.frames
        valid = surf.valid
        keyable = (valid & ~surf.has_transparency & (surf.tex_id >= 0)
                   & surf.black_transparent
                   & room[2].has_black[surf.tex_id.clamp(min=0).long()]
                   & surf.key_possible)
        faces = dict(valid=int(valid.sum(1).max()),
                     keyable=int(keyable.sum(1).max()),
                     transparent=int((valid & surf.has_transparency)
                                     .sum(1).max()))
        print(f"N={n}: stages (ms per frame, synchronized per stage) "
              + ", ".join(f"{k} {v:.3f}" for k, v in stage.items())
              + f"; faces of the longest instance {faces} {card}",
              flush=True)

        acts_p = acts[args.frames + 1]
        torch.cuda.synchronize()
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            rollout.step_and_render(states, env, acts_p, game,
                                    height=height, width=width)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        kern = [e for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        dur = [e.time_range.elapsed_us() / 1e3 for e in kern]
        busy = sum(dur)
        by_name = {}
        for e, d in zip(kern, dur):
            by_name[e.name] = by_name.get(e.name, 0.0) + d
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        print(f"N={n}: one frame under torch.profiler: {len(kern)} CUDA "
              f"kernels, device busy {busy:.3f} ms of {wall:.3f} ms wall, "
              f"idle share {1.0 - busy / wall:.3f}; most device time: "
              + "; ".join(f"{k[:60]} {v:.3f} ms" for k, v in top)
              + f" {card}", flush=True)


if __name__ == "__main__":
    main()
