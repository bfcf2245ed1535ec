#!/usr/bin/env python3
"""GPU smoke run of the PyTorch + CUDA port (bonnie32_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card, nvcc and this checkout; imports nothing of jax or of
the JAX package.  In order:

  1. prints the card's name and power limit (nvidia-smi) and builds the
     CUDA kernels of bonnie32_tpu_torch/csrc/raster.cu from source into
     build/torch_kernels/ (nvcc, sm_90a), printing ptxas' register report;
  2. builds the Cave-size level of tests/torch_scenes.py in code;
  3. kernel vs plain: N=8 instances at 320x240 after one tick — the CUDA
     visibility + resolve kernels and their plain torch twins on the same
     prep must agree exactly (0 differing pixels in colour, depth, winner
     and barycentric planes), with keyed faces present;
  4. main path: rollout.step_and_render at N=1024, 320x240, for FRAMES
     frames with numpy-seeded actions, after WARMUP untimed frames; the
     launch counters reset just before and read just after; checks finite
     states, >= 25% coverage in every instance's last frame, distinct
     instances, one launch per kernel per frame, and that the last frame
     of 8 instances equals the plain path's render;
  5. times (CUDA events) the frame, its stages on a replay of the same
     frames, and each kernel beside its plain twin at the main path's
     shapes.

The last two lines of standard output are one JSON object with the
kernels' measurements, then {"ok": true, "device": {...}}.  Any failed
check raises, so the exit code is not 0 and no result line is printed.
"""

import json
import os
import subprocess
import sys
import time

N_MAIN = 1024
N_CHECK = 8
HEIGHT, WIDTH = 240, 320
FRAMES = 8
WARMUP = 2             # untimed main-path frames before the counted run
SEED = 0
PLAIN_CHUNK = 128      # instances per plain-twin call when timing at N_MAIN


def _fail(msg):
    raise RuntimeError(f"chip_smoke: {msg}")


def main():
    import torch

    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is false: no CUDA card")
    run(torch.device("cuda", 0))


def run(dev):
    """All phases on `dev`, the card (a CPU rehearsal passes the CPU with
    the CUDA entry points and events substituted)."""
    import numpy as np
    import torch

    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path[:0] = [repo, os.path.join(repo, "tests")]
    import torch_scenes as ts
    from bonnie32_tpu_torch import rollout
    from bonnie32_tpu_torch._host.models import level as L
    from bonnie32_tpu_torch.config import RasterSettings
    from bonnie32_tpu_torch.game import step as stp
    from bonnie32_tpu_torch.models import scene_flat
    from bonnie32_tpu_torch.ops import _cuda
    from bonnie32_tpu_torch.ops import raster_batch as rb

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    card = f"[{smi}]"
    print(f"card: {smi}")

    t0 = time.perf_counter()
    _cuda.build(verbose=True)
    print(f"kernel build (nvcc, sm_90a): "
          f"{time.perf_counter() - t0:.2f} s {card}")

    settings = RasterSettings.game()
    level = ts.cave_size_level(L)
    env = rollout.build_env(level, ts.textures(), ts.resolver, device=dev)
    spawn = ts.spawn_point(level)
    atlas = env.flat.atlas
    print(f"level: {env.flat_static.n_faces} faces, "
          f"{env.flat_static.n_textures} textures")

    def actions(rng, n):
        return stp.Actions(**{k: torch.from_numpy(v).to(dev)
                              for k, v in ts.actions_np(rng, n).items()})

    def prep_for(states):
        cams = stp.character_camera(states, env.params)
        surf = scene_flat.build_surfaces_flat(env.flat, cams, settings,
                                              WIDTH, HEIGHT)
        return rb.prep_instance(surf, atlas, WIDTH, HEIGHT)

    def plain(prep):
        planes = rb.visibility_ref(prep, atlas, HEIGHT, WIDTH)
        color = rb.resolve_ref(prep, atlas, *planes[1:],
                               int(settings.shading), 0)
        return planes, color

    # ---- kernel vs plain on the same prep ----
    rng = np.random.default_rng(SEED)
    states = rollout.initial_states(level, spawn, N_CHECK, device=dev)
    states = stp.tick(states, env.grid, env.params, actions(rng, N_CHECK),
                      1.0 / 60.0)
    prep = prep_for(states)
    k_planes = _cuda.raster_visibility(prep, atlas, HEIGHT, WIDTH)
    k_color = _cuda.raster_resolve(prep, atlas, *k_planes[1:],
                                   int(settings.shading), 0)
    p_planes, p_color = plain(prep)
    torch.cuda.synchronize()
    names = ("depth", "winner", "bcx", "bcy")
    diffs = {n: int((k != p).sum()) for n, k, p in
             zip(names, k_planes, p_planes)}
    diffs["color"] = int((k_color != p_color).sum())
    win = k_planes[1]
    inst = torch.arange(N_CHECK, device=dev)[:, None, None]
    keyed_px = int(((prep.ctrl[inst, win.clamp(min=0).long(), rb.K_KEY] != 0)
                    & (win >= 0)).sum())
    n_keyable = int(((prep.ctrl[..., rb.K_KEY] != 0)
                     & (torch.arange(prep.order.shape[1], device=dev)
                        < prep.count[:, None])).sum())
    err_vis = float((k_planes[0] - p_planes[0]).abs().max())
    err_res = int((k_color.long() - p_color.long()).abs().max())
    print(f"kernel vs plain, N={N_CHECK} {WIDTH}x{HEIGHT}: differing "
          f"pixels {diffs}; kept keyable faces {n_keyable}, pixels won by "
          f"keyed faces {keyed_px}")
    if any(diffs.values()):
        _fail(f"kernels disagree with their plain twins: {diffs}")
    if n_keyable == 0 or keyed_px == 0:
        _fail("no keyed face reached the kernels")

    # ---- main path: the user's entry point, counters reset just before ----
    rng = np.random.default_rng(SEED + 1)
    states = rollout.initial_states(level, spawn, N_MAIN, device=dev)
    acts = [actions(rng, N_MAIN) for _ in range(FRAMES)]
    warm = states
    for f in range(WARMUP):     # allocator and first-launch costs
        warm, _ = rollout.step_and_render(warm, env, acts[f], settings,
                                          height=HEIGHT, width=WIDTH)
    torch.cuda.synchronize()
    _cuda.raster_visibility.launches = 0
    _cuda.raster_resolve.launches = 0
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    start = states
    ev[0].record()
    for f in range(FRAMES):
        states, fbs = rollout.step_and_render(states, env, acts[f], settings,
                                              height=HEIGHT, width=WIDTH)
    ev[1].record()
    torch.cuda.synchronize()
    cover = float((((fbs.color >> 24) & 255) == 255).float()
                  .mean(dim=(1, 2)).min())
    launches = {"raster_visibility": _cuda.raster_visibility.launches,
                "raster_resolve": _cuda.raster_resolve.launches}
    main_ms = ev[0].elapsed_time(ev[1])
    print(f"main path: N={N_MAIN} {WIDTH}x{HEIGHT}, {FRAMES} frames, "
          f"launches {launches}, min coverage {cover:.3f}")
    if cover < 0.25:
        _fail(f"an instance covers only {cover:.3f} of its last frame")
    for name, count in launches.items():
        if count != FRAMES:
            _fail(f"{name} launched {count} times in {FRAMES} frames")
    for name in ("pos", "vel", "vertical_velocity", "facing",
                 "char_cam_yaw", "char_cam_pitch", "time"):
        if not bool(torch.isfinite(getattr(states, name)).all()):
            _fail(f"state {name} is not finite")
    if fbs.color.shape != (N_MAIN, HEIGHT, WIDTH):
        _fail(f"frame shape {tuple(fbs.color.shape)}")
    distinct = int((fbs.color != fbs.color[:1]).flatten(1).any(1).sum())
    if distinct < N_MAIN // 2:
        _fail(f"only {distinct} instances differ from instance 0")
    sub = type(states)(*(x[:N_CHECK] for x in states))
    _, ref_color = plain(prep_for(sub))
    ref_diff = int((ref_color != fbs.color[:N_CHECK]).sum())
    print(f"main path output vs plain render of {N_CHECK} instances: "
          f"{ref_diff} differing pixels; {distinct} of {N_MAIN} instances "
          f"differ from instance 0")
    if ref_diff:
        _fail("the main path's frame disagrees with the plain path")

    # ---- timing: frame stages, kernels and their plain twins ----
    # Each stage between synchronizes: the eager stages are launch-bound,
    # so events inside an unsynchronized frame would charge the card's
    # wait for the host to whichever stage's markers it falls between.
    evs = [torch.cuda.Event(enable_timing=True) for _ in range(2)]

    def timed(fn):
        torch.cuda.synchronize()
        evs[0].record()
        out = fn()
        evs[1].record()
        torch.cuda.synchronize()
        return out, evs[0].elapsed_time(evs[1]) / FRAMES

    stage_ms = dict(tick=0.0, surfaces_prep=0.0, visibility=0.0,
                    resolve=0.0)
    states = start          # the same frames as the timed main-path run
    for f in range(FRAMES):
        states, ms = timed(lambda s=states, a=acts[f]: stp.tick(
            s, env.grid, env.params, a, 1.0 / 60.0))
        stage_ms["tick"] += ms
        prep, ms = timed(lambda s=states: prep_for(s))
        stage_ms["surfaces_prep"] += ms
        planes, ms = timed(lambda p=prep: _cuda.raster_visibility(
            p, atlas, HEIGHT, WIDTH))
        stage_ms["visibility"] += ms
        _, ms = timed(lambda p=prep, q=planes: _cuda.raster_resolve(
            p, atlas, *q[1:], int(settings.shading), 0))
        stage_ms["resolve"] += ms

    def kernel_ms(fn, reps=10):
        fn()
        torch.cuda.synchronize()
        evs[0].record()
        for _ in range(reps):
            fn()
        evs[1].record()
        torch.cuda.synchronize()
        return evs[0].elapsed_time(evs[1]) / reps

    vis_ms = kernel_ms(lambda: _cuda.raster_visibility(prep, atlas, HEIGHT,
                                                       WIDTH))
    res_ms = kernel_ms(lambda: _cuda.raster_resolve(
        prep, atlas, *planes[1:], int(settings.shading), 0))

    def chunked_plain_ms(fn):
        total = 0.0
        for s in range(0, N_MAIN, PLAIN_CHUNK):
            part = rb.BatchPrep(*(x[s:s + PLAIN_CHUNK] for x in prep))
            args = [p[s:s + PLAIN_CHUNK] for p in planes[1:]]
            torch.cuda.synchronize()
            evs[0].record()
            fn(part, args)
            evs[1].record()
            torch.cuda.synchronize()
            total += evs[0].elapsed_time(evs[1])
        return total

    vis_plain = chunked_plain_ms(
        lambda p, _: rb.visibility_ref(p, atlas, HEIGHT, WIDTH))
    res_plain = chunked_plain_ms(
        lambda p, a: rb.resolve_ref(p, atlas, *a, int(settings.shading), 0))

    ms_frame = main_ms / FRAMES
    print(f"frame: {ms_frame:.3f} ms per batched frame of {N_MAIN} "
          f"instances = {N_MAIN * 1000.0 / ms_frame:.1f} instance-frames/s "
          f"(step_and_render, CUDA events over {FRAMES} frames) {card}")
    print("stages (ms per frame, CUDA events, synchronized per stage): "
          + ", ".join(f"{k} {v:.3f}" for k, v in stage_ms.items())
          + f", sum {sum(stage_ms.values()):.3f} {card}")
    print(f"raster_visibility: kernel {vis_ms:.3f} ms, plain {vis_plain:.3f}"
          f" ms (N={N_MAIN}, plain in chunks of {PLAIN_CHUNK}) {card}")
    print(f"raster_resolve: kernel {res_ms:.3f} ms, plain {res_plain:.3f} ms"
          f" (N={N_MAIN}, plain in chunks of {PLAIN_CHUNK}) {card}")

    src = "bonnie32_tpu_torch/csrc/raster.cu"
    print(json.dumps({"kernels": [
        {"name": "raster_visibility", "route": "cuda", "source": src,
         "replaces": "bonnie32_tpu/ops/raster_batch.py:859",
         "launches": launches["raster_visibility"], "max_abs_err": err_vis,
         "ms": vis_ms, "plain_ms": vis_plain},
        {"name": "raster_resolve", "route": "cuda", "source": src,
         "replaces": "bonnie32_tpu/ops/raster_batch.py:1098",
         "launches": launches["raster_resolve"], "max_abs_err": err_res,
         "ms": res_ms, "plain_ms": res_plain}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
