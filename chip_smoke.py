#!/usr/bin/env python3
"""GPU smoke run of the PyTorch + CUDA port (bonnie32_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card, nvcc and this checkout; imports nothing of jax or of
the JAX package.  In order:

  1. prints the card's name and power limit (nvidia-smi) and builds the
     CUDA kernels of bonnie32_tpu_torch/csrc/raster.cu from source into
     build/torch_kernels/ (nvcc, sm_90a), printing ptxas' register report;
  2. builds the Cave-size level of tests/torch_scenes.py in code, and its
     transparent variant (20 faces glazed with every PS1 blend mode);
  3. kernel vs plain: N=8 instances at 320x240 after one tick — on the
     opaque level the visibility + resolve kernels, on the transparent
     level the composite kernel in z-buffer and x-ray mode and the
     painter's visibility, each against its plain torch twin on the same
     inputs: 0 differing pixels in colour, depth, winner and barycentric
     planes; keyed faces present; every non-opaque blend mode draws;
  4. main paths: rollout.step_and_render at N=1024, 320x240, with
     numpy-seeded actions — the opaque level (WARMUP + FRAMES frames),
     the transparent level (the same), then x-ray and painter's mode on
     the transparent level (1 + MODE_FRAMES frames each); the launch
     counters reset just before each counted run and read just after.
     Checks one launch per frame of each kernel the path routes through
     (x-ray: the composite only), finite states, >= 25% coverage in every
     instance's last frame, distinct instances, and that the last frame
     of 8 instances equals the plain render;
  5. times (CUDA events) the frames, the stages of the opaque and the
     transparent frame on a replay of the same frames, and each kernel
     beside its plain twin at the main path's shapes, with the bound
     (the least time the card could take: bytes over 3.35 TB/s or f32
     operations over 67 TFLOP/s, whichever is larger).

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
MODE_FRAMES = 3        # counted x-ray and painter's frames
SEED = 0
PLAIN_CHUNK = 128      # instances per plain-twin call when timing at N_MAIN

# The card's peaks (NVIDIA H100 SXM data sheet, at its 700 W limit)
HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12
# f32 operations per pixel, counted from the kernels' expressions: the
# edge functions, barycentrics, coverage compares and interpolated 1/z of
# one face at one pixel of its clipped bbox; the pixel pipeline of one
# drawn pixel (UV, fetch, 3-channel modulate, shade, dither/quantize).
# The bound counts the coverage test on every bbox pixel of every live
# face and the pipeline once per pixel the kernel wrote: the least work
# this run's data needs (keyed UVs and overdraw not counted).
OPS_COVER = 20
OPS_PIPELINE = 80

SRC = "bonnie32_tpu_torch/csrc/raster.cu"
JAX_RB = "bonnie32_tpu/ops/raster_batch.py"
BLEND_NAMES = ("OPAQUE", "AVERAGE", "ADD", "SUBTRACT", "ADD_QUARTER",
               "ERASE")


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
    import dataclasses

    import numpy as np
    import torch

    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path[:0] = [repo, os.path.join(repo, "tests")]
    import torch_scenes as ts
    from bonnie32_tpu_torch import rollout
    from bonnie32_tpu_torch.config import RasterSettings
    from bonnie32_tpu_torch.game import step as stp
    from bonnie32_tpu_torch.models import level as L
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

    game = RasterSettings.game()
    xray = dataclasses.replace(game, xray_mode=True)
    painters = dataclasses.replace(game, use_zbuffer=False)
    level = ts.cave_size_level(L)
    env = rollout.build_env(level, ts.textures(), ts.resolver, device=dev)
    tlevel = ts.transparent_cave_level(L)
    tenv = rollout.build_env(tlevel, ts.transparent_textures(), ts.resolver,
                             device=dev)
    spawn = ts.spawn_point(level)
    print(f"level: {env.flat_static.n_faces} faces, "
          f"{env.flat_static.n_textures} textures; transparent variant: "
          f"{len(tenv.flat_static.transparent_idx)} transparent faces, "
          f"{tenv.flat_static.n_textures} textures")
    kernels = (_cuda.raster_visibility, _cuda.raster_resolve,
               _cuda.raster_composite)

    def reset_counts():
        for k in kernels:
            k.launches = 0

    def read_counts():
        return {k.__name__: k.launches for k in kernels}

    def actions(rng, n):
        return stp.Actions(**{k: torch.from_numpy(v).to(dev)
                              for k, v in ts.actions_np(rng, n).items()})

    def surf_for(e, states, settings):
        cams = stp.character_camera(states, e.params)
        return scene_flat.build_surfaces_flat(e.flat, cams, settings, WIDTH,
                                              HEIGHT)

    def prep_for(e, surf, settings):
        return rb.prep_instance(surf, e.flat.atlas, WIDTH, HEIGHT,
                                painters=not settings.use_zbuffer,
                                group_id=e.flat.f_group)

    def plain_render(e, states, settings):
        """The frame of `states` through the plain twins only."""
        surf = surf_for(e, states, settings)
        atlas = e.flat.atlas
        n = states.pos.shape[0]
        shading = int(settings.shading)
        mode = rb.composite_mode(settings)
        if settings.xray_mode:
            color = torch.zeros((n, HEIGHT, WIDTH), dtype=torch.int32,
                                device=dev)
            depth = torch.zeros(color.shape, device=dev)
            tr = rb.prep_xray(surf, e.flat.f_group, settings.use_zbuffer)
            tables = rb.face_tables(surf, atlas, WIDTH, HEIGHT)
            return rb.composite_ref(color, depth, tr, tables, atlas, shading,
                                    mode)
        prep = prep_for(e, surf, settings)
        planes = rb.visibility_ref(prep, atlas, HEIGHT, WIDTH,
                                   painters=not settings.use_zbuffer)
        color = rb.resolve_ref(prep, atlas, *planes[1:], shading, 0)
        if e.flat_static.transparent_idx:
            tr = rb.prep_transparent(surf, e.flat_static.transparent_idx)
            color = rb.composite_ref(color, planes[0], tr, prep, atlas,
                                     shading, mode)
        return color

    def differing(kern, plain, names):
        return {n: int((k != p).sum()) for n, k, p in zip(names, kern,
                                                         plain)}

    shading = int(game.shading)
    atlas = env.flat.atlas
    tatlas = tenv.flat.atlas
    names = ("depth", "winner", "bcx", "bcy")

    # ---- kernel vs plain on the same inputs, N_CHECK instances ----
    rng = np.random.default_rng(SEED)
    acts_check = actions(rng, N_CHECK)
    states = rollout.initial_states(level, spawn, N_CHECK, device=dev)
    states = stp.tick(states, env.grid, env.params, acts_check, 1.0 / 60.0)
    prep = prep_for(env, surf_for(env, states, game), game)
    k_planes = _cuda.raster_visibility(prep, atlas, HEIGHT, WIDTH)
    k_color = _cuda.raster_resolve(prep, atlas, *k_planes[1:], shading, 0)
    p_planes = rb.visibility_ref(prep, atlas, HEIGHT, WIDTH)
    p_color = rb.resolve_ref(prep, atlas, *p_planes[1:], shading, 0)
    torch.cuda.synchronize()
    diffs = differing(k_planes, p_planes, names)
    diffs["color"] = int((k_color != p_color).sum())
    win = k_planes[1]
    inst = torch.arange(N_CHECK, device=dev)[:, None, None]
    keyed_px = int(((prep.ctrl[inst, win.clamp(min=0).long(), rb.K_KEY] != 0)
                    & (win >= 0)).sum())
    n_keyable = int(((prep.ctrl[..., rb.K_KEY] != 0)
                     & (torch.arange(prep.order.shape[1], device=dev)
                        < prep.count[:, None])).sum())
    err = {"raster_visibility":
           float((k_planes[0] - p_planes[0]).abs().max()),
           "raster_resolve":
           int((k_color.long() - p_color.long()).abs().max())}
    print(f"kernel vs plain, opaque level, N={N_CHECK} {WIDTH}x{HEIGHT}: "
          f"differing pixels {diffs}; kept keyable faces {n_keyable}, "
          f"pixels won by keyed faces {keyed_px}")
    if any(diffs.values()):
        _fail(f"kernels disagree with their plain twins: {diffs}")
    if n_keyable == 0 or keyed_px == 0:
        _fail("no keyed face reached the kernels")

    # the transparent level: composite (z-buffer, x-ray), painter's merge
    tstates = rollout.initial_states(tlevel, spawn, N_CHECK, device=dev)
    tstates = stp.tick(tstates, tenv.grid, tenv.params, acts_check,
                       1.0 / 60.0)
    tsurf = surf_for(tenv, tstates, game)
    tprep = prep_for(tenv, tsurf, game)
    tr = rb.prep_transparent(tsurf, tenv.flat_static.transparent_idx)
    opaque = _cuda.raster_visibility(tprep, tatlas, HEIGHT, WIDTH)
    base = _cuda.raster_resolve(tprep, tatlas, *opaque[1:], shading, 0)
    depth_before = opaque[0].clone()
    ZBUF, XRAY = rb.COMPOSITE_ZBUFFER, rb.COMPOSITE_XRAY
    k_comp = _cuda.raster_composite(base.clone(), opaque[0], tr, tprep,
                                    tatlas, shading, ZBUF)
    p_comp = rb.composite_ref(base, opaque[0], tr, tprep, tatlas, shading,
                              ZBUF)
    xsurf = surf_for(tenv, tstates, xray)
    xprep = rb.face_tables(xsurf, tatlas, WIDTH, HEIGHT)
    xtr = rb.prep_xray(xsurf, tenv.flat.f_group, True)
    clear = torch.zeros_like(base)
    zero_depth = torch.zeros_like(opaque[0])
    k_xray = _cuda.raster_composite(clear.clone(), zero_depth, xtr, xprep,
                                    tatlas, shading, XRAY)
    p_xray = rb.composite_ref(clear, zero_depth, xtr, xprep, tatlas,
                              shading, XRAY)
    pprep = prep_for(tenv, tsurf, painters)
    k_paint = _cuda.raster_visibility(pprep, tatlas, HEIGHT, WIDTH,
                                      painters=True)
    p_paint = rb.visibility_ref(pprep, tatlas, HEIGHT, WIDTH, painters=True)
    torch.cuda.synchronize()
    # the composite reads depth and must leave it as it was
    tdiffs = {"composite color": int((k_comp != p_comp).sum()),
              "composite depth": int((opaque[0] != depth_before).sum()),
              "xray color": int((k_xray != p_xray).sum()),
              "xray depth": int((zero_depth != 0).sum())}
    tdiffs.update({f"painters {k}": v for k, v in differing(
        k_paint, p_paint, names).items()})
    changed = int((k_comp != base).sum())
    err["raster_composite"] = int((k_comp.long() - p_comp.long()).abs().max())
    err["raster_composite_xray"] = int(
        (k_xray.long() - p_xray.long()).abs().max())
    # the painter's depth plane is always the cleared one: the merge shows
    # in the barycentric planes (and the winner plane, counted above)
    err["raster_visibility_painters"] = max(
        float((k_paint[i] - p_paint[i]).abs().max()) for i in (2, 3))
    # pixels each blend mode drew: composite each mode's entries alone
    # onto a plane of alpha 0 (whether a pixel draws does not depend on
    # what lies under it); every drawn word has alpha 255
    per_mode = {}
    for mode, mname in enumerate(BLEND_NAMES):
        keep = tr.tctrl[..., rb.T_BLEND] == mode
        if not bool(keep.any()):
            continue
        tctrl = tr.tctrl.clone()
        tctrl[..., rb.T_VALID] *= keep.to(torch.int32)
        drew = _cuda.raster_composite(
            torch.zeros_like(base), opaque[0], tr._replace(tctrl=tctrl),
            tprep, tatlas, shading, ZBUF)
        per_mode[mname] = int((((drew >> 24) & 255) == 255).sum())
    print(f"kernel vs plain, transparent level, N={N_CHECK} "
          f"{WIDTH}x{HEIGHT}: differing pixels {tdiffs}; the composite "
          f"changed {changed} pixels; pixels drawn per blend mode "
          f"{per_mode}; painter's depth plane cleared: "
          f"{not bool(k_paint[0].any())}")
    if any(tdiffs.values()):
        _fail(f"phase-3 / painter's kernels disagree with their twins: "
              f"{tdiffs}")
    if bool(k_paint[0].any()):
        _fail("the painter's visibility wrote depth")
    for mname in BLEND_NAMES[1:]:
        if per_mode.get(mname, 0) == 0:
            _fail(f"blend mode {mname} drew no pixel")

    # ---- main paths: the user's entry point, counters reset before ----
    def main_path(e, lvl, settings, n_frames, n_warm, want, label):
        rng = np.random.default_rng(SEED + 1)
        start = rollout.initial_states(lvl, spawn, N_MAIN, device=dev)
        acts = [actions(rng, N_MAIN) for _ in range(n_frames)]
        warm = start
        for f in range(n_warm):     # allocator and first-launch costs
            warm, _ = rollout.step_and_render(warm, e, acts[f], settings,
                                              height=HEIGHT, width=WIDTH)
        torch.cuda.synchronize()
        reset_counts()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        states = start
        ev[0].record()
        for f in range(n_frames):
            states, fbs = rollout.step_and_render(states, e, acts[f],
                                                  settings, height=HEIGHT,
                                                  width=WIDTH)
        ev[1].record()
        torch.cuda.synchronize()
        counts = read_counts()
        ms = ev[0].elapsed_time(ev[1]) / n_frames
        cover = float((((fbs.color >> 24) & 255) == 255).float()
                      .mean(dim=(1, 2)).min())
        print(f"main path, {label}: N={N_MAIN} {WIDTH}x{HEIGHT}, "
              f"{n_frames} frames, launches {counts}, min coverage "
              f"{cover:.3f}")
        for name, per_frame in want.items():
            if counts[name] != per_frame * n_frames:
                _fail(f"{label}: {name} launched {counts[name]} times in "
                      f"{n_frames} frames")
        if cover < 0.25:
            _fail(f"{label}: an instance covers only {cover:.3f} of its "
                  f"last frame")
        for name in ("pos", "vel", "vertical_velocity", "facing",
                     "char_cam_yaw", "char_cam_pitch", "time"):
            if not bool(torch.isfinite(getattr(states, name)).all()):
                _fail(f"{label}: state {name} is not finite")
        if fbs.color.shape != (N_MAIN, HEIGHT, WIDTH):
            _fail(f"{label}: frame shape {tuple(fbs.color.shape)}")
        if settings.xray_mode or not settings.use_zbuffer:
            if bool(fbs.depth.any()):
                _fail(f"{label}: the depth plane is not the cleared one")
        distinct = int((fbs.color != fbs.color[:1]).flatten(1).any(1).sum())
        if distinct < N_MAIN // 2:
            _fail(f"{label}: only {distinct} instances differ from "
                  f"instance 0")
        sub = type(states)(*(x[:N_CHECK] for x in states))
        ref_diff = int((plain_render(e, sub, settings)
                        != fbs.color[:N_CHECK]).sum())
        print(f"main path, {label}: output vs plain render of {N_CHECK} "
              f"instances: {ref_diff} differing pixels; {distinct} of "
              f"{N_MAIN} instances differ from instance 0")
        if ref_diff:
            _fail(f"{label}: the main path's frame disagrees with the "
                  f"plain path")
        return counts, ms, start, acts

    vis, res, comp = (k.__name__ for k in kernels)
    runs = {}
    runs["opaque"] = main_path(env, level, game, FRAMES, WARMUP,
                               {vis: 1, res: 1, comp: 0}, "opaque level")
    runs["transparent"] = main_path(tenv, tlevel, game, FRAMES, WARMUP,
                                    {vis: 1, res: 1, comp: 1},
                                    "transparent level")
    runs["xray"] = main_path(tenv, tlevel, xray, MODE_FRAMES, 1,
                             {vis: 0, res: 0, comp: 1}, "x-ray")
    runs["painters"] = main_path(tenv, tlevel, painters, MODE_FRAMES, 1,
                                 {vis: 1, res: 1, comp: 1}, "painter's")

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

    def replay(e, key):
        """The stages of the counted frames of run `key`, replayed."""
        _, _, states, acts = runs[key]
        stage = dict(tick=0.0, surfaces_prep=0.0, visibility=0.0,
                     resolve=0.0, composite=0.0)
        idx = e.flat_static.transparent_idx
        for f in range(FRAMES):
            states, ms = timed(lambda s=states, a=acts[f]: stp.tick(
                s, e.grid, e.params, a, 1.0 / 60.0))
            stage["tick"] += ms

            def surfaces_prep(s=states):
                surf = surf_for(e, s, game)
                return (prep_for(e, surf, game),
                        rb.prep_transparent(surf, idx) if idx else None)
            (prep, tr), ms = timed(surfaces_prep)
            stage["surfaces_prep"] += ms
            planes, ms = timed(lambda p=prep: _cuda.raster_visibility(
                p, e.flat.atlas, HEIGHT, WIDTH))
            stage["visibility"] += ms
            color, ms = timed(lambda p=prep, q=planes: _cuda.raster_resolve(
                p, e.flat.atlas, *q[1:], shading, 0))
            stage["resolve"] += ms
            if idx:
                _, ms = timed(lambda c=color, p=prep, q=planes, t=tr:
                              _cuda.raster_composite(
                                  c, q[0], t, p, e.flat.atlas, shading,
                                  ZBUF))
                stage["composite"] += ms
        if not idx:
            del stage["composite"]
        return stage, prep, planes, color, tr

    stages = {}
    stages["opaque"], *_ = replay(env, "opaque")
    stages["transparent"], prep, planes, color, tr = replay(tenv,
                                                            "transparent")

    # the other modes' inputs at N_MAIN, from the transparent run's states
    _, _, start, acts = runs["transparent"]
    states = stp.tick(start, tenv.grid, tenv.params, acts[0], 1.0 / 60.0)
    psurf = surf_for(tenv, states, painters)
    pprep = prep_for(tenv, psurf, painters)
    xsurf = surf_for(tenv, states, xray)
    xprep = rb.face_tables(xsurf, tatlas, WIDTH, HEIGHT)
    xtr = rb.prep_xray(xsurf, tenv.flat.f_group, True)
    clear = torch.zeros((N_MAIN, HEIGHT, WIDTH), dtype=torch.int32,
                        device=dev)
    zero_depth = torch.zeros(clear.shape, device=dev)

    def kernel_ms(fn, reps=10):
        fn()
        torch.cuda.synchronize()
        evs[0].record()
        for _ in range(reps):
            fn()
        evs[1].record()
        torch.cuda.synchronize()
        return evs[0].elapsed_time(evs[1]) / reps

    def chunked_plain_ms(fn):
        total = 0.0
        for s in range(0, N_MAIN, PLAIN_CHUNK):
            torch.cuda.synchronize()
            evs[0].record()
            fn(slice(s, s + PLAIN_CHUNK))
            evs[1].record()
            torch.cuda.synchronize()
            total += evs[0].elapsed_time(evs[1])
        return total

    def part(tup, sl):
        return type(tup)(*(x[sl] for x in tup))

    # the kernel composites in place: it is timed on scratch planes (the
    # same work every launch), the plain twins on the unchanged ones
    base = color.clone()
    work = color.clone()
    xwork = clear.clone()
    ms, plain = {}, {}
    ms[vis] = kernel_ms(lambda: _cuda.raster_visibility(
        prep, tatlas, HEIGHT, WIDTH))
    plain[vis] = chunked_plain_ms(lambda sl: rb.visibility_ref(
        part(prep, sl), tatlas, HEIGHT, WIDTH))
    ms["raster_visibility_painters"] = kernel_ms(
        lambda: _cuda.raster_visibility(pprep, tatlas, HEIGHT, WIDTH,
                                        painters=True))
    plain["raster_visibility_painters"] = chunked_plain_ms(
        lambda sl: rb.visibility_ref(part(pprep, sl), tatlas, HEIGHT, WIDTH,
                                     painters=True))
    ms[res] = kernel_ms(lambda: _cuda.raster_resolve(
        prep, tatlas, *planes[1:], shading, 0))
    plain[res] = chunked_plain_ms(lambda sl: rb.resolve_ref(
        part(prep, sl), tatlas, *(p[sl] for p in planes[1:]), shading, 0))
    ms[comp] = kernel_ms(lambda: _cuda.raster_composite(
        work, planes[0], tr, prep, tatlas, shading, ZBUF))
    plain[comp] = chunked_plain_ms(lambda sl: rb.composite_ref(
        base[sl], planes[0][sl], part(tr, sl), part(prep, sl), tatlas,
        shading, ZBUF))
    ms["raster_composite_xray"] = kernel_ms(lambda: _cuda.raster_composite(
        xwork, zero_depth, xtr, xprep, tatlas, shading, XRAY))
    plain["raster_composite_xray"] = chunked_plain_ms(
        lambda sl: rb.composite_ref(clear[sl], zero_depth[sl],
                                    part(xtr, sl), part(xprep, sl), tatlas,
                                    shading, XRAY))

    # ---- bounds: bytes or f32 operations, from this run's inputs ----
    # Bytes: each input the function needs read once, each output written
    # once, counting only the rows and columns the data needs: the kept
    # faces' order entry, 6 ctrl and 16 attrs columns (visibility); the
    # 20 attrs columns of each face that won a pixel (resolve); every
    # composite entry's valid and editor-alpha words and the rest of a live
    # one's row (6 tctrl, 4 ctrl, 16 attrs, 12 tfscal columns).  Pixels:
    # the visibility's four planes and the resolve's three planes in and
    # colour out over the whole frame; the composite's colour read and
    # written where it drew, and depth read where an entry covers, in
    # z-buffer mode.  The atlas is read whole.
    def nbytes(*ts_):
        return sum(t.numel() * t.element_size() for t in ts_)

    def bbox_area(p, fids, live):
        k = p.ctrl.gather(1, fids.long()[..., None].expand(-1, -1, 8))
        w = (k[..., rb.K_XHI] - k[..., rb.K_XLO]).clamp(min=0)
        h = (k[..., rb.K_YHI] - k[..., rb.K_YLO]).clamp(min=0)
        return int((w * h * live).long().sum())

    def kept(p):
        return (torch.arange(p.order.shape[1], device=dev)[None]
                < p.count[:, None]).to(torch.int32)

    def live(t):
        return ((t.tctrl[..., rb.T_VALID] != 0)
                & (t.tctrl[..., rb.T_EA] != 0)).to(torch.int32)

    def bound(n_bytes, n_ops):
        t_bytes, t_ops = n_bytes / HBM_BYTES_S, n_ops / F32_OPS_S
        return (max(t_bytes, t_ops) * 1e3,
                "bytes" if t_bytes >= t_ops else "operations")

    atlas_b = nbytes(tatlas.data, tatlas.offset, tatlas.width,
                     tatlas.height)
    plane = N_MAIN * HEIGHT * WIDTH
    bounds = {}
    for name, p in ((vis, prep), ("raster_visibility_painters", pprep)):
        n_kept = int(p.count.sum())
        bounds[name] = bound(n_kept * 4 * (1 + 6 + 16) + nbytes(p.count)
                             + atlas_b + 16 * plane,
                             OPS_COVER * bbox_area(p, p.order, kept(p)))
    win = planes[1]
    n_faces = prep.attrs.shape[1]
    row = (torch.arange(N_MAIN, device=dev)[:, None, None] * n_faces
           + win.long())[win >= 0]
    won = torch.zeros(N_MAIN * n_faces, dtype=torch.bool, device=dev)
    won[row] = True
    bounds[res] = bound(int(won.sum()) * 4 * 20 + atlas_b + 16 * plane,
                        OPS_PIPELINE * int((win >= 0).sum()))

    # pixels the composite drew: drawn words have alpha 255 and the plane
    # of zeros under them has none (whether a pixel draws does not depend
    # on the colour under it); with a zero depth plane every covered pixel
    # in front of the camera passes the z-test, keyed texels aside
    def drawn(t, p, depth, mode):
        c = _cuda.raster_composite(torch.zeros_like(clear), depth, t, p,
                                   tatlas, shading, mode)
        return int((((c >> 24) & 255) == 255).sum())

    def entry_bytes(t):
        n_live = int(live(t).sum())
        return t.tctrl[..., 0].numel() * 8 + n_live * 4 * (6 + 4 + 16 + 12)

    drawn_z = drawn(tr, prep, planes[0], ZBUF)
    bounds[comp] = bound(
        entry_bytes(tr) + atlas_b + 8 * drawn_z
        + 4 * drawn(tr, prep, zero_depth, ZBUF),
        OPS_COVER * bbox_area(prep, tr.tctrl[..., rb.T_FID], live(tr))
        + OPS_PIPELINE * drawn_z)
    drawn_x = drawn(xtr, xprep, zero_depth, XRAY)
    bounds["raster_composite_xray"] = bound(
        entry_bytes(xtr) + atlas_b + 8 * drawn_x,
        OPS_COVER * bbox_area(xprep, xtr.tctrl[..., rb.T_FID], live(xtr))
        + OPS_PIPELINE * drawn_x)

    for key, label in (("opaque", "opaque level"),
                       ("transparent", "transparent level"),
                       ("xray", "x-ray"), ("painters", "painter's")):
        f_ms = runs[key][1]
        print(f"frame, {label}: {f_ms:.3f} ms per batched frame of "
              f"{N_MAIN} instances = {N_MAIN * 1000.0 / f_ms:.1f} "
              f"instance-frames/s (step_and_render, CUDA events) {card}")
    for key, stage in stages.items():
        print(f"stages, {key} level (ms per frame, CUDA events, "
              f"synchronized per stage): "
              + ", ".join(f"{k} {v:.3f}" for k, v in stage.items())
              + f", sum {sum(stage.values()):.3f} {card}")
    for name in ms:
        print(f"{name}: kernel {ms[name]:.3f} ms, plain {plain[name]:.3f} "
              f"ms, bound {bounds[name][0]:.3f} ms ({bounds[name][1]}) "
              f"(N={N_MAIN}, transparent level, plain in chunks of "
              f"{PLAIN_CHUNK}) {card}")

    t_counts = runs["transparent"][0]
    launches = {vis: t_counts[vis], res: t_counts[res],
                comp: t_counts[comp],
                "raster_visibility_painters": runs["painters"][0][vis],
                "raster_composite_xray": runs["xray"][0][comp]}
    replaces = {vis: f"{JAX_RB}:859",
                "raster_visibility_painters": f"{JAX_RB}:941",
                res: f"{JAX_RB}:1098",
                comp: f"{JAX_RB}:1562",
                "raster_composite_xray": f"{JAX_RB}:1713"}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SRC,
         "replaces": replaces[name], "launches": launches[name],
         "max_abs_err": err[name], "ms": ms[name], "plain_ms": plain[name],
         "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
         "library_ms": None} for name in ms]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
