#!/usr/bin/env python3
"""Sweep of the tile shape of the port's binned rasterizer kernels
(bonnie32_tpu_torch/csrc/raster.cu) on one CUDA card.

    python3 scripts/torch_tile_sweep.py 16x16x4x2 32x8x1x1 ...

Each argument is TILE_W x TILE_H x rows per thread of the visibility kernel
x rows per thread of the composite kernel, optionally followed by
`:NAME=value,...` for further -DRASTER_NAME=value definitions (e.g.
`16x16x4x2:VIS_PERSP_THREADS=1024`, the register cap of the perspective
visibility).  Every shape is compiled (all nvcc processes at once),
checked against the plain versions at N=8 — `raster_bin` and its work
list, both visibility merges affine and perspective, resolve, the three
composite modes, at 320x240 and at a ragged 150x100, 0 differing elements
wanted — and timed at N=1024, 320x240 on the transparent Cave-size level
after one tick (CUDA events over 10 launches; a consumer's time includes
its `raster_bin` launch), the perspective instantiations too.  Prints the card's
name and power limit first.  Imports nothing of jax.
"""
import dataclasses
import os
import subprocess
import sys
import time

import numpy as np
import torch

repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [repo, os.path.join(repo, "tests")]
import torch_scenes as ts
from bonnie32_tpu_torch import rollout
from bonnie32_tpu_torch.config import RasterSettings
from bonnie32_tpu_torch.game import step as stp
from bonnie32_tpu_torch.models import level as L
from bonnie32_tpu_torch.models import scene_flat
from bonnie32_tpu_torch.ops import _cuda
from bonnie32_tpu_torch.ops import raster_batch as rb



def parse(a):
    shape, _, extra = a.partition(":")
    return tuple(int(v) for v in shape.split("x")) + tuple(
        e for e in extra.split(",") if e)


CONFIGS = [parse(a) for a in sys.argv[1:]]
dev = torch.device("cuda", 0)
print("card:", subprocess.run(
    ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
    capture_output=True, text=True).stdout.strip(), flush=True)
BASE_FLAGS = _cuda.NVCC_FLAGS


def configure(cfg):
    """Point the build at shape `cfg`: the tile through raster_batch (the
    build passes it on), rows and further definitions as flags."""
    rb.TILE_W, rb.TILE_H = cfg[:2]
    _cuda.NVCC_FLAGS = BASE_FLAGS + (
        f"-DRASTER_VIS_ROWS={cfg[2]}", f"-DRASTER_COMP_ROWS={cfg[3]}"
    ) + tuple(f"-DRASTER_{e}" for e in cfg[4:])
    _cuda._libs.clear()


t0 = time.perf_counter()
procs = {}
_cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
for cfg in CONFIGS:
    configure(cfg)
    out = _cuda.library_path("raster")
    procs[cfg] = subprocess.Popen(
        [_cuda._nvcc(), *_cuda.nvcc_flags(), "-Xptxas", "-v", "-o", str(out),
         str(_cuda.SOURCES["raster"])], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
for i, (cfg, p) in enumerate(procs.items()):
    log = p.communicate()[0]
    if p.returncode != 0 or i == 0:
        keep = [ln for ln in log.splitlines() if "error" in ln
                or "warning" in ln or "Compiling entry" in ln or "Used" in ln
                or "spill" in ln]
        print(cfg, "nvcc rc", p.returncode)
        print("\n".join(keep if p.returncode == 0 else log.splitlines()[-60:]))
    if p.returncode != 0:
        CONFIGS.remove(cfg)
print(f"builds: {time.perf_counter() - t0:.1f} s", flush=True)

game = RasterSettings.game()
xray = dataclasses.replace(game, xray_mode=True)
painters = dataclasses.replace(game, use_zbuffer=False)
shading = int(game.shading)
evs = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
tlevel = ts.transparent_cave_level(L)
tenv = rollout.build_env(tlevel, ts.transparent_textures(), ts.resolver,
                         device=dev)
atlas = tenv.flat.atlas
spawn = ts.spawn_point(tlevel)


def kernel_ms(fn, reps=10):
    fn()
    torch.cuda.synchronize()
    evs[0].record()
    for _ in range(reps):
        fn()
    evs[1].record()
    torch.cuda.synchronize()
    return evs[0].elapsed_time(evs[1]) / reps


def inputs(n, h, w):
    rng = np.random.default_rng(1)
    acts = stp.Actions(**{k: torch.from_numpy(v).to(dev)
                          for k, v in ts.actions_np(rng, n).items()})
    states = rollout.initial_states(tlevel, spawn, n, device=dev)
    states = stp.tick(states, tenv.grid, tenv.params, acts, 1.0 / 60.0)

    def surf_for(settings):
        cams = stp.character_camera(states, tenv.params)
        return scene_flat.build_surfaces_flat(tenv.flat, cams, settings, w, h)
    surf = surf_for(game)
    prep = rb.prep_instance(surf, atlas, w, h, painters=False,
                            group_id=tenv.flat.f_group)
    pprep = rb.prep_instance(surf_for(painters), atlas, w, h, painters=True,
                             group_id=tenv.flat.f_group)
    tr = rb.prep_transparent(surf, tenv.flat_static.transparent_idx)
    xsurf = surf_for(xray)
    xprep = rb.face_tables(xsurf, atlas, w, h)
    xtr = rb.prep_xray(xsurf, tenv.flat.f_group, True)
    return prep, pprep, tr, xprep, xtr


def check(h, w):
    n = 8
    prep, pprep, tr, xprep, xtr = inputs(n, h, w)
    bad = {}
    for name, ctrl, kw in (("bin opaque", prep.ctrl, dict(
            order=prep.order, count=prep.count)),
            ("bin painters", pprep.ctrl, dict(order=pprep.order,
                                              count=pprep.count)),
            ("bin transparent", prep.ctrl, dict(tctrl=tr.tctrl)),
            ("bin xray", xprep.ctrl, dict(tctrl=xtr.tctrl))):
        bins, work, work_len = _cuda.raster_bin(ctrl, h, w, want_work=True,
                                                **kw)
        want = rb.tile_bins_ref(ctrl, h, w, **kw)
        torch.cuda.synchronize()
        bad[name] = int((bins != want).sum())
        got = work[:int(work_len[0])].sort().values
        ref = rb.work_list_ref(want)
        bad[name + " work"] = int(got.numel() != ref.numel()
                                  or (got != ref).any())
    for name, p, pt in (("vis", prep, False), ("vis painters", pprep, True)):
        for persp in (False, True):
            k = _cuda.raster_visibility(p, atlas, h, w, painters=pt,
                                        perspective=persp)
            r = rb.visibility_ref(p, atlas, h, w, painters=pt,
                                  perspective=persp)
            torch.cuda.synchronize()
            bad[name + (" persp" if persp else "")] = sum(
                int((a != b).sum()) for a, b in zip(k, r))
    planes = _cuda.raster_visibility(prep, atlas, h, w)
    base = _cuda.raster_resolve(prep, atlas, *planes[1:], shading, 0)
    bad["resolve"] = int((base != rb.resolve_ref(
        prep, atlas, *planes[1:], shading, 0)).sum())
    for name, mode in (("comp z", 0), ("comp painters", 1)):
        k = _cuda.raster_composite(base.clone(), planes[0], tr, prep, atlas,
                                   shading, mode)
        r = rb.composite_ref(base, planes[0], tr, prep, atlas, shading, mode)
        torch.cuda.synchronize()
        bad[name] = int((k != r).sum())
        bad[name + " changed 0"] = int(not (k != base).any())
    clear = torch.full_like(base, 0x10203040)
    zd = torch.zeros_like(planes[0])
    k = _cuda.raster_composite(clear.clone(), zd, xtr, xprep, atlas, shading,
                               2)
    r = rb.composite_ref(clear, zd, xtr, xprep, atlas, shading, 2)
    torch.cuda.synchronize()
    bad["comp xray"] = int((k != r).sum())
    print(f"  check {w}x{h}: "
          + ("all 0" if not any(bad.values()) else f"DIFFERS {bad}"),
          flush=True)


big = None
for cfg in CONFIGS:
    configure(cfg)
    print(f"config {cfg}", flush=True)
    try:
        check(240, 320)
        check(100, 150)
        if big is None:
            big = inputs(1024, 240, 320)
        prep, pprep, tr, xprep, xtr = big
        H, W = 240, 320
        t = {}
        t["bin vis"] = kernel_ms(lambda: _cuda.raster_bin(
            prep.ctrl, H, W, order=prep.order, count=prep.count))
        t["bin tr"] = kernel_ms(lambda: _cuda.raster_bin(
            prep.ctrl, H, W, tctrl=tr.tctrl, want_work=True))
        t["bin xray"] = kernel_ms(lambda: _cuda.raster_bin(
            xprep.ctrl, H, W, tctrl=xtr.tctrl, want_work=True))
        t["vis"] = kernel_ms(lambda: _cuda.raster_visibility(prep, atlas, H,
                                                             W))
        pl = _cuda.raster_visibility(prep, atlas, H, W)
        t["resolve"] = kernel_ms(lambda: _cuda.raster_resolve(
            prep, atlas, *pl[1:], shading, 0))
        del pl
        t["vis painters"] = kernel_ms(lambda: _cuda.raster_visibility(
            pprep, atlas, H, W, painters=True))
        planes = _cuda.raster_visibility(prep, atlas, H, W)
        color = _cuda.raster_resolve(prep, atlas, *planes[1:], shading, 0)
        work = color.clone()
        t["comp z"] = kernel_ms(lambda: _cuda.raster_composite(
            work, planes[0], tr, prep, atlas, shading, 0))
        xwork = torch.zeros_like(color)
        zd = torch.zeros_like(planes[0])
        t["comp xray"] = kernel_ms(lambda: _cuda.raster_composite(
            xwork, zd, xtr, xprep, atlas, shading, 2))
        dead = tr.tctrl.clone()
        dead[..., rb.T_VALID] = 0
        t["comp z, no live entry"] = kernel_ms(lambda: _cuda.raster_composite(
            work, planes[0], tr._replace(tctrl=dead), prep, atlas, shading,
            0))
        # the perspective instantiations on the same inputs
        t["vis persp"] = kernel_ms(lambda: _cuda.raster_visibility(
            prep, atlas, H, W, perspective=True))
        t["vis painters persp"] = kernel_ms(lambda: _cuda.raster_visibility(
            pprep, atlas, H, W, painters=True, perspective=True))
        t["resolve persp"] = kernel_ms(lambda: _cuda.raster_resolve(
            prep, atlas, *planes[1:], shading, 0, perspective=True))
        t["comp z persp"] = kernel_ms(lambda: _cuda.raster_composite(
            work, planes[0], tr, prep, atlas, shading, 0, perspective=True))
        t["comp xray persp"] = kernel_ms(lambda: _cuda.raster_composite(
            xwork, zd, xtr, xprep, atlas, shading, 2, perspective=True))
        del planes, color, work, xwork, zd
        print("  ms: " + ", ".join(f"{k} {v:.3f}" for k, v in t.items()),
              flush=True)
    except Exception as exc:  # report and go on to the next shape
        print(f"  FAILED: {type(exc).__name__}: {exc}", flush=True)
        torch.cuda.synchronize()
