#!/usr/bin/env python3
"""Where the port's visibility and composite kernels spend their time, on
one CUDA card: the entries per tile of each ordered list, and the kernels
timed on altered tables.

    python3 scripts/torch_kernel_split.py [--tree PATH]

`--tree` is the checkout whose `bonnie32_tpu_torch` is driven (default:
this one), so that two commits can be split in one run.  N=1024, 320x240,
the transparent Cave-size level after one tick.  Prints, for the kept
faces (z-buffer and painter's order), the transparent list and the x-ray
list: live entries per instance, bbox pixels per frame pixel, and for
several tile shapes the mean and maximum number of entries whose bbox
overlaps a tile and the share of tiles with none.  Then times (CUDA
events, 10 launches) `raster_visibility` as it is, with every bbox emptied
(no covered work left: what remains is per-face overhead and the plane
writes), with that and half the kept faces, and with `count = 0` (launch
and plane writes only); `raster_composite` in z-buffer mode as it is and
with every entry invalid, in x-ray mode as it is and with every bbox
emptied.  Prints the card's name and power limit first.  Imports nothing
of jax.
"""
import argparse
import dataclasses
import os
import subprocess
import sys

import numpy as np
import torch

parser = argparse.ArgumentParser()
parser.add_argument("--tree", default=os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
tree = os.path.abspath(parser.parse_args().tree)
sys.path[:0] = [tree, os.path.join(tree, "tests")]
import torch_scenes as ts
from bonnie32_tpu_torch import rollout
from bonnie32_tpu_torch.config import RasterSettings
from bonnie32_tpu_torch.game import step as stp
from bonnie32_tpu_torch.models import level as L
from bonnie32_tpu_torch.models import scene_flat
from bonnie32_tpu_torch.ops import _cuda
from bonnie32_tpu_torch.ops import raster_batch as rb

dev = torch.device("cuda", 0)
N, H, W = 1024, 240, 320
print("card:", subprocess.run(
    ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
    capture_output=True, text=True).stdout.strip())
_cuda.build()
game = RasterSettings.game()
xray = dataclasses.replace(game, xray_mode=True)
painters = dataclasses.replace(game, use_zbuffer=False)
shading = int(game.shading)

evs = [torch.cuda.Event(enable_timing=True) for _ in range(2)]


def kernel_ms(fn, reps=10):
    fn()
    torch.cuda.synchronize()
    evs[0].record()
    for _ in range(reps):
        fn()
    evs[1].record()
    torch.cuda.synchronize()
    return evs[0].elapsed_time(evs[1]) / reps


def tile_stats(label, ctrl, fids, live):
    n, l = fids.shape
    box = ctrl.gather(1, fids.long()[..., None].expand(-1, -1, 8))[..., :4]
    area = ((box[..., 1] - box[..., 0]).clamp(min=0)
            * (box[..., 3] - box[..., 2]).clamp(min=0) * live).sum().item()
    print(f"{label}: L={l}, mean live entries per instance "
          f"{live.sum().item() / n:.2f}, max {live.sum(1).max().item()}, "
          f"bbox pixels per frame pixel {area / (n * H * W):.3f}")
    for th, tw in ((16, 16), (8, 32), (16, 32), (8, 16), (4, 32)):
        # the overlap test is separable: rows (I, TY, L), columns (I, TX, L)
        y0 = torch.arange(0, H, th, device=dev)
        x0 = torch.arange(0, W, tw, device=dev)
        y1 = (y0 + th).clamp(max=H)
        x1 = (x0 + tw).clamp(max=W)
        tot = 0
        mx = 0
        empty = 0
        for s in range(0, n, 128):
            b = box[s:s + 128]
            lv = live[s:s + 128].bool()
            hy = (torch.minimum(b[..., 3][:, None], y1[None, :, None])
                  > torch.maximum(b[..., 2][:, None], y0[None, :, None]))
            hx = (torch.minimum(b[..., 1][:, None], x1[None, :, None])
                  > torch.maximum(b[..., 0][:, None], x0[None, :, None]))
            # (I, TY, L) x (I, TX, L) -> counts (I, TY, TX)
            c = torch.einsum("iyl,ixl->iyx", (hy & lv[:, None]).float(),
                             hx.float())
            tot += c.sum().item()
            mx = max(mx, c.max().item())
            empty += (c == 0).sum().item()
        tiles = n * len(y0) * len(x0)
        print(f"   tile {tw}x{th}: mean entries per tile {tot / tiles:.2f}, "
              f"max {mx:.0f}, tiles with none {empty / tiles:.3f}; "
              f"entry-pixels per frame pixel (tile granularity) "
              f"{tot * th * tw / (n * H * W):.2f}")


tlevel = ts.transparent_cave_level(L)
tenv = rollout.build_env(tlevel, ts.transparent_textures(), ts.resolver,
                         device=dev)
spawn = ts.spawn_point(tlevel)
rng = np.random.default_rng(1)
acts = stp.Actions(**{k: torch.from_numpy(v).to(dev)
                      for k, v in ts.actions_np(rng, N).items()})
states = rollout.initial_states(tlevel, spawn, N, device=dev)
states = stp.tick(states, tenv.grid, tenv.params, acts, 1.0 / 60.0)
atlas = tenv.flat.atlas


def surf_for(settings):
    cams = stp.character_camera(states, tenv.params)
    return scene_flat.build_surfaces_flat(tenv.flat, cams, settings, W, H)


surf = surf_for(game)
prep = rb.prep_instance(surf, atlas, W, H, painters=False,
                        group_id=tenv.flat.f_group)
pprep = rb.prep_instance(surf_for(painters), atlas, W, H, painters=True,
                         group_id=tenv.flat.f_group)
tr = rb.prep_transparent(surf, tenv.flat_static.transparent_idx)
xsurf = surf_for(xray)
xprep = rb.face_tables(xsurf, atlas, W, H)
xtr = rb.prep_xray(xsurf, tenv.flat.f_group, True)

kept = (torch.arange(prep.order.shape[1], device=dev)[None]
        < prep.count[:, None]).int()
tile_stats("opaque list (transparent level)", prep.ctrl, prep.order, kept)
pk = (torch.arange(pprep.order.shape[1], device=dev)[None]
      < pprep.count[:, None]).int()
tile_stats("painter's list", pprep.ctrl, pprep.order, pk)
for label, t, p in (("transparent list", tr, prep), ("x-ray list", xtr,
                                                     xprep)):
    live = ((t.tctrl[..., rb.T_VALID] != 0)
            & (t.tctrl[..., rb.T_EA] != 0)).int()
    tile_stats(label, p.ctrl, t.tctrl[..., rb.T_FID], live)

# ---- the visibility kernel's split ----
full = kernel_ms(lambda: _cuda.raster_visibility(prep, atlas, H, W))
ctrl0 = prep.ctrl.clone()
ctrl0[..., rb.K_XHI] = 0          # every bbox empty: no face covers a pixel
skip = kernel_ms(lambda: _cuda.raster_visibility(
    prep._replace(ctrl=ctrl0), atlas, H, W))
none = kernel_ms(lambda: _cuda.raster_visibility(
    prep._replace(count=torch.zeros_like(prep.count)), atlas, H, W))
print(f"raster_visibility: as it is {full:.3f} ms; every bbox empty "
      f"(per-face overhead + plane writes) {skip:.3f} ms; count 0 (launch "
      f"+ plane writes only) {none:.3f} ms")
# half the kept faces: how the per-face overhead scales
half = kernel_ms(lambda: _cuda.raster_visibility(
    prep._replace(ctrl=ctrl0, count=prep.count // 2), atlas, H, W))
print(f"raster_visibility: every bbox empty and half the kept faces "
      f"{half:.3f} ms")
pfull = kernel_ms(lambda: _cuda.raster_visibility(pprep, atlas, H, W,
                                                  painters=True))
print(f"raster_visibility painters: {pfull:.3f} ms")

# ---- the composite's split ----
planes = _cuda.raster_visibility(prep, atlas, H, W)
color = _cuda.raster_resolve(prep, atlas, *planes[1:], shading, 0)
work = color.clone()
cz = kernel_ms(lambda: _cuda.raster_composite(work, planes[0], tr, prep,
                                              atlas, shading, 0))
dead = tr.tctrl.clone()
dead[..., rb.T_VALID] = 0
cz0 = kernel_ms(lambda: _cuda.raster_composite(
    work, planes[0], tr._replace(tctrl=dead), prep, atlas, shading, 0))
print(f"raster_composite z-buffer: as it is {cz:.3f} ms; every entry "
      f"invalid (launch overhead only) {cz0:.3f} ms")
xwork = torch.zeros_like(color)
zero_depth = torch.zeros_like(planes[0])
cx = kernel_ms(lambda: _cuda.raster_composite(xwork, zero_depth, xtr, xprep,
                                              atlas, shading, 2))
xctrl0 = xprep.ctrl.clone()
xctrl0[..., rb.K_XHI] = 0
cx0 = kernel_ms(lambda: _cuda.raster_composite(
    xwork, zero_depth, xtr, xprep._replace(ctrl=xctrl0), atlas, shading, 2))
print(f"raster_composite x-ray: as it is {cx:.3f} ms; every bbox empty "
      f"(per-entry overhead only) {cx0:.3f} ms")
