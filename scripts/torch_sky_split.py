#!/usr/bin/env python3
"""Where the port's sky kernel (TPU kernel K5: `raster_sky`, and the sky
fused into `raster_resolve`) spends its time, on one CUDA card.

    python3 scripts/torch_sky_split.py [--tree PATH] [--probes]
        [--sass FILE] [--tiles WxH[xR] ...]

`--tree` is the checkout whose `bonnie32_tpu_torch` is driven (default:
this one), so that two commits can be split in one run.  N=1024, 320x240,
the open-air Cave-size level after one tick, under the night sky (moon,
haze, one mountain range) and the two-range sunset sky (tint, sun, haze,
two cloud layers).  Prints, in order:

  * the card's name and power limit;
  * ptxas' registers and shared memory for every kernel whose name holds
    "sky" (the sky's two entry points) and the occupancy they allow, and
    the static SASS instruction count of those kernels by opcode
    (`cuobjdump -sass`);
  * per sky: mountain faces whose box (widened by one pixel; the pixel-
    centre test the kernels make) overlaps a tile, for several tile
    shapes and for the 256-pixel row blocks of the first port: mean, max,
    share of tiles with none, and the box tests a pixel makes;
  * per sky: the share of the sphere's pixels inside each cloud band,
    the haze, the tint's horizon range and each body's glow gate;
  * times (CUDA events, 10 launches queued behind a matrix product, so
    that the card's time is read and not the host's): `raster_sky` and
    the fused resolve as they are, without mountain faces, with every
    sphere feature off but the gradient (ray + acos), that with no
    mountain faces, the fused resolve over a constant word, and one
    `fill_` of the plane (the stores alone);
  * with `--probes`, probe copies of csrc/raster.cu (written under
    build/, never used by the package) in which one piece of the sphere
    is replaced by a cheaper stand-in that is NOT exact — the view ray's
    square root and divides by one rsqrt, acos by a subtraction, the
    gradient's divides by multiplies, the whole sphere by a constant —
    or, exact, the sky kernels' registers are left to the compiler (no
    cap for 2048 threads an SM); each probe's
    planes against the kernel as it is (differing pixels), and its times
    as it is, without mountains and with the gradient alone (where the
    sphere's time goes);
  * with `--sass FILE`, the SASS of the sky kernels into FILE;
  * with `--tiles`, for each sky tile shape W x H (ops/skybox.py
    SKY_TILE_W / SKY_TILE_H, which the build passes on) and R rows of a
    column a thread (SKY_THREAD_ROWS, in a copy of the source under
    build/; default 1): ptxas' report,
    a check at N=8 against the plain versions at 320x240 and 150x100
    (tile faces, mountain pixels exact, other sky pixels within one
    step, fused route equal to the plane route), and the times of both
    entry points under both skies.

Imports nothing of jax.
"""
import argparse
import dataclasses
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import torch

parser = argparse.ArgumentParser()
parser.add_argument("--tree", default=os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
parser.add_argument("--tiles", nargs="*", default=[])
parser.add_argument("--probes", action="store_true")
parser.add_argument("--sass", default=None,
                    help="write the SASS of the sky kernels to this file")
args = parser.parse_args()
tree = os.path.abspath(args.tree)
sys.path[:0] = [tree, os.path.join(tree, "tests")]
import torch_scenes as ts  # noqa: E402
from bonnie32_tpu_torch import rollout  # noqa: E402
from bonnie32_tpu_torch.config import RasterSettings  # noqa: E402
from bonnie32_tpu_torch.game import step as stp  # noqa: E402
from bonnie32_tpu_torch.models import level as L  # noqa: E402
from bonnie32_tpu_torch.models import scene_flat  # noqa: E402
from bonnie32_tpu_torch.models import skybox as S  # noqa: E402
from bonnie32_tpu_torch.ops import _cuda  # noqa: E402
from bonnie32_tpu_torch.ops import raster_batch as rb  # noqa: E402
from bonnie32_tpu_torch.ops import skybox as sky_ops  # noqa: E402

dev = torch.device("cuda", 0)
N, H, W = 1024, 240, 320
print("tree:", tree)
print("card:", subprocess.run(
    ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
    capture_output=True, text=True).stdout.strip(), flush=True)

# ---- registers, occupancy, SASS ----
lib = _cuda.library_path("raster")
_cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
log = subprocess.run([_cuda._nvcc(), *_cuda.nvcc_flags(), "-Xptxas", "-v",
                      "-o", str(lib), str(_cuda.SOURCES["raster"])],
                     capture_output=True, text=True, check=True)
ptxas = (log.stdout + log.stderr).splitlines()


def occupancy(regs, threads, smem):
    """Resident warps of 64 an SM: 64 K registers allocated per warp in
    units of 256, 228 KB shared memory (1 KB reserved a block), at most
    32 blocks and 2048 threads."""
    per_warp = -(-regs * 32 // 256) * 256
    warps_block = threads // 32
    by_regs = 65536 // (per_warp * warps_block)
    by_smem = 233472 // (smem + 1024) if smem else 32
    blocks = min(by_regs, by_smem, 32, 2048 // threads)
    return blocks, blocks * warps_block / 64


fn = None
for line in ptxas:
    m = re.search(r"Compiling entry function '(\S+)'", line)
    if m:
        fn = m.group(1)
        continue
    m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
    if m and fn and ("sky" in fn.lower() or "resolve" in fn):
        regs, smem = int(m.group(1)), int(m.group(2) or 0)
        blocks, occ = occupancy(regs, 256, smem)
        print(f"ptxas: {fn}: {regs} registers, {smem} bytes static smem; "
              f"at 256 threads a block {blocks} blocks an SM, occupancy "
              f"{occ:.3f}")
        fn = None
    elif "spill" in line and fn and ("sky" in fn.lower() or "resolve" in fn):
        print("  ", line.strip())

cuobjdump = shutil.which("cuobjdump") or os.path.join(
    os.path.dirname(_cuda._nvcc()), "cuobjdump")
sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                      text=True).stdout
funcs = {}
name = None
for line in sass.splitlines():
    m = re.search(r"Function : (\S+)", line)
    if m:
        name = m.group(1)
        funcs[name] = []
        continue
    m = re.match(r"\s*/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)",
                 line)
    if m and name:
        funcs[name].append(m.group(1).split(".")[0])
if args.sass:
    with open(args.sass, "w") as fh:
        fh.write(sass)
for name, ops in funcs.items():
    if "sky" not in name.lower() and "resolve" not in name:
        continue
    hist = {}
    for op in ops:
        hist[op] = hist.get(op, 0) + 1
    top = sorted(hist.items(), key=lambda kv: -kv[1])[:24]
    print(f"SASS {name}: {len(ops)} instructions; "
          + ", ".join(f"{k} {v}" for k, v in top), flush=True)

# ---- inputs ----
game = RasterSettings.game()
shading = int(game.shading)
evs = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
ballast = torch.ones((4096, 4096), device=dev)


def kernel_ms(fn, reps=10):
    fn()
    torch.cuda.synchronize()
    torch.matmul(ballast, ballast)
    evs[0].record()
    for _ in range(reps):
        fn()
    evs[1].record()
    torch.cuda.synchronize()
    return evs[0].elapsed_time(evs[1]) / reps


def inputs(sky_name):
    level = ts.open_air_level(L, S, sky_name)
    e = rollout.build_env(level, ts.textures(), ts.resolver, device=dev)
    rng = np.random.default_rng(1)
    acts = stp.Actions(**{k: torch.from_numpy(v).to(dev)
                          for k, v in ts.actions_np(rng, N).items()})
    states = rollout.initial_states(level, ts.spawn_point(level), N,
                                    device=dev)
    states = stp.tick(states, e.grid, e.params, acts, 1.0 / 60.0)
    cams = stp.character_camera(states, e.params)
    scal = sky_ops.prep_sky_scal(e.sky, cams, W, H)
    surf = scene_flat.build_surfaces_flat(e.flat, cams, game, W, H)
    prep = rb.prep_instance(surf, e.flat.atlas, W, H)
    planes = _cuda.raster_visibility(prep, e.flat.atlas, H, W)
    return e, scal, prep, planes


def face_stats(sky, scal):
    """Mountain faces whose box holds a pixel centre of a tile."""
    nf = sky.face_table.shape[0]
    box = [scal[:, r, :nf] for r in (sky_ops.R_XMIN, sky_ops.R_XMAX,
                                     sky_ops.R_YMIN, sky_ops.R_YMAX)]
    valid = box[2] <= box[3]
    print(f"  valid faces per instance: mean "
          f"{float(valid.sum(1).float().mean()):.2f} of {nf}")
    for th, tw in ((16, 16), (8, 32), (16, 32), (4, 64), (8, 16), (32, 8)):
        y0 = torch.arange(0, H, th, device=dev, dtype=torch.float32)
        x0 = torch.arange(0, W, tw, device=dev, dtype=torch.float32)
        y1 = torch.clamp(y0 + th, max=H) - 1.0
        x1 = torch.clamp(x0 + tw, max=W) - 1.0
        hy = ((box[3][:, None] >= y0[None, :, None] + 0.5)
              & (box[2][:, None] <= y1[None, :, None] + 0.5))
        hx = ((box[1][:, None] >= x0[None, :, None] + 0.5)
              & (box[0][:, None] <= x1[None, :, None] + 0.5))
        c = torch.einsum("iyf,ixf->iyx", hy.float(), hx.float())
        print(f"  tile {tw}x{th}: faces per tile mean "
              f"{float(c.mean()):.3f}, max {int(c.max())}, tiles with none "
              f"{float((c == 0).float().mean()):.3f}")
    # the first port: a block of 256 consecutive pixels stages the faces
    # whose box reaches its rows, and every pixel tests each of them
    first = torch.arange(0, H * W, 256, device=dev)
    ylo = (first // W).float() + 0.5
    yhi = ((first + 256).clamp(max=H * W) - 1) // W
    hy = ((box[3][:, None] >= ylo[None, :, None])
          & (box[2][:, None] <= yhi.float()[None, :, None] + 0.5))
    print(f"  256-pixel blocks (rows only): faces per block mean "
          f"{float(hy.sum(-1).float().mean()):.3f}, max "
          f"{int(hy.sum(-1).max())}")


def feature_shares(sky, scal, shows=None):
    """Share of the sphere's pixels (no mountain covers them) inside each
    feature's range, over the first 128 instances."""
    k = sky_ops.sky_consts(sky.skybox)
    r = sky_ops.ray_consts(W, H)
    n = 128
    sc = scal[:n]
    free = ~sky_ops.mountain_mask(sky, sc, H, W)
    xi = torch.arange(W, device=dev, dtype=torch.float32)[None, None]
    yi = torch.arange(H, device=dev, dtype=torch.float32)[None, :, None]
    ndc_x = (xi + 0.5 - r["half_w"]) / r["vs"] / r["usq"]
    ndc_y = (yi + 0.5 - r["half_h"]) / r["vs"] / r["usq"]
    norm = torch.sqrt(ndc_x * ndc_x + ndc_y * ndc_y + 1.0)
    b = [sc[:, sky_ops.R_BASIS, j][:, None, None] for j in range(9)]
    cx, cy, cz = ndc_x / norm, ndc_y / norm, 1.0 / norm
    wx = cx * b[0] + cy * b[3] + cz * b[6]
    wy = cx * b[1] + cy * b[4] + cz * b[7]
    wz = cx * b[2] + cy * b[5] + cz * b[8]
    v = torch.acos(wy.clamp(-1, 1)) / np.pi
    hz = k["horizon"]
    tot = float(free.sum())
    out = {"sphere share of plane": tot / free.numel()}
    if k["tint_enabled"]:
        out["tint |v-hz|<0.3"] = float(((v - hz).abs() < 0.3)[free].sum()) \
            / tot
    if k["haze_enabled"]:
        out["haze"] = float(((v - hz).abs() < k["haze_extent"])[free]
                            .sum()) / tot
    for j, body in enumerate(k["body"]):
        if body["enabled"]:
            cosd = wx * body["dx"] + wy * body["dy"] + wz * body["dz"]
            out[f"body {j} gate"] = float((cosd > body["cos_gate"])[free]
                                          .sum()) / tot
    for j, layer in enumerate(k["cloud"]):
        if layer["enabled"]:
            inside = (v >= layer["vmin"]) & (v <= layer["vmax"])
            out[f"cloud {j} band"] = float(inside[free].sum()) / tot
    print("  " + ", ".join(f"{a} {b:.4f}" for a, b in out.items()))


def gradient_only(sky):
    """`sky` with every sphere feature but the gradient off."""
    sb = sky.skybox

    def off(x):
        return dataclasses.replace(x, enabled=False)
    return sky._replace(skybox=dataclasses.replace(
        sb, sun=off(sb.sun), moon=off(sb.moon), cloud_layers=[],
        horizon_haze=off(sb.horizon_haze), horizontal_tint_enabled=False))


skies = {name: inputs(name) for name in ("night", "sunset")}
for sky_name, (e, scal, prep, planes) in skies.items():
    sky = e.sky
    print(f"{sky_name} sky: {sky.face_table.shape[0]} mountain faces",
          flush=True)
    face_stats(sky, scal)
    feature_shares(sky, scal)
    bare = sky._replace(face_table=sky.face_table[:0])
    atlas = e.flat.atlas
    t = {}
    for label, sk in (("as it is", sky), ("no mountain faces", bare),
                      ("gradient only", gradient_only(sky)),
                      ("gradient only, no mountain faces",
                       gradient_only(bare))):
        t[f"raster_sky {label}"] = kernel_ms(
            lambda sk=sk: _cuda.raster_sky(sk, scal, H, W))
        t[f"fused resolve {label}"] = kernel_ms(
            lambda sk=sk: _cuda.raster_resolve(
                prep, atlas, *planes[1:], shading,
                sky_ops.SkyBackground(sk, scal)))
    t["resolve over a constant word"] = kernel_ms(
        lambda: _cuda.raster_resolve(prep, atlas, *planes[1:], shading, 0))
    plane = torch.empty((N, H, W), dtype=torch.int32, device=dev)
    t["fill_ of the plane (stores alone)"] = kernel_ms(lambda: plane.fill_(7))
    drawn = float((planes[1] >= 0).float().mean())
    print(f"  {sky_name}: share of pixels a face won {drawn:.3f}")
    for label, ms in t.items():
        print(f"  {sky_name}: {label} {ms:.3f} ms (N={N} {W}x{H})",
              flush=True)


# ---- the sky tile shape: build each, check it, time it ----
def check_shape(h, w):
    """Differing elements of the kernels against the plain versions at
    N=8: tile faces, mountain pixels, sky pixels beyond one step, fused
    route against the plane route."""
    bad = {}
    for sky_name, (e, scal, prep, planes) in skies.items():
        cams_scal = sky_ops.prep_sky_scal(e.sky, cams_of[sky_name], w, h)
        plane, words = _cuda.raster_sky(e.sky, cams_scal, h, w,
                                         want_tiles=True)
        twin = sky_ops.sky_plane_ref(e.sky, cams_scal, h, w)
        mtn = sky_ops.mountain_mask(e.sky, cams_scal, h, w)
        sprep = small_prep[sky_name, h, w]
        vis = _cuda.raster_visibility(sprep, e.flat.atlas, h, w)
        fused = _cuda.raster_resolve(sprep, e.flat.atlas, *vis[1:], shading,
                                     sky_ops.SkyBackground(e.sky, cams_scal))
        over = _cuda.raster_resolve(sprep, e.flat.atlas, *vis[1:], shading,
                                    plane)
        torch.cuda.synchronize()
        step = torch.zeros(plane.shape, dtype=torch.int64, device=dev)
        for sh in (0, 8, 16):
            step = torch.maximum(step, (((plane >> sh) & 255).long()
                                        - ((twin >> sh) & 255).long()).abs())
        bad[f"{sky_name} words"] = int((words != sky_ops.sky_tile_faces_ref(
            e.sky, cams_scal, h, w)).sum())
        bad[f"{sky_name} mountain"] = int((plane[mtn] != twin[mtn]).sum())
        bad[f"{sky_name} beyond one step"] = int((step > 1).sum())
        bad[f"{sky_name} fused vs plane"] = int((fused != over).sum())
    return bad


if args.tiles:
    cams_of, small_prep = {}, {}
    for sky_name, (e, scal, prep, planes) in skies.items():
        level = ts.open_air_level(L, S, sky_name)
        rng = np.random.default_rng(1)
        acts = stp.Actions(**{k: torch.from_numpy(v).to(dev)
                              for k, v in ts.actions_np(rng, 8).items()})
        st = rollout.initial_states(level, ts.spawn_point(level), 8,
                                    device=dev)
        st = stp.tick(st, e.grid, e.params, acts, 1.0 / 60.0)
        cams_of[sky_name] = stp.character_camera(st, e.params)
        for h, w in ((H, W), (100, 150)):
            surf = scene_flat.build_surfaces_flat(
                e.flat, cams_of[sky_name], game, w, h)
            small_prep[sky_name, h, w] = rb.prep_instance(surf, e.flat.atlas,
                                                          w, h)
    shapes = [tuple(int(v) for v in (a + "x1").split("x")[:3])
              for a in args.tiles]
    source, tile = _cuda.SOURCES["raster"], (sky_ops.SKY_TILE_W,
                                             sky_ops.SKY_TILE_H)
    copy_dir = _cuda.BUILD_DIR.parent / "sky_probes"
    copy_dir.mkdir(parents=True, exist_ok=True)
    procs, paths = {}, {}
    for tw, th, rows in shapes:
        old = "constexpr int SKY_THREAD_ROWS = 2;"
        text = source.read_text()
        if old not in text:
            raise RuntimeError(f"{old!r} not found")
        paths[tw, th, rows] = copy_dir / f"raster_tile_{tw}x{th}x{rows}.cu"
        paths[tw, th, rows].write_text(text.replace(
            old, f"constexpr int SKY_THREAD_ROWS = {rows};"))
        _cuda.SOURCES["raster"] = paths[tw, th, rows]
        sky_ops.SKY_TILE_W, sky_ops.SKY_TILE_H = tw, th
        procs[tw, th, rows] = subprocess.Popen(
            [_cuda._nvcc(), *_cuda.nvcc_flags(), "-Xptxas", "-v", "-o",
             str(_cuda.library_path("raster")), str(paths[tw, th, rows])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for shape, proc in procs.items():
        log = proc.communicate()[0]
        regs = [ln.strip() for ln in log.splitlines() if "Used" in ln]
        print(f"tile {shape[0]}x{shape[1]}, {shape[2]} rows a thread: nvcc "
              f"rc {proc.returncode}; " + " | ".join(regs[-3:]))
        if proc.returncode != 0:
            print(log[-3000:])
    for tw, th, rows in shapes:
        if procs[tw, th, rows].returncode != 0:
            continue
        _cuda.SOURCES["raster"] = paths[tw, th, rows]
        sky_ops.SKY_TILE_W, sky_ops.SKY_TILE_H = tw, th
        _cuda._libs.clear()
        bad = {**check_shape(H, W),
               **{f"{k}, 150x100": v for k, v in check_shape(100, 150)
                  .items()}}
        t = {}
        for sky_name, (e, scal, prep, planes) in skies.items():
            t[f"raster_sky {sky_name}"] = kernel_ms(
                lambda e=e, scal=scal: _cuda.raster_sky(e.sky, scal, H, W))
            t[f"fused resolve {sky_name}"] = kernel_ms(
                lambda e=e, scal=scal, prep=prep, planes=planes:
                _cuda.raster_resolve(prep, e.flat.atlas, *planes[1:],
                                     shading,
                                     sky_ops.SkyBackground(e.sky, scal)))
        print(f"tile {tw}x{th}, {rows} rows a thread: check "
              + ("all 0" if not any(bad.values()) else f"DIFFERS {bad}")
              + "; ms: " + ", ".join(f"{k} {v:.3f}" for k, v in t.items()),
              flush=True)
    _cuda.SOURCES["raster"] = source
    sky_ops.SKY_TILE_W, sky_ops.SKY_TILE_H = tile
    _cuda._libs.clear()


# ---- probes: where the sphere's time goes ----
PROBES = {
    "registers left to the compiler (exact)": [(
        "constexpr int SKY_MIN_BLOCKS = 2048 / SKY_THREADS;",
        "constexpr int SKY_MIN_BLOCKS = 1;")],
    "view ray by one rsqrt": [(
        "const float norm = sqrtf((ndc_x * ndc_x + ndc_y * ndc_y) + 1.0f);\n"
        "  const float cx = ndc_x / norm, cy = ndc_y / norm, cz = 1.0f / norm;",
        "const float cz = rsqrtf((ndc_x * ndc_x + ndc_y * ndc_y) + 1.0f);\n"
        "  const float cx = ndc_x * cz, cy = ndc_y * cz;")],
    "acos by a subtraction": [(
        "const float phi = acosf(clipf(wy, -1.0f, 1.0f));",
        "const float phi = 1.5707964f - clipf(wy, -1.0f, 1.0f);")],
    "gradient divides by multiplies": [
        ("const float v = phi / PI_F;", "const float v = phi * 0.31830987f;"),
        ("? (P.has_above ? v / P.above_div : 0.0f)",
         "? (P.has_above ? v * P.above_div : 0.0f)"),
        (": (P.has_below ? (v - hz) / P.below_div : 1.0f);",
         ": (P.has_below ? (v - hz) * P.below_div : 1.0f);")],
    "no sphere": [(
        "word[k] = sky_sphere(P, sh, tx, row0 + k);",
        "word[k] = (255 << 24) | tx;")],
}

if args.probes:
    base_src = _cuda.SOURCES["raster"].read_text()
    probe_dir = _cuda.BUILD_DIR.parent / "sky_probes"
    probe_dir.mkdir(parents=True, exist_ok=True)
    paths = {}
    for i, (label, subs) in enumerate([("as it is", [])]
                                      + list(PROBES.items())):
        src = base_src
        for old, new in subs:
            if old not in src:
                raise RuntimeError(f"probe {label!r}: {old!r} not found")
            src = src.replace(old, new)
        paths[label] = probe_dir / f"raster_probe{i}.cu"
        paths[label].write_text(src)
    procs = {}
    for label, path in paths.items():
        _cuda.SOURCES["raster"] = path
        procs[label] = subprocess.Popen(
            [_cuda._nvcc(), *_cuda.nvcc_flags(), "-Xptxas", "-v", "-o",
             str(_cuda.library_path("raster")), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for label, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            print(f"probe {label}: nvcc failed\n{log[-2000:]}")
    probe_ref = {}
    for label, path in paths.items():
        if procs[label].returncode != 0:
            continue
        _cuda.SOURCES["raster"] = path
        _cuda._libs.clear()
        t = {}
        diff = {}
        for sky_name, (e, scal, prep, planes) in skies.items():
            bare = e.sky._replace(face_table=e.sky.face_table[:0])
            out = (_cuda.raster_sky(e.sky, scal, H, W),
                   _cuda.raster_resolve(prep, e.flat.atlas, *planes[1:],
                                        shading,
                                        sky_ops.SkyBackground(e.sky, scal)))
            first = probe_ref.setdefault(sky_name, out)
            diff[sky_name] = [int((a != b).sum()) for a, b in zip(out, first)]
            t[f"{sky_name} fused resolve"] = kernel_ms(
                lambda e=e, scal=scal, prep=prep, planes=planes:
                _cuda.raster_resolve(prep, e.flat.atlas, *planes[1:],
                                     shading,
                                     sky_ops.SkyBackground(e.sky, scal)))
            t[f"{sky_name} as it is"] = kernel_ms(
                lambda e=e, scal=scal: _cuda.raster_sky(e.sky, scal, H, W))
            t[f"{sky_name} no mountain faces"] = kernel_ms(
                lambda b=bare, scal=scal: _cuda.raster_sky(b, scal, H, W))
            t[f"{sky_name} gradient only, no mountain faces"] = kernel_ms(
                lambda g=gradient_only(bare), scal=scal: _cuda.raster_sky(
                    g, scal, H, W))
        print(f"probe {label}: pixels differing from the kernel as it is "
              f"(plane, fused) {diff}; ms: "
              + ", ".join(f"{k} {v:.3f}" for k, v in t.items()), flush=True)
        del out
