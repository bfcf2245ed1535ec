#!/usr/bin/env python3
"""GPU smoke run of the PyTorch + CUDA port (bonnie32_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card, nvcc and this checkout; imports nothing of jax or of
the JAX package.  In order:

  1. prints the card's name and power limit (nvidia-smi) and builds the
     CUDA kernels of bonnie32_tpu_torch/csrc/raster.cu, gather.cu and
     audio.cu from source into build/torch_kernels/ (one nvcc each,
     started together, sm_90a), printing ptxas' register report;
  2. builds the Cave-size level of tests/torch_scenes.py in code, its
     transparent variant (20 faces glazed with every PS1 blend mode), the
     same room with a two-part asset placed twice (lit by its Light
     components), and the open-air level and its transparent variant
     under the night sky and the two-range sunset sky;
  3. kernel vs plain: N=8 instances at 320x240 after one tick — on the
     opaque level the visibility + resolve kernels, on the transparent
     level the composite kernel in z-buffer and x-ray mode and the
     painter's visibility, each against its plain torch twin on the same
     inputs: 0 differing pixels in colour, depth, winner and barycentric
     planes; keyed faces present; every non-opaque blend mode draws.
     The same kernels once more at 150x100, which no tile shape divides
     (ragged right and bottom tiles).  The perspective-UV instantiations
     (affine_textures off) of the visibility (z-buffer and painter's),
     resolve (word and sky-fused) and composite (z-buffer, painter's,
     x-ray) kernels against their twins, 0 differing pixels, each frame
     also different from the affine kernels'.  The binning (`raster_bin`, which
     the visibility and composite wrappers launch first): its mask words
     against `tile_bins_ref`, exact, for the kept faces in z-buffer and in
     painter's order, the transparent list and the x-ray list, and its
     work list, as a set, against the tiles with any bit.
     The sky (TPU kernel K5), for the night and the sunset sky, at
     320x240 and at 150x100: `raster_sky` and `raster_resolve` with the
     sky behind the faces against `sky_plane_ref` / `resolve_ref` in three
     pixel classes — pixels a face drew and pixels a mountain covers
     exact, the other sky pixels within one 8-bit step, their share
     printed (acos, atan2, sin and pow differ by ulps between nvcc's and
     torch's libraries); sky, mountain and star pixels must all occur;
     the two routes equal each other; the mountain faces each sky tile
     staged equal `sky_tile_faces_ref`.  The gather (K7):
     `select_gather` on a 32,768-entry table and N_MAIN x 240 x 320
     indices, some out of range on both sides, i32 and f32, 0 differing
     elements against its twin;
  4. main paths: rollout.step_and_render at N=1024, 320x240, with
     numpy-seeded actions — the opaque level (WARMUP + FRAMES frames),
     the transparent level (the same), then x-ray and painter's mode on
     the transparent level (1 + MODE_FRAMES frames each); then the sky:
     the open-air level under the night sky (in-kernel route: one
     visibility and one sky-fused resolve a frame, no `raster_sky`), its
     transparent variant (sky-buffer route: `raster_sky`, visibility,
     resolve over the plane, composite), and x-ray and painter's over the
     sunset sky; then perspective UVs on the transparent level (z-buffer,
     painter's, x-ray) and on the open-air night level (the sky-fused
     resolve), the editor's default settings (backface wires) on the
     Cave-size level, the wireframe overlay alone on the transparent
     level (no kernel), and the level with the placed assets.  The launch
     counters are reset just before each counted run and read just
     after.  Checks one launch per frame of each kernel
     the path routes through (and one `raster_bin` per visibility and per
     composite launch) and none of the others, finite states,
     >= 25% coverage in every instance's last frame (0.5% for the
     overlay's edges), distinct instances,
     and that the last frame of 8 instances equals the plain render (over
     a sky: in the pixel classes above, with one RGB555 step allowed
     where a blended face lies over a sky pixel that is one step off);
  5. times (CUDA events) the frames, the stages of the opaque, the
     transparent, the open-air, the editor (the wireframe pass a stage of
     its own), the overlay and the asset frames on a replay of the same
     frames (the second of two
     replays, so that no stage pays for the allocator's growth), and each
     kernel beside its plain twin at the main path's shapes, with the bound
     (the least time the card could take: bytes over 3.35 TB/s or f32
     operations over 33.5e12 instructions/s, whichever is larger; the
     operation-bound rows also at the FMA rate of 67e12 that counts a
     fused multiply-add twice); `select_gather` also beside `torch.take`,
     the one PyTorch call that computes it.  The sky also without its
     mountain faces and with the gradient alone, and the mean and maximum
     number of mountain faces a sky tile stages.
     A visibility or composite time is that of everything its wrapper
     launches (`raster_bin` + the consumer); `raster_bin` alone is timed
     behind a long matrix product, so that its launches are queued before
     the first runs and the time is the card's, not the host's.  Prints
     the live entries per instance and the mean and maximum number of
     entries per tile of each list;
  6. the sequential renderer (`run_sequential`) and the game's play path
     (`run_play`: a level saved and loaded through the native RON parser,
     GameToolState with scripted gamepad input, render_game_view at three
     sizes in RGB555 and 8-bit, the 8-bit render_level, the exact sky
     mesh and the ECS systems, each against the CPU), with their times;
  7. the editor and modeler viewports (`run_editor`: the world editor's
     3-D view with its overlays on three levels at two sizes, the player
     camera preview, UiContext.paint with every command kind and icons,
     the modeler's four panes composited and painted, the skeleton
     overlay, the asset preview, and picking), each card = CPU with 0
     differing pixels or values, with their times;
  8. the tracker's audio path (`run_audio`): the SPU reverb
     (`spu_reverb`) and the Gaussian resampler (`spu_resample`) of
     csrc/audio.cu against their twins on every preset and pitch (the
     reverb also on all ten presets from pre-filled buffers across the
     wrap, the resampler on short calls and across pitch changes), a 32 s
     8-channel song rendered by `render_song` and streamed by
     `AudioStream.render_audio` (60 Hz and ragged deltas), bit for bit,
     through the oscillators and through a SoundFont, and their times,
     with the reverb's bound seeing its serial chain;
  9. the datagen fleet's surroundings (`run_fleet`): the port's
     `entry.entry` card vs CPU, the instance-sharded step
     (`parallel.mesh`) at N=1024 over every card and over the card named
     four times equal to the unsharded step bit for bit (each shard
     launching `raster_bin`, visibility and resolve), `raster_stats`
     card vs CPU, a checkpoint of the states resumed bit for bit, the
     kernel route's idle share under `profiling.trace`, and the debug
     overlay, menu and controller view card vs CPU, with their times;
 10. the rest of the UI, storage and the texture import path (`run_ui`):
     a frame of every widget, panel and an open radial menu painted by
     UiContext.paint over a 640x480 editor view, the text input and the
     landing page drawn into it, card vs CPU with 0 differing words and no
     kernel launched; the drag tracker's pickers with the camera on the
     card against the CPU; a seeded image imported (resized to 64x64,
     quantized at 4 and 8 bpp) as the Cave-size level's floor texture and
     drawn by `entry.entry` at N=64 (K1-K3 launched once, card = CPU); a
     checkpoint of 64 states through storage/ (local files, the in-memory
     cloud, the cloud over a fake HTTP API on 127.0.0.1), each route also
     through async_ops, restored on the card bit for bit, and the
     1,024-state checkpoint refused by the cloud; with their times.

ptxas' register count of every kernel instantiation is printed as one
JSON object after the build.  The last two lines of standard output are
one JSON object with the kernels' measurements (the perspective
instantiations as rows of their own), then {"ok": true, "device":
{...}}.  Any failed
check raises, so the exit code is not 0 and no result line is printed.
"""

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import time

N_MAIN = 1024
N_CHECK = 8
HEIGHT, WIDTH = 240, 320
FRAMES = 6
WARMUP = 2             # untimed main-path frames before the counted run
MODE_FRAMES = 3        # counted x-ray and painter's frames
SEED = 0
PLAIN_CHUNK = 128      # instances per plain-twin call when timing at N_MAIN
RAGGED = (100, 150)    # a frame (rows, columns) that no tile shape divides
N_SEQ = 128            # the sequential renderer's batch: one instance chunk
SEQ_FRAMES = 3         # timed sequential frames at N=1 (1 at N_SEQ)
PLAY_FRAMES = 6        # scripted gamepad frames before the game views
N_PLAY8 = 128          # the 8-bit pipeline's batch
N_SKY_EXACT = 8        # the exact sky mesh walk's batch
N_ECS = 1024           # instances of the ECS systems
ECS_CAPACITY = 16      # entity slots an instance
N_TICK_DRIFT = 64      # instances of the card-vs-CPU tick check
TICK_DRIFT_FRAMES = 300
EDITOR_SIZES = ((640, 480), (320, 240))   # the editor view's sizes
N_PICK_RAYS = 64       # seeded rays of the pick_triangle check
AUDIO_STREAMS = 8      # seeded streams a preset / pitch, kernel vs twin
AUDIO_CHECK = 1024     # samples a reverb call, kernel vs twin (two calls)
RESAMPLE_CHECK = 2048  # samples a pitch, kernel vs twin (two calls)
# the real-size song: 8 channels, 4 x 64 rows at 120 bpm and 4 rows a
# beat (32 s), HALL at wet 80, channel 0 at 22 kHz (the resampler runs)
AUDIO_SONG = dict(patterns=4, rows=64, channels=8, bpm=120, reverb=5,
                  wet=80, rate0=2)
AUDIO_FONT_CHANNEL = 1  # the channel the SoundFont render keeps
AUDIO_FRAMES = 121     # render_audio(1/60) calls timed (first not counted)
AUDIO_CHUNK = 4096     # samples a kernel call in the S=1 / S=64 times
AUDIO_WIDE = 64        # streams of the wide kernel time
AUDIO_REPS = 5         # timed kernel calls
WRAP_STREAMS = 64      # streams of the reverb check across the wrap
WRAP_LENGTHS = (1, 37, 735, 4096)   # its calls, the state carried
N_ENTRY = 4            # instances of the entry point, card vs CPU
N_FLEET = 1024         # instances of the sharded step, resume and trace
FLEET_FRAMES = 3       # chained frames of the sharded step and the resume
FLEET_SHARDS = 4       # entries of the mesh naming the card several times
TRACE_FRAMES = 5       # frames under torch.profiler
UI_REPS = 5            # timed UI paints / draws / storage round trips
N_IMPORT = 64          # instances drawing the imported floor texture
N_STORE = 64           # states of the checkpoint sent through storage/
N_STORE_BIG = 1024     # states of the checkpoint the cloud must refuse
DRAG_SEEDS = 3         # seeded cameras of the drag tracker's check
ANGLE_TOL = 1e-5       # rad: the card's atan2 vs the CPU's (drag tracker)
CHAIN_IIR = 8          # the IIR's dependent integer instructions a 2 ticks
CHAIN_ACCUM = 3        # the accumulator's a sample: add, compare, subtract
CHAIN_CYCLES = 4       # cycles a dependent instruction

# The card's peaks (NVIDIA H100 SXM, at its 700 W limit).  The f32 rate
# is that of uncontracted instructions: 132 SMs x 128 lanes x 1.98 GHz.
# The kernels are built with -fmad=false, so each add or multiply counted
# below is one instruction; the data sheet's 67 TFLOP/s counts a fused
# multiply-add as two operations (F32_FMA_OPS_S, printed once beside).
HBM_BYTES_S = 3.35e12
F32_OPS_S = 33.5e12
F32_FMA_OPS_S = 67e12
# f32 operations per pixel, counted from the kernels' expressions: the
# edge functions, barycentrics, coverage compares and interpolated 1/z of
# one face at one pixel of its clipped bbox; the pixel pipeline of one
# drawn pixel (UV, fetch, 3-channel modulate, shade, dither/quantize).
# The bound counts the coverage test on every bbox pixel of every live
# face and the pipeline once per pixel the kernel wrote: the least work
# this run's data needs (keyed UVs and overdraw not counted).
OPS_COVER = 20
OPS_PIPELINE = 80
# Perspective-correct UVs on top of the affine pipeline, per drawn pixel:
# u/z and v/z (12 multiplies, 4 adds) and the select of the divisor, two
# divides counted as one operation each, less the affine UV's 10; resolve
# also interpolates the winner's 1/z (5), which OPS_COVER already counts
# for the composites.
OPS_PERSPECTIVE = 9
OPS_IZI = 5
# The sky, per pixel it shows on and no mountain covers: the view ray
# (a square root, three divides, nine multiplies and six adds; the
# column's and row's terms are per tile), acos, the gradient's divide,
# clamp and three-channel lerp, and each enabled body's dot product and
# gate.  Then, on the pixels this run's data needs them (counted from the
# rays of the plain version): the azimuth (atan2) where the tint or a
# cloud layer reads it, the tint within its horizon range and spread, the
# haze within its extent, a body's acos, pow and lerps within its glow, a
# cloud layer's six sines inside its band and its pow where the noise
# reaches the threshold.  Each acos, atan2 or sine counted as 20
# operations and each pow as 40; a mountain face's barycentrics,
# compares and colour at each pixel of its clipped bbox.
OPS_TRANSCENDENTAL = 20
OPS_POW = 40
OPS_SKY_RAY = 28
OPS_SKY_GRADIENT = 18
OPS_SKY_TINT = 28
OPS_SKY_HAZE = 22
OPS_SKY_BODY_GATE = 6
OPS_SKY_GLOW = OPS_TRANSCENDENTAL + OPS_POW + 30
OPS_SKY_CLOUD_NOISE = 6 * OPS_TRANSCENDENTAL + 20
OPS_SKY_CLOUD_POW = OPS_POW + 20
OPS_SKY_FACE = 25
GATHER_TABLE = 32768   # "<= 32k entries", the JAX module's own size

SRC = "bonnie32_tpu_torch/csrc/raster.cu"
GATHER_SRC = "bonnie32_tpu_torch/csrc/gather.cu"
JAX_RB = "bonnie32_tpu/ops/raster_batch.py"
JAX_GATHER = "bonnie32_tpu/ops/gather_pallas.py"
AUDIO_SRC = "bonnie32_tpu_torch/csrc/audio.cu"
JAX_AUDIO = "bonnie32_tpu/audio"
BLEND_NAMES = ("OPAQUE", "AVERAGE", "ADD", "SUBTRACT", "ADD_QUARTER",
               "ERASE")


def _fail(msg):
    raise RuntimeError(f"chip_smoke: {msg}")


def ptxas_registers(log):
    """{kernel: registers} from nvcc's -Xptxas -v report, the names
    demangled by c++filt where it exists, argument lists dropped."""
    regs, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = m.group(1)
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None:
            regs[entry] = int(m.group(1))
            entry = None
    try:
        names = subprocess.run(["c++filt"], input="\n".join(regs),
                               capture_output=True, text=True,
                               check=True).stdout.splitlines()
    except (OSError, subprocess.CalledProcessError):
        names = list(regs)
    if len(names) != len(regs):
        names = list(regs)
    return {n.replace("(anonymous namespace)::", "").split("(")[0]: r
            for n, r in zip(names, regs.values())}


def main():
    import torch

    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is false: no CUDA card")
    run(torch.device("cuda", 0))


def channel_step(a, b):
    """Per pixel the largest difference of a channel between two planes
    of packed RGBA8 words (torch tensors of one shape, on one device)."""
    import torch
    step = torch.zeros(a.shape, dtype=torch.int64, device=a.device)
    for sh in (0, 8, 16, 24):
        step = torch.maximum(step, (((a >> sh) & 255).long()
                                    - ((b >> sh) & 255).long()).abs())
    return step


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
    from bonnie32_tpu_torch.audio import resampler as rsp
    from bonnie32_tpu_torch.audio import reverb as rvb
    from bonnie32_tpu_torch.config import RasterSettings
    from bonnie32_tpu_torch.game import step as stp
    from bonnie32_tpu_torch.models import asset as A
    from bonnie32_tpu_torch.models import level as L
    from bonnie32_tpu_torch.models import mesh as M
    from bonnie32_tpu_torch.models import scene
    from bonnie32_tpu_torch.models import user_texture as U
    from bonnie32_tpu_torch.models import scene_flat
    from bonnie32_tpu_torch.models import skybox as S
    from bonnie32_tpu_torch.ops import _cuda
    from bonnie32_tpu_torch.ops import gather as tg
    from bonnie32_tpu_torch.ops import raster_batch as rb
    from bonnie32_tpu_torch.ops import skybox as sky_ops
    from bonnie32_tpu_torch.ops import wireframe as wf

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    card = f"[{smi}]"
    print(f"card: {smi}")
    t_start = time.perf_counter()

    def phase_done(name):
        print(f"[{time.perf_counter() - t_start:7.1f} s] {name} done",
              flush=True)

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as build_log:
        _cuda.build(verbose=True)
    print(build_log.getvalue())
    print(f"kernel build (nvcc, sm_90a): "
          f"{time.perf_counter() - t0:.2f} s {card}")
    registers = ptxas_registers(build_log.getvalue())
    print("registers (ptxas): " + json.dumps(registers))

    game = RasterSettings.game()
    xray = dataclasses.replace(game, xray_mode=True)
    painters = dataclasses.replace(game, use_zbuffer=False)
    persp = dataclasses.replace(game, affine_textures=False)
    persp_xray = dataclasses.replace(xray, affine_textures=False)
    persp_painters = dataclasses.replace(painters, affine_textures=False)
    editor = RasterSettings()               # backface wires, the default
    overlay = RasterSettings(wireframe_overlay=True)
    level = ts.cave_size_level(L)
    env = rollout.build_env(level, ts.textures(), ts.resolver, device=dev)
    # the placed assets: two placements of a two-part asset, lit by its
    # Light components (point lights)
    alevel = ts.asset_level(L)
    alib = ts.asset_library(A, M)
    aenv = rollout.build_env(
        alevel, ts.textures(), ts.resolver,
        light_specs=scene.collect_scene_lights(alevel, alib),
        asset_library=alib, user_textures=ts.user_textures(U), device=dev)
    tlevel = ts.transparent_cave_level(L)
    tenv = rollout.build_env(tlevel, ts.transparent_textures(), ts.resolver,
                             device=dev)
    spawn = ts.spawn_point(level)
    print(f"level: {env.flat_static.n_faces} faces, "
          f"{env.flat_static.n_textures} textures; transparent variant: "
          f"{len(tenv.flat_static.transparent_idx)} transparent faces, "
          f"{tenv.flat_static.n_textures} textures")
    # the sky levels: night (in-kernel route; with transparent faces the
    # sky-buffer route) and the two-range sunset (x-ray, painter's)
    sky_envs = {}
    for sky_name in ("night", "sunset"):
        lv = ts.open_air_level(L, S, sky_name)
        tlv = ts.transparent_open_air_level(L, S, sky_name)
        sky_envs[sky_name] = (
            lv, rollout.build_env(lv, ts.textures(), ts.resolver,
                                  device=dev),
            tlv, rollout.build_env(tlv, ts.transparent_textures(),
                                   ts.resolver, device=dev))
    slevel, senv, stlevel, stenv = sky_envs["night"]
    print(f"asset level: {aenv.flat_static.n_faces} faces in "
          f"{aenv.flat_static.n_draw_groups} draw groups, "
          f"{aenv.flat_static.n_textures} textures, "
          f"{int(aenv.flat.lights.kind.ne(0).sum())} lights")
    print(f"open-air level: {senv.flat_static.n_faces} faces; night sky: "
          f"{senv.sky.face_table.shape[0]} mountain faces, "
          f"{senv.sky.star_dirs.shape[0]} stars; sunset sky: "
          f"{sky_envs['sunset'][1].sky.face_table.shape[0]} mountain faces")
    kernels = (_cuda.raster_visibility, _cuda.raster_resolve,
               _cuda.raster_composite, _cuda.raster_sky, tg.select_gather,
               _cuda.raster_bin, rvb.spu_reverb, rsp.spu_resample)

    def reset_counts():
        for k in kernels:
            k.launches = 0

    def read_counts():
        return {k.__name__: k.launches for k in kernels}

    def actions(rng, n):
        return stp.Actions(**{k: torch.from_numpy(v).to(dev)
                              for k, v in ts.actions_np(rng, n).items()})

    def surf_for(e, states, settings, hw=(HEIGHT, WIDTH)):
        cams = stp.character_camera(states, e.params)
        return scene_flat.build_surfaces_flat(e.flat, cams, settings, hw[1],
                                              hw[0])

    def prep_for(e, surf, settings, hw=(HEIGHT, WIDTH)):
        return rb.prep_instance(surf, e.flat.atlas, hw[1], hw[0],
                                painters=not settings.use_zbuffer,
                                group_id=e.flat.f_group)

    def drawn_mask(color_like, depth, t, p, atlas, mode, persp=False):
        """Pixels the composite of `t` draws: composited onto a plane of
        alpha 0 (whether a pixel draws does not depend on what lies under
        it), every drawn word has alpha 255."""
        c = rb.composite_ref(torch.zeros_like(color_like), depth, t, p,
                             atlas, shading, mode, perspective=persp)
        return ((c >> 24) & 255) == 255

    def plain_render(e, states, settings):
        """The frame of `states` through the plain twins only, routed as
        rollout.render_cameras routes.  Returns (colour, classes): over a
        sky, `classes` holds the masks `face` (an opaque face drew),
        `mtn` (a mountain covers), `blended` (the composite drew) and the
        number of star pixels; without a sky it is None.  The wireframe
        passes are torch code, the same on both sides: here they show
        that the frame routes them (after every solid pass, against its
        depth plane; alone on a cleared frame in overlay mode)."""
        n = states.pos.shape[0]
        cams = stp.character_camera(states, e.params)
        if settings.wireframe_overlay:
            clear = torch.zeros((n, HEIGHT, WIDTH), dtype=torch.int32,
                                device=dev)
            return wf.render_wireframes_flat(
                clear, torch.zeros(clear.shape, device=dev), e.flat, cams,
                settings), None
        surf = surf_for(e, states, settings)
        atlas = e.flat.atlas
        mode = rb.composite_mode(settings)
        persp = not settings.affine_textures
        wires = settings.backface_cull and settings.backface_wireframe
        sky = e.sky
        plane = stars = mtn = None
        if sky is not None:
            scal = sky_ops.prep_sky_scal(sky, cams, WIDTH, HEIGHT)
            plane = sky_ops.sky_plane_ref(sky, scal, HEIGHT, WIDTH)
            mtn = sky_ops.mountain_mask(sky, scal, HEIGHT, WIDTH)
            in_kernel = sky_ops.sky_kernel_ok(sky, e.flat_static, settings)
            if sky.stars_enabled and not in_kernel:
                bare = plane
                plane = sky_ops.scatter_stars(plane, None, sky, cams,
                                              time=sky.time)
                stars = int((plane != bare).sum())
        if settings.xray_mode:
            color = (torch.zeros((n, HEIGHT, WIDTH), dtype=torch.int32,
                                 device=dev) if plane is None else plane)
            depth = torch.zeros(color.shape, device=dev)
            tr = rb.prep_xray(surf, e.flat.f_group, settings.use_zbuffer)
            tables = rb.face_tables(surf, atlas, WIDTH, HEIGHT)
            out = rb.composite_ref(color, depth, tr, tables, atlas, shading,
                                   mode, perspective=persp)
            if wires:
                out = wf.render_wireframes_flat(out, depth, e.flat, cams,
                                                settings)
            if sky is None:
                return out, None
            return out, dict(
                face=torch.zeros_like(mtn), mtn=mtn, stars=stars,
                blended=drawn_mask(color, depth, tr, tables, atlas, mode,
                                   persp))
        prep = prep_for(e, surf, settings)
        planes = rb.visibility_ref(prep, atlas, HEIGHT, WIDTH,
                                   painters=not settings.use_zbuffer,
                                   perspective=persp)
        color = rb.resolve_ref(prep, atlas, *planes[1:], shading, 0,
                               perspective=persp)
        face = color != 0          # a drawn word has alpha 255
        if sky is not None:
            color = torch.where(face, color, plane)
            if sky.stars_enabled and in_kernel:
                bare = color
                color = sky_ops.scatter_stars(color, planes[0], sky, cams,
                                              time=sky.time)
                stars = int((color != bare).sum())
        blended = torch.zeros_like(face)
        if e.flat_static.transparent_idx:
            tr = rb.prep_transparent(surf, e.flat_static.transparent_idx)
            if sky is not None:
                blended = drawn_mask(color, planes[0], tr, prep, atlas, mode,
                                     persp)
            color = rb.composite_ref(color, planes[0], tr, prep, atlas,
                                     shading, mode, perspective=persp)
        if wires:
            color = wf.render_wireframes_flat(color, planes[0], e.flat, cams,
                                              settings)
        if sky is None:
            return color, None
        return color, dict(face=face, mtn=mtn, stars=stars, blended=blended)

    def sky_classes(label, kern, plain, cls, blend_limit):
        """Hold a frame over a sky against its plain version by pixel
        class; returns the share of plain sky pixels one step off."""
        step = channel_step(kern, plain)
        face = cls["face"] & ~cls["blended"]
        mtn = cls["mtn"] & ~cls["face"] & ~cls["blended"]
        sky = ~cls["face"] & ~cls["mtn"] & ~cls["blended"]
        counts = dict(face=int(face.sum()), mountain=int(mtn.sum()),
                      sky=int(sky.sum()), blended=int(cls["blended"].sum()))
        bad = dict(face=int((step[face] > 0).sum()),
                   mountain=int((step[mtn] > 0).sum()),
                   sky_beyond_one_step=int((step[sky] > 1).sum()),
                   blended_beyond_limit=int(
                       (step[cls["blended"]] > blend_limit).sum()))
        off = int((step[sky] == 1).sum())
        share = off / max(counts["sky"], 1)
        print(f"{label}: pixels by class {counts}, star pixels "
              f"{cls['stars']}; differing {bad}; sky pixels one step off "
              f"{off} ({share:.6%}); blended pixels off "
              f"{int((step[cls['blended']] > 0).sum())} (limit "
              f"{blend_limit} a channel); sky share of the frame "
              f"{(counts['sky'] + counts['mountain']) / step.numel():.3f}")
        if any(bad.values()):
            _fail(f"{label}: disagrees with the plain version: {bad}")
        if counts["sky"] == 0 or counts["mountain"] == 0:
            _fail(f"{label}: no sky or no mountain pixel was drawn")
        return share

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

    phase_done("kernels vs plain, opaque and transparent level")

    # ---- the binning: raster_bin vs tile_bins_ref, and its work list ----
    def bin_lists(p, pp, t, xp, xt):
        """The four lists the wrappers bin: name -> (ctrl, list)."""
        return {"opaque": (p.ctrl, dict(order=p.order, count=p.count)),
                "painter's": (pp.ctrl, dict(order=pp.order, count=pp.count)),
                "transparent": (p.ctrl, dict(tctrl=t.tctrl)),
                "x-ray": (xp.ctrl, dict(tctrl=xt.tctrl))}

    def check_bins(lists, hw, label):
        bad = {}
        worst = 0
        for name, (ctrl, kw) in lists.items():
            bins, work, work_len = _cuda.raster_bin(ctrl, *hw,
                                                    want_work=True, **kw)
            want = rb.tile_bins_ref(ctrl, *hw, **kw)
            torch.cuda.synchronize()
            got = work[:int(work_len[0])].sort().values
            ref = rb.work_list_ref(want)
            bad[name] = int((bins != want).sum())
            bad[f"{name}, work list"] = int(
                got.numel() != ref.numel() or bool((got != ref).any()))
            if int(work_len[1]) != 0:
                _fail(f"raster_bin, {name}: the cursor is not zero")
            if not bool((want != 0).any()):
                _fail(f"raster_bin, {name}: no bit is set")
            worst = max(worst, int((bins.long() - want.long()).abs().max()))
        print(f"raster_bin vs plain, {label}, N={N_CHECK} {hw[1]}x{hw[0]}, "
              f"tiles {rb.TILE_W}x{rb.TILE_H}: differing words and work "
              f"lists {bad}")
        if any(bad.values()):
            _fail(f"raster_bin disagrees with tile_bins_ref: {bad}")
        return worst

    err["raster_bin"] = check_bins(
        bin_lists(tprep, pprep, tr, xprep, xtr), (HEIGHT, WIDTH),
        "transparent level")

    # ---- the same kernels on a frame with ragged right and bottom tiles ----
    r_prep = prep_for(env, surf_for(env, states, game, RAGGED), game, RAGGED)
    r_tsurf = surf_for(tenv, tstates, game, RAGGED)
    r_tprep = prep_for(tenv, r_tsurf, game, RAGGED)
    r_pprep = prep_for(tenv, r_tsurf, painters, RAGGED)
    r_tr = rb.prep_transparent(r_tsurf, tenv.flat_static.transparent_idx)
    r_xsurf = surf_for(tenv, tstates, xray, RAGGED)
    r_xprep = rb.face_tables(r_xsurf, tatlas, RAGGED[1], RAGGED[0])
    r_xtr = rb.prep_xray(r_xsurf, tenv.flat.f_group, True)
    err["raster_bin"] = max(err["raster_bin"], check_bins(
        bin_lists(r_tprep, r_pprep, r_tr, r_xprep, r_xtr), RAGGED,
        "transparent level"))
    rk = _cuda.raster_visibility(r_prep, atlas, *RAGGED)
    rp = rb.visibility_ref(r_prep, atlas, *RAGGED)
    rdiffs = differing(rk, rp, names)
    rdiffs["color"] = int((
        _cuda.raster_resolve(r_prep, atlas, *rk[1:], shading, 0)
        != rb.resolve_ref(r_prep, atlas, *rp[1:], shading, 0)).sum())
    r_opaque = _cuda.raster_visibility(r_tprep, tatlas, *RAGGED)
    r_base = _cuda.raster_resolve(r_tprep, tatlas, *r_opaque[1:], shading, 0)
    r_comp = _cuda.raster_composite(r_base.clone(), r_opaque[0], r_tr,
                                    r_tprep, tatlas, shading, ZBUF)
    rdiffs["composite color"] = int((r_comp != rb.composite_ref(
        r_base, r_opaque[0], r_tr, r_tprep, tatlas, shading, ZBUF)).sum())
    r_clear = torch.zeros_like(r_base)
    r_zero = torch.zeros_like(r_opaque[0])
    rdiffs["xray color"] = int((
        _cuda.raster_composite(r_clear.clone(), r_zero, r_xtr, r_xprep,
                               tatlas, shading, XRAY)
        != rb.composite_ref(r_clear, r_zero, r_xtr, r_xprep, tatlas,
                            shading, XRAY)).sum())
    rdiffs.update({f"painters {k}": v for k, v in differing(
        _cuda.raster_visibility(r_pprep, tatlas, *RAGGED, painters=True),
        rb.visibility_ref(r_pprep, tatlas, *RAGGED, painters=True),
        names).items()})
    torch.cuda.synchronize()
    print(f"kernel vs plain on a ragged frame, N={N_CHECK} "
          f"{RAGGED[1]}x{RAGGED[0]}: differing pixels {rdiffs}; the "
          f"composite changed {int((r_comp != r_base).sum())} pixels")
    if any(rdiffs.values()):
        _fail(f"kernels disagree with their twins on a ragged frame: "
              f"{rdiffs}")
    if not bool((r_comp != r_base).any()) or not bool((rk[1] >= 0).any()):
        _fail("nothing was drawn on the ragged frame")
    phase_done("raster_bin vs plain, kernels on a ragged frame")

    # ---- the perspective instantiations vs their twins, N_CHECK ----
    PAINT = rb.COMPOSITE_PAINTERS
    pk = _cuda.raster_visibility(tprep, tatlas, HEIGHT, WIDTH,
                                 perspective=True)
    pp = rb.visibility_ref(tprep, tatlas, HEIGHT, WIDTH, perspective=True)
    pkc = _cuda.raster_resolve(tprep, tatlas, *pk[1:], shading, 0,
                               perspective=True)
    ppc = rb.resolve_ref(tprep, tatlas, *pp[1:], shading, 0,
                         perspective=True)
    pkz = _cuda.raster_composite(pkc.clone(), pk[0], tr, tprep, tatlas,
                                 shading, ZBUF, perspective=True)
    ppz = rb.composite_ref(ppc, pp[0], tr, tprep, tatlas, shading, ZBUF,
                           perspective=True)
    qk = _cuda.raster_visibility(pprep, tatlas, HEIGHT, WIDTH, painters=True,
                                 perspective=True)
    qp = rb.visibility_ref(pprep, tatlas, HEIGHT, WIDTH, painters=True,
                           perspective=True)
    qkc = _cuda.raster_resolve(pprep, tatlas, *qk[1:], shading, 0,
                               perspective=True)
    qpc = rb.resolve_ref(pprep, tatlas, *qp[1:], shading, 0,
                         perspective=True)
    qkz = _cuda.raster_composite(qkc.clone(), qk[0], tr, pprep, tatlas,
                                 shading, PAINT, perspective=True)
    qpz = rb.composite_ref(qpc, qp[0], tr, pprep, tatlas, shading, PAINT,
                           perspective=True)
    pkx = _cuda.raster_composite(clear.clone(), zero_depth, xtr, xprep,
                                 tatlas, shading, XRAY, perspective=True)
    ppx = rb.composite_ref(clear, zero_depth, xtr, xprep, tatlas, shading,
                           XRAY, perspective=True)
    torch.cuda.synchronize()
    pdiffs = {f"z-buffer {k}": v for k, v in differing(pk, pp,
                                                       names).items()}
    pdiffs.update({f"painter's {k}": v for k, v in differing(
        qk, qp, names).items()})
    pdiffs.update({"resolve": int((pkc != ppc).sum()),
                   "resolve, painter's": int((qkc != qpc).sum()),
                   "composite": int((pkz != ppz).sum()),
                   "composite, painter's": int((qkz != qpz).sum()),
                   "xray": int((pkx != ppx).sum())})
    vs_affine = {"resolve": int((pkc != base).sum()),
                 "composite": int((pkz != k_comp).sum()),
                 "xray": int((pkx != k_xray).sum())}
    print(f"perspective kernels vs plain, transparent level, N={N_CHECK} "
          f"{WIDTH}x{HEIGHT}: differing pixels {pdiffs}; pixels that "
          f"differ from the affine kernels' {vs_affine}; painter's depth "
          f"plane cleared: {not bool(qk[0].any())}")
    if any(pdiffs.values()):
        _fail(f"perspective kernels disagree with their twins: {pdiffs}")
    if min(vs_affine.values()) == 0 or bool(qk[0].any()):
        _fail("a perspective path drew the affine frame, or the painter's "
              "visibility wrote depth")
    err["raster_visibility_perspective"] = max(
        float((pk[i] - pp[i]).abs().max()) for i in (0, 2, 3))
    err["raster_resolve_perspective"] = int(
        (pkc.long() - ppc.long()).abs().max())
    err["raster_composite_perspective"] = int(
        (pkz.long() - ppz.long()).abs().max())
    err["raster_composite_xray_perspective"] = int(
        (pkx.long() - ppx.long()).abs().max())
    phase_done("perspective kernels vs plain")

    # ---- K5: the sky kernels vs their plain twins, N_CHECK instances ----
    sky_share = {}
    for sky_name, (lv, e, _, _) in sky_envs.items():
        sst = rollout.initial_states(lv, spawn, N_CHECK, device=dev)
        sst = stp.tick(sst, e.grid, e.params, acts_check, 1.0 / 60.0)
        cams = stp.character_camera(sst, e.params)
        for hw in ((HEIGHT, WIDTH), RAGGED):
            size = f"{hw[1]}x{hw[0]}"
            scal = sky_ops.prep_sky_scal(e.sky, cams, hw[1], hw[0])
            k_sky, k_words = _cuda.raster_sky(e.sky, scal, *hw,
                                              want_tiles=True)
            p_sky = sky_ops.sky_plane_ref(e.sky, scal, *hw)
            p_words = sky_ops.sky_tile_faces_ref(e.sky, scal, *hw)
            sprep = prep_for(e, surf_for(e, sst, game, hw), game, hw)
            svis = _cuda.raster_visibility(sprep, e.flat.atlas, *hw)
            bg = sky_ops.SkyBackground(e.sky, scal)
            k_fused = _cuda.raster_resolve(sprep, e.flat.atlas, *svis[1:],
                                           shading, bg)
            p_fused = rb.resolve_ref(sprep, e.flat.atlas, *svis[1:], shading,
                                     bg)
            k_over = _cuda.raster_resolve(sprep, e.flat.atlas, *svis[1:],
                                          shading, k_sky)
            starred = sky_ops.scatter_stars(k_fused, svis[0], e.sky, cams,
                                            time=e.sky.time)
            torch.cuda.synchronize()
            mtn = sky_ops.mountain_mask(e.sky, scal, *hw)
            none = torch.zeros_like(mtn)
            n_stars = int((starred != k_fused).sum())
            word_diff = int((k_words != p_words).sum())
            print(f"raster_sky's tile faces vs sky_tile_faces_ref, "
                  f"{sky_name} sky, {size}, tiles {sky_ops.SKY_TILE_W}x"
                  f"{sky_ops.SKY_TILE_H}: {word_diff} differing words")
            if word_diff:
                _fail(f"{sky_name} sky, {size}: the kernel's tile faces "
                      f"disagree with sky_tile_faces_ref")
            sky_share[sky_name, "plane", size] = sky_classes(
                f"raster_sky vs plain, {sky_name} sky, N={N_CHECK} {size}",
                k_sky, p_sky, dict(face=none, mtn=mtn, blended=none,
                                   stars=n_stars), 0)
            sky_share[sky_name, "fused", size] = sky_classes(
                f"raster_resolve + sky vs plain, {sky_name} sky, "
                f"N={N_CHECK} {size}", k_fused, p_fused,
                dict(face=svis[1] >= 0, mtn=mtn, blended=none,
                     stars=n_stars), 0)
            if hw == (HEIGHT, WIDTH):
                # the perspective instantiation of the sky-fused resolve
                pvis = _cuda.raster_visibility(sprep, e.flat.atlas, *hw,
                                               perspective=True)
                kp = _cuda.raster_resolve(sprep, e.flat.atlas, *pvis[1:],
                                          shading, bg, perspective=True)
                pp_ = rb.resolve_ref(sprep, e.flat.atlas, *pvis[1:], shading,
                                     bg, perspective=True)
                sky_share[sky_name, "fused, perspective", size] = \
                    sky_classes(
                        f"raster_resolve + sky, perspective, vs plain, "
                        f"{sky_name} sky, N={N_CHECK} {size}", kp, pp_,
                        dict(face=pvis[1] >= 0, mtn=mtn, blended=none,
                             stars=n_stars), 0)
                err[f"raster_resolve_sky_perspective_{sky_name}"] = int(
                    channel_step(kp, pp_).max())
            plane_vs_fused = int((k_over != k_fused).sum())
            print(f"resolve over the raster_sky plane vs resolve with the "
                  f"sky fused, {sky_name} sky, {size}: {plane_vs_fused} "
                  f"differing pixels")
            if plane_vs_fused:
                _fail("the two entry points of the sky disagree")
            if e.sky.stars_enabled and n_stars == 0:
                _fail(f"{sky_name} sky: no star pixel was drawn")
            err[f"raster_sky_{sky_name}"] = max(
                err.get(f"raster_sky_{sky_name}", 0),
                int(channel_step(k_sky, p_sky).max()))
            err[f"raster_resolve_sky_{sky_name}"] = max(
                err.get(f"raster_resolve_sky_{sky_name}", 0),
                int(channel_step(k_fused, p_fused).max()))
    phase_done("sky kernels vs plain")

    # ---- K7: select_gather vs its twin and torch.take ----
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    gidx = torch.randint(-GATHER_TABLE // 8, GATHER_TABLE + GATHER_TABLE // 8,
                         (N_MAIN, HEIGHT, WIDTH), generator=gen, device=dev,
                         dtype=torch.int32)
    gtables = {
        "i32": torch.randint(-2 ** 31, 2 ** 31 - 1, (GATHER_TABLE,),
                             generator=gen, device=dev, dtype=torch.int32),
        "f32": torch.randn(GATHER_TABLE, generator=gen, device=dev)}
    out_of_range = (int((gidx < 0).sum()), int((gidx >= GATHER_TABLE).sum()))
    gdiff = {}
    for kind, table in gtables.items():
        got = tg.select_gather(table, gidx)
        want = tg.select_gather_ref(table, gidx)
        torch.cuda.synchronize()
        gdiff[kind] = int((got != want).sum())
        del got, want
    print(f"select_gather vs plain: table {GATHER_TABLE} entries, "
          f"{gidx.numel()} indices ({out_of_range[0]} below 0, "
          f"{out_of_range[1]} past the end): differing elements {gdiff}")
    if any(gdiff.values()):
        _fail(f"select_gather disagrees with its twin: {gdiff}")
    if min(out_of_range) == 0:
        _fail("no index out of range on one side")
    err["select_gather"] = 0
    # Nothing in the package calls select_gather, so no main path below
    # launches it (each asserts a count of 0).  Its own path is its entry
    # point alone: driven here once per table type with the counts reset
    # before and read after, apart from the comparison above.
    reset_counts()
    for table in gtables.values():
        got = tg.select_gather(table, gidx)
        if got.shape != gidx.shape or got.dtype != table.dtype:
            _fail(f"select_gather: {tuple(got.shape)} {got.dtype}")
        del got
    torch.cuda.synchronize()
    gather_counts = read_counts()
    print(f"select_gather alone (no caller in the package): launches "
          f"{gather_counts}")
    if gather_counts != {**dict.fromkeys(gather_counts, 0),
                         "select_gather": len(gtables)}:
        _fail(f"select_gather alone: launches {gather_counts}")
    phase_done("select_gather vs plain and alone")

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
        # the overlay draws edges only: a few per cent of the frame
        least = 0.005 if settings.wireframe_overlay else 0.25
        print(f"main path, {label}: N={N_MAIN} {WIDTH}x{HEIGHT}, "
              f"{n_frames} frames, launches {counts}, min coverage "
              f"{cover:.3f}")
        for name in counts:
            per_frame = want.get(name, 0)
            if counts[name] != per_frame * n_frames:
                _fail(f"{label}: {name} launched {counts[name]} times in "
                      f"{n_frames} frames")
        if cover < least:
            _fail(f"{label}: an instance covers only {cover:.3f} of its "
                  f"last frame")
        for name in ("pos", "vel", "vertical_velocity", "facing",
                     "char_cam_yaw", "char_cam_pitch", "time"):
            if not bool(torch.isfinite(getattr(states, name)).all()):
                _fail(f"{label}: state {name} is not finite")
        if fbs.color.shape != (N_MAIN, HEIGHT, WIDTH):
            _fail(f"{label}: frame shape {tuple(fbs.color.shape)}")
        if (settings.xray_mode or not settings.use_zbuffer
                or settings.wireframe_overlay):
            if bool(fbs.depth.any()):
                _fail(f"{label}: the depth plane is not the cleared one")
        distinct = int((fbs.color != fbs.color[:1]).flatten(1).any(1).sum())
        if distinct < N_MAIN // 2:
            _fail(f"{label}: only {distinct} instances differ from "
                  f"instance 0")
        sub = type(states)(*(x[:N_CHECK] for x in states))
        plain_color, cls = plain_render(e, sub, settings)
        if cls is None:
            ref_diff = int((plain_color != fbs.color[:N_CHECK]).sum())
            print(f"main path, {label}: output vs plain render of "
                  f"{N_CHECK} instances: {ref_diff} differing pixels; "
                  f"{distinct} of {N_MAIN} instances differ from instance 0")
            if ref_diff:
                _fail(f"{label}: the main path's frame disagrees with the "
                      f"plain path")
        else:
            # a sky pixel one step off under a blended face moves the
            # blend's 5-bit result by at most one, 8 in 8 bits; x-ray's
            # 8-bit average keeps the one step
            sky_share[label] = sky_classes(
                f"main path, {label}: output vs plain render of {N_CHECK} "
                f"instances", fbs.color[:N_CHECK], plain_color, cls,
                1 if settings.xray_mode else 8)
            if e.sky.stars_enabled and not cls["stars"]:
                _fail(f"{label}: no star pixel was drawn")
            print(f"main path, {label}: {distinct} of {N_MAIN} instances "
                  f"differ from instance 0")
        phase_done(f"main path, {label}")
        return counts, ms, start, acts

    vis, res, comp, ksky, kgather, kbin = (k.__name__ for k in kernels[:6])
    runs = {}
    runs["opaque"] = main_path(env, level, game, FRAMES, WARMUP,
                               {vis: 1, res: 1, comp: 0, kbin: 1},
                               "opaque level")
    runs["transparent"] = main_path(tenv, tlevel, game, FRAMES, WARMUP,
                                    {vis: 1, res: 1, comp: 1, kbin: 2},
                                    "transparent level")
    runs["xray"] = main_path(tenv, tlevel, xray, MODE_FRAMES, 1,
                             {vis: 0, res: 0, comp: 1, kbin: 1}, "x-ray")
    runs["painters"] = main_path(tenv, tlevel, painters, MODE_FRAMES, 1,
                                 {vis: 1, res: 1, comp: 1, kbin: 2},
                                 "painter's")
    # over a sky: in-kernel route, sky-buffer route, x-ray, painter's
    runs["sky"] = main_path(senv, slevel, game, FRAMES, WARMUP,
                            {vis: 1, res: 1, kbin: 1},
                            "open-air, night sky")
    runs["sky_transparent"] = main_path(
        stenv, stlevel, game, FRAMES, WARMUP,
        {ksky: 1, vis: 1, res: 1, comp: 1, kbin: 2},
        "transparent open-air, night sky")
    _, _, sunlevel, sunenv = sky_envs["sunset"]
    runs["sky_xray"] = main_path(sunenv, sunlevel, xray, MODE_FRAMES, 1,
                                 {ksky: 1, comp: 1, kbin: 1},
                                 "x-ray, sunset sky")
    runs["sky_painters"] = main_path(
        sunenv, sunlevel, painters, MODE_FRAMES, 1,
        {ksky: 1, vis: 1, res: 1, comp: 1, kbin: 2},
        "painter's, sunset sky")
    # perspective-correct UVs: every perspective instantiation
    runs["persp"] = main_path(tenv, tlevel, persp, MODE_FRAMES, 1,
                              {vis: 1, res: 1, comp: 1, kbin: 2},
                              "perspective, transparent level")
    runs["persp_painters"] = main_path(tenv, tlevel, persp_painters,
                                       MODE_FRAMES, 1,
                                       {vis: 1, res: 1, comp: 1, kbin: 2},
                                       "perspective, painter's")
    runs["persp_xray"] = main_path(tenv, tlevel, persp_xray, MODE_FRAMES, 1,
                                   {comp: 1, kbin: 1}, "perspective, x-ray")
    runs["persp_sky"] = main_path(senv, slevel, persp, MODE_FRAMES, 1,
                                  {vis: 1, res: 1, kbin: 1},
                                  "perspective, open-air, night sky")
    # the editor: backface wires over the one draw group (torch code after
    # the kernels), the front-edge overlay alone (no kernel at all)
    runs["editor"] = main_path(env, level, editor, FRAMES, WARMUP,
                               {vis: 1, res: 1, kbin: 1},
                               "editor default, backface wires")
    runs["overlay"] = main_path(tenv, tlevel, overlay, FRAMES, WARMUP, {},
                                "wireframe overlay, transparent level")
    runs["assets"] = main_path(aenv, alevel, game, FRAMES, WARMUP,
                               {vis: 1, res: 1, kbin: 1}, "placed assets")

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

    def replay(e, key, settings=game):
        """The stages of the counted frames of run `key`, replayed, routed
        as rollout.render_cameras routes under `settings`.  Returns the
        stage sums and the last frame's intermediates."""
        _, _, states, acts = runs[key]
        idx = e.flat_static.transparent_idx
        sky = e.sky
        persp = not settings.affine_textures
        cmode = rb.composite_mode(settings)
        in_kernel = sky is not None and sky_ops.sky_kernel_ok(
            sky, e.flat_static, settings)
        back_wires = settings.backface_cull and settings.backface_wireframe
        names = ["tick", "surfaces_prep"]
        if settings.wireframe_overlay:
            names += ["wires"]
        else:
            if sky is not None and not in_kernel:
                names += ["sky_plane", "stars"]
            names += ["visibility", "resolve"]
            if in_kernel and sky.stars_enabled:
                names += ["stars"]
            if idx:
                names += ["composite"]
            if back_wires:
                names += ["wires"]
        stage = dict.fromkeys(names, 0.0)
        last = {}
        for f in range(FRAMES):
            states, ms = timed(lambda s=states, a=acts[f]: stp.tick(
                s, e.grid, e.params, a, 1.0 / 60.0))
            stage["tick"] += ms
            if settings.wireframe_overlay:
                cams, ms = timed(lambda s=states: stp.character_camera(
                    s, e.params))
                stage["surfaces_prep"] += ms
                none = torch.zeros((N_MAIN, HEIGHT, WIDTH), dtype=torch.int32,
                                   device=dev)
                _, ms = timed(lambda m=cams, c=none: wf.render_wireframes_flat(
                    c, torch.zeros(c.shape, device=dev), e.flat, m,
                    settings))
                stage["wires"] += ms
                continue

            def surfaces_prep(s=states):
                cams = stp.character_camera(s, e.params)
                surf = scene_flat.build_surfaces_flat(e.flat, cams, settings,
                                                      WIDTH, HEIGHT)
                return (prep_for(e, surf, settings),
                        rb.prep_transparent(surf, idx) if idx else None,
                        cams, sky_ops.prep_sky_scal(sky, cams, WIDTH, HEIGHT)
                        if sky is not None else None)
            (prep, tr, cams, scal), ms = timed(surfaces_prep)
            stage["surfaces_prep"] += ms
            bg = 0
            if in_kernel:
                bg = sky_ops.SkyBackground(sky, scal)
            elif sky is not None:
                bg, ms = timed(lambda q=scal: _cuda.raster_sky(
                    sky, q, HEIGHT, WIDTH))
                stage["sky_plane"] += ms
                bg, ms = timed(lambda c=bg, m=cams: sky_ops.scatter_stars(
                    c, None, sky, m, time=sky.time))
                stage["stars"] += ms
            planes, ms = timed(lambda p=prep: _cuda.raster_visibility(
                p, e.flat.atlas, HEIGHT, WIDTH,
                painters=not settings.use_zbuffer, perspective=persp))
            stage["visibility"] += ms
            color, ms = timed(lambda p=prep, q=planes, g=bg:
                              _cuda.raster_resolve(p, e.flat.atlas, *q[1:],
                                                   shading, g,
                                                   perspective=persp))
            stage["resolve"] += ms
            if in_kernel and sky.stars_enabled:
                color, ms = timed(lambda c=color, q=planes, m=cams:
                                  sky_ops.scatter_stars(c, q[0], sky, m,
                                                        time=sky.time))
                stage["stars"] += ms
            if idx:
                _, ms = timed(lambda c=color, p=prep, q=planes, t=tr:
                              _cuda.raster_composite(
                                  c, q[0], t, p, e.flat.atlas, shading,
                                  cmode, perspective=persp))
                stage["composite"] += ms
            if back_wires:
                color, ms = timed(lambda c=color, q=planes, m=cams:
                                  wf.render_wireframes_flat(
                                      c, q[0], e.flat, m, settings))
                stage["wires"] += ms
            last = dict(prep=prep, planes=planes, color=color, tr=tr,
                        scal=scal)
        return stage, last

    # each replay twice, the second kept: in the first the allocator may
    # still grow or free its pool (a stall of tens of ms that landed on
    # whichever stage asked for memory)
    stages = {}
    for label, e, key, st in (
            ("opaque", env, "opaque", game),
            ("transparent", tenv, "transparent", game),
            ("open-air, night sky", senv, "sky", game),
            ("transparent open-air, night sky", stenv, "sky_transparent",
             game),
            ("editor default, backface wires", env, "editor", editor),
            ("wireframe overlay, transparent level", tenv, "overlay",
             overlay),
            ("placed assets", aenv, "assets", game)):
        replay(e, key, st)
        stages[label], kept = replay(e, key, st)
        if key == "transparent":
            last = kept
        elif key == "sky":
            sky_last = kept
    del kept
    prep, planes, color, tr = (last[k] for k in ("prep", "planes", "color",
                                                 "tr"))
    phase_done("stage replays")

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

    ballast = torch.ones((4096, 4096), device=dev)

    def kernel_ms(fn, reps=10, queued=False):
        """Milliseconds per call of `fn`, CUDA events over `reps` calls.
        `queued`: the calls wait behind a matrix product of a few ms, so
        all of them are enqueued before the first runs and a launch shorter
        than its wrapper's host time is still timed on the card."""
        fn()
        torch.cuda.synchronize()
        if queued:
            torch.matmul(ballast, ballast)
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

    def popcount(words):
        x = words.long() & 0xFFFFFFFF
        x = x - ((x >> 1) & 0x55555555)
        x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
        x = (x + (x >> 4)) & 0x0F0F0F0F
        return ((x * 0x01010101) >> 24) & 0xFF

    # the kernel composites in place: it is timed on scratch planes (the
    # same work every launch), the plain twins on the unchanged ones
    base = color.clone()
    work = color.clone()
    xwork = clear.clone()
    ms, plain = {}, {}
    # the binning alone, per list (the rows below include it): the kept
    # faces' list is the one in the kernels line
    lists_main = bin_lists(prep, pprep, tr, xprep, xtr)
    bin_ms = {name: kernel_ms(lambda c=ctrl, kw=kw: _cuda.raster_bin(
        c, HEIGHT, WIDTH, want_work="tctrl" in kw, **kw), queued=True)
        for name, (ctrl, kw) in lists_main.items()}
    ms[kbin] = bin_ms["opaque"]
    plain[kbin] = chunked_plain_ms(lambda sl: rb.tile_bins_ref(
        prep.ctrl[sl], HEIGHT, WIDTH, order=prep.order[sl],
        count=prep.count[sl]))
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

    # the perspective instantiations on the same inputs
    vis_p, res_p = "raster_visibility_perspective", "raster_resolve_perspective"
    comp_p = "raster_composite_perspective"
    xray_p = "raster_composite_xray_perspective"
    pplanes = _cuda.raster_visibility(prep, tatlas, HEIGHT, WIDTH,
                                      perspective=True)
    ms[vis_p] = kernel_ms(lambda: _cuda.raster_visibility(
        prep, tatlas, HEIGHT, WIDTH, perspective=True))
    plain[vis_p] = chunked_plain_ms(lambda sl: rb.visibility_ref(
        part(prep, sl), tatlas, HEIGHT, WIDTH, perspective=True))
    ms[res_p] = kernel_ms(lambda: _cuda.raster_resolve(
        prep, tatlas, *pplanes[1:], shading, 0, perspective=True))
    plain[res_p] = chunked_plain_ms(lambda sl: rb.resolve_ref(
        part(prep, sl), tatlas, *(p[sl] for p in pplanes[1:]), shading, 0,
        perspective=True))
    ms[comp_p] = kernel_ms(lambda: _cuda.raster_composite(
        work, pplanes[0], tr, prep, tatlas, shading, ZBUF, perspective=True))
    plain[comp_p] = chunked_plain_ms(lambda sl: rb.composite_ref(
        base[sl], pplanes[0][sl], part(tr, sl), part(prep, sl), tatlas,
        shading, ZBUF, perspective=True))
    ms[xray_p] = kernel_ms(lambda: _cuda.raster_composite(
        xwork, zero_depth, xtr, xprep, tatlas, shading, XRAY,
        perspective=True))
    plain[xray_p] = chunked_plain_ms(lambda sl: rb.composite_ref(
        clear[sl], zero_depth[sl], part(xtr, sl), part(xprep, sl), tatlas,
        shading, XRAY, perspective=True))
    phase_done("kernel and plain timings, earlier kernels")

    # the sky at N_MAIN: the open-air run's last replayed frame (night,
    # fused and alone), and the sunset sky from the same cameras' tables
    sprep, splanes, sscal = (sky_last[k] for k in ("prep", "planes", "scal"))
    satlas = senv.flat.atlas
    night = senv.sky
    sunset = sky_envs["sunset"][1].sky
    sun_scal = sky_ops.prep_sky_scal(
        sunset, stp.character_camera(
            stp.tick(runs["sky"][2], senv.grid, senv.params,
                     runs["sky"][3][0], 1.0 / 60.0), senv.params),
        WIDTH, HEIGHT)
    sbg = sky_ops.SkyBackground(night, sscal)
    fused = "raster_resolve_sky"
    # the sky's launches wait behind a matrix product, so that the host's
    # time per call (the SkyParams struct is filled per call) never shows
    ms[fused] = kernel_ms(lambda: _cuda.raster_resolve(
        sprep, satlas, *splanes[1:], shading, sbg), queued=True)
    resolve_const_ms = kernel_ms(lambda: _cuda.raster_resolve(
        sprep, satlas, *splanes[1:], shading, 0), queued=True)
    plain[fused] = chunked_plain_ms(lambda sl: rb.resolve_ref(
        part(sprep, sl), satlas, *(p[sl] for p in splanes[1:]), shading,
        sky_ops.SkyBackground(night, sscal[sl])))
    fused_p = "raster_resolve_sky_perspective"
    splanes_p = _cuda.raster_visibility(sprep, satlas, HEIGHT, WIDTH,
                                        perspective=True)
    ms[fused_p] = kernel_ms(lambda: _cuda.raster_resolve(
        sprep, satlas, *splanes_p[1:], shading, sbg, perspective=True),
        queued=True)
    plain[fused_p] = chunked_plain_ms(lambda sl: rb.resolve_ref(
        part(sprep, sl), satlas, *(p[sl] for p in splanes_p[1:]), shading,
        sky_ops.SkyBackground(night, sscal[sl]), perspective=True))
    ms[ksky] = kernel_ms(lambda: _cuda.raster_sky(night, sscal, HEIGHT,
                                                  WIDTH), queued=True)
    plain[ksky] = chunked_plain_ms(lambda sl: sky_ops.sky_plane_ref(
        night, sscal[sl], HEIGHT, WIDTH))
    ms["raster_sky_sunset"] = kernel_ms(lambda: _cuda.raster_sky(
        sunset, sun_scal, HEIGHT, WIDTH), queued=True)
    plain["raster_sky_sunset"] = chunked_plain_ms(
        lambda sl: sky_ops.sky_plane_ref(sunset, sun_scal[sl], HEIGHT,
                                         WIDTH))

    # where the sky's time goes: the same launches without the mountains,
    # and with neither the mountains nor any sphere feature but the
    # gradient (the view ray, acos, the gradient and the stores)
    def gradient_only(sky):
        sb = sky.skybox
        def off(x):
            return dataclasses.replace(x, enabled=False)
        return sky._replace(face_table=sky.face_table[:0],
                            skybox=dataclasses.replace(
                                sb, sun=off(sb.sun), moon=off(sb.moon),
                                cloud_layers=[], horizon_haze=off(
                                    sb.horizon_haze),
                                horizontal_tint_enabled=False))

    bare_ms, grad_ms = {}, {}
    for name, sk, sc in (("night", night, sscal),
                         ("sunset", sunset, sun_scal)):
        bare = sk._replace(face_table=sk.face_table[:0])
        grad = gradient_only(sk)
        bare_ms[name] = kernel_ms(lambda b=bare, c=sc: _cuda.raster_sky(
            b, c, HEIGHT, WIDTH), queued=True)
        grad_ms[name] = kernel_ms(lambda g=grad, c=sc: _cuda.raster_sky(
            g, c, HEIGHT, WIDTH), queued=True)
    # the mountain faces each sky tile stages
    tile_faces = {}
    for name, sk, sc in (("night", night, sscal),
                         ("sunset", sunset, sun_scal)):
        per_tile = popcount(_cuda.raster_sky(sk, sc, HEIGHT, WIDTH,
                                             want_tiles=True)[1]).sum(-1)
        tile_faces[name] = (float(per_tile.float().mean()),
                            int(per_tile.max()),
                            float((per_tile == 0).float().mean()))
    ms[kgather] = kernel_ms(lambda: tg.select_gather(gtables["i32"], gidx))
    plain[kgather] = kernel_ms(lambda: tg.select_gather_ref(gtables["i32"],
                                                            gidx))
    gather_f32_ms = kernel_ms(lambda: tg.select_gather(gtables["f32"], gidx))
    clamped = gidx.long().clamp(0, GATHER_TABLE - 1)
    library = {kgather: kernel_ms(lambda: torch.take(gtables["i32"],
                                                     clamped))}
    del clamped
    phase_done("kernel and plain timings, sky and gather")

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
        """(ms, what binds it, ms had f32 operations run at the FMA
        rate)."""
        t_bytes, t_ops = n_bytes / HBM_BYTES_S, n_ops / F32_OPS_S
        return (max(t_bytes, t_ops) * 1e3,
                "bytes" if t_bytes >= t_ops else "operations",
                max(t_bytes, n_ops / F32_FMA_OPS_S) * 1e3)

    atlas_b = nbytes(tatlas.data, tatlas.offset, tatlas.width,
                     tatlas.height)
    plane = N_MAIN * HEIGHT * WIDTH
    bounds = {}
    for name, p in ((vis, prep), ("raster_visibility_painters", pprep)):
        n_kept = int(p.count.sum())
        bounds[name] = bound(n_kept * 4 * (1 + 6 + 16) + nbytes(p.count)
                             + atlas_b + 16 * plane,
                             OPS_COVER * bbox_area(p, p.order, kept(p)))
    # the binning reads each live entry's list word and bbox (4 of the 8
    # ctrl columns) and the counts, writes every mask word, and makes one
    # overlap test (4 compares) per live entry and tile
    tiles = rb.tile_grid(HEIGHT, WIDTH)
    n_kept = int(prep.count.sum())
    bounds[kbin] = bound(
        n_kept * 4 * (1 + 4) + nbytes(prep.count)
        + 4 * N_MAIN * tiles[0] * tiles[1] * ((prep.order.shape[1] + 31)
                                              // 32),
        4 * n_kept * tiles[0] * tiles[1])
    win = planes[1]
    n_faces = prep.attrs.shape[1]
    row = (torch.arange(N_MAIN, device=dev)[:, None, None] * n_faces
           + win.long())[win >= 0]
    won = torch.zeros(N_MAIN * n_faces, dtype=torch.bool, device=dev)
    won[row] = True
    bounds[res] = bound(int(won.sum()) * 4 * 20 + atlas_b + 16 * plane,
                        OPS_PIPELINE * int((win >= 0).sum()))
    # perspective: visibility as above (keyed UVs are not counted); resolve
    # reads three more columns of a won row (the corners' 1/z)
    bounds[vis_p] = bounds[vis]
    pwin = pplanes[1]
    prow = (torch.arange(N_MAIN, device=dev)[:, None, None] * n_faces
            + pwin.long())[pwin >= 0]
    pwon = torch.zeros(N_MAIN * n_faces, dtype=torch.bool, device=dev)
    pwon[prow] = True
    bounds[res_p] = bound(int(pwon.sum()) * 4 * 23 + atlas_b + 16 * plane,
                          (OPS_PIPELINE + OPS_PERSPECTIVE + OPS_IZI)
                          * int((pwin >= 0).sum()))

    # pixels the composite drew: drawn words have alpha 255 and the plane
    # of zeros under them has none (whether a pixel draws does not depend
    # on the colour under it); with a zero depth plane every covered pixel
    # in front of the camera passes the z-test, keyed texels aside
    def drawn(t, p, depth, mode, persp=False):
        c = _cuda.raster_composite(torch.zeros_like(clear), depth, t, p,
                                   tatlas, shading, mode, perspective=persp)
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
    drawn_zp = drawn(tr, prep, pplanes[0], ZBUF, True)
    bounds[comp_p] = bound(
        entry_bytes(tr) + atlas_b + 8 * drawn_zp
        + 4 * drawn(tr, prep, zero_depth, ZBUF, True),
        OPS_COVER * bbox_area(prep, tr.tctrl[..., rb.T_FID], live(tr))
        + (OPS_PIPELINE + OPS_PERSPECTIVE) * drawn_zp)
    drawn_xp = drawn(xtr, xprep, zero_depth, XRAY, True)
    bounds[xray_p] = bound(
        entry_bytes(xtr) + atlas_b + 8 * drawn_xp,
        OPS_COVER * bbox_area(xprep, xtr.tctrl[..., rb.T_FID], live(xtr))
        + (OPS_PIPELINE + OPS_PERSPECTIVE) * drawn_xp)

    # The sky: 4 bytes written per pixel it shows on (its scalar table and
    # face table are a few KB an instance) against the operations counted
    # above the constants OPS_SKY_*: the sphere's on the pixels no mountain
    # covers (a covered pixel never evaluates it), and a mountain face's on
    # its clipped bbox.  Fused into resolve, the launch's bound is
    # resolve's own terms plus the sky's operations on the pixels no face
    # drew.
    def sky_work(sky, scal, shows=None):
        """(pixels the sky shows on, those of them no mountain covers,
        the sphere's operations on those), from the rays of the plain
        version, PLAIN_CHUNK instances at a time; `shows` is an (N, H, W)
        mask, or None for the whole plane."""
        k = sky_ops.sky_consts(sky.skybox)
        r = sky_ops.ray_consts(WIDTH, HEIGHT)
        xs = torch.arange(WIDTH, device=dev, dtype=torch.float32)
        ys = torch.arange(HEIGHT, device=dev, dtype=torch.float32)
        ndc_x = ((xs + 0.5 - r["half_w"]) / r["vs"] / r["usq"])[None, None]
        ndc_y = ((ys + 0.5 - r["half_h"]) / r["vs"] / r["usq"])[None, :,
                                                                 None]
        norm = torch.sqrt(ndc_x * ndc_x + ndc_y * ndc_y + 1.0)
        cx, cy, cz = ndc_x / norm, ndc_y / norm, 1.0 / norm
        n_bodies = sum(bd["enabled"] for bd in k["body"])
        n_shown = n_sphere = n_ops = 0
        for s in range(0, N_MAIN, PLAIN_CHUNK):
            sl = slice(s, s + PLAIN_CHUNK)
            sc = scal[sl]
            free = ~sky_ops.mountain_mask(sky, sc, HEIGHT, WIDTH)
            if shows is not None:
                free &= shows[sl]
            n_shown += free.numel() if shows is None else int(shows[sl].sum())
            n_sphere += int(free.sum())
            b = [sc[:, sky_ops.R_BASIS, j][:, None, None] for j in range(10)]
            wx = cx * b[0] + cy * b[3] + cz * b[6]
            wy = cx * b[1] + cy * b[4] + cz * b[7]
            wz = cx * b[2] + cy * b[5] + cz * b[8]
            v = torch.acos(wy.clamp(-1.0, 1.0)) / np.pi
            theta = torch.remainder(torch.atan2(wz, wx), 2 * np.pi)
            dist = (v - k["horizon"]).abs()
            ops = (OPS_SKY_RAY + OPS_TRANSCENDENTAL + OPS_SKY_GRADIENT
                   + OPS_SKY_BODY_GATE * n_bodies) * free.sum()
            azimuth = torch.zeros_like(free)
            if k["tint_enabled"]:
                diff = (theta - k["tint_dir"]).abs()
                diff = torch.where(diff > np.pi, 2 * np.pi - diff, diff)
                azimuth |= dist < 0.3
                ops += OPS_SKY_TINT * (free & (dist < 0.3)
                                       & (diff < k["tint_spread"])).sum()
            if k["haze_enabled"]:
                ops += OPS_SKY_HAZE * (free & (dist < k["haze_extent"])).sum()
            for bd in k["body"]:
                if bd["enabled"]:
                    cosd = wx * bd["dx"] + wy * bd["dy"] + wz * bd["dz"]
                    ops += OPS_SKY_GLOW * (free & (cosd > bd["cos_gate"])).sum()
            for cl in k["cloud"]:
                if not cl["enabled"]:
                    continue
                inside = free & (v >= cl["vmin"]) & (v <= cl["vmax"])
                azimuth |= inside
                th_s = theta + b[9] * cl["scroll_speed"]
                raw = (torch.sin(torch.sin(th_s * cl["f1"] + cl["p1"])
                                 * cl["s1"] + v * 50.0) * 0.5
                       + torch.sin(torch.sin(th_s * cl["f2"] + cl["p2"])
                                   * cl["s2"] + v * 120.0) * 0.3
                       + torch.sin(torch.sin(th_s * cl["f3"] + cl["p3"])
                                   * cl["s3"] + v * 200.0) * 0.2 + 0.5)
                ops += OPS_SKY_CLOUD_NOISE * inside.sum()
                ops += OPS_SKY_CLOUD_POW * (inside
                                            & (raw >= cl["threshold"])).sum()
            ops += (OPS_TRANSCENDENTAL + 2) * (free & azimuth).sum()
            n_ops += int(ops)
        return n_shown, n_sphere, n_ops

    def mountain_bbox_area(sky, scal):
        nf = sky.face_table.shape[0]
        lo_y = scal[:, sky_ops.R_YMIN, :nf].clamp(0, HEIGHT)
        hi_y = scal[:, sky_ops.R_YMAX, :nf].clamp(0, HEIGHT)
        lo_x = scal[:, sky_ops.R_XMIN, :nf].clamp(0, WIDTH)
        hi_x = scal[:, sky_ops.R_XMAX, :nf].clamp(0, WIDTH)
        return int(((hi_y - lo_y).clamp(min=0)
                    * (hi_x - lo_x).clamp(min=0)).sum())

    def sky_bound(sky, scal, work, extra_bytes=0, extra_ops=0):
        n_shown, _, n_ops = work
        return bound(4 * n_shown + nbytes(scal, sky.face_table)
                     + extra_bytes,
                     n_ops + OPS_SKY_FACE * mountain_bbox_area(sky, scal)
                     + extra_ops)

    sky_px = {ksky: sky_work(night, sscal),
              "raster_sky_sunset": sky_work(sunset, sun_scal)}
    bounds[ksky] = sky_bound(night, sscal, sky_px[ksky])
    bounds["raster_sky_sunset"] = sky_bound(sunset, sun_scal,
                                            sky_px["raster_sky_sunset"])
    swin = splanes[1]
    n_sfaces = sprep.attrs.shape[1]
    srow = (torch.arange(N_MAIN, device=dev)[:, None, None] * n_sfaces
            + swin.long())[swin >= 0]
    swon = torch.zeros(N_MAIN * n_sfaces, dtype=torch.bool, device=dev)
    swon[srow] = True
    # the sky shows where resolve drew no face (none won, or the winner's
    # texel is keyed out): over a word of alpha 0, the pixels still at 0
    shows = ((_cuda.raster_resolve(sprep, satlas, *splanes[1:], shading, 0)
              >> 24) & 255) == 0
    sky_px[fused] = sky_work(night, sscal, shows)
    n_face_px = plane - sky_px[fused][0]
    del shows
    satlas_b = nbytes(satlas.data, satlas.offset, satlas.width,
                      satlas.height)
    # the colour plane's 4 B a pixel are in the 16 B of resolve's planes
    bounds[fused] = sky_bound(
        night, sscal, sky_px[fused],
        extra_bytes=int(swon.sum()) * 4 * 20 + satlas_b + 12 * plane
        + 4 * n_face_px,
        extra_ops=OPS_PIPELINE * n_face_px)
    # the same with perspective UVs, from the perspective visibility
    swin_p = splanes_p[1]
    srow_p = (torch.arange(N_MAIN, device=dev)[:, None, None] * n_sfaces
              + swin_p.long())[swin_p >= 0]
    swon_p = torch.zeros(N_MAIN * n_sfaces, dtype=torch.bool, device=dev)
    swon_p[srow_p] = True
    shows_p = ((_cuda.raster_resolve(sprep, satlas, *splanes_p[1:], shading,
                                     0, perspective=True) >> 24) & 255) == 0
    sky_px[fused_p] = sky_work(night, sscal, shows_p)
    n_face_px_p = plane - sky_px[fused_p][0]
    del shows_p
    bounds[fused_p] = sky_bound(
        night, sscal, sky_px[fused_p],
        extra_bytes=int(swon_p.sum()) * 4 * 23 + satlas_b + 12 * plane
        + 4 * n_face_px_p,
        extra_ops=(OPS_PIPELINE + OPS_PERSPECTIVE + OPS_IZI) * n_face_px_p)
    bounds[kgather] = bound(8 * gidx.numel() + nbytes(gtables["i32"]), 0)
    print(f"{fused}: with the night sky {ms[fused]:.3f} ms, the same launch "
          f"over a constant word {resolve_const_ms:.3f} ms; "
          f"{(plane - n_face_px) / plane:.3f} of the pixels show the sky "
          f"(N={N_MAIN}, open-air level) {card}")
    print("pixels the sky shows on, those of them that evaluate the "
          "sphere (no mountain covers them), and the sphere's operations "
          "a sphere pixel: "
          + ", ".join(f"{k} {n} / {m}, {o / max(m, 1):.1f}"
                      for k, (n, m, o) in sky_px.items())
          + f" (N={N_MAIN})")
    print(f"raster_sky without its mountain faces: night "
          f"{bare_ms['night']:.3f} ms (with: {ms[ksky]:.3f}), sunset "
          f"{bare_ms['sunset']:.3f} ms (with: "
          f"{ms['raster_sky_sunset']:.3f}); gradient only, no mountain "
          f"faces: night {grad_ms['night']:.3f} ms, sunset "
          f"{grad_ms['sunset']:.3f} ms {card}")
    print("mountain faces per sky tile (" + f"{sky_ops.SKY_TILE_W}x"
          f"{sky_ops.SKY_TILE_H}, N={N_MAIN}): " + ", ".join(
              f"{k} sky mean {m:.3f} max {x}, tiles with none {z:.3f}"
              for k, (m, x, z) in tile_faces.items()))
    print(f"{kgather}: i32 {ms[kgather]:.3f} ms, f32 {gather_f32_ms:.3f} ms, "
          f"torch.take {library[kgather]:.3f} ms, plain "
          f"{plain[kgather]:.3f} ms, bound {bounds[kgather][0]:.3f} ms "
          f"({gidx.numel()} indices, {GATHER_TABLE}-entry table) {card}")
    for name, (ctrl, kw) in lists_main.items():
        per_tile = popcount(_cuda.raster_bin(ctrl, HEIGHT, WIDTH,
                                             **kw)[0]).sum(-1)
        n_live = rb.bin_list(**kw)[1].sum(1)
        print(f"list {name}: {int(n_live.shape[0])} instances, length "
              f"{rb.bin_list(**kw)[0].shape[1]}, live entries per instance "
              f"mean {float(n_live.float().mean()):.2f} max "
              f"{int(n_live.max())}; entries per {rb.TILE_W}x{rb.TILE_H} "
              f"tile mean {float(per_tile.float().mean()):.2f} max "
              f"{int(per_tile.max())}, tiles with none "
              f"{float((per_tile == 0).float().mean()):.3f}; raster_bin "
              f"alone {bin_ms[name]:.3f} ms (N={N_MAIN}) {card}")
    print("sky pixels one step off the plain version, share: "
          + ", ".join(f"{k if isinstance(k, str) else ' '.join(k)} {v:.6%}"
                      for k, v in sky_share.items()))

    for key, label in (("opaque", "opaque level"),
                       ("transparent", "transparent level"),
                       ("xray", "x-ray"), ("painters", "painter's"),
                       ("sky", "open-air, night sky"),
                       ("sky_transparent", "transparent open-air, night sky"),
                       ("sky_xray", "x-ray, sunset sky"),
                       ("sky_painters", "painter's, sunset sky"),
                       ("persp", "perspective, transparent level"),
                       ("persp_painters", "perspective, painter's"),
                       ("persp_xray", "perspective, x-ray"),
                       ("persp_sky", "perspective, open-air, night sky"),
                       ("editor", "editor default, backface wires"),
                       ("overlay", "wireframe overlay, transparent level"),
                       ("assets", "placed assets")):
        f_ms = runs[key][1]
        print(f"frame, {label}: {f_ms:.3f} ms per batched frame of "
              f"{N_MAIN} instances = {N_MAIN * 1000.0 / f_ms:.1f} "
              f"instance-frames/s (step_and_render, CUDA events) {card}")
    for key, stage in stages.items():
        print(f"stages, {key} (ms per frame, CUDA events, "
              f"synchronized per stage): "
              + ", ".join(f"{k} {v:.3f}" for k, v in stage.items())
              + f", sum {sum(stage.values()):.3f} {card}")
    with_bin = {vis: "opaque", "raster_visibility_painters": "painter's",
                comp: "transparent", "raster_composite_xray": "x-ray",
                vis_p: "opaque", comp_p: "transparent", xray_p: "x-ray"}
    sky_kernels = (fused, fused_p, ksky, "raster_sky_sunset", kgather)
    for name in ms:
        where = ("open-air level" if name in sky_kernels
                 else "transparent level")
        print(f"{name}: kernel {ms[name]:.3f} ms, plain {plain[name]:.3f} "
              f"ms, bound {bounds[name][0]:.3f} ms ({bounds[name][1]}) "
              f"(N={N_MAIN}, {where}, plain in chunks of "
              f"{PLAIN_CHUNK})"
              + (f"; the kernel's time includes its raster_bin launch, "
                 f"alone {bin_ms[with_bin[name]]:.3f} ms"
                 if name in with_bin else "") + f" {card}")

    print(f"bounds bound by operations, read at the FMA rate "
          f"{F32_FMA_OPS_S:.3g}/s as before: " + ", ".join(
              f"{name} {bounds[name][2]:.3f} ms (now {bounds[name][0]:.3f})"
              for name in ms if bounds[name][1] == "operations")
          + f" {card}")

    run_sequential(dev, card, phase_done, reset_counts, read_counts,
                   actions, env, level, tenv, tlevel, aenv, alevel, senv,
                   slevel, spawn)
    run_play(dev, card, phase_done, reset_counts, read_counts)
    run_editor(dev, card, phase_done, reset_counts, read_counts)
    audio_rows = run_audio(dev, card, phase_done, reset_counts, read_counts)
    run_fleet(dev, card, phase_done, reset_counts, read_counts)
    run_ui(dev, card, phase_done, reset_counts, read_counts)

    t_counts = runs["transparent"][0]
    launches = {vis: t_counts[vis], res: t_counts[res],
                comp: t_counts[comp],
                "raster_visibility_painters": runs["painters"][0][vis],
                "raster_composite_xray": runs["xray"][0][comp],
                # the sky: fused in the open-air run's resolve launches;
                # alone in the sky-buffer runs (night: the transparent
                # open-air run; sunset: x-ray and painter's); the gather
                # has no caller on any of those paths (each asserted its
                # count 0): its count is that of its entry point driven
                # alone, and `counted_on` says so
                fused: runs["sky"][0][res],
                ksky: runs["sky_transparent"][0][ksky],
                "raster_sky_sunset": (runs["sky_xray"][0][ksky]
                                      + runs["sky_painters"][0][ksky]),
                kgather: gather_counts[kgather],
                # one per visibility and one per composite launch
                kbin: t_counts[kbin],
                # the perspective instantiations: the perspective runs
                vis_p: runs["persp"][0][vis], res_p: runs["persp"][0][res],
                comp_p: runs["persp"][0][comp],
                xray_p: runs["persp_xray"][0][comp],
                fused_p: runs["persp_sky"][0][res]}
    counted_on = {vis: "transparent level", res: "transparent level",
                  comp: "transparent level",
                  "raster_visibility_painters": "painter's",
                  "raster_composite_xray": "x-ray",
                  fused: "open-air, night sky",
                  ksky: "transparent open-air, night sky",
                  "raster_sky_sunset": "x-ray and painter's, sunset sky",
                  kgather: "its entry point alone: on no main path, "
                           "nothing in the package calls it",
                  kbin: "transparent level",
                  vis_p: "perspective, transparent level",
                  res_p: "perspective, transparent level",
                  comp_p: "perspective, transparent level",
                  xray_p: "perspective, x-ray",
                  fused_p: "perspective, open-air, night sky"}
    replaces = {vis: f"{JAX_RB}:859",
                "raster_visibility_painters": f"{JAX_RB}:941",
                res: f"{JAX_RB}:1098",
                comp: f"{JAX_RB}:1562",
                "raster_composite_xray": f"{JAX_RB}:1713",
                fused: f"{JAX_RB}:1525", ksky: f"{JAX_RB}:712",
                "raster_sky_sunset": f"{JAX_RB}:712",
                kgather: f"{JAX_GATHER}:60", kbin: f"{JAX_RB}:859",
                vis_p: f"{JAX_RB}:1003", res_p: f"{JAX_RB}:1249",
                comp_p: f"{JAX_RB}:1562", xray_p: f"{JAX_RB}:1713",
                fused_p: f"{JAX_RB}:1249"}
    err[fused] = max(err["raster_resolve_sky_night"],
                     err["raster_resolve_sky_sunset"])
    err[ksky] = err["raster_sky_night"]
    err[fused_p] = max(err["raster_resolve_sky_perspective_night"],
                       err["raster_resolve_sky_perspective_sunset"])
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": GATHER_SRC if name == kgather else SRC,
         "replaces": replaces[name], "launches": launches[name],
         "max_abs_err": err[name], "ms": ms[name], "plain_ms": plain[name],
         "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
         "library_ms": library.get(name), "counted_on": counted_on[name]}
        for name in ms] + audio_rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def run_sequential(dev, card, phase_done, reset_counts, read_counts,
                   actions, env, level, glenv, gllevel, aenv, alevel, senv,
                   slevel, spawn):
    """The sequential renderer (render.py, models/scene.py; torch code,
    no kernel of its own but `raster_sky` for a sky) on `dev`:

      * render_mesh_15 of the cube of tests/torch_scenes.py at 320x240 in
        "fast", "inv" and "harmonic" depth modes and under an ortho view,
        each against the same call on the CPU (0 differing pixels), and
        "inv" against "harmonic" (0);
      * step_and_render on the sequential route (the env without its flat
        scene) on the Cave-size level, its transparent variant (`glenv`,
        glazed faces in every blend mode) and the asset level, each at
        N=1 and N=N_SEQ, game settings: the last frame against the kernel
        route of the same env, states and actions (0 differing pixels in
        colour and depth), and no raster_visibility, raster_resolve,
        raster_composite or raster_bin launch;
      * the routes the kernels cannot draw, at N=1 through
        step_and_render: ortho projection (cameras inside the room, whose
        faces behind them pass the harmonic test on the inverse-z clear),
        the editor's RasterSettings() on the asset level (five draw
        groups, backface wires), transparent faces in the first room of
        the two-room level; each frame against the CPU (0);
      * the open-air night level on the sequential route: the sky plane
        from `raster_sky` (one launch a frame), its pixels within one
        8-bit step of the CPU's, every other pixel exact;
      * ms per frame of each route at N=1 and N=N_SEQ: CUDA events around
        the step_and_render loop after one warm-up frame."""
    import numpy as np
    import torch

    import torch_render_cases as rc
    import torch_scenes as ts
    import torch_seq_cases as sc
    from bonnie32_tpu_torch import config, rollout
    from bonnie32_tpu_torch.config import RasterSettings
    from bonnie32_tpu_torch.game import step as stp
    from bonnie32_tpu_torch.models import build
    from bonnie32_tpu_torch.models import level as L
    from bonnie32_tpu_torch.models import skybox as S
    from bonnie32_tpu_torch.types import CameraArrays

    cpu = torch.device("cpu")
    game = RasterSettings.game()
    raster = ("raster_visibility", "raster_resolve", "raster_composite",
              "raster_bin")

    # ---- render_mesh_15 on the cube, card vs CPU ----
    for name in ("ps1_default", "ortho"):
        frames = {}
        for mode in rc.MODES:
            reset_counts()
            frames[mode] = rc.port_frame(name, mode, dev, HEIGHT, WIDTH)
            counts = read_counts()
            if any(counts[k] for k in raster):
                _fail(f"render_mesh_15 {name} {mode}: launched {counts}")
            cpu_f = rc.port_frame(name, mode, cpu, HEIGHT, WIDTH)
            diff = int((frames[mode] != cpu_f).sum())
            lit = float(((cpu_f >> 24) & 255 == 255).mean())
            print(f"render_mesh_15, cube {name}, {mode}: {WIDTH}x{HEIGHT}, "
                  f"card vs CPU {diff} differing pixels, lit {lit:.3f}")
            if diff or lit == 0.0:
                _fail(f"render_mesh_15 {name} {mode}: {diff} differing "
                      f"pixels, lit share {lit}")
        d = int((frames["inv"] != frames["harmonic"]).sum())
        print(f"render_mesh_15, cube {name}: inv vs harmonic {d} differing "
              f"pixels")
        if d:
            _fail(f"render_mesh_15 {name}: inv and harmonic differ")
    phase_done("render_mesh_15, cube")

    evs = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    times = {}

    def timed_frames(label, n, n_frames, frame, want_sky=0):
        """`frame(f)` (f = 0 warm-up, then 1..n_frames counted and timed,
        CUDA events around the loop) on the sequential route: no raster
        kernel launches, `want_sky` raster_sky launches an instance chunk
        and frame.  Returns the last frame's result."""
        frame(0)
        torch.cuda.synchronize()
        held = 0
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
            held = torch.cuda.memory_allocated(dev)
        reset_counts()
        evs[0].record()
        for f in range(1, n_frames + 1):
            out = frame(f)
        evs[1].record()
        torch.cuda.synchronize()
        counts = read_counts()
        ms = evs[0].elapsed_time(evs[1]) / n_frames
        times[label, n] = ms
        chunks = -(-n // rollout.INSTANCE_CHUNK)
        # device memory the frames took above what earlier phases hold
        peak = ((torch.cuda.max_memory_allocated(dev) - held) / 2 ** 30
                if dev.type == "cuda" else float("nan"))
        print(f"sequential route, {label}: N={n} {WIDTH}x{HEIGHT}, "
              f"{n_frames} frames, {ms:.3f} ms per frame, peak device "
              f"memory {peak:.2f} GiB above the {held / 2 ** 30:.2f} held, "
              f"launches {counts} {card}")
        if any(counts[k] for k in raster):
            _fail(f"{label}: the sequential route launched {counts}")
        if counts["raster_sky"] != want_sky * chunks * n_frames:
            _fail(f"{label}: raster_sky launched {counts['raster_sky']} "
                  f"times")
        return out

    def drive(e, lvl, settings, n, n_frames, want_sky=0, label=""):
        """step_and_render of `n` instances from the spawn point, timed.
        Returns (states before the last frame, its actions, the last
        frame)."""
        rng = np.random.default_rng(SEED + 2)
        acts = [actions(rng, n) for _ in range(n_frames + 1)]
        hist = [rollout.initial_states(lvl, ts.spawn_point(lvl), n,
                                       device=dev)]

        def frame(f):
            states, fbs = rollout.step_and_render(
                hist[-1], e, acts[f], settings, height=HEIGHT, width=WIDTH)
            hist.append(states)
            return fbs

        fbs = timed_frames(label, n, n_frames, frame, want_sky)
        if not bool(((fbs.color >> 24) & 255 == 255).any()):
            _fail(f"{label}: nothing drawn")
        return hist[-2], acts[n_frames], fbs

    # ---- the sequential route vs the kernel route, game settings ----
    for name, e, lvl in (("Cave-size level", env, level),
                         ("transparent level", glenv, gllevel),
                         ("asset level", aenv, alevel)):
        if not rollout.kernel_route(e, game):
            _fail(f"{name}: the kernels do not draw the game settings")
        seq_env = e._replace(flat=None, flat_static=None)
        for n, n_frames in ((1, SEQ_FRAMES), (N_SEQ, 1)):
            prev, act, fbs = drive(seq_env, lvl, game, n, n_frames,
                                   label=f"{name}, game settings")
            _, kern = rollout.step_and_render(prev, e, act, game,
                                              height=HEIGHT, width=WIDTH)
            diff = int((kern.color != fbs.color).sum())
            ddiff = int((kern.depth != fbs.depth).sum())
            print(f"sequential route, {name}: N={n}, last frame vs the "
                  f"kernel route {diff} differing pixels, {ddiff} depth")
            if diff or ddiff:
                _fail(f"{name}: sequential vs kernel route at N={n}: "
                      f"{diff} pixels, {ddiff} depth")
    phase_done("sequential route vs kernel route")

    # ---- the routes the kernels cannot draw, card vs CPU ----
    def cpu_env_of(name):
        lvl, tex, kw, _ = sc.level_args(name)
        return lvl, rollout.build_env(lvl, tex, ts.resolver, device=cpu,
                                      **kw)

    ortho = ts.ortho_settings(config)
    tlevel, tex, kw, _ = sc.level_args("transparent_first_room")
    tenv = rollout.build_env(tlevel, tex, ts.resolver, device=dev, **kw)
    routes = (("ortho, Cave-size level", env, level, ortho, "cave"),
              ("editor RasterSettings(), asset level", aenv, alevel,
               RasterSettings(), "asset"),
              ("transparent faces in the first room", tenv, tlevel, game,
               "transparent_first_room"))
    poses = sc.POSES["cave"]
    room_cams = CameraArrays(
        torch.tensor([p for p, _, _ in poses], device=dev),
        torch.from_numpy(np.stack([build.camera_basis(pi, ya)
                                   for _, pi, ya in poses])).to(dev))
    for label, e, lvl, settings, cname in routes:
        if rollout.kernel_route(e, settings):
            _fail(f"{label}: routed to the kernels")
        ortho_route = settings.ortho_projection is not None
        for n, n_frames in ((1, SEQ_FRAMES), (N_SEQ, 1)):
            if ortho_route:
                # the character camera stands outside the room, where no
                # face lies behind it and nothing passes: time the render
                # half from cameras inside the room instead
                idx = torch.arange(n, device=dev) % len(poses)
                cams_n = CameraArrays(room_cams.position[idx],
                                      room_cams.basis[idx])
                timed_frames(label, n, n_frames,
                             lambda f, c=cams_n: rollout.render_cameras(
                                 e, c, settings, HEIGHT, WIDTH))
            else:
                prev, act, _ = drive(e, lvl, settings, n, n_frames,
                                     label=label)
        _, cenv = cpu_env_of(cname)
        if ortho_route:
            sub = room_cams
        else:
            cams = stp.character_camera(stp.tick(
                prev, e.grid, e.params, act, 1.0 / 60.0), e.params)
            sub = CameraArrays(cams.position[:1], cams.basis[:1])
        card_f = rollout.render_cameras(e, sub, settings, HEIGHT, WIDTH)
        cpu_f = rollout.render_cameras(cenv, CameraArrays(
            *(x.cpu() for x in sub)), settings, HEIGHT, WIDTH)
        diff = int((card_f.color.cpu() != cpu_f.color).sum())
        lit = float(((cpu_f.color >> 24) & 255 == 255).float().mean())
        print(f"sequential route, {label}: {sub.position.shape[0]} "
              f"cameras, card vs CPU {diff} differing pixels, lit {lit:.3f}")
        if diff or lit == 0.0:
            _fail(f"{label}: card vs CPU {diff} differing pixels, lit {lit}")
    phase_done("routes the kernels cannot draw")

    # ---- the open-air night level on the sequential route ----
    sseq = senv._replace(flat=None, flat_static=None)
    label = "open-air, night sky"
    for n, n_frames in ((1, SEQ_FRAMES), (N_SEQ, 1)):
        prev, act, fbs = drive(sseq, slevel, game, n, n_frames, want_sky=1,
                               label=label)
    cams = stp.character_camera(stp.tick(prev, sseq.grid, sseq.params, act,
                                         1.0 / 60.0), sseq.params)
    sub = CameraArrays(cams.position[:8], cams.basis[:8])
    cenv = rollout.build_env(ts.open_air_level(L, S), ts.textures(),
                             ts.resolver, flat=False, device=cpu)
    card_f = rollout.render_cameras(sseq, sub, game, HEIGHT, WIDTH)
    cpu_f = rollout.render_cameras(cenv, CameraArrays(
        *(x.cpu() for x in sub)), game, HEIGHT, WIDTH)
    step = channel_step(card_f.color.cpu(), cpu_f.color)
    sky = cpu_f.depth == 0.0
    print(f"sequential route, {label}: {sub.position.shape[0]} cameras, "
          f"card vs CPU: face pixels differing "
          f"{int((step[~sky] > 0).sum())} of {int((~sky).sum())}, sky "
          f"pixels one step off {int((step[sky] == 1).sum())}, beyond "
          f"{int((step[sky] > 1).sum())} of {int(sky.sum())}")
    if bool((step[~sky] > 0).any()) or bool((step[sky] > 1).any()):
        _fail(f"{label}: card and CPU differ beyond the sky's one step")
    if not bool(sky.any()) or not bool((~sky).any()):
        _fail(f"{label}: no sky or no face pixel")
    phase_done("sequential route, night sky")
    print("sequential route, ms per frame (step_and_render, CUDA events, "
          "after one warm-up frame): " + ", ".join(
              f"{k[0]} N={k[1]} {v:.3f}" for k, v in times.items())
          + f" {card}")



def run_play(dev, card, phase_done, reset_counts, read_counts):
    """The game's play path on `dev` (torch code; `raster_sky` its one
    kernel):

      * load: the open-air night level of tests/torch_scenes.py (the
        Cave-size level without its ceiling, under the night sky) saved
        with save_level into build/play/ and loaded with load_level
        through the native RON parser (built with g++ first); its parse
        equals the Python parser's, and the two parse times are printed;
      * play: GameToolState on the card, the player spawned, PLAY_FRAMES
        ticks of scripted VirtualGamepad input through to_actions; then
        render_game_view of the 4:3 640x480 view, a 16:9 view stretched
        to 480 rows and the 320x240 view, each under the night sky in
        RGB555 and in 8-bit, then one frame from the free-fly camera.
        Each frame launches `raster_sky` once and no raster kernel, and
        equals the CPU's from the same camera: face pixels and depth
        exact, sky pixels within one 8-bit step.  The 8-bit views draw no
        face (the 8-bit pipeline tests z < depth on the view's inverse-z
        clear, as the JAX package's does): only the sky shows;
      * 8-bit: render_level(use_rgb555=False) on a frame cleared to
        F32_MAX at 320x240, N=1 and N=N_PLAY8 character cameras, on the
        Cave-size and the asset level: no kernel launch; the first and
        last instance equal the CPU's in colour and depth;
      * exact sky: render_skybox(exact=True) under the night and the
        sunset sky at 320x240, N=1 and N=N_SKY_EXACT, equal to the CPU's
        (0 pixels), and at 160x120 equal to the numpy transcription
        tests/golden/skybox_golden.py (0 pixels);
      * ECS: combat_system, try_open_door, activate_checkpoint,
        collect_item, integrate_velocities and global_positions on
        N_ECS instances of ECS_CAPACITY random entities: every state
        field and event lane equal to the CPU's;
      * the game tick: N_TICK_DRIFT instances on the Cave-size level,
        the same seeded actions ticked (`step.tick`, `character_camera`)
        on the card and on the CPU for TICK_DRIFT_FRAMES frames, each
        from its own states (tests/torch_tick_drift.py): the values that
        differ bit for bit and the largest difference per field after
        frames 1, 3, 30 and 300; frames 1-3 within the CPU tick's
        tolerance against the JAX package (integers exact, floats rtol
        1e-5 / atol 1e-4), the later drift printed and held to nothing.

    Every time is CUDA events around the calls after a warm-up call,
    printed with the card's name and power limit."""
    import numpy as np
    import torch

    import torch_scenes as ts
    import torch_seq_cases as sc
    from golden import skybox_golden as G
    from bonnie32_tpu_torch import native
    from bonnie32_tpu_torch.config import RasterSettings
    from bonnie32_tpu_torch.game import collision as col
    from bonnie32_tpu_torch.game import events as ev
    from bonnie32_tpu_torch.game import runtime as rt
    from bonnie32_tpu_torch.game import state as st
    from bonnie32_tpu_torch.game import step as stp
    from bonnie32_tpu_torch.game import systems as sy
    from bonnie32_tpu_torch.game import viewport as vp
    from bonnie32_tpu_torch.input import (InputState, VirtualGamepad,
                                          VirtualKeyboard)
    from bonnie32_tpu_torch.io import brotli_io, ron
    from bonnie32_tpu_torch.models import build
    from bonnie32_tpu_torch.models import level as L
    from bonnie32_tpu_torch.models import scene
    from bonnie32_tpu_torch.models import skybox as S
    from bonnie32_tpu_torch.ops import raster_ref
    from bonnie32_tpu_torch.ops import skybox as sky_ops
    from bonnie32_tpu_torch.types import CameraArrays

    cpu = torch.device("cpu")
    evs = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    times = {}

    def timed(label, fn, frames=1, want=None):
        """fn() once untimed, then `frames` times between CUDA events:
        the launches of the timed calls must be `want` (kernel name ->
        count per call; every other kernel 0).  Returns the last
        result."""
        fn()
        torch.cuda.synchronize()
        reset_counts()
        evs[0].record()
        for _ in range(frames):
            out = fn()
        evs[1].record()
        torch.cuda.synchronize()
        counts = read_counts()
        expect = {k: (want or {}).get(k, 0) * frames for k in counts}
        if counts != expect:
            _fail(f"{label}: launches {counts}, want {expect}")
        times[label] = evs[0].elapsed_time(evs[1]) / frames
        return out

    def to_cpu(cams):
        return CameraArrays(*(x.cpu() for x in cams))

    # ---- load: save_level, then load_level through the native parser ----
    t0 = time.perf_counter()
    native.get()
    build_s = time.perf_counter() - t0
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "play")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "open_air_night.ron")
    L.save_level(ts.open_air_level(L, S), path)
    with open(path, "rb") as f:
        text = brotli_io.maybe_decompress(f.read())
    parse = {}
    for name, fn in (("native", ron.loads), ("Python", ron.loads_py)):
        t0 = time.perf_counter()
        for _ in range(5):
            value = fn(text)
        parse[name] = ((time.perf_counter() - t0) / 5 * 1e3, value)
    if parse["native"][1] != parse["Python"][1]:
        _fail("load: the native parse differs from the Python parse")
    level = L.load_level(path)
    if (ron.dumps(level.to_ron())
            != ron.dumps(L.Level.from_ron(parse["Python"][1]).to_ron())):
        _fail("load: load_level's level differs from the Python parse's")
    print(f"load: {os.path.relpath(path)}, {len(text)} bytes of RON, "
          f"{len(level.rooms)} room(s); "
          f"native parser (g++ build {build_s:.2f} s) {parse['native'][0]:.3f}"
          f" ms, Python parser {parse['Python'][0]:.3f} ms a parse "
          f"(host clock) {card}")
    phase_done("play: load through the native parser")

    # ---- play: GameToolState, scripted input, render_game_view ----
    tex = ts.textures()
    scene_d = scene.compile_level(level, tex, ts.resolver, with_8bit=True,
                                  device=dev)
    scene_c = scene.compile_level(level, tex, ts.resolver, with_8bit=True,
                                  device=cpu)
    cfg = S.Skybox.from_ron(level.skybox)
    sky_d = sky_ops.build_sky_tables(cfg, device=dev)
    sky_c = sky_ops.build_sky_tables(cfg, device=cpu)
    tool = rt.GameToolState(col.compile_collision(level, device=dev),
                            col.player_params(level, device=dev),
                            device=dev)
    tool.spawn_player(ts.spawn_point(level))
    tool.playing = True
    kb, gp = VirtualKeyboard(), VirtualGamepad()
    inp = InputState(kb, gp)
    script = [dict(axes=dict(lx=0.0, ly=1.0, rx=0.4, ry=0.0),
                   buttons={"b"}),
              dict(axes=dict(lx=0.5, ly=0.8, rx=0.0, ry=-0.3),
                   buttons={"b", "a"}),
              dict(axes=dict(lx=-0.7, ly=0.2, rx=-0.6, ry=0.2),
                   buttons=set())]
    for f in range(PLAY_FRAMES):
        gp.update(**script[f % len(script)])
        tool.tick(inp)
    if not all(bool(torch.isfinite(x).all()) for x in tool.state
               if x.dtype.is_floating_point):
        _fail("play: the state is not finite after the scripted ticks")
    views = (("4:3 640x480", dict(low_resolution=False,
                                  stretch_to_fill=False), (0, 0, 800, 600)),
             ("16:9 stretched to 480 rows",
              dict(low_resolution=False, stretch_to_fill=True),
              (0, 0, 1280, 720)),
             ("320x240", dict(low_resolution=True, stretch_to_fill=False),
              (0, 0, 800, 600)))

    def check_view(label, cams, settings, rect, faces_expected):
        out = timed(label, lambda: vp.render_game_view(
            scene_d, cams, settings, rect, sky=sky_d), frames=2,
            want={"raster_sky": 1})
        ref = vp.render_game_view(scene_c, to_cpu(cams), settings, rect,
                                  sky=sky_c)
        color, depth = out.fb.color.cpu(), out.fb.depth.cpu()
        step = channel_step(color, ref.fb.color)
        faces = ref.fb.depth != 0.0
        n_face = int(faces.sum())
        print(f"play, {label}: {out.fb_size[0]}x{out.fb_size[1]} at "
              f"{tuple(round(v, 1) for v in out.dest)}, card vs CPU: face "
              f"pixels differing {int((step[faces] > 0).sum())} of "
              f"{n_face}, depth differing "
              f"{int((depth != ref.fb.depth).sum())}, sky pixels one step "
              f"off {int((step[~faces] == 1).sum())}, beyond "
              f"{int((step[~faces] > 1).sum())} of {int((~faces).sum())}")
        if (out.fb_size != ref.fb_size or out.dest != ref.dest
                or bool((step[faces] > 0).any())
                or bool((depth != ref.fb.depth).any())
                or bool((step[~faces] > 1).any())):
            _fail(f"play, {label}: card and CPU differ")
        if (n_face > 0) != faces_expected or not bool((~faces).any()):
            _fail(f"play, {label}: {n_face} face pixels, "
                  f"{int((~faces).sum())} sky pixels")

    cams = tool.camera()
    for label, kw, rect in views:
        for pipe, rgb in (("RGB555", True), ("8-bit", False)):
            check_view(f"{label}, {pipe}", cams,
                       RasterSettings.game(use_rgb555=rgb, **kw), rect,
                       faces_expected=rgb)
    tool.toggle_camera_mode()
    kb.update({"q"})
    gp.update(axes=dict(lx=0.3, ly=0.8, rx=-0.2, ry=0.1), buttons=set())
    tool.tick(inp)
    if tool.camera_mode != rt.CameraMode.FREEFLY:
        _fail("play: the camera did not switch to free-fly")
    check_view("free-fly camera, 320x240, RGB555", tool.camera(),
               RasterSettings.game(low_resolution=True,
                                   stretch_to_fill=False),
               (0, 0, 800, 600), faces_expected=True)
    phase_done("play: GameToolState and render_game_view")

    def valid_counts8(sc_, cams, settings):
        """(meshes, I) valid surfaces that render_level's 8-bit branch
        builds for each room and asset mesh of `sc_`, on the host."""
        from bonnie32_tpu_torch.ops.surface import build_surfaces
        from bonnie32_tpu_torch.types import no_fog
        fog0 = no_fog(device=cams.position.device)

        def room_faces(i):
            f = scene._index(sc_.faces, i)
            tid = f.tex_id
            return f._replace(tex_id=torch.where(
                tid >= 0, sc_.tex_map[i][torch.clamp(tid, min=0).long()],
                tid))

        meshes = [(scene._index(sc_.mesh, i), room_faces(i), sc_.atlas8,
                   sc_.ambient[i]) for i in range(sc_.ambient.shape[0])]
        meshes += [(scene._index(sc_.a_mesh, i), scene._index(sc_.a_faces, i),
                    scene._index(sc_.a_atlas8, i), sc_.a_ambient[i])
                   for i in range(sc_.a_count)]
        return torch.stack([build_surfaces(
            m, f, a, cams, sc_.lights._replace(ambient=amb), fog0, settings,
            WIDTH, HEIGHT).valid.sum(1).cpu() for m, f, a, amb in meshes])

    # ---- 8-bit: render_level(use_rgb555=False) on an F32_MAX clear ----
    s8 = RasterSettings.game(use_rgb555=False)
    for name in ("cave", "asset"):
        lvl, ltex, kw, _ = sc.level_args(name)
        sc_d = scene.compile_level(lvl, ltex, ts.resolver, with_8bit=True,
                                   device=dev, **kw)
        sc_c = scene.compile_level(lvl, ltex, ts.resolver, with_8bit=True,
                                   device=cpu, **kw)
        grid = col.compile_collision(lvl, device=dev)
        params = col.player_params(lvl, device=dev)
        for n in (1, N_PLAY8):
            states = stp.tick(
                st.spawn_player(st.new_state(n, 4, device=dev),
                                ts.spawn_point(lvl),
                                lvl.player_settings)[0],
                grid, params, stp.Actions(**{
                    k: torch.from_numpy(v).to(dev) for k, v in
                    ts.actions_np(np.random.default_rng(SEED + 3),
                                  n).items()}), 1.0 / 60.0)
            cams = stp.character_camera(states, params)

            def frame(sc_=sc_d, cams_=cams, n_=n, dev_=dev):
                fb = raster_ref.new_framebuffer(HEIGHT, WIDTH, "harmonic",
                                                n=n_, device=dev_)
                return scene.render_level(fb, sc_, cams_, s8)

            label = f"8-bit render_level, {name} level, N={n}"
            out = timed(label, frame)
            # render_mesh8 loops to the most valid surfaces of any
            # instance and masks the rest: check the instances at each
            # mesh's extremes as well as the first and the last
            valid = valid_counts8(sc_d, cams, s8)
            idx = sorted({0, n - 1, *valid.argmin(1).tolist(),
                          *valid.argmax(1).tolist()})
            sub = CameraArrays(cams.position[idx], cams.basis[idx])
            ref = frame(sc_c, to_cpu(sub), len(idx), cpu)
            diff = int((out.color[idx].cpu() != ref.color).sum())
            ddiff = int((out.depth[idx].cpu() != ref.depth).sum())
            lit = float(((ref.color >> 24) & 255 == 255).float().mean())
            print(f"{label}: {WIDTH}x{HEIGHT}, valid surfaces per "
                  f"instance {int(valid.sum(0).min())}-"
                  f"{int(valid.sum(0).max())}, instances {idx} card vs CPU "
                  f"{diff} differing pixels, {ddiff} depth, lit {lit:.3f}")
            if diff or ddiff or lit < 0.2:
                _fail(f"{label}: {diff} pixels, {ddiff} depth, lit {lit}")
    phase_done("play: the 8-bit pipeline")

    # ---- the exact sky mesh walk ----
    rng = np.random.default_rng(SEED + 4)
    poses = [(float(rng.uniform(-0.4, 0.4)), float(rng.uniform(0, 6.28)))
             for _ in range(N_SKY_EXACT)]
    basis = torch.from_numpy(np.stack([build.camera_basis(p, y)
                                       for p, y in poses]))
    for sky_name in ("night", "sunset"):
        cfg = ts.sky_config(S, sky_name)
        t_d = sky_ops.build_sky_tables(cfg, device=dev)
        t_c = sky_ops.build_sky_tables(cfg, device=cpu)
        for n in (1, N_SKY_EXACT):
            cams = CameraArrays(torch.zeros(n, 3), basis[:n])

            def walk(tables, cams_, h=HEIGHT, w=WIDTH):
                fb = raster_ref.new_framebuffer(
                    h, w, "inv", n=cams_.position.shape[0],
                    device=cams_.position.device)
                return sky_ops.render_skybox(tables, cams_, h, w,
                                             exact=True, fb=fb)

            label = f"exact sky, {sky_name}, N={n}"
            out = timed(label, lambda: walk(t_d, CameraArrays(
                *(x.to(dev) for x in cams))))
            ref = walk(t_c, cams)
            diff = int((out.color.cpu() != ref.color).sum())
            print(f"{label}: {WIDTH}x{HEIGHT}, card vs CPU {diff} differing "
                  f"pixels")
            if diff or bool(out.depth.any()):
                _fail(f"{label}: {diff} pixels differ from the CPU")
        gh, gw = 120, 160
        cams = CameraArrays(torch.zeros(1, 3, device=dev),
                            basis[:1].to(dev))
        out = walk(t_d, cams, gh, gw).color[0].cpu().numpy()
        gpix = np.zeros((gh, gw, 3), np.uint8)
        G.render_skybox_scalar(
            gpix, t_c.all_dirs.numpy(), t_c.all_colors.numpy(),
            t_c.all_faces.numpy(), basis[0].numpy(),
            star_spec=dict(dirs=t_c.star_dirs.numpy(),
                           phase=t_c.star_phase.numpy(),
                           color=t_c.star_color.numpy(),
                           size=t_c.star_size, twinkle=t_c.star_twinkle,
                           enabled=t_c.stars_enabled), time=t_c.time)
        ours = np.stack([(out >> sh) & 255 for sh in (0, 8, 16)], -1)
        gdiff = int((ours != gpix).any(-1).sum())
        print(f"exact sky, {sky_name}: {gw}x{gh}, card vs the numpy "
              f"golden {gdiff} differing pixels")
        if gdiff:
            _fail(f"exact sky, {sky_name}: {gdiff} pixels differ from "
                  f"skybox_golden")
    phase_done("play: the exact sky")

    # ---- ECS systems at N_ECS instances ----
    def populate(device):
        r = np.random.default_rng(SEED + 5)

        def pos(spread=2.0):
            return torch.from_numpy(r.uniform(
                -spread, spread, (N_ECS, 3)).astype(np.float32)).to(device)

        s = st.new_state(N_ECS, ECS_CAPACITY, device=device)
        s, player = st.spawn(s, st.KIND_PLAYER, pos(), hp=20,
                             team=st.TEAM_PLAYER, hurtbox_radius=1.0)
        s, enemy = st.spawn_enemy(s, pos(), hp=12)
        for team in (st.TEAM_ENEMY, st.TEAM_PLAYER, st.TEAM_NEUTRAL):
            s, _ = st.spawn_projectile(s, pos(), pos(5.0), 4, enemy,
                                       team=team)
        s, door = st.spawn_door(s, pos(), required_key=3)
        s, cp = st.spawn_checkpoint(s, pos())
        s, item = st.spawn(s, st.KIND_ITEM, pos(), item_amount=7)
        s, key = st.spawn(s, st.KIND_KEY, pos(), key_type=3)
        keys = torch.from_numpy(r.integers(-1, 5, (N_ECS, 4)).astype(
            np.int32)).to(device)
        return s, (player, door, cp, item, key, keys)

    def systems(device):
        s, (player, door, cp, item, key, keys) = populate(device)
        e = ev.new_events(N_ECS, 8, device=device)
        s, e = sy.combat_system(s, e, 1.0 / 60.0)
        s, opened, e = sy.try_open_door(s, door, player, keys, e)
        s, e = sy.activate_checkpoint(s, cp, player, e)
        s, e = sy.collect_item(s, item, player, e)
        s, e = sy.collect_item(s, key, player, e)
        s = sy.integrate_velocities(s, 1.0 / 60.0)
        return s, e, opened, sy.global_positions(s)

    out = timed(f"ECS systems, N={N_ECS}", lambda: systems(dev))
    ref = systems(cpu)

    def leaves(tree):
        if isinstance(tree, torch.Tensor):
            return [tree]
        return [x for t in tree for x in leaves(t)]

    got, want = leaves(out), leaves(ref)
    bad = sum(int((a.cpu() != b).sum()) for a, b in zip(got, want))
    hits = int(ref[1].damage.count.sum())
    print(f"ECS systems: N={N_ECS}, {ECS_CAPACITY} slots, card vs CPU "
          f"{bad} differing values in {len(got)} fields; damage events "
          f"{hits}, doors opened {int(ref[2].sum())}")
    if bad or len(got) != len(want) or hits == 0:
        _fail(f"ECS systems: {bad} values differ, {hits} damage events")
    phase_done("play: ECS systems")
    print("play path, ms a call (CUDA events, after one warm-up call): "
          + ", ".join(f"{k} {v:.3f}" for k, v in times.items()) + f" {card}")

    # ---- the card's game tick against the CPU's ----
    import torch_tick_drift as td
    from bonnie32_tpu_torch import rollout
    tick_level = ts.cave_size_level(L)
    sides = [(rollout.build_env(tick_level, ts.textures(), ts.resolver,
                                device=d), d) for d in (dev, cpu)]
    drift = td.tick_drift(tick_level, sides, N_TICK_DRIFT, TICK_DRIFT_FRAMES,
                          SEED)
    print(f"game tick, card vs CPU: N={N_TICK_DRIFT}, Cave-size level, "
          f"seeded actions, each side from its own states:\n"
          + td.summary(drift))
    faults = td.held_faults(drift)
    if faults:
        _fail(f"the card's tick leaves the CPU's tolerance (rtol "
              f"{td.RTOL}, atol {td.ATOL}, integers exact) on frames "
              f"1-{td.HELD}: {faults}")
    phase_done("play: the card's tick vs the CPU's")



def run_editor(dev, card, phase_done, reset_counts, read_counts):
    """The editor and modeler viewports on `dev` (torch code: no kernel
    of the table launches), each held against the same call on the CPU:

      * the world editor's 3-D view: render_editor_viewport with
        RasterSettings.modeler() at 640x480 and 320x240 on the three
        levels of tests/torch_editor_cases.py — the Cave-size level (a
        selected floor face, a hovered face, the floor-placement
        preview), the two-room level with a wall and a horizontal portal,
        and the asset level with its AssetLibrary (the light octahedra)
        and a player-spawn object (its cylinder): colour and depth card =
        CPU, 0 differing pixels; GRID_INNER, ROOM_CURRENT, both portal
        colours, SELECT_COLOR, HOVER_COLOR, GIZMO_LIGHT and GIZMO_PLAIN
        each occur on the card's frames;
      * render_player_camera_preview on the Cave-size level: card = CPU,
        the green cylinder drawn;
      * UiContext.paint of a queue with every command kind (fills at
        alpha 128 and 255, overlapping alpha lines, a clipped triangle,
        circles, clipped text, an image) and two icons, at 640x480:
        0 differing words;
      * the modeler: render_all_views of a two-cube MeshProject (320x240
        panes), composite_views and paint; render_view_with_skeleton with
        a posed five-bone rig in the perspective and the front pane; the
        asset browser's render_preview of the two-part asset: 0 differing
        pixels (the skeleton's geometry is built on the host, so the
        card's sin and cos do not reach it);
      * the pose math on tensors (pose_bones, bone_tips, rotate_by_euler
        both ways): card vs CPU within 1e-3, the largest difference
        printed (sin and cos differ by ulps between the libraries);
      * picking: screen_to_ray and ray_plane_intersection at every pixel
        of 320x240 from the Cave editor camera, pick_triangle over the
        Cave-size level's triangles for N_PICK_RAYS seeded rays: equal
        values, masks and indices.

    The entry points run on their default device, which must be the
    card.  Each is timed once after a warm-up call, between CUDA events,
    with no kernel launch; the overlay pass (draw_viewport_overlays) is
    also timed alone over each finished view."""
    import numpy as np
    import torch

    import torch_editor_cases as ec
    import torch_scenes as ts
    from bonnie32_tpu_torch import ui
    from bonnie32_tpu_torch.config import RasterSettings
    from bonnie32_tpu_torch.editor import model_browser as MB
    from bonnie32_tpu_torch.editor import state as ES
    from bonnie32_tpu_torch.editor import viewport_edit as VE
    from bonnie32_tpu_torch.editor import viewport_render as VR
    from bonnie32_tpu_torch.models import animation as AN
    from bonnie32_tpu_torch.models import asset as A
    from bonnie32_tpu_torch.models import build
    from bonnie32_tpu_torch.models import level as L
    from bonnie32_tpu_torch.models import mesh as M
    from bonnie32_tpu_torch.models import modeler_viewport as MV
    from bonnie32_tpu_torch.models import scene
    from bonnie32_tpu_torch.models import user_texture as U
    from bonnie32_tpu_torch.ops import picking as pk
    from bonnie32_tpu_torch.types import FrameBuffers

    cpu = torch.device("cpu")
    evs = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    times = {}

    def timed(label, fn):
        """fn() once untimed, then once between CUDA events; no kernel of
        the table may launch.  Returns the timed call's result."""
        fn()
        torch.cuda.synchronize()
        reset_counts()
        evs[0].record()
        out = fn()
        evs[1].record()
        torch.cuda.synchronize()
        counts = read_counts()
        if any(counts.values()):
            _fail(f"editor, {label}: launches {counts}, want none")
        times[label] = evs[0].elapsed_time(evs[1])
        return out

    def on_card(label, t):
        if t.device.type != dev.type:
            _fail(f"editor, {label}: ran on {t.device}, not on {dev}")

    def differ(a, b):
        """Elements of a (on any device) that differ from b on the CPU."""
        a = a.cpu()
        if a.dtype.is_floating_point:
            return int((~((a == b) | (torch.isnan(a) & torch.isnan(b))))
                       .sum())
        return int((a != b).sum())

    def word(rgb):
        return int(np.uint32(rgb[0] | (rgb[1] << 8) | (rgb[2] << 16)
                             | (255 << 24)).astype(np.int32))

    # ---- the world editor's 3-D view on three levels, two sizes ----
    colours = ("GRID_INNER", "ROOM_CURRENT", "PORTAL_HORIZONTAL",
               "PORTAL_WALL", "SELECT_COLOR", "HOVER_COLOR", "GIZMO_LIGHT",
               "GIZMO_PLAIN")
    seen = dict.fromkeys(colours, 0)
    settings = RasterSettings.modeler()
    cases = {}
    for name in ec.EDITOR_CASES:
        st, ed, hv, tex, kw = ec.editor_case(name, L, ES, VE, A, M, U, scene)
        sc_d = scene.compile_level(st.level, tex, ts.resolver, device=dev,
                                   **kw)
        sc_c = scene.compile_level(st.level, tex, ts.resolver, device=cpu,
                                   **kw)
        cases[name] = (st, sc_d, sc_c)
        for w, h in EDITOR_SIZES:
            label = f"editor view, {name} level, {w}x{h}"
            out = timed(label, lambda: VR.render_editor_viewport(
                st, sc_d, w, h, settings=settings, editor=ed, hover=hv))
            on_card(label, out.color)
            ref = VR.render_editor_viewport(st, sc_c, w, h, settings=settings,
                                            editor=ed, hover=hv, device=cpu)
            dc, dd = differ(out.color, ref.color), differ(out.depth,
                                                          ref.depth)
            counts = {c: int((out.color == word(getattr(VR, c))).sum())
                      for c in colours}
            for c in colours:
                seen[c] += counts[c]
            print(f"{label}: card vs CPU {dc} differing pixels, {dd} depth; "
                  f"overlay pixels " + ", ".join(
                      f"{c} {n}" for c, n in counts.items() if n))
            if dc or dd or tuple(out.color.shape) != (1, h, w):
                _fail(f"{label}: {dc} pixels, {dd} depth differ from the CPU")
            # the overlay pass alone, over the finished view
            timed(f"overlay pass alone, {name} level, {w}x{h}",
                  lambda: VR.draw_viewport_overlays(out, st, editor=ed,
                                                    hover=hv))
    missing = [c for c, n in seen.items() if not n]
    if missing:
        _fail(f"editor view: overlay colours {missing} never drawn")

    st, sc_d, sc_c = cases["cave"]
    room = st.level.rooms[0]
    obj = L.AssetInstance(sector_x=4, sector_z=4, asset_id=A.PLAYER_SPAWN_ID)
    label = "player camera preview, Cave-size level, 320x240"
    out = timed(label, lambda: VR.render_player_camera_preview(
        st, room, obj, 320, 240, scene=sc_d))
    ref = VR.render_player_camera_preview(st, room, obj, 320, 240,
                                          scene=sc_c, device=cpu)
    diff = int((out != ref).sum())
    green = int((out == word((100, 255, 100))).sum())
    print(f"{label}: card vs CPU {diff} differing pixels, cylinder pixels "
          f"{green}")
    if diff or green < 20:
        _fail(f"{label}: {diff} pixels differ, {green} cylinder pixels")
    phase_done("editor: the 3-D view and the camera preview")

    # ---- UiContext.paint and the icons at 640x480 ----
    rng = np.random.default_rng(SEED + 6)
    bg = (rng.integers(0, 1 << 24, (1, 480, 640)) | (255 << 24)).astype(
        np.uint32).view(np.int32)

    def paint(device):
        fb = FrameBuffers(color=torch.from_numpy(bg).to(device),
                          depth=torch.zeros((1, 480, 640), device=device))
        fb = ec.paint_queue(ui, scale=4).paint(fb)
        for name, scale, rect in ec.ICONS[:2]:
            fb = ui.icons.draw_icon_centered(
                fb, name, ui.Rect(*(4 * v for v in rect)), (255, 220, 40),
                scale=4 * scale)
        return fb.color

    label = "UiContext.paint, every command kind and two icons, 640x480"
    out = timed(label, lambda: paint(dev))
    on_card(label, out)
    ref = paint(cpu)
    diff = differ(out, ref)
    painted = int((ref != torch.from_numpy(bg)).sum())
    print(f"{label}: card vs CPU {diff} differing words of "
          f"{painted} painted")
    if diff or painted < 10000:
        _fail(f"{label}: {diff} words differ, {painted} painted")
    phase_done("editor: UiContext.paint")

    # ---- the modeler's panes, the skeleton, the asset preview ----
    vp = ec.viewports(MV)
    mesh, faces, atlas = MV.project_arrays(ec.mesh_project(M))
    lights = build.lights_from_list(ts.DEFAULT_LIGHT_SPECS, ambient=0.5)
    bounds = ui.Rect(0, 0, 640, 480)
    msettings = RasterSettings.modeler()

    def views(device=None):
        frames = MV.render_all_views(vp, mesh, faces, atlas, lights,
                                     msettings, bounds, pane_h=240,
                                     pane_w=320, device=device)
        ctx = ui.UiContext()
        ctx.begin_frame(0, 0, False)
        MV.composite_views(ctx, vp, frames, bounds)
        blank = FrameBuffers(
            color=torch.zeros((1, 480, 640), dtype=torch.int32,
                              device=frames[MV.ViewportId.TOP].color.device),
            depth=torch.zeros((1, 480, 640),
                              device=frames[MV.ViewportId.TOP].color.device))
        return frames, ctx.paint(blank).color

    label = "modeler, four 320x240 panes, composited and painted"
    frames, comp = timed(label, views)
    rframes, rcomp = views(cpu)
    on_card(label, comp)
    diffs = {v.value: differ(frames[v].color, rframes[v].color)
             for v in frames}
    dcomp = differ(comp, rcomp)
    print(f"{label}: card vs CPU differing pixels per pane {diffs}, "
          f"composite {dcomp}")
    if any(diffs.values()) or dcomp or len(frames) != 4:
        _fail(f"{label}: {diffs}, composite {dcomp}")
    bones, posed = ec.rig(AN), ec.pose(AN)
    for view in (MV.ViewportId.PERSPECTIVE, MV.ViewportId.FRONT):
        label = f"modeler skeleton, {view.value} pane, 320x240"
        args = (vp, view, mesh, faces, atlas, lights, msettings, 240, 320,
                bones)
        out = timed(label, lambda: MV.render_view_with_skeleton(
            *args, pose=posed))
        ref = MV.render_view_with_skeleton(*args, pose=posed, device=cpu)
        base = MV.render_view(*args[:-1], device=cpu)
        diff = differ(out.color, ref.color) + differ(out.depth, ref.depth)
        bone_px = int((ref.color != base.color).sum())
        print(f"{label}: card vs CPU {diff} differing pixels and depths, "
              f"bone pixels {bone_px}")
        if diff or bone_px < 50:
            _fail(f"{label}: {diff} differ, {bone_px} bone pixels")
    lib = ts.asset_library(A, M)
    utex = ts.user_textures(U)
    browser = MB.AssetBrowser()
    browser.orbit_distance = 2200.0
    browser.orbit_center = (0.0, 300.0, 0.0)
    label = "asset preview, two-part asset, 320x240"
    out = timed(label, lambda: browser.render_preview(
        lib.assets[ts.ASSET_ID], user_textures=utex))
    on_card(label, out.color)
    ref = browser.render_preview(lib.assets[ts.ASSET_ID], user_textures=utex,
                                 device=cpu)
    diff = differ(out.color, ref.color)
    drawn = int((ref.color != ref.color.reshape(-1)[0]).sum())
    print(f"{label}: card vs CPU {diff} differing pixels, {drawn} drawn")
    if diff or drawn < 1000:
        _fail(f"{label}: {diff} pixels differ, {drawn} drawn")
    phase_done("editor: the modeler and the asset preview")

    # ---- the pose math on tensors: the card's sin and cos ----
    parent, lp, lr, ln = AN.bones_to_arrays(bones)
    arng = np.random.default_rng(SEED + 8)
    pose_p = torch.from_numpy(arng.uniform(-30, 30, (256, 5, 3)).astype(
        np.float32))
    pose_r = torch.from_numpy(arng.uniform(-40, 40, (256, 5, 3)).astype(
        np.float32))
    vec = torch.from_numpy(arng.uniform(-500, 500, (4096, 3)).astype(
        np.float32))
    rot = torch.from_numpy(arng.uniform(-180, 180, (4096, 3)).astype(
        np.float32))

    def pose_math(device):
        wp, wr = AN.pose_bones(parent, lp.to(device), lr.to(device),
                               pose_p.to(device), pose_r.to(device))
        v, r = vec.to(device), rot.to(device)
        return (wp, wr, AN.bone_tips(wp, wr, ln.to(device)),
                AN.rotate_by_euler(v, r), AN.inverse_rotate_by_euler(v, r))

    label = "pose math, 256 posed frames of the rig, 4096 rotations"
    out = timed(label, lambda: pose_math(dev))
    on_card(label, out[0])
    ref = pose_math(cpu)
    worst = max(float((a.cpu() - b).abs().max()) for a, b in zip(out, ref))
    apart = sum(differ(a, b) for a, b in zip(out, ref))
    print(f"{label}: card vs CPU {apart} values apart, largest |difference| "
          f"{worst:.3e} world units or degrees (sin and cos differ by ulps "
          f"between the card's and the CPU's libraries; limit 1e-3)")
    if worst > 1e-3:
        _fail(f"{label}: card and CPU {worst} apart")

    # ---- picking ----
    st = cases["cave"][0]
    cam_pos = torch.from_numpy(np.asarray(st.camera_pos, np.float32))
    basis = torch.from_numpy(np.asarray(st.camera_basis(), np.float32))
    ys, xs = torch.meshgrid(torch.arange(240, dtype=torch.float32),
                            torch.arange(320, dtype=torch.float32),
                            indexing="ij")

    def rays(device):
        o, d = pk.screen_to_ray(xs.to(device), ys.to(device), 320, 240,
                                cam_pos.to(device), basis.to(device))
        t, ok = pk.ray_plane_intersection(
            o, d, torch.tensor([0.0, 600.0, 0.0], device=device),
            torch.tensor([0.0, 1.0, 0.0], device=device))
        return o, d, t, ok

    label = "picking, screen_to_ray + ray_plane_intersection, 320x240"
    out = timed(label, lambda: rays(dev))
    on_card(label, out[1])
    ref = rays(cpu)
    diffs = [differ(a, b) for a, b in zip(out, ref)]
    hits = int(ref[3].sum())
    print(f"{label}: card vs CPU differing origin, direction, t, mask "
          f"{diffs}; {hits} pixels hit the plane")
    if any(diffs) or hits == 0 or hits == 320 * 240:
        _fail(f"{label}: {diffs} differ, {hits} hits")
    sc_c = cases["cave"][2]
    keep = sc_c.faces.valid[0]
    tris = sc_c.mesh.pos[0][sc_c.faces.vidx[0][keep].long()]      # (T, 3, 3)
    prng = np.random.default_rng(SEED + 7)
    px = torch.from_numpy(prng.uniform(0, 320, N_PICK_RAYS).astype(
        np.float32))
    py = torch.from_numpy(prng.uniform(0, 240, N_PICK_RAYS).astype(
        np.float32))

    def pick(device):
        o, d = pk.screen_to_ray(px.to(device), py.to(device), 320, 240,
                                cam_pos.to(device), basis.to(device))
        return pk.pick_triangle(o, d, tris.to(device))

    label = (f"picking, pick_triangle, {N_PICK_RAYS} rays over "
             f"{tris.shape[0]} triangles")
    out = timed(label, lambda: pick(dev))
    on_card(label, out[0])
    ref = pick(cpu)
    diffs = [differ(a, b) for a, b in zip(out, ref)]
    n_hit = int(ref[2].sum())
    print(f"{label}: card vs CPU differing index, t, hit {diffs}; "
          f"{n_hit} rays hit")
    if any(diffs) or n_hit < N_PICK_RAYS // 2:
        _fail(f"{label}: {diffs} differ, {n_hit} hits")
    phase_done("editor: picking")
    print("editor path, ms a call (CUDA events, after one warm-up call): "
          + ", ".join(f"{k} {v:.3f}" for k, v in times.items()) + f" {card}")


def _audio_deltas(total, rate, rng, overshoot=2000):
    """render_audio deltas: mostly one 60 Hz frame, a quarter of them one
    of tests/test_audio_stream.py's ragged sizes (37, 256, 441, 1,000 or
    1,361 samples), until `overshoot` samples past the horizon."""
    import numpy as np
    sizes = np.array([37, 256, 441, 1000, 1361])
    deltas, produced = [], 0.0
    while produced < total + overshoot:
        if rng.random() < 0.25:
            k = float(sizes[rng.integers(len(sizes))])
            deltas.append(k / rate)
        else:
            k = rate / 60.0
            deltas.append(1.0 / 60.0)
        produced += k
    return deltas


def _reverb_words(params, ticks):
    """The work-buffer words a reverb call must move for `ticks` 22.05 kHz
    ticks with the registers `params` (32,), its reads and writes walked
    in the order of `reverb.process_ref`: (reads, writes), each summed
    over both sides.  A word counts as one read where the call reads it
    before it writes it (a word the call wrote is read back from what it
    wrote, not from memory), and as one write however often it is
    written.  The count does not depend on the start position."""
    from bonnie32_tpu_torch.audio import reverb as rvb
    p = {k: int(params[i]) for k, i in rvb._IDX.items()}

    def back(name, sub):
        return (p[name] - sub) & 0xFFFF
    # one tick: (side, offset from pos, whether it writes)
    tick = [("l", p["d_l_same"], 0), ("l", back("m_l_same", 2), 0),
            ("l", p["m_l_same"], 1),
            ("r", p["d_r_same"], 0), ("r", back("m_r_same", 2), 0),
            ("r", p["m_r_same"], 1),
            ("r", p["d_r_diff"], 0), ("l", back("m_l_diff", 2), 0),
            ("l", p["m_l_diff"], 1),
            ("l", p["d_l_diff"], 0), ("r", back("m_r_diff", 2), 0),
            ("r", p["m_r_diff"], 1)]
    tick += [(s, p[f"m_{s}_comb{k}"], 0) for s in "lr" for k in range(1, 5)]
    for stage in "12":
        for s in "lr":
            m = f"m_{s}_apf{stage}"
            tick += [(s, back(m, p[f"d_apf{stage}"]), 0), (s, p[m], 1)]
    read, written = set(), set()
    for t in range(ticks):
        for side, off, writes in tick:
            word = (side, (t + off) & (rvb.BUFFER_SIZE - 1))
            if writes:
                written.add(word)
            elif word not in written:
                read.add(word)
    return len(read), len(written)


def run_audio(dev, card, phase_done, reset_counts, read_counts):
    """The tracker's audio path on `dev`: host synthesis (numpy), then the
    master gain, the SPU reverb (`spu_reverb`) and the Gaussian resampler
    (`spu_resample`) of csrc/audio.cu on the card.

      (a) `spu_reverb` against its twin `reverb.process_ref` on the card:
          all nine presets x AUDIO_STREAMS seeded streams (noise at
          levels from quiet to clipping, and square waves loud enough
          that `_mul_vol`'s product wraps) in one batched call of
          AUDIO_CHECK samples, the state carried into a second; then all
          ten presets (OFF too) from buffers of seeded int16 words at pos
          0x20000 - 300, so that windows straddle the wrap and far reads
          return words, calls of WRAP_LENGTHS samples with the state
          carried, at S = WRAP_STREAMS and at S = 1 (each preset alone):
          0 differing output samples, buffer words, pos and accum;
      (b) `spu_resample` against `resampler.process_ref` at pitches
          0x0800, 0x0400 and 0x0200, AUDIO_STREAMS streams, two calls of
          RESAMPLE_CHECK / 2 samples; then at each pitch calls of 1,
          ratio - 1, 37, 735 and 4,096 samples and two at the next
          pitch (a carried count may reach the new ratio): 0 differing;
      (c) a real-size song (tests/torch_scenes.py `demo_song`: 8 channels,
          4 patterns of 64 rows in order, 120 bpm at 4 rows a beat: 32 s,
          1,411,200 samples; channels 0-4 one per oscillator family,
          reverb HALL at wet 80, channel 0 at 22 kHz so the resampler
          runs): `engine.render_song` (one launch of each kernel) against
          an `AudioStream` driven by 60 Hz deltas with ragged ones mixed
          in (one launch of each kernel per call that renders), 0
          differing samples; then the same song with only channel 1's
          notes through the SoundFont `sine_font` (the synth plays every
          channel through the SoundFont or every channel through the
          oscillators, never both), the same check; a short song
          (6 rows at 1,200 bpm) card vs CPU, 0 differing samples;
      (d) times: the song's render and its split (host synth, copy to
          the card, gain + reverb, resampler, copy back), the ms per
          render_audio(1/60) call and the real-time factor, and each
          kernel's ms at S = 1 x 735 samples (one 60 Hz frame), S = 1 x
          AUDIO_CHUNK and S = AUDIO_WIDE x AUDIO_CHUNK, queued behind a
          matrix product (a call shorter than its wrapper's host time is
          timed on the card), with the ns per 22.05 kHz tick and per
          sample; then both kernels against their twins at the main
          path's shapes (S = 1, one 735-sample frame and a ragged
          37-sample call, the state carried and updated in place as
          SpuChain does): 0 differing.

    Returns the two kernels' rows of the `kernels` line: ms and plain ms
    at the streamed chunk (S = 1, one 60 Hz frame of 735 samples), the
    launches of the streamed run, the largest difference from the twin
    over (a), (b) and the main path's shapes, and the bound: the largest
    of the bytes that chunk must move (`_reverb_words`), its operations
    and, for the reverb, its chain (the longest loop-carried path of one
    stream at CHAIN_CYCLES a dependent instruction and the card's top SM
    clock), `bound_by` naming which."""
    import time

    import numpy as np
    import torch

    import torch_scenes as ts
    from bonnie32_tpu_torch.audio import engine
    from bonnie32_tpu_torch.audio import resampler as rsp
    from bonnie32_tpu_torch.audio import reverb as rvb
    from bonnie32_tpu_torch.audio import sf2
    from bonnie32_tpu_torch.audio import song as M
    from bonnie32_tpu_torch.audio import stream as strm

    cpu = torch.device("cpu")
    rng = np.random.default_rng(SEED)
    rate = strm.SAMPLE_RATE
    err = {}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    ballast = torch.ones((4096, 4096), device=dev)

    def events_ms(fn, reps, queued=False):
        """fn() once untimed, then `reps` calls between CUDA events: ms
        a call.  `queued`: the calls wait behind a matrix product, so that
        all are enqueued before the first runs and a kernel shorter than
        its wrapper's host time is timed on the card."""
        fn()
        evs = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        sync()
        if queued:
            torch.matmul(ballast, ballast)
        evs[0].record()
        for _ in range(reps):
            fn()
        evs[1].record()
        sync()
        return evs[0].elapsed_time(evs[1]) / reps

    # ---- (a) spu_reverb vs its twin: every preset, loud inputs too ----
    n_pre = 9
    s_all = n_pre * AUDIO_STREAMS
    params = np.repeat(np.stack([rvb.preset_params(p)
                                 for p in range(1, n_pre + 1)]),
                       AUDIO_STREAMS, 0)
    n = 2 * AUDIO_CHECK
    sigma = rng.uniform(0.02, 1.5, (s_all, 1))
    left = (rng.standard_normal((s_all, n)) * sigma).astype(np.float32)
    right = (rng.standard_normal((s_all, n)) * sigma).astype(np.float32)
    square = np.where((np.arange(n) // 50) % 2 == 0, 1.0, -1.0)
    left[::AUDIO_STREAMS // 2] = square       # two loud streams a preset
    right[::AUDIO_STREAMS // 2] = -square
    wet = 80 / 127.0
    st_k = rvb.init_state(dev, streams=s_all)
    st_p = rvb.init_state(dev, streams=s_all)
    diffs = {"out": 0, "buffer words": 0, "pos": 0, "accum": 0}
    worst = 0.0
    for a in (0, AUDIO_CHECK):
        seg = slice(a, a + AUDIO_CHECK)
        lt = torch.from_numpy(left[:, seg]).to(dev)
        rt = torch.from_numpy(right[:, seg]).to(dev)
        st_k, kl, kr = rvb.process(st_k, lt, rt, params, wet)
        st_p, pl, pr = rvb.process_ref(st_p, lt, rt, params, wet)
        sync()
        diffs["out"] += int((kl != pl).sum() + (kr != pr).sum())
        worst = max(worst, float((kl - pl).abs().max()),
                    float((kr - pr).abs().max()))
        diffs["buffer words"] += int((st_k.buffer_l != st_p.buffer_l).sum()
                                     + (st_k.buffer_r != st_p.buffer_r)
                                     .sum())
        diffs["pos"] += int((st_k.pos != st_p.pos).sum())
        diffs["accum"] += int((st_k.accum != st_p.accum).sum())
    print(f"audio (a): spu_reverb vs process_ref, {n_pre} presets x "
          f"{AUDIO_STREAMS} streams, {AUDIO_CHECK} samples x 2 calls "
          f"(state carried): differing {diffs}, largest output difference "
          f"{worst}")
    if any(diffs.values()) or not bool(st_k.buffer_l.any()):
        _fail(f"spu_reverb disagrees with its twin: {diffs}")
    err["spu_reverb"] = worst

    # all ten presets from buffers of seeded int16 words, pos 300 words
    # before the wrap, calls of WRAP_LENGTHS samples with the state
    # carried: WRAP_STREAMS streams in one batched call (stream k plays
    # preset k % 10), and streams 0-9 each alone (S = 1), both against
    # the twin's batched rows
    s_w = WRAP_STREAMS
    n_w = sum(WRAP_LENGTHS)
    params_w = np.stack([rvb.preset_params(k % 10) for k in range(s_w)])
    words = rng.integers(-32768, 32768, (2, s_w, rvb.BUFFER_SIZE)
                         ).astype(np.int32)
    sigma = rng.uniform(0.02, 1.5, (s_w, 1))
    xw = (rng.standard_normal((2, s_w, n_w)) * sigma).astype(np.float32)
    xw[0, 10:20] = np.where((np.arange(n_w) // 50) % 2 == 0, 1.0, -1.0)
    xw[1, 10:20] = -xw[0, 10:20]              # loud: one stream a preset
    xw_dev = torch.from_numpy(xw).to(dev)

    def wrap_state(rows):
        return rvb.ReverbState(
            buffer_l=torch.from_numpy(words[0, rows]).to(dev),
            buffer_r=torch.from_numpy(words[1, rows]).to(dev),
            pos=torch.full((len(rows),), rvb.BUFFER_SIZE - 300,
                           dtype=torch.int32, device=dev),
            accum=torch.full((len(rows),), 0.5, device=dev))

    twin = wrap_state(list(range(s_w)))
    wide = wrap_state(list(range(s_w)))
    alone = [wrap_state([k]) for k in range(10)]
    diffs = {"out": 0, "buffer words": 0, "pos": 0, "accum": 0}
    worst = 0.0

    def count(outs, ref_outs, st, ref_st):
        nonlocal worst
        for a, b in zip(outs, ref_outs):
            diffs["out"] += int((a != b).sum())
            worst = max(worst, float((a - b).abs().max()))
        diffs["buffer words"] += int((st.buffer_l != ref_st.buffer_l).sum()
                                     + (st.buffer_r != ref_st.buffer_r)
                                     .sum())
        diffs["pos"] += int((st.pos != ref_st.pos).sum())
        diffs["accum"] += int((st.accum != ref_st.accum).sum())

    a = 0
    for ln in WRAP_LENGTHS:
        seg = slice(a, a + ln)
        lt, rt = xw_dev[0, :, seg], xw_dev[1, :, seg]
        twin, pl, pr = rvb.process_ref(twin, lt, rt, params_w, wet)
        wide, kl, kr = rvb.process(wide, lt, rt, params_w, wet, inplace=True)
        count((kl, kr), (pl, pr), wide, twin)
        for k in range(10):
            alone[k], kl, kr = rvb.process(alone[k], lt[k:k + 1],
                                           rt[k:k + 1], params_w[k], wet,
                                           inplace=True)
            count((kl, kr), (pl[k:k + 1], pr[k:k + 1]), alone[k],
                  rvb.ReverbState(*(t[k:k + 1] for t in twin)))
        a += ln
    sync()
    crossed = int((twin.pos < rvb.BUFFER_SIZE - 300).sum())
    print(f"audio (a): spu_reverb vs process_ref, all ten presets from "
          f"pre-filled buffers at pos {rvb.BUFFER_SIZE - 300:#x}, calls of "
          f"{WRAP_LENGTHS} samples (state carried), S={s_w} and S=1 x 10: "
          f"differing {diffs}, largest output difference {worst}; "
          f"{crossed} of {s_w} streams crossed the wrap")
    if any(diffs.values()) or crossed != s_w:
        _fail(f"spu_reverb across the wrap disagrees with its twin: "
              f"{diffs}, {crossed} streams crossed")
    err["spu_reverb"] = max(err["spu_reverb"], worst)
    phase_done("audio: spu_reverb vs plain")

    # ---- (b) spu_resample vs its twin ----
    worst = 0.0
    for pitch in (rsp.PITCH_22K, rsp.PITCH_11K, rsp.PITCH_5K):
        st_k = rsp.init_state(dev, streams=AUDIO_STREAMS)
        st_p = rsp.init_state(dev, streams=AUDIO_STREAMS)
        sig = (rng.standard_normal((AUDIO_STREAMS, RESAMPLE_CHECK))
               * rng.uniform(0.05, 1.2, (AUDIO_STREAMS, 1))
               ).astype(np.float32)
        bad = 0
        half = RESAMPLE_CHECK // 2 + 1
        for seg in (slice(0, half), slice(half, RESAMPLE_CHECK)):
            lt = torch.from_numpy(sig[:, seg]).to(dev)
            rt = torch.from_numpy(-sig[:, seg] * 0.5).to(dev)
            st_k, kl, kr = rsp.process(st_k, lt, rt, pitch)
            st_p, pl, pr = rsp.process_ref(st_p, lt, rt, pitch)
            sync()
            bad += int((kl != pl).sum() + (kr != pr).sum())
            bad += sum(int((a != b).sum()) for a, b in zip(st_k, st_p))
            worst = max(worst, float((kl - pl).abs().max()),
                        float((kr - pr).abs().max()))
        print(f"audio (b): spu_resample vs process_ref, pitch {pitch:#06x},"
              f" {AUDIO_STREAMS} streams, {RESAMPLE_CHECK} samples in two "
              f"calls: {bad} differing samples and state values")
        if bad:
            _fail(f"spu_resample at pitch {pitch:#x} disagrees with its "
                  f"twin: {bad}")
    # short and long calls at each pitch, then a pitch change (the count
    # carried from a longer block can reach the new ratio)
    pitches = (rsp.PITCH_22K, rsp.PITCH_11K, rsp.PITCH_5K)
    for k, pitch in enumerate(pitches):
        ratio = rsp.PITCH_NATIVE // pitch
        after = pitches[(k + 1) % 3]
        calls = [(n_, pitch) for n_ in (1, ratio - 1, 37, 735, 4096)]
        calls += [(n_, after) for n_ in (37, 735)]
        sig = (rng.standard_normal((2, AUDIO_STREAMS,
                                    sum(n_ for n_, _ in calls)))
               * 0.6).astype(np.float32)
        sig_dev = torch.from_numpy(sig).to(dev)
        st_k = rsp.init_state(dev, streams=AUDIO_STREAMS)
        st_p = rsp.init_state(dev, streams=AUDIO_STREAMS)
        bad, a = 0, 0
        for n_, p_ in calls:
            seg = slice(a, a + n_)
            st_k, kl, kr = rsp.process(st_k, sig_dev[0, :, seg],
                                       sig_dev[1, :, seg], p_, inplace=True)
            st_p, pl, pr = rsp.process_ref(st_p, sig_dev[0, :, seg],
                                           sig_dev[1, :, seg], p_)
            bad += int((kl != pl).sum() + (kr != pr).sum())
            bad += sum(int((x != y).sum()) for x, y in zip(st_k, st_p))
            worst = max(worst, float((kl - pl).abs().max()),
                        float((kr - pr).abs().max()))
            a += n_
        sync()
        print(f"audio (b): spu_resample vs process_ref, pitch {pitch:#06x} "
              f"then {after:#06x}, calls {[n_ for n_, _ in calls]}: {bad} "
              f"differing samples and state values")
        if bad:
            _fail(f"spu_resample at pitch {pitch:#x}, short calls and a "
                  f"pitch change: {bad} differ from the twin")
    err["spu_resample"] = worst
    phase_done("audio: spu_resample vs plain")

    # ---- (c) the 32 s song: render_song vs AudioStream ----
    song = ts.demo_song(M, **AUDIO_SONG, seed=SEED)
    seconds = song.total_rows() / song.rows_per_second()
    total = int(seconds * rate)

    def stream_run(s, font, label):
        st = strm.AudioStream(s, soundfont=font, device=dev)
        deltas = _audio_deltas(st.total, rate, np.random.default_rng(SEED))
        parts_l, parts_r, calls = [], [], 0
        sync()
        reset_counts()
        t0 = time.perf_counter()
        for d in deltas:
            calls += st.render_audio(d) > 0
            l_, r_ = st.read(st.ring.available)
            parts_l.append(l_)
            parts_r.append(r_)
        wall = time.perf_counter() - t0
        counts = read_counts()
        want = {"spu_reverb": calls, "spu_resample": calls}
        if {k: counts[k] for k in want} != want or any(
                v for k, v in counts.items() if k not in want):
            _fail(f"{label} stream: launches {counts}, want {want}")
        print(f"audio (c): {label}, AudioStream: {len(deltas)} "
              f"render_audio calls ({calls} rendering), {wall:.3f} s, "
              f"launches {counts}")
        return np.concatenate(parts_l), np.concatenate(parts_r), counts

    def offline_run(s, font, label):
        sync()
        reset_counts()
        t0 = time.perf_counter()
        out = engine.render_song(s, soundfont=font, device=dev)
        wall = time.perf_counter() - t0
        counts = read_counts()
        want = {"spu_reverb": 1, "spu_resample": 1}
        if any(counts[k] != want.get(k, 0) for k in counts):
            _fail(f"{label} render_song: launches {counts}, want {want}")
        print(f"audio (c): {label}, render_song: {len(out[0])} samples "
              f"({seconds:.1f} s), {wall:.3f} s, launches {counts}")
        return out, wall

    def check_song(label, out, streamed):
        lo, ro = out
        n_ = len(lo)
        bad = int((lo != streamed[0][:n_]).sum()
                  + (ro != streamed[1][:n_]).sum())
        peak = float(np.abs(lo).max())
        finite = bool(np.isfinite(lo).all() and np.isfinite(ro).all())
        print(f"audio (c): {label}: streamed vs offline {bad} differing "
              f"samples of {2 * n_}; peak {peak:.4f}, finite {finite}")
        if bad or n_ != total or not finite or not 0.01 < peak <= 4.0:
            _fail(f"{label}: streamed vs offline {bad} differ, {n_} "
                  f"samples (want {total}), peak {peak}, finite {finite}")

    t_phase = time.perf_counter()
    osc_out, osc_wall = offline_run(song, None, "oscillators")
    osc_stream = stream_run(song, None, "oscillators")
    check_song("oscillators", osc_out, osc_stream)
    stream_launches = osc_stream[2]
    font_song = ts.demo_song(M, **AUDIO_SONG, seed=SEED)
    for pat in font_song.patterns:
        for c in range(len(pat.channels)):
            if c != AUDIO_FONT_CHANNEL:
                pat.channels[c] = [M.Note() for _ in range(pat.length)]
    font = sf2.load(ts.sine_font(sf2))
    font_out, font_wall = offline_run(font_song, font, "SoundFont")
    check_song("SoundFont", font_out,
               stream_run(font_song, font, "SoundFont"))
    short = ts.demo_song(M, patterns=1, rows=6, channels=5, bpm=1200,
                         reverb=5, rate0=2, seed=SEED)
    card_l, card_r = engine.render_song(short, device=dev)
    cpu_l, cpu_r = engine.render_song(short, device=cpu)
    bad = int((card_l != cpu_l).sum() + (card_r != cpu_r).sum())
    print(f"audio (c): short song ({len(cpu_l)} samples) card vs CPU: "
          f"{bad} differing samples")
    if bad:
        _fail(f"short song: card vs CPU {bad} differing samples")
    phase_s = time.perf_counter() - t_phase
    print(f"audio (c): the song phase took {phase_s:.1f} s {card}")
    phase_done("audio: render_song vs AudioStream")

    # ---- (d) times ----
    chain = strm.SpuChain(song, dev)
    t0 = time.perf_counter()
    synth = strm.SongSynth(song, total, rate)
    dry = synth.dry_chunk(0, total)
    t_synth = time.perf_counter() - t0
    split = {"host synth (s)": t_synth}
    sync()
    evs = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    evs[0].record()
    lr = chain.to_device(*dry)
    evs[1].record()
    mixed = chain.gain_reverb(lr)
    evs[2].record()
    res = chain.resample(*mixed)
    evs[3].record()
    back = torch.stack(res).cpu()
    evs[4].record()
    sync()
    for k, name in enumerate(("copy to the card", "gain + reverb kernel",
                              "resampler kernel", "copy back")):
        split[name + " (ms)"] = evs[k].elapsed_time(evs[k + 1])
    if not np.array_equal(back[0].numpy(), osc_out[0]):
        _fail("the split render differs from render_song")
    print(f"audio (d): render_song of the {seconds:.0f} s song: "
          f"{osc_wall:.3f} s wall (SoundFont, one channel: "
          f"{font_wall:.3f} s); split " + ", ".join(
              f"{k} {v:.3f}" for k, v in split.items()) + f" {card}")

    st = strm.AudioStream(song, device=dev)
    per_call = []
    for _ in range(AUDIO_FRAMES):
        t0 = time.perf_counter()
        st.render_audio(1.0 / 60.0)
        st.read(st.ring.available)
        per_call.append(time.perf_counter() - t0)
    per_call = np.asarray(per_call[1:]) * 1e3
    rtf = (1000.0 / 60.0) / per_call.mean()
    print(f"audio (d): render_audio(1/60) + read, {len(per_call)} calls "
          f"after one warm-up: mean {per_call.mean():.3f} ms, median "
          f"{np.median(per_call):.3f}, max {per_call.max():.3f}; real-time "
          f"factor {rtf:.2f} (audio time / wall time) {card}")

    shape_ms = {}
    for s, n_ in ((1, rate // 60), (1, AUDIO_CHUNK),
                  (AUDIO_WIDE, AUDIO_CHUNK)):
        x = torch.from_numpy((rng.standard_normal((s, n_)) * 0.4)
                             .astype(np.float32)).to(dev)
        rst = rvb.init_state(dev, streams=s)
        p = torch.from_numpy(np.repeat(rvb.preset_params(5)[None], s, 0)
                             ).to(dev)
        consts = rvb._scalars(wet, 1.0, 2.0)
        ms_rvb = events_ms(lambda: rvb.spu_reverb(rst, x, x, p, *consts,
                                                  True), AUDIO_REPS, True)
        qst = rsp.init_state(dev, streams=s)
        ms_rsp = events_ms(lambda: rsp.spu_resample(qst, x, x,
                                                    rsp.PITCH_22K, True),
                           AUDIO_REPS, True)
        ticks = n_ // 2
        shape_ms[(s, n_)] = (ms_rvb, ms_rsp)
        print(f"audio (d): S={s}, {n_}-sample chunk: spu_reverb "
              f"{ms_rvb:.4f} ms ({ms_rvb * 1e6 / ticks:.1f} ns per "
              f"22.05 kHz tick, {ms_rvb * 1e6 / ticks / s:.2f} ns per "
              f"tick and stream), spu_resample {ms_rsp:.4f} ms "
              f"({ms_rsp * 1e6 / n_:.2f} ns per sample, "
              f"{ms_rsp * 1e6 / n_ / s:.3f} per sample and stream) {card}")
    wide_ms = shape_ms[(AUDIO_WIDE, AUDIO_CHUNK)][0]
    print(f"audio (d): spu_reverb S={AUDIO_WIDE} / S=1 on "
          f"{AUDIO_CHUNK}-sample chunks: "
          f"{wide_ms / shape_ms[(1, AUDIO_CHUNK)][0]:.3f}x {card}")

    # the main path's shapes, kernel against twin: one 60 Hz frame, then
    # a ragged 37-sample call with the state carried, (N,) inputs on an
    # unbatched state updated in place, as SpuChain gives them
    chunk = rate // 60
    p_song = rvb.preset_params(song.reverb.preset)
    wet_song = np.float32(song.reverb.wet / 127.0)
    pitch = strm.resampler_pitch(song)
    xs = torch.from_numpy((rng.standard_normal((2, chunk + 37)) * 0.4)
                          .astype(np.float32)).to(dev)
    sk, sp = rvb.init_state(dev), rvb.init_state(dev)
    qk, qp = rsp.init_state(dev), rsp.init_state(dev)
    bad = {"spu_reverb": 0, "spu_resample": 0}
    worst = dict(bad)
    for seg in (slice(0, chunk), slice(chunk, chunk + 37)):
        sk, kl, kr = rvb.process(sk, xs[0, seg], xs[1, seg], p_song,
                                 wet_song, inplace=True)
        sp, pl, pr = rvb.process_ref(sp, xs[0, seg], xs[1, seg], p_song,
                                     wet_song)
        qk, ql, qr = rsp.process(qk, kl, kr, pitch, inplace=True)
        qp, rl, rr = rsp.process_ref(qp, pl, pr, pitch)
        sync()
        for name, outs, states in (("spu_reverb", (kl, kr, pl, pr), (sk, sp)),
                                   ("spu_resample", (ql, qr, rl, rr),
                                    (qk, qp))):
            a_l, a_r, b_l, b_r = outs
            bad[name] += int((a_l != b_l).sum() + (a_r != b_r).sum())
            bad[name] += sum(int((a != b).sum()) for a, b in zip(*states))
            worst[name] = max(worst[name], float((a_l - b_l).abs().max()),
                              float((a_r - b_r).abs().max()))
    print(f"audio (d): at the main path's shapes (S=1, {chunk} then 37 "
          f"samples, state carried): differing samples and state values "
          f"{bad}")
    if any(bad.values()):
        _fail(f"kernels vs twins at the main path's shapes: {bad}")
    for name in err:
        err[name] = max(err[name], worst[name])

    # the kernels' rows: the streamed chunk, S = 1, one 60 Hz frame
    x = torch.from_numpy((rng.standard_normal((1, chunk)) * 0.4)
                         .astype(np.float32)).to(dev)
    p1 = torch.from_numpy(rvb.preset_params(song.reverb.preset)[None]
                          ).to(dev)
    rst = rvb.init_state(dev, streams=1)
    ms = {"spu_reverb": events_ms(
        lambda: rvb.spu_reverb(rst, x, x, p1, *rvb._scalars(wet, 1.0, 2.0),
                               True), AUDIO_REPS, True)}
    qst = rsp.init_state(dev, streams=1)
    ms["spu_resample"] = events_ms(
        lambda: rsp.spu_resample(qst, x, x, rsp.PITCH_22K, True),
        AUDIO_REPS, True)
    rst0 = rvb.init_state(dev, streams=1)
    qst0 = rsp.init_state(dev, streams=1)
    plain = {"spu_reverb": events_ms(
        lambda: rvb.process_ref(rst0, x, x, p1, wet), 1),
        "spu_resample": events_ms(
            lambda: rsp.process_ref(qst0, x, x, rsp.PITCH_22K), 1)}
    ticks = chunk // 2
    reads, writes = _reverb_words(p1[0].cpu().numpy(), ticks)
    io = 4 * chunk * 4                      # left, right in; two outs
    by = {"spu_reverb": io + 4 * (reads + writes) + 4 * 32 + 2 * 8,
          "spu_resample": io + 2 * 4 * (2 * 4 + 4)}
    # operations: per tick 26 `mul_vol`s (multiply, shift, two clamps),
    # 30 adds and subtractions, 34 addresses (add, mask), two Q15
    # conversions (5); per sample the accumulator and the mix (8).  The
    # resampler per sample: the averaging (4, and 6 more per push), the
    # counter (4), two Gaussian sums (2 x 7 plus 8 table conversions), 4
    # clamps.  Integer instructions counted at the f32 instruction rate.
    ops = {"spu_reverb": ticks * (26 * 4 + 30 + 34 * 2 + 2 * 5) + chunk * 8,
           "spu_resample": chunk * (4 + 4 + 2 * 7 + 8 + 4)
           + (chunk // 2) * 6}
    # the reverb's chain: one stream's longest loop-carried path, at
    # CHAIN_CYCLES a dependent instruction and the card's top SM clock —
    # the IIR's CHAIN_IIR instructions from the word read back to the
    # word written, every two ticks, or the accumulator's CHAIN_ACCUM a
    # sample, whichever is longer
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    chain = {"spu_reverb": max(CHAIN_IIR * ticks / 2, CHAIN_ACCUM * chunk)}
    print(f"spu_reverb chain bound: IIR {CHAIN_IIR} dependent instructions "
          f"per 2 ticks x {ticks} ticks = {CHAIN_IIR * ticks / 2:.0f}, "
          f"accumulator {CHAIN_ACCUM} per sample x {chunk} samples = "
          f"{CHAIN_ACCUM * chunk}; {chain['spu_reverb']:.0f} x "
          f"{CHAIN_CYCLES} cycles at the top SM clock {clock_mhz:.0f} MHz "
          f"{card}")
    rows = []
    for name, src_line in (("spu_reverb", f"{JAX_AUDIO}/reverb.py:195"),
                           ("spu_resample",
                            f"{JAX_AUDIO}/resampler.py:98")):
        limits = {"bytes": by[name] / HBM_BYTES_S * 1e3,
                  "operations": ops[name] / F32_OPS_S * 1e3}
        if name in chain:
            limits["chain"] = (chain[name] * CHAIN_CYCLES
                               / (clock_mhz * 1e6) * 1e3)
        bound_by = max(limits, key=limits.get)
        bound = limits[bound_by]
        step = ticks if name == "spu_reverb" else chunk
        print(f"{name}: kernel {ms[name]:.4f} ms, plain {plain[name]:.3f} "
              f"ms, bound {bound:.6f} ms ({bound_by}; "
              + ", ".join(f"{k} {v:.6f}" for k, v in limits.items())
              + f"; {by[name]} B, {ops[name]} operations), "
              f"{bound / ms[name]:.1%} of the bound, at S=1, {chunk} "
              f"samples (one 60 Hz frame): {ms[name] * 1e6 / step:.1f} ns "
              f"per {'22.05 kHz tick' if name == 'spu_reverb' else 'sample'}"
              f" {card}")
        rows.append({"name": name, "route": "cuda", "source": AUDIO_SRC,
                     "replaces": src_line,
                     "launches": stream_launches[name],
                     "max_abs_err": err[name], "ms": ms[name],
                     "plain_ms": plain[name], "bound_ms": bound,
                     "bound_by": bound_by, "library_ms": None,
                     "counted_on": "AudioStream, 32 s song, 60 Hz and "
                                   "ragged deltas"})
    phase_done("audio: times")
    return rows


def run_fleet(dev, card, phase_done, reset_counts, read_counts):
    """The datagen fleet's surroundings on `dev` (no kernel of their own;
    the sharded step launches K1-K3 on every shard), on the Cave-size
    level at HEIGHT x WIDTH:

      (a) the entry point: entry.entry(level, n=N_ENTRY) on the card and
          on the CPU, one step each: one `raster_bin`, visibility and
          resolve launch on the card, the frames equal (0 differing
          pixels, colour and depth);
      (b) the instance-sharded step: N_FLEET instances, FLEET_FRAMES
          chained frames of seeded actions, unsharded and through
          parallel.mesh.sharded_step_and_render over `instance_mesh()`
          (every visible card) and over `dev` named FLEET_SHARDS times:
          every frame and, after the last, every state word equal to the
          unsharded run's; each shard launches `raster_bin`, visibility
          and resolve once a frame; then ms per frame of the three, CUDA
          events around FLEET_FRAMES frames (the checks warmed them up);
      (c) profiling.raster_stats on the Cave-size room for the N_FLEET
          cameras after (b), game and no-cull settings: the five counters
          of every camera equal the CPU's;
      (d) resume: the states after (b) saved with checkpoint.save into
          build/fleet/ and restored into fresh initial states on the
          card, FLEET_FRAMES more frames from each: frames and states
          equal the uninterrupted run's bit for bit; the file's bytes and
          the save and restore times (host clock);
      (e) idle share: profiling.trace around TRACE_FRAMES unsynchronized
          frames of `rollout.step_and_render` at N_FLEET (the opaque
          main path), then `busy_share`: the kernels traced and the share
          of the window the card ran one;
      (f) the game's debug overlay, the options menu and the controller
          view (tests/torch_fleet_cases.paint_debug_views) painted over
          (a)'s first frame on the card and on the CPU: no kernel
          launched, 0 differing words.
    """
    import numpy as np
    import torch

    import torch_fleet_cases as fc
    import torch_scenes as ts
    from bonnie32_tpu_torch import checkpoint, entry, profiling, rollout
    from bonnie32_tpu_torch.config import RasterSettings
    from bonnie32_tpu_torch.game import step as stp
    from bonnie32_tpu_torch.models import level as L
    from bonnie32_tpu_torch.parallel import mesh as pmesh
    from bonnie32_tpu_torch.types import FrameBuffers, to_device

    cpu = torch.device("cpu")
    game = RasterSettings.game()
    level = ts.cave_size_level(L)
    raster = {"raster_bin": 1, "raster_visibility": 1, "raster_resolve": 1}
    evs = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "fleet")
    os.makedirs(out_dir, exist_ok=True)

    def check_counts(label, counts, per):
        want = {k: raster.get(k, 0) * per for k in counts}
        if counts != want:
            _fail(f"{label}: launches {counts}, want {want}")

    def differing(a, b):
        """Words that differ between two tensors (floats as their bits)."""
        if a.dtype.is_floating_point:
            a, b = a.view(torch.int32), b.view(torch.int32)
        return int((a.to(b.device) != b).sum())

    def state_words(a, b):
        return sum(differing(getattr(a, f), getattr(b, f))
                   for f in a._fields)

    # ---- (a) the entry point, card vs CPU ----
    kw = dict(n=N_ENTRY, textures=ts.textures(), resolve=ts.resolver)
    fn, args = entry.entry(level, device=dev, **kw)
    torch.cuda.synchronize()
    reset_counts()
    fbs = fn(*args)
    torch.cuda.synchronize()
    check_counts("fleet entry", read_counts(), 1)
    fn_c, args_c = entry.entry(level, device=cpu, **kw)
    fbs_c = fn_c(*args_c)
    diff = differing(fbs.color, fbs_c.color)
    ddiff = differing(fbs.depth, fbs_c.depth)
    lit = ((fbs_c.color >> 24) & 255).eq(255).float().mean((1, 2))
    print(f"fleet (a) entry: N={N_ENTRY} {HEIGHT}x{WIDTH}, frames card vs "
          f"CPU: {diff} differing pixels, {ddiff} differing depth words; "
          f"coverage {lit.min().item():.3f}-{lit.max().item():.3f} {card}")
    if diff or ddiff:
        _fail("fleet entry: the card's frames differ from the CPU's")
    if float(lit.min()) < 0.25:
        _fail(f"fleet entry: coverage {lit.tolist()}")
    phase_done("fleet: entry point")

    # ---- (b) the instance-sharded step ----
    env = args[1]
    start = rollout.initial_states(level, ts.spawn_point(level), N_FLEET,
                                   device=dev)
    rng = np.random.default_rng(SEED + 12)
    acts = [stp.Actions(**{k: torch.from_numpy(v).to(dev) for k, v in
                           ts.actions_np(rng, N_FLEET).items()})
            for _ in range(2 * FLEET_FRAMES + TRACE_FRAMES)]

    def unsharded(states, frames):
        out = []
        for a in frames:
            states, fb = rollout.step_and_render(
                states, env, a, game, instance_chunk=None)
            out.append(fb)
        return states, out

    ref_states, ref = unsharded(start, acts[:FLEET_FRAMES])
    meshes = {"every card": pmesh.instance_mesh(),
              f"{dev} x{FLEET_SHARDS}": pmesh.instance_mesh(
                  [dev] * FLEET_SHARDS)}
    steps = {}
    for name, mesh in meshes.items():
        step = pmesh.sharded_step_and_render(mesh, env, game, HEIGHT, WIDTH)
        sh_acts = [pmesh.shard_instances(a, mesh)
                   for a in acts[:FLEET_FRAMES]]
        steps[name] = (step, mesh, sh_acts)
        shards = pmesh.shard_instances(start, mesh)
        torch.cuda.synchronize()
        reset_counts()
        diffs = []
        for k in range(FLEET_FRAMES):
            shards, fbs_sh = step(shards, sh_acts[k])
            got = pmesh.gather_instances(fbs_sh, dev)
            diffs.append(differing(got.color, ref[k].color)
                         + differing(got.depth, ref[k].depth))
        torch.cuda.synchronize()
        counts = read_counts()
        words = state_words(pmesh.gather_instances(shards, dev), ref_states)
        print(f"fleet (b) sharded over {name} ({len(mesh)} shards of "
              f"{[int(s.pos.shape[0]) for s in shards]} instances): "
              f"differing frame words per frame {diffs}, differing state "
              f"words {words}; launches {counts} {card}")
        if any(diffs) or words:
            _fail(f"fleet sharded step over {name}: differs from the "
                  f"unsharded step")
        check_counts(f"fleet sharded step over {name}", counts,
                     FLEET_FRAMES * len(mesh))

    def timed(run):
        torch.cuda.synchronize()
        evs[0].record()
        run()
        evs[1].record()
        torch.cuda.synchronize()
        return evs[0].elapsed_time(evs[1]) / FLEET_FRAMES

    ms = {"unsharded": timed(lambda: unsharded(start,
                                               acts[:FLEET_FRAMES]))}
    for name, (step, mesh, sh_acts) in steps.items():
        def run(step=step, mesh=mesh, sh_acts=sh_acts):
            shards = pmesh.shard_instances(start, mesh)
            for a in sh_acts:
                shards, _ = step(shards, a)
        ms[f"sharded over {name}"] = timed(run)
    print("fleet (b) ms per frame (N=%d, %dx%d, CUDA events over %d "
          "frames; a sharded run includes cutting the start states): "
          % (N_FLEET, WIDTH, HEIGHT, FLEET_FRAMES)
          + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()) + f" {card}")
    phase_done("fleet: sharded step")

    # ---- (c) raster_stats, card vs CPU ----
    cams = stp.character_camera(ref_states, env.params)
    tables = fc.room_tables(env.scene)
    tables_c = to_device(tables, cpu)
    for label, settings in (("game", game),
                            ("no cull", RasterSettings.game(
                                backface_cull=False))):
        reset_counts()
        got = profiling.raster_stats(*tables[:3], cams, *tables[3:],
                                     settings, WIDTH, HEIGHT)
        counts = read_counts()
        want = profiling.raster_stats(*tables_c[:3], to_device(cams, cpu),
                                      *tables_c[3:], settings, WIDTH,
                                      HEIGHT)
        bad = sum(differing(a, b) for a, b in zip(got, want))
        print(f"fleet (c) raster_stats, {label}, {N_FLEET} cameras: "
              + ", ".join(f"{f} {int(v.sum())}"
                          for f, v in zip(got._fields, got))
              + f" (summed); {bad} counters differ from the CPU's; "
              f"launches {counts} {card}")
        if bad or any(counts.values()):
            _fail(f"fleet raster_stats ({label}): differs from the CPU's "
                  f"or launched a kernel")
    phase_done("fleet: raster_stats")

    # ---- (d) checkpoint and resume ----
    path = os.path.join(out_dir, "states.npz")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    checkpoint.save(path, ref_states, metadata={"frame": FLEET_FRAMES})
    save_ms = (time.perf_counter() - t0) * 1e3
    template = rollout.initial_states(level, ts.spawn_point(level), N_FLEET,
                                      device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restored = checkpoint.restore(path, template)
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    if (checkpoint.load_metadata(path)["user"]["frame"] != FLEET_FRAMES
            or state_words(restored, ref_states)
            or not all(t.device == ref_states.pos.device for t in restored)):
        _fail("fleet resume: the restored states differ from the saved")
    later = acts[FLEET_FRAMES:2 * FLEET_FRAMES]
    straight, fb_s = unsharded(ref_states, later)
    resumed, fb_r = unsharded(restored, later)
    fdiff = sum(differing(a.color, b.color) + differing(a.depth, b.depth)
                for a, b in zip(fb_r, fb_s))
    sdiff = state_words(resumed, straight)
    print(f"fleet (d) resume: {N_FLEET} states after frame {FLEET_FRAMES}, "
          f"{os.path.getsize(path)} bytes, save {save_ms:.3f} ms, restore "
          f"{restore_ms:.3f} ms (host clock); {FLEET_FRAMES} more frames: "
          f"{fdiff} differing frame words, {sdiff} differing state words "
          f"against the uninterrupted run {card}")
    if fdiff or sdiff:
        _fail("fleet resume: differs from the uninterrupted run")
    phase_done("fleet: checkpoint and resume")

    # ---- (e) the kernel route's idle share ----
    states = straight
    torch.cuda.synchronize()
    reset_counts()
    with profiling.trace(os.path.join(out_dir, "trace")) as prof:
        for a in acts[2 * FLEET_FRAMES:]:
            states, _ = rollout.step_and_render(states, env, a, game,
                                                instance_chunk=None)
        torch.cuda.synchronize()
    check_counts("fleet trace", read_counts(), TRACE_FRAMES)
    kernels = profiling.kernel_events(prof)
    share = profiling.busy_share(prof)
    ours = sum(1 for e in kernels if any(
        k in e.name for k in ("bin_kernel", "visibility_kernel",
                              "resolve_kernel")))
    print(f"fleet (e) trace: {TRACE_FRAMES} frames at N={N_FLEET} under "
          f"torch.profiler: {len(kernels)} kernels traced ({ours} of the "
          f"raster kernels), device busy share {share:.4f}, idle share "
          f"{1.0 - share:.4f} (union of kernel intervals over the traced "
          f"window) {card}")
    phase_done("fleet: trace")

    # ---- (f) the debug overlay, menu and controller view ----
    frame = FrameBuffers(fbs.color[:1].clone(), fbs.depth[:1].clone())
    frame_c = FrameBuffers(fbs_c.color[:1].clone(), fbs_c.depth[:1].clone())
    torch.cuda.synchronize()
    reset_counts()
    got = fc.paint_debug_views(frame)
    torch.cuda.synchronize()
    counts = read_counts()
    want = fc.paint_debug_views(frame_c)
    painted = int((want.color != frame_c.color).sum())
    diff = differing(got.color, want.color) + differing(got.depth,
                                                        want.depth)
    print(f"fleet (f) debug overlay, menu and controller view over the "
          f"entry's frame: {painted} words painted, {diff} differ from the "
          f"CPU's; launches {counts} {card}")
    if diff or painted < 5000 or any(counts.values()):
        _fail("fleet debug views: differ from the CPU's or launched a "
              "kernel")
    phase_done("fleet: debug overlay")


def run_ui(dev, card, phase_done, reset_counts, read_counts):
    """The rest of ui/, storage/ and the texture import path on `dev`
    (host code and torch code over draw2d, picking and the main path's
    kernels; no kernel of their own), each held against the CPU:

      (a) a widget frame (tests/torch_ui_cases.widget_frame): every widget
          of ui/widgets.py, a split panel with a collapsible panel and an
          open radial menu, the mouse dragging a knob along a seeded path
          for three frames while a dropdown is open, painted by
          UiContext.paint over the Cave editor case's 3-D view at 640x480
          (render_editor_viewport on the card, copied to the CPU for the
          CPU's paint): 0 differing words, no kernel launched; the command
          count and ms per paint (CUDA events, after a warm-up paint);
      (b) draw_text_input (a selection and the caret showing) and the
          landing page (draw_landing scrolled to its end with a link
          hovered, draw_landing_ctx, draw_link_row) drawn into that view:
          0 differing words, no kernel launched; ms per call;
      (c) the drag tracker's line, plane, circle and screen pickers,
          unsnapped and snapped both ways, from DRAG_SEEDS seeded cameras
          with the camera basis on the card against the same drags with a
          numpy camera: every ray cast on the card, positions equal bit
          for bit, angles equal or within ANGLE_TOL (the largest
          difference printed); ms per update (host clock);
      (d) a seeded 96x80 RGBA image through TextureImportState: resized to
          64x64 and quantized at 4 and 8 bpp (index 0 transparent), the
          UserTexture's words as the Cave-size level's FLOOR texture, one
          step of entry.entry at N_IMPORT, 320x240, game settings: one
          `raster_bin`, visibility and resolve launch, the frames equal to
          the CPU's and different from the checker floor's; ms of the
          import and of quantize_image alone (host clock);
      (e) a checkpoint of N_STORE rollout states (checkpoint.save_bytes)
          through storage.Storage on three routes (LocalStorage under
          build/ui/, CloudStorage over MemoryCloudBackend, CloudStorage
          over HttpCloudBackend and the fake API of
          tests/torch_cloud_server.py on 127.0.0.1), each staged through
          async_ops.save_async / load_async, read back and restored on the
          card bit for bit; ms per save and per load (host clock); the
          N_STORE_BIG-state checkpoint refused with FileTooLarge by the
          in-memory and the HTTP cloud.
    """
    import shutil

    import numpy as np
    import torch

    import torch_cloud_server as fake
    import torch_editor_cases as ec
    import torch_scenes as ts
    import torch_ui_cases as uc
    from bonnie32_tpu_torch import checkpoint, entry, rollout, texture, ui
    from bonnie32_tpu_torch.config import RasterSettings
    from bonnie32_tpu_torch.editor import state as ES
    from bonnie32_tpu_torch.editor import viewport_edit as VE
    from bonnie32_tpu_torch.editor import viewport_render as VR
    from bonnie32_tpu_torch.models import asset as A
    from bonnie32_tpu_torch.models import level as L
    from bonnie32_tpu_torch.models import mesh as M
    from bonnie32_tpu_torch.models import quantize
    from bonnie32_tpu_torch.models import scene
    from bonnie32_tpu_torch.models import user_texture as U
    from bonnie32_tpu_torch.ops import picking as pk
    from bonnie32_tpu_torch import storage
    from bonnie32_tpu_torch.storage import async_ops
    from bonnie32_tpu_torch.storage.cloud import HttpCloudBackend
    from bonnie32_tpu_torch.types import FrameBuffers

    cpu = torch.device("cpu")
    evs = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "ui")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)

    def no_launch(label, counts):
        if any(counts.values()):
            _fail(f"ui {label}: launches {counts}, want none")

    def differing(a, b):
        """Words that differ between two tensors (floats as their bits)."""
        if a.dtype.is_floating_point:
            a, b = a.view(torch.int32), b.view(torch.int32)
        return int((a.to(b.device) != b).sum())

    def event_ms(fn, reps=UI_REPS):
        """ms a call of fn(), CUDA events around `reps` calls after one."""
        fn()
        torch.cuda.synchronize()
        evs[0].record()
        for _ in range(reps):
            fn()
        evs[1].record()
        torch.cuda.synchronize()
        return evs[0].elapsed_time(evs[1]) / reps

    def frame_on(view, device):
        return FrameBuffers(view.color.to(device).clone(),
                            view.depth.to(device).clone())

    # ---- (a) the widget frame over the editor view ----
    w, h = uc.FRAME_SIZE
    st, ed, hv, tex, kw = ec.editor_case("cave", L, ES, VE, A, M, U, scene)
    sc_d = scene.compile_level(st.level, tex, ts.resolver, device=dev, **kw)
    view = VR.render_editor_viewport(st, sc_d, w, h,
                                     settings=RasterSettings.modeler(),
                                     editor=ed, hover=hv, device=dev)
    view_c = frame_on(view, cpu)
    ctx, trace = uc.widget_frame(ui, SEED + 13)
    knob = [f[0][-1][0] for f in trace]
    dd_open = dict(trace[-1][3])["dropdown"]
    if None in knob or not any(k == "state" and v[1][0][1] == "dd"
                               for k, v in dd_open):
        _fail(f"ui widget frame: knob values {knob}, dropdown {dd_open}")
    torch.cuda.synchronize()
    reset_counts()
    got = ctx.paint(frame_on(view, dev))
    torch.cuda.synchronize()
    no_launch("widget frame", read_counts())
    if got.color.device.type != dev.type:
        _fail(f"ui widget frame: painted on {got.color.device}")
    want = ctx.paint(frame_on(view_c, cpu))
    diff = differing(got.color, want.color) + differing(got.depth,
                                                        want.depth)
    painted = int((want.color != view_c.color).sum())
    kinds = sorted({c[0] for c in ctx.commands})
    ms = event_ms(lambda: ctx.paint(frame_on(view, dev)))
    print(f"ui (a) widget frame at {w}x{h} over the editor view: "
          f"{len(ctx.commands)} commands ({', '.join(kinds)}), knob values "
          f"{knob}, {painted} words painted, {diff} differ from the CPU's; "
          f"{ms:.3f} ms a paint (CUDA events, {UI_REPS} paints) {card}")
    if diff or painted < 50000:
        _fail("ui widget frame: the card's paint differs from the CPU's")
    phase_done("ui: widget frame")

    # ---- (b) text input and landing page ----
    ti = {}
    for label, run in (
            ("text input", lambda fb: uc.text_input_calls(ui, fb)),
            ("text input, scale 2", lambda fb: uc.text_input_calls(ui, fb,
                                                                   2)),
            ("landing", lambda fb: uc.landing_calls(ui, fb, w, h))):
        torch.cuda.synchronize()
        reset_counts()
        got, out = run(frame_on(view, dev))
        torch.cuda.synchronize()
        no_launch(label, read_counts())
        want, cout = run(frame_on(view_c, cpu))
        diff = differing(got.color, want.color)
        painted = int((want.color != view_c.color).sum())
        ti[label] = (diff, painted, out == cout)
        if diff or painted == 0 or out != cout:
            _fail(f"ui {label}: {diff} words differ from the CPU's, "
                  f"{painted} painted, state equal {out == cout}")
    state = ui.TextInputState.new("hello world_x 42")
    state.selection_start, state.cursor = 2, 9
    rect = ui.Rect(8, 8, 240, 16)
    fb_d = frame_on(view, dev)
    ms_ti = event_ms(lambda: ui.draw_text_input(fb_d, rect, state))
    landing = uc.sub(ui, "landing")
    ms_ld = event_ms(lambda: landing.draw_landing(
        fb_d, ui.Rect(0, 0, w, h), landing.LandingState()))
    print("ui (b) text input (a selection, the caret shown) and landing "
          "page (scrolled, a link hovered) over the editor view: "
          + ", ".join(f"{k}: {d} of {n} painted words differ"
                      for k, (d, n, _) in ti.items())
          + f"; {ms_ti:.3f} ms a draw_text_input, {ms_ld:.3f} ms a "
          f"draw_landing (CUDA events) {card}")
    phase_done("ui: text input and landing")

    # ---- (c) the drag tracker ----
    rays = []
    screen_to_ray = pk.screen_to_ray

    def spy(*args, **kwargs):
        o, d = screen_to_ray(*args, **kwargs)
        rays.append(d.device.type)
        return o, d

    worst_pos = worst_ang = 0.0
    n_moves = 0
    t_card = 0.0
    pk.screen_to_ray = spy
    try:
        for seed in range(DRAG_SEEDS):
            pos, basis = uc.drag_camera(SEED + seed)
            cam = (torch.from_numpy(pos).to(dev),
                   torch.from_numpy(basis).to(dev))
            t0 = time.perf_counter()
            got = uc.run_drags(ui, *cam, SEED + seed)
            t_card += time.perf_counter() - t0
            cards = len(rays)
            want = uc.run_drags(ui, pos, basis, SEED + seed)
            if set(rays[:cards]) != {dev.type} or set(rays[cards:]) != {"cpu"}:
                _fail(f"ui drag tracker: rays cast on {set(rays[:cards])}")
            del rays[:]
            for (name, snap, a), (_, _, b) in zip(got, want):
                for x, y in zip(a, b):
                    n_moves += 1
                    worst_pos = max(worst_pos, float(np.abs(
                        x[0].astype(np.float64) - y[0]).max()))
                    worst_ang = max(worst_ang, abs(x[1] - y[1]),
                                    abs(x[3] - y[3]))
                    if x[4] != y[4]:
                        _fail(f"ui drag tracker {name}: mouse deltas")
    finally:
        pk.screen_to_ray = screen_to_ray
    n_updates = n_moves - DRAG_SEEDS * len(uc.drag_cases(ui))
    verdict = ("equal" if worst_ang == 0.0 else
               f"within {ANGLE_TOL:g} rad" if worst_ang <= ANGLE_TOL
               else "apart")
    print(f"ui (c) drag tracker: {len(uc.drag_cases(ui))} pickers x "
          f"{DRAG_SEEDS} cameras, {n_updates} updates with the camera on "
          f"the card vs the CPU: largest position difference {worst_pos:.3g}"
          f" (must be 0), angles {verdict} (largest difference "
          f"{worst_ang:.3g} rad); {1e3 * t_card / n_updates:.3f} ms an "
          f"update on the card (host clock) {card}")
    if worst_pos or worst_ang > ANGLE_TOL:
        _fail("ui drag tracker: the card's drags differ from the CPU's")
    phase_done("ui: drag tracker")

    # ---- (d) the import path through the main path's kernels ----
    level = ts.cave_size_level(L)
    rgba = uc.import_rgba(SEED)
    floor = ts.TEXTURE_NAMES.index("FLOOR")
    raster = {"raster_bin": 1, "raster_visibility": 1, "raster_resolve": 1}
    base = None
    for depth in (0, 1):
        t0 = time.perf_counter()
        dialog, tex = uc.imported_texture(texture, rgba, depth)
        import_ms = (time.perf_counter() - t0) * 1e3
        resized = texture.resize_to_target(rgba, uc.IMPORT_TARGET,
                                           dialog.resize_mode)
        t0 = time.perf_counter()
        quantize.quantize_image(resized, uc.IMPORT_TARGET, uc.IMPORT_TARGET,
                                depth=depth)
        quant_ms = (time.perf_counter() - t0) * 1e3
        words = tex.to_texture15()
        keyed = int((words == 0).sum())
        textures = ts.textures()
        textures[floor] = (words, 0)
        fn, args = entry.entry(level, n=N_IMPORT, device=dev,
                               textures=textures, resolve=ts.resolver)
        torch.cuda.synchronize()
        reset_counts()
        fbs = fn(*args)
        torch.cuda.synchronize()
        counts = read_counts()
        want = {k: raster.get(k, 0) for k in counts}
        if counts != want:
            _fail(f"ui import ({depth}): launches {counts}, want {want}")
        fn_c, args_c = entry.entry(level, n=N_IMPORT, device=cpu,
                                   textures=textures, resolve=ts.resolver)
        fbs_c = fn_c(*args_c)
        diff = differing(fbs.color, fbs_c.color)
        ddiff = differing(fbs.depth, fbs_c.depth)
        if base is None:
            fn0, args0 = entry.entry(level, n=N_IMPORT, device=dev,
                                     textures=ts.textures(),
                                     resolve=ts.resolver)
            base = fn0(*args0).color
        shown = differing(fbs.color, base)
        print(f"ui (d) import at {4 * (depth + 1)} bpp: "
              f"{rgba.shape[1]}x{rgba.shape[0]} -> {tex.width}x{tex.height}"
              f", {len(tex.palette)} CLUT words, {keyed} transparent "
              f"texels; entry.entry N={N_IMPORT} {HEIGHT}x{WIDTH}: launches "
              f"{counts}, {diff} differing pixels and {ddiff} differing "
              f"depth words card vs CPU, {shown} pixels differ from the "
              f"checker floor's frame; import {import_ms:.3f} ms, "
              f"quantize_image {quant_ms:.3f} ms (host clock) {card}")
        if diff or ddiff or keyed == 0 or shown == 0:
            _fail(f"ui import ({depth}): the card's frames differ from the "
                  f"CPU's, or the texture has no keyed texel or is unseen")
    phase_done("ui: texture import")

    # ---- (e) storage ----
    spawn = ts.spawn_point(level)
    states = rollout.initial_states(level, spawn, N_STORE, device=dev)
    data = checkpoint.save_bytes(states, metadata={"route": "all"})
    path = "assets/userdata/fleet/states.npz"
    local = storage.LocalStorage(os.path.join(out_dir, "storage"))
    times = {}
    with fake.serve() as (url, api):
        http = storage.CloudStorage(HttpCloudBackend(
            url, token_provider=lambda: fake.TOKEN))
        routes = {"local": storage.Storage(local=local),
                  "memory cloud": storage.Storage(
                      local=local, cloud=storage.CloudStorage()),
                  "HTTP cloud": storage.Storage(local=local, cloud=http)}
        for name, s in routes.items():
            staged = os.path.join(out_dir, "async", f"{name}.npz")
            if not async_ops.save_async(staged, data).wait():
                _fail(f"ui storage {name}: save_async")
            blob = async_ops.load_async(staged).wait()
            save = load = 0.0
            for _ in range(UI_REPS):
                t0 = time.perf_counter()
                s.write(path, blob).wait()
                t1 = time.perf_counter()
                back = s.read(path).wait()
                load += time.perf_counter() - t1
                save += t1 - t0
            restored = checkpoint.restore_bytes(back, rollout.initial_states(
                level, spawn, N_STORE, device=dev))
            words = sum(differing(getattr(restored, f), getattr(states, f))
                        for f in states._fields)
            on_card = all(getattr(restored, f).device.type == dev.type
                          for f in states._fields)
            times[name] = (1e3 * save / UI_REPS, 1e3 * load / UI_REPS)
            if back != data or words or not on_card:
                _fail(f"ui storage {name}: {words} state words differ")
        stored = sorted(api.store)
        big = checkpoint.save_bytes(rollout.initial_states(
            level, spawn, N_STORE_BIG, device=dev))
        refused = []
        for cloud in (storage.CloudStorage(), http):
            try:
                cloud.write(path, big).wait()
                refused.append(None)
            except storage.StorageError as e:
                refused.append(e.kind)
    print(f"ui (e) storage: a checkpoint of {N_STORE} states, {len(data)} "
          f"bytes, through async_ops and Storage, restored on the card bit "
          f"for bit on every route; ms a save / load (host clock, "
          f"{UI_REPS} round trips): "
          + ", ".join(f"{k} {a:.3f} / {b:.3f}" for k, (a, b) in
                      times.items())
          + f"; the fake API held {stored}; the {N_STORE_BIG}-state "
          f"checkpoint ({len(big)} bytes) refused by the memory and HTTP "
          f"clouds: {refused} {card}")
    if refused != ["FileTooLarge"] * 2 or stored != [path]:
        _fail(f"ui storage: the oversize checkpoint was not refused "
              f"({refused}) or the API holds {stored}")
    phase_done("ui: storage")


if __name__ == "__main__":
    main()
