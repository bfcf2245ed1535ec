"""Build, load and launch the CUDA kernels of csrc/raster.cu
(`raster_bin`, `raster_visibility`, `raster_resolve`, `raster_composite`,
`raster_sky`); csrc/gather.cu and csrc/audio.cu are built and loaded here
too and launched by ops/gather.py and by audio/reverb.py and
audio/resampler.py.

nvcc compiles each source into a shared library with a plain C interface
(no PyTorch headers: seconds, not minutes), named by a hash of the source
and flags under `<repo>/build/torch_kernels/`, at first use; `build()`
compiles all of them at once, one nvcc process each.  ctypes loads them;
each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with torch.empty, launches on the current stream, raises when
the C entry point returns a CUDA error, and counts its launches in the
plain integer attribute `launches`.

Nothing here runs at import: the CPU tests import every module, and
building needs nvcc and a card.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = {"raster": _CSRC / "raster.cu", "gather": _CSRC / "gather.cu",
           "audio": _CSRC / "audio.cu"}
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def nvcc_flags() -> tuple:
    """NVCC_FLAGS plus the tile shapes of the plain binning
    (raster_batch.TILE_H, TILE_W) and of the plain sky culling
    (skybox.SKY_TILE_H, SKY_TILE_W), which csrc/raster.cu is built for."""
    from . import raster_batch as rb
    from . import skybox as sky_ops
    return NVCC_FLAGS + (f"-DRASTER_TILE_H={rb.TILE_H}",
                         f"-DRASTER_TILE_W={rb.TILE_W}",
                         f"-DRASTER_SKY_TILE_H={sky_ops.SKY_TILE_H}",
                         f"-DRASTER_SKY_TILE_W={sky_ops.SKY_TILE_W}")


def library_path(name: str = "raster") -> Path:
    """Where the library for source `name`'s current text and the flags
    lives."""
    digest = hashlib.sha256(SOURCES[name].read_bytes()
                            + " ".join(nvcc_flags()).encode()).hexdigest()
    return BUILD_DIR / f"{name}_{digest[:16]}.so"


def build(names=None, verbose: bool = False) -> dict:
    """Compile the sources `names` (default: all) whose hashed library
    does not exist yet, all nvcc processes started together.  `verbose`
    rebuilds with -Xptxas -v and prints its report.  Returns the library
    paths by name."""
    names = tuple(SOURCES) if names is None else tuple(names)
    paths = {name: library_path(name) for name in names}
    procs = {}
    for name, out in paths.items():
        if out.exists() and not verbose:
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *nvcc_flags(),
               *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(SOURCES[name])]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {SOURCES[name].name} "
                          f"({proc.returncode}):\n{log}")
            continue
        if verbose:
            print(log)
        os.replace(tmp, paths[name])
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


class _SkyBody(ctypes.Structure):
    _fields_ = ([("enabled", ctypes.c_int)]
                + [(n, ctypes.c_float) for n in (
                    "dx", "dy", "dz", "cos_gate", "size", "glow_r",
                    "glow_span", "glow_falloff")]
                + [("color", ctypes.c_float * 3),
                   ("glow_color", ctypes.c_float * 3)])


class _SkyCloud(ctypes.Structure):
    _fields_ = ([("enabled", ctypes.c_int)]
                + [(n, ctypes.c_float) for n in (
                    "vmin", "vmax", "scroll_speed", "f1", "p1", "s1", "f2",
                    "p2", "s2", "f3", "p3", "s3", "threshold", "span",
                    "height", "half_thickness", "opacity")]
                + [("color", ctypes.c_float * 3)])


class SkyParams(ctypes.Structure):
    """csrc/raster.cu's SkyParams, field for field."""

    _fields_ = ([(n, ctypes.c_float * 3) for n in (
                    "zenith", "horizon_sky", "horizon_ground", "nadir")]
                + [(n, ctypes.c_float) for n in (
                    "horizon", "above_div", "below_div")]
                + [(n, ctypes.c_int) for n in (
                    "has_above", "has_below", "tint_enabled")]
                + [(n, ctypes.c_float) for n in (
                    "tint_dir", "tint_spread", "tint_intensity")]
                + [("tint_color", ctypes.c_float * 3),
                   ("haze_enabled", ctypes.c_int),
                   ("haze_extent", ctypes.c_float),
                   ("haze_intensity", ctypes.c_float),
                   ("haze_color", ctypes.c_float * 3),
                   ("body", _SkyBody * 2), ("cloud", _SkyCloud * 2)]
                + [(n, ctypes.c_float) for n in (
                    "half_w", "half_h", "vs", "usq")])


def _fill(struct, values: dict):
    """Copy `values` into the ctypes structure by field name; a key the
    structure lacks is an error, fields the dict lacks stay 0."""
    ctypes_of = dict(struct._fields_)
    unknown = set(values) - set(ctypes_of)
    if unknown:
        raise KeyError(f"{type(struct).__name__} has no field "
                       f"{sorted(unknown)}")
    for name, v in values.items():
        ctype = ctypes_of[name]
        if isinstance(v, (list, tuple)):
            item = ctype._type_
            if issubclass(item, ctypes.Structure):
                for slot, sub in zip(getattr(struct, name), v):
                    _fill(slot, sub)
            else:
                setattr(struct, name, ctype(*v))
        else:
            setattr(struct, name, v)
    return struct


def sky_params(skybox, width: int, height: int) -> SkyParams:
    """The kernels' sky configuration for `skybox` at this frame size,
    from the same constants as the plain version (ops/skybox.py)."""
    from . import skybox as sky_ops
    return _fill(SkyParams(), {**sky_ops.sky_consts(skybox),
                               **sky_ops.ray_consts(width, height)})


def load(name: str = "raster"):
    """The ctypes library of source `name`, built at first use."""
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(build([name])[name]))
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            if name == "raster":
                lib.raster_bin.argtypes = [ptr] * 6 + [i32] * 6 + [ptr]
                lib.raster_visibility.argtypes = ([ptr] * 12 + [i32] * 6
                                                  + [ptr])
                lib.raster_resolve.argtypes = [ptr] * 13 + [i32] * 9 + [ptr]
                lib.raster_composite.argtypes = ([ptr] * 13 + [i32] * 8
                                                 + [ptr])
                lib.raster_sky.argtypes = [ptr] * 5 + [i32] * 5 + [ptr]
                for fn in (lib.raster_bin, lib.raster_visibility,
                           lib.raster_resolve, lib.raster_composite,
                           lib.raster_sky):
                    fn.restype = i32
            elif name == "gather":
                lib.select_gather.argtypes = [ptr] * 3 + [
                    ctypes.c_longlong, i32, ptr]
                lib.select_gather.restype = i32
            else:
                f32 = ctypes.c_float
                lib.spu_reverb.argtypes = ([ptr] * 10 + [i32] * 2
                                           + [f32] * 4 + [i32] * 4 + [ptr])
                lib.spu_resample.argtypes = ([ptr] * 10 + [i32] * 5
                                             + [ptr] * 2)
                lib.spu_reverb.restype = lib.spu_resample.restype = i32
            _libs[name] = lib
    return _libs[name]


def _check(name, t, dtype, shape, device, align=4):
    if not t.is_cuda or t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, "
                         f"got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.data_ptr() % align:
        raise ValueError(f"{name}: expected {align}-byte aligned storage")
    return t.data_ptr()


def _check_atlas(atlas, device):
    nt = atlas.offset.shape[0]
    return [_check("atlas.data", atlas.data, torch.int32,
                   atlas.data.shape, device),
            _check("atlas.offset", atlas.offset, torch.int32, (nt,), device),
            _check("atlas.width", atlas.width, torch.int32, (nt,), device),
            _check("atlas.height", atlas.height, torch.int32, (nt,), device)]


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def raster_bin(ctrl, height: int, width: int, order=None, count=None,
               tctrl=None, want_work: bool = False):
    """Launch `raster_bin`: which entries of each instance's ordered list
    touch which tile, as raster_batch.tile_bins_ref computes it.  The list
    is the visibility kernel's (`order` (I, L) i32 with `count` (I,) i32:
    position p is live where p < count[i]) or the composite's (`tctrl`
    (I, L, 8) i32: live where valid and editor alpha are not 0); each
    entry's clipped bbox is its face's row of `ctrl` (I, T, 8) i32.
    Returns (bins (I, tiles_y, tiles_x, ceil(L / 32)) i32, work, work_len):
    with `want_work`, `work` (I * tiles,) i32 holds, in its first
    `work_len[0]` places and in no fixed order, the flat (instance, tile)
    indices with any bit set, and `work_len[1]` is the zeroed cursor that
    `raster_composite` draws tiles with, so one work list serves one
    composite launch; both stay on the device (else None)."""
    from . import raster_batch as rb
    lib = load()
    dev = ctrl.device
    n, t = ctrl.shape[:2]
    if ((order is None) == (tctrl is None)
            or (order is None) != (count is None)):
        raise ValueError("raster_bin: give order and count, or tctrl")
    composite = tctrl is not None
    length = (tctrl if composite else order).shape[1]
    ctrl_p = _check("ctrl", ctrl, torch.int32, (n, t, 8), dev, align=16)
    if composite:
        list_p = _check("tctrl", tctrl, torch.int32, (n, length, 8), dev)
        count_p = None
    else:
        list_p = _check("order", order, torch.int32, (n, length), dev)
        count_p = _check("count", count, torch.int32, (n,), dev)
    tiles_y, tiles_x = rb.tile_grid(height, width)
    if n * tiles_y * tiles_x >= 2 ** 31:
        raise ValueError(f"{n} instances of {tiles_y}x{tiles_x} tiles "
                         f"exceed the work list's 32-bit index")
    bins = torch.empty((n, tiles_y, tiles_x, (length + 31) // 32),
                       dtype=torch.int32, device=dev)
    work = work_len = None
    if want_work:
        work = torch.empty(n * tiles_y * tiles_x, dtype=torch.int32,
                           device=dev)
        work_len = torch.zeros(2, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.raster_bin(list_p, count_p, ctrl_p, bins.data_ptr(),
                         work.data_ptr() if want_work else None,
                         work_len.data_ptr() if want_work else None,
                         n, length, t, height, width, int(composite), stream)
    _raise_on(err, "raster_bin")
    raster_bin.launches += 1
    return bins, work, work_len


raster_bin.launches = 0


def raster_visibility(prep, atlas, height: int, width: int,
                      painters: bool = False, perspective: bool = False):
    """Launch `raster_bin` over the kept faces, then `raster_visibility`
    (phase 1): returns (depth f32, winner i32, bcx f32, bcy f32), each
    (I, H, W) on the prep's device.  `painters`: the painter's merge (last
    covering face wins) and a cleared depth plane.  `perspective`: keyed
    faces test their texel at the perspective-correct UV."""
    lib = load()
    dev = prep.attrs.device
    n, t = prep.order.shape
    if n > 65535:
        raise ValueError(f"{n} instances exceed the grid's z limit 65535")
    args = [_check("order", prep.order, torch.int32, (n, t), dev),
            _check("ctrl", prep.ctrl, torch.int32, (n, t, 8), dev, align=16),
            _check("attrs", prep.attrs, torch.float32, (n, t, 32), dev,
                   align=16),
            *_check_atlas(atlas, dev)]
    bins, _, _ = raster_bin(prep.ctrl, height, width, order=prep.order,
                            count=prep.count)
    depth = torch.empty((n, height, width), dtype=torch.float32, device=dev)
    winner = torch.empty((n, height, width), dtype=torch.int32, device=dev)
    bcx = torch.empty_like(depth)
    bcy = torch.empty_like(depth)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.raster_visibility(*args, bins.data_ptr(), depth.data_ptr(),
                                winner.data_ptr(), bcx.data_ptr(),
                                bcy.data_ptr(), n, t, height, width,
                                int(painters), int(perspective), stream)
    _raise_on(err, "raster_visibility")
    raster_visibility.launches += 1
    return depth, winner, bcx, bcy


raster_visibility.launches = 0


def _sky_args(sky, scal, n, height, width, dev):
    """Pointers and sizes of the sky's tables: (scal, faces, params by
    reference, number of faces, vpad); `params` must outlive the call."""
    nf = sky.face_table.shape[0]
    params = sky_params(sky.skybox, width, height)
    return ([_check("sky scal", scal, torch.float32, (n, 8, sky.vpad), dev),
             _check("sky face_table", sky.face_table, torch.int32, (nf, 12),
                    dev)], params, nf)


def raster_resolve(prep, atlas, winner, bcx, bcy, shading: int, background,
                   perspective: bool = False):
    """Launch `raster_resolve` (phase 2): the packed RGBA8 colour plane
    (I, H, W) i32.  `background` fills the pixels no face drew: an int
    (one word), an (I, H, W) i32 plane, or an ops.skybox.SkyBackground
    (the in-kernel sky).  `perspective`: perspective-correct UVs over the
    winner's 1/z."""
    lib = load()
    dev = prep.attrs.device
    n, height, width = winner.shape
    t = prep.attrs.shape[1]
    if n > 65535:
        raise ValueError(f"{n} instances exceed the grid's y and z limit "
                         f"65535")
    args = [_check("winner", winner, torch.int32, (n, height, width), dev),
            _check("bcx", bcx, torch.float32, (n, height, width), dev),
            _check("bcy", bcy, torch.float32, (n, height, width), dev),
            _check("attrs", prep.attrs, torch.float32, (n, t, 32), dev),
            *_check_atlas(atlas, dev)]
    color = torch.empty((n, height, width), dtype=torch.int32, device=dev)
    word, plane, sky_ptrs, params, nf, vpad = 0, None, [None, None], None, 0, 0
    if isinstance(background, torch.Tensor):
        plane = _check("background", background, torch.int32,
                       (n, height, width), dev)
    elif not isinstance(background, tuple):
        word = int(background)
    else:
        sky, scal = background
        sky_ptrs, params, nf = _sky_args(sky, scal, n, height, width, dev)
        vpad = sky.vpad
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.raster_resolve(
        *args, color.data_ptr(), plane, *sky_ptrs,
        ctypes.addressof(params) if params is not None else None,
        n, t, height, width, int(shading), word, nf, vpad,
        int(perspective), stream)
    _raise_on(err, "raster_resolve")
    raster_resolve.launches += 1
    return color


raster_resolve.launches = 0


def raster_sky(sky, scal, height: int, width: int, want_tiles: bool = False):
    """Launch `raster_sky`: sphere + mountains of every instance of the
    scalar table `scal` (I, 8, vpad) f32 (ops.skybox.prep_sky_scal), the
    packed RGBA8 plane (I, H, W) i32.  With `want_tiles`, returns
    (plane, words): words (I, tiles_y, tiles_x, ceil(F / 32)) i32 are the
    mountain faces each sky tile staged, as ops.skybox.sky_tile_faces_ref
    gives them."""
    from . import skybox as sky_ops
    lib = load()
    dev = scal.device
    n = scal.shape[0]
    if n > 65535:
        raise ValueError(f"{n} instances exceed the grid's z limit 65535")
    ptrs, params, nf = _sky_args(sky, scal, n, height, width, dev)
    color = torch.empty((n, height, width), dtype=torch.int32, device=dev)
    words = None
    if want_tiles:
        words = torch.zeros((n, *sky_ops.sky_tile_grid(height, width),
                             (nf + 31) // 32), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.raster_sky(*ptrs, ctypes.addressof(params), color.data_ptr(),
                         words.data_ptr() if want_tiles else None, n, nf,
                         sky.vpad, height, width, stream)
    _raise_on(err, "raster_sky")
    raster_sky.launches += 1
    return (color, words) if want_tiles else color


raster_sky.launches = 0


def raster_composite(color, depth, tr, prep, atlas, shading: int, mode: int,
                     perspective: bool = False):
    """Launch `raster_bin` over the entries of the TransPrep `tr`, then
    `raster_composite` (phase 3), which composites them in order onto
    `color` (I, H, W) i32, IN PLACE, in the tiles a live entry touches, and
    returns it; face rows come from `prep` (a BatchPrep or FaceTables).
    `mode` is a raster_batch.COMPOSITE_* value: z-buffer mode z-tests
    against `depth` (I, H, W) f32, which is never written; x-ray takes the
    50% average in place of the blend modes.  `perspective`:
    perspective-correct UVs over each entry's own 1/z."""
    lib = load()
    dev = color.device
    n, height, width = color.shape
    t = prep.attrs.shape[1]
    nt = tr.tctrl.shape[1]
    if n > 65535:
        raise ValueError(f"{n} instances exceed the grid's z limit 65535")
    if mode not in (0, 1, 2):
        raise ValueError(f"unknown composite mode {mode}")
    args = [_check("tctrl", tr.tctrl, torch.int32, (n, nt, 8), dev),
            _check("tfscal", tr.tfscal, torch.float32, (n, nt, 12), dev,
                   align=16),
            _check("ctrl", prep.ctrl, torch.int32, (n, t, 8), dev, align=16),
            _check("attrs", prep.attrs, torch.float32, (n, t, 32), dev,
                   align=16),
            *_check_atlas(atlas, dev)]
    planes = [_check("depth", depth, torch.float32, (n, height, width), dev),
              _check("color", color, torch.int32, (n, height, width), dev)]
    bins, work, work_len = raster_bin(prep.ctrl, height, width,
                                      tctrl=tr.tctrl, want_work=True)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.raster_composite(*args, bins.data_ptr(), work.data_ptr(),
                               work_len.data_ptr(), *planes, n, nt, t, height,
                               width, int(shading), int(mode),
                               int(perspective), stream)
    _raise_on(err, "raster_composite")
    raster_composite.launches += 1
    return color


raster_composite.launches = 0
