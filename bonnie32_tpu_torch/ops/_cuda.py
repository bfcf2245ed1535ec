"""Build, load and launch the CUDA kernels of csrc/raster.cu
(`raster_visibility`, `raster_resolve`, `raster_composite`).

nvcc compiles the source into a shared library with a plain C interface
(no PyTorch headers: seconds, not minutes), named by a hash of the source
and flags under `<repo>/build/torch_kernels/`, at first use.  ctypes loads
it; each wrapper checks device, dtype, shape and contiguity, allocates
its outputs with torch.empty, launches on the current stream, raises when
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

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "raster.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    digest = hashlib.sha256(_SRC.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"raster_{digest[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile csrc/raster.cu unless the hashed library already exists.
    `verbose` adds -Xptxas -v and returns with its report printed."""
    out = library_path()
    if out.exists() and not verbose:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), str(_SRC)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    if verbose:
        print(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            lib.raster_visibility.argtypes = [ptr] * 12 + [i32] * 5 + [ptr]
            lib.raster_visibility.restype = i32
            lib.raster_resolve.argtypes = [ptr] * 9 + [i32] * 6 + [ptr]
            lib.raster_resolve.restype = i32
            lib.raster_composite.argtypes = [ptr] * 10 + [i32] * 7 + [ptr]
            lib.raster_composite.restype = i32
            _lib = lib
    return _lib


def _check(name, t, dtype, shape, device):
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


def raster_visibility(prep, atlas, height: int, width: int,
                      painters: bool = False):
    """Launch `raster_visibility` (phase 1): returns (depth f32, winner
    i32, bcx f32, bcy f32), each (I, H, W) on the prep's device.
    `painters`: the painter's merge (last covering face wins) and a
    cleared depth plane."""
    lib = _load()
    dev = prep.attrs.device
    n, t = prep.order.shape
    if n > 65535:
        raise ValueError(f"{n} instances exceed the grid's z limit 65535")
    args = [_check("order", prep.order, torch.int32, (n, t), dev),
            _check("count", prep.count, torch.int32, (n,), dev),
            _check("ctrl", prep.ctrl, torch.int32, (n, t, 8), dev),
            _check("attrs", prep.attrs, torch.float32, (n, t, 32), dev),
            *_check_atlas(atlas, dev)]
    depth = torch.empty((n, height, width), dtype=torch.float32, device=dev)
    winner = torch.empty((n, height, width), dtype=torch.int32, device=dev)
    bcx = torch.empty_like(depth)
    bcy = torch.empty_like(depth)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.raster_visibility(*args, depth.data_ptr(), winner.data_ptr(),
                                bcx.data_ptr(), bcy.data_ptr(), n, t,
                                height, width, int(painters), stream)
    _raise_on(err, "raster_visibility")
    raster_visibility.launches += 1
    return depth, winner, bcx, bcy


raster_visibility.launches = 0


def raster_resolve(prep, atlas, winner, bcx, bcy, shading: int,
                   background: int):
    """Launch `raster_resolve` (phase 2): the packed RGBA8 colour plane
    (I, H, W) i32."""
    lib = _load()
    dev = prep.attrs.device
    n, height, width = winner.shape
    t = prep.attrs.shape[1]
    args = [_check("winner", winner, torch.int32, (n, height, width), dev),
            _check("bcx", bcx, torch.float32, (n, height, width), dev),
            _check("bcy", bcy, torch.float32, (n, height, width), dev),
            _check("attrs", prep.attrs, torch.float32, (n, t, 32), dev),
            *_check_atlas(atlas, dev)]
    color = torch.empty((n, height, width), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.raster_resolve(*args, color.data_ptr(), n, t, height, width,
                             int(shading), int(background), stream)
    _raise_on(err, "raster_resolve")
    raster_resolve.launches += 1
    return color


raster_resolve.launches = 0


def raster_composite(color, depth, tr, prep, atlas, shading: int, mode: int):
    """Launch `raster_composite` (phase 3): composites the entries of the
    TransPrep `tr` in order onto `color` (I, H, W) i32, IN PLACE, and
    returns it; face rows come from `prep` (a BatchPrep or FaceTables).
    `mode` is a raster_batch.COMPOSITE_* value: z-buffer mode z-tests
    against `depth` (I, H, W) f32, which is never written; x-ray takes the
    50% average in place of the blend modes."""
    lib = _load()
    dev = color.device
    n, height, width = color.shape
    t = prep.attrs.shape[1]
    nt = tr.tctrl.shape[1]
    if n > 65535:
        raise ValueError(f"{n} instances exceed the grid's z limit 65535")
    if mode not in (0, 1, 2):
        raise ValueError(f"unknown composite mode {mode}")
    args = [_check("tctrl", tr.tctrl, torch.int32, (n, nt, 8), dev),
            _check("tfscal", tr.tfscal, torch.float32, (n, nt, 12), dev),
            _check("ctrl", prep.ctrl, torch.int32, (n, t, 8), dev),
            _check("attrs", prep.attrs, torch.float32, (n, t, 32), dev),
            *_check_atlas(atlas, dev),
            _check("depth", depth, torch.float32, (n, height, width), dev),
            _check("color", color, torch.int32, (n, height, width), dev)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.raster_composite(*args, n, nt, t, height, width, int(shading),
                               int(mode), stream)
    _raise_on(err, "raster_composite")
    raster_composite.launches += 1
    return color


raster_composite.launches = 0
