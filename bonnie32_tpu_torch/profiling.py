"""Profiling: frame timings and rasterizer statistics
(bonnie32_tpu/profiling.py).

The reference tracks per-phase wall-clock timings (RasterTimings,
`rasterizer/types.rs:1499`; FrameTimings, `game/runtime.rs:13`;
EditorFrameTimings, `editor/state.rs:13`) plus a `triangles_drawn`
counter (render.rs:2545).  Here:

  * RasterStats — counters (triangles drawn, opaque vs transparent
    split, culling breakdown) from the surface build the sequential
    renderer runs (ops/surface.build_surfaces), on the cameras' device,
    exact;
  * Profiler / FrameTimings — host-side phase timers with the
    reference's accumulate semantics; a phase given tensors waits for
    their CUDA device before it stops the clock;
  * trace() — torch.profiler around a block, written as a Chrome trace;
    `busy_share` reads from it the share of the traced window in which a
    kernel ran on the card (one minus it is the device's idle share).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from .config import RasterSettings
from .ops.surface import build_surfaces
from .tree import tensors
from .types import (CameraArrays, FaceArrays, Fog, Lights, MeshArrays,
                    TextureAtlas)


class RasterStats(NamedTuple):
    """Counters of one render, i32: 0-dim for one camera, (I,) for a
    batch of cameras.

    triangles_drawn matches render.rs:2545 (surfaces surviving the cull
    phase, both passes).
    """

    triangles_in: torch.Tensor       # valid input faces
    triangles_drawn: torch.Tensor    # after near/fog/backface culling
    opaque_drawn: torch.Tensor       # pass-1 surfaces
    transparent_drawn: torch.Tensor  # pass-2 surfaces
    backfaces_culled: torch.Tensor   # valid faces rejected as backfacing


def raster_stats(mesh: MeshArrays, faces: FaceArrays, atlas: TextureAtlas,
                 camera: CameraArrays, lights: Lights, fog: Fog,
                 settings: RasterSettings, width: int,
                 height: int) -> RasterStats:
    """Counters from the same cull pass the renderer runs, for one camera
    (position (3,)) or a batch ((I, 3))."""
    one = camera.position.dim() == 1
    cams = (CameraArrays(camera.position[None], camera.basis[None]) if one
            else camera)
    s = build_surfaces(mesh, faces, atlas, cams, lights, fog, settings,
                       width, height)
    drawn = s.valid                                   # (I, T)
    valid = faces.valid.expand_as(drawn)

    def count(m):
        c = m.sum(-1).to(torch.int32)
        return c[0] if one else c

    return RasterStats(
        triangles_in=count(valid),
        triangles_drawn=count(drawn),
        opaque_drawn=count(drawn & ~s.has_transparency),
        transparent_drawn=count(drawn & s.has_transparency),
        backfaces_culled=count(valid & ~drawn),
    )


@dataclasses.dataclass
class FrameTimings:
    """Host-side per-phase accumulator (types.rs:1516 accumulate())."""

    ms: Dict[str, float] = dataclasses.field(default_factory=dict)
    counts: Dict[str, int] = dataclasses.field(default_factory=dict)

    def add(self, phase: str, seconds: float) -> None:
        self.ms[phase] = self.ms.get(phase, 0.0) + seconds * 1e3
        self.counts[phase] = self.counts.get(phase, 0) + 1

    def accumulate(self, other: "FrameTimings") -> None:
        for k, v in other.ms.items():
            self.ms[k] = self.ms.get(k, 0.0) + v
        for k, v in other.counts.items():
            self.counts[k] = self.counts.get(k, 0) + v

    @property
    def total_ms(self) -> float:
        return sum(self.ms.values())

    def summary(self) -> str:
        lines = []
        for k in sorted(self.ms, key=self.ms.get, reverse=True):
            n = self.counts.get(k, 1)
            lines.append(f"{k:24s} {self.ms[k]:10.3f} ms"
                         f"  ({self.ms[k] / max(n, 1):8.3f} ms/call x{n})")
        lines.append(f"{'total':24s} {self.total_ms:10.3f} ms")
        return "\n".join(lines)


def _wait_for(tree) -> None:
    """Wait for every CUDA device that holds a tensor of `tree`; CPU
    tensors are ready when they exist."""
    for dev in {t.device for t in tensors(tree) if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


class Profiler:
    """Phase timer.  `with prof.phase("raster", sync=out): ...`
    accumulates wall time; the tensors of `sync` are waited for, so a
    phase's time includes the device work it queued (without it, the
    time would be charged to whoever synchronizes next)."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.timings = FrameTimings()

    @contextlib.contextmanager
    def phase(self, name: str, sync: Optional[object] = None):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                _wait_for(sync)
            self.timings.add(name, time.perf_counter() - t0)

    def timed(self, name: str, fn, *args, **kwargs):
        """Run fn, wait for the tensors it returns, charge the wall time
        to `name`."""
        if not self.enabled:
            return fn(*args, **kwargs)
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        _wait_for(out)
        self.timings.add(name, time.perf_counter() - t0)
        return out

    def reset(self) -> FrameTimings:
        out = self.timings
        self.timings = FrameTimings()
        return out

    def summary(self) -> str:
        return self.timings.summary()


TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler around the block; yields the profiler and, on exit,
    writes its Chrome trace to `log_dir`/trace.json (chrome://tracing,
    Perfetto).  The card's activity is traced where torch sees a card;
    on a CPU-only build the host's alone."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def kernel_events(prof) -> List:
    """The kernels the card ran in a finished trace (its CUDA events
    other than copies and fills)."""
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.name.startswith(("Memcpy", "Memset"))]


def busy_share(prof) -> float:
    """The share of the traced window (first event's start to the last
    event's end, host and card) covered by the union of the kernels'
    intervals; 0.0 without a kernel."""
    events = prof.events()
    if not events:
        return 0.0
    lo = min(e.time_range.start for e in events)
    hi = max(e.time_range.end for e in events)
    spans: List[Tuple[float, float]] = sorted(
        (e.time_range.start, e.time_range.end) for e in kernel_events(prof))
    busy, end = 0.0, lo
    for a, b in spans:
        a = max(a, end)
        if b > a:
            busy += b - a
            end = b
    return busy / (hi - lo) if hi > lo else 0.0
