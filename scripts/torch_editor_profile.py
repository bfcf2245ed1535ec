#!/usr/bin/env python3
"""Where the editor's frames go on the card.

    python3 scripts/torch_editor_profile.py [--size 320 240]

On the three levels of tests/torch_editor_cases.py (one editor view
each, RasterSettings.modeler()), and for UiContext.paint of
torch_editor_cases.paint_queue with two icons at 640x480: one call as
warm-up, then one call under torch.profiler (CPU and CUDA activities):
the CUDA kernels launched, the device's busy time (the kernels' summed
self time), the call's wall time and the idle share (1 - busy / wall),
for the whole editor view (render_editor_viewport), its overlay pass
alone (draw_viewport_overlays over the finished view) and the paint.

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
    ap.add_argument("--size", type=int, nargs=2, default=[320, 240],
                    metavar=("W", "H"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_editor_profile: needs a CUDA card")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path[:0] = [repo, os.path.join(repo, "tests")]
    import torch_editor_cases as ec
    import torch_scenes as ts
    from bonnie32_tpu_torch import ui
    from bonnie32_tpu_torch.editor import state as ES
    from bonnie32_tpu_torch.editor import viewport_edit as VE
    from bonnie32_tpu_torch.editor import viewport_render as VR
    from bonnie32_tpu_torch.models import asset as A
    from bonnie32_tpu_torch.models import level as L
    from bonnie32_tpu_torch.models import mesh as M
    from bonnie32_tpu_torch.models import scene
    from bonnie32_tpu_torch.models import user_texture as U
    from bonnie32_tpu_torch.types import FrameBuffers
    from torch.profiler import ProfilerActivity, profile

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    card = f"[{smi}]"
    dev = torch.device("cuda", 0)
    width, height = args.size

    def profiled(label, fn):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        kern = [e for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(e.time_range.elapsed_us() for e in kern) / 1e3
        print(f"{label}: {len(kern)} CUDA kernels, device busy "
              f"{busy:.3f} ms of {wall:.3f} ms wall, idle share "
              f"{1.0 - busy / wall:.3f} {card}", flush=True)
        return out

    for name in ec.EDITOR_CASES:
        st, ed, hv, tex, kw = ec.editor_case(name, L, ES, VE, A, M, U, scene)
        sc = scene.compile_level(st.level, tex, ts.resolver, device=dev, **kw)
        view = profiled(
            f"editor view, {name} level, {width}x{height}",
            lambda: VR.render_editor_viewport(st, sc, width, height,
                                              editor=ed, hover=hv))
        profiled(f"overlay pass alone, {name} level, {width}x{height}",
                 lambda: VR.draw_viewport_overlays(view, st, editor=ed,
                                                   hover=hv))

    bg = torch.from_numpy((np.random.default_rng(6).integers(
        0, 1 << 24, (1, 480, 640)) | (255 << 24)).astype(np.uint32).view(
        np.int32)).to(dev)

    def paint():
        fb = FrameBuffers(bg, torch.zeros((1, 480, 640), device=dev))
        fb = ec.paint_queue(ui, scale=4).paint(fb)
        for icon, scale, rect in ec.ICONS[:2]:
            fb = ui.icons.draw_icon_centered(
                fb, icon, ui.Rect(*(4 * v for v in rect)), (255, 220, 40),
                scale=4 * scale)
        return fb

    profiled("UiContext.paint, 25 commands and two icons, 640x480", paint)


if __name__ == "__main__":
    main()
