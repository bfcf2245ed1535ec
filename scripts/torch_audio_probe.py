#!/usr/bin/env python3
"""Probe the SPU kernels of bonnie32_tpu_torch/csrc/audio.cu on the card.

    python3 scripts/torch_audio_probe.py [--presets 5 1] [--sass FILE]

Builds csrc/audio.cu, then:

  * the SASS of `spu_reverb_kernel` (cuobjdump -sass): every loop of more
    than 40 instructions (a backward branch and its target) with its
    instruction count and its shared loads, shared stores and integer
    multiplies, so a tick's instruction count can be read off the chain's
    loop (the paired loop runs two ticks an iteration);
  * `spu_reverb` and `spu_resample` timed at S=1 x 735 samples (one 60 Hz
    frame), S=1 x 4,096 and S=64 x 4,096, each preset of `--presets`
    (5: HALL, which the layout pairs; 1: ROOM, forwarded), queued behind
    a matrix product so that the card's time is read, not the host's:
    ms a call, ns a 22.05 kHz tick, ns a sample;
  * the card's name, power limit and SM clocks beside the times.

Needs a CUDA card and nvcc; imports nothing of jax.
"""

import argparse
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from bonnie32_tpu_torch.audio import resampler as rsp  # noqa: E402
from bonnie32_tpu_torch.audio import reverb as rvb  # noqa: E402
from bonnie32_tpu_torch.ops import _cuda  # noqa: E402

SHAPES = ((1, 735), (1, 4096), (64, 4096))
REPS = 10


def smi(query):
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def sass_loops(sass: str, kernel: str):
    """(start, end, instructions, LDS, STS, IMAD) of each loop of the
    kernel's SASS longer than 40 instructions."""
    body = re.search(rf"Function : \S*{kernel}\S*\n(.*?)(?:\n\s*Function :|\Z)",
                     sass, re.S).group(1)
    ops = [(int(a, 16), op) for a, op in re.findall(
        r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", body)]
    loops = []
    for a, op in ops:
        if not op.startswith("BRA"):
            continue
        m = re.search(rf"/\*{a:04x}\*/[^\n]*BRA[^\n]*?0x([0-9a-f]+)", body)
        target = int(m.group(1), 16) if m else a
        if target < a:
            inside = [o for x, o in ops if target <= x <= a]
            if len(inside) > 40:
                loops.append((target, a, len(inside),
                              sum(o.startswith("LDS") for o in inside),
                              sum(o.startswith("STS") for o in inside),
                              sum(o.startswith("IMAD") for o in inside)))
    return loops


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--presets", type=int, nargs="+", default=[5, 1])
    ap.add_argument("--sass", help="write the kernel library's SASS here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda", 0)
    card = f"[{smi('name,power.limit')}]"
    lib = _cuda.build(["audio"])["audio"]
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    if args.sass:
        with open(args.sass, "w") as f:
            f.write(sass)
    for start, end, n, lds, sts, imad in sass_loops(sass,
                                                    "spu_reverb_kernel"):
        print(f"spu_reverb_kernel loop {start:#06x}-{end:#06x}: {n} "
              f"instructions, {lds} LDS, {sts} STS, {imad} IMAD")

    ballast = torch.ones((4096, 4096), device=dev)
    rng = np.random.default_rng(0)

    def queued_ms(fn):
        fn()
        torch.cuda.synchronize()
        evs = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.matmul(ballast, ballast)
        evs[0].record()
        for _ in range(REPS):
            fn()
        evs[1].record()
        torch.cuda.synchronize()
        return evs[0].elapsed_time(evs[1]) / REPS

    consts = rvb._scalars(80 / 127.0, 1.0, 2.0)
    for preset in args.presets:
        lay = rvb.window_layout(rvb.preset_params(preset))
        for s, n in SHAPES:
            x = torch.from_numpy((rng.standard_normal((s, n)) * 0.4)
                                 .astype(np.float32)).to(dev)
            st = rvb.init_state(dev, streams=s)
            p = torch.from_numpy(np.repeat(rvb.preset_params(preset)[None],
                                           s, 0)).to(dev)
            ms_r = queued_ms(lambda: rvb.spu_reverb(st, x, x, p, *consts,
                                                    True))
            q = rsp.init_state(dev, streams=s)
            ms_q = queued_ms(lambda: rsp.spu_resample(q, x, x, rsp.PITCH_22K,
                                                      True))
            print(f"preset {preset} ({'paired' if lay.paired else 'forwarded'}"
                  f"), S={s} x {n}: spu_reverb {ms_r:.4f} ms "
                  f"({ms_r * 1e6 / (n // 2):.1f} ns a tick), spu_resample "
                  f"{ms_q:.4f} ms ({ms_q * 1e6 / n:.2f} ns a sample); SM "
                  f"clock {smi('clocks.sm')} of {smi('clocks.max.sm')} {card}",
                  flush=True)


if __name__ == "__main__":
    main()
