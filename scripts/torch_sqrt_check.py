#!/usr/bin/env python3
"""Is torch's square root correctly rounded, on the CPU and on the card?

    python3 scripts/torch_sqrt_check.py [--n 1000000] [--seed 0]

Draws `--n` f32 values uniform in [0.1, 10.1) from a numpy seed and
counts the values whose root differs from numpy's (IEEE, correctly
rounded): torch.sqrt on the CPU (and its vector unit, as
torch.backends.cpu.get_cpu_capability() names it), the port's
ops/fixed.sqrt_rn on the CPU, and, where a card is present, both on the
card, with the card's name and power limit.
"""

import argparse
import os
import subprocess
import sys


def main():
    import numpy as np
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    from bonnie32_tpu_torch.ops.fixed import sqrt_rn

    x = np.random.default_rng(args.seed).uniform(
        0.1, 10.1, args.n).astype(np.float32)
    want = np.sqrt(x)
    t = torch.from_numpy(x)

    def off(root):
        return int((root.cpu().numpy() != want).sum())

    print(f"{args.n} values, CPU {torch.backends.cpu.get_cpu_capability()}:"
          f" torch.sqrt off numpy's {off(torch.sqrt(t))}, sqrt_rn "
          f"{off(sqrt_rn(t))}")
    if torch.cuda.is_available():
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        d = t.cuda()
        print(f"card: torch.sqrt off numpy's {off(torch.sqrt(d))}, sqrt_rn "
              f"{off(sqrt_rn(d))} [{smi}]")


if __name__ == "__main__":
    main()
