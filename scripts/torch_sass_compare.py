#!/usr/bin/env python3
"""Compare the machine code (SASS) of the kernels of
bonnie32_tpu_torch/csrc/raster.cu in this checkout with those of another
checkout, kernel by kernel, on a machine with nvcc and cuobjdump.

    python3 scripts/torch_sass_compare.py --tree PATH

Both sources are compiled with this checkout's nvcc flags into cubins
(one nvcc each, started together).  A kernel of the other tree is paired
with the kernel of this one whose name is the same once the template
arguments this tree added are dropped from the end (a new trailing
`bool` parameter defaults to false: `resolve_kernel` pairs with
`resolve_kernel<false>`, `visibility_kernel<true>` with
`visibility_kernel<true, false>`).  For each pair it prints the
instruction counts and how many instructions differ once addresses,
encodings and the file's anonymous-namespace tag are dropped; kernels of
this tree without a partner are listed by their instruction counts.
Imports nothing of jax.
"""
import argparse
import os
import re
import shutil
import subprocess
import sys
import tempfile

repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, repo)
from bonnie32_tpu_torch.ops import _cuda  # noqa: E402

parser = argparse.ArgumentParser()
parser.add_argument("--tree", required=True)
args = parser.parse_args()
sources = {"this": _cuda.SOURCES["raster"],
           "other": os.path.join(os.path.abspath(args.tree),
                                 "bonnie32_tpu_torch", "csrc", "raster.cu")}
flags = [f for f in _cuda.nvcc_flags()
         if f not in ("-shared", "-Xcompiler", "-fPIC")]
cuobjdump = shutil.which("cuobjdump") or os.path.join(
    os.path.dirname(_cuda._nvcc()), "cuobjdump")
print("card:", subprocess.run(
    ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
    capture_output=True, text=True).stdout.strip())


def demangle(names):
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True,
                             check=True).stdout.splitlines()
    except (OSError, subprocess.CalledProcessError):
        return list(names)
    return out if len(out) == len(names) else list(names)


def kernels(cubin):
    """{demangled name without arguments: [normalized instructions]}."""
    sass = subprocess.run([cuobjdump, "-sass", cubin], capture_output=True,
                          text=True, check=True).stdout
    funcs, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;?\s*/\*", line)
        if m and name:
            # the anonymous namespace's per-file tag appears in symbols
            funcs[name].append(re.sub(r"_GLOBAL__N__\w+?_cu_\w{8}", "",
                                      m.group(1)))
    names = list(funcs)
    return {re.sub(r"^void ", "", d.replace("(anonymous namespace)::", "")
                   ).split("(")[0]: funcs[n]
            for d, n in zip(demangle(names), names)}


with tempfile.TemporaryDirectory() as tmp:
    procs = {}
    for side, src in sources.items():
        out = os.path.join(tmp, f"{side}.cubin")
        procs[side] = (out, subprocess.Popen(
            [_cuda._nvcc(), *flags, "-cubin", "-o", out, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    code = {}
    for side, (out, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            sys.exit(f"nvcc failed on the {side} tree:\n{log}")
        code[side] = kernels(out)


def partner(name, others):
    """The other tree's kernel whose name this one's becomes when its
    trailing template arguments are `false` and dropped."""
    cut = name
    while True:
        if cut in others:
            return cut
        m = re.match(r"^(.*?)(?:, false>|<false>)$", cut)
        if not m:
            return None
        cut = m.group(1) + (">" if cut.endswith(", false>") else "")


for name in sorted(code["this"]):
    ops = code["this"][name]
    other = partner(name, code["other"])
    if other is None:
        print(f"{name}: {len(ops)} instructions (no partner)")
        continue
    theirs = code["other"][other]
    differ = sum(a != b for a, b in zip(ops, theirs)) + abs(
        len(ops) - len(theirs))
    print(f"{name} vs {other}: {len(ops)} / {len(theirs)} instructions, "
          f"{differ} differ" + (" (identical)" if differ == 0 else ""))
