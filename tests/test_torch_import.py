"""The port never needs jax: importing every module of bonnie32_tpu_torch
(and the shared test level) in a fresh interpreter leaves jax out of
sys.modules, and no source file of the package imports it."""

import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "bonnie32_tpu_torch"
MODULES = sorted(
    ".".join(p.relative_to(REPO).with_suffix("").parts)
    for p in PKG.rglob("*.py") if p.name != "__init__.py")


@pytest.mark.parametrize("module", ["bonnie32_tpu_torch"] + MODULES)
def test_import_leaves_jax_out(module):
    code = (f"import sys; sys.path[:0] = [{str(REPO)!r}, "
            f"{str(REPO / 'tests')!r}]; import {module}; import torch_scenes; "
            "assert 'jax' not in sys.modules, 'jax was imported'")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_no_source_imports_jax():
    for p in PKG.rglob("*.py"):
        for line in p.read_text().splitlines():
            stripped = line.strip()
            assert not (stripped.startswith("import jax")
                        or stripped.startswith("from jax")), f"{p}: {line}"
