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


JAX_PKG = REPO / "bonnie32_tpu"
SOURCES = sorted([p for p in PKG.rglob("*")
                  if p.suffix in (".py", ".cu", ".cpp")]
                 + [REPO / "chip_smoke.py"])


def test_import_runs_no_file_of_the_jax_package():
    """Every module of the port, the shared scenes and chip_smoke in one
    fresh interpreter: no loaded module's file lies under bonnie32_tpu/."""
    prefix = str(JAX_PKG) + "/"
    code = (f"import sys; sys.path[:0] = [{str(REPO)!r}, "
            f"{str(REPO / 'tests')!r}]\n"
            f"for m in {['bonnie32_tpu_torch'] + MODULES!r}: __import__(m)\n"
            "import torch_scenes, chip_smoke\n"
            "files = [getattr(m, '__file__', None) or ''\n"
            "         for m in list(sys.modules.values())]\n"
            f"bad = [f for f in files if f.startswith({prefix!r})]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_native_parser_is_the_ports_own():
    """Parsing RON through the port (its native parser, built at first
    use) in a fresh interpreter loads the port's own `_b32native_torch`
    from build/native/, and no `_b32native` built from the JAX package's
    native/ directory."""
    code = (f"import sys; sys.path[:0] = [{str(REPO)!r}]\n"
            "from bonnie32_tpu_torch.io import ron\n"
            "from bonnie32_tpu_torch import native\n"
            "assert ron.loads('(a: Foo(1))')['a'].name == 'Foo'\n"
            "assert '_b32native' not in sys.modules\n"
            "mod = sys.modules[native.NAME]\n"
            "assert mod.__file__ == str(native.library_path())\n"
            f"assert not mod.__file__.startswith({str(JAX_PKG) + '/'!r})\n"
            "files = [getattr(m, '__file__', None) or ''\n"
            "         for m in list(sys.modules.values())]\n"
            f"assert not [f for f in files if 'b32native' in f and "
            f"f.startswith({str(JAX_PKG) + '/'!r})]\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_source_names_no_jax_package_module(path):
    """No source of the port, nor chip_smoke.py, names a module of the
    JAX package, the old alias package, or a path built to its
    directory."""
    text = path.read_text()
    assert "bonnie32_tpu." not in text
    assert "_host" not in text
    for quote in "'\"":
        assert f"{quote}bonnie32_tpu{quote}" not in text


def test_every_cuda_source_has_a_loader_entry():
    """Each .cu file of the package is a source of ops/_cuda.py's loader
    (built at first use into a library named after it), and the loader
    names no file that is missing."""
    from bonnie32_tpu_torch.ops import _cuda
    on_disk = sorted(p for p in PKG.rglob("*.cu"))
    assert sorted(_cuda.SOURCES.values()) == on_disk
    assert sorted(_cuda.SOURCES) == ["audio", "gather", "raster"]
    for name in _cuda.SOURCES:
        path = _cuda.library_path(name)
        assert path.parent == _cuda.BUILD_DIR
        assert path.name.startswith(name + "_") and path.suffix == ".so"
