"""The port's native C++ RON parser (bonnie32_tpu_torch/native/, built
with g++ at first use into build/native/) against its pure-Python parser
io/ron.loads_py, on test_native_ron.py's snippets and error cases and on
a Cave-size level (tests/torch_scenes.py) saved and loaded; `ron.loads`
takes the native parser by default, and a failed build raises."""

import math

import pytest
import torch

import torch_scenes as ts
from bonnie32_tpu_torch import native
from bonnie32_tpu_torch.io import ron
from bonnie32_tpu_torch.models import level as TL

torch.set_num_threads(1)


def eq(a, b):
    """Structural equality with NaN == NaN and Tags by name and value."""
    if isinstance(a, ron.Tag) or isinstance(b, ron.Tag):
        return (isinstance(a, ron.Tag) and isinstance(b, ron.Tag)
                and a.name == b.name and eq(a.value, b.value))
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(eq(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(eq(x, y) for x, y in zip(a, b))
    if isinstance(a, float):
        return (math.isnan(a) and math.isnan(b)) or a == b
    return a == b


# test_native_ron.py's snippets
CASES = [
    "(a: 1, b: 2.5, c: -3, d: 0x1F, e: 1_000, f: 1e-3)",
    "[1, 2, 3,]",
    "(1, 2, 3)",
    "()",
    "Some(42)",
    "None",
    "(x: Some((y: true)), z: false)",
    'NwSe',
    'Point(x: 1.0, y: 2.0)',
    'Rgb(1, 2, 3)',
    '"hi \\"there\\" \\n \\u{263A}"',
    "'x'",
    "{ \"k\": 1, \"j\": [2] }",
    "(v: [inf, -inf, NaN])",
    "// comment\n(a: 1 /* inline */, b: 2)",
    "(single,)",          # 1-tuple unwraps to the value
    "(nested: ((1,2),(3,4)))",
]


@pytest.mark.parametrize("text", CASES)
def test_native_matches_python(text):
    assert eq(ron.loads_py(text), native.get().ron_loads(text)), text
    assert eq(ron.loads_py(text), ron.loads(text.encode())), text


def test_errors():
    mod = native.get()
    with pytest.raises(ValueError):
        mod.ron_loads("(a: 1) trailing")
    with pytest.raises(ValueError):
        mod.ron_loads("(a:")
    with pytest.raises(TypeError):
        mod.ron_loads(123)


def test_default_loads_uses_native(monkeypatch):
    def refuse(text):
        raise AssertionError("loads_py was called")

    monkeypatch.setattr(ron, "loads_py", refuse)
    v = ron.loads("(speed: 5000.0)")
    assert v == {"speed": 5000.0}
    monkeypatch.undo()
    assert ron.loads_py("(speed: 5000.0)") == v
    # the port's Tag class is the module's enum-variant factory
    assert type(ron.loads("Foo(1)")) is ron.Tag


def test_module_is_built_into_the_build_directory():
    mod = native.get()
    path = native.library_path()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert path.name.startswith(native.NAME + "_")
    assert mod.__file__ == str(path)


def test_cave_size_level_round_trip(tmp_path):
    level = ts.cave_size_level(TL)
    text = ron.dumps(level.to_ron())
    assert eq(ron.loads(text), ron.loads_py(text))
    path = tmp_path / "cave.ron"
    TL.save_level(level, path)
    back = TL.load_level(path)
    assert eq(back.to_ron(), TL.Level.from_ron(ron.loads_py(text)).to_ron())
    assert len(back.rooms) == len(level.rooms)


def test_failed_build_raises(monkeypatch, tmp_path):
    bad = tmp_path / "b32native.cpp"
    bad.write_text("#include <Python.h>\nthis is not C++;\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_module", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.get()
    assert not list((tmp_path / "build").glob("*.so"))
