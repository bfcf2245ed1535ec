"""The native (C++) RON parser of b32native.cpp, built on demand with g++.

`get()` returns the `_b32native_torch` extension module, compiling it at
first use into `<repo>/build/native/` under a name keyed on a hash of the
source, the compiler command and the interpreter's extension suffix, and
installing io/ron.py's `Tag` as its enum-variant factory.  A failed build
raises with the compiler's output; there is no fall-back to the Python
parser (io/ron.loads_py stays, and callers may ask for it).  Nothing here
runs at import.
"""

import hashlib
import importlib.util
import os
import subprocess
import sysconfig
import threading
from pathlib import Path

NAME = "_b32native_torch"
SOURCE = Path(__file__).resolve().parent / "b32native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_module = None


def _command(out: Path) -> list:
    include = sysconfig.get_paths()["include"]
    return ["g++", *CXX_FLAGS, f"-I{include}", str(SOURCE), "-o", str(out)]


def library_path() -> Path:
    """Where the module built from the current source lives."""
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    key = (SOURCE.read_bytes() + " ".join(_command(Path("out"))).encode()
           + suffix.encode())
    return BUILD_DIR / f"{NAME}_{hashlib.sha256(key).hexdigest()[:16]}{suffix}"


def build() -> Path:
    """Compile the module unless its hashed library exists; several
    processes may build at once (each writes its own file, the last
    rename wins).  Raises RuntimeError with g++'s output on failure."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run(_command(tmp), capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"g++ could not build {SOURCE.name}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on {SOURCE.name} ({proc.returncode})"
                           f":\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def get():
    """The compiled module, built and loaded at first call."""
    global _module
    with _lock:
        if _module is None:
            path = build()
            spec = importlib.util.spec_from_file_location(NAME, path)
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            from ..io.ron import Tag
            module.set_tag_factory(Tag)
            _module = module
    return _module
