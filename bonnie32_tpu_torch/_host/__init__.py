"""Alias package over the JAX package's directory.

`bonnie32_tpu/__init__.py` imports jax and turns on x64, so any
`import bonnie32_tpu.<module>` pulls in jax, even for its pure-numpy
modules.  The port must not need jax, yet it reuses those modules as they
are: the level model (`models/level.py`), the RON and brotli IO (`io/`)
and the raster settings (`config.py`).  This package's `__path__` points
at the `bonnie32_tpu/` directory, so `bonnie32_tpu_torch._host.models.level`
loads that very source file as a submodule of this package — its relative
imports (`from ..io import ron`) resolve inside the alias and
`bonnie32_tpu/__init__.py` never runs.

Only the jax-free modules may be imported through here: `config`, `io.*`,
`native`, `models.level`, `models.texture_pack` and
`models.user_texture`.  Everything else in `bonnie32_tpu/` imports jax;
its port is a module of `bonnie32_tpu_torch/` under the same name.
"""

import os

__path__ = [os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "bonnie32_tpu")]
