"""bonnie32_tpu_torch — the PyTorch + CUDA port of bonnie32_tpu.

The JAX package `bonnie32_tpu/` stays the reference; this package mirrors
its module names (the counterpart of `bonnie32_tpu/x/y.py` is
`bonnie32_tpu_torch/x/y.py`) and ports the batched datagen frame: game
tick, character camera, flat-level surfaces, and the rasterizer's
visibility + resolve phases as hand-written CUDA kernels for Hopper
(`csrc/raster.cu`, built with nvcc at first use).

Idiom: NamedTuples of tensors instead of pytrees, an explicit leading
instance dimension instead of vmap, an explicit `device` wherever tensors
are created.  Nothing here imports jax; the pure-numpy host modules of the
JAX package (level model, RON/brotli IO, config) load through the
`_host` alias package without running `bonnie32_tpu/__init__.py`.
"""

__version__ = "0.1.0"

from ._host.config import (RasterSettings, ShadingMode,  # noqa: F401
                           BlendMode)
