"""bonnie32_tpu_torch — the PyTorch + CUDA port of the JAX package
(`bonnie32_tpu/`).

The JAX package `bonnie32_tpu/` stays the reference; this package mirrors
its module names (the counterpart of `bonnie32_tpu/x/y.py` is
`bonnie32_tpu_torch/x/y.py`) and ports the batched datagen frame: game
tick, character camera, flat-level surfaces, and the rasterizer's
visibility, resolve and transparent-composite phases as hand-written CUDA
kernels for Hopper (`csrc/raster.cu`, built with nvcc at first use).

Idiom: NamedTuples of tensors instead of pytrees, an explicit leading
instance dimension instead of vmap, an explicit `device` wherever tensors
are created.  The entry points run on the card unless the caller passes
`device="cpu"`.  Nothing here imports jax or any file of the JAX package:
the host modules it needs (level model, RON/brotli IO, config) are the
port's own copies.
"""

__version__ = "0.1.0"

from .config import BlendMode, RasterSettings, ShadingMode  # noqa: F401
