"""PS1 RGB555 colour ops on int32 tensors (bonnie32_tpu/ops/color.py).

Only what the datagen frame's resolve phase needs: channel extraction,
5->8 expansion, dither-quantize, RGBA8 packing and the closed-form Bayer
offsets of `raster_batch._dither_offsets`.  The CUDA resolve kernel
(csrc/raster.cu) carries the same integer expressions.
"""

import torch

BLACK_DRAWABLE = 0x8000
WHITE = 0x7FFF


def r5(c: torch.Tensor) -> torch.Tensor:
    return (c >> 10) & 0x1F


def g5(c: torch.Tensor) -> torch.Tensor:
    return (c >> 5) & 0x1F


def b5(c: torch.Tensor) -> torch.Tensor:
    return c & 0x1F


def expand_5_to_8(v5: torch.Tensor) -> torch.Tensor:
    """(v5 << 3) | (v5 >> 2): 0->0, 31->255 (render.rs:1161)."""
    return (v5 << 3) | (v5 >> 2)


def dither_and_quantize8(v8: torch.Tensor, offset: torch.Tensor
                         ) -> torch.Tensor:
    """((v8 + offset) >> 3).clamp(0, 31) (render.rs:1177)."""
    return torch.clamp((v8 + offset) >> 3, 0, 31)


def pack_rgba8(r, g, b, a) -> torch.Tensor:
    """r | g<<8 | b<<16 | a<<24 as int32 (a=255 wraps to a negative word,
    like the JAX package's int32 packing)."""
    return r | (g << 8) | (b << 16) | (a << 24)


def dither_offsets(xi: torch.Tensor, yi: torch.Tensor) -> torch.Tensor:
    """PS1_DITHER_MATRIX[y & 3][x & 3] in the closed form of
    raster_batch._dither_offsets."""
    xe = (xi + (yi & 2)) & 3
    m0 = -4 + ((xe & 1) << 2) + (xe >> 1)
    odd = (yi & 1) != 0
    return m0 + torch.where(odd, 6 - ((xi & 1) << 3), torch.zeros_like(xi))
