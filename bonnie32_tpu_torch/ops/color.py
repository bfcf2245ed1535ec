"""PS1 RGB555 colour ops on int32 tensors (bonnie32_tpu/ops/color.py).

Color15 pack/unpack (`sRRRRRGG GGGBBBBB`, bit 15 the STP bit, 0x0000 the
colour key), 5->8 expansion, vertex-colour modulation, the PS1 dither
matrix and dither-quantize, RGB555 blending in 5-bit space and RGBA8
packing, plus the closed-form Bayer offsets of
`raster_batch._dither_offsets`.  The CUDA kernels (csrc/raster.cu) carry
the same integer expressions.  Python ints broadcast as tensors do.
"""

import numpy as np
import torch

from ..config import BlendMode

TRANSPARENT = 0x0000
BLACK_DRAWABLE = 0x8000
WHITE = 0x7FFF
STP_BIT = 0x8000

# PS1 GPU dither matrix (render.rs:1150-1155), signed offsets -4..+3
PS1_DITHER_MATRIX = np.array(
    [[-4, 0, -3, 1],
     [2, -2, 3, -1],
     [-3, 1, -4, 0],
     [3, -1, 2, -2]], dtype=np.int32)


def _i32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int32)


def pack15(r5, g5, b5, stp=None) -> torch.Tensor:
    """Color15::new / new_semi (types.rs:41-56); channels clamped to 31."""
    c = ((torch.clamp(_i32(r5), max=31) << 10)
         | (torch.clamp(_i32(g5), max=31) << 5) | torch.clamp(_i32(b5),
                                                              max=31))
    if stp is not None:
        c = torch.where(torch.as_tensor(stp), c | STP_BIT, c)
    return c


def is_transparent(c) -> torch.Tensor:
    """types.rs:100: the all-zero word is the colour key."""
    return _i32(c) == 0


def is_semi_transparent(c) -> torch.Tensor:
    """types.rs:106: bit 15."""
    return (_i32(c) & STP_BIT) != 0


def r5(c: torch.Tensor) -> torch.Tensor:
    return (c >> 10) & 0x1F


def g5(c: torch.Tensor) -> torch.Tensor:
    return (c >> 5) & 0x1F


def b5(c: torch.Tensor) -> torch.Tensor:
    return c & 0x1F


def expand_5_to_8(v5: torch.Tensor) -> torch.Tensor:
    """(v5 << 3) | (v5 >> 2): 0->0, 31->255 (render.rs:1161)."""
    return (v5 << 3) | (v5 >> 2)


def r8(c) -> torch.Tensor:
    return expand_5_to_8(r5(_i32(c)))


def g8(c) -> torch.Tensor:
    return expand_5_to_8(g5(_i32(c)))


def b8(c) -> torch.Tensor:
    return expand_5_to_8(b5(_i32(c)))


def from_rgb888(r, g, b) -> torch.Tensor:
    """Color15::from_rgb888 (types.rs:60): quantize by >> 3."""
    return pack15(_i32(r) >> 3, _i32(g) >> 3, _i32(b) >> 3)


def to_rgba_channels(c):
    """Color15::to_rgba (types.rs:220): the colour key -> (0, 0, 0, 0)."""
    c = _i32(c)
    t = is_transparent(c)
    zero = torch.zeros_like(c)
    return (torch.where(t, zero, r8(c)), torch.where(t, zero, g8(c)),
            torch.where(t, zero, b8(c)),
            torch.where(t, zero, torch.full_like(c, 255)))


def modulate8(tex8, vertex8) -> torch.Tensor:
    """(tex * vertex) / 128, at most 255 (render.rs:1624-1626); the
    operands are non-negative, so the division is a shift."""
    return torch.clamp((_i32(tex8) * _i32(vertex8)) >> 7, max=255)


def dither_offset(x, y) -> torch.Tensor:
    """PS1_DITHER_MATRIX[y & 3][x & 3] (render.rs:1174)."""
    x, y = _i32(x), _i32(y)
    m = torch.from_numpy(PS1_DITHER_MATRIX).to(x.device)
    return m[(y & 3).long(), (x & 3).long()]


def quantize8(v8) -> torch.Tensor:
    """Plain truncation v8 >> 3 (render.rs:1653)."""
    return _i32(v8) >> 3


def blend5(blend, f8, b8_) -> torch.Tensor:
    """One channel of blend_rgb555 (render.rs:1093-1145) on 8-bit
    operands, for BlendMode codes `blend`; the output is the plain v5 << 3
    expansion (render.rs:1143)."""
    f5 = f8 >> 3
    b5_ = b8_ >> 3
    v5 = torch.where(
        blend == int(BlendMode.AVERAGE), torch.clamp((b5_ + f5) >> 1, max=31),
        torch.where(
            blend == int(BlendMode.ADD), torch.clamp(b5_ + f5, max=31),
            torch.where(
                blend == int(BlendMode.SUBTRACT), torch.clamp(b5_ - f5, min=0),
                torch.where(
                    blend == int(BlendMode.ADD_QUARTER),
                    torch.clamp(b5_ + (f5 >> 2), max=31),
                    torch.where(blend == int(BlendMode.ERASE), b5_, f5)))))
    return v5 << 3


def blend_rgb555(front8, back8, mode):
    """The PS1 blend in 5-bit space (render.rs:1093-1145) of (r, g, b)
    8-bit channel tuples under BlendMode codes `mode`."""
    mode = _i32(mode)
    return tuple(blend5(mode, _i32(f), _i32(b)) for f, b in zip(front8,
                                                                 back8))


def dither_and_quantize8(v8: torch.Tensor, offset: torch.Tensor
                         ) -> torch.Tensor:
    """((v8 + offset) >> 3).clamp(0, 31) (render.rs:1177)."""
    return torch.clamp((v8 + offset) >> 3, 0, 31)


def pack_rgb(rgb) -> int:
    """An (r, g, b) colour of 8-bit ints as the opaque RGBA8 word, an
    int32 value (the wrap of `pack_rgba8(r, g, b, 255)`)."""
    r, g, b = rgb
    word = r | (g << 8) | (b << 16) | (255 << 24)
    return word - (1 << 32) if word >= (1 << 31) else word  # i32 wrap


def pack_rgba8(r, g, b, a) -> torch.Tensor:
    """r | g<<8 | b<<16 | a<<24 as int32 (a=255 wraps to a negative word,
    like the JAX package's int32 packing)."""
    return r | (g << 8) | (b << 16) | (a << 24)


def unpack_rgba8(word):
    w = _i32(word)
    return w & 0xFF, (w >> 8) & 0xFF, (w >> 16) & 0xFF, (w >> 24) & 0xFF


def dither_offsets(xi: torch.Tensor, yi: torch.Tensor) -> torch.Tensor:
    """PS1_DITHER_MATRIX[y & 3][x & 3] in the closed form of
    raster_batch._dither_offsets."""
    xe = (xi + (yi & 2)) & 3
    m0 = -4 + ((xe & 1) << 2) + (xe >> 1)
    odd = (yi & 1) != 0
    return m0 + torch.where(odd, 6 - ((xi & 1) << 3), torch.zeros_like(xi))
