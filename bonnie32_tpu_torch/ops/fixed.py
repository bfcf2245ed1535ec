"""PS1 GTE fixed-point math on int tensors (bonnie32_tpu/ops/fixed.py).

4.12 fixed point in int32 storage with wrapping adds, the UNR
Newton-Raphson division and the fixed projection pipeline
(the reference's `src/rasterizer/fixed.rs`).  The JAX package builds the
64-bit products from 16-bit limbs because XLA:TPU scalarizes int64; here
every product is a native int64 and each 32-bit wrap is an explicit
mask, which torch computes the same way on the CPU and the GPU.
"""

import numpy as np
import torch

FRAC_BITS = 12
ONE = 1 << FRAC_BITS  # 4096

_I32_MAX_F = 2147483520.0   # largest f32 below 2^31


def f32_to_i32(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 -> i32 convert: truncate, NaN -> 0, saturate at the i32
    range.  torch's own cast gives INT_MIN for NaN and out-of-range values
    on x86, so every float -> int cast of the port whose input is not
    provably in range goes through here."""
    t = torch.where(torch.isnan(x), torch.zeros_like(x), x)
    i = torch.clamp(t, -2147483648.0, _I32_MAX_F).to(torch.int32)
    return torch.where(t >= 2147483648.0,
                       torch.full_like(i, 2147483647), i)


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wrap-around."""
    return (((x + 2 ** 31) & 0xFFFFFFFF) - 2 ** 31).to(torch.int32)


def from_f32(f: torch.Tensor) -> torch.Tensor:
    """Fixed32::from_f32 (fixed.rs:125): (f * 4096.0) as i32, Rust `as`
    (truncate, saturate, NaN -> 0)."""
    return f32_to_i32(torch.trunc(f.to(torch.float32) * float(ONE)))


def from_int(n: int) -> int:
    """Fixed32::from_int (fixed.rs:119) for the host constants."""
    return ((n << FRAC_BITS) + 2 ** 31) % 2 ** 32 - 2 ** 31


def to_f32(x: torch.Tensor) -> torch.Tensor:
    """Fixed32::to_f32 (fixed.rs:131)."""
    return x.to(torch.float32) / float(ONE)


def floor(x: torch.Tensor) -> torch.Tensor:
    """Fixed32::floor (fixed.rs:137): arithmetic >> 12."""
    return x >> FRAC_BITS


def mul_fixed(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """((a as i64 * b as i64) >> 12) as i32 (fixed.rs:161)."""
    return _wrap32((a.to(torch.int64) * b.to(torch.int64)) >> FRAC_BITS)


def add(a: torch.Tensor, b) -> torch.Tensor:
    """Wrapping i32 add (fixed.rs:233)."""
    return _wrap32(a.to(torch.int64) + b)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Wrapping i32 sub (fixed.rs:241)."""
    return _wrap32(a.to(torch.int64) - b.to(torch.int64))


def div_unr(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """PS1 GTE UNR division (fixed.rs:178-230), elementwise.  4.12 inputs,
    4.12 result with the authentic data-dependent error."""
    n64 = num.to(torch.int64)
    d64 = den.to(torch.int64)
    negative = (n64 < 0) != (d64 < 0)
    n_abs = n64.abs()
    d_abs = torch.where(d64 == 0, torch.ones_like(d64), d64.abs())

    # leading zeros of the 32-bit divisor: d_abs < 2^32 is exact in f64,
    # and frexp's exponent is its bit length
    z = 32 - torch.frexp(d_abs.to(torch.float64)).exponent.to(torch.int64)
    d16 = (d_abs << z) >> 16                       # in [0x8000, 0xFFFF]

    idx = torch.clamp((d16 - 0x7FC0) >> 7, max=256)
    # UNR_TABLE[idx] + 0x101, from the table's generating formula
    q = 0x40000 // (idx + 0x100)
    u = torch.clamp((q + 1) >> 1, min=0x101)

    nr1 = (0x2000080 - d16 * u) >> 8
    nr2 = (0x80 + nr1 * u) >> 8

    shift = 36 - z                                  # in [5, 36]
    raw = n_abs * nr2                               # < 2^50
    mag = (raw + (torch.ones_like(shift) << (shift - 1))) >> shift
    mag = torch.clamp(mag, max=0x7FFFFFFF)
    out = torch.where(negative, -mag, mag).to(torch.int32)
    return torch.where(d64 == 0, torch.zeros_like(out), out)


def transform_to_camera_space(world_pos, camera_pos, basis):
    """fixed.rs:362.  world_pos (..., 3) f32, camera_pos broadcastable to
    it, basis (..., 3, 3) rows broadcastable against world_pos[..., None, :].
    Returns (..., 3) int32 4.12 camera-space coordinates."""
    wp = from_f32(world_pos)
    cp = from_f32(camera_pos)
    rel = sub(wp, cp)
    b = from_f32(basis)

    def dot_row(row):
        t0 = mul_fixed(rel[..., 0], row[..., 0])
        t1 = mul_fixed(rel[..., 1], row[..., 1])
        t2 = mul_fixed(rel[..., 2], row[..., 2])
        return add(add(t0, t1), t2)

    return torch.stack([dot_row(b[..., 0, :]), dot_row(b[..., 1, :]),
                        dot_row(b[..., 2, :])], dim=-1)


def project_to_screen(cam_fixed, width: int, height: int):
    """fixed.rs:390: 4.12 camera space -> integer screen coords."""
    distance = 5 * ONE                                       # from_f32(5.0)
    scale = 4 * ONE                                          # from_f32(4.0)
    viewport_scale = int(np.trunc(np.float32((min(width, height) / 2.0)
                                             * 0.75) * np.float32(ONE)))
    half_w = from_int(width // 2)
    half_h = from_int(height // 2)

    cx, cy, cz = cam_fixed[..., 0], cam_fixed[..., 1], cam_fixed[..., 2]
    denom = add(cz, distance)
    near_zero = denom.abs() < 256      # int32 abs: i32::MIN stays negative

    proj_x = div_unr(mul_fixed(cx, torch.full_like(cx, scale)), denom)
    proj_y = div_unr(mul_fixed(cy, torch.full_like(cy, scale)), denom)
    vs = torch.full_like(proj_x, viewport_scale)
    sx = floor(add(mul_fixed(proj_x, vs), half_w))
    sy = floor(add(mul_fixed(proj_y, vs), half_h))
    sx = torch.where(near_zero, torch.full_like(sx, half_w >> FRAC_BITS), sx)
    sy = torch.where(near_zero, torch.full_like(sy, half_h >> FRAC_BITS), sy)
    return sx, sy, cz


def project_fixed(world_pos, camera_pos, basis, width: int, height: int):
    """fixed.rs:424: world -> (sx, sy) int32 screen coords and the fixed
    camera z as f32."""
    cam = transform_to_camera_space(world_pos, camera_pos, basis)
    sx, sy, depth = project_to_screen(cam, width, height)
    return sx, sy, to_f32(depth)
