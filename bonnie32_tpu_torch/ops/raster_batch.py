"""Batched rasterizer of the flat datagen frame
(bonnie32_tpu/ops/raster_batch.py, phases 1-2 of the Pallas kernel).

`prep_instance` culls, bounds and compacts every instance's faces;
`rasterize_batch` then runs

  * VISIBILITY (the TPU kernel's phase 1, clean and keyed faces): faces
    in compacted draw order, per pixel the edge functions, barycentrics,
    coverage `min(bc) >= -1e-4` inside the face's clipped bbox, the colour
    key test for keyable faces, and the strict `izi > depth` merge (first
    drawn wins ties).  Output: depth, winner face id and the winner's
    (bcx, bcy) per pixel;
  * RESOLVE (phase 2): per pixel with a winner, the PS1 pixel pipeline —
    affine UV, wrap, texel fetch, black/transparent key fixups, 5->8
    expand, vertex-colour modulate, shade, Bayer dither, RGB555 quantize,
    RGBA8 pack; the background word where no face won.

For CUDA tensors both phases are the hand-written kernels of
csrc/raster.cu (ops/_cuda.py); for CPU tensors they are the plain torch
twins below, `visibility_ref` and `resolve_ref`, which evaluate the same
f32 expressions in the same order (no FMA contraction on either side), so
the two agree bit for bit.  The TPU layout machinery (lane-group layout,
SMEM segment plans, draw-ordered attr gathers) is not ported: planes are
(I, H, W) throughout.
"""

from typing import NamedTuple

import torch

from .._host.config import RasterSettings, ShadingMode
from ..types import Surfaces, TextureAtlas
from . import color as col
from .fixed import f32_to_i32

# attrs column layout (f32), as the JAX package's
C_V3X, C_V3Y, C_A0, C_B0, C_A1, C_B1, C_IA = 0, 1, 2, 3, 4, 5, 6
C_IZA, C_IZB, C_IZC = 7, 8, 9
C_U0, C_VV0, C_U1, C_VV1, C_U2, C_VV2 = 10, 11, 12, 13, 14, 15
C_VCP0, C_VCP1, C_VCP2 = 16, 17, 18
C_SH = 19                      # 19..27: shade corner-major (r,g,b) x3
C_TID, C_FLAGS = 28, 29
N_COLS = 32

# ctrl column layout (i32)
K_XLO, K_XHI, K_YLO, K_YHI, K_TID, K_KEY = 0, 1, 2, 3, 4, 5
N_CTRL = 8

FLAG_DITHER = 1
FLAG_BT = 2

COVER_EPS = -0.0001


class BatchPrep(NamedTuple):
    """Per-instance prepass products, batched over instances."""

    count: torch.Tensor  # (I,) i32 number of kept (compacted) faces
    order: torch.Tensor  # (I, T) i32 kept face ids first, in draw order
    ctrl: torch.Tensor   # (I, T, N_CTRL) i32 bbox, tex id, keyable
    attrs: torch.Tensor  # (I, T, N_COLS) f32 edge/depth/UV/colour/shade


def prep_instance(surfaces: Surfaces, atlas: TextureAtlas,
                  width: int, height: int) -> BatchPrep:
    """Cull + bbox + compact every instance's surfaces (the JAX
    prep_instance, single-segment z-buffer case).  Kept faces are opaque,
    valid, non-degenerate, with a finite non-empty clipped bbox; they
    compact in original (= draw) order by a stable sort."""
    sx, sy = surfaces.sx, surfaces.sy
    v1x, v2x, v3x = sx[..., 0], sx[..., 1], sx[..., 2]
    v1y, v2y, v3y = sy[..., 0], sy[..., 1], sy[..., 2]
    zero = torch.zeros_like(v1x)

    # jnp.minimum/maximum propagate NaN; torch.minimum/maximum do too
    min_xf = torch.maximum(torch.minimum(torch.minimum(v1x, v2x), v3x), zero)
    max_xf = torch.minimum(torch.maximum(torch.maximum(v1x, v2x), v3x) + 1.0,
                           torch.full_like(v1x, float(width)))
    min_yf = torch.maximum(torch.minimum(torch.minimum(v1y, v2y), v3y), zero)
    max_yf = torch.minimum(torch.maximum(torch.maximum(v1y, v2y), v3y) + 1.0,
                           torch.full_like(v1y, float(height)))
    x_lo = f32_to_i32(torch.trunc(min_xf))
    x_hi = torch.clamp(f32_to_i32(torch.trunc(max_xf)), min=0)
    y_lo = f32_to_i32(torch.trunc(min_yf))
    y_hi = torch.clamp(f32_to_i32(torch.trunc(max_yf)), min=0)

    degenerate = surfaces.area.abs() < 0.00001
    nan_box = (torch.isnan(min_xf) | torch.isnan(max_xf)
               | torch.isnan(min_yf) | torch.isnan(max_yf))
    opaque = surfaces.valid & ~surfaces.has_transparency
    keep = (opaque & ~degenerate & ~nan_box
            & (x_hi > x_lo) & (y_hi > y_lo))

    tid = surfaces.tex_id
    safe_tid = torch.clamp(tid, min=0)
    keyable = ((tid >= 0) & surfaces.black_transparent
               & atlas.has_black[safe_tid] & surfaces.key_possible)

    iz, uv, vc = surfaces.inv_z, surfaces.uv, surfaces.vc
    vcp = (vc[..., 0] + (vc[..., 1] << 8) + (vc[..., 2] << 16)).to(
        torch.float32)
    sh = surfaces.shade.reshape(surfaces.shade.shape[:2] + (9,))
    flags = (torch.where(surfaces.needs_dither, FLAG_DITHER, 0)
             | torch.where(surfaces.black_transparent, FLAG_BT, 0))
    n, t = v1x.shape
    attrs = torch.cat([
        torch.stack([v3x, v3y, v2y - v3y, v3x - v2x, v3y - v1y, v1x - v3x,
                     surfaces.inv_area], dim=-1),
        iz, uv.reshape(n, t, 6), vcp, sh,
        torch.stack([tid.to(torch.float32).expand(n, t),
                     flags.to(torch.float32).expand(n, t),
                     zero, zero], dim=-1)], dim=-1)

    ctrl = torch.stack([x_lo, x_hi, y_lo, y_hi, tid.expand(n, t),
                        keyable.to(torch.int32).expand(n, t),
                        torch.zeros_like(x_lo), torch.zeros_like(x_lo)],
                       dim=-1)
    order = torch.sort((~keep).to(torch.int8), dim=1, stable=True).indices
    count = keep.sum(dim=1, dtype=torch.int32)
    return BatchPrep(count=count, order=order.to(torch.int32).contiguous(),
                     ctrl=ctrl.contiguous(), attrs=attrs.contiguous())


def _interp3(bcx, bcy, bcz, a0, a1, a2):
    return (bcx * a0 + bcy * a1) + bcz * a2


def _wrap01(x):
    """Texture UV wrap: fmod into [0, 1), negatives shifted, NaN -> 0."""
    r = x - torch.trunc(x)
    r = torch.where(r < 0, r + 1.0, r)
    return torch.where(torch.isnan(r), torch.zeros_like(r), r)


def _u8_trunc_sat(x):
    """Rust `f32 as u8`: truncate, saturate to [0, 255], NaN -> 0."""
    x = torch.where(torch.isnan(x), torch.zeros_like(x), x)
    return torch.clamp(torch.trunc(x), 0.0, 255.0).to(torch.int32)


def _texel_index(atlas, tid, u, v):
    """Flat atlas index of the texel at (u, v) of texture `tid` >= 0."""
    tw = atlas.width[tid]
    th = atlas.height[tid]
    tx = torch.minimum(torch.trunc(_wrap01(u) * tw.to(torch.float32))
                       .to(torch.int32), tw - 1)
    ty = torch.minimum(torch.trunc(_wrap01(1.0 - v) * th.to(torch.float32))
                       .to(torch.int32), th - 1)
    return atlas.offset[tid] + ty * tw + tx


def visibility_ref(prep: BatchPrep, atlas: TextureAtlas,
                   height: int, width: int):
    """Plain torch twin of the `raster_visibility` kernel.  Returns
    (depth f32, winner i32 original face id or -1, bcx f32, bcy f32), each
    (I, H, W)."""
    n = prep.count.shape[0]
    dev = prep.attrs.device
    yi = torch.arange(height, device=dev, dtype=torch.int32)[None, :, None]
    xi = torch.arange(width, device=dev, dtype=torch.int32)[None, None, :]
    px = xi.to(torch.float32)
    py = yi.to(torch.float32)
    shape = (n, height, width)
    depth = torch.zeros(shape, dtype=torch.float32, device=dev)
    winner = torch.full(shape, -1, dtype=torch.int32, device=dev)
    bcx_p = torch.zeros(shape, dtype=torch.float32, device=dev)
    bcy_p = torch.zeros(shape, dtype=torch.float32, device=dev)
    inst = torch.arange(n, device=dev)
    counts = prep.count[:, None, None]
    for f in range(int(prep.count.max()) if n else 0):
        live = counts > f
        fid = prep.order[:, f].long()
        a = prep.attrs[inst, fid][:, :, None, None]          # (I, 32, 1, 1)
        k = prep.ctrl[inst, fid][:, :, None, None]           # (I, 8, 1, 1)
        dx = px - a[:, C_V3X]
        dy = py - a[:, C_V3Y]
        w0 = a[:, C_A0] * dx + a[:, C_B0] * dy
        w1 = a[:, C_A1] * dx + a[:, C_B1] * dy
        bcx = w0 * a[:, C_IA]
        bcy = w1 * a[:, C_IA]
        bcz = (1.0 - bcx) - bcy
        cov = ((bcx >= COVER_EPS) & (bcy >= COVER_EPS) & (bcz >= COVER_EPS)
               & (xi >= k[:, K_XLO]) & (xi < k[:, K_XHI])
               & (yi >= k[:, K_YLO]) & (yi < k[:, K_YHI]) & live)
        keyed = k[:, K_KEY] != 0
        if bool(keyed.any()):
            u = _interp3(bcx, bcy, bcz, a[:, C_U0], a[:, C_U1], a[:, C_U2])
            v = _interp3(bcx, bcy, bcz, a[:, C_VV0], a[:, C_VV1],
                         a[:, C_VV2])
            tid = torch.clamp(k[:, K_TID], min=0).expand(shape)
            texel = atlas.data[_texel_index(atlas, tid, u, v).long()]
            cov = cov & ~(keyed & ((texel & 0x7FFF) == 0))
        izi = (bcx * a[:, C_IZA] + bcy * a[:, C_IZB]) + bcz * a[:, C_IZC]
        better = cov & (izi > depth)
        depth = torch.where(better, izi, depth)
        winner = torch.where(better, fid.to(torch.int32)[:, None, None],
                             winner)
        bcx_p = torch.where(better, bcx, bcx_p)
        bcy_p = torch.where(better, bcy, bcy_p)
    return depth, winner, bcx_p, bcy_p


def resolve_ref(prep: BatchPrep, atlas: TextureAtlas, winner, bcx, bcy,
                shading: int, background: int):
    """Plain torch twin of the `raster_resolve` kernel: the packed RGBA8
    colour plane (I, H, W) for the winners of `visibility_ref`."""
    n, height, width = winner.shape
    dev = winner.device
    yi = torch.arange(height, device=dev, dtype=torch.int32)[None, :, None]
    xi = torch.arange(width, device=dev, dtype=torch.int32)[None, None, :]
    has = winner >= 0
    inst = torch.arange(n, device=dev)[:, None, None]
    a = prep.attrs[inst, torch.clamp(winner, min=0).long()]   # (I,H,W,32)
    a = a.permute(3, 0, 1, 2)
    bcz = (1.0 - bcx) - bcy
    u = _interp3(bcx, bcy, bcz, a[C_U0], a[C_U1], a[C_U2])
    v = _interp3(bcx, bcy, bcz, a[C_VV0], a[C_VV1], a[C_VV2])
    tid = a[C_TID].to(torch.int32)
    textured = tid >= 0
    texel = atlas.data[_texel_index(atlas, torch.clamp(tid, min=0),
                                    u, v).long()]
    flags = a[C_FLAGS].to(torch.int32)
    bt = (flags & FLAG_BT) != 0
    ndith = (flags & FLAG_DITHER) != 0

    c15 = torch.where(textured, texel, torch.full_like(texel, col.WHITE))
    is_black = (col.r5(c15) == 0) & (col.g5(c15) == 0) & (col.b5(c15) == 0)
    keyed_out = is_black & bt & textured
    c15 = torch.where((c15 == 0) & ~bt,
                      torch.full_like(c15, col.BLACK_DRAWABLE), c15)
    tex8 = [col.expand_5_to_8(ch(c15)) for ch in (col.r5, col.g5, col.b5)]

    vcs = [a[C_VCP0 + j].to(torch.int32) for j in range(3)]
    out5 = []
    offset = col.dither_offsets(xi, yi)
    for c in range(3):
        vcc = [((p >> (8 * c)) & 255).to(torch.float32) for p in vcs]
        v8 = _u8_trunc_sat(_interp3(bcx, bcy, bcz, *vcc))
        mod8 = torch.clamp((tex8[c] * v8) >> 7, max=255)
        if shading == ShadingMode.NONE:
            s = torch.ones_like(bcx)
        elif shading == ShadingMode.FLAT:
            s = a[C_SH + c]
        else:
            s = _interp3(bcx, bcy, bcz, a[C_SH + c], a[C_SH + 3 + c],
                         a[C_SH + 6 + c])
        shaded = _u8_trunc_sat(torch.clamp(
            mod8.to(torch.float32) * torch.clamp(s, 0.0, 2.0), max=255.0))
        out5.append(torch.where(ndith,
                                col.dither_and_quantize8(shaded, offset),
                                shaded >> 3))
    word = col.pack_rgba8(col.expand_5_to_8(out5[0]),
                          col.expand_5_to_8(out5[1]),
                          col.expand_5_to_8(out5[2]),
                          torch.full_like(out5[0], 255))
    drawn = has & ~keyed_out
    return torch.where(drawn, word, torch.full_like(word, background))


def rasterize_batch(prep: BatchPrep, atlas: TextureAtlas,
                    settings: RasterSettings, height: int, width: int,
                    background: int = 0):
    """Visibility then resolve for every instance: (color i32, depth f32),
    each (I, H, W).  CUDA tensors run the kernels of csrc/raster.cu; CPU
    tensors run the plain twins.  There is no other branch."""
    shading = int(settings.shading)
    if prep.attrs.is_cuda:
        from . import _cuda
        depth, winner, bcx, bcy = _cuda.raster_visibility(
            prep, atlas, height, width)
        color = _cuda.raster_resolve(prep, atlas, winner, bcx, bcy,
                                     shading, background)
        return color, depth
    if prep.attrs.device.type != "cpu":
        raise ValueError(f"unsupported device {prep.attrs.device}")
    depth, winner, bcx, bcy = visibility_ref(prep, atlas, height, width)
    color = resolve_ref(prep, atlas, winner, bcx, bcy, shading, background)
    return color, depth
