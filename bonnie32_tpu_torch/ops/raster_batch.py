"""Batched rasterizer of the flat datagen frame
(bonnie32_tpu/ops/raster_batch.py, phases 1-3 of the Pallas kernel).

`prep_instance` culls, bounds and compacts every instance's faces;
`rasterize_batch` then runs

  * VISIBILITY (the TPU kernel's phase 1, clean and keyed faces): faces
    in compacted draw order, per pixel the edge functions, barycentrics,
    coverage `min(bc) >= -1e-4` inside the face's clipped bbox, the colour
    key test for keyable faces, and the strict `izi > depth` merge (first
    drawn wins ties) — or, in painter's mode, the last covering face wins
    (faces arrive sorted back to front per draw group) and the depth
    plane comes back cleared.  Output: depth, winner face id and the
    winner's (bcx, bcy) per pixel;
  * RESOLVE (phase 2): per pixel with a winner, the PS1 pixel pipeline —
    affine or perspective-correct UV, wrap, texel fetch, black/transparent
    key fixups, 5->8
    expand, vertex-colour modulate, shade, Bayer dither, RGB555 quantize,
    RGBA8 pack; where no face drew, the background: one word, a plane
    (the sky-buffer route) or the sky itself, evaluated per pixel (the
    TPU kernel's in-kernel sky, ops/skybox.py).

`composite` is phase 3: the ordered composite of a face list
(`prep_transparent`: the transparent faces back to front; `prep_xray`:
every face, for x-ray mode) onto the colour plane, with the PS1 blend
modes and the editor-alpha lerp, or x-ray's 50% blend.  It z-tests
against the opaque depth in z-buffer mode and never writes depth.

With `affine_textures` off, every phase takes the perspective-correct UV
(render.rs:1563-1579): u/z and v/z interpolated over the corners' 1/z and
divided by the pixel's interpolated 1/z, or by 1 where that is 0 — the
keyed coverage test at the face's own 1/z, resolve at the winner's (which
it recomputes from the winner's barycentrics and attribute row: bit for
bit the value the merge kept in the depth plane, so painter's mode, whose
depth plane comes back cleared, needs nothing handed over), the composite
at each entry's own.  The JAX kernel takes it in phases 1-2 only and hands
the transparent faces, and x-ray, to its sequential compositor, whose
division is exact too (ops/exactf.py); the port runs all of them in its
kernels.

For CUDA tensors every phase is a hand-written kernel of csrc/raster.cu
(ops/_cuda.py); for CPU tensors they are the plain torch twins below,
`visibility_ref`, `resolve_ref` and `composite_ref`, which evaluate the
same f32 expressions in the same order (no FMA contraction on either
side), so the two agree bit for bit.  The TPU layout machinery
(lane-group layout, SMEM segment plans, draw-ordered attr gathers) is not
ported: planes are (I, H, W) throughout.

The TPU kernel walks each face over the row blocks of its own bbox only.
The CUDA kernels get the same economy from the other side: the frame is
cut into TILE_H x TILE_W tiles, the `raster_bin` kernel marks once per
launch which entries of the ordered list (the kept faces, or the
composite's entries) touch which tile, and a tile's block of the
visibility or composite kernel stages and walks only those, in list order.
`tile_bins_ref` is that kernel's plain version; the twins of the consumers
need no bins (an entry whose bit is clear for a tile covers no pixel of
it, tests/test_torch_bins.py), so they walk every entry over the whole
frame.
"""

from typing import NamedTuple

import torch

from ..config import BlendMode, RasterSettings, ShadingMode
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

# tctrl (i32) and tfscal (f32) columns of the phase-3 tables
T_FID, T_TID, T_BLEND, T_EA, T_FLAGS, T_VALID = 0, 1, 2, 3, 4, 5
N_TCTRL = 8
N_TFS = 12                     # packed vertex colours x3 + shade x9

# composite modes: z-test against the opaque depth; no z-test (painter's);
# x-ray's 50% average in place of the blend modes, no z-test
COMPOSITE_ZBUFFER, COMPOSITE_PAINTERS, COMPOSITE_XRAY = 0, 1, 2

FLAG_DITHER = 1
FLAG_BT = 2
STP_BIT = 0x8000

COVER_EPS = -0.0001

# The tile of the frame one block of the CUDA kernels owns (rows, columns);
# ops/_cuda.py builds csrc/raster.cu for this shape
TILE_H, TILE_W = 16, 16


class BatchPrep(NamedTuple):
    """Per-instance prepass products, batched over instances."""

    count: torch.Tensor  # (I,) i32 number of kept (compacted) faces
    order: torch.Tensor  # (I, T) i32 kept face ids first, in draw order
    ctrl: torch.Tensor   # (I, T, N_CTRL) i32 bbox, tex id, keyable
    attrs: torch.Tensor  # (I, T, N_COLS) f32 edge/depth/UV/colour/shade


class FaceTables(NamedTuple):
    """A BatchPrep's per-face tables alone, in original face order: all
    the composite reads."""

    ctrl: torch.Tensor   # (I, T, N_CTRL) i32
    attrs: torch.Tensor  # (I, T, N_COLS) f32


def _lexsort(keys):
    """Indices (I, T) that sort each row by keys[0], then keys[1], ...
    (each (I, T)), ties kept in index order: successive stable sorts,
    least significant key first."""
    order = None
    for key in reversed(keys):
        k = key if order is None else key.gather(1, order)
        idx = torch.sort(k, dim=1, stable=True).indices
        order = idx if order is None else order.gather(1, idx)
    return order


def prep_instance(surfaces: Surfaces, atlas: TextureAtlas,
                  width: int, height: int, painters: bool = False,
                  group_id=None) -> BatchPrep:
    """Cull + bbox + compact every instance's surfaces (the JAX
    prep_instance, single-segment case).  Kept faces are opaque, valid,
    non-degenerate, with a finite non-empty clipped bbox.  In z-buffer
    mode they compact in original (= draw) order; in painter's mode in the
    reference's SORT order (render.rs:2525-2542): per draw group
    (`group_id`, (T,) i32), back to front by centroid z, stable, unkept
    faces keyed +inf."""
    keep, ctrl, attrs = _cull_and_tables(surfaces, atlas, width, height)
    n, t = keep.shape
    unkept = (~keep).to(torch.int8)
    if painters:
        gid = (torch.zeros(t, dtype=torch.int32, device=keep.device)
               if group_id is None else group_id.to(torch.int32))
        cz = surfaces.centroid_z
        zkey = torch.where(keep & ~torch.isnan(cz), -cz,
                           torch.full_like(cz, float("inf")))
        order = _lexsort([unkept, gid.expand(n, t), zkey])
    else:
        order = torch.sort(unkept, dim=1, stable=True).indices
    count = keep.sum(dim=1, dtype=torch.int32)
    return BatchPrep(count=count, order=order.to(torch.int32).contiguous(),
                     ctrl=ctrl, attrs=attrs)


def face_tables(surfaces: Surfaces, atlas: TextureAtlas,
                width: int, height: int) -> FaceTables:
    """prep_instance's ctrl/attrs tables without the cull's compaction
    (x-ray mode composites every face and needs no draw order)."""
    _, ctrl, attrs = _cull_and_tables(surfaces, atlas, width, height)
    return FaceTables(ctrl=ctrl, attrs=attrs)


def _cull_and_tables(surfaces, atlas, width, height):
    """(keep (I, T) bool, ctrl, attrs) of prep_instance."""
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
    return keep, ctrl.contiguous(), attrs.contiguous()


def _interp3(bcx, bcy, bcz, a0, a1, a2):
    return (bcx * a0 + bcy * a1) + bcz * a2


def _face_uv(bcx, bcy, bcz, col, izi=None):
    """(u, v) at the pixel of the face whose attrs column c is `col(c)`:
    affine without `izi`; else perspective-correct (render.rs:1563-1579)
    over the pixel's interpolated 1/z `izi`: ((bcx u0) iz0 + (bcy u1) iz1)
    + (bcz u2) iz2, divided by izi, or by 1 where izi is 0 (a tensor
    division: IEEE on the CPU and the card)."""
    if izi is None:
        return (_interp3(bcx, bcy, bcz, col(C_U0), col(C_U1), col(C_U2)),
                _interp3(bcx, bcy, bcz, col(C_VV0), col(C_VV1), col(C_VV2)))
    za, zb, zc = col(C_IZA), col(C_IZB), col(C_IZC)
    safe = torch.where(izi == 0, torch.ones_like(izi), izi)
    return tuple(
        (((bcx * col(t0)) * za + (bcy * col(t1)) * zb) + (bcz * col(t2)) * zc)
        / safe for t0, t1, t2 in ((C_U0, C_U1, C_U2), (C_VV0, C_VV1, C_VV2)))


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


def tile_grid(height: int, width: int):
    """(tiles_y, tiles_x) of a frame; the last row and column may be
    ragged."""
    return -(-height // TILE_H), -(-width // TILE_W)


def bin_list(order=None, count=None, tctrl=None):
    """The ordered list a kernel walks, as (fids (I, L) i64, live (I, L)
    bool): the visibility kernel's (position p of `order`, live where
    p < count[i]) or the composite's (entry e of `tctrl`, live where its
    valid flag and its editor alpha are not 0)."""
    if ((order is None) == (tctrl is None)
            or (order is None) != (count is None)):
        raise ValueError("give order and count, or tctrl")
    if tctrl is not None:
        return (tctrl[..., T_FID].long(),
                (tctrl[..., T_VALID] != 0) & (tctrl[..., T_EA] != 0))
    pos = torch.arange(order.shape[1], device=order.device)
    return order.long(), pos[None] < count[:, None]


def tile_bins_ref(ctrl, height: int, width: int, order=None, count=None,
                  tctrl=None):
    """Plain torch twin of the `raster_bin` kernel (the TPU kernel clips
    each face's bbox to the row blocks it reaches; here the frame is cut
    into TILE_H x TILE_W tiles and the test is made once per entry and
    tile).  For the list of `bin_list`, with each entry's clipped half-open
    bbox from its face's row of `ctrl` (I, T, N_CTRL): bins (I, tiles_y,
    tiles_x, ceil(L / 32)) i32, bit b of word w set where list position
    32 w + b is live and its bbox holds a pixel of the frame inside the
    tile.  Bit order is list order, i.e. draw order."""
    fids, live = bin_list(order, count, tctrl)
    dev = ctrl.device
    box = ctrl.gather(1, fids[..., None].expand(-1, -1, N_CTRL))
    tiles_y, tiles_x = tile_grid(height, width)
    y0 = torch.arange(tiles_y, device=dev, dtype=torch.int32) * TILE_H
    x0 = torch.arange(tiles_x, device=dev, dtype=torch.int32) * TILE_W
    y1 = torch.clamp(y0 + TILE_H, max=height)
    x1 = torch.clamp(x0 + TILE_W, max=width)

    def reaches(lo, hi, t0, t1):          # (I, tiles, L)
        return (torch.minimum(hi[:, None], t1[None, :, None])
                > torch.maximum(lo[:, None], t0[None, :, None]))

    hit = (reaches(box[..., K_YLO], box[..., K_YHI], y0, y1)[:, :, None]
           & reaches(box[..., K_XLO], box[..., K_XHI], x0, x1)[:, None]
           & live[:, None, None])         # (I, tiles_y, tiles_x, L)
    return mask_words(hit)


def mask_words(hit):
    """(..., L) bool -> (..., ceil(L / 32)) i32: bit b of word w is entry
    32 w + b, the kernels' mask words."""
    length = hit.shape[-1]
    n_words = (length + 31) // 32
    hit = torch.nn.functional.pad(hit, (0, 32 * n_words - length))
    bit = torch.ones((), dtype=torch.int64, device=hit.device) << torch.arange(
        32, device=hit.device)
    words = (hit.reshape(*hit.shape[:-1], n_words, 32) * bit).sum(-1)
    # bit 31 is the sign of the i32 word
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(
        torch.int32)


def work_list_ref(bins):
    """The flat (instance, tile) indices with any bit set, ascending: as a
    set, the work list `raster_bin` appends for the composite."""
    return torch.nonzero((bins != 0).any(-1).reshape(-1))[:, 0].to(
        torch.int32)


def visibility_ref(prep: BatchPrep, atlas: TextureAtlas,
                   height: int, width: int, painters: bool = False,
                   perspective: bool = False):
    """Plain torch twin of the `raster_visibility` kernel.  Returns
    (depth f32, winner i32 original face id or -1, bcx f32, bcy f32), each
    (I, H, W).  `painters`: the last covering face wins and the depth
    plane is returned cleared (painter's never writes depth).
    `perspective`: keyed faces test their texel at the perspective-correct
    UV."""
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
        izi = (bcx * a[:, C_IZA] + bcy * a[:, C_IZB]) + bcz * a[:, C_IZC]
        keyed = k[:, K_KEY] != 0
        if bool(keyed.any()):
            u, v = _face_uv(bcx, bcy, bcz, lambda c: a[:, c],
                            izi if perspective else None)
            tid = torch.clamp(k[:, K_TID], min=0).expand(shape)
            texel = atlas.data[_texel_index(atlas, tid, u, v).long()]
            cov = cov & ~(keyed & ((texel & 0x7FFF) == 0))
        better = cov if painters else cov & (izi > depth)
        depth = torch.where(better, izi, depth)
        winner = torch.where(better, fid.to(torch.int32)[:, None, None],
                             winner)
        bcx_p = torch.where(better, bcx, bcx_p)
        bcy_p = torch.where(better, bcy, bcy_p)
    if painters:
        depth = torch.zeros_like(depth)
    return depth, winner, bcx_p, bcy_p


def background_ref(background, n: int, height: int, width: int, device):
    """The background of `resolve_ref` as an (I, H, W) i32 plane (or a
    tensor that broadcasts to it): `background` is one word, a plane, or
    an ops.skybox.SkyBackground, whose sky the plain twin renders
    whole."""
    if isinstance(background, torch.Tensor):
        if background.shape != (n, height, width):
            raise ValueError(f"background plane {tuple(background.shape)}, "
                             f"expected {(n, height, width)}")
        return background
    if isinstance(background, tuple):
        from . import skybox as sky_ops
        return sky_ops.sky_plane_ref(background.sky, background.scal,
                                     height, width)
    return torch.tensor(int(background), dtype=torch.int32, device=device)


def resolve_ref(prep: BatchPrep, atlas: TextureAtlas, winner, bcx, bcy,
                shading: int, background=0, perspective: bool = False):
    """Plain torch twin of the `raster_resolve` kernel: the packed RGBA8
    colour plane (I, H, W) for the winners of `visibility_ref`, over
    `background` (one word, a plane, or a SkyBackground).  `perspective`:
    perspective-correct UVs over the winner's 1/z at the pixel, computed
    as the merge computed it."""
    n, height, width = winner.shape
    dev = winner.device
    yi = torch.arange(height, device=dev, dtype=torch.int32)[None, :, None]
    xi = torch.arange(width, device=dev, dtype=torch.int32)[None, None, :]
    has = winner >= 0
    inst = torch.arange(n, device=dev)[:, None, None]
    a = prep.attrs[inst, torch.clamp(winner, min=0).long()]   # (I,H,W,32)
    a = a.permute(3, 0, 1, 2)
    bcz = (1.0 - bcx) - bcy
    izi = ((bcx * a[C_IZA] + bcy * a[C_IZB]) + bcz * a[C_IZC]
           if perspective else None)
    u, v = _face_uv(bcx, bcy, bcz, lambda c: a[c], izi)
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
    return torch.where(drawn, word,
                       background_ref(background, n, height, width, dev))


def rasterize_batch(prep: BatchPrep, atlas: TextureAtlas,
                    settings: RasterSettings, height: int, width: int,
                    background=0):
    """Visibility then resolve for every instance: (color i32, depth f32),
    each (I, H, W), over `background`: one word, an (I, H, W) i32 plane,
    or an ops.skybox.SkyBackground (the in-kernel sky).  CUDA tensors run
    the kernels of csrc/raster.cu; CPU tensors run the plain twins.
    There is no other branch."""
    shading = int(settings.shading)
    painters = not settings.use_zbuffer
    persp = not settings.affine_textures
    if prep.attrs.is_cuda:
        from . import _cuda
        depth, winner, bcx, bcy = _cuda.raster_visibility(
            prep, atlas, height, width, painters=painters, perspective=persp)
        color = _cuda.raster_resolve(prep, atlas, winner, bcx, bcy,
                                     shading, background, perspective=persp)
        return color, depth
    if prep.attrs.device.type != "cpu":
        raise ValueError(f"unsupported device {prep.attrs.device}")
    depth, winner, bcx, bcy = visibility_ref(prep, atlas, height, width,
                                             painters=painters,
                                             perspective=persp)
    color = resolve_ref(prep, atlas, winner, bcx, bcy, shading, background,
                        perspective=persp)
    return color, depth


# ---------------------------------------------------------------------------
# Phase 3: the ordered composite (transparent faces; every face in x-ray)
# ---------------------------------------------------------------------------

class TransPrep(NamedTuple):
    """Per-instance tables of the composite, already in composite order,
    so the kernel walks entries 0..NT-1.  Edge, bbox and UV scalars are
    not duplicated: the composite reads them from the prep's ctrl/attrs
    tables at row `fid` (original face order, every face addressable)."""

    tctrl: torch.Tensor   # (I, NT, N_TCTRL) i32: fid, tid, blend, ea,
    #                       flags, valid (T_* columns)
    tfscal: torch.Tensor  # (I, NT, N_TFS) f32: packed vertex colours x3
    #                       + corner-major shade x9


def _face_subset(surfaces: Surfaces, idx) -> Surfaces:
    """The faces `idx` of every instance.  Fields shared by the instances
    are (T,); the others (I, T, ...)."""
    return Surfaces(*(v[idx] if v.dim() == 1 else v[:, idx]
                      for v in surfaces))


def _composite_tables(sub: Surfaces, fids, order) -> TransPrep:
    """Composite tables for a face subset: `fids` (NT,) are original face
    ids (rows of the prep tables), `order` (I, NT) the composite
    sequence.  Validity folds in what the sequential compositor checks
    per pixel (valid, not degenerate) plus NaN-bbox protection."""
    n, nt = sub.sx.shape[:2]
    degenerate = sub.area.abs() < 0.00001
    sx, sy = sub.sx, sub.sy
    mins = torch.minimum(torch.minimum(sx[..., 0], sx[..., 1]), sx[..., 2])
    maxs = torch.maximum(torch.maximum(sx[..., 0], sx[..., 1]), sx[..., 2])
    miny = torch.minimum(torch.minimum(sy[..., 0], sy[..., 1]), sy[..., 2])
    maxy = torch.maximum(torch.maximum(sy[..., 0], sy[..., 1]), sy[..., 2])
    nan_box = (torch.isnan(mins) | torch.isnan(maxs) | torch.isnan(miny)
               | torch.isnan(maxy))
    valid = sub.valid & ~degenerate & ~nan_box
    flags = (torch.where(sub.needs_dither, FLAG_DITHER, 0)
             | torch.where(sub.black_transparent, FLAG_BT, 0))
    zero = torch.zeros((n, nt), dtype=torch.int32, device=sx.device)
    tctrl = torch.stack([
        fids.to(torch.int32).expand(n, nt), sub.tex_id.expand(n, nt),
        sub.blend_mode.expand(n, nt), sub.editor_alpha.expand(n, nt),
        flags.to(torch.int32).expand(n, nt), valid.to(torch.int32),
        zero, zero], dim=-1)
    vc = sub.vc
    vcp = (vc[..., 0] + (vc[..., 1] << 8) + (vc[..., 2] << 16)).to(
        torch.float32)                                   # (I, NT, 3)
    tfscal = torch.cat([vcp, sub.shade.reshape(n, nt, 9)], dim=-1)
    o = order.long()[..., None]
    return TransPrep(
        tctrl=tctrl.gather(1, o.expand(-1, -1, N_TCTRL)).contiguous(),
        tfscal=tfscal.gather(1, o.expand(-1, -1, N_TFS)).contiguous())


def prep_transparent(surfaces: Surfaces, idx_tuple) -> TransPrep:
    """Composite tables of the level's static transparent-face list
    (FlatSceneStatic.transparent_idx), back to front by centroid z,
    stable in list order (the sequential compositor's order,
    render.rs:2525-2542)."""
    idx = torch.tensor(idx_tuple, dtype=torch.long,
                       device=surfaces.sx.device)
    sub = _face_subset(surfaces, idx)
    order = torch.sort(-sub.centroid_z, dim=1, stable=True).indices
    return _composite_tables(sub, idx, order)


def prep_xray(surfaces: Surfaces, group_id=None,
              use_zbuffer: bool = True) -> TransPrep:
    """All-face composite tables for x-ray mode (render.rs:507-526): per
    draw group, the opaque faces in index order (back to front in
    painter's mode), then the transparent faces back to front, then the
    invalid ones (surface.draw_order / render.rs:2518-2545)."""
    n, t = surfaces.sx.shape[:2]
    dev = surfaces.sx.device
    tr = surfaces.valid & surfaces.has_transparency
    op = surfaces.valid & ~surfaces.has_transparency
    rank = torch.where(op, 0, torch.where(tr, 1, 2)).to(torch.int32)
    neg_z = -surfaces.centroid_z
    within = (torch.where(tr, neg_z, torch.zeros_like(neg_z))
              if use_zbuffer else neg_z)
    gid = (torch.zeros(t, dtype=torch.int32, device=dev) if group_id is None
           else group_id.to(torch.int32)).expand(n, t)
    order = _lexsort([gid, rank, within])
    return _composite_tables(surfaces, torch.arange(t, device=dev), order)


# blend_rgb555 of one channel (ops/color.py)
_blend5 = col.blend5


def composite_mode(settings: RasterSettings) -> int:
    """The COMPOSITE_* mode of `settings`."""
    if settings.xray_mode:
        return COMPOSITE_XRAY
    return COMPOSITE_ZBUFFER if settings.use_zbuffer else COMPOSITE_PAINTERS


def composite_ref(color, depth, tr: TransPrep, prep, atlas: TextureAtlas,
                  shading: int, mode: int, perspective: bool = False):
    """Plain torch twin of the `raster_composite` kernel: the composite
    entries of `tr` in order, each onto the colour plane (I, H, W) i32 of
    the phase before, reading face rows from `prep` (a BatchPrep or
    FaceTables).  COMPOSITE_ZBUFFER z-tests `izi > depth` against the
    opaque depth (never written); COMPOSITE_XRAY takes the 50% average in
    place of the blend modes and editor alpha; `perspective`: perspective-
    correct UVs over each entry's own 1/z.  Returns the new colour
    plane."""
    if mode not in (COMPOSITE_ZBUFFER, COMPOSITE_PAINTERS, COMPOSITE_XRAY):
        raise ValueError(f"unknown composite mode {mode}")
    zactive, xray = mode == COMPOSITE_ZBUFFER, mode == COMPOSITE_XRAY
    n, height, width = color.shape
    dev = color.device
    yi = torch.arange(height, device=dev, dtype=torch.int32)[None, :, None]
    xi = torch.arange(width, device=dev, dtype=torch.int32)[None, None, :]
    px = xi.to(torch.float32)
    py = yi.to(torch.float32)
    offset = col.dither_offsets(xi, yi)
    inst = torch.arange(n, device=dev)
    # the editor-alpha // 255 is trunc(x * f32(1/255)), as in the kernels
    inv255 = torch.tensor(1.0 / 255.0, dtype=torch.float32, device=dev)
    for f in range(tr.tctrl.shape[1]):
        tc = tr.tctrl[:, f][:, :, None, None]                # (I, 8, 1, 1)
        live = (tc[:, T_VALID] != 0) & (tc[:, T_EA] != 0)
        if not bool(live.any()):
            continue
        fid = tr.tctrl[:, f, T_FID].long()
        a = prep.attrs[inst, fid][:, :, None, None]          # (I, 32, 1, 1)
        k = prep.ctrl[inst, fid][:, :, None, None]           # (I, 8, 1, 1)
        fs = tr.tfscal[:, f][:, :, None, None]               # (I, 12, 1, 1)
        tid, blend, ea = tc[:, T_TID], tc[:, T_BLEND], tc[:, T_EA]
        bt = (tc[:, T_FLAGS] & FLAG_BT) != 0
        ndith = (tc[:, T_FLAGS] & FLAG_DITHER) != 0
        dx = px - a[:, C_V3X]
        dy = py - a[:, C_V3Y]
        w0 = a[:, C_A0] * dx + a[:, C_B0] * dy
        w1 = a[:, C_A1] * dx + a[:, C_B1] * dy
        bcx = w0 * a[:, C_IA]
        bcy = w1 * a[:, C_IA]
        bcz = (1.0 - bcx) - bcy
        vis = ((bcx >= COVER_EPS) & (bcy >= COVER_EPS) & (bcz >= COVER_EPS)
               & (xi >= k[:, K_XLO]) & (xi < k[:, K_XHI])
               & (yi >= k[:, K_YLO]) & (yi < k[:, K_YHI]) & live)
        izi = (bcx * a[:, C_IZA] + bcy * a[:, C_IZB]) + bcz * a[:, C_IZC]
        if zactive:
            vis = vis & (izi > depth)
        u, v = _face_uv(bcx, bcy, bcz, lambda c: a[:, c],
                        izi if perspective else None)
        textured = tid >= 0
        texel = atlas.data[_texel_index(
            atlas, torch.clamp(tid, min=0).expand(n, height, width),
            u, v).long()]
        c15 = torch.where(textured, texel, torch.full_like(texel, col.WHITE))
        is_black = (col.r5(c15) == 0) & (col.g5(c15) == 0) & (col.b5(c15) == 0)
        keyed_out = is_black & bt & textured
        c15 = torch.where((c15 == 0) & ~bt,
                          torch.full_like(c15, col.BLACK_DRAWABLE), c15)
        tex8 = [col.expand_5_to_8(ch(c15)) for ch in (col.r5, col.g5, col.b5)]
        vcs = [fs[:, j].to(torch.int32) for j in range(3)]
        q5 = []
        for c in range(3):
            vcc = [((p >> (8 * c)) & 255).to(torch.float32) for p in vcs]
            v8 = _u8_trunc_sat(_interp3(bcx, bcy, bcz, *vcc))
            mod8 = torch.clamp((tex8[c] * v8) >> 7, max=255)
            if shading == ShadingMode.NONE:
                s = torch.ones_like(bcx)
            elif shading == ShadingMode.FLAT:
                s = fs[:, 3 + c]
            else:
                s = _interp3(bcx, bcy, bcz, fs[:, 3 + c], fs[:, 6 + c],
                             fs[:, 9 + c])
            shaded = _u8_trunc_sat(torch.clamp(
                mod8.to(torch.float32) * torch.clamp(s, 0.0, 2.0),
                max=255.0))
            q5.append(torch.where(ndith,
                                  col.dither_and_quantize8(shaded, offset),
                                  shaded >> 3))
        front = [col.expand_5_to_8(q) for q in q5]
        all_black = (q5[0] == 0) & (q5[1] == 0) & (q5[2] == 0)
        semi = ((c15 & STP_BIT) != 0) | all_black
        back = [(color >> (8 * c)) & 255 for c in range(3)]
        if xray:
            out = [(fr + bk) >> 1 for fr, bk in zip(front, back)]
        else:
            do_blend = semi & (blend != int(BlendMode.OPAQUE))
            ps1 = [torch.where(do_blend, _blend5(blend, fr, bk), fr)
                   for fr, bk in zip(front, back)]
            use_ea = ea < 255
            out = [torch.where(
                use_ea, torch.trunc((p * ea + bk * (255 - ea)).to(
                    torch.float32) * inv255).to(torch.int32), p)
                for p, bk in zip(ps1, back)]
        word = col.pack_rgba8(out[0], out[1], out[2],
                              torch.full_like(out[0], 255))
        color = torch.where(vis & ~keyed_out, word, color)
    return color


def composite(color, depth, tr: TransPrep, prep, atlas: TextureAtlas,
              settings: RasterSettings):
    """Phase 3 for every instance: the entries of `tr` composited onto
    `color` in order; z-tested against `depth` in z-buffer mode (never in
    x-ray or painter's mode).  CUDA tensors run the `raster_composite`
    kernel, which updates `color` in place; CPU tensors run the plain
    twin.  Returns the colour plane."""
    shading, mode = int(settings.shading), composite_mode(settings)
    persp = not settings.affine_textures
    if color.is_cuda:
        from . import _cuda
        return _cuda.raster_composite(color, depth, tr, prep, atlas,
                                      shading, mode, perspective=persp)
    if color.device.type != "cpu":
        raise ValueError(f"unsupported device {color.device}")
    return composite_ref(color, depth, tr, prep, atlas, shading, mode,
                         perspective=persp)
