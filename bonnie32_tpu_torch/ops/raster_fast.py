"""The visibility-reduction rasterizer of the sequential renderer
(bonnie32_tpu/ops/raster_fast.py), batched over instances:

  1a. the clean opaque surfaces (no texel can key them out) in chunks of
      CHUNK: per pixel the chunk's lexicographic (1/z, -index) maximum,
      i.e. the first drawn of the nearest (argmax takes the first), merged
      into the running winner with the same order — the strict z-test in
      draw order, since opaque draw order in z-buffer mode is index order;
  1b. the keyable opaque surfaces one by one, each covered pixel testing
      its texel for the colour key first, with the same merge;
  2.  the winner's resolve: its attributes fetched per pixel (plain
      indexing, where the JAX package gathers through one-hot matrix
      products), through the pixel pipeline once;
  3.  the transparent surfaces back to front through the sequential
      compositor (raster_ref.raster_one, inverse z, no depth write).

Depth is inverse z throughout.  For perspective projection, the z-buffer
and no x-ray (render.render_mesh_15 routes the others to the sequential
compositor).  Passes 1b and 3 walk as many surfaces as the instance with
the most has; both counts are read once a call on the host.
"""

import torch

from ..config import RasterSettings
from ..types import FrameBuffers, Surfaces, TextureAtlas
from . import color as col
from . import pixel as px
from .raster_batch import _lexsort
from .raster_ref import edge_setup, one_surface, pixel_grid, raster_one

CHUNK = 16


def _corners(a):
    return tuple(a[..., k] for k in range(3))


def _merge(izi, idx, best_izi, best_idx):
    """Whether (izi, idx) beats the running winner: a nearer 1/z, or the
    same one from an earlier surface.  The background (best_idx -1) wins
    ties: the reference z-test is strict."""
    return (izi > best_izi) | ((izi == best_izi) & (best_idx >= 0)
                               & (idx < best_idx))


def rasterize_surfaces_fast(fb: FrameBuffers, surfaces: Surfaces,
                            atlas: TextureAtlas,
                            settings: RasterSettings) -> FrameBuffers:
    if not (settings.use_zbuffer and not settings.xray_mode
            and settings.ortho_projection is None):
        raise ValueError("the fast path needs perspective projection, the "
                         "z-buffer and no x-ray")
    n, height, width = fb.color.shape
    dev = fb.color.device
    grid = pixel_grid(height, width, dev)
    n_surf = surfaces.sx.shape[1]
    inst = torch.arange(n, device=dev)
    valid = surfaces.valid
    opaque = valid & ~surfaces.has_transparency
    transparent = valid & surfaces.has_transparency
    tid = surfaces.tex_id
    # keying removes coverage only where black_transparent is set and the
    # texture has a black texel (pixel.sample_keyed_bit)
    keyable = ((tid >= 0) & surfaces.black_transparent
               & atlas.has_black[torch.clamp(tid, min=0).long()]
               & surfaces.key_possible)
    clean_op = opaque & ~keyable
    key_op = opaque & keyable

    # ---- pass 1a: clean opaque surfaces, CHUNK at a time ----
    best_izi = fb.depth
    best_idx = torch.full((n, height, width), -1, dtype=torch.int32,
                          device=dev)
    for s in range(0, n_surf, CHUNK):
        sl = slice(s, s + CHUNK)

        def c(f):          # (I, K) -> (I, K, 1, 1), broadcast per pixel
            return f[:, sl, None, None]

        sx, sy, iz = surfaces.sx[:, sl], surfaces.sy[:, sl], \
            surfaces.inv_z[:, sl]
        vx = tuple(v[..., None, None] for v in _corners(sx))
        vy = tuple(v[..., None, None] for v in _corners(sy))
        bc_x, bc_y, bc_z, covered = edge_setup(
            vx, vy, c(surfaces.area), c(surfaces.inv_area),
            tuple(g[:, None] for g in grid), width, height)
        izs = tuple(v[..., None, None] for v in _corners(iz))
        izi = (bc_x * izs[0] + bc_y * izs[1]) + bc_z * izs[2]
        izi_k = torch.where(covered & c(clean_op), izi,
                            torch.full_like(izi, float("-inf")))
        # max over the chunk: the first maximal index, i.e. draw order
        local_izi, local_k = torch.max(izi_k, dim=1)
        local_idx = s + local_k.to(torch.int32)
        better = _merge(local_izi, local_idx, best_izi, best_idx)
        best_izi = torch.where(better, local_izi, best_izi)
        best_idx = torch.where(better, local_idx, best_idx)

    # the keyable opaque surfaces first, in index order; the transparent
    # ones back to front by centroid z, stable
    ko_order = _lexsort([(~key_op).to(torch.int8)])
    tr_order = _lexsort([(~transparent).to(torch.int8),
                         -surfaces.centroid_z])
    n_ko, n_tr = key_op.sum(1), transparent.sum(1)
    max_ko, max_tr = torch.stack([n_ko.max(), n_tr.max()]).tolist()

    # ---- pass 1b: keyable opaque surfaces, one at a time ----
    for i in range(max_ko):
        idx = ko_order[:, i]
        o = one_surface(surfaces, idx, live=i < n_ko)
        bc_x, bc_y, bc_z, covered = edge_setup(o.vx, o.vy, o.area,
                                               o.inv_area, grid, width,
                                               height)
        izi = (bc_x * o.iz[0] + bc_y * o.iz[1]) + bc_z * o.iz[2]
        u, v = px.uv_at(bc_x, bc_y, bc_z, o.uv, o.iz, izi, settings)
        keyed = px.sample_keyed_bit(atlas, o.tid, u, v, o.black_transparent)
        idx32 = idx.to(torch.int32)[:, None, None]
        better = covered & o.valid & ~keyed & _merge(izi, idx32, best_izi,
                                                     best_idx)
        best_izi = torch.where(better, izi, best_izi)
        best_idx = torch.where(better, idx32, best_idx)

    # ---- pass 2: the winners through the pixel pipeline ----
    has = best_idx >= 0
    win = torch.clamp(best_idx, min=0).long()

    def at(f):             # the winner's value of an (I, T, ...) field
        f = f.expand((n,) + tuple(f.shape)) if f.dim() == 1 else f
        return f[inst[:, None, None], win]

    vx, vy, iz = _corners(at(surfaces.sx)), _corners(at(surfaces.sy)), \
        _corners(at(surfaces.inv_z))
    uv3, vc3, sh3 = at(surfaces.uv), at(surfaces.vc), at(surfaces.shade)
    bc_x, bc_y, bc_z, _ = edge_setup(vx, vy, at(surfaces.area),
                                     at(surfaces.inv_area), grid, width,
                                     height)
    izi = (bc_x * iz[0] + bc_y * iz[1]) + bc_z * iz[2]
    pc = px.pixel_color(
        bc_x, bc_y, bc_z, izi, iz,
        tuple((uv3[..., k, 0], uv3[..., k, 1]) for k in range(3)),
        tuple(tuple(vc3[..., k, ch] for ch in range(3)) for k in range(3)),
        tuple(tuple(sh3[..., k, ch] for ch in range(3)) for k in range(3)),
        at(surfaces.tex_id), at(surfaces.black_transparent),
        at(surfaces.needs_dither), grid[2], grid[3], atlas, settings)
    word = col.pack_rgba8(pc.r8, pc.g8, pc.b8, torch.full_like(pc.r8, 255))
    color = torch.where(has & ~pc.keyed_out, word, fb.color)
    depth = best_izi       # passes 1a/1b merged with the incoming depth

    # ---- pass 3: transparent surfaces, back to front ----
    skip_z = torch.ones((n, 1, 1), dtype=torch.bool, device=dev)
    for i in range(max_tr):
        o = one_surface(surfaces, tr_order[:, i], live=i < n_tr)
        color, depth = raster_one(color, depth, o, skip_z, atlas, settings,
                                  grid, "inv")
    return FrameBuffers(color=color, depth=depth)
