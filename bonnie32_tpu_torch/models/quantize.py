"""PNG color quantization for PS1-style indexed textures.
(The port's own copy of the JAX package's `models/quantize.py`, host
code.)

Median-cut palette reduction with three split strategies, optional LAB
(perceptually uniform) color space, perceptual green weighting, saturation
bias, pre-quantization denoise, and minimum-bucket merging.  Produces an
indexed texture (palette indices, index 0 = transparent) plus a Clut.

Host-side asset-pipeline tool, vectorized with numpy (this runs at
import/edit time, not in the TPU frame loop, so numpy — not jax — is the
idiomatic choice).

Reference behavior: `/root/reference/src/modeler/quantize.rs` (median cut
846 lines; quantize_image_with_options at :296, LAB at :85, bucket split
selection at :473, merge at :512, matching at :671).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from .mesh import Clut, IndexedAtlas, depth_colors

WHITE15 = 0x7FFF
TRANSPARENT15 = 0x0000

MODE_STANDARD = "standard"            # split by (saturation-weighted) population
MODE_PRESERVE_DETAIL = "preserve_detail"  # split by unique color count
MODE_SMOOTH = "smooth"                # split by color-range volume


@dataclasses.dataclass(frozen=True)
class QuantizeOptions:
    """quantize.rs:31 — advanced quantization knobs."""

    mode: str = MODE_STANDARD
    use_lab: bool = False
    pre_quantize: int = 0           # >0: reduce to 4 bits/channel first
    perceptual_weight: float = 0.0  # extra green weight (0..1)
    saturation_bias: float = 0.0    # prioritize saturated buckets (0..1)
    min_bucket_fraction: float = 0.0  # merge buckets below this pixel share


@dataclasses.dataclass
class QuantizeResult:
    texture: IndexedAtlas
    clut: Clut


# ---------------------------------------------------------------------------
# Color15 helpers (vectorized)
# ---------------------------------------------------------------------------

def _pack15(r5, g5, b5):
    r5 = np.minimum(r5, 31).astype(np.uint16)
    g5 = np.minimum(g5, 31).astype(np.uint16)
    b5 = np.minimum(b5, 31).astype(np.uint16)
    return (r5 << 10) | (g5 << 5) | b5


def _r5(c):
    return (c >> 10) & 0x1F


def _g5(c):
    return (c >> 5) & 0x1F


def _b5(c):
    return c & 0x1F


# ---------------------------------------------------------------------------
# LAB color space (quantize.rs:85-200)
# ---------------------------------------------------------------------------

_REF_WHITE = np.array([0.95047, 1.0, 1.08883], np.float32)
_RGB2XYZ = np.array([[0.4124564, 0.3575761, 0.1804375],
                     [0.2126729, 0.7151522, 0.0721750],
                     [0.0193339, 0.1191920, 0.9503041]], np.float32)
_XYZ2RGB = np.array([[3.2404542, -1.5371385, -0.4985314],
                     [-0.9692660, 1.8760108, 0.0415560],
                     [0.0556434, -0.2040259, 1.0572252]], np.float32)
_DELTA = np.float32(6.0 / 29.0)


def _srgb_to_linear(v):
    v = v.astype(np.float32)
    return np.where(v <= 0.04045, v / np.float32(12.92),
                    ((v + np.float32(0.055)) / np.float32(1.055)) ** np.float32(2.4))


def _linear_to_srgb(v):
    v = v.astype(np.float32)
    return np.where(v <= 0.0031308, v * np.float32(12.92),
                    np.float32(1.055) * np.maximum(v, 0) ** np.float32(1 / 2.4)
                    - np.float32(0.055))


def _lab_f(t):
    return np.where(t > _DELTA ** 3, np.cbrt(t).astype(np.float32),
                    t / (3 * _DELTA * _DELTA) + np.float32(4.0 / 29.0))


def _lab_f_inv(t):
    return np.where(t > _DELTA, t * t * t,
                    3 * _DELTA * _DELTA * (t - np.float32(4.0 / 29.0)))


def rgb888_to_lab(rgb):
    """(N,3) uint8 -> (N,3) float32 L/a/b.  quantize.rs:85."""
    lin = _srgb_to_linear(np.asarray(rgb, np.float32) / np.float32(255.0))
    xyz = lin @ _RGB2XYZ.T
    f = _lab_f((xyz / _REF_WHITE).astype(np.float32))
    l = 116.0 * f[..., 1] - 16.0
    a = 500.0 * (f[..., 0] - f[..., 1])
    b = 200.0 * (f[..., 1] - f[..., 2])
    return np.stack([l, a, b], axis=-1).astype(np.float32)


def lab_to_rgb888(lab):
    """(N,3) float32 -> (N,3) uint8.  quantize.rs:122."""
    lab = np.asarray(lab, np.float32)
    fy = (lab[..., 0] + 16.0) / 116.0
    fx = lab[..., 1] / 500.0 + fy
    fz = fy - lab[..., 2] / 200.0
    xyz = np.stack([_lab_f_inv(np.float32(fx)), _lab_f_inv(np.float32(fy)),
                    _lab_f_inv(np.float32(fz))], axis=-1) * _REF_WHITE
    lin = xyz.astype(np.float32) @ _XYZ2RGB.T
    srgb = np.clip(_linear_to_srgb(lin) * 255.0, 0.0, 255.0)
    return srgb.astype(np.uint8)


def color15_to_lab(c15):
    """5->8 expansion uses v*255/31 (quantize.rs:115, not the (v<<3)|(v>>2)
    renderer expansion)."""
    c15 = np.asarray(c15, np.uint16)
    r = (_r5(c15).astype(np.uint32) * 255 // 31).astype(np.uint8)
    g = (_g5(c15).astype(np.uint32) * 255 // 31).astype(np.uint8)
    b = (_b5(c15).astype(np.uint32) * 255 // 31).astype(np.uint8)
    return rgb888_to_lab(np.stack([r, g, b], axis=-1))


# ---------------------------------------------------------------------------
# Median cut
# ---------------------------------------------------------------------------

def _qcolor_arrays(colors15: np.ndarray, opts: QuantizeOptions):
    """Internal (c0,c1,c2) feature space + saturation.  quantize.rs:220-260."""
    r = _r5(colors15).astype(np.float32)
    g = _g5(colors15).astype(np.float32)
    b = _b5(colors15).astype(np.float32)
    mx = np.maximum(np.maximum(r, g), b)
    mn = np.minimum(np.minimum(r, g), b)
    sat = np.where(mx > 0.0, (mx - mn) / np.where(mx > 0, mx, 1.0), 0.0)
    if opts.use_lab:
        feat = color15_to_lab(colors15)
    else:
        gw = g * np.float32(1.0 + opts.perceptual_weight * 0.5)
        feat = np.stack([r, gw, b], axis=-1)
    return feat.astype(np.float32), sat.astype(np.float32)


def _ranges(feat):
    return feat.max(axis=0) - feat.min(axis=0)


def _volume(feat):
    r = _ranges(feat)
    return float(r[0]) * float(r[1]) * float(r[2])


def _bucket_score(idx, feat, orig, sat, opts: QuantizeOptions):
    if opts.mode == MODE_PRESERVE_DETAIL:
        return len(np.unique(orig[idx]))
    if opts.mode == MODE_SMOOTH:
        return _volume(feat[idx])
    # Standard: saturation-weighted population (quantize.rs:590)
    return float(np.sum(1.0 + sat[idx] * np.float32(opts.saturation_bias)))


def _find_split(buckets, feat, orig, sat, opts, min_bucket_size):
    """quantize.rs:473 — candidates need >1 member, > min size, volume > 0.
    Rust max_by returns the LAST maximal element on ties."""
    best, best_score = None, None
    for i, idx in enumerate(buckets):
        if len(idx) <= 1 or len(idx) <= min_bucket_size:
            continue
        if _volume(feat[idx]) <= 0.0:
            continue
        score = _bucket_score(idx, feat, orig, sat, opts)
        if best_score is None or score >= best_score:
            best, best_score = i, score
    return best


def _merge_small(buckets, feat, sat, min_size):
    """quantize.rs:512 — repeatedly fold the smallest under-threshold bucket
    into the bucket with the nearest feature-space center (first-min ties)."""
    buckets = list(buckets)
    while len(buckets) > 1:
        small_i, small_n = None, None
        for i, idx in enumerate(buckets):
            if len(idx) < min_size and (small_n is None or len(idx) < small_n):
                small_i, small_n = i, len(idx)
        if small_i is None:
            break
        small = buckets.pop(small_i)
        centers = np.stack([feat[idx].mean(axis=0) for idx in buckets])
        d = ((centers - feat[small].mean(axis=0)) ** 2).sum(axis=1)
        near = int(np.argmin(d))
        buckets[near] = np.concatenate([buckets[near], small])
    return buckets


def _average_color(idx, feat, orig, opts: QuantizeOptions) -> int:
    """quantize.rs:637 — LAB: average in LAB then convert; RGB: integer-mean
    the original 5-bit channels (floor division)."""
    if opts.use_lab:
        rgb = lab_to_rgb888(feat[idx].mean(axis=0, dtype=np.float32)[None, :])[0]
        return int(_pack15(rgb[0] >> 3, rgb[1] >> 3, rgb[2] >> 3))
    n = np.uint32(len(idx))
    r = int(np.sum(_r5(orig[idx]).astype(np.uint32)) // n)
    g = int(np.sum(_g5(orig[idx]).astype(np.uint32)) // n)
    b = int(np.sum(_b5(orig[idx]).astype(np.uint32)) // n)
    return int(_pack15(np.uint16(r), np.uint16(g), np.uint16(b)))


def median_cut(colors15: np.ndarray, max_colors: int, total_pixels: int,
               opts: Optional[QuantizeOptions] = None) -> List[int]:
    """quantize.rs:386 — median cut over Color15 samples -> palette list."""
    opts = opts or QuantizeOptions()
    colors15 = np.asarray(colors15, np.uint16)
    if colors15.size == 0:
        return [WHITE15]
    uniq = np.unique(colors15)
    if len(uniq) <= max_colors:
        return [int(c) for c in uniq]

    feat, sat = _qcolor_arrays(colors15, opts)
    buckets = [np.arange(len(colors15))]
    min_bucket_size = int(total_pixels * opts.min_bucket_fraction)

    while len(buckets) < max_colors:
        si = _find_split(buckets, feat, colors15, sat, opts, min_bucket_size)
        if si is None:
            break
        idx = buckets.pop(si)
        f = feat[idx]
        rng = _ranges(f)
        if rng[0] >= rng[1] and rng[0] >= rng[2]:
            axis = 0
        elif rng[1] >= rng[2]:
            axis = 1
        else:
            axis = 2
        order = np.argsort(f[:, axis], kind="stable")
        mid = len(order) // 2
        buckets.append(idx[order[:mid]])
        buckets.append(idx[order[mid:]])

    if min_bucket_size > 0 and len(buckets) > 1:
        buckets = _merge_small(buckets, feat, sat, min_bucket_size)

    return [_average_color(idx, feat, colors15, opts) for idx in buckets]


# ---------------------------------------------------------------------------
# Palette matching (quantize.rs:671-725)
# ---------------------------------------------------------------------------

def nearest_in_palette(colors15: np.ndarray, palette: List[int],
                       perceptual_weight: float = 0.0) -> np.ndarray:
    """Nearest palette index per color, RGB555 space, green optionally
    over-weighted.  First index wins ties (strict-< update rule)."""
    pal = np.asarray(palette, np.uint16)
    if pal.size == 0:
        return np.zeros(len(colors15), np.int64)
    c = np.asarray(colors15, np.uint16)
    gw = np.float32(1.0 + perceptual_weight)
    dr = _r5(c)[:, None].astype(np.float32) - _r5(pal)[None, :].astype(np.float32)
    dg = _g5(c)[:, None].astype(np.float32) - _g5(pal)[None, :].astype(np.float32)
    db = _b5(c)[:, None].astype(np.float32) - _b5(pal)[None, :].astype(np.float32)
    dist = dr * dr + dg * dg * gw + db * db
    return np.argmin(dist, axis=1)


def nearest_in_palette_lab(lab_colors: np.ndarray,
                           lab_palette: np.ndarray) -> np.ndarray:
    d = ((lab_colors[:, None, :] - lab_palette[None, :, :]) ** 2).sum(axis=-1)
    return np.argmin(d, axis=1)


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def quantize_image(rgba, width: int, height: int, depth: int = 1,
                   name: str = "",
                   opts: Optional[QuantizeOptions] = None) -> QuantizeResult:
    """quantize.rs:296 — RGBA8 image -> indexed texture + Clut.

    rgba: (H,W,4) or (H*W,4) or flat uint8.  depth: 0=Bpp4, 1=Bpp8.
    Index 0 is reserved for transparency; fully transparent pixels map to 0.
    """
    opts = opts or QuantizeOptions()
    px = np.asarray(rgba, np.uint8).reshape(-1, 4)
    assert px.shape[0] == width * height, "pixel count mismatch"
    target_colors = depth_colors(depth)

    rgb = px[:, :3]
    if opts.pre_quantize > 0:
        rgb = (rgb >> 4) << 4  # 4-bit denoise (quantize.rs:313)
    opaque = px[:, 3] > 0

    colors15 = _pack15(rgb[opaque, 0] >> 3, rgb[opaque, 1] >> 3,
                       rgb[opaque, 2] >> 3)
    palette = median_cut(colors15, max(target_colors - 1, 1),
                         width * height, opts)

    clut = Clut(id=0, name=name, depth=depth,
                colors=[TRANSPARENT15] * target_colors)
    for i, c in enumerate(palette):
        if i + 1 < target_colors:
            clut.colors[i + 1] = int(c)

    indices = np.zeros(width * height, np.uint8)
    if opaque.any():
        if opts.use_lab:
            pal_lab = color15_to_lab(np.asarray(palette, np.uint16))
            pix_lab = rgb888_to_lab(rgb[opaque])
            best = nearest_in_palette_lab(pix_lab, pal_lab)
        else:
            pix15 = _pack15(rgb[opaque, 0] >> 3, rgb[opaque, 1] >> 3,
                            rgb[opaque, 2] >> 3)
            best = nearest_in_palette(pix15, palette, opts.perceptual_weight)
        indices[opaque] = (best + 1).astype(np.uint8)

    texture = IndexedAtlas(width=width, height=height, depth=depth,
                           indices=indices, default_clut=0)
    return QuantizeResult(texture=texture, clut=clut)


def count_unique_colors(rgba) -> int:
    """quantize.rs:732 — distinct RGB555 among non-transparent pixels."""
    px = np.asarray(rgba, np.uint8).reshape(-1, 4)
    op = px[:, 3] > 0
    if not op.any():
        return 0
    packed = _pack15(px[op, 0] >> 3, px[op, 1] >> 3, px[op, 2] >> 3)
    return len(np.unique(packed))


def optimal_clut_depth(unique_colors: int) -> int:
    """quantize.rs:752 — <=15 colors fit Bpp4 (index 0 is transparent)."""
    return 0 if unique_colors <= 15 else 1
