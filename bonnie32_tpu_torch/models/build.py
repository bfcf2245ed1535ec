"""Host-side builders: numpy scene data -> CPU tensors
(bonnie32_tpu/models/build.py).

Only the flat atlas is built: the JAX package's bf16 texel planes, key-bit
rows and packed palette encodings are TPU structures.  The CUDA kernels
test a texel for the colour key as `(atlas.data[off + rel] & 0x7FFF) == 0`,
which is exactly what those key rows encode.
"""

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..config import BlendMode
from ..types import CameraArrays, FaceArrays, Lights, MeshArrays, \
    TextureAtlas, TextureAtlas8, resolve_device


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _pad_rows(a, n: int, fill=0):
    """`a` with rows appended up to `n`, each `fill`."""
    if a.shape[0] == n:
        return a
    if a.shape[0] > n:
        raise ValueError(f"{a.shape[0]} rows do not fit a pad of {n}")
    out = np.full((n,) + a.shape[1:], fill, a.dtype)
    out[:a.shape[0]] = a
    return out


def make_mesh_arrays(pos, uv=None, normal=None, color=None,
                     color_blend=None, pad_to=None) -> MeshArrays:
    """Pack vertex data (Vertex, types.rs:947); the defaults are
    Vertex::new's (types.rs:962): uv (0, 0), normal 0, colour NEUTRAL
    (128, 128, 128), opaque.  `pad_to` appends default-zero vertices."""
    pos = np.asarray(pos, np.float32)
    v = pos.shape[0]
    uv = np.zeros((v, 2), np.float32) if uv is None else uv
    normal = np.zeros((v, 3), np.float32) if normal is None else normal
    color = np.full((v, 3), 128, np.int32) if color is None else color
    color_blend = (np.full(v, int(BlendMode.OPAQUE), np.int32)
                   if color_blend is None else color_blend)
    n = pad_to or v
    return MeshArrays(
        pos=_t(_pad_rows(pos, n)),
        uv=_t(_pad_rows(np.asarray(uv, np.float32), n)),
        normal=_t(_pad_rows(np.asarray(normal, np.float32), n)),
        color=_t(_pad_rows(np.asarray(color, np.int32), n)),
        color_blend=_t(_pad_rows(np.asarray(color_blend, np.int32), n)))


def compute_key_possible(uv, vidx, tex_id, black_transparent,
                         textures) -> np.ndarray:
    """Per-face colour-key footprint analysis (the JAX package's
    build.compute_key_possible, unchanged numpy): False when the face's
    wrapped corner-UV bbox, with a one-texel margin, holds no black texel,
    or when the face cannot key at all."""
    uv = np.asarray(uv, np.float32)
    vidx = np.asarray(vidx, np.int64).reshape(-1, 3)
    tex_id = np.asarray(tex_id, np.int64).reshape(-1)
    bt = np.asarray(black_transparent, bool).reshape(-1)
    black_masks = []
    for pixels, _blend in textures:
        p = np.asarray(pixels).astype(np.int64) & 0xFFFF
        black_masks.append((p & 0x7FFF) == 0)

    def texel_span(lo: float, hi: float, n: int):
        span = hi - lo
        eps = abs(span) * 2e-3 + 1e-4
        i0 = int(np.floor((lo - eps) * n)) - 1
        i1 = int(np.floor((hi + eps) * n)) + 1
        if i1 - i0 + 1 >= n:
            return np.arange(n)
        return np.arange(i0, i1 + 1) % n

    out = np.zeros(len(tex_id), bool)
    for i in range(len(tex_id)):
        tid = int(tex_id[i])
        if tid < 0 or tid >= len(black_masks) or not bt[i]:
            continue
        mask = black_masks[tid]
        if not mask.any():
            continue
        cu = uv[vidx[i], 0]
        cv = 1.0 - uv[vidx[i], 1]   # the sampler flips v
        h, w = mask.shape
        txs = texel_span(float(cu.min()), float(cu.max()), w)
        tys = texel_span(float(cv.min()), float(cv.max()), h)
        out[i] = bool(mask[np.ix_(tys, txs)].any())
    return out


def make_face_arrays(vidx, tex_id=None, black_transparent=None,
                     blend_mode=None, editor_alpha=None, double_sided=None,
                     key_possible=None, pad_to=None) -> FaceArrays:
    """Pack faces (Face, types.rs:983); the defaults are Face::new's
    (types.rs:1013-1023): untextured, black-transparent, opaque, editor
    alpha 255, single-sided; key_possible unknown (True).  `pad_to`
    appends invalid faces."""
    vidx = np.asarray(vidx, np.int32).reshape(-1, 3)
    t = vidx.shape[0]

    def arr(a, dtype, default):
        return np.full(t, default, dtype) if a is None else np.asarray(
            a, dtype).reshape(t)

    n = pad_to or t
    return FaceArrays(
        vidx=_t(_pad_rows(vidx, n)),
        tex_id=_t(_pad_rows(arr(tex_id, np.int32, -1), n, -1)),
        black_transparent=_t(_pad_rows(arr(black_transparent, bool, True),
                                       n, False)),
        blend_mode=_t(_pad_rows(arr(blend_mode, np.int32,
                                    int(BlendMode.OPAQUE)), n)),
        editor_alpha=_t(_pad_rows(arr(editor_alpha, np.int32, 255), n, 255)),
        double_sided=_t(_pad_rows(arr(double_sided, bool, False), n, False)),
        valid=_t(_pad_rows(np.ones(t, bool), n, False)),
        key_possible=_t(_pad_rows(arr(key_possible, bool, True), n, False)))


def build_atlas(textures: Sequence[Tuple[np.ndarray, int]],
                pad_data_to=None, pad_count_to=None) -> TextureAtlas:
    """Flatten (pixels (h, w) Color15, blend_mode) textures into one word
    array; an empty list becomes one 1x1 white texture.  `pad_count_to`
    appends 1x1 placeholder entries at offset 0, `pad_data_to` zero
    words (the per-room atlases of models/scene.compile_level stack)."""
    if not textures:
        textures = [(np.full((1, 1), 0x7FFF, np.uint16),
                     int(BlendMode.OPAQUE))]
    offsets, widths, heights, blends, chunks = [], [], [], [], []
    has_black, has_transparent = [], []
    off = 0
    for pixels, blend in textures:
        pixels = np.asarray(pixels).astype(np.int64) & 0xFFFF
        h, w = pixels.shape
        offsets.append(off)
        widths.append(w)
        heights.append(h)
        blends.append(int(blend))
        has_black.append(bool(((pixels & 0x7FFF) == 0).any()))
        has_transparent.append(bool((pixels == 0).any()))
        chunks.append(pixels.astype(np.int32).reshape(-1))
        off += h * w
    for _ in range(len(offsets), pad_count_to or 0):
        offsets.append(0)
        widths.append(1)
        heights.append(1)
        blends.append(0)
        has_black.append(False)
        has_transparent.append(False)
    data = np.concatenate(chunks).astype(np.int32)
    if pad_data_to and pad_data_to > data.size:
        data = np.concatenate([data, np.zeros(pad_data_to - data.size,
                                              np.int32)])
    return TextureAtlas(
        data=_t(data),
        offset=_t(np.asarray(offsets, np.int32)),
        width=_t(np.asarray(widths, np.int32)),
        height=_t(np.asarray(heights, np.int32)),
        blend_mode=_t(np.asarray(blends, np.int32)),
        has_black=_t(np.asarray(has_black, bool)),
        has_transparent=_t(np.asarray(has_transparent, bool)))


def build_atlas8(textures, pad_data_to=None, pad_count_to=None,
                 device=None) -> TextureAtlas8:
    """Pack the 8-bit textures of the non-RGB555 pipeline onto `device`
    (default: the card): (rgba (h, w, 4) uint8, blend_mode) entries, an
    empty list one 1x1 white texture.  Each texel word carries its blend
    in byte 3: ERASE where alpha is 0 (types.rs:1095), else OPAQUE.
    `pad_count_to` appends 1x1 opaque entries at offset 0, `pad_data_to`
    zero words."""
    device = resolve_device(device)
    if not textures:
        textures = [(np.full((1, 1, 4), 255, np.uint8),
                     int(BlendMode.OPAQUE))]
    offsets, widths, heights, blends, chunks = [], [], [], [], []
    off = 0
    for rgba, blend in textures:
        rgba = np.asarray(rgba, np.uint8)
        h, w = rgba.shape[:2]
        texel_blend = np.where(rgba[..., 3] == 0, int(BlendMode.ERASE),
                               int(BlendMode.OPAQUE)).astype(np.int64)
        word = (rgba[..., 0].astype(np.int64)
                | (rgba[..., 1].astype(np.int64) << 8)
                | (rgba[..., 2].astype(np.int64) << 16)
                | (texel_blend << 24))
        offsets.append(off)
        widths.append(w)
        heights.append(h)
        blends.append(int(blend))
        chunks.append(word.reshape(-1).astype(np.int32))
        off += h * w
    data = np.concatenate(chunks)
    if pad_data_to is not None and data.size < pad_data_to:
        data = np.concatenate([data, np.zeros(pad_data_to - data.size,
                                              np.int32)])
    extra = max((pad_count_to or 0) - len(offsets), 0)
    offsets += [0] * extra
    widths += [1] * extra
    heights += [1] * extra
    blends += [int(BlendMode.OPAQUE)] * extra
    return TextureAtlas8(
        data=_t(data).to(device),
        offset=_t(np.asarray(offsets, np.int32)).to(device),
        width=_t(np.asarray(widths, np.int32)).to(device),
        height=_t(np.asarray(heights, np.int32)).to(device),
        blend_mode=_t(np.asarray(blends, np.int32)).to(device))


def camera_basis(pitch: float, yaw: float) -> np.ndarray:
    """Camera::update_basis (camera.rs:76-91) in host f32; rows bx, by, bz."""
    rx = np.float32(pitch)
    ry = np.float32(yaw)
    bz = np.array([np.cos(rx) * np.sin(ry), -np.sin(rx),
                   np.cos(rx) * np.cos(ry)], np.float32)
    up = np.array([0.0, -1.0, 0.0], np.float32)
    bx = np.cross(up, bz).astype(np.float32)
    ln = np.sqrt(np.float32(bx[0] * bx[0] + bx[1] * bx[1] + bx[2] * bx[2]))
    if ln != 0:
        bx = (bx / ln).astype(np.float32)
    by = np.cross(bz, bx).astype(np.float32)
    return np.stack([bx, by, bz])


def make_camera(position, basis) -> CameraArrays:
    return CameraArrays(position=_t(np.asarray(position, np.float32)),
                        basis=_t(np.asarray(basis, np.float32)))


def lights_from_list(specs: List[dict], pad: int = 8,
                     ambient: float = 0.3) -> Lights:
    """Lights from dicts {kind: 'directional'|'point'|'spot', direction,
    position, color (0-255), intensity, radius, angle, enabled}."""
    kind_map = {"directional": 1, "point": 2, "spot": 3}
    kind = np.zeros(pad, np.int32)
    position = np.zeros((pad, 3), np.float32)
    direction = np.zeros((pad, 3), np.float32)
    color01 = np.zeros((pad, 3), np.float32)
    intensity = np.zeros(pad, np.float32)
    radius = np.zeros(pad, np.float32)
    angle = np.zeros(pad, np.float32)
    for i, s in enumerate(specs):
        if not s.get("enabled", True):
            continue
        kind[i] = kind_map[s["kind"]]
        if "position" in s:
            position[i] = np.asarray(s["position"], np.float32)
        if "direction" in s:
            d = np.asarray(s["direction"], np.float32)
            ln = np.sqrt(np.float32(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]))
            direction[i] = (d / ln).astype(np.float32) if ln != 0 else d
        c = np.asarray(s.get("color", (255, 255, 255)), np.float32)
        color01[i] = (c / np.float32(255.0)).astype(np.float32)
        intensity[i] = np.float32(s.get("intensity", 1.0))
        radius[i] = np.float32(s.get("radius", 0.0))
        angle[i] = np.float32(s.get("angle", 0.0))
    return Lights(kind=_t(kind), position=_t(position),
                  direction=_t(direction), color01=_t(color01),
                  intensity=_t(intensity), radius=_t(radius),
                  angle=_t(angle),
                  ambient=torch.tensor(ambient, dtype=torch.float32))
