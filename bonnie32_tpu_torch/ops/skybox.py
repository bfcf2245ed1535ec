"""Skybox rendering: analytic sky sphere, mountain peaks and stars
(bonnie32_tpu/ops/skybox.py and the in-kernel sky of
bonnie32_tpu/ops/raster_batch.py, `_sky_chunk_scr`).

The sky of a pixel is a function of its view ray alone: the ray's
spherical angles go through `_sample_sky` (zenith/horizon/nadir gradient,
horizontal tint, horizon haze, sun and moon core + glow, cloud layers),
the result is clipped and truncated to 8 bits a channel, and the mountain
triangles of the level are drawn over it, the last covering face winning.
Stars are projected sparkles scattered over the finished plane.

Two routes use it, chosen by `sky_kernel_ok` exactly as the JAX package
chooses:

  * in-kernel: `raster_resolve` evaluates the sky at every pixel no face
    drew (ops/raster_batch.py, `SkyBackground`), then `scatter_stars`
    lands the sparkles on pixels whose depth is still the cleared 0.0;
  * sky buffer: `render_skybox` renders the whole plane (`raster_sky` on
    the card) and the stars onto it, and the rasterizer takes the plane as
    its background (x-ray, painter's, stars under transparent faces).

Both kernels run one `sky_tile` device function over SKY_TILE_H x
SKY_TILE_W tiles of a frame; its plain torch twin is `sky_plane_ref`,
which evaluates the same f32 expressions in the same order, one torch op
per rounding, from the same per-instance scalar table (`prep_sky_scal`)
and the same constants (`sky_consts`).  A tile draws only the mountain
faces whose box holds one of its pixel centres (`sky_tile_faces_ref`, in
draw order); the twin takes that restriction as an option and equals
itself without it.  The mountains use only + - * / and agree bit for bit;
the sphere goes through acos, atan2, sin and pow, whose last bits differ
between libraries, so a sky pixel may sit one 8-bit step from its twin.

`render_skybox(exact=True)` is the reference's own clear instead
(fb.render_skybox, render.rs:81-145): the generated sphere mesh (48 x 32
segments, its colours sampled at the vertices) and the mountains,
rasterized triangle by triangle over the frame it is given, the last
covering face winning, then the stars.  It is torch code (no kernel),
chunks of faces at a time (`_exact_mesh_pass`).

Not carried over from the JAX package: the (NG*H, 128) lane layout, the
zero-leaf pytree wrappers that made the config static under jit, the
minimax acos/atan2 (Mosaic has no lowering for the real ones), and the
per-chunk gating.
"""

import math
from typing import NamedTuple

import numpy as np
import torch

from ..config import PROJ_DISTANCE, PROJ_SCALE
from ..types import CameraArrays, FrameBuffers, resolve_device
from . import color as col
from .fixed import f32_to_i32, sqrt_rn
from .raster_batch import mask_words

TWO_PI = 2.0 * math.pi
# The tile of a frame one block of the sky kernels owns (csrc/raster.cu is
# built with it), and by which the plain culling cuts the frame.
SKY_TILE_H, SKY_TILE_W = 16, 32
# rows of the per-instance scalar table (prep_sky_scal)
R_MSX, R_MSY, R_INV, R_BASIS, R_YMIN, R_YMAX, R_XMIN, R_XMAX = range(8)
C_TIME = 9                      # column of row R_BASIS holding the time
# columns of SkyTables.face_table
N_FACE_COLS = 12                # 3 vertex ids + 3 corners x (r, g, b)
# diamond sparkle: ((dx, dy), dim, minimum star size), in draw order
STAR_OFFSETS = ((((0, 0), 1.0, 1),)
                + tuple(((dx, dy), 0.7, 2) for dx, dy in
                        ((-1, 0), (1, 0), (0, -1), (0, 1)))
                + tuple(((dx, dy), 0.4, 3) for dx, dy in
                        ((-2, 0), (2, 0), (0, -2), (0, 2))))
_F32 = torch.float32
_I32 = torch.int32


class SkyTables(NamedTuple):
    skybox: object              # models.skybox.Skybox, the host config
    time: float                 # generation time (cloud scroll)
    vpad: int                   # width of the per-instance scalar table
    mtn_dirs: torch.Tensor      # (M, 3) f32 unit*scale directions
    face_table: torch.Tensor    # (F, 12) i32: each mountain face's three
    #                             vertex ids and nine corner colours
    star_dirs: torch.Tensor     # (S, 3) f32 unit directions
    star_phase: torch.Tensor    # (S,) f32 twinkle phase
    star_color: torch.Tensor    # (3,) i32
    star_size: float
    star_twinkle: float
    stars_enabled: bool
    # the whole generated mesh, sphere then mountains (generate_mesh
    # order, geometry.rs:529-733), for render_skybox(exact=True)
    all_dirs: torch.Tensor = None    # (V, 3) f32 unit * per-range scale
    all_colors: torch.Tensor = None  # (V, 3) i32
    all_faces: torch.Tensor = None   # (F, 3) i32
    all_valid: torch.Tensor = None   # (F,) bool


class SkyBackground(NamedTuple):
    """The in-kernel sky as the rasterizer's background: the tables and
    the per-instance scalar table of `prep_sky_scal`."""

    sky: SkyTables
    scal: torch.Tensor          # (I, 8, vpad) f32


def _face_table(mfaces, mcolors):
    rows = [[int(f[0]), int(f[1]), int(f[2])]
            + [int(c) for v in f for c in mcolors[v]] for f in mfaces]
    return np.asarray(rows, np.int32).reshape(len(rows), N_FACE_COLS)


def build_sky_tables(skybox, time: float = 0.0, device=None) -> SkyTables:
    """Host: models.skybox.Skybox -> tables on `device` (default: the
    card; raises without one).  The sphere needs no table; mountains and
    stars carry device data."""
    device = resolve_device(device)
    if len(skybox.cloud_layers) > 2:
        raise ValueError("a skybox has two cloud layer slots")
    mdirs, mcolors, mfaces = skybox.generate_mountains(time)
    vpad = max(8, -(-max(len(mdirs), len(mfaces), 10) // 8) * 8)
    face_table = _face_table(mfaces, mcolors)
    # the exact path's mesh: the sphere, then the mountains
    sdirs_m, scolors, sfaces_m = skybox.generate_sphere(time)
    all_dirs, all_colors, all_faces = sdirs_m, scolors, sfaces_m
    if len(mdirs):
        all_dirs = np.concatenate([sdirs_m, mdirs])
        all_colors = np.concatenate([scolors, mcolors])
        all_faces = np.concatenate(
            [sfaces_m, np.asarray(mfaces, np.int32) + len(sdirs_m)])
    if len(mdirs) == 0:
        mdirs = np.zeros((1, 3), np.float32)

    # star directions (render.rs:160-181 LCG)
    stars = skybox.stars
    sdirs, sphase = [], []
    state = stars.seed

    def next_rand():
        nonlocal state
        state = (state * 1103515245 + 12345) & 0xFFFFFFFFFFFFFFFF
        return ((state >> 16) & 0xFFFFFFFFFFFF) / 65536.0 % 1.0

    for _ in range(max(stars.count, 1)):
        theta = next_rand() * TWO_PI
        phi = next_rand() * (skybox.horizon * math.pi)
        y = math.cos(phi)
        ring = math.sin(phi)
        sdirs.append((ring * math.cos(theta), y, ring * math.sin(theta)))
        sphase.append(next_rand() * TWO_PI if stars.twinkle_speed > 0
                      else 0.0)

    def t(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

    return SkyTables(
        skybox=skybox, time=float(time), vpad=int(vpad),
        mtn_dirs=t(mdirs, np.float32), face_table=t(face_table, np.int32),
        star_dirs=t(sdirs, np.float32), star_phase=t(sphase, np.float32),
        star_color=t(stars.color, np.int32),
        star_size=float(np.float32(stars.size)),
        star_twinkle=float(np.float32(stars.twinkle_speed)),
        stars_enabled=bool(stars.enabled),
        all_dirs=t(all_dirs, np.float32), all_colors=t(all_colors, np.int32),
        all_faces=t(all_faces, np.int32),
        all_valid=t(np.ones(len(all_faces), bool), bool))


def body_unit_dir(body):
    """Unit direction of a sun/moon body in the (x, y, z) frame where a
    ray's spherical angles satisfy x = sin(phi)cos(theta), y = cos(phi),
    z = sin(phi)sin(theta): the reference's cos_dist trig chain equals
    dot(ray, body)."""
    body_phi = math.pi / 2 - body.elevation
    sp, cp = math.sin(body_phi), math.cos(body_phi)
    return (sp * math.cos(body.azimuth), cp, sp * math.sin(body.azimuth))


def _rgbf(c):
    return tuple(float(x) for x in c)


def sky_consts(cfg) -> dict:
    """Every scalar the sky function reads, as Python numbers, derived in
    one place: the plain version and the CUDA kernel round the same
    doubles to f32.  The keys are the fields of the kernel's SkyParams
    struct (csrc/raster.cu)."""
    bodies = []
    for body in (cfg.sun, cfg.moon):
        glow_r = body.size * 4.0
        d = body_unit_dir(body)
        bodies.append(dict(
            enabled=int(bool(body.enabled)), dx=d[0], dy=d[1], dz=d[2],
            # beyond the glow radius core and glow are exactly 0
            cos_gate=math.cos(min(glow_r, math.pi)) - 1e-5,
            size=body.size, glow_r=glow_r,
            glow_span=max(glow_r - body.size, 1e-9),
            glow_falloff=body.glow_falloff, color=_rgbf(body.color),
            glow_color=_rgbf(body.glow_color)))
    clouds = []
    for layer in (list(cfg.cloud_layers) + [None, None])[:2]:
        if layer is None or layer.opacity <= 0:
            clouds.append(dict(enabled=0))
            continue
        stretch = 8.0 + layer.wispiness * 16.0
        threshold = layer.wispiness * 0.5
        clouds.append(dict(
            enabled=1, vmin=layer.height - layer.thickness / 2,
            vmax=layer.height + layer.thickness / 2,
            scroll_speed=layer.scroll_speed,
            f1=layer.density * 3.0, p1=layer.phase, s1=stretch,
            f2=layer.density * 7.0, p2=layer.phase * 2.0, s2=stretch * 0.5,
            f3=layer.density * 13.0, p3=layer.phase * 0.7, s3=stretch * 0.3,
            threshold=threshold, span=max(1.0 - threshold, 1e-9),
            height=layer.height,
            half_thickness=max(layer.thickness / 2, 1e-9),
            opacity=layer.opacity, color=_rgbf(layer.color)))
    tint = bool(cfg.horizontal_tint_enabled
                and cfg.horizontal_tint_intensity > 0)
    haze = bool(cfg.horizon_haze.enabled and cfg.horizon_haze.intensity > 0)
    return dict(
        zenith=_rgbf(cfg.zenith_color),
        horizon_sky=_rgbf(cfg.horizon_sky_color),
        horizon_ground=_rgbf(cfg.horizon_ground_color),
        nadir=_rgbf(cfg.nadir_color), horizon=cfg.horizon,
        above_div=max(cfg.horizon, 1e-9),
        below_div=max(1.0 - cfg.horizon, 1e-9),
        has_above=int(cfg.horizon > 0), has_below=int(cfg.horizon < 1),
        tint_enabled=int(tint), tint_dir=cfg.horizontal_tint_direction,
        tint_spread=cfg.horizontal_tint_spread,
        tint_intensity=cfg.horizontal_tint_intensity,
        tint_color=_rgbf(cfg.horizontal_tint_color),
        haze_enabled=int(haze), haze_extent=cfg.horizon_haze.extent,
        haze_intensity=cfg.horizon_haze.intensity,
        haze_color=_rgbf(cfg.horizon_haze.color),
        body=bodies, cloud=clouds)


def ray_consts(width: int, height: int) -> dict:
    """Constants of the per-pixel view ray (ray.rs:46, the inverse of
    project())."""
    return dict(half_w=width / 2.0, half_h=height / 2.0,
                vs=(min(width, height) / 2.0) * PROJ_SCALE,
                usq=PROJ_DISTANCE - 1.0)


def _consts_on(device):
    """f32 0-dim tensors of Python numbers on `device`: every constant of
    the plain version is one, so that `x / c` is a division on the card
    too (torch multiplies by the reciprocal of a Python scalar there)."""
    def c(x):
        return torch.tensor(float(x), dtype=_F32, device=device)
    return c


def _lerp3(a, b, t):
    """Channel lerp with the reference's clamp: a, b per-channel planes
    or constants."""
    t = torch.clamp(t, 0.0, 1.0)
    return tuple(av * (1.0 - t) + bv * t for av, bv in zip(a, b))


def _select3(sel, a, b):
    return tuple(torch.where(sel, x, y) for x, y in zip(a, b))


def _apply_body(body, color, ang, c):
    """Sun/moon core + glow onto `color` given the angular distance plane
    `ang`; `body` is one entry of sky_consts()["body"], `c` the constant
    maker."""
    size = c(body["size"])
    zero = torch.zeros_like(ang)
    core = torch.where(ang < size, 1.0 - ang / size, zero)
    glow_t = torch.clamp((ang - size) / c(body["glow_span"]), 0.0, 1.0)
    glow = torch.where(
        (ang >= size) & (ang < c(body["glow_r"])),
        torch.pow(1.0 - glow_t, c(body["glow_falloff"])) * c(0.6), zero)
    cored = _lerp3(color, [c(x) for x in body["color"]], core)
    color = _select3(core > 0, cored, color)
    glowed = _lerp3(color, [c(x) for x in body["glow_color"]], glow)
    return _select3(glow > 0, glowed, color)


def _sample_sky(cfg, theta, phi, time, ray):
    """Torch mirror of models.skybox.Skybox.sample_at_direction
    (geometry.rs:400-527), channel-separated, in the JAX package's
    expression order.  Returns unclipped float (r, g, b) planes.
    `time` is an f32 tensor; `ray` is the unit world direction (wx, wy,
    wz) that `theta` and `phi` are the angles of: the angular distance to
    the sun and the moon is taken from its dot product with
    body_unit_dir, as the kernels take it."""
    wx, wy, wz = ray
    k = sky_consts(cfg)
    c = _consts_on(phi.device)
    c3 = lambda v: [c(x) for x in v]  # noqa: E731
    v = phi / c(math.pi)
    hz = c(k["horizon"])

    t_above = v / c(k["above_div"]) if k["has_above"] \
        else torch.zeros_like(v)
    above = _lerp3(c3(k["zenith"]), c3(k["horizon_sky"]), t_above)
    t_below = (v - hz) / c(k["below_div"]) if k["has_below"] \
        else torch.ones_like(v)
    below = _lerp3(c3(k["horizon_ground"]), c3(k["nadir"]), t_below)
    color = _select3(v < hz, above, below)
    zero = torch.zeros_like(v)

    if k["tint_enabled"]:
        diff = (theta - c(k["tint_dir"])).abs()
        diff = torch.where(diff > c(math.pi), c(TWO_PI) - diff, diff)
        spread = c(k["tint_spread"])
        dt = 1.0 - diff / spread
        strength = torch.where(diff < spread,
                               (dt * dt) * c(k["tint_intensity"]), zero)
        horizon_factor = 1.0 - torch.clamp((v - hz).abs() / c(0.3),
                                           max=1.0)
        tinted = _lerp3(color, c3(k["tint_color"]),
                        strength * horizon_factor)
        color = _select3(strength > 0, tinted, color)

    if k["haze_enabled"]:
        dist = (v - hz).abs()
        ext = c(k["haze_extent"])
        de = 1.0 - dist / ext
        s = torch.where(dist < ext, (de * de) * c(k["haze_intensity"]), zero)
        hazed = _lerp3(color, c3(k["haze_color"]), s)
        color = _select3(s > 0, hazed, color)

    for body in k["body"]:
        if not body["enabled"]:
            continue
        cosd = wx * c(body["dx"]) + wy * c(body["dy"]) + wz * c(body["dz"])
        ang = torch.acos(torch.clamp(cosd, -1.0, 1.0))
        color = _apply_body(body, color, ang, c)

    for layer in k["cloud"]:
        if not layer["enabled"]:
            continue
        inside = (v >= c(layer["vmin"])) & (v <= c(layer["vmax"]))
        th_s = theta + time * c(layer["scroll_speed"])
        n1 = torch.sin(torch.sin(th_s * c(layer["f1"]) + c(layer["p1"]))
                       * c(layer["s1"]) + v * c(50.0))
        n2 = torch.sin(torch.sin(th_s * c(layer["f2"]) + c(layer["p2"]))
                       * c(layer["s2"]) + v * c(120.0))
        n3 = torch.sin(torch.sin(th_s * c(layer["f3"]) + c(layer["p3"]))
                       * c(layer["s3"]) + v * c(200.0))
        raw = torch.clamp(n1 * c(0.5) + n2 * c(0.3) + n3 * c(0.2) + c(0.5),
                          0.0, 1.0)
        thr = c(layer["threshold"])
        frac = torch.clamp((raw - thr) / c(layer["span"]), min=0.0)
        # select after both sides: pow of a discarded value leaves no NaN
        cval = torch.where(raw < thr, zero, torch.pow(frac, c(0.7)))
        dist = (v - c(layer["height"])).abs() / c(layer["half_thickness"])
        edge = torch.clamp(1.0 - dist, 0.0, 1.0)
        s = torch.where(inside, cval * c(layer["opacity"]) * edge, zero)
        clouded = _lerp3(color, c3(layer["color"]), s)
        color = _select3(s > 0, clouded, color)

    return color


def _rotate(dirs, basis):
    """(S, 3) directions into every camera's frame: out[i, v, r] =
    sum_k dirs[v, k] * basis[i, r, k], summed left to right."""
    d = dirs[None, :, None, :]                          # (1, S, 1, 3)
    b = basis[:, None, :, :]                            # (I, 1, 3, 3)
    return (d[..., 0] * b[..., 0] + d[..., 1] * b[..., 1]) \
        + d[..., 2] * b[..., 2]


def _project(cam_dirs, width, height):
    """Camera-frame points (I, V, 3) -> (in front of the camera, screen
    x, screen y), each (I, V) (project(), math.rs)."""
    vs = (min(width, height) / 2.0) * PROJ_SCALE
    us = PROJ_DISTANCE - 1.0
    denom = cam_dirs[..., 2] + PROJ_DISTANCE
    sx = (cam_dirs[..., 0] * us) / denom * vs + width / 2.0
    sy = (cam_dirs[..., 1] * us) / denom * vs + height / 2.0
    return cam_dirs[..., 2] > 0.1, sx, sy


def prep_sky_scal(sky: SkyTables, cams: CameraArrays, width: int,
                  height: int, time=None) -> torch.Tensor:
    """Per-instance scalar table of the sky kernels, (I, 8, vpad) f32.
    Rows:

      0: projected mountain-vertex screen x  (per vertex)
      1: projected mountain-vertex screen y  (per vertex)
      2: per-FACE 1/dnm (barycentric denominator reciprocal)
      3: camera basis row-major (cols 0-8) + the time (col 9; default
         the tables' generation time)
      4-7: per-FACE screen bbox ymin/ymax/xmin/xmax; invalid and culled
           faces get an empty box (ymin > ymax), which is how the kernels
           and the plain version know them."""
    basis = cams.basis.to(_F32)
    n = basis.shape[0]
    dev = basis.device
    vpad = sky.vpad
    mvalid, msx, msy = _project(_rotate(sky.mtn_dirs * 10000.0, basis),
                                width, height)
    out = torch.zeros((n, 8, vpad), dtype=_F32, device=dev)
    nv = msx.shape[1]
    out[:, R_MSX, :nv] = msx
    out[:, R_MSY, :nv] = msy
    out[:, R_BASIS, :9] = basis.reshape(n, 9)
    out[:, R_BASIS, C_TIME] = float(np.float32(
        sky.time if time is None else time))
    nf = sky.face_table.shape[0]
    if nf:
        fi = sky.face_table[:, :3].long()
        x0, x1, x2 = (msx[:, fi[:, j]] for j in range(3))
        y0, y1, y2 = (msy[:, fi[:, j]] for j in range(3))
        ok = mvalid[:, fi[:, 0]] & mvalid[:, fi[:, 1]] & mvalid[:, fi[:, 2]]
        signed = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
        ok = ok & (signed < 0.0)          # inward-facing (render.rs:124)
        dnm = (y1 - y2) * (x0 - x2) + (x2 - x1) * (y0 - y2)
        ok = ok & (dnm.abs() >= 0.0001)
        inv = 1.0 / torch.where(dnm == 0, torch.ones_like(dnm), dnm)
        big = torch.full_like(dnm, 1e9)
        xmin = torch.minimum(torch.minimum(x0, x1), x2) - 1.0
        xmax = torch.maximum(torch.maximum(x0, x1), x2) + 1.0
        ymin = torch.minimum(torch.minimum(y0, y1), y2) - 1.0
        ymax = torch.maximum(torch.maximum(y0, y1), y2) + 1.0
        out[:, R_INV, :nf] = inv
        out[:, R_YMIN, :nf] = torch.where(ok, ymin, big)
        out[:, R_YMAX, :nf] = torch.where(ok, ymax, -big)
        out[:, R_XMIN, :nf] = torch.where(ok, xmin, big)
        out[:, R_XMAX, :nf] = torch.where(ok, xmax, -big)
    return out


def _u8(x):
    """clip to [0, 255] then the saturating f32 -> i32 convert."""
    return f32_to_i32(torch.clamp(x, 0.0, 255.0))


def sky_plane_ref(sky: SkyTables, scal: torch.Tensor, height: int,
                  width: int, tile_faces=None) -> torch.Tensor:
    """Plain torch twin of the `raster_sky` kernel (and of the sky that
    `raster_resolve` draws behind the faces): sphere + mountains of every
    instance from its scalar table, (I, H, W) packed RGBA8 i32.  With
    `tile_faces` (the words of `sky_tile_faces_ref`), each tile draws only
    its own faces, as the kernels do."""
    dev = scal.device
    c = _consts_on(dev)
    r = ray_consts(width, height)
    xi = torch.arange(width, device=dev, dtype=_I32)[None, None, :]
    yi = torch.arange(height, device=dev, dtype=_I32)[None, :, None]
    pxf = xi.to(_F32)
    pyf = yi.to(_F32)
    b = [scal[:, R_BASIS, j][:, None, None] for j in range(9)]
    time = scal[:, R_BASIS, C_TIME][:, None, None]

    # per-pixel view ray -> world direction
    ndc_x = (pxf + 0.5 - c(r["half_w"])) / c(r["vs"]) / c(r["usq"])
    ndc_y = (pyf + 0.5 - c(r["half_h"])) / c(r["vs"]) / c(r["usq"])
    norm = sqrt_rn(ndc_x * ndc_x + ndc_y * ndc_y + 1.0)
    cx, cy, cz = ndc_x / norm, ndc_y / norm, 1.0 / norm
    wx = cx * b[0] + cy * b[3] + cz * b[6]
    wy = cx * b[1] + cy * b[4] + cz * b[7]
    wz = cx * b[2] + cy * b[5] + cz * b[8]
    phi = torch.acos(torch.clamp(wy, -1.0, 1.0))
    # jnp.mod(atan2, 2 pi): the angle lies in [-pi, pi], so the remainder
    # is the angle itself and only its sign is repaired
    ang = torch.atan2(wz, wx)
    theta = torch.where(ang < 0, ang + c(TWO_PI), ang)

    rf, gf, bf = _sample_sky(sky.skybox, theta, phi, time, (wx, wy, wz))
    alpha = torch.full(rf.shape, 255, dtype=_I32, device=dev)
    word = col.pack_rgba8(_u8(rf), _u8(gf), _u8(bf), alpha)

    # mountains: last covering face wins (render.rs:111-139)
    for covered, (w0, w1, w2), cols in _mountain_faces(sky, scal, height,
                                                       width, tile_faces):
        ch = [f32_to_i32(torch.clamp(torch.trunc(
            w0 * float(cols[j]) + w1 * float(cols[3 + j])
            + w2 * float(cols[6 + j])), 0.0, 255.0)) for j in range(3)]
        word = torch.where(covered,
                           col.pack_rgba8(ch[0], ch[1], ch[2], alpha), word)
    return word


def _mountain_faces(sky: SkyTables, scal: torch.Tensor, height: int,
                    width: int, tile_faces=None):
    """Per mountain face in draw order: (covered (I, H, W) bool, the
    barycentrics (w0, w1, w2), the nine corner colours), from the scalar
    table alone, as the kernels evaluate them: a face is drawn where its
    box (the triangle's bounds widened by one pixel; empty for an invalid
    or culled face) holds the pixel centre and the three barycentrics are
    >= 0, and, with `tile_faces` given, only in the tiles whose words hold
    its bit.  The JAX kernel tests the box per chunk of rows, its buffer
    route not at all; a covered pixel lies inside the box either way."""
    dev = scal.device
    px = torch.arange(width, device=dev, dtype=_F32)[None, None, :] + 0.5
    py = torch.arange(height, device=dev, dtype=_F32)[None, :, None] + 0.5
    for f, (i0, i1, i2, *cols) in enumerate(sky.face_table.tolist()):
        valid = (scal[:, R_YMIN, f] <= scal[:, R_YMAX, f])[:, None, None]
        if not bool(valid.any()):
            continue
        in_tiles = True
        if tile_faces is not None:
            in_tiles = (((tile_faces[..., f // 32] >> (f % 32)) & 1) != 0)
            in_tiles = in_tiles.repeat_interleave(SKY_TILE_H, 1)[:, :height]
            in_tiles = in_tiles.repeat_interleave(SKY_TILE_W, 2)[..., :width]
        x0, x1, x2 = (scal[:, R_MSX, i][:, None, None] for i in (i0, i1, i2))
        y0, y1, y2 = (scal[:, R_MSY, i][:, None, None] for i in (i0, i1, i2))
        inv = scal[:, R_INV, f][:, None, None]
        w0 = ((y1 - y2) * (px - x2) + (x2 - x1) * (py - y2)) * inv
        w1 = ((y2 - y0) * (px - x2) + (x0 - x2) * (py - y2)) * inv
        w2 = 1.0 - w0 - w1
        box = [scal[:, r, f][:, None, None]
               for r in (R_XMIN, R_XMAX, R_YMIN, R_YMAX)]
        inside = ((px >= box[0]) & (px <= box[1])
                  & (py >= box[2]) & (py <= box[3]))
        yield (inside & in_tiles & (w0 >= 0.0) & (w1 >= 0.0) & (w2 >= 0.0),
               (w0, w1, w2), cols)


def sky_tile_grid(height: int, width: int):
    """(tiles_y, tiles_x) of the sky kernels' tiles; the last row and
    column may be ragged."""
    return -(-height // SKY_TILE_H), -(-width // SKY_TILE_W)


def sky_tile_faces_ref(sky: SkyTables, scal: torch.Tensor, height: int,
                       width: int) -> torch.Tensor:
    """Plain version of the sky kernels' per-tile cull: the mountain faces
    whose box holds a pixel centre of each SKY_TILE_H x SKY_TILE_W tile,
    as words (I, tiles_y, tiles_x, ceil(F / 32)) i32 whose bit b of word w
    is face 32 w + b, so that the set bits are the tile's faces in draw
    order (the counterpart of raster_batch.tile_bins_ref).  An invalid or
    culled face has an empty box and lies in no tile."""
    dev = scal.device
    nf = sky.face_table.shape[0]
    tiles_y, tiles_x = sky_tile_grid(height, width)
    y0 = torch.arange(tiles_y, device=dev, dtype=_I32) * SKY_TILE_H
    x0 = torch.arange(tiles_x, device=dev, dtype=_I32) * SKY_TILE_W
    # the first and last pixel centre of each tile row and column
    lo_y, lo_x = y0.to(_F32) + 0.5, x0.to(_F32) + 0.5
    hi_y = torch.clamp(y0 + SKY_TILE_H, max=height).to(_F32) - 0.5
    hi_x = torch.clamp(x0 + SKY_TILE_W, max=width).to(_F32) - 0.5
    xmin, xmax, ymin, ymax = (scal[:, r, None, :nf] for r in (
        R_XMIN, R_XMAX, R_YMIN, R_YMAX))                  # (I, 1, F)
    rows = (ymax >= lo_y[None, :, None]) & (ymin <= hi_y[None, :, None])
    cols = (xmax >= lo_x[None, :, None]) & (xmin <= hi_x[None, :, None])
    return mask_words(rows[:, :, None] & cols[:, None])   # (I, TY, TX, F)


def mountain_mask(sky: SkyTables, scal: torch.Tensor, height: int,
                  width: int) -> torch.Tensor:
    """(I, H, W) bool: the pixels a mountain face covers (for checks that
    hold mountain pixels exact and sphere pixels to one step)."""
    mask = torch.zeros((scal.shape[0], height, width), dtype=torch.bool,
                       device=scal.device)
    for covered, _, _ in _mountain_faces(sky, scal, height, width):
        mask |= covered
    return mask


def render_sky_plane(sky: SkyTables, scal: torch.Tensor, height: int,
                     width: int) -> torch.Tensor:
    """Sphere + mountains of every instance, (I, H, W) i32: the
    `raster_sky` kernel for CUDA tensors, its plain twin for CPU
    tensors."""
    if scal.is_cuda:
        from . import _cuda
        return _cuda.raster_sky(sky, scal, height, width)
    if scal.device.type != "cpu":
        raise ValueError(f"unsupported device {scal.device}")
    return sky_plane_ref(sky, scal, height, width)


def _star_writes(sky: SkyTables, cams: CameraArrays, height: int,
                 width: int, time):
    """Projected star sparkle writes (render.rs:149-237), the nine
    diamond offsets stacked in draw order: screen xs, ys and the mask ok,
    each (I, 9, S), and the packed colour words (9, S)."""
    dev = sky.star_dirs.device
    scam = _rotate(sky.star_dirs * 10000.0, cams.basis.to(_F32))
    s_ok, fx, fy = _project(scam, width, height)
    # the screen coordinates are huge where the denominator nears 0: the
    # saturating convert first, the bounds test after
    ssx = f32_to_i32(fx)
    ssy = f32_to_i32(fy)
    if sky.star_twinkle > 0.0:
        brightness = 0.5 + 0.5 * torch.sin(
            float(np.float32(time)) * sky.star_twinkle + sky.star_phase)
    else:
        brightness = torch.ones_like(sky.star_phase)
    base = sky.star_color.to(_F32)
    # two-stage truncation as the reference: base*brightness to u8 first,
    # then the diamond arms truncate center*0.7 / center*0.4
    center_c = torch.trunc(base[None, :] * brightness[:, None]).to(_I32)
    size = int(max(sky.star_size, 1.0))
    table = torch.tensor(
        [(dx, dy, dim, float(sky.stars_enabled and size >= min_size))
         for (dx, dy), dim, min_size in STAR_OFFSETS], dtype=_F32, device=dev)
    dxy = table[:, :2].to(_I32)
    cc = torch.trunc(center_c.to(_F32)[None] * table[:, 2, None, None]).to(
        _I32)                                               # (9, S, 3)
    words = col.pack_rgba8(cc[..., 0], cc[..., 1], cc[..., 2],
                           torch.full_like(cc[..., 0], 255))
    xs = ssx[:, None, :] + dxy[None, :, 0, None]
    ys = ssy[:, None, :] + dxy[None, :, 1, None]
    ok = (s_ok[:, None, :] & (table[None, :, 3, None] != 0)
          & (xs >= 0) & (xs < width) & (ys >= 0) & (ys < height))
    return xs, ys, ok, words


def scatter_stars(color, depth, sky: SkyTables, cams: CameraArrays,
                  time=0.0):
    """The star pass: sparkles onto `color` (I, H, W) i32.  With `depth`
    given they land only where it is still the cleared 0.0, i.e. where no
    opaque face drew (the in-kernel sky route); with depth None
    everywhere (the sky-buffer route, before the faces).

    The JAX package scatters offset by offset so that a later offset
    overwrites an earlier one, and within one offset its CPU scatter
    leaves the later star.  Duplicate indices are unordered in torch's
    index_put_, so the winner of each pixel is built explicitly: the
    largest key `offset * S + star` (an order-free amax reduction), then
    that star's colour.  Masked writes are dropped by the mask, never by
    an out-of-range index (negative indices wrap).  Returns a new plane;
    `color` is left alone."""
    n, height, width = color.shape
    xs, ys, ok, words = _star_writes(sky, cams, height, width, time)
    s = sky.star_dirs.shape[0]
    dev = color.device
    inst = torch.arange(n, device=dev)[:, None, None] * (height * width)
    flat = (inst + (ys.clamp(0, height - 1).long() * width
                    + xs.clamp(0, width - 1).long())).reshape(-1)
    ok = ok.reshape(-1)
    if depth is not None:
        ok = ok & (depth.reshape(-1)[flat] == 0.0)
    # key = offset * S + star; a masked write carries -1 and wins no pixel
    key = torch.arange(len(STAR_OFFSETS) * s, device=dev,
                       dtype=_I32).expand(n, -1).reshape(-1)
    winner = torch.full((n * height * width,), -1, dtype=_I32, device=dev)
    winner.scatter_reduce_(0, flat, torch.where(ok, key, -1), "amax")
    # every write carries its pixel's winning colour (the pixel's own
    # colour where no sparkle is live), so duplicate indices hold equal
    # values and the scatter is deterministic; only the I * 9 * S touched
    # pixels are visited, not the plane
    won = winner[flat]
    out = color.reshape(-1).clone()
    values = torch.where(won >= 0, words.reshape(-1)[won.clamp(min=0).long()],
                         out[flat])
    out.scatter_(0, flat, values)
    return out.reshape(color.shape)


def sky_kernel_ok(sky, static, settings) -> bool:
    """Routing test, as the JAX package's: the in-kernel sky (background
    synthesis in `raster_resolve` + the star pass after it) or the full
    sky-buffer route (`render_skybox` -> background plane)."""
    if sky is None:
        return False
    if not settings.use_zbuffer or settings.xray_mode:
        return False
    sb = sky.skybox
    if (sb.stars.enabled and sb.stars.count > 0
            and len(static.transparent_idx) > 0):
        # stars composite UNDER transparent faces; the star pass runs
        # after the composite, so take the buffer route
        return False
    return True


# elements of one chunk's (I, K, H, W) coverage planes in the exact mesh
# pass: the chunk's face count K follows from the frame and batch size
EXACT_CHUNK_ELEMS = 1 << 24


def exact_face_setup(sky: SkyTables, cams: CameraArrays, height: int,
                     width: int):
    """Per mesh face and instance, what rasterize_skybox_triangle
    (render.rs:246-299) needs, as the JAX package's exact path computes
    it: (ok (I, F) bool, corners x (3 of (I, F)), y (3 of (I, F)), 1/dnm
    (I, F), colours (F, 9) f64).  A face is ok where it is valid, its
    three vertices lie in front of the camera, it faces inward (signed
    area < 0, render.rs:124) and its barycentric denominator is not
    tiny."""
    vvalid, vx, vy = _project(_rotate(sky.all_dirs * 10000.0,
                                      cams.basis.to(_F32)), width, height)
    f = sky.all_faces.long()
    x0, x1, x2 = (vx[:, f[:, j]] for j in range(3))
    y0, y1, y2 = (vy[:, f[:, j]] for j in range(3))
    ok = (sky.all_valid[None] & vvalid[:, f[:, 0]] & vvalid[:, f[:, 1]]
          & vvalid[:, f[:, 2]])
    signed = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
    dnm = (y1 - y2) * (x0 - x2) + (x2 - x1) * (y0 - y2)
    ok = ok & (signed < 0.0) & (dnm.abs() >= 0.0001)
    inv = torch.ones_like(dnm) / torch.where(dnm == 0,
                                             torch.ones_like(dnm), dnm)
    colors = sky.all_colors[f].reshape(-1, 9).to(torch.float64)
    return ok, (x0, x1, x2), (y0, y1, y2), inv, colors


def exact_face_cover(xs, ys, inv, px, py):
    """Barycentrics (w0, w1, w2) of the pixel centres (px, py) and
    coverage, the corners and 1/dnm broadcasting against them
    (render.rs:262-281)."""
    x0, x1, x2 = xs
    y0, y1, y2 = ys
    w0 = ((y1 - y2) * (px - x2) + (x2 - x1) * (py - y2)) * inv
    w1 = ((y2 - y0) * (px - x2) + (x0 - x2) * (py - y2)) * inv
    w2 = 1.0 - w0 - w1
    return (w0, w1, w2), (w0 >= 0.0) & (w1 >= 0.0) & (w2 >= 0.0)


def exact_face_color(w, cols):
    """The covered pixel's colour channels (render.rs:283-290): each
    w0 c0 + w1 c1 + w2 c2, truncated and clipped to [0, 255]; `cols` (9
    columns (r, g, b) per corner, f64) broadcasts against the w planes.
    The products and their sum are taken in f64 and rounded to f32 once,
    as the golden transcription of the reference does
    (tests/golden/skybox_golden.py); the JAX package sums in f32, which
    truncates one step lower where the sum lands just below an integer."""
    w0, w1, w2 = (x.to(torch.float64) for x in w)
    return [f32_to_i32(torch.clamp(torch.trunc((
        w0 * cols[..., j] + w1 * cols[..., 3 + j] + w2 * cols[..., 6 + j]
    ).to(_F32)), 0.0, 255.0)) for j in range(3)]


def _exact_mesh_pass(color, sky: SkyTables, cams: CameraArrays):
    """The mesh walk of render_skybox(exact=True): every face in order
    over `color` (I, H, W) packed words, the last covering face winning.
    Faces that no instance draws are dropped first (one read on the
    host); the rest go in chunks of K, each an order-free reduction: the
    covering face of highest index in the chunk wins a pixel (an amax),
    its barycentrics are evaluated again at the pixels it won (the same
    f32 expressions on the same values) and its colour written, so that
    the frame equals the face-by-face loop.  Returns the (r, g, b)
    planes."""
    n, height, width = color.shape
    dev = color.device
    ok, xs, ys, inv, cols = exact_face_setup(sky, cams, height, width)
    chans = list(col.unpack_rgba8(color)[:3])
    live = torch.nonzero(ok.any(0)).flatten()
    if live.numel() == 0:
        return chans
    px = torch.arange(width, device=dev, dtype=_F32)[None, None, :] + 0.5
    py = torch.arange(height, device=dev, dtype=_F32)[None, :, None] + 0.5
    rows = torch.arange(n, device=dev)[:, None, None]
    k = max(1, min(live.numel(), EXACT_CHUNK_ELEMS // (n * height * width)))
    for start in range(0, live.numel(), k):
        fids = live[start:start + k]
        kk = fids.numel()
        c_ok = ok[:, fids]                                      # (I, K)
        c_xs = [x[:, fids] for x in xs]
        c_ys = [y[:, fids] for y in ys]
        c_inv = inv[:, fids]

        def at_faces(v):                   # (I, K) -> (I, K, 1, 1)
            return v[:, :, None, None]

        _, cov = exact_face_cover([at_faces(x) for x in c_xs],
                                  [at_faces(y) for y in c_ys],
                                  at_faces(c_inv), px[:, None], py[:, None])
        slot = torch.arange(kk, device=dev, dtype=_I32)[None, :, None, None]
        win = torch.where(cov & at_faces(c_ok), slot,
                          torch.full_like(slot, -1)).amax(1)    # (I, H, W)
        drawn = win >= 0
        wl = win.clamp(min=0).long()

        def at_win(v):                     # (I, K) -> (I, H, W)
            return v[rows, wl]

        w, _ = exact_face_cover([at_win(x) for x in c_xs],
                                [at_win(y) for y in c_ys], at_win(c_inv),
                                px, py)
        new = exact_face_color(w, cols[fids][wl])
        chans = [torch.where(drawn, nc, c) for nc, c in zip(new, chans)]
    return chans


def render_skybox(sky: SkyTables, cams: CameraArrays, height: int,
                  width: int, time=None, exact: bool = False,
                  fb: FrameBuffers = None) -> FrameBuffers:
    """fb.render_skybox (render.rs:81-145) + stars (:149-237) for every
    camera: (I, H, W) colour and the cleared inverse-z depth.  `time`
    (cloud scroll, twinkle) defaults to the tables' generation time.

    exact=False: the sphere is the analytic sky function at each pixel's
    exact direction (`raster_sky` on the card), the mountains over it.
    exact=True: the generated sphere and mountain mesh, rasterized
    triangle by triangle (`_exact_mesh_pass`) over the frame `fb`
    ((I, height, width) FrameBuffers, required), as the reference clears
    with it; every pixel's alpha becomes 255."""
    time = sky.time if time is None else time
    if exact:
        if fb is None or tuple(fb.color.shape[1:]) != (height, width):
            raise ValueError("render_skybox(exact=True) draws over a frame: "
                             f"pass fb of shape (I, {height}, {width})")
        r, g, b = _exact_mesh_pass(fb.color, sky, cams)
        color = col.pack_rgba8(r, g, b, torch.full_like(r, 255))
    else:
        scal = prep_sky_scal(sky, cams, width, height, time=time)
        color = render_sky_plane(sky, scal, height, width)
    if sky.stars_enabled:
        color = scatter_stars(color, None, sky, cams, time=time)
    return FrameBuffers(color=color, depth=torch.zeros(
        color.shape, dtype=_F32, device=color.device))
