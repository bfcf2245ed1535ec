"""Wireframe passes of the editor (bonnie32_tpu/ops/wireframe.py): the
edges of the back faces, depth-tested, over the solid passes, and the
edges of the front faces over a cleared frame (`wireframe_overlay`),
batched over instances in plain torch tensor code: over a FlatScene
(`render_wireframes_flat`, the kernel route, each edge deduplicated within
its draw group) or over one mesh (`render_wireframes`, the sequential
renderer's pass after each render_mesh_15, on an inverse-z or a
harmonic-z depth plane).

The reference walks each edge with a data-dependent Bresenham loop
(render.rs:684-860) after collecting and deduplicating the edges in its
cull loop (render.rs:2368-2513, 2573-2633).  Here, as in the JAX
package, the walk is evaluated in closed form per step index: the pixel
at step k of an edge is

    major axis:  p_k = p0 + s k
    minor axis:  q_k = q0 + s_q floor((2 k d_minor + d_major) / (2 d_major))

so every edge becomes a fixed strip of `max_steps` pixels, starting where
the segment enters the screen, and all strips scatter into the frame at
once.  A line writes colour only, one constant word per pass, so writes
that land on the same pixel agree and their order does not matter.

The strips are (instances, edges, max_steps): on the Cave-size level
(984 edges) at N=1024 that is 387 M entries a pass, so the instances go
through in chunks of INSTANCE_CHUNK.  Integer arithmetic stays i32 with
floor division where the JAX code has `//`; masked writes go to one
padding slot past the frame (a negative index would wrap).
"""

import torch

from ..config import NEAR_PLANE, RasterSettings
from ..types import CameraArrays, FrameBuffers
from .color import pack_rgb as _pack_rgb
from .fixed import f32_to_i32
from .raster_batch import _lexsort
from .vertex import transform_vertices

# Wireframe palette (render.rs:2599, 2630)
BACKFACE_COLOR = (80, 80, 100)
FRONTFACE_COLOR = (200, 200, 220)
MAX_STEPS = 384           # strip length: the longest on-screen run
INSTANCE_CHUNK = 128      # instances per strip batch (memory)


def _floor_div(a, b):
    return torch.div(a, b, rounding_mode="floor")


def line_pixels(x0, y0, x1, y1, width: int, height: int, max_steps: int):
    """Closed-form Bresenham strips of segments (x0, y0) -> (x1, y1), i32
    tensors of one shape S.  Returns (xs, ys, t, valid), each S + (K,):
    the pixel coordinates, the interpolation parameter t = step / total
    steps (render.rs:783-786), and a mask of the steps within the segment.

    A strip starts at k_start, the largest lower bound on the step index
    that the screen's edges give on either axis (both coordinates are
    monotone in k), so `max_steps` covers the on-screen run, not the whole
    segment."""
    def full(v):
        return torch.full_like(x0, v)

    dx = (x1 - x0).abs()
    ady = (y1 - y0).abs()
    sx = torch.where(x0 < x1, full(1), full(-1))
    sy = torch.where(y0 < y1, full(1), full(-1))
    length = torch.maximum(dx, ady)

    xmajor = dx >= ady
    dmaj = torch.clamp(torch.where(xmajor, dx, ady), min=1)
    dmin = torch.where(xmajor, ady, dx)

    # lower bounds on k from the screen's edges on each axis
    p0 = torch.where(xmajor, x0, y0)
    plim = torch.where(xmajor, full(width), full(height))
    q0 = torch.where(xmajor, y0, x0)
    qlim = torch.where(xmajor, full(height), full(width))
    smaj = torch.where(xmajor, sx, sy)
    smin = torch.where(xmajor, sy, sx)
    k_lo_major = torch.where(smaj > 0, -p0, p0 - (plim - 1))
    m_req = torch.clamp(torch.where(smin > 0, -q0, q0 - (qlim - 1)), min=0)
    # minor_off(k) >= m  <=>  k >= ceil(dmaj (2m - 1) / (2 dmin))
    ceil_minor = -_floor_div(-(dmaj * (2 * m_req - 1)),
                             torch.clamp(2 * dmin, min=1))
    k_lo_minor = torch.where(m_req == 0, full(0),
                             torch.where(dmin > 0, ceil_minor, length + 1))
    k_start = torch.minimum(
        torch.maximum(torch.maximum(k_lo_major, k_lo_minor), full(0)),
        length + 1)

    k = k_start[..., None] + torch.arange(max_steps, dtype=torch.int32,
                                          device=x0.device)
    valid = k <= length[..., None]
    dmin_k, dmaj_k = dmin[..., None], dmaj[..., None]
    minor_off = _floor_div(2 * k * dmin_k + dmaj_k, 2 * dmaj_k)
    xmaj_k = xmajor[..., None]
    x0k, y0k, sxk, syk = (v[..., None] for v in (x0, y0, sx, sy))
    xs = torch.where(xmaj_k, x0k + sxk * k, x0k + sxk * minor_off)
    ys = torch.where(xmaj_k, y0k + syk * minor_off, y0k + syk * k)
    # total_steps = max(dx, dy, 1); step == k (render.rs:781-786)
    t = k.to(torch.float32) / torch.clamp(length, min=1).to(
        torch.float32)[..., None]
    return xs, ys, t, valid


def scatter_lines(buf, depth, ex, ey, ez, valid_edge, word: int,
                   max_steps: int, depth_tested: bool, inst0: int,
                   depth_mode: str = "inv", inclusive: bool = False):
    """Draw the edges (I, E, 2) of instances inst0.. into `buf`, the flat
    colour planes of every instance plus one padding slot.  With
    `depth_tested` a pixel draws only where the line is strictly in front
    of the depth plane (draw_line_3d: z < buf, render.rs:795, 800): on an
    inverse-z plane ("inv") where its 1/z is above the plane's, on a
    harmonic one where its z is below; `inclusive` lets a line level with
    the plane draw too (draw_line_3d_overlay and the alpha pass, z <= buf,
    render.rs:764, 822).  Depth is never written (render.rs:793-797)."""
    n, height, width = depth.shape
    xs, ys, t, step_ok = line_pixels(ex[..., 0], ey[..., 0], ex[..., 1],
                                     ey[..., 1], width, height, max_steps)
    z = ez[..., 0:1] + t * (ez[..., 1:2] - ez[..., 0:1])      # (I, E, K)
    ok = (step_ok & valid_edge[..., None] & (xs >= 0) & (xs < width)
          & (ys >= 0) & (ys < height))
    inst = torch.arange(inst0, inst0 + ex.shape[0], device=ex.device)
    pix = ((inst[:, None, None] * height + ys.long()) * width + xs.long())
    if depth_tested:
        plane = depth.reshape(-1)[torch.where(ok, pix, torch.zeros_like(pix))]
        if depth_mode == "harmonic":
            ok &= (z <= plane) if inclusive else (z < plane)
        else:
            # a line z <= 0 cannot beat a positive 1/z; the cleared 0 is far
            izl = torch.where(z > 0.0, torch.ones_like(z) / z,
                              torch.full_like(z, float("-inf")))
            ok &= (izl >= plane) if inclusive else (izl > plane)
    buf.index_fill_(0, torch.where(ok, pix, torch.full_like(pix, n * height
                                                            * width)
                                   ).reshape(-1), word)


def _edge_key(ex, ey):
    """Each edge's endpoints in normalized order (the lexically smaller
    one first, render.rs:2586-2591): (flip, kx0, ky0, kx1, ky1)."""
    a_first = (ex[..., 0] < ex[..., 1]) | ((ex[..., 0] == ex[..., 1])
                                           & (ey[..., 0] < ey[..., 1]))
    kx0 = torch.where(a_first, ex[..., 0], ex[..., 1])
    ky0 = torch.where(a_first, ey[..., 0], ey[..., 1])
    kx1 = torch.where(a_first, ex[..., 1], ex[..., 0])
    ky1 = torch.where(a_first, ey[..., 1], ey[..., 0])
    return ~a_first, kx0, ky0, kx1, ky1


def _dedup_mask_grouped(ex, ey, valid, group):
    """First-occurrence mask (I, E) per draw group (render.rs:2586, scoped
    to one render_mesh_15 call): among the edges of one group with the
    same normalized endpoints, the first valid one survives; an invalid
    edge never blocks a later valid one.  A stable sort on (group, key,
    invalid), ties in edge order."""
    _, kx0, ky0, kx1, ky1 = _edge_key(ex, ey)
    inval = (~valid).to(torch.int32)
    grp = group.to(torch.int32).expand_as(kx0)
    keys = [grp, kx0, ky0, kx1, ky1, inval]
    order = _lexsort(keys)
    srt = [k.gather(1, order) for k in keys]
    same_prev = torch.ones_like(srt[0][:, 1:], dtype=torch.bool)
    for k in srt[:5]:
        same_prev &= k[:, 1:] == k[:, :-1]
    first = torch.cat([torch.ones_like(same_prev[:, :1]), ~same_prev], dim=1)
    keep_sorted = first & (srt[5] == 0)
    return torch.zeros_like(keep_sorted).scatter(1, order, keep_sorted)


def _dedup_mask(ex, ey, valid):
    """First-occurrence mask (I, E) over one mesh's edges
    (render.rs:2586): among the edges with the same normalized endpoints
    the first valid one survives.  The JAX package compares every pair;
    the grouped sort gives the same mask with one group."""
    return _dedup_mask_grouped(ex, ey, valid, torch.zeros(
        ex.shape[1], dtype=torch.int32, device=ex.device))


def _normalize_edge_order(ex, ey, ez):
    """The reference draws each edge from its lexically smaller endpoint
    (render.rs:2587-2591)."""
    flip = _edge_key(ex, ey)[0][..., None]
    return (torch.where(flip, ex.flip(-1), ex),
            torch.where(flip, ey.flip(-1), ey),
            torch.where(flip, ez.flip(-1), ez))


def _face_edges(c_sx, c_sy, c_sz, cam_z, valid, double_sided, fog_enabled,
                fog_cull_distance, settings: RasterSettings):
    """The edges of faces with screen corners (I, T, 3) in their original
    winding: (ex, ey (I, 3 T, 2) i32, ez (I, 3 T, 2) f32, back (I, 3 T),
    front (I, 3 T)), edges v1v2, v2v3, v3v1 of each face in face order
    (render.rs:2373-2513).  Back edges are those of valid back faces that
    are not double-sided (the reference draws double-sided parts without
    backface culling, which skips their backface phase,
    scene.rs:134-138), and none in x-ray mode; front edges those of valid
    front faces.  The near plane rejects a face (not under ortho) and fog
    culls whole faces (`fog_cull_distance` broadcasts against cam_z's
    faces)."""
    if settings.ortho_projection is None:
        near_ok = (cam_z > NEAR_PLANE).all(dim=-1)
    else:
        near_ok = torch.ones_like(cam_z[..., 0], dtype=torch.bool)
    signed_area = ((c_sx[..., 1] - c_sx[..., 0])
                   * (c_sy[..., 2] - c_sy[..., 0])
                   - (c_sx[..., 2] - c_sx[..., 0])
                   * (c_sy[..., 1] - c_sy[..., 0]))
    is_backface = signed_area <= 0.0
    fog_cull = fog_enabled & (cam_z > fog_cull_distance).all(dim=-1)
    common = valid & near_ok & ~fog_cull
    back_face = common & is_backface & ~double_sided
    if settings.xray_mode:
        back_face = torch.zeros_like(back_face)
    front_face = common & ~is_backface

    # v.x as i32 truncates toward zero (Rust's saturating cast)
    ix = f32_to_i32(torch.clamp(torch.trunc(c_sx), -2.0 ** 31, 2.0 ** 31 - 1))
    iy = f32_to_i32(torch.clamp(torch.trunc(c_sy), -2.0 ** 31, 2.0 ** 31 - 1))
    a, b = [0, 1, 2], [1, 2, 0]
    n, t = ix.shape[:2]
    ex = torch.stack([ix[..., a], ix[..., b]], dim=-1).reshape(n, 3 * t, 2)
    ey = torch.stack([iy[..., a], iy[..., b]], dim=-1).reshape(n, 3 * t, 2)
    ez = torch.stack([c_sz[..., a], c_sz[..., b]], dim=-1).reshape(n, 3 * t,
                                                                    2)
    return (ex, ey, ez, back_face.repeat_interleave(3, dim=-1),
            front_face.repeat_interleave(3, dim=-1))


def wireframe_edges_flat(scene, cams: CameraArrays,
                         settings: RasterSettings, width: int, height: int):
    """The edges of every face of a FlatScene for each camera of `cams`
    ((I,) CameraArrays), from the corners in their original winding (the
    wireframe phase reads vertices before the backface swap): `_face_edges`
    with the faces' own room fog, plus each edge's draw group (E,)."""
    cam = CameraArrays(position=cams.position[:, None, None, :],
                       basis=cams.basis[:, None, None, :, :])
    tv = transform_vertices(scene.cpos, cam, settings, width, height)
    faces, fog = scene.faces, scene.fog
    return _face_edges(tv.sx, tv.sy, tv.sz, tv.cam[..., 2], faces.valid,
                       faces.double_sided, fog.enabled,
                       fog.cull_distance[:, None], settings) + (
        scene.f_group.repeat_interleave(3),)


def wireframe_edges(mesh, faces, cams: CameraArrays, fog,
                    settings: RasterSettings, width: int, height: int):
    """The edges of one mesh's faces (render.rs:2373-2513) for each camera
    of `cams`: `_face_edges` under the mesh's fog."""
    cam = CameraArrays(position=cams.position[:, None, :],
                       basis=cams.basis[:, None, :, :])
    tv = transform_vertices(mesh.pos, cam, settings, width, height)
    vi = faces.vidx.long()
    return _face_edges(tv.sx[:, vi], tv.sy[:, vi], tv.sz[:, vi],
                       tv.cam[..., 2][:, vi], faces.valid,
                       faces.double_sided, fog.enabled, fog.cull_distance,
                       settings)


def wires_on(settings: RasterSettings) -> bool:
    """Whether the settings draw a wireframe pass (render.rs:2573-2633)."""
    return ((settings.backface_cull and settings.backface_wireframe)
            or settings.wireframe_overlay)


def render_wireframes_flat(color, depth, scene, cams: CameraArrays,
                           settings: RasterSettings,
                           max_steps: int = MAX_STEPS,
                           chunk: int = INSTANCE_CHUNK):
    """The wireframe passes over (I, H, W) frames of a FlatScene: the
    back edges, depth-tested against the inverse-z plane `depth` (with
    backface culling and backface wireframes on), then the front edges
    untested (`wireframe_overlay`).  Returns the new colour plane; depth
    is not written.

    Testing the back edges against the final depth plane equals the
    reference's per-group interleave of solids and wires only for one
    draw group (models/scene_flat.check_slice); the overlay runs with the
    solid passes skipped and is exact for any number of groups."""
    n, height, width = color.shape
    buf = torch.empty(n * height * width + 1, dtype=color.dtype,
                      device=color.device)
    buf[:-1] = color.reshape(-1)
    passes = []
    if settings.backface_cull and settings.backface_wireframe:
        passes.append((3, _pack_rgb(BACKFACE_COLOR), True))
    if settings.wireframe_overlay:
        passes.append((4, _pack_rgb(FRONTFACE_COLOR), False))
    for s in range(0, n, chunk):
        sub = CameraArrays(*(x[s:s + chunk] for x in cams))
        edges = wireframe_edges_flat(scene, sub, settings, width, height)
        ex, ey, ez, group = edges[0], edges[1], edges[2], edges[5]
        for which, word, tested in passes:
            m = _dedup_mask_grouped(ex, ey, edges[which], group)
            bx, by, bz = _normalize_edge_order(ex, ey, ez)
            scatter_lines(buf, depth, bx, by, bz, m, word, max_steps,
                           tested, s)
    return buf[:-1].reshape(n, height, width)


def render_wireframes(fb, mesh, faces, cams: CameraArrays, fog,
                      settings: RasterSettings, depth_mode: str = "harmonic",
                      max_steps: int = MAX_STEPS):
    """The WIREFRAME phase of one render_mesh_15 (render.rs:2573-2633)
    over (I, H, W) framebuffers: the back edges depth-tested against
    `fb.depth` (an inverse-z or a harmonic plane, `depth_mode`), then the
    front edges untested.  Returns the FrameBuffers; depth is not
    written."""
    n, height, width = fb.color.shape
    buf = torch.empty(n * height * width + 1, dtype=fb.color.dtype,
                      device=fb.color.device)
    buf[:-1] = fb.color.reshape(-1)
    ex, ey, ez, back, front = wireframe_edges(mesh, faces, cams, fog,
                                              settings, width, height)
    passes = []
    if settings.backface_cull and settings.backface_wireframe:
        passes.append((back, _pack_rgb(BACKFACE_COLOR), True))
    if settings.wireframe_overlay:
        passes.append((front, _pack_rgb(FRONTFACE_COLOR), False))
    for which, word, tested in passes:
        m = _dedup_mask(ex, ey, which)
        bx, by, bz = _normalize_edge_order(ex, ey, ez)
        scatter_lines(buf, fb.depth, bx, by, bz, m, word, max_steps, tested,
                       0, depth_mode)
    return FrameBuffers(color=buf[:-1].reshape(n, height, width),
                        depth=fb.depth)
