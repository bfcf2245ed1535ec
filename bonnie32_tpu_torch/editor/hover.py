"""Viewport hover detection: vertex > edge > face priority resolution.
(The port's own copy of the JAX package's `editor/hover.py`, host code.)

Reference behavior: `src/editor/viewport_3d.rs` — screen
thresholds (vertex 6 px, edge 4 px, object 12 px; :7038-7041, :7341),
quad hit testing via projected corners, and the depth-tolerance priority
rule (:7283-7317): sort candidates by depth, then among candidates within
1% of the closest depth the lower type (vertex=0 < edge=1 < face=2) wins.

Headless core: callers provide candidate quads (4 world corners + a tag);
this module projects them with ops/picking.world_to_screen and returns
the winning (kind, tag, extra) hit.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

from ..ops import picking as pk

VERTEX_THRESHOLD = 6.0   # px (viewport_3d.rs:7038)
EDGE_THRESHOLD = 4.0     # px (:7039)
OBJECT_THRESHOLD = 12.0  # px (:7341)
DEPTH_TOLERANCE_PERCENT = 0.01  # (:7286)


@dataclasses.dataclass
class HoverResult:
    kind: Optional[str] = None      # "vertex" | "edge" | "face"
    tag: Any = None                 # caller's quad tag
    corner: int = -1                # vertex index 0..3
    edge: int = -1                  # edge index 0..3
    depth: float = float("inf")
    screen_dist: float = float("inf")


def _project_quads(quads: Sequence[Tuple[Any, np.ndarray]], cam_pos, basis,
                   width: int, height: int):
    corners = np.stack([np.asarray(q[1], np.float32) for q in quads])
    flat = corners.reshape(-1, 3)
    sx, sy, cz, ok = pk.world_to_screen(flat, cam_pos, basis, width, height)
    return (np.asarray(sx).reshape(-1, 4), np.asarray(sy).reshape(-1, 4),
            np.asarray(cz).reshape(-1, 4), np.asarray(ok).reshape(-1, 4))


def detect_hover(mouse_x: float, mouse_y: float,
                 quads: Sequence[Tuple[Any, np.ndarray]],
                 cam_pos, basis, width: int, height: int) -> HoverResult:
    """quads: [(tag, (4, 3) world corners), ...] in draw order.

    Vertex hits within 6 px, edge hits within 4 px of the projected
    segment, face hits by point-in-quad (two triangles).  Nearest depth
    wins within each type; the 1% depth-tolerance priority rule resolves
    across types.
    """
    result = HoverResult()
    if not quads:
        return result
    sx, sy, cz, ok = _project_quads(quads, cam_pos, basis, width, height)

    best = {"vertex": (np.inf, None), "edge": (np.inf, None),
            "face": (np.inf, None)}

    for qi, (tag, _) in enumerate(quads):
        if not ok[qi].all():
            continue
        xs, ys, zs = sx[qi], sy[qi], cz[qi]

        # vertices
        d = np.hypot(xs - mouse_x, ys - mouse_y)
        ci = int(np.argmin(d))
        if d[ci] <= VERTEX_THRESHOLD and zs[ci] < best["vertex"][0]:
            best["vertex"] = (float(zs[ci]),
                              (tag, ci, float(d[ci])))

        # edges (0..3 = corner i -> i+1)
        for e in range(4):
            j = (e + 1) % 4
            dist = float(pk.point_to_segment_distance(
                mouse_x, mouse_y, xs[e], ys[e], xs[j], ys[j]))
            depth = float((zs[e] + zs[j]) / 2.0)
            if dist <= EDGE_THRESHOLD and depth < best["edge"][0]:
                best["edge"] = (depth, (tag, e, dist))

        # face: point in either triangle of the quad
        in_a = bool(pk.point_in_triangle_2d(mouse_x, mouse_y, xs[0], ys[0],
                                            xs[1], ys[1], xs[2], ys[2]))
        in_b = bool(pk.point_in_triangle_2d(mouse_x, mouse_y, xs[0], ys[0],
                                            xs[2], ys[2], xs[3], ys[3]))
        if in_a or in_b:
            depth = float(np.mean(zs))
            if depth < best["face"][0]:
                best["face"] = (depth, (tag,))

    # priority resolution (viewport_3d.rs:7283-7317)
    candidates = [(best[k][0], t, k) for t, k in
                  ((0, "vertex"), (1, "edge"), (2, "face"))
                  if best[k][1] is not None]
    if not candidates:
        return result
    candidates.sort(key=lambda c: c[0])
    closest = candidates[0][0]
    tol = closest * DEPTH_TOLERANCE_PERCENT
    within = [c for c in candidates if abs(c[0] - closest) < tol] \
        or [candidates[0]]
    _, _, kind = min(within, key=lambda c: c[1])

    depth, payload = best[kind]
    result.kind = kind
    result.tag = payload[0]
    result.depth = depth
    if kind == "vertex":
        result.corner = payload[1]
        result.screen_dist = payload[2]
    elif kind == "edge":
        result.edge = payload[1]
        result.screen_dist = payload[2]
    return result


def detect_object_hover(mouse_x: float, mouse_y: float,
                        positions: Sequence[Tuple[Any, np.ndarray]],
                        cam_pos, basis, width: int,
                        height: int) -> Optional[Tuple[Any, float]]:
    """Gizmo-style object pick: nearest projected position within 12 px
    (viewport_3d.rs:7341)."""
    bests = None
    for tag, pos in positions:
        sx, sy, cz, ok = pk.world_to_screen(np.asarray(pos, np.float32),
                                            cam_pos, basis, width, height)
        if not bool(ok):
            continue
        d = float(np.hypot(float(sx) - mouse_x, float(sy) - mouse_y))
        if d <= OBJECT_THRESHOLD and (bests is None or d < bests[1]):
            bests = (tag, d)
    return bests
