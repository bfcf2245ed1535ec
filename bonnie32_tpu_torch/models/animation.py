"""Rigged models: bones, parts, keyframe animation, skeleton visualization
(bonnie32_tpu/models/animation.py).

Reference behavior (the reference's `src/modeler/`):
  * Animation / Keyframe / BoneTransform (lerp) — `model.rs:15-112`.
  * RiggedModel / RigBone / RigPart — `state.rs:264-402`.
  * rotate_by_euler (X-then-Z, Y ignored) / inverse — `state.rs:30-82`.
  * bone_world_transform / bone_tip_position / octahedron triangles —
    `skeleton.rs:482-661`.

The model classes are host data, copied from the JAX package.
`rotate_by_euler`, `pose_bones` and `bone_tips` take tensors and run on
their device (`bones_to_arrays` gives CPU tensors, like models/build):
the bones fold their parents' transforms in topological order, batched
over any leading axes of the pose offsets.  The functions that return
host data (`bone_world_transform`, `bone_tip_position`,
`skeleton_to_triangles`) run their pose math on the CPU, so the skeleton
geometry a card draws is the geometry the CPU draws (torch's sin and cos
differ by ulps between the card and the CPU).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..io.ron import Tag, wrap_some
from ..ops.fixed import sqrt_rn
from ..types import as_f32, device_of
from .mesh import EditableMesh


BONE_DEFAULT_WIDTH = 40.0
BONE_COLOR_ROOT = (255, 220, 100)     # skeleton.rs:29
BONE_COLOR_DEFAULT = (200, 200, 200)  # skeleton.rs:13


# ---------------------------------------------------------------------------
# Euler rotation (state.rs:30-82): X (pitch) first, then Z (yaw); Y unused.
# ---------------------------------------------------------------------------

def _cos_sin(rotation_deg, device):
    r = torch.deg2rad(as_f32(rotation_deg, device))
    return (torch.cos(r[..., 0]), torch.sin(r[..., 0]),
            torch.cos(r[..., 2]), torch.sin(r[..., 2]))


def rotate_by_euler(v, rotation_deg):
    """state.rs:30 — broadcastable over (..., 3) tensors, on their
    device."""
    dev = device_of(v, rotation_deg)
    v = as_f32(v, dev)
    cx, sx, cz, sz = _cos_sin(rotation_deg, dev)
    x1 = v[..., 0]
    y1 = v[..., 1] * cx + v[..., 2] * sx
    z1 = -v[..., 1] * sx + v[..., 2] * cx
    x2 = x1 * cz + y1 * sz
    y2 = -x1 * sz + y1 * cz
    return torch.stack(torch.broadcast_tensors(x2, y2, z1), dim=-1)


def inverse_rotate_by_euler(v, rotation_deg):
    """state.rs:58 — (-Z) then (-X)."""
    dev = device_of(v, rotation_deg)
    v = as_f32(v, dev)
    cx, sx, cz, sz = _cos_sin(rotation_deg, dev)
    x1 = v[..., 0] * cz - v[..., 1] * sz
    y1 = v[..., 0] * sz + v[..., 1] * cz
    z1 = v[..., 2]
    y2 = y1 * cx - z1 * sx
    z2 = y1 * sx + z1 * cx
    return torch.stack(torch.broadcast_tensors(x1, y2, z2), dim=-1)


# ---------------------------------------------------------------------------
# Animation data model (model.rs)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BoneTransform:
    """model.rs:88 — local position + euler degrees."""

    position: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    rotation: Tuple[float, float, float] = (0.0, 0.0, 0.0)

    def lerp(self, other: "BoneTransform", t: float) -> "BoneTransform":
        """model.rs:98 — straight componentwise lerp (including angles)."""
        p = tuple(a + (b - a) * t for a, b in zip(self.position,
                                                  other.position))
        r = tuple(a + (b - a) * t for a, b in zip(self.rotation,
                                                  other.rotation))
        return BoneTransform(position=p, rotation=r)

    @classmethod
    def from_ron(cls, d):
        if d is None:
            return cls()
        return cls(position=tuple(float(x) for x in d.get("position",
                                                          (0, 0, 0))),
                   rotation=tuple(float(x) for x in d.get("rotation",
                                                          (0, 0, 0))))

    def to_ron(self):
        return {"position": list(self.position),
                "rotation": list(self.rotation)}


@dataclasses.dataclass
class Keyframe:
    """model.rs:71 — one transform per bone."""

    frame: int
    transforms: List[BoneTransform]

    @classmethod
    def new(cls, frame: int, num_bones: int) -> "Keyframe":
        return cls(frame=frame,
                   transforms=[BoneTransform() for _ in range(num_bones)])

    @classmethod
    def from_ron(cls, d):
        return cls(frame=int(d["frame"]),
                   transforms=[BoneTransform.from_ron(t)
                               for t in d.get("transforms", [])])

    def to_ron(self):
        return {"frame": self.frame,
                "transforms": [t.to_ron() for t in self.transforms]}


@dataclasses.dataclass
class Animation:
    """model.rs:15 — named clip, keyframes sorted by frame."""

    name: str = "Action"
    fps: int = 15
    looping: bool = True
    keyframes: List[Keyframe] = dataclasses.field(default_factory=list)

    def last_frame(self) -> int:
        return self.keyframes[-1].frame if self.keyframes else 0

    def duration(self) -> float:
        return self.last_frame() / float(self.fps)

    def get_keyframe(self, frame: int) -> Optional[Keyframe]:
        for kf in self.keyframes:
            if kf.frame == frame:
                return kf
        return None

    def set_keyframe(self, keyframe: Keyframe) -> None:
        """model.rs:53 — insert-or-replace, kept sorted."""
        existing = self.get_keyframe(keyframe.frame)
        if existing is not None:
            idx = self.keyframes.index(existing)
            self.keyframes[idx] = keyframe
        else:
            self.keyframes.append(keyframe)
            self.keyframes.sort(key=lambda kf: kf.frame)

    def remove_keyframe(self, frame: int) -> None:
        self.keyframes = [kf for kf in self.keyframes if kf.frame != frame]

    def sample(self, time_s: float) -> List[BoneTransform]:
        """Pose at `time_s`: lerp between bracketing keyframes; loops when
        `looping` (wraps at duration), else clamps to the last frame."""
        if not self.keyframes:
            return []
        last = self.last_frame()
        frame_f = time_s * self.fps
        if last > 0:
            frame_f = (frame_f % last) if self.looping \
                else min(frame_f, float(last))
        else:
            frame_f = 0.0
        prev = self.keyframes[0]
        nxt = self.keyframes[-1]
        for kf in self.keyframes:
            if kf.frame <= frame_f:
                prev = kf
        for kf in reversed(self.keyframes):
            if kf.frame >= frame_f:
                nxt = kf
        if nxt.frame == prev.frame:
            return list(prev.transforms)
        t = (frame_f - prev.frame) / float(nxt.frame - prev.frame)
        n = max(len(prev.transforms), len(nxt.transforms))
        out = []
        for i in range(n):
            a = prev.transforms[i] if i < len(prev.transforms) \
                else BoneTransform()
            b = nxt.transforms[i] if i < len(nxt.transforms) \
                else BoneTransform()
            out.append(a.lerp(b, t))
        return out

    @classmethod
    def from_ron(cls, d):
        return cls(name=d.get("name", "Action"), fps=int(d.get("fps", 15)),
                   looping=bool(d.get("looping", True)),
                   keyframes=[Keyframe.from_ron(k)
                              for k in d.get("keyframes", [])])

    def to_ron(self):
        return {"name": self.name, "fps": self.fps, "looping": self.looping,
                "keyframes": [k.to_ron() for k in self.keyframes]}


# ---------------------------------------------------------------------------
# Rig (state.rs:264-402)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RigBone:
    """state.rs:326."""

    name: str = ""
    parent: Optional[int] = None
    local_position: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    local_rotation: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    length: float = 20.0
    width: float = 0.0

    def display_width(self) -> float:
        """state.rs:369 — auto width = 15% of length, clamped 20..200."""
        if self.width > 0.0:
            return self.width
        return min(max(self.length * 0.15, 20.0), 200.0)

    @classmethod
    def from_ron(cls, d):
        p = d.get("parent")
        if isinstance(p, Tag):
            p = p.value if p.name == "Some" else None
        return cls(name=d.get("name", ""),
                   parent=int(p) if p is not None else None,
                   local_position=tuple(float(x) for x in
                                        d.get("local_position", (0, 0, 0))),
                   local_rotation=tuple(float(x) for x in
                                        d.get("local_rotation", (0, 0, 0))),
                   length=float(d.get("length", 20.0)),
                   width=float(d.get("width", 0.0)))

    def to_ron(self):
        return {"name": self.name,
                "parent": wrap_some(self.parent) if self.parent is not None
                else None,
                "local_position": list(self.local_position),
                "local_rotation": list(self.local_rotation),
                "length": self.length, "width": self.width}


@dataclasses.dataclass
class RigPart:
    """state.rs:380 — geometry following a bone."""

    name: str = ""
    bone_index: Optional[int] = None
    mesh: EditableMesh = dataclasses.field(default_factory=EditableMesh)
    pivot: Tuple[float, float, float] = (0.0, 0.0, 0.0)


@dataclasses.dataclass
class RiggedModel:
    """state.rs:264."""

    name: str = ""
    skeleton: List[RigBone] = dataclasses.field(default_factory=list)
    parts: List[RigPart] = dataclasses.field(default_factory=list)
    animations: List[Animation] = dataclasses.field(
        default_factory=lambda: [Animation()])

    @classmethod
    def from_mesh(cls, name: str, mesh: EditableMesh) -> "RiggedModel":
        return cls(name=name,
                   parts=[RigPart(name="root", mesh=mesh)])


# ---------------------------------------------------------------------------
# Bone posing (skeleton.rs:482-531)
# ---------------------------------------------------------------------------

def bone_world_transform(bones: List[RigBone], bone_idx: int,
                         pose: Optional[List[BoneTransform]] = None):
    """skeleton.rs:482 — fold local transforms root->leaf.

    Rotation composes by ADDITION of euler degrees (the reference's
    convention); positions rotate by the accumulated parent rotation.
    Optional `pose` offsets add to each bone's bind-pose locals.  Host
    data in and out: the rotation runs on the CPU.
    """
    position = np.zeros(3, np.float32)
    rotation = np.zeros(3, np.float32)
    chain = []
    cur = bone_idx
    while cur is not None:
        chain.append(cur)
        cur = bones[cur].parent
    for idx in reversed(chain):
        b = bones[idx]
        lp = np.asarray(b.local_position, np.float32)
        lr = np.asarray(b.local_rotation, np.float32)
        if pose is not None and idx < len(pose):
            lp = lp + np.asarray(pose[idx].position, np.float32)
            lr = lr + np.asarray(pose[idx].rotation, np.float32)
        position = position + rotate_by_euler(
            torch.from_numpy(lp), torch.from_numpy(rotation)).numpy()
        rotation = rotation + lr
    return position, rotation


def bone_tip_position(bones: List[RigBone], bone_idx: int,
                      pose: Optional[List[BoneTransform]] = None):
    """skeleton.rs:511 — tip = base + length along the rotated +Y bone
    axis (direction from the accumulated x/z rotation)."""
    base, rot = bone_world_transform(bones, bone_idx, pose)
    rx = math.radians(float(rot[0]))
    rz = math.radians(float(rot[2]))
    cx = math.cos(rx)
    d = np.array([math.sin(rz) * cx, math.cos(rz) * cx, -math.sin(rx)],
                 np.float32)
    n = float(np.linalg.norm(d))
    if n > 0:
        d = d / n
    return base + d * np.float32(bones[bone_idx].length)


def bones_to_arrays(bones: List[RigBone]):
    """CPU tensors (parent i32 w/ -1 root, locals, lengths), like
    models/build's; bones must already be parent-before-child (the editor
    appends children after parents, so file order satisfies this)."""
    n = len(bones)
    parent = np.full(n, -1, np.int32)
    lp = np.zeros((n, 3), np.float32)
    lr = np.zeros((n, 3), np.float32)
    ln = np.zeros(n, np.float32)
    for i, b in enumerate(bones):
        if b.parent is not None:
            assert b.parent < i, "bones must be parent-before-child"
            parent[i] = b.parent
        lp[i] = b.local_position
        lr[i] = b.local_rotation
        ln[i] = b.length
    return (torch.from_numpy(parent), torch.from_numpy(lp),
            torch.from_numpy(lr), torch.from_numpy(ln))


def pose_bones(parent, local_pos, local_rot, pose_pos=None, pose_rot=None):
    """Vectorized bone_world_transform for ALL bones: a sequential fold in
    topological order over the bones (counts are small, <= ~32), on the
    device of `local_pos`.  Pose offsets (..., B, 3) batch animation
    frames.  Returns (world_pos (..., B, 3), world_rot (..., B, 3)
    degrees).  The parents are the rig's topology: read once on the
    host."""
    dev = device_of(local_pos, local_rot, pose_pos, pose_rot)
    parents = [int(p) for p in torch.as_tensor(parent).reshape(-1).tolist()]
    lp = as_f32(local_pos, dev)
    lr = as_f32(local_rot, dev)
    if pose_pos is not None:
        lp = lp + as_f32(pose_pos, dev)
    if pose_rot is not None:
        lr = lr + as_f32(pose_rot, dev)
    lp, lr = torch.broadcast_tensors(lp, lr)
    zero = torch.zeros_like(lp[..., 0, :])
    world_pos = []
    world_rot = []
    for i, p in enumerate(parents):
        pp = world_pos[p] if p >= 0 else zero
        pr = world_rot[p] if p >= 0 else zero
        world_pos.append(pp + rotate_by_euler(lp[..., i, :], pr))
        world_rot.append(pr + lr[..., i, :])
    return torch.stack(world_pos, dim=-2), torch.stack(world_rot, dim=-2)


def bone_tips(world_pos, world_rot, lengths):
    """Vectorized tip positions (skeleton.rs:511), on the device of
    `world_pos`."""
    dev = device_of(world_pos, world_rot, lengths)
    r = torch.deg2rad(as_f32(world_rot, dev))
    cx = torch.cos(r[..., 0])
    d = torch.stack([torch.sin(r[..., 2]) * cx, torch.cos(r[..., 2]) * cx,
                     -torch.sin(r[..., 0])], dim=-1)
    norm = sqrt_rn(d[..., 0:1] * d[..., 0:1] + d[..., 1:2] * d[..., 1:2]
                      + d[..., 2:3] * d[..., 2:3])
    d = d / torch.where(norm == 0, torch.ones_like(norm), norm)
    return as_f32(world_pos, dev) + d * as_f32(lengths, dev)[..., None]


# ---------------------------------------------------------------------------
# Skeleton visualization (skeleton.rs:534-661)
# ---------------------------------------------------------------------------

def _perp_axes(d):
    """skeleton.rs:257."""
    up = np.array([0.0, 1.0, 0.0], np.float32) if abs(d[1]) < 0.9 \
        else np.array([1.0, 0.0, 0.0], np.float32)
    p1 = np.cross(d, up)
    p1 = p1 / np.linalg.norm(p1)
    p2 = np.cross(d, p1)
    p2 = p2 / np.linalg.norm(p2)
    return p1, p2


def skeleton_to_triangles(bones: List[RigBone], alpha: int = 255,
                          pose: Optional[List[BoneTransform]] = None):
    """skeleton.rs:534 — octahedron per bone (base + tip + 4-vertex ring at
    20% length), root bones yellow.  Golden-model-format (verts, faces)."""
    verts = []
    faces = []
    for idx, bone in enumerate(bones):
        color = BONE_COLOR_ROOT if bone.parent is None else BONE_COLOR_DEFAULT
        base, _ = bone_world_transform(bones, idx, pose)
        tip = bone_tip_position(bones, idx, pose)
        direction = tip - base
        length = float(np.linalg.norm(direction))
        if length < 0.001:
            continue
        dn = direction / length
        p1, p2 = _perp_axes(dn)
        width = bone.display_width()
        ring_center = base + dn * (length * 0.2)
        ring = [ring_center + p1 * width, ring_center + p2 * width,
                ring_center - p1 * width, ring_center - p2 * width]
        v0 = len(verts)

        def vert(pos, normal):
            verts.append(dict(pos=tuple(float(x) for x in pos), uv=(0.0, 0.0),
                              normal=tuple(float(x) for x in normal),
                              color=color, color_blend=0))
        vert(base, -dn)
        vert(tip, dn)
        for rp in ring:
            rn = rp - ring_center
            rn = rn / np.linalg.norm(rn)
            vert(rp, rn)
        for i in range(4):
            nx = (i + 1) % 4
            faces.append(dict(v0=v0, v1=v0 + 2 + i, v2=v0 + 2 + nx,
                              tex_id=None, black_transparent=False,
                              blend_mode=0, editor_alpha=alpha))
        for i in range(4):
            nx = (i + 1) % 4
            faces.append(dict(v0=v0 + 1, v1=v0 + 2 + nx, v2=v0 + 2 + i,
                              tex_id=None, black_transparent=False,
                              blend_mode=0, editor_alpha=alpha))
    return verts, faces
