"""3D drag state machine (ui/drag_tracker.rs:29-260); the port's own copy
of the JAX package's `ui/drag_tracker.py`.

DragState holds drag-start anchors (positions, angles, camera snapshot);
DragConfig selects the picker (screen / line / plane / circle) and grid
snapping.  `update()` advances the drag with a mouse ray, constraining via
the port's ops/picking ray queries — the same geometry the reference uses.
The ray queries run on the device of the camera basis (a tensor on the
card keeps them there); only their scalar results come back to the host,
where the snapping and the f32 state stay numpy as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops import picking as pk
from ..types import as_f32, device_of


def _as_numpy(x) -> np.ndarray:
    """A tensor, array or sequence as an f32 numpy array on the host."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


@dataclasses.dataclass
class DragState:
    """drag_tracker.rs:29."""

    initial_position: np.ndarray
    current_position: np.ndarray
    handle_offset: np.ndarray
    initial_mouse: Tuple[float, float]
    current_mouse: Tuple[float, float]
    initial_angle: float = 0.0
    current_angle: float = 0.0
    center_screen: Tuple[float, float] = (0.0, 0.0)
    start_camera: Optional[tuple] = None       # (pos (3,), basis (3,3))
    start_viewport: Optional[Tuple[int, int]] = None

    @classmethod
    def new(cls, initial_position, handle_offset, initial_mouse):
        p = np.asarray(initial_position, np.float32)
        return cls(initial_position=p, current_position=p.copy(),
                   handle_offset=np.asarray(handle_offset, np.float32),
                   initial_mouse=tuple(initial_mouse),
                   current_mouse=tuple(initial_mouse))

    @classmethod
    def new_rotation(cls, center, initial_angle, initial_mouse,
                     center_screen, camera=None, viewport=None):
        p = np.asarray(center, np.float32)
        return cls(initial_position=p, current_position=p.copy(),
                   handle_offset=np.zeros(3, np.float32),
                   initial_mouse=tuple(initial_mouse),
                   current_mouse=tuple(initial_mouse),
                   initial_angle=float(initial_angle),
                   current_angle=float(initial_angle),
                   center_screen=tuple(center_screen),
                   start_camera=camera, start_viewport=viewport)

    def position_delta(self) -> np.ndarray:
        return self.current_position - self.initial_position

    def angle_delta(self) -> float:
        return self.current_angle - self.initial_angle

    def mouse_delta(self) -> Tuple[float, float]:
        return (self.current_mouse[0] - self.initial_mouse[0],
                self.current_mouse[1] - self.initial_mouse[1])

    def reset_initial(self) -> None:
        """drag_tracker.rs:144 — re-anchor mid-drag."""
        self.initial_position = self.current_position.copy()
        self.initial_mouse = self.current_mouse
        self.initial_angle = self.current_angle


@dataclasses.dataclass
class DragConfig:
    """drag_tracker.rs:203 — picker + snapping."""

    picker: str = "screen"      # screen | line | plane | circle
    sensitivity: float = 1.0
    origin: Optional[np.ndarray] = None
    direction: Optional[np.ndarray] = None   # line dir / plane normal / axis
    ref_vector: Optional[np.ndarray] = None  # circle angle-0 reference
    snap_mode: str = "none"     # none | relative | absolute
    grid_size: float = 1.0

    @classmethod
    def line(cls, origin, direction) -> "DragConfig":
        return cls(picker="line", origin=np.asarray(origin, np.float32),
                   direction=np.asarray(direction, np.float32))

    @classmethod
    def plane(cls, origin, normal) -> "DragConfig":
        return cls(picker="plane", origin=np.asarray(origin, np.float32),
                   direction=np.asarray(normal, np.float32))

    @classmethod
    def circle(cls, center, axis, ref_vector) -> "DragConfig":
        return cls(picker="circle", origin=np.asarray(center, np.float32),
                   direction=np.asarray(axis, np.float32),
                   ref_vector=np.asarray(ref_vector, np.float32))

    def with_snap(self, grid_size: float) -> "DragConfig":
        return dataclasses.replace(self, snap_mode="relative",
                                   grid_size=grid_size)

    def with_absolute_snap(self, grid_size: float) -> "DragConfig":
        return dataclasses.replace(self, snap_mode="absolute",
                                   grid_size=grid_size)

    def _snap_scalar(self, v: float, initial: float) -> float:
        g = self.grid_size
        if self.snap_mode == "absolute":
            return round(v / g) * g
        if self.snap_mode == "relative":
            return initial + round((v - initial) / g) * g
        return v

    def update(self, state: DragState, mouse_x: float, mouse_y: float,
               cam_pos, cam_basis, width: int, height: int) -> DragState:
        """Advance the drag from a new mouse position.

        screen: position moves by mouse delta * sensitivity in the camera
        plane; line/plane: ray-constrained via ops/picking; circle: angle
        from ray-circle intersection.
        """
        state.current_mouse = (mouse_x, mouse_y)
        dev = device_of(cam_basis, cam_pos)
        o, d = pk.screen_to_ray(mouse_x, mouse_y, width, height,
                                as_f32(cam_pos, dev), as_f32(cam_basis, dev))
        basis = _as_numpy(cam_basis)

        if self.picker == "line":
            point, s, ok = pk.ray_line_closest_point(o, d, self.origin,
                                                     self.direction)
            if bool(ok):
                s = self._snap_scalar(float(s), 0.0)
                state.current_position = (
                    self.origin + self.direction * np.float32(s)
                    - state.handle_offset)
        elif self.picker == "plane":
            t, ok = pk.ray_plane_intersection(o, d, self.origin,
                                              self.direction)
            if bool(ok):
                hit = _as_numpy(pk.ray_at(o, d, t))
                p = hit - state.handle_offset
                if self.snap_mode != "none":
                    p = np.asarray(
                        [self._snap_scalar(float(p[i]),
                                           float(state.initial_position[i]))
                         for i in range(3)], np.float32)
                state.current_position = p
        elif self.picker == "circle":
            ang, ok = pk.ray_circle_angle(o, d, self.origin, self.direction,
                                          self.ref_vector)
            if bool(ok):
                a = float(ang)
                if self.snap_mode != "none":
                    a = self._snap_scalar(a, state.initial_angle)
                state.current_angle = a
        else:  # screen: camera-plane translation by mouse delta
            dx, dy = state.mouse_delta()
            s = self.sensitivity
            state.current_position = (
                state.initial_position
                + basis[0] * np.float32(dx * s)
                + basis[1] * np.float32(dy * s))
            if self.snap_mode != "none":
                state.current_position = np.asarray(
                    [self._snap_scalar(float(state.current_position[i]),
                                       float(state.initial_position[i]))
                     for i in range(3)], np.float32)
        return state
