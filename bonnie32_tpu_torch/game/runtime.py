"""Game runtime shell: play-mode state, FPS limiting, camera modes
(bonnie32_tpu/game/runtime.py).

Reference behaviour: runtime.rs (FpsLimit :80-127, GameToolState :129-230,
orbit defaults target (512, 256, 512), distance 3000, azimuth 0.8,
elevation 0.3); the free-fly camera of renderer.rs:421-492 (fly 1500 u/s,
look sensitivity 2.5, pitch clamp +-1.5, Q/E vertical); the sleep + spin
frame pacing of main.rs:1640-1668.

The batched ECS (game/state.py) and the fused tick (game/step.py) are the
simulation; GameToolState holds ONE interactive instance of them (a batch
of one, on the card unless the caller names another device) with the
camera and menu bookkeeping of the play-mode tool.  Its cameras are
CameraArrays with a leading axis of 1.
"""

from __future__ import annotations

import dataclasses
import enum
import math
import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import HEIGHT, HEIGHT_HI, WIDTH, WIDTH_HI, RasterSettings
from ..input import Action, InputState
from ..models import build
from ..types import CameraArrays, resolve_device
from . import state as st
from . import step as gstep
from .collision import CollisionGrid, PlayerParams


class FpsLimit(enum.Enum):
    """runtime.rs:80 — 30 / 60 / unlocked, cycled in the options menu."""

    FPS30 = "30"
    FPS60 = "60"
    UNLOCKED = "Unlocked"

    def frame_time(self) -> Optional[float]:
        return {FpsLimit.FPS30: 1.0 / 30.0, FpsLimit.FPS60: 1.0 / 60.0,
                FpsLimit.UNLOCKED: None}[self]

    def next(self) -> "FpsLimit":
        order = [FpsLimit.FPS30, FpsLimit.FPS60, FpsLimit.UNLOCKED]
        return order[(order.index(self) + 1) % 3]

    def prev(self) -> "FpsLimit":
        order = [FpsLimit.FPS30, FpsLimit.FPS60, FpsLimit.UNLOCKED]
        return order[(order.index(self) - 1) % 3]

    @property
    def label(self) -> str:
        return self.value


class CameraMode(enum.Enum):
    CHARACTER = "character"
    FREEFLY = "freefly"


FLY_SPEED = 1500.0        # renderer.rs:429
LOOK_SENSITIVITY = 2.5    # renderer.rs:430
PITCH_CLAMP = 1.5         # renderer.rs:438


def _camera(position, basis, device) -> CameraArrays:
    """One host camera as CameraArrays with a leading axis of 1."""
    return CameraArrays(
        position=torch.tensor(np.asarray(position, np.float32),
                              device=device)[None],
        basis=torch.tensor(np.asarray(basis, np.float32),
                           device=device)[None])


@dataclasses.dataclass
class FreeflyCamera:
    """renderer.rs:421-492 — noclip camera, host state."""

    position: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32))
    yaw: float = 0.0
    pitch: float = 0.0

    def update(self, inp: InputState, dt: float,
               mouse_delta: Tuple[float, float] = (0.0, 0.0),
               rmb_down: bool = False) -> None:
        if rmb_down:
            self.yaw -= mouse_delta[0] * 0.005
            self.pitch = max(-PITCH_CLAMP,
                             min(self.pitch + mouse_delta[1] * 0.005,
                                 PITCH_CLAMP))
        rx, ry = inp.right_stick()
        if math.hypot(rx, ry) > 0.0:
            self.yaw -= rx * LOOK_SENSITIVITY * dt
            self.pitch = max(-PITCH_CLAMP,
                             min(self.pitch - ry * LOOK_SENSITIVITY * dt,
                                 PITCH_CLAMP))

        forward = np.array([math.cos(self.pitch) * math.sin(self.yaw),
                            -math.sin(self.pitch),
                            math.cos(self.pitch) * math.cos(self.yaw)],
                           np.float32)
        n = float(np.linalg.norm(forward))
        if n > 0:
            forward = forward / n
        right = np.array([math.cos(self.yaw), 0.0, -math.sin(self.yaw)],
                         np.float32)

        lx, ly = inp.left_stick()
        move = np.zeros(3, np.float32)
        if math.hypot(lx, ly) > 0.1:
            move += forward * np.float32(ly * FLY_SPEED * dt)
            move += right * np.float32(-lx * FLY_SPEED * dt)
        if inp.action_down(Action.FLY_UP):
            move[1] += FLY_SPEED * dt
        if inp.action_down(Action.FLY_DOWN):
            move[1] -= FLY_SPEED * dt
        self.position = self.position + move

    def camera(self, device=None) -> CameraArrays:
        """The camera, (1,) CameraArrays on `device` (default: the
        card)."""
        return _camera(self.position,
                       build.camera_basis(self.pitch, self.yaw),
                       resolve_device(device))


def viewport_fb_size(settings: RasterSettings, rect_w: float,
                     rect_h: float) -> Tuple[int, int]:
    """Framebuffer (width, height) of the game viewport (renderer.rs:
    34-49): stretch_to_fill keeps the vertical resolution (240 or 480 by
    `low_resolution`) and scales the width to the viewport's aspect;
    otherwise the fixed 4:3 PS1 resolutions 320x240 / 640x480."""
    if settings.stretch_to_fill:
        base_h = HEIGHT if settings.low_resolution else HEIGHT_HI
        scaled_w = int(base_h * (float(rect_w) / float(rect_h)))
        return max(scaled_w, 1), base_h
    if settings.low_resolution:
        return WIDTH, HEIGHT
    return WIDTH_HI, HEIGHT_HI


def present_rect(settings: RasterSettings, fb_w: int, fb_h: int,
                 rect_x: float, rect_y: float, rect_w: float,
                 rect_h: float) -> Tuple[float, float, float, float]:
    """Where (x, y, w, h) the framebuffer is drawn in the viewport
    (renderer.rs:183-199): the whole rect in stretch mode, else 4:3
    letterboxed or pillarboxed (bars rgb(10, 10, 12))."""
    if settings.stretch_to_fill:
        return rect_x, rect_y, rect_w, rect_h
    fb_aspect = float(fb_w) / float(fb_h)
    rect_aspect = rect_w / rect_h
    if fb_aspect > rect_aspect:
        w = rect_w
        h = rect_w / fb_aspect
        return rect_x, rect_y + (rect_h - h) * 0.5, w, h
    h = rect_h
    w = rect_h * fb_aspect
    return rect_x + (rect_w - w) * 0.5, rect_y, w, h


class FrameLimiter:
    """main.rs:1640-1668 — sleep-then-spin frame pacing."""

    def __init__(self, limit: FpsLimit = FpsLimit.FPS60,
                 sleep_fn=time.sleep, clock=time.perf_counter):
        self.limit = limit
        self._sleep = sleep_fn
        self._clock = clock
        self._frame_start = clock()

    def begin_frame(self) -> None:
        self._frame_start = self._clock()

    def end_frame(self) -> float:
        """Block until the frame budget elapses; returns the actual frame
        time.  Sleeps most of the wait, spins the last ~2 ms."""
        target = self.limit.frame_time()
        if target is None:
            return self._clock() - self._frame_start
        while True:
            elapsed = self._clock() - self._frame_start
            remaining = target - elapsed
            if remaining <= 0:
                return elapsed
            if remaining > 0.002:
                self._sleep(remaining - 0.002)


class GameToolState:
    """runtime.rs:129 — one interactive play-mode instance on `device`
    (default: the card)."""

    def __init__(self, grid: CollisionGrid, params: PlayerParams,
                 capacity: int = 64, device=None,
                 settings: Optional[RasterSettings] = None):
        self.device = resolve_device(device)
        self.grid = grid
        self.params = params
        self.settings = settings or RasterSettings.game()
        self.state = st.new_state(1, capacity, device=self.device)
        self.playing = False
        self.camera_mode = CameraMode.CHARACTER
        self.freefly = FreeflyCamera()
        # orbit defaults (runtime.rs:196-200)
        self.orbit_target = np.array([512.0, 256.0, 512.0], np.float32)
        self.orbit_distance = 3000.0
        self.orbit_azimuth = 0.8
        self.orbit_elevation = 0.3
        self.fps_limit = FpsLimit.FPS60
        self.options_menu_open = False
        self.show_debug_overlay = False
        self.debug_menu_selection = 0   # renderer.rs debug menu cursor
        self.camera_initialized = False

    def spawn_player(self, pos, hp: int = 100) -> int:
        self.state, e = st.spawn_player(self.state, pos, self.params, hp=hp)
        return int(e[0])

    def tick(self, inp: InputState, dt: float = 1.0 / 60.0,
             mouse_delta=(0.0, 0.0), rmb_down: bool = False) -> None:
        """Per-frame update: free-fly input or the fused character tick
        (runtime.rs:405 gates on `playing`)."""
        if not self.playing:
            return
        if self.camera_mode == CameraMode.FREEFLY:
            self.freefly.update(inp, dt, mouse_delta, rmb_down)
            return
        self.state = gstep.tick(self.state, self.grid, self.params,
                                inp.to_actions(self.device), dt)

    def camera(self) -> CameraArrays:
        """The view camera, (1,) CameraArrays on the state's device."""
        if self.camera_mode == CameraMode.FREEFLY:
            return self.freefly.camera(self.device)
        if int(self.state.player[0]) >= 0:
            return gstep.character_camera(self.state, self.params)
        # orbit fallback (before the player spawns)
        az, el, d = (self.orbit_azimuth, self.orbit_elevation,
                     self.orbit_distance)
        offset = np.array([math.sin(az) * math.cos(el), math.sin(el),
                           math.cos(az) * math.cos(el)], np.float32) * -d
        return _camera(self.orbit_target + offset,
                       build.camera_basis(el, az), self.device)

    def toggle_camera_mode(self) -> None:
        if self.camera_mode == CameraMode.CHARACTER:
            cam = self.camera()
            self.freefly.position = cam.position[0].cpu().numpy().astype(
                np.float32)
            self.freefly.yaw = float(self.state.char_cam_yaw[0])
            self.freefly.pitch = float(self.state.char_cam_pitch[0])
            self.camera_mode = CameraMode.FREEFLY
        else:
            self.camera_mode = CameraMode.CHARACTER
