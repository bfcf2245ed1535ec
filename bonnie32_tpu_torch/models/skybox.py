"""Procedural Spyro-style skybox: config, sampling and mesh generation
(the port's own copy of the JAX package's `models/skybox.py`, which is
numpy only).

Host-side mirror of the Skybox system in the reference's `src/world/
geometry.rs:98-1026`: four-stop vertical gradient with horizontal tint,
horizon haze, sun/moon orbs with glow, two wispy cloud layers, two 3D
mountain ranges as peaked geometry on the sky sphere, and a star field.

`sample_at_direction` / `generate_mesh` follow the reference formulas in
float32; exact trig rounding is libm-defined, so the sky is
appearance-faithful rather than bit-exact (documented divergence — it is a
background gradient).  The four shipped presets are reproduced.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np

from ..io.ron import Tag

F32 = np.float32
PI = math.pi

_DIR_ANGLES = {"East": 0.0, "North": PI / 2, "West": PI, "South": 3 * PI / 2}


def _unwrap(v):
    """Unwrap a Some(...) tag — in-memory to_ron dicts carry them; the RON
    parser unwraps on load."""
    if isinstance(v, Tag) and v.name == "Some":
        return v.value
    return v


def _rgb(d, default):
    if d is None:
        return default
    return (int(d["r"]), int(d["g"]), int(d["b"]))


def _rgb_ron(c):
    return {"r": int(c[0]), "g": int(c[1]), "b": int(c[2])}


def _dir_ron(angle: float) -> Tag:
    """Nearest cardinal Direction tag for a tint angle (inverts
    _DIR_ANGLES for serialization)."""
    best = min(_DIR_ANGLES.items(),
               key=lambda kv: abs((kv[1] - float(angle) + PI)
                                  % (2 * PI) - PI))
    return Tag(best[0])


def _lerp_rgb(a, b, t):
    t = min(max(float(t), 0.0), 1.0)
    inv = 1.0 - t
    return (int(a[0] * inv + b[0] * t), int(a[1] * inv + b[1] * t),
            int(a[2] * inv + b[2] * t))


@dataclasses.dataclass
class CelestialBody:
    enabled: bool = False
    azimuth: float = PI
    elevation: float = 0.2
    size: float = 0.1
    color: Tuple[int, int, int] = (255, 250, 220)
    glow_color: Tuple[int, int, int] = (255, 200, 100)
    glow_falloff: float = 2.5

    @classmethod
    def from_ron(cls, d):
        if d is None:
            return cls()
        return cls(enabled=bool(d.get("enabled", False)),
                   azimuth=float(d.get("azimuth", PI)),
                   elevation=float(d.get("elevation", 0.2)),
                   size=float(d.get("size", 0.1)),
                   color=_rgb(d.get("color"), (255, 250, 220)),
                   glow_color=_rgb(d.get("glow_color"), (255, 200, 100)),
                   glow_falloff=float(d.get("glow_falloff", 2.5)))

    def to_ron(self):
        return {"enabled": self.enabled, "azimuth": F32(self.azimuth),
                "elevation": F32(self.elevation), "size": F32(self.size),
                "color": _rgb_ron(self.color),
                "glow_color": _rgb_ron(self.glow_color),
                "glow_falloff": F32(self.glow_falloff)}


@dataclasses.dataclass
class CloudLayer:
    height: float = 0.42
    thickness: float = 0.06
    color: Tuple[int, int, int] = (255, 230, 200)
    opacity: float = 0.4
    scroll_speed: float = 0.02
    wispiness: float = 0.7
    density: float = 1.0
    phase: float = 0.0

    @classmethod
    def from_ron(cls, d):
        d = _unwrap(d)
        if d is None:
            return None
        return cls(height=float(d.get("height", 0.42)),
                   thickness=float(d.get("thickness", 0.06)),
                   color=_rgb(d.get("color"), (255, 230, 200)),
                   opacity=float(d.get("opacity", 0.4)),
                   scroll_speed=float(d.get("scroll_speed", 0.02)),
                   wispiness=float(d.get("wispiness", 0.7)),
                   density=float(d.get("density", 1.0)),
                   phase=float(d.get("phase", 0.0)))

    def to_ron(self):
        return {"height": F32(self.height),
                "thickness": F32(self.thickness),
                "color": _rgb_ron(self.color),
                "opacity": F32(self.opacity),
                "scroll_speed": F32(self.scroll_speed),
                "wispiness": F32(self.wispiness),
                "density": F32(self.density), "phase": F32(self.phase)}


@dataclasses.dataclass
class MountainRange:
    lit_color: Tuple[int, int, int] = (140, 120, 160)
    shadow_color: Tuple[int, int, int] = (60, 50, 80)
    highlight_color: Tuple[int, int, int] = (200, 180, 220)
    height: float = 0.15
    depth: float = 0.5
    jaggedness: float = 0.5
    seed: int = 12345

    @classmethod
    def from_ron(cls, d):
        d = _unwrap(d)
        if d is None:
            return None
        return cls(lit_color=_rgb(d.get("lit_color"), (140, 120, 160)),
                   shadow_color=_rgb(d.get("shadow_color"), (60, 50, 80)),
                   highlight_color=_rgb(d.get("highlight_color"), (200, 180, 220)),
                   height=float(d.get("height", 0.15)),
                   depth=float(d.get("depth", 0.5)),
                   jaggedness=float(d.get("jaggedness", 0.5)),
                   seed=int(d.get("seed", 12345)))

    def to_ron(self):
        return {"lit_color": _rgb_ron(self.lit_color),
                "shadow_color": _rgb_ron(self.shadow_color),
                "highlight_color": _rgb_ron(self.highlight_color),
                "height": F32(self.height), "depth": F32(self.depth),
                "jaggedness": F32(self.jaggedness), "seed": self.seed}


@dataclasses.dataclass
class StarField:
    enabled: bool = False
    color: Tuple[int, int, int] = (255, 255, 240)
    count: int = 80
    size: float = 1.5
    twinkle_speed: float = 0.0
    seed: int = 42

    @classmethod
    def from_ron(cls, d):
        if d is None:
            return cls()
        return cls(enabled=bool(d.get("enabled", False)),
                   color=_rgb(d.get("color"), (255, 255, 240)),
                   count=int(d.get("count", 80)),
                   size=float(d.get("size", 1.5)),
                   twinkle_speed=float(d.get("twinkle_speed", 0.0)),
                   seed=int(d.get("seed", 42)))

    def to_ron(self):
        return {"enabled": self.enabled, "color": _rgb_ron(self.color),
                "count": self.count, "size": F32(self.size),
                "twinkle_speed": F32(self.twinkle_speed),
                "seed": self.seed}


@dataclasses.dataclass
class HorizonHaze:
    enabled: bool = True
    color: Tuple[int, int, int] = (200, 180, 160)
    intensity: float = 0.25
    extent: float = 0.12

    @classmethod
    def from_ron(cls, d):
        if d is None:
            return cls()
        return cls(enabled=bool(d.get("enabled", True)),
                   color=_rgb(d.get("color"), (200, 180, 160)),
                   intensity=float(d.get("intensity", 0.25)),
                   extent=float(d.get("extent", 0.12)))

    def to_ron(self):
        return {"enabled": self.enabled, "color": _rgb_ron(self.color),
                "intensity": F32(self.intensity),
                "extent": F32(self.extent)}


@dataclasses.dataclass
class Skybox:
    """geometry.rs:319."""

    zenith_color: Tuple[int, int, int] = (40, 60, 120)
    horizon_sky_color: Tuple[int, int, int] = (180, 140, 120)
    horizon_ground_color: Tuple[int, int, int] = (160, 120, 100)
    nadir_color: Tuple[int, int, int] = (80, 70, 90)
    horizontal_tint_enabled: bool = False
    horizontal_tint_color: Tuple[int, int, int] = (255, 180, 120)
    horizontal_tint_direction: float = 0.0  # radians
    horizontal_tint_intensity: float = 0.4
    horizontal_tint_spread: float = 1.05
    horizon: float = 0.5
    sun: CelestialBody = dataclasses.field(default_factory=CelestialBody)
    moon: CelestialBody = dataclasses.field(default_factory=CelestialBody)
    cloud_layers: List[Optional[CloudLayer]] = dataclasses.field(
        default_factory=lambda: [None, None])
    mountain_ranges: List[Optional[MountainRange]] = dataclasses.field(
        default_factory=lambda: [None, None])
    mountain_light_direction: float = 0.0
    stars: StarField = dataclasses.field(default_factory=StarField)
    horizon_haze: HorizonHaze = dataclasses.field(default_factory=HorizonHaze)

    @classmethod
    def from_ron(cls, d):
        if d is None:
            return None

        def direction(v, default=0.0):
            if v is None:
                return default
            name = v.name if isinstance(v, Tag) else str(v)
            return _DIR_ANGLES.get(name, default)

        layers = d.get("cloud_layers", (None, None))
        mounts = d.get("mountain_ranges", (None, None))
        return cls(
            zenith_color=_rgb(d.get("zenith_color"), (40, 60, 120)),
            horizon_sky_color=_rgb(d.get("horizon_sky_color"), (180, 140, 120)),
            horizon_ground_color=_rgb(d.get("horizon_ground_color"), (160, 120, 100)),
            nadir_color=_rgb(d.get("nadir_color"), (80, 70, 90)),
            horizontal_tint_enabled=bool(d.get("horizontal_tint_enabled", False)),
            horizontal_tint_color=_rgb(d.get("horizontal_tint_color"), (255, 180, 120)),
            horizontal_tint_direction=direction(d.get("horizontal_tint_direction")),
            horizontal_tint_intensity=float(d.get("horizontal_tint_intensity", 0.4)),
            horizontal_tint_spread=float(d.get("horizontal_tint_spread", 1.05)),
            horizon=float(d.get("horizon", 0.5)),
            sun=CelestialBody.from_ron(d.get("sun")),
            moon=CelestialBody.from_ron(d.get("moon")),
            cloud_layers=[CloudLayer.from_ron(x) for x in layers],
            mountain_ranges=[MountainRange.from_ron(x) for x in mounts],
            mountain_light_direction=direction(d.get("mountain_light_direction")),
            stars=StarField.from_ron(d.get("stars")),
            horizon_haze=HorizonHaze.from_ron(d.get("horizon_haze")),
        )

    def to_ron(self) -> dict:
        """Serialize back to the level's RON schema (wrap_some handled by
        the Level writer; editor-created skyboxes persist through this)."""
        from ..io import ron as ron_mod

        def opt(v):
            return ron_mod.wrap_some(v.to_ron()) if v is not None else None

        return {
            "zenith_color": _rgb_ron(self.zenith_color),
            "horizon_sky_color": _rgb_ron(self.horizon_sky_color),
            "horizon_ground_color": _rgb_ron(self.horizon_ground_color),
            "nadir_color": _rgb_ron(self.nadir_color),
            "horizontal_tint_enabled": self.horizontal_tint_enabled,
            "horizontal_tint_color": _rgb_ron(self.horizontal_tint_color),
            "horizontal_tint_direction": _dir_ron(
                self.horizontal_tint_direction),
            "horizontal_tint_intensity": F32(self.horizontal_tint_intensity),
            "horizontal_tint_spread": F32(self.horizontal_tint_spread),
            "horizon": F32(self.horizon),
            "sun": self.sun.to_ron(), "moon": self.moon.to_ron(),
            "cloud_layers": tuple(opt(c) for c in self.cloud_layers),
            "mountain_ranges": tuple(opt(m) for m in self.mountain_ranges),
            "mountain_light_direction": _dir_ron(self.mountain_light_direction),
            "stars": self.stars.to_ron(),
            "horizon_haze": self.horizon_haze.to_ron(),
        }

    def freeze(self) -> tuple:
        """Hashable canonical key over every parameter: two configs with
        equal keys render the same sky."""
        def fz(x):
            if dataclasses.is_dataclass(x):
                return tuple(fz(getattr(x, f.name))
                             for f in dataclasses.fields(x))
            if isinstance(x, (list, tuple)):
                return tuple(fz(v) for v in x)
            return x
        return fz(self)

    # ------------------------------------------------------------------
    # Sampling (geometry.rs:400-527), vectorized numpy over arrays
    # ------------------------------------------------------------------

    def sample_at_direction(self, theta, phi, time=0.0):
        """Sky color at direction(s); theta/phi arrays -> (..., 3) float rgb."""
        theta = np.asarray(theta, F32)
        phi = np.asarray(phi, F32)
        v = phi / F32(PI)

        def lerp(a, b, t):
            t = np.clip(t, 0.0, 1.0)[..., None].astype(F32)
            a = np.asarray(a, F32)
            b = np.asarray(b, F32)
            return a * (1 - t) + b * t

        hz = F32(self.horizon)
        t_above = np.where(hz > 0, v / max(hz, 1e-9), 0.0)
        above = lerp(self.zenith_color, self.horizon_sky_color, t_above)
        t_below = np.where(hz < 1, (v - hz) / max(1.0 - hz, 1e-9), 1.0)
        below = lerp(self.horizon_ground_color, self.nadir_color, t_below)
        color = np.where((v < hz)[..., None], above, below)

        if self.horizontal_tint_enabled and self.horizontal_tint_intensity > 0:
            diff = np.abs(theta - F32(self.horizontal_tint_direction))
            diff = np.where(diff > PI, 2 * PI - diff, diff)
            strength = np.where(
                diff < self.horizontal_tint_spread,
                (1.0 - diff / self.horizontal_tint_spread) ** 2
                * self.horizontal_tint_intensity, 0.0)
            horizon_factor = 1.0 - np.minimum(np.abs(v - hz) / 0.3, 1.0)
            color = np.where(
                (strength > 0)[..., None],
                lerp(color, self.horizontal_tint_color,
                     strength * horizon_factor), color)

        if self.horizon_haze.enabled and self.horizon_haze.intensity > 0:
            dist = np.abs(v - hz)
            s = np.where(dist < self.horizon_haze.extent,
                         (1.0 - dist / self.horizon_haze.extent) ** 2
                         * self.horizon_haze.intensity, 0.0)
            color = np.where((s > 0)[..., None],
                             lerp(color, self.horizon_haze.color, s), color)

        for body in (self.sun, self.moon):
            if not body.enabled:
                continue
            body_phi = PI / 2 - body.elevation
            cos_dist = (np.sin(phi) * math.sin(body_phi)
                        * np.cos(theta - body.azimuth)
                        + np.cos(phi) * math.cos(body_phi))
            ang = np.arccos(np.clip(cos_dist, -1.0, 1.0))
            core = np.where(ang < body.size, 1.0 - ang / body.size, 0.0)
            glow_r = body.size * 4.0
            glow_t = np.clip((ang - body.size) / max(glow_r - body.size, 1e-9),
                             0.0, 1.0)
            glow = np.where((ang >= body.size) & (ang < glow_r),
                            (1.0 - glow_t) ** body.glow_falloff * 0.6, 0.0)
            color = np.where((core > 0)[..., None],
                             lerp(color, body.color, core), color)
            color = np.where((glow > 0)[..., None],
                             lerp(color, body.glow_color, glow), color)

        for layer in self.cloud_layers:
            if layer is None or layer.opacity <= 0:
                continue
            vmin = layer.height - layer.thickness / 2
            vmax = layer.height + layer.thickness / 2
            inside = (v >= vmin) & (v <= vmax)
            scroll = time * layer.scroll_speed
            cval = self._wispy(theta + scroll, v, layer.wispiness,
                               layer.density, layer.phase)
            dist = np.abs(v - layer.height) / max(layer.thickness / 2, 1e-9)
            edge = np.clip(1.0 - dist, 0.0, 1.0)
            s = np.where(inside, cval * layer.opacity * edge, 0.0)
            color = np.where((s > 0)[..., None],
                             lerp(color, layer.color, s), color)
        return color

    def _wispy(self, theta, v, wispiness, density, phase):
        """geometry.rs:510-527."""
        stretch = 8.0 + wispiness * 16.0
        n1 = np.sin(np.sin(theta * density * 3.0 + phase) * stretch + v * 50.0)
        n2 = np.sin(np.sin(theta * density * 7.0 + phase * 2.0) * stretch * 0.5
                    + v * 120.0)
        n3 = np.sin(np.sin(theta * density * 13.0 + phase * 0.7) * stretch * 0.3
                    + v * 200.0)
        raw = np.clip(n1 * 0.5 + n2 * 0.3 + n3 * 0.2 + 0.5, 0.0, 1.0)
        threshold = wispiness * 0.5
        frac = np.clip((raw - threshold) / max(1.0 - threshold, 1e-9), 0.0, None)
        return np.where(raw < threshold, 0.0, frac ** 0.7)

    # ------------------------------------------------------------------
    # Mesh generation (geometry.rs:529-733)
    # ------------------------------------------------------------------

    def generate_sphere(self, time=0.0, h_segments=48, v_segments=32):
        """Sphere directions + colors (camera-relative unit dirs * radius is
        applied at render time).  Returns (dirs (V,3), colors (V,3) u8,
        faces (F,3))."""
        vs = np.arange(v_segments + 1)
        hs = np.arange(h_segments + 1)
        phi = PI * vs / v_segments
        theta = 2 * PI * hs / h_segments
        PH, TH = np.meshgrid(phi, theta, indexing="ij")
        y = np.cos(PH)
        ring = np.sin(PH)
        x = ring * np.cos(TH)
        z = ring * np.sin(TH)
        dirs = np.stack([x, y, z], axis=-1).reshape(-1, 3).astype(F32)
        colors = self.sample_at_direction(TH, PH, time).reshape(-1, 3)
        colors = np.clip(colors, 0, 255).astype(np.int32)

        faces = []
        row = h_segments + 1
        for vv in range(v_segments):
            for hh in range(h_segments):
                i0 = vv * row + hh
                i1 = i0 + 1
                i2 = (vv + 1) * row + hh
                i3 = i2 + 1
                faces.append((i0, i2, i1))
                faces.append((i1, i2, i3))
        return dirs, colors, np.asarray(faces, np.int32)

    def generate_mountains(self, time=0.0):
        """Peaked mountain triangles (geometry.rs:580-733).

        Returns (dirs (V,3) with per-range radius scale applied, colors,
        faces) appended after the sphere."""
        verts, colors, faces = [], [], []
        ranges = [(i, r) for i, r in enumerate(self.mountain_ranges)
                  if r is not None]
        ranges.sort(key=lambda p: -p[1].depth)
        light_angle = self.mountain_light_direction
        for _, rng_ in ranges:
            scale = 0.99 - rng_.depth * 0.02
            horizon_phi = self.horizon * PI
            base_phi = horizon_phi + 0.08
            max_h = rng_.height * 1.2
            num_peaks = 12 + int(rng_.jaggedness * 8.0)

            state = rng_.seed
            def next_rand():
                nonlocal state
                state = (state * 1103515245 + 12345) & 0xFFFFFFFFFFFFFFFF
                return ((state >> 16) & 0xFFFF) / 65536.0

            peaks = []
            for _ in range(num_peaks):
                a = next_rand() * 2 * PI
                h = 0.3 + next_rand() * 0.7
                peaks.append((a, h))
            peaks.sort(key=lambda p: p[0])

            for peak_theta, peak_height in peaks:
                base = len(verts)
                half_w = 0.12 + peak_height * 0.15 * (1.0 - rng_.jaggedness * 0.5)
                lt = peak_theta - half_w
                rt = peak_theta + half_w
                peak_phi = horizon_phi - peak_height * max_h

                def light_of(angle):
                    d = abs(angle - light_angle)
                    if d > PI:
                        d = 2 * PI - d
                    return max(0.0, min(1.0, (PI / 2 - d) / (PI / 2))) \
                        if d < PI / 2 else 0.0

                ll = light_of(peak_theta - half_w / 2)
                rl = light_of(peak_theta + half_w / 2)
                left_c = _lerp_rgb(rng_.shadow_color, rng_.lit_color, ll)
                right_c = _lerp_rgb(rng_.shadow_color, rng_.lit_color, rl)
                pl = (ll + rl) / 2
                if peak_height > 0.5:
                    t = min((peak_height - 0.5) / 0.5 * pl, 0.5)
                    peak_c = _lerp_rgb(rng_.shadow_color, rng_.highlight_color, t)
                else:
                    peak_c = _lerp_rgb(rng_.shadow_color, rng_.lit_color, pl)

                fade = rng_.depth * 0.5
                haze = self.horizon_haze.color
                left_c = _lerp_rgb(left_c, haze, fade)
                right_c = _lerp_rgb(right_c, haze, fade)
                peak_c = _lerp_rgb(peak_c, haze, fade * 0.8)
                base_c = _lerp_rgb(rng_.shadow_color, haze, fade)

                py, pring = math.cos(peak_phi), math.sin(peak_phi)
                by, bring = math.cos(base_phi), math.sin(base_phi)
                verts.append((pring * math.cos(peak_theta) * scale, py * scale,
                              pring * math.sin(peak_theta) * scale))
                colors.append(peak_c)
                verts.append((bring * math.cos(lt) * scale, by * scale,
                              bring * math.sin(lt) * scale))
                colors.append(left_c)
                verts.append((bring * math.cos(rt) * scale, by * scale,
                              bring * math.sin(rt) * scale))
                colors.append(right_c)
                verts.append((bring * math.cos(peak_theta) * scale, by * scale,
                              bring * math.sin(peak_theta) * scale))
                colors.append(base_c)
                faces.append((base, base + 1, base + 3))
                faces.append((base, base + 3, base + 2))

        if not verts:
            return (np.zeros((0, 3), F32), np.zeros((0, 3), np.int32),
                    np.zeros((0, 3), np.int32))
        return (np.asarray(verts, F32), np.asarray(colors, np.int32),
                np.asarray(faces, np.int32))

    # presets (geometry.rs:749-1026)
    @classmethod
    def preset_sunset(cls):
        return cls(
            zenith_color=(60, 40, 100), horizon_sky_color=(255, 160, 100),
            horizon_ground_color=(200, 140, 160), nadir_color=(120, 100, 140),
            horizontal_tint_enabled=True, horizontal_tint_color=(255, 200, 120),
            horizontal_tint_direction=PI, horizontal_tint_intensity=0.5,
            horizontal_tint_spread=1.2, horizon=0.52,
            sun=CelestialBody(True, PI, 0.15, 0.12, (255, 250, 200),
                              (255, 180, 80), 2.0),
            cloud_layers=[
                CloudLayer(0.35, 0.05, (255, 200, 160), 0.4, 0.01, 0.85, 0.8, 0.0),
                CloudLayer(0.45, 0.08, (255, 180, 140), 0.5, 0.02, 0.7, 1.0, 2.5)],
            mountain_ranges=[
                MountainRange((180, 140, 180), (80, 60, 100), (255, 200, 200),
                              0.15, 0.6, 0.4, 11111), None],
            mountain_light_direction=PI,
            stars=StarField(enabled=False),
            horizon_haze=HorizonHaze(True, (255, 200, 160), 0.35, 0.15))

    @classmethod
    def preset_twilight(cls):
        return cls(
            zenith_color=(30, 40, 80), horizon_sky_color=(100, 80, 140),
            horizon_ground_color=(60, 80, 100), nadir_color=(40, 60, 80),
            horizontal_tint_enabled=True, horizontal_tint_color=(200, 140, 180),
            horizontal_tint_direction=PI, horizontal_tint_intensity=0.35,
            horizontal_tint_spread=1.0, horizon=0.55,
            cloud_layers=[
                CloudLayer(0.42, 0.06, (220, 200, 180), 0.35, 0.008, 0.9, 0.7, 0.0),
                None],
            mountain_ranges=[
                MountainRange((80, 90, 140), (40, 50, 80), (120, 130, 180),
                              0.12, 0.7, 0.3, 22222), None],
            mountain_light_direction=PI,
            stars=StarField(True, (255, 255, 220), 60, 1.5, 0.5, 42),
            horizon_haze=HorizonHaze(True, (140, 120, 160), 0.25, 0.12))

    @classmethod
    def preset_arctic(cls):
        """geometry.rs:889 — icy blue daylight with aurora-tinted east."""
        return cls(
            zenith_color=(60, 100, 140), horizon_sky_color=(140, 180, 200),
            horizon_ground_color=(180, 200, 220), nadir_color=(100, 140, 180),
            horizontal_tint_enabled=True,
            horizontal_tint_color=(200, 150, 180),
            horizontal_tint_direction=0.0,  # East
            horizontal_tint_intensity=0.25, horizontal_tint_spread=1.5,
            horizon=0.5,
            cloud_layers=[
                CloudLayer(0.35, 0.04, (220, 200, 240), 0.3, 0.005, 0.6,
                           0.5, 0.0),
                CloudLayer(0.48, 0.03, (200, 220, 240), 0.4, 0.003, 0.4,
                           0.6, 1.5)],
            mountain_ranges=[
                MountainRange((200, 210, 230), (100, 120, 160),
                              (255, 255, 255), 0.2, 0.3, 0.7, 33333),
                MountainRange((160, 180, 210), (80, 100, 140),
                              (220, 230, 250), 0.25, 0.5, 0.5, 44444)],
            mountain_light_direction=0.0,  # East
            horizon_haze=HorizonHaze(True, (180, 200, 220), 0.4, 0.1))

    @classmethod
    def preset_night(cls):
        return cls(
            zenith_color=(10, 15, 40), horizon_sky_color=(20, 35, 70),
            horizon_ground_color=(15, 25, 50), nadir_color=(5, 10, 25),
            horizontal_tint_enabled=False, horizon=0.5,
            moon=CelestialBody(True, PI / 4, 0.6, 0.08, (240, 240, 255),
                               (180, 180, 220), 4.0),
            mountain_ranges=[
                MountainRange((30, 35, 50), (15, 20, 35), (50, 55, 75),
                              0.12, 0.6, 0.4, 55555), None],
            mountain_light_direction=0.0,
            stars=StarField(True, (255, 255, 245), 150, 1.8, 1.0, 12345),
            horizon_haze=HorizonHaze(True, (30, 40, 70), 0.2, 0.08))
