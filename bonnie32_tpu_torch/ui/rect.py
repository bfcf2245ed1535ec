"""Rect: the layout primitive (ui/rect.rs:5-130); the port's own copy of
the JAX package's `ui/rect.py`, host code."""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class Rect:
    x: float
    y: float
    w: float
    h: float

    @classmethod
    def screen(cls, width: float, height: float) -> "Rect":
        return cls(0.0, 0.0, width, height)

    @property
    def right(self) -> float:
        return self.x + self.w

    @property
    def bottom(self) -> float:
        return self.y + self.h

    @property
    def center_x(self) -> float:
        return self.x + self.w / 2.0

    @property
    def center_y(self) -> float:
        return self.y + self.h / 2.0

    def contains(self, px: float, py: float) -> bool:
        return self.x <= px < self.right and self.y <= py < self.bottom

    def pad(self, padding: float) -> "Rect":
        return Rect(self.x + padding, self.y + padding,
                    max(self.w - 2 * padding, 0.0),
                    max(self.h - 2 * padding, 0.0))

    def pad_sides(self, left: float, top: float, right: float,
                  bottom: float) -> "Rect":
        return Rect(self.x + left, self.y + top,
                    max(self.w - left - right, 0.0),
                    max(self.h - top - bottom, 0.0))

    # splits (rect.rs:68-102)
    def split_h(self, ratio: float) -> Tuple["Rect", "Rect"]:
        """Left/right at a width ratio."""
        w1 = self.w * ratio
        return (Rect(self.x, self.y, w1, self.h),
                Rect(self.x + w1, self.y, self.w - w1, self.h))

    def split_v(self, ratio: float) -> Tuple["Rect", "Rect"]:
        """Top/bottom at a height ratio."""
        h1 = self.h * ratio
        return (Rect(self.x, self.y, self.w, h1),
                Rect(self.x, self.y + h1, self.w, self.h - h1))

    def split_h_px(self, pixels: float) -> Tuple["Rect", "Rect"]:
        w1 = min(pixels, self.w)
        return (Rect(self.x, self.y, w1, self.h),
                Rect(self.x + w1, self.y, self.w - w1, self.h))

    def split_v_px(self, pixels: float) -> Tuple["Rect", "Rect"]:
        h1 = min(pixels, self.h)
        return (Rect(self.x, self.y, self.w, h1),
                Rect(self.x, self.y + h1, self.w, self.h - h1))

    # slices (rect.rs:104-130)
    def slice_top(self, height: float) -> "Rect":
        return Rect(self.x, self.y, self.w, min(height, self.h))

    def remaining_after_top(self, height: float) -> "Rect":
        h = min(height, self.h)
        return Rect(self.x, self.y + h, self.w, self.h - h)

    def slice_bottom(self, height: float) -> "Rect":
        h = min(height, self.h)
        return Rect(self.x, self.bottom - h, self.w, h)

    def remaining_after_bottom(self, height: float) -> "Rect":
        h = min(height, self.h)
        return Rect(self.x, self.y, self.w, self.h - h)

    def slice_left(self, width: float) -> "Rect":
        return Rect(self.x, self.y, min(width, self.w), self.h)

    def remaining_after_left(self, width: float) -> "Rect":
        w = min(width, self.w)
        return Rect(self.x + w, self.y, self.w - w, self.h)

    def intersect(self, other: "Rect") -> "Rect":
        x = max(self.x, other.x)
        y = max(self.y, other.y)
        r = min(self.right, other.right)
        b = min(self.bottom, other.bottom)
        return Rect(x, y, max(r - x, 0.0), max(b - y, 0.0))
