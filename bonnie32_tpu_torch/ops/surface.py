"""Per-vertex fog (bonnie32_tpu/ops/surface.py): the pieces of the
CULL/FOG phase (render.rs:2266-2293) that the flat surface build uses."""

import torch

from .._host.config import BlendMode
from .fixed import f32_to_i32


def _fog_factor(z, start, falloff):
    """calculate_fog_factor (render.rs:2266-2274)."""
    safe = torch.where(falloff <= 0.0, torch.ones_like(falloff), falloff)
    lin = torch.clamp((z - start) / safe, max=1.0)
    return torch.where(z <= start, torch.zeros_like(lin),
                       torch.where(falloff <= 0.0, torch.ones_like(lin), lin))


def _apply_fog_to_color(color_rgb, color_blend, fog_rgb, factor):
    """apply_fog_to_color (render.rs:2279-2293): returns (rgb (..., 3) i32,
    blend i32).  The lerp branch builds a fresh colour, so its blend resets
    to OPAQUE; the passthrough branches keep the original colour and blend."""
    f = factor[..., None]
    lerped = color_rgb.to(torch.float32) * (1.0 - f) \
        + fog_rgb.to(torch.float32) * f
    lerped = torch.clamp(f32_to_i32(torch.trunc(lerped)), 0, 255)
    use_orig = factor <= 0.0
    use_fog = factor >= 1.0
    rgb = torch.where(use_orig[..., None], color_rgb,
                      torch.where(use_fog[..., None],
                                  torch.broadcast_to(fog_rgb, color_rgb.shape),
                                  lerped))
    blend = torch.where(use_orig, color_blend,
                        torch.full_like(color_blend, int(BlendMode.OPAQUE)))
    return rgb, blend
