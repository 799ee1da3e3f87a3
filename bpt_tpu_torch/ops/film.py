"""Film: 8-bit conversion matching colors_to_rgb8 (src/image/wpng.h:14-35):
divide the sample sum by max(1, spp), clamp to [0, 0.999], gamma-2 via
sqrt, scale by 256, truncate to uint8.  NaN is scrubbed to 0 by default."""

from __future__ import annotations

import torch


def to_rgb8(framebuffer_sum: torch.Tensor, samples_per_pixel: int,
            nan_scrub: bool = True) -> torch.Tensor:
    """framebuffer_sum: [..., 3] sum of per-sample colors -> uint8 [..., 3]."""
    scale = 1.0 / max(1, int(samples_per_pixel))
    c = framebuffer_sum * scale
    if nan_scrub:
        c = torch.nan_to_num(c, nan=0.0, posinf=torch.inf, neginf=-torch.inf)
    c = torch.clamp(c, 0.0, 0.999)
    c = torch.sqrt(c)
    return (256.0 * c).to(torch.uint8)
