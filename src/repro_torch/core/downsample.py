"""§4.2 dynamic downsampling (counterpart of ``repro/core/downsample.py``).

    keyframes:      R_n = R_0
    non-keyframes:  R_n = min((1/16) R_0 * m^(n-k-1), (1/4) R_0)

with R the pixel count (area), m > 1 the scaling factor and k the index of
the most recent keyframe.  As in the reference, the area ratio is rounded
up in resolution to a power-of-two side factor in {1, 2, 4}, so a 16-pixel
tile grid exists at every factor of a 64-divisible frame; the session keeps
one render stage per factor.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class DownsampleConfig(NamedTuple):
    m: float = 2.0
    min_area: float = 1.0 / 16.0
    max_area: float = 1.0 / 4.0
    enabled: bool = True


def area_ratio(frames_since_keyframe: int,
               cfg: DownsampleConfig = DownsampleConfig()) -> float:
    """The exact §4.2 area ratio of a non-keyframe at distance d >= 1."""
    d = max(int(frames_since_keyframe), 1)
    return min(cfg.min_area * cfg.m ** (d - 1), cfg.max_area)


def side_factor(frames_since_keyframe: int, is_keyframe: bool,
                cfg: DownsampleConfig = DownsampleConfig()) -> int:
    """Per-side factor in {1, 2, 4}: the largest whose area 1/f^2 still
    covers the schedule's ratio (never fewer pixels than it asks for)."""
    if is_keyframe or not cfg.enabled:
        return 1
    r = area_ratio(frames_since_keyframe, cfg)
    if r <= 1.0 / 16.0 + 1e-12:
        return 4
    if r <= 1.0 / 4.0 + 1e-12:
        return 2
    return 1


def _blocks(x: torch.Tensor, factor: int) -> torch.Tensor:
    h, w = x.shape[0], x.shape[1]
    if h % factor or w % factor:
        raise ValueError(f"a {h}x{w} image does not split into {factor}x{factor} blocks")
    return x.reshape((h // factor, factor, w // factor, factor) + tuple(x.shape[2:]))


def downsample_image(img: torch.Tensor, factor: int) -> torch.Tensor:
    """Average-pool (H, W, C?) by an integer per-side factor."""
    if factor == 1:
        return img
    return _blocks(img, factor).mean(dim=(1, 3))


def downsample_depth(depth: torch.Tensor, factor: int) -> torch.Tensor:
    """Depth pooling that ignores invalid (<= 0) pixels; a block with no
    valid pixel is 0.  The division is by ``clamp(count, min=1)`` so the
    branch ``torch.where`` discards never makes a NaN."""
    if factor == 1:
        return depth
    d = _blocks(depth, factor)
    valid = (d > 0).to(depth.dtype)
    s = (d * valid).sum(dim=(1, 3))
    c = valid.sum(dim=(1, 3))
    return torch.where(c > 0, s / torch.clamp(c, min=1.0), torch.zeros_like(s))
