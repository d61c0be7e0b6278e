"""§4.2 dynamic downsampling (counterpart of ``repro/core/downsample.py``).

Only the configuration type and the factor-1 identity are ported: the
slice runs every frame at full resolution.  Other factors raise.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class DownsampleConfig(NamedTuple):
    m: float = 2.0
    min_area: float = 1.0 / 16.0
    max_area: float = 1.0 / 4.0
    enabled: bool = True


def _only_factor_one(factor: int) -> None:
    if factor != 1:
        raise NotImplementedError("downsampling factors other than 1 are "
                                  "not ported yet")


def downsample_image(img: torch.Tensor, factor: int) -> torch.Tensor:
    _only_factor_one(factor)
    return img


def downsample_depth(depth: torch.Tensor, factor: int) -> torch.Tensor:
    _only_factor_one(factor)
    return depth
