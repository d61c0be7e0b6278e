"""Raster inputs, the raster plan, and the backend registry (counterpart of
``repro/core/raster_api.py``).

* :class:`RasterInputs` — the projected per-Gaussian 2D attributes plus the
  per-tile :class:`FragmentLists`; a leading view axis ``B`` on every
  tensor means batched multi-view rasterization.
* :class:`RasterPlan` — how to rasterize: tile grid, backend name, chunk,
  fragment capacity, and an optional carried
  :class:`~repro_torch.core.schedule.TileSchedule` for the ``schedule``
  backend.
* the registry — backends register under a name (``kernels/ops.py`` holds
  the built-ins: ``ref``, ``kernel`` and ``schedule``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.core.projection import ProjectedGaussians
from repro_torch.core.schedule import TileSchedule
from repro_torch.core.sorting import FragmentLists, TileGrid


class RasterInputs(NamedTuple):
    mu2d: torch.Tensor     # (N, 2) or (B, N, 2)
    conic: torch.Tensor    # (N, 3)
    color: torch.Tensor    # (N, 3)
    opacity: torch.Tensor  # (N,)
    depth: torch.Tensor    # (N,)
    frags: FragmentLists   # index plumbing (no gradient)

    @classmethod
    def from_projection(cls, proj: ProjectedGaussians,
                        frags: FragmentLists) -> "RasterInputs":
        return cls(mu2d=proj.mu2d, conic=proj.conic, color=proj.color,
                   opacity=proj.opacity, depth=proj.depth, frags=frags)

    @property
    def views(self) -> Optional[int]:
        """Leading view-axis length, or ``None`` for a single view."""
        return self.mu2d.shape[0] if self.mu2d.ndim == 3 else None


@dataclasses.dataclass(frozen=True)
class RasterPlan:
    grid: TileGrid
    backend: str = "kernel"   # registry name
    chunk: int = 16           # kernel chunk size (C)
    capacity: int = 128       # fragments per tile (K)
    # A carried schedule (schedule backend): (S,) tensors for one view,
    # (B, S) for B views.  None: the backend builds one from the counts.
    sched: Optional[TileSchedule] = dataclasses.field(default=None,
                                                      compare=False)

    @property
    def max_trips(self) -> int:
        return self.capacity // self.chunk

    def with_sched(self, sched: Optional[TileSchedule]) -> "RasterPlan":
        return dataclasses.replace(self, sched=sched)


# name -> fn(inputs, plan) -> (color_pm, depth_pm, final_t)
_BACKENDS: dict[str, Callable] = {}


def register_backend(name: str) -> Callable[[Callable], Callable]:
    def deco(fn: Callable) -> Callable:
        _BACKENDS[name] = fn
        return fn
    return deco


def registered_backends() -> tuple[str, ...]:
    from repro_torch.kernels import ops  # noqa: F401  (registers built-ins)
    return tuple(sorted(_BACKENDS))


def get_backend(name: str) -> Callable:
    names = registered_backends()
    if name not in _BACKENDS:
        raise ValueError(f"unknown raster backend {name!r}; registered "
                         f"backends: {', '.join(names)}")
    return _BACKENDS[name]
