"""Pinhole camera model (counterpart of ``repro/core/camera.py``).

A ``Camera`` carries intrinsics and a world-to-camera pose as a (4,4) — or
(B,4,4) for a batch of views — float32 tensor.  Convention: +z forward,
+x right, +y down (OpenCV).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import lie


class Intrinsics(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int

    def scaled(self, factor: float) -> "Intrinsics":
        """Intrinsics for an image downscaled by ``factor`` (>=1)."""
        return Intrinsics(
            fx=self.fx / factor,
            fy=self.fy / factor,
            cx=self.cx / factor,
            cy=self.cy / factor,
            width=int(self.width // factor),
            height=int(self.height // factor),
        )


class Camera(NamedTuple):
    intrinsics: Intrinsics
    w2c: torch.Tensor  # (4,4) or (B,4,4) float32

    @property
    def c2w(self) -> torch.Tensor:
        return lie.se3_inverse(self.w2c)

    def perturbed(self, xi: torch.Tensor) -> "Camera":
        """Left-perturb the pose by a se(3) tangent vector (6,)."""
        return Camera(self.intrinsics, lie.se3_exp(xi) @ self.w2c)


def look_at(eye: torch.Tensor, target: torch.Tensor,
            up: torch.Tensor) -> torch.Tensor:
    """World-to-camera matrix looking from ``eye`` toward ``target``."""
    fwd = target - eye
    fwd = fwd / (torch.linalg.norm(fwd) + 1e-9)
    right = torch.linalg.cross(fwd, up)
    right = right / (torch.linalg.norm(right) + 1e-9)
    down = torch.linalg.cross(fwd, right)
    R = torch.stack([right, down, fwd], dim=0)  # rows: camera axes in world
    t = -R @ eye
    top = torch.cat([R, t[:, None]], dim=1)
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=top.dtype,
                          device=top.device)
    return torch.cat([top, bottom], dim=0)
