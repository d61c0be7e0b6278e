"""Step 1 (Preprocessing): EWA projection of 3D Gaussians to screen space.

Counterpart of ``repro/core/projection.py``.  Plain differentiable torch:
autograd through this module is the Step-5 "Preprocessing BP" (2D
gradients -> 3D Gaussian gradients -> camera-pose gradients), as JAX
autodiff is in the reference.  Its float32 products must not run in TF32
on the card; ``repro_torch/__init__.py`` turns TF32 off.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.camera import Camera
from repro_torch.core.gaussians import GaussianField

_COV2D_BLUR = 0.3
_NEAR = 0.05


class ProjectedGaussians(NamedTuple):
    mu2d: torch.Tensor     # (N, 2) pixel coords
    conic: torch.Tensor    # (N, 3) inverse 2D covariance (a, b, c)
    color: torch.Tensor    # (N, 3) rgb in [0,1]
    opacity: torch.Tensor  # (N,)
    depth: torch.Tensor    # (N,) camera-space z
    radius: torch.Tensor   # (N,) screen-space extent in px (no gradient use)
    valid: torch.Tensor    # (N,) bool — alive, in front, on screen


def _over_storage(fn, x: torch.Tensor, storage):
    """``fn(x)`` row by row; with ``storage = (rows, n)`` (``x`` holds the
    rows ``rows`` of an n-row storage) ``fn`` runs on the n-row operand,
    zero off those rows, and its rows ``rows`` are returned."""
    if storage is None:
        return fn(x)
    rows, n = storage
    full = x.new_zeros((n, *x.shape[1:])).index_copy(0, rows, x)
    return fn(full).index_select(0, rows)


def project(g: GaussianField, cam: Camera, storage=None) -> ProjectedGaussians:
    """``storage = (rows, n)`` says that ``g`` is a paged view: the rows
    ``rows`` of an n-row storage.  The two products with the camera's
    rotation then run over n-row operands, zero off the view, so the
    pose gradient's sums over rows (the backward of ``mu @ W.T``, ``+ t``
    and ``J @ W``) have the flat step's shapes, and cuBLAS, which splits a
    sum by its length, rounds them as it rounds the flat step's.  Rows
    off the view add exact zeros there (they render nothing), so while
    every row that renders is in the view the pose gradient equals the
    flat step's bit for bit."""
    intr = cam.intrinsics
    W = cam.w2c[:3, :3]
    t = cam.w2c[:3, 3]

    p_cam = _over_storage(lambda mu: mu @ W.T + t, g.mu, storage)
    z = p_cam[:, 2]
    z_safe = torch.clamp(z, min=_NEAR)

    mu2d = torch.stack(
        [intr.fx * p_cam[:, 0] / z_safe + intr.cx,
         intr.fy * p_cam[:, 1] / z_safe + intr.cy],
        dim=-1,
    )

    inv_z = 1.0 / z_safe
    inv_z2 = inv_z * inv_z
    zeros = torch.zeros_like(z)
    J = torch.stack(
        [
            torch.stack([intr.fx * inv_z, zeros, -intr.fx * p_cam[:, 0] * inv_z2], -1),
            torch.stack([zeros, intr.fy * inv_z, -intr.fy * p_cam[:, 1] * inv_z2], -1),
        ],
        dim=-2,
    )

    cov3d = g.covariance()
    JW = _over_storage(lambda j: j @ W, J, storage)
    cov2d = JW @ cov3d @ JW.transpose(-1, -2)
    cov2d = cov2d + _COV2D_BLUR * torch.eye(2, dtype=cov2d.dtype,
                                            device=cov2d.device)

    det = cov2d[:, 0, 0] * cov2d[:, 1, 1] - cov2d[:, 0, 1] * cov2d[:, 1, 0]
    det_safe = torch.clamp(det, min=1e-12)
    inv_det = 1.0 / det_safe
    conic = torch.stack(
        [cov2d[:, 1, 1] * inv_det, -cov2d[:, 0, 1] * inv_det,
         cov2d[:, 0, 0] * inv_det],
        dim=-1,
    )

    # Screen-space radius: 3 sigma of the major axis (index use only).
    with torch.no_grad():
        mid = 0.5 * (cov2d[:, 0, 0] + cov2d[:, 1, 1])
        lam1 = mid + torch.sqrt(torch.clamp(mid * mid - det_safe, min=0.0) + 1e-12)
        radius = torch.ceil(3.0 * torch.sqrt(torch.clamp(lam1, min=0.0)))
        onscreen = (
            (mu2d[:, 0] + radius >= 0.0)
            & (mu2d[:, 0] - radius <= intr.width)
            & (mu2d[:, 1] + radius >= 0.0)
            & (mu2d[:, 1] - radius <= intr.height)
        )
        valid = g.alive & (z > _NEAR) & (det > 1e-12) & onscreen

    return ProjectedGaussians(mu2d=mu2d, conic=conic, color=g.rgb(),
                              opacity=g.opacity(), depth=z, radius=radius,
                              valid=valid)
