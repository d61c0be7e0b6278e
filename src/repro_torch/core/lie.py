"""SO(3)/SE(3) Lie-group operations for camera-pose optimization.

Counterpart of ``repro/core/lie.py``.  Tracking optimizes a left tangent
delta; torch autograd through :func:`se3_exp` gives the Step-5 pose
gradients.

``torch.where`` leaks NaN gradients from the branch it does not take,
exactly as ``jnp.where`` does, so every coefficient keeps the
"double-where": the denominator itself is made safe before the division,
and the gradient at theta=0 (where every tracking iteration starts) is
exact and finite.
"""

from __future__ import annotations

import torch

from repro_torch._device import constant

_SERIES_CUT = 1e-8
# (t - sin t)/t^3 and (1 - a/2b)/t^2 cancel catastrophically in f32 well
# above the NaN threshold — series until theta < 0.1.
_CANCEL_CUT = 1e-2


def _eye3(ref: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=ref.dtype, device=ref.device)


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: (…,3) -> (…,3,3) skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def _abc(theta2: torch.Tensor):
    """a=sin(t)/t, b=(1-cos t)/t^2, c=(t-sin t)/t^3 with NaN-free series
    fallbacks (double-where)."""
    use_series = theta2 < _SERIES_CUT
    t2 = torch.where(use_series, torch.ones_like(theta2), theta2)  # safe denom
    t = torch.sqrt(t2)
    a = torch.where(use_series, 1.0 - theta2 / 6.0, torch.sin(t) / t)
    b = torch.where(use_series, 0.5 - theta2 / 24.0, (1.0 - torch.cos(t)) / t2)
    c = torch.where(theta2 < _CANCEL_CUT, 1.0 / 6.0 - theta2 / 120.0,
                    (t - torch.sin(t)) / (t2 * t))
    return a, b, c


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (…,3) axis-angle -> (…,3,3) rotation matrix."""
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)[..., None]  # (…,1,1)
    a, b, _ = _abc(theta2)
    W = hat(w)
    return _eye3(w) + a * W + b * (W @ W)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Inverse of so3_exp: (…,3,3) -> (…,3). Valid for |theta| < pi."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0 + 1e-7, 1.0 - 1e-7)
    theta = torch.arccos(cos_t)
    vee = torch.stack(
        [R[..., 2, 1] - R[..., 1, 2],
         R[..., 0, 2] - R[..., 2, 0],
         R[..., 1, 0] - R[..., 0, 1]],
        dim=-1,
    )
    small = theta < 1e-6
    theta_safe = torch.where(small, torch.ones_like(theta), theta)[..., None]
    scale = torch.where(
        small[..., None],
        0.5 + theta[..., None] ** 2 / 12.0,
        theta_safe / (2.0 * torch.sin(theta_safe)),
    )
    return scale * vee


def _homogeneous(top: torch.Tensor) -> torch.Tensor:
    bottom = constant((0.0, 0.0, 0.0, 1.0), top.dtype, top.device)
    bottom = bottom.expand(top.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """se(3) exp: (…,6) [rho, w] -> (…,4,4) homogeneous transform."""
    rho, w = xi[..., :3], xi[..., 3:]
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)[..., None]
    a, b, c = _abc(theta2)
    W = hat(w)
    W2 = W @ W
    eye = _eye3(xi)
    R = eye + a * W + b * W2
    V = eye + b * W + c * W2
    t = torch.einsum("...ij,...j->...i", V, rho)
    return _homogeneous(torch.cat([R, t[..., None]], dim=-1))


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """Inverse of se3_exp: (…,4,4) -> (…,6)."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    w = so3_log(R)
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)[..., None]
    a, b, _ = _abc(theta2)
    W = hat(w)
    W2 = W @ W
    use_series = theta2 < _CANCEL_CUT
    t2 = torch.where(use_series, torch.ones_like(theta2), theta2)
    coef = torch.where(use_series, 1.0 / 12.0 + theta2 / 720.0,
                       (1.0 - a / (2.0 * b)) / t2)
    Vinv = _eye3(T) - 0.5 * W + coef * W2
    rho = torch.einsum("...ij,...j->...i", Vinv, t)
    return torch.cat([rho, w], dim=-1)


def se3_inverse(T: torch.Tensor) -> torch.Tensor:
    R, t = T[..., :3, :3], T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    ti = -torch.einsum("...ij,...j->...i", Rt, t)
    return _homogeneous(torch.cat([Rt, ti[..., None]], dim=-1))


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply a (4,4) transform to (...,3) points."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    return torch.einsum("ij,...j->...i", R, pts) + t
