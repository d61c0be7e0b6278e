"""Classical (non-rendering) tracking for the Photo-SLAM base algorithm
(counterpart of ``repro/slam/geometric.py``).

Photo-SLAM tracks by geometric optimization instead of differentiating
through the renderer, so RTGS applies only to its mapping (§6.1).  As in
the reference this is dense frame-to-frame direct odometry: back-project
the previous frame's depth on a strided pixel grid, reproject into the
current frame, and minimize photometric plus depth residuals.  No Gaussian
and no kernel is involved; torch autograd gives the pose gradient.
"""

from __future__ import annotations

import torch

from repro_torch.core import lie
from repro_torch.core.camera import Intrinsics
from repro_torch.train.optimizer import Adam


def bilinear_sample(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Sample (H, W, C) or (H, W) at continuous pixel coordinates uv (P, 2)."""
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    h, w = img.shape[:2]
    u = torch.clamp(uv[:, 0] - 0.5, 0.0, w - 1.001)
    v = torch.clamp(uv[:, 1] - 0.5, 0.0, h - 1.001)
    u0f, v0f = torch.floor(u), torch.floor(v)
    u0, v0 = u0f.long(), v0f.long()
    du, dv = (u - u0f)[:, None], (v - v0f)[:, None]
    out = (img[v0, u0] * (1 - du) * (1 - dv)
           + img[v0, u0 + 1] * du * (1 - dv)
           + img[v0 + 1, u0] * (1 - du) * dv
           + img[v0 + 1, u0 + 1] * du * dv)
    return out[:, 0] if squeeze else out


def backproject_grid(rgb: torch.Tensor, depth: torch.Tensor, w2c: torch.Tensor,
                     intr: Intrinsics, stride: int = 4):
    """World points, colors, depths and validity of a strided pixel grid of
    one frame."""
    f32 = dict(dtype=torch.float32, device=rgb.device)
    ys = torch.arange(0, intr.height, stride, **f32) + 0.5
    xs = torch.arange(0, intr.width, stride, **f32) + 0.5
    vv, uu = torch.meshgrid(ys, xs, indexing="ij")
    uu, vv = uu.reshape(-1), vv.reshape(-1)
    uv = torch.stack([uu, vv], -1)
    d = bilinear_sample(depth, uv)
    c = bilinear_sample(rgb, uv)
    x_cam = torch.stack([(uu - intr.cx) / intr.fx * d,
                         (vv - intr.cy) / intr.fy * d, d], -1)
    c2w = lie.se3_inverse(w2c)
    x_world = x_cam @ c2w[:3, :3].T + c2w[:3, 3]
    return x_world, c, d, d > 1e-3


def geometric_loss(xi, base_w2c, pts_w, cols, valid, cur_rgb, cur_depth,
                   intr: Intrinsics, lambda_pho: float = 0.7) -> torch.Tensor:
    """Photometric + depth residual of the points reprojected at
    ``se3_exp(xi) @ base_w2c``."""
    w2c = lie.se3_exp(xi) @ base_w2c
    x_cam = pts_w @ w2c[:3, :3].T + w2c[:3, 3]
    z = torch.clamp(x_cam[:, 2], min=1e-3)
    uv = torch.stack([intr.fx * x_cam[:, 0] / z + intr.cx,
                      intr.fy * x_cam[:, 1] / z + intr.cy], -1)
    inb = ((uv[:, 0] > 1) & (uv[:, 0] < intr.width - 1)
           & (uv[:, 1] > 1) & (uv[:, 1] < intr.height - 1)
           & valid & (x_cam[:, 2] > 1e-3))
    w = inb.to(torch.float32)
    wsum = torch.clamp(w.sum(), min=1.0)
    samp_rgb = bilinear_sample(cur_rgb, uv)
    samp_d = bilinear_sample(cur_depth, uv)
    e_pho = ((samp_rgb - cols).abs().mean(-1) * w).sum() / wsum
    d_ok = w * (samp_d > 1e-3).to(torch.float32)
    e_geo = ((samp_d - z).abs() * d_ok).sum() / torch.clamp(d_ok.sum(), min=1.0)
    return lambda_pho * e_pho + (1 - lambda_pho) * e_geo


def make_geometric_tracker(intr: Intrinsics, lambda_pho: float = 0.7):
    """``vg(xi, base_w2c, points, colors, valid, rgb, depth) -> (loss,
    dloss/dxi)``, the reference's value-and-grad of the same loss."""

    def vg(xi, base_w2c, pts_w, cols, valid, cur_rgb, cur_depth):
        with torch.enable_grad():
            xi_ = xi.detach().requires_grad_(True)
            loss = geometric_loss(xi_, base_w2c, pts_w, cols, valid, cur_rgb,
                                  cur_depth, intr, lambda_pho)
            (g_xi,) = torch.autograd.grad(loss, [xi_])
        return loss.detach(), g_xi

    return vg


def geometric_track(intr: Intrinsics, base_w2c, pts_w, cols, valid, cur_rgb,
                    cur_depth, *, iters: int, lr_pose: float) -> torch.Tensor:
    """The reference's ``get_geo_scan``: ``iters`` pose steps of Adam at
    twice the tracking rate on the geometric loss; returns ``xi``."""
    vg = make_geometric_tracker(intr)
    opt = Adam(lr=lr_pose * 2)
    xi = torch.zeros(6, dtype=torch.float32, device=base_w2c.device)
    ostate = opt.init({"xi": xi})
    for _ in range(iters):
        _, g_xi = vg(xi, base_w2c, pts_w, cols, valid, cur_rgb, cur_depth)
        upd, ostate = opt.update({"xi": g_xi}, ostate)
        xi = xi + upd["xi"]
    return xi
