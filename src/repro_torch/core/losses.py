"""SLAM objective (Eq. 6) and PSNR (counterpart of ``repro/core/losses.py``)."""

from __future__ import annotations

import torch


def slam_loss(rendered_rgb: torch.Tensor, rendered_depth: torch.Tensor,
              rendered_alpha: torch.Tensor, obs_rgb: torch.Tensor,
              obs_depth: torch.Tensor, lambda_pho: float = 0.9,
              depth_valid_min: float = 1e-3) -> torch.Tensor:
    """lambda * |rgb error| + (1 - lambda) * |depth error| where covered."""
    e_pho = torch.mean(torch.abs(rendered_rgb - obs_rgb))
    mask = (obs_depth > depth_valid_min) & (rendered_alpha > 0.5)
    norm_depth = rendered_depth / torch.clamp(rendered_alpha, min=1e-6)
    e_geo = torch.sum(torch.abs(norm_depth - obs_depth) * mask) / torch.clamp(
        mask.sum().to(torch.float32), min=1.0)
    return lambda_pho * e_pho + (1.0 - lambda_pho) * e_geo


def psnr(a: torch.Tensor, b: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    mse = torch.mean((a - b) ** 2)
    return 10.0 * torch.log10(max_val ** 2 / torch.clamp(mse, min=1e-12))
