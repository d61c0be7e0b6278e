"""Pure-tensor oracle for the tile rasterizer (counterpart of
``repro/kernels/ref.py``).

Defines the blending semantics the kernels mirror:

  1. alpha_k = o_k * exp(-0.5 * d^T conic d), zeroed below ALPHA_MIN,
     clipped at ALPHA_MAX, zeroed for padded fragments.
  2. Texc_k  = prod_{j<k} (1 - alpha_j)            (exclusive transmittance)
  3. include_k = Texc_k > TERM_EPS                 (early termination)
  4. w_k     = Texc_k * alpha_k * include_k
  5. color = sum_k w_k c_k ; depth = sum_k w_k d_k ;
     final_T = prod_k (1 - alpha_k * include_k)

Everything is differentiable torch, so autograd through this module is the
reference gradient for the hand-written backward.  Memory is
O(tiles * 256 * K) per intermediate.
"""

from __future__ import annotations

import torch

from repro_torch.core.sorting import TILE, TileGrid

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
TERM_EPS = 1e-4

NUM_ATTRS = 12  # packed rows: mu_x mu_y ca cb cc r g b o depth present pad
PIX = TILE * TILE


def tile_pixel_coords(grid: TileGrid, device="cpu"):
    """Pixel-centre coordinates per tile: two (num_tiles, 256) tensors."""
    f32 = dict(dtype=torch.float32, device=device)
    ty, tx = torch.meshgrid(torch.arange(grid.grid_h, **f32),
                            torch.arange(grid.grid_w, **f32), indexing="ij")
    py, px = torch.meshgrid(torch.arange(TILE, **f32),
                            torch.arange(TILE, **f32), indexing="ij")
    x = (tx.reshape(-1, 1) * TILE + px.reshape(1, -1)) + 0.5
    y = (ty.reshape(-1, 1) * TILE + py.reshape(1, -1)) + 0.5
    return x, y


def fragment_alphas(attrs: torch.Tensor, grid: TileGrid) -> torch.Tensor:
    """Alpha of every fragment: (T, 256, K)."""
    px, py = tile_pixel_coords(grid, attrs.device)
    mu_x, mu_y = attrs[:, 0], attrs[:, 1]
    ca, cb, cc = attrs[:, 2], attrs[:, 3], attrs[:, 4]
    o = attrs[:, 8]
    present = attrs[:, 10] > 0.5
    dx = px[:, :, None] - mu_x[:, None, :]
    dy = py[:, :, None] - mu_y[:, None, :]
    q = (ca[:, None, :] * dx * dx + 2.0 * cb[:, None, :] * dx * dy
         + cc[:, None, :] * dy * dy)
    gauss = torch.exp(-0.5 * torch.clamp(q, min=0.0))
    alpha = torch.clamp(o[:, None, :] * gauss, max=ALPHA_MAX)
    keep = (alpha >= ALPHA_MIN) & present[:, None, :]
    return torch.where(keep, alpha, torch.zeros_like(alpha))


def blend(attrs: torch.Tensor, alpha: torch.Tensor):
    """Front-to-back blend with early termination.  Returns
    (color (T,256,3), depth (T,256), final_T (T,256))."""
    texc = torch.cumprod(1.0 - alpha, dim=-1)
    texc = torch.cat([torch.ones_like(texc[..., :1]), texc[..., :-1]], dim=-1)
    include = texc > TERM_EPS
    w = texc * alpha * include
    color = torch.einsum("tpk,tck->tpc", w, attrs[:, 5:8])
    depth = torch.einsum("tpk,tk->tp", w, attrs[:, 9])
    final_t = torch.prod(1.0 - alpha * include, dim=-1)
    return color, depth, final_t


def rasterize_tiles(attrs: torch.Tensor, grid: TileGrid):
    return blend(attrs, fragment_alphas(attrs, grid))


def tiles_to_image(tiled: torch.Tensor, grid: TileGrid) -> torch.Tensor:
    """(T, 256, C?) tile-major -> (H, W, C?) image."""
    chan = tuple(tiled.shape[2:])
    x = tiled.reshape((grid.grid_h, grid.grid_w, TILE, TILE) + chan)
    return x.transpose(1, 2).reshape((grid.height, grid.width) + chan)


def image_to_tiles(img: torch.Tensor, grid: TileGrid) -> torch.Tensor:
    """(H, W, C?) -> (T, 256, C?)."""
    chan = tuple(img.shape[2:])
    x = img.reshape((grid.grid_h, TILE, grid.grid_w, TILE) + chan)
    return x.transpose(1, 2).reshape((grid.num_tiles, PIX) + chan)
