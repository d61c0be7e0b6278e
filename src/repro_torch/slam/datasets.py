"""Synthetic RGB-D scenes (counterpart of ``repro/slam/datasets.py``).

A procedural room — checkered back wall, gradient floor, two striped boxes
— is sampled into a ground-truth Gaussian field and rendered along a
smooth orbit through the port's ``kernel`` backend (K1 on the card).  The
recipe is the reference's; the draws come from a seeded numpy generator,
so the points are not ``jax.random``'s.  Scenes are deterministic in
``(name, seed)``.  Ported: ``room0``, ``room1``, ``hall0``.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import List

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import gaussians as G
from repro_torch.core.camera import Camera, Intrinsics, look_at
from repro_torch.core.raster_api import RasterPlan
from repro_torch.core.render import render
from repro_torch.core.sorting import make_tile_grid

SCENES: tuple = ("room0", "room1", "hall0")
NOT_PORTED: tuple = ("desk0", "stairs0", "corridor0")

_OFFSET = {"room0": 0.0, "room1": 0.35, "hall0": -0.3}
_ARC = {"room0": 0.9, "room1": 1.2, "hall0": 0.7}


@dataclasses.dataclass
class Frame:
    rgb: torch.Tensor    # (H, W, 3) float32 in [0,1]
    depth: torch.Tensor  # (H, W) float32, 0 = invalid
    w2c_gt: np.ndarray   # (4, 4) ground-truth pose


@dataclasses.dataclass
class SLAMDataset:
    name: str
    intrinsics: Intrinsics
    frames: List[Frame]
    gt_field: G.GaussianField

    @property
    def num_frames(self) -> int:
        return len(self.frames)


def _room_points(rng: np.random.Generator, name: str, n: int):
    """Points + colors on the room's surfaces (the reference's recipe)."""
    quarters = n // 4
    xy = rng.uniform(-2.0, 2.0, (quarters, 2))
    wall = np.stack([xy[:, 0], xy[:, 1] * 0.75, np.full(quarters, 4.0)], -1)
    check = (np.floor(xy[:, 0] * 2) + np.floor(xy[:, 1] * 2)) % 2
    wall_col = np.stack([0.2 + 0.6 * check, 0.3 + 0.2 * check, 0.8 - 0.5 * check], -1)

    xz = rng.uniform([-2.0, 1.0], [2.0, 4.0], (quarters, 2))
    floor = np.stack([xz[:, 0], np.full(quarters, 1.5), xz[:, 1]], -1)
    floor_col = np.stack([0.4 + 0.15 * xz[:, 0], np.full(quarters, 0.35),
                          0.2 + 0.2 * (xz[:, 1] - 1) / 3], -1)

    def box(center, size, base_col):
        m = quarters // 2
        u = rng.uniform(-1.0, 1.0, (m, 3))
        face = rng.integers(0, 3, m)
        sign = rng.integers(0, 2, m) * 2 - 1
        pts = u * size
        pts[np.arange(m), face] = sign * size[face]
        stripes = np.floor((u[:, 0] + u[:, 1]) * 3) % 2
        return pts + center, base_col[None, :] * (0.6 + 0.4 * stripes[:, None])

    b1, c1 = box(np.array([-0.8, 1.1, 2.8]), np.array([0.35, 0.4, 0.35]),
                 np.array([0.9, 0.5, 0.2]))
    b2, c2 = box(np.array([0.9, 1.0, 3.2]), np.array([0.3, 0.5, 0.3]),
                 np.array([0.3, 0.8, 0.4]))
    pts = np.concatenate([wall, floor, b1, b2], axis=0)
    cols = np.concatenate([wall_col, floor_col, c1, c2], axis=0)
    off = _OFFSET[name]
    pts = pts + np.array([off, 0.0, off * 0.5])
    pts = pts + 0.01 * rng.standard_normal(pts.shape)
    return pts.astype(np.float32), np.clip(cols, 0.02, 0.98).astype(np.float32)


def _trajectory(name: str, num_frames: int) -> List[np.ndarray]:
    """Smooth arc orbiting the scene centre with mild vertical bobbing."""
    poses = []
    for t in np.linspace(0.0, 1.0, num_frames):
        ang = (t - 0.5) * _ARC[name]
        eye = np.array([1.4 * np.sin(ang), 0.25 * np.sin(2.2 * ang),
                        0.9 - 0.9 * np.cos(ang)])
        target = np.array([0.4 * np.sin(ang * 0.5), 0.5, 3.0])
        w2c = look_at(torch.tensor(eye, dtype=torch.float32),
                      torch.tensor(target, dtype=torch.float32),
                      torch.tensor([0.0, -1.0, 0.0]))
        poses.append(w2c.numpy())
    return poses


@torch.no_grad()
def make_dataset(name: str = "room0", num_frames: int = 40, height: int = 96,
                 width: int = 128, num_gaussians: int = 4096, seed: int = 0,
                 frag_capacity: int = 128, device=None) -> SLAMDataset:
    """Render a scene's frames on ``device`` (the card by default)."""
    if name in NOT_PORTED:
        raise NotImplementedError(f"scene {name!r} is not ported yet")
    if name not in SCENES:
        raise ValueError(f"unknown scene {name!r}; registered scenes: "
                         f"{', '.join(SCENES)}")
    dev = resolve_device(device)
    rng = np.random.default_rng(seed + zlib.crc32(name.encode()) % 1000)
    pts, cols = _room_points(rng, name, num_gaussians)
    gt = G.from_points(torch.as_tensor(pts, device=dev),
                       torch.as_tensor(cols, device=dev),
                       capacity=num_gaussians, scale=0.045, opacity=0.85)
    f = 0.9 * width
    intr = Intrinsics(fx=f, fy=f, cx=width / 2, cy=height / 2, width=width,
                      height=height)
    plan = RasterPlan(grid=make_tile_grid(height, width), backend="kernel",
                      capacity=frag_capacity)
    frames = []
    for w2c in _trajectory(name, num_frames):
        out = render(gt, Camera(intr, torch.as_tensor(w2c, device=dev)), plan,
                     device=dev)
        depth = torch.where(out.alpha > 0.5,
                            out.depth / torch.clamp(out.alpha, min=1e-6),
                            torch.zeros_like(out.depth))
        frames.append(Frame(rgb=out.image, depth=depth, w2c_gt=w2c))
    return SLAMDataset(name=name, intrinsics=intr, frames=frames, gt_field=gt)
