"""Synthetic RGB-D scenes (counterpart of ``repro/slam/datasets.py``).

A procedural room — checkered back wall, gradient floor, two striped boxes
— is sampled into a ground-truth Gaussian field and rendered along a
smooth orbit through the port's ``kernel`` backend (K1 on the card).  The
recipes are the reference's; the draws come from a seeded numpy generator,
so the points are not ``jax.random``'s.  Scenes are deterministic in
``(name, seed)``:

* ``room0``, ``room1``, ``hall0`` — the room (offset per variant);
* ``desk0`` — a cluttered corner: 3/4 of the points in three tight blobs
  near the camera over a sparse wall and floor, so per-tile fragment
  counts are heavily skewed (the WSU's workload);
* ``stairs0`` — six treads and risers receding from the camera, points
  allocated quadratically toward the near steps, a sparse landing wall
  behind: depth and occupancy skew in one view;
* ``corridor0`` — floor, two walls and six pillars along z in [1, 13];
  the camera translates down it on an ease-in trajectory, so early
  geometry leaves the view for good (PagedMap's workload).
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

SCENES: tuple = ("room0", "room1", "hall0", "desk0", "stairs0", "corridor0")


def registered_scenes() -> tuple:
    return SCENES


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


# (centre, sigma, base colour) of desk0's three clutter blobs.
_DESK_BLOBS = (((-1.05, 1.15, 2.25), 0.18, (0.85, 0.35, 0.2)),
               ((-0.7, 0.85, 2.5), 0.16, (0.25, 0.7, 0.35)),
               ((-1.15, 0.7, 2.1), 0.14, (0.3, 0.4, 0.85)))


def _desk_points(rng: np.random.Generator, n: int):
    """'desk0': a sparse back wall and floor (1/8 of the points each) and
    three tight Gaussian blobs stacked in the lower-left foreground."""
    n_wall = n // 8
    n_floor = n // 8
    n_clutter = n - n_wall - n_floor

    xy = rng.uniform(-2.0, 2.0, (n_wall, 2))
    wall = np.stack([xy[:, 0], xy[:, 1] * 0.75, np.full(n_wall, 4.0)], -1)
    wall_col = np.stack([np.full(n_wall, 0.55), 0.55 + 0.1 * xy[:, 1],
                         np.full(n_wall, 0.6)], -1)

    xz = rng.uniform([-2.0, 1.0], [2.0, 4.0], (n_floor, 2))
    floor = np.stack([xz[:, 0], np.full(n_floor, 1.5), xz[:, 1]], -1)
    floor_col = np.stack([0.35 + 0.1 * xz[:, 0], np.full(n_floor, 0.3),
                          np.full(n_floor, 0.25)], -1)

    pts, cols = [wall, floor], [wall_col, floor_col]
    per = n_clutter // len(_DESK_BLOBS)
    for i, (center, sigma, base) in enumerate(_DESK_BLOBS):
        m = n_clutter - per * (len(_DESK_BLOBS) - 1) if i == 0 else per
        p = np.asarray(center) + sigma * rng.standard_normal((m, 3))
        stripes = np.floor((p[:, 0] + p[:, 1]) * 8) % 2
        pts.append(p)
        cols.append(np.asarray(base)[None, :] * (0.55 + 0.45 * stripes[:, None]))
    return (np.concatenate(pts).astype(np.float32),
            np.clip(np.concatenate(cols), 0.02, 0.98).astype(np.float32))


def _stairs_points(rng: np.random.Generator, n: int):
    """'stairs0': six steps climbing away from the camera, each half tread
    (horizontal) and half riser (vertical), then a sparse landing wall at
    z = 5 (1/8 of the points); 8 mm of noise on every point."""
    n_wall = n // 8
    n_steps, k_steps = n - n_wall, 6
    # Step k (0 = nearest) gets weight (K - k)^2; the remainder goes to 0.
    w = np.array([(k_steps - k) ** 2 for k in range(k_steps)], np.float64)
    counts = np.floor(n_steps * w / w.sum()).astype(int)
    counts[0] += n_steps - int(counts.sum())
    pts, cols = [], []
    for k, m in enumerate(counts):
        u = rng.uniform(0.0, 1.0, (m, 2))
        z0, y0 = 1.5 + 0.55 * k, 1.5 - 0.28 * k
        m_t = m // 2
        tread = np.stack([(u[:m_t, 0] - 0.5) * 3.2, np.full(m_t, y0),
                          z0 + u[:m_t, 1] * 0.55], -1)
        riser = np.stack([(u[m_t:, 0] - 0.5) * 3.2, y0 + u[m_t:, 1] * 0.28,
                          np.full(m - m_t, z0)], -1)
        p = np.concatenate([tread, riser], 0)
        stripes = np.floor(p[:, 0] * 4) % 2
        shade = 0.35 + 0.09 * k
        pts.append(p)
        cols.append(np.stack([shade + 0.25 * stripes, np.full(m, 0.3 + 0.05 * k),
                              np.full(m, 0.65 - 0.06 * k)], -1))

    xy = rng.uniform(-2.0, 2.0, (n_wall, 2))
    pts.append(np.stack([xy[:, 0] * 0.8, xy[:, 1] * 0.6 - 0.4,
                         np.full(n_wall, 5.0)], -1))
    cols.append(np.stack([np.full(n_wall, 0.6), 0.5 + 0.1 * xy[:, 1],
                          np.full(n_wall, 0.45)], -1))
    pts = np.concatenate(pts)
    pts = pts + 0.008 * rng.standard_normal(pts.shape)
    return (pts.astype(np.float32),
            np.clip(np.concatenate(cols), 0.02, 0.98).astype(np.float32))


def _corridor_points(rng: np.random.Generator, n: int):
    """'corridor0': a z-striped floor (1/4 of the points), two checkered
    side walls at x = -1.5 and 1.5 (1/4 each) and six pillars 2 m apart,
    alternating sides; 8 mm of noise on every point."""
    z0, z1 = 1.0, 13.0
    n_pairs = 6
    n_floor = n // 4
    n_wall = n // 4
    n_pillar = n - n_floor - 2 * n_wall

    xz = rng.uniform([-1.5, z0], [1.5, z1], (n_floor, 2))
    floor = np.stack([xz[:, 0], np.full(n_floor, 1.5), xz[:, 1]], -1)
    fstripe = np.floor(xz[:, 1] * 1.5) % 2
    floor_col = np.stack([0.3 + 0.2 * fstripe, np.full(n_floor, 0.32),
                          0.25 + 0.1 * (xz[:, 1] - z0) / (z1 - z0)], -1)
    pts, cols = [floor], [floor_col]

    for x_side in (-1.5, 1.5):
        yz = rng.uniform([-0.6, z0], [1.5, z1], (n_wall, 2))
        check = (np.floor(yz[:, 0] * 2) + np.floor(yz[:, 1] * 1.2)) % 2
        pts.append(np.stack([np.full(n_wall, x_side), yz[:, 0], yz[:, 1]], -1))
        cols.append(np.stack([0.25 + 0.5 * check, 0.35 + 0.15 * check,
                              0.7 - 0.4 * check * (0.5 + x_side / 3.0)], -1))

    per = n_pillar // n_pairs
    for i in range(n_pairs):
        m = n_pillar - per * (n_pairs - 1) if i == 0 else per
        side = 1.0 if i % 2 == 0 else -1.0
        centre = np.array([side * 1.0, 0.7, z0 + 1.0 + 2.0 * i])
        pts.append(rng.standard_normal((m, 3)) * np.array([0.12, 0.45, 0.12]) + centre)
        hue = i / max(n_pairs - 1, 1)
        cols.append(np.stack([np.full(m, 0.85 - 0.5 * hue), np.full(m, 0.3 + 0.5 * hue),
                              np.full(m, 0.35)], -1))
    pts = np.concatenate(pts)
    pts = pts + 0.008 * rng.standard_normal(pts.shape)
    return (pts.astype(np.float32),
            np.clip(np.concatenate(cols), 0.02, 0.98).astype(np.float32))


def _surface_points(rng: np.random.Generator, name: str, n: int):
    if name.startswith("desk"):
        return _desk_points(rng, n)
    if name.startswith("stairs"):
        return _stairs_points(rng, n)
    if name.startswith("corridor"):
        return _corridor_points(rng, n)
    return _room_points(rng, name, n)


def _look_at(eye, target) -> np.ndarray:
    return look_at(torch.tensor(eye, dtype=torch.float32),
                   torch.tensor(target, dtype=torch.float32),
                   torch.tensor([0.0, -1.0, 0.0])).numpy()


def _trajectory(name: str, num_frames: int) -> List[np.ndarray]:
    """Smooth arc orbiting the scene centre with mild vertical bobbing;
    ``corridor0`` instead translates straight down the corridor (z from 0
    to 4, looking ahead) with an ease-in (z ~ t^2), so the per-frame step
    grows from ~0 and the constant-velocity model can bootstrap."""
    ts = np.linspace(0.0, 1.0, num_frames)
    if name.startswith("corridor"):
        return [_look_at(np.array([0.2 * np.sin(3.0 * t),
                                   0.45 + 0.05 * np.sin(5.0 * t), 4.0 * t * t]),
                         np.array([0.1 * np.sin(3.0 * t + 0.5), 0.6,
                                   4.0 * t * t + 3.0]))
                for t in ts]
    poses = []
    for t in ts:
        ang = (t - 0.5) * _ARC.get(name, 0.9)
        eye = np.array([1.4 * np.sin(ang), 0.25 * np.sin(2.2 * ang),
                        0.9 - 0.9 * np.cos(ang)])
        target = np.array([0.4 * np.sin(ang * 0.5), 0.5, 3.0])
        poses.append(_look_at(eye, target))
    return poses


@torch.no_grad()
def make_dataset(name: str = "room0", num_frames: int = 40, height: int = 96,
                 width: int = 128, num_gaussians: int = 4096, seed: int = 0,
                 frag_capacity: int = 128, device=None) -> SLAMDataset:
    """Render a scene's frames on ``device`` (the card by default)."""
    if name not in SCENES:
        raise ValueError(f"unknown scene {name!r}; registered scenes: "
                         f"{', '.join(SCENES)}")
    dev = resolve_device(device)
    rng = np.random.default_rng(seed + zlib.crc32(name.encode()) % 1000)
    pts, cols = _surface_points(rng, name, num_gaussians)
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
