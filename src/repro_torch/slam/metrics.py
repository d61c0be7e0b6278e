"""SLAM metrics: ATE, PSNR and the work counters (counterpart of
``repro/slam/metrics.py``).

:class:`DeviceWork` holds int64 tensors on the session's device, so the
run-cumulative totals cannot wrap and the reference's hi/lo ``WideWork``
split is not needed; the totals equal the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple

import numpy as np
import torch


class DeviceWork(NamedTuple):
    fragments: torch.Tensor          # tile-Gaussian intersections processed
    pixels: torch.Tensor             # pixels rendered
    gaussians_iters: torch.Tensor    # alive Gaussians x iterations
    iterations: torch.Tensor
    unstable_gaussians: torch.Tensor  # optimized Gaussians x mapping iters
    sched_programs: torch.Tensor     # mapping chunk trips
    skipped_fragments: torch.Tensor  # fragments dropped by a stable mask
    densify_dropped: torch.Tensor    # new Gaussians dropped: storage full
    frag_build_rows: torch.Tensor    # rows swept by fragment-list builds


def _i64(x):
    """A count as int64: a tensor converted on its device, a host number
    kept a Python int (added to a device counter as a scalar operand, so
    no host-to-device copy)."""
    return x.to(torch.int64) if isinstance(x, torch.Tensor) else int(x)


def device_work_zero(device="cpu") -> DeviceWork:
    z = torch.zeros((), dtype=torch.int64, device=device)
    return DeviceWork(*([z] * len(DeviceWork._fields)))


def device_work_add(w: DeviceWork, fragments, pixels, alive, unstable=None,
                    programs=0, skipped=0) -> DeviceWork:
    """One iteration's work; ``unstable`` defaults to ``alive``."""
    if unstable is None:
        unstable = alive
    return w._replace(
        fragments=w.fragments + _i64(fragments),
        pixels=w.pixels + _i64(pixels),
        gaussians_iters=w.gaussians_iters + _i64(alive),
        iterations=w.iterations + 1,
        unstable_gaussians=w.unstable_gaussians + _i64(unstable),
        sched_programs=w.sched_programs + _i64(programs),
        skipped_fragments=w.skipped_fragments + _i64(skipped),
    )


def device_work_merge(a: DeviceWork, b: DeviceWork) -> DeviceWork:
    return DeviceWork(*(x + y for x, y in zip(a, b)))


class ImbalanceStats(NamedTuple):
    """WSU workload-imbalance counters over one grid's program loads.

    ``tail_ratio`` (max / mean fragments per program) is what pairwise
    scheduling attacks: how many times longer the heaviest program runs
    than the average one."""

    max_load: float    # fragments in the heaviest program
    mean_load: float   # mean fragments per program
    tail_ratio: float  # max / mean (1.0 = perfectly balanced)


def imbalance_stats(loads) -> ImbalanceStats:
    """Per-program fragment-load imbalance of ``loads`` (P,): per-tile
    counts for the unscheduled grid, ``schedule.pair_loads`` for the WSU
    grid.  A tensor is copied to the host (one sync)."""
    if isinstance(loads, torch.Tensor):
        loads = loads.cpu().numpy()
    loads = np.asarray(loads, np.float64)
    mx = float(loads.max()) if loads.size else 0.0
    mean = float(loads.mean()) if loads.size else 0.0
    return ImbalanceStats(max_load=mx, mean_load=mean,
                          tail_ratio=mx / max(mean, 1e-9))


def align_umeyama(src: np.ndarray, dst: np.ndarray):
    """Closed-form SE(3) alignment (no scale) of src -> dst, both (F, 3)."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    cs, cd = src - mu_s, dst - mu_d
    U, _, Vt = np.linalg.svd(cs.T @ cd)
    S = np.diag([1.0, 1.0, np.sign(np.linalg.det(Vt.T @ U.T))])
    R = Vt.T @ S @ U.T
    return R, mu_d - R @ mu_s


def ate_rmse(est_w2c: List[np.ndarray], gt_w2c: List[np.ndarray]) -> float:
    """Absolute Trajectory Error (RMSE, meters) after SE(3) alignment."""
    est_c = np.stack([np.linalg.inv(p)[:3, 3] for p in est_w2c])
    gt_c = np.stack([np.linalg.inv(p)[:3, 3] for p in gt_w2c])
    R, t = align_umeyama(est_c, gt_c)
    aligned = est_c @ R.T + t
    return float(np.sqrt(np.mean(np.sum((aligned - gt_c) ** 2, axis=-1))))


def psnr_np(a: np.ndarray, b: np.ndarray, max_val: float = 1.0) -> float:
    mse = float(np.mean((a - b) ** 2))
    return 10.0 * np.log10(max_val ** 2 / max(mse, 1e-12))


@dataclasses.dataclass
class WorkCounters:
    """Run totals of the algorithmic work (host ints)."""

    fragments: int = 0
    pixels: int = 0
    gaussians_iters: int = 0
    iterations: int = 0
    frames: int = 0
    unstable_gaussians: int = 0
    sched_programs: int = 0
    skipped_fragments: int = 0
    densify_dropped: int = 0
    frag_build_rows: int = 0
