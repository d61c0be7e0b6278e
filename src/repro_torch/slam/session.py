"""The SLAM session API (counterpart of ``repro/slam/session.py``).

* :func:`session_init` ``(dataset, cfg) -> SlamSession`` — seed the map
  from frame 0 and run its bootstrap mapping;
* :func:`session_step` ``(session, frame, factor=1) -> (session,
  StepResult)`` — the fragment build, the tracking iterations (with §4.1
  pruning when ``cfg.prune`` is set, at the §4.2 downsampling ``factor``),
  the keyframe decision and, on keyframes, densification, the
  keyframe-ring mapping (sparse over the unstable Gaussians when
  ``cfg.sparse_opt``) and the PSNR eval (always at full resolution);
* :func:`session_finalize` ``(session) -> SLAMResult``;
* :func:`run_sequence` — all three over a dataset, choosing each frame's
  downsampling factor on the host.

The base algorithms are MonoGS, GS-SLAM, Photo-SLAM (geometric tracking,
``slam/geometric.py``) and SplaTAM, each with its keyframe policy.

The reference traces the step into one XLA dispatch; here it is eager
PyTorch, so ``lax.cond`` branches are host ``if``s on host integers
(frame index, keyframe ring fill, the pruning interval clock), which costs
no device sync.  GS-SLAM's and Photo-SLAM's keyframe decisions read one
device value each per frame, and a fired pruning boundary reads one.  A step
writes the session's trajectory, PSNR and alive logs in place and returns
the advanced session: the session passed in is consumed, as the
reference's donated buffers are.

Everything runs on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import gaussians as G
from repro_torch.core import lie, pruning
from repro_torch.core.camera import Intrinsics
from repro_torch.core.downsample import (
    DownsampleConfig, downsample_depth, downsample_image, side_factor,
)
from repro_torch.core.keyframes import KeyframePolicy
from repro_torch.core.losses import psnr as psnr_dev
from repro_torch.core.pruning import PruneConfig, PruneState
from repro_torch.core.sorting import FragmentLists
from repro_torch.kernels.tile_render import raise_on_sched_fault
from repro_torch.slam import geometric
from repro_torch.slam.engine import _Stage
from repro_torch.slam.metrics import (
    DeviceWork, WorkCounters, ate_rmse, device_work_merge, device_work_totals,
    device_work_zero,
)
from repro_torch.train.optimizer import Adam, AdamState


@dataclasses.dataclass
class SLAMConfig:
    base_algo: str = "monogs"       # monogs | gsslam | photoslam | splatam
    iters_track: int = 12
    iters_map: int = 24
    lr_pose: float = 3e-3
    lr_map: float = 8e-3
    lambda_pho: float = 0.8
    capacity: int = 8192            # Gaussian pool size
    frag_capacity: int = 128        # K fragments per tile
    backend: str = "kernel"         # K1/K2 on the card, plain on the CPU;
                                    # "schedule": the WSU path, K4/K5;
                                    # "kernel_norb": no R&B stash, K1
                                    # re-run in the backward
    map_window: int = 4             # keyframes optimized jointly per iter
    densify_per_kf: int = 384
    seed_stride: int = 3
    seed_opacity: float = 0.7
    map_rebuild_stride: int = 6
    keyframe: KeyframePolicy = dataclasses.field(default_factory=KeyframePolicy)
    prune: Optional[PruneConfig] = None     # §4.1 adaptive pruning
    downsample: DownsampleConfig = dataclasses.field(
        default_factory=lambda: DownsampleConfig(enabled=False))
    sparse_opt: bool = False        # sparse stable/unstable mapping: freeze
                                    # stable Gaussians out of the Adam step,
                                    # the fragment builds and the schedule
                                    # (needs prune: the bit rides PruneState)
    # Parts of the reference not ported yet: setting any of them raises.
    paged: Optional[object] = None
    sched_bucket: int = 1           # WSU trip bucketing: only 1 (no rounding)

    def __post_init__(self):
        unported = {
            "paged": self.paged is not None,
            "sched_bucket": self.sched_bucket != 1,
        }
        bad = [k for k, v in unported.items() if v]
        if bad:
            raise NotImplementedError(
                f"SLAMConfig: {', '.join(bad)} not ported to repro_torch yet")


@dataclasses.dataclass
class SLAMResult:
    est_w2c: List[np.ndarray]
    gt_w2c: List[np.ndarray]
    keyframe_psnr: List[float]
    ate: float
    work: WorkCounters
    alive_per_frame: List[int]
    wall_time_s: float
    prune_removed: int = 0

    @property
    def mean_psnr(self) -> float:
        return float(np.mean(self.keyframe_psnr)) if self.keyframe_psnr else 0.0


class StepResult(NamedTuple):
    pose: torch.Tensor          # (4, 4) estimated w2c after tracking
    is_kf: bool
    psnr: torch.Tensor          # () post-mapping PSNR (NaN if not a keyframe)
    alive: torch.Tensor         # () alive Gaussians after the frame
    work: DeviceWork            # this frame's work
    track_losses: torch.Tensor  # (iters_track,)
    fired: torch.Tensor         # (iters_track,) bool §4.1 boundary iterations
    map_losses: torch.Tensor    # (iters_map,) (zeros if not a keyframe)


@dataclasses.dataclass
class SlamSession:
    cfg: SLAMConfig
    intr: Intrinsics
    stages: dict                # {downsampling factor: _Stage}
    g: G.GaussianField
    map_opt: AdamState
    pstate: Optional[PruneState]  # §4.1 state (None when pruning is off)
    masked: torch.Tensor        # (N,) bool mask of the prune-off path
    pose: torch.Tensor          # (4, 4) current estimated w2c
    velocity: torch.Tensor      # (4, 4) constant-velocity model
    traj: torch.Tensor          # (F, 4, 4)
    frame_idx: int              # frames processed so far
    kf_rgb: torch.Tensor        # (W, H, Wd, 3) keyframe ring, oldest first
    kf_depth: torch.Tensor      # (W, H, Wd)
    kf_w2c: torch.Tensor        # (W, 4, 4)
    kf_count: int               # populated ring slots (<= W)
    kf_total: int               # keyframes so far
    last_kf_idx: int
    last_kf_rgb: torch.Tensor   # (H, Wd, 3) for the photoslam policy
    prev_rgb: torch.Tensor      # (H, Wd, 3) previous frame (photoslam
    prev_depth: torch.Tensor    # (H, Wd)     geometric tracking)
    kf_psnr: torch.Tensor       # (F,) per-keyframe PSNR log (NaN pad)
    alive_log: torch.Tensor     # (F,) int64
    work: DeviceWork            # run-cumulative counters (int64)
    frags: FragmentLists        # lists of the map at the last keyframe pose
    rng: torch.Generator        # densify draws
    tile_baselines: dict        # {num_tiles: (T,) i32} §4.1 churn baselines
                                # parked across §4.2 factor switches

    @property
    def device(self) -> torch.device:
        return self.pose.device

    @property
    def stage(self) -> _Stage:
        """The full-resolution stage (mapping, densify, eval)."""
        return self.stages[1]

    @property
    def cur_masked(self) -> torch.Tensor:
        return self.pstate.masked if self.pstate is not None else self.masked

    def stage_at(self, factor: int) -> _Stage:
        if factor not in self.stages:
            self.stages[factor] = _Stage(self.intr, self.cfg, self.device, factor)
        return self.stages[factor]

    def replace(self, **kw) -> "SlamSession":
        return dataclasses.replace(self, **kw)


def _as_image(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _seed_map(dataset, cfg: SLAMConfig, device) -> G.GaussianField:
    """Bootstrap the map from frame 0's RGB-D (host numpy, as the
    reference does it)."""
    f0 = dataset.frames[0]
    intr = dataset.intrinsics
    depth = np.asarray(torch.as_tensor(f0.depth).cpu())
    rgb = np.asarray(torch.as_tensor(f0.rgb).cpu())
    ys = np.arange(0, intr.height, cfg.seed_stride)
    xs = np.arange(0, intr.width, cfg.seed_stride)
    vv, uu = np.meshgrid(ys, xs, indexing="ij")
    uu, vv = uu.reshape(-1), vv.reshape(-1)
    d = depth[vv, uu]
    ok = d > 1e-3
    uu, vv, d = uu[ok], vv[ok], d[ok]
    x_cam = np.stack([(uu + 0.5 - intr.cx) / intr.fx * d,
                      (vv + 0.5 - intr.cy) / intr.fy * d, d], -1)
    c2w = np.linalg.inv(np.asarray(f0.w2c_gt))
    pts = x_cam @ c2w[:3, :3].T + c2w[:3, 3]
    cols = rgb[vv, uu]
    n = min(len(pts), cfg.capacity // 2)
    mean_scale = float(np.median(d)) / intr.fx * cfg.seed_stride
    return G.from_points(
        torch.as_tensor(pts[:n], dtype=torch.float32, device=device),
        torch.as_tensor(np.clip(cols[:n], 0.02, 0.98), dtype=torch.float32,
                        device=device),
        capacity=cfg.capacity, scale=mean_scale, opacity=cfg.seed_opacity)


def _median_linear(x: torch.Tensor) -> torch.Tensor:
    """``jnp.nanmedian`` of a 1-D tensor without NaNs: the two middle values
    of an even count are blended as ``lo * 0.5 + hi * 0.5`` (linear
    quantile), where ``torch.median`` would return the lower one."""
    if x.numel() == 0:
        return torch.tensor(float("nan"), dtype=x.dtype, device=x.device)
    vals = torch.sort(x).values
    q = torch.tensor(0.5, dtype=torch.float32) * (x.numel() - 1)
    lo_i, hi_i = int(torch.floor(q)), int(torch.ceil(q))
    hw = (q - torch.floor(q)).to(x.device)
    return vals[lo_i] * (1.0 - hw) + vals[hi_i] * hw


def _densify_core(g: G.GaussianField, rgb, depth, rendered, w2c,
                  intr: Intrinsics, cfg: SLAMConfig, rng: torch.Generator,
                  perm: Optional[torch.Tensor] = None):
    """Add Gaussians where the current render misses observed geometry:
    rank pixels by error (stable sort: the many zero scores tie), take a
    random ``P`` of the top ``2P``, back-project them.

    ``perm`` (a permutation of ``range(2P)``) fixes the random pick, so a
    test can feed the reference's ``jax.random`` draw; otherwise it comes
    from ``rng``.  Returns ``(g, dropped)``."""
    per = cfg.densify_per_kf
    err = torch.abs(rendered - rgb).mean(-1)
    score = torch.where(depth > 1e-3, err, torch.zeros_like(err)).reshape(-1)
    cand = torch.argsort(-score, stable=True)[: per * 2]
    if perm is None:
        perm = torch.randperm(cand.numel(), generator=rng, device=rng.device)
    sel = cand[perm.to(cand.device)][:per]
    vv, uu = sel // err.shape[1], sel % err.shape[1]
    d = depth[vv, uu]
    ok = d > 1e-3
    x_cam = torch.stack([(uu + 0.5 - intr.cx) / intr.fx * d,
                         (vv + 0.5 - intr.cy) / intr.fy * d, d], -1)
    c2w = torch.linalg.inv(w2c)
    pts = x_cam @ c2w[:3, :3].T + c2w[:3, 3]
    cols = torch.clamp(rgb[vv, uu], 0.02, 0.98)
    scale = _median_linear(d[ok]) / intr.fx * 2.0
    n_sel = sel.numel()
    quat = torch.zeros((n_sel, 4), dtype=torch.float32, device=g.mu.device)
    quat[:, 0] = 1.0
    new = G.GaussianField(
        mu=pts,
        log_scale=torch.log(scale).expand(n_sel, 3),
        quat=quat,
        logit_o=torch.full((n_sel,), math.log(0.6 / 0.4), dtype=torch.float32,
                           device=g.mu.device),
        color=torch.log(cols / (1.0 - cols)),
        alive=ok,
    )
    n_new = ok.sum()
    n_dead = (~g.alive).sum()
    dropped = torch.clamp(torch.clamp(n_new, max=per) - n_dead, min=0)
    return G.insert(g, new, max_new=per), dropped


def _push_ring(buf: torch.Tensor, row: torch.Tensor, count: int) -> torch.Tensor:
    """Append ``row`` to an oldest-first ring: fill slot ``count``, then
    shift left once full."""
    if count >= buf.shape[0]:
        return torch.cat([buf[1:], row[None]], dim=0)
    out = buf.clone()
    out[count] = row
    return out


def session_init(dataset, cfg: SLAMConfig, *, max_frames: Optional[int] = None,
                 seed: int = 0, device=None) -> SlamSession:
    """Seed the map from frame 0 and bootstrap its mapping.  The returned
    session has consumed frame 0."""
    dev = resolve_device(device)
    intr = dataset.intrinsics
    if cfg.downsample.enabled and (intr.height % 64 or intr.width % 64):
        raise ValueError(
            "dynamic downsampling needs 64-divisible frames (16-pixel tiles "
            f"at the 4x stage); got {intr.height}x{intr.width}")
    st = _Stage(intr, cfg, dev)
    stages = {1: st}
    f0 = dataset.frames[0]
    num_f = int(max_frames or dataset.num_frames)
    w, h, wd = cfg.map_window, intr.height, intr.width

    g = _seed_map(dataset, cfg, dev)
    pstate = (pruning.init_state(g, st.grid.num_tiles, cfg.prune)
              if cfg.prune else None)
    # One parked baseline per §4.2 grid, the -1 sentinel ("no comparable
    # baseline") until that grid first reaches a boundary.
    tile_baselines = {}
    if cfg.prune and cfg.downsample.enabled:
        for f in (1, 2, 4):
            stages.setdefault(f, _Stage(intr, cfg, dev, f))
            t = stages[f].grid.num_tiles
            tile_baselines[t] = torch.full((t,), -1, dtype=torch.int32, device=dev)
    pose0 = torch.tensor(np.asarray(f0.w2c_gt), dtype=torch.float32, device=dev)
    rgb0, depth0 = _as_image(f0.rgb, dev), _as_image(f0.depth, dev)
    masked = torch.zeros((cfg.capacity,), dtype=torch.bool, device=dev)
    kf_rgb = torch.zeros((w, h, wd, 3), dtype=torch.float32, device=dev)
    kf_depth = torch.zeros((w, h, wd), dtype=torch.float32, device=dev)
    kf_rgb[0], kf_depth[0] = rgb0, depth0
    kf_w2c = pose0[None].repeat(w, 1, 1)

    map_opt0 = Adam(lr=cfg.lr_map).init(G.params_of(g))
    g, map_opt, work_m, _, image = st._map_scan_masked(
        g, masked, map_opt0, kf_w2c, kf_rgb, kf_depth, 1, device_work_zero(dev))
    # The serving-cache build below sweeps the pool once more.
    work_m = work_m._replace(frag_build_rows=work_m.frag_build_rows + g.capacity)
    kf_psnr = torch.full((num_f,), float("nan"), dtype=torch.float32, device=dev)
    kf_psnr[0] = psnr_dev(image, rgb0)
    alive_log = torch.zeros((num_f,), dtype=torch.int64, device=dev)
    alive_log[0] = g.alive.sum()
    traj = torch.zeros((num_f, 4, 4), dtype=torch.float32, device=dev)
    traj[0] = pose0
    rng = torch.Generator(device=dev)
    rng.manual_seed(seed)
    frags = st._build_core(g, masked, kf_w2c[0])
    return SlamSession(
        cfg=cfg, intr=intr, stages=stages, g=g, map_opt=map_opt,
        pstate=pstate, masked=masked,
        pose=pose0, velocity=torch.eye(4, dtype=torch.float32, device=dev),
        traj=traj, frame_idx=1, kf_rgb=kf_rgb, kf_depth=kf_depth,
        kf_w2c=kf_w2c, kf_count=1, kf_total=1, last_kf_idx=0,
        last_kf_rgb=rgb0, prev_rgb=rgb0, prev_depth=depth0,
        kf_psnr=kf_psnr, alive_log=alive_log, work=work_m,
        frags=frags, rng=rng, tile_baselines=tile_baselines)


@torch.no_grad()
def _map_branch(sess: SlamSession, g, masked, rgb, depth, new_pose, perm):
    cfg, st = sess.cfg, sess.stage
    rendered = st._render_eval_core(g, masked, new_pose)
    g2, dropped = _densify_core(g, rgb, depth, rendered, new_pose, sess.intr,
                                cfg, sess.rng, perm)
    pstate, stable = sess.pstate, None
    if cfg.sparse_opt:
        # Newcomers land in dead slots whose stale EMA and age could freeze
        # them at birth.
        pstate = pruning.mark_born(pstate, g2.alive & ~g.alive)
        stable = pstate.stable
    g = g2
    opt0 = Adam(lr=cfg.lr_map).init(G.params_of(g))
    kf_rgb = _push_ring(sess.kf_rgb, rgb, sess.kf_count)
    kf_depth = _push_ring(sess.kf_depth, depth, sess.kf_count)
    kf_w2c = _push_ring(sess.kf_w2c, new_pose, sess.kf_count)
    n2 = min(sess.kf_count + 1, cfg.map_window)
    with torch.enable_grad():
        g, map_opt, work_m, map_losses, image = st._map_scan_masked(
            g, masked, opt0, kf_w2c, kf_rgb, kf_depth, n2,
            device_work_zero(sess.device), stable)
    # The densify-eval render above and the serving-cache refresh below
    # each build one fragment list over g's rows.
    work_m = work_m._replace(
        densify_dropped=work_m.densify_dropped + dropped,
        frag_build_rows=work_m.frag_build_rows + 2 * g.capacity)
    psnr_v = psnr_dev(image, rgb)
    sess.kf_psnr[sess.kf_total] = psnr_v
    # The serving cache stays dense: renders from outside see the whole map.
    frags = st._build_core(g, masked, new_pose)
    return sess.replace(
        g=g, map_opt=map_opt, pstate=pstate, kf_rgb=kf_rgb, kf_depth=kf_depth,
        kf_w2c=kf_w2c,
        kf_count=n2, kf_total=sess.kf_total + 1,
        frags=frags), work_m, map_losses, psnr_v


def _maybe_retile(sess: SlamSession, factor: int) -> SlamSession:
    """Give the pruning state's churn baseline the tile grid of ``factor``,
    parking the displaced one in the session's ``tile_baselines``."""
    if sess.pstate is None:
        return sess
    tiles = sess.stage_at(factor).grid.num_tiles
    if sess.pstate.prev_tile_count.shape[0] == tiles:
        return sess
    baselines = dict(sess.tile_baselines)       # retile_state writes to it
    pstate = pruning.retile_state(sess.pstate, tiles, baselines)
    return sess.replace(pstate=pstate, tile_baselines=baselines)


def _track_geometric(sess: SlamSession, base, rgb, depth):
    """Photo-SLAM's tracking: frame-to-frame direct odometry from the
    previous frame (no render, so nothing for pruning to accumulate)."""
    cfg, intr, dev = sess.cfg, sess.intr, sess.device
    pts_w, cols, _, valid = geometric.backproject_grid(
        sess.prev_rgb, sess.prev_depth, sess.pose, intr, stride=4)
    xi = geometric.geometric_track(intr, base, pts_w, cols, valid, rgb, depth,
                                   iters=cfg.iters_track, lr_pose=cfg.lr_pose)
    k = cfg.iters_track
    work = device_work_zero(dev)._replace(
        pixels=torch.tensor((intr.height // 4) * (intr.width // 4) * k,
                            dtype=torch.int64, device=dev),
        iterations=torch.tensor(k, dtype=torch.int64, device=dev))
    losses = torch.zeros((k,), dtype=torch.float32, device=dev)
    fired = torch.zeros((k,), dtype=torch.bool, device=dev)
    return xi, work, losses, fired


def session_step(sess: SlamSession, frame, *, factor: int = 1,
                 perm: Optional[torch.Tensor] = None):
    """Advance the session by one frame; returns ``(session, StepResult)``.
    ``factor`` is the §4.2 side factor of this frame's tracking (the host
    chooses it, as :func:`run_sequence` does).  ``perm`` fixes the densify
    pick on a keyframe (see ``_densify_core``)."""
    sess = _maybe_retile(sess, factor)
    cfg, dev, kp = sess.cfg, sess.device, sess.cfg.keyframe
    rgb, depth = _as_image(frame.rgb, dev), _as_image(frame.depth, dev)
    idx = sess.frame_idx
    d_since = idx - sess.last_kf_idx
    g, pstate = sess.g, sess.pstate
    masked = sess.cur_masked

    # GS-SLAM decides after tracking; the others before it.
    pre_kf = kp.kind != "gsslam" and kp.is_keyframe(
        idx, d_since, cur_rgb=rgb, last_kf_rgb=sess.last_kf_rgb)

    base = sess.velocity @ sess.pose
    if cfg.base_algo == "photoslam":
        xi, work_t, track_losses, fired = _track_geometric(sess, base, rgb, depth)
    else:
        st_t = sess.stage_at(factor)
        obs_rgb = downsample_image(rgb, factor)
        obs_depth = downsample_depth(depth, factor)
        frags = st_t._build_core(g, masked, base)
        if pstate is not None:
            xi, g, pstate, work_t, track_losses, fired = st_t._track_scan_prune(
                g, pstate, base, obs_rgb, obs_depth, frags, device_work_zero(dev))
            masked = pstate.masked
        else:
            xi, work_t, track_losses, fired = st_t._track_scan_noprune(
                g, masked, base, obs_rgb, obs_depth, frags, device_work_zero(dev))
    with torch.no_grad():
        new_pose = lie.se3_exp(xi) @ base
        velocity = new_pose @ torch.linalg.inv(sess.pose)
    sess.traj[idx] = new_pose

    if kp.kind == "gsslam":
        is_kf = kp.is_keyframe(idx, d_since, cur_pose=new_pose,
                               last_kf_pose=sess.kf_w2c[sess.kf_count - 1])
    else:
        is_kf = pre_kf

    sess = sess.replace(pstate=pstate)
    if is_kf:
        sess, work_m, map_losses, psnr_v = _map_branch(
            sess, g, masked, rgb, depth, new_pose, perm)
        sess = sess.replace(last_kf_idx=idx, last_kf_rgb=rgb)
    else:
        sess = sess.replace(g=g)
        work_m = device_work_zero(dev)
        map_losses = torch.zeros((cfg.iters_map,), dtype=torch.float32, device=dev)
        psnr_v = torch.tensor(float("nan"), dtype=torch.float32, device=dev)

    alive_now = sess.g.alive.sum()
    sess.alive_log[idx] = alive_now
    step_work = device_work_merge(work_t, work_m)
    sess = sess.replace(pose=new_pose, velocity=velocity, frame_idx=idx + 1,
                        prev_rgb=rgb, prev_depth=depth,
                        work=device_work_merge(sess.work, step_work))
    return sess, StepResult(pose=new_pose, is_kf=is_kf, psnr=psnr_v,
                            alive=alive_now, work=step_work,
                            track_losses=track_losses, fired=fired,
                            map_losses=map_losses)


def session_finalize(sess: SlamSession, gt_w2c=None, *,
                     wall_time_s: float = 0.0) -> SLAMResult:
    """Fetch the session's logs and assemble a :class:`SLAMResult`.  On the
    card's WSU path it also reads the scheduled kernels' fault word."""
    n = sess.frame_idx
    if sess.stage.scheduled and sess.device.type == "cuda":
        raise_on_sched_fault(sess.device)
    traj = sess.traj[:n].cpu().numpy()
    est = [traj[i] for i in range(n)]
    gt = [np.asarray(p) for p in gt_w2c] if gt_w2c is not None else []
    ate = ate_rmse(est, gt[:n]) if len(gt) >= n >= 2 else float("nan")
    return SLAMResult(
        est_w2c=est, gt_w2c=gt,
        keyframe_psnr=[float(x) for x in sess.kf_psnr[:sess.kf_total].cpu()],
        ate=ate,
        work=WorkCounters(frames=n, **device_work_totals(sess.work)),
        alive_per_frame=[int(x) for x in sess.alive_log[:n].cpu()],
        wall_time_s=wall_time_s,
        prune_removed=int(sess.pstate.removed) if sess.pstate is not None else 0)


def frame_factor(dataset, idx: int, last_kf_idx: int, cfg: SLAMConfig) -> int:
    """The §4.2 side factor of frame ``idx``, chosen on the host before its
    step: MonoGS and SplaTAM pre-decide keyframes from the frame counts,
    Photo-SLAM from the frame's photometric change against the last
    keyframe, GS-SLAM (which decides after tracking) not at all."""
    kp, d_since = cfg.keyframe, idx - last_kf_idx
    if not cfg.downsample.enabled:
        return 1
    pre_kf = kp.kind != "gsslam" and kp.is_keyframe(
        idx, d_since, cur_rgb=dataset.frames[idx].rgb,
        last_kf_rgb=dataset.frames[last_kf_idx].rgb)
    return side_factor(d_since, pre_kf, cfg.downsample)


def run_sequence(dataset, cfg: SLAMConfig, *, device=None, seed: int = 0,
                 perms: Optional[dict] = None) -> SLAMResult:
    """Init, one :func:`session_step` per frame at the factor
    :func:`frame_factor` chooses, finalize.  ``perms`` maps a frame index
    to a fixed densify pick (tests only)."""
    t0 = time.perf_counter()
    sess = session_init(dataset, cfg, seed=seed, device=device)
    last_kf_idx = 0
    for idx in range(1, dataset.num_frames):
        sess, res = session_step(
            sess, dataset.frames[idx],
            factor=frame_factor(dataset, idx, last_kf_idx, cfg),
            perm=None if perms is None else perms.get(idx))
        if res.is_kf:
            last_kf_idx = idx
    if sess.device.type == "cuda":
        torch.cuda.synchronize(sess.device)
    return session_finalize(sess, gt_w2c=[f.w2c_gt for f in dataset.frames],
                            wall_time_s=time.perf_counter() - t0)
