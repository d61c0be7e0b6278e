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

Scaling up, :func:`step_many` steps S stacked sessions
(:func:`stack_sessions`) in lockstep through the phase runner they share:
a frame-step in which no row takes a keyframe is one CUDA graph replay
for all S rows, and each row equals its solo run bit for bit.
:class:`SessionPool` is the host wrapper that admits and retires sessions
by swapping rows.

The base algorithms are MonoGS, GS-SLAM, Photo-SLAM (geometric tracking,
``slam/geometric.py``) and SplaTAM, each with its keyframe policy.

The reference traces the step into one XLA dispatch.  Here
``SLAMConfig.fused`` (the default) runs each phase's iterations as CUDA
graph replays on the card (the same segments, through the same static
buffers and with no capture, on the CPU; ``slam/graphs.py``) through a
phase runner shared by every session of one device, config and
intrinsics (:func:`runner_for`: a session of a config already served
captures nothing), and
``fused=False`` runs them eagerly, one iteration after another, as the
oracle.  Both run the same kernels on the same inputs in the same order,
so they agree bit for bit.  ``lax.cond`` branches are host ``if``s on
host integers (frame index, keyframe ring fill, the pruning interval
clock), which costs no device sync.  GS-SLAM's and Photo-SLAM's keyframe
decisions read one device value each per frame, a fired pruning boundary
reads one and densification three.  ``stats=`` (an
:class:`~repro_torch.slam.graphs.EngineStats`) counts dispatches, syncs
and graph replays, as the reference counts its dispatches and syncs.  A
step writes the session's trajectory, PSNR and alive logs in place and
returns the advanced session: the session passed in is consumed, as the
reference's donated buffers are.

Everything runs on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import gaussians as G
from repro_torch.core import lie, pruning
from repro_torch.core.camera import Intrinsics
from repro_torch.core.downsample import (
    DownsampleConfig, downsample_depth, downsample_image, side_factor,
)
from repro_torch.core.keyframes import KeyframePolicy, read_decisions
from repro_torch.core.losses import psnr as psnr_dev
from repro_torch.core.pruning import PruneConfig, PruneState
from repro_torch.core.sorting import FragmentLists
from repro_torch.kernels.tile_render import raise_on_sched_fault
from repro_torch.slam import geometric
from repro_torch.slam.engine import _Stage
from repro_torch.slam.graphs import (
    EngineStats, PhaseRunner, row_names, row_view, rows_segment,
)
from repro_torch.slam.metrics import (
    DeviceWork, WorkCounters, ate_rmse, device_work_merge, device_work_zero,
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
    fused: bool = True              # each phase's iterations as CUDA graph
                                    # replays (the same segments, no
                                    # capture, on the CPU); False: eager
                                    # per-iteration oracle
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
    dispatches: int = 0             # see slam/graphs.py for the units
    syncs: int = 0

    @property
    def mean_psnr(self) -> float:
        return float(np.mean(self.keyframe_psnr)) if self.keyframe_psnr else 0.0


class StepResult(NamedTuple):
    """One step's results; :func:`step_many` stacks them along a leading
    S axis, with ``is_kf`` a tuple of S bools."""

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

    batch = None                # a solo session (SessionStack.batch is S)

    @property
    def device(self) -> torch.device:
        return self.pose.device

    @property
    def max_frames(self) -> int:
        return int(self.traj.shape[0])

    @property
    def stage(self) -> _Stage:
        """The full-resolution stage (mapping, densify, eval)."""
        return self.stages[1]

    @property
    def runner(self) -> PhaseRunner:
        """The session's phase runner (graphs, pool and counts), shared by
        its stages and by every session of its device, config and
        intrinsics."""
        return self.stages[1].runner

    @property
    def cur_masked(self) -> torch.Tensor:
        return self.pstate.masked if self.pstate is not None else self.masked

    def stage_at(self, factor: int) -> _Stage:
        if factor not in self.stages:
            self.stages[factor] = _Stage(self.intr, self.cfg, self.device, factor,
                                         runner=self.runner)
        return self.stages[factor]

    def replace(self, **kw) -> "SlamSession":
        return dataclasses.replace(self, **kw)


_RUNNERS: dict = {}


def runner_for(device, cfg: SLAMConfig, intr: Intrinsics) -> PhaseRunner:
    """The phase runner of every session of ``device``, ``cfg`` and
    ``intr`` (the counterpart of the reference's module-level executable
    caches): its graphs, captured once, serve all of them, solo or
    stacked, from one memory pool."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = (dev, repr(cfg), tuple(intr))
    if key not in _RUNNERS:
        _RUNNERS[key] = PhaseRunner(dev, cfg.fused)
    return _RUNNERS[key]


def cached_runners() -> List[PhaseRunner]:
    """Every phase runner :func:`runner_for` has made in this process."""
    return list(_RUNNERS.values())


def _as_image(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def frame_arrays(frame, device=None):
    """A frame's ``(rgb, depth)`` as float32 tensors, on ``device`` if one
    is given: a dataset frame (``.rgb`` / ``.depth``) or a pair."""
    rgb, depth = (frame.rgb, frame.depth) if hasattr(frame, "rgb") else frame
    return _as_image(rgb, device), _as_image(depth, device)


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
    c2w = torch.linalg.inv_ex(w2c).inverse     # no error check: no sync
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


def _charge(stats: Optional[EngineStats], runner: PhaseRunner,
            before: EngineStats) -> None:
    """Add the runner's counts since ``before`` to the caller's ``stats``."""
    if stats is not None:
        stats.add(runner.stats.since(before))


def session_init(dataset, cfg: SLAMConfig, *, max_frames: Optional[int] = None,
                 seed: int = 0, device=None,
                 stats: Optional[EngineStats] = None) -> SlamSession:
    """Seed the map from frame 0 and bootstrap its mapping.  The returned
    session has consumed frame 0."""
    dev = resolve_device(device)
    intr = dataset.intrinsics
    if cfg.downsample.enabled and (intr.height % 64 or intr.width % 64):
        raise ValueError(
            "dynamic downsampling needs 64-divisible frames (16-pixel tiles "
            f"at the 4x stage); got {intr.height}x{intr.width}")
    runner = runner_for(dev, cfg, intr)
    before = dataclasses.replace(runner.stats)
    st = _Stage(intr, cfg, dev, runner=runner)
    stages = {1: st}
    f0 = dataset.frames[0]
    num_f = int(max_frames or dataset.num_frames)
    w, h, wd = cfg.map_window, intr.height, intr.width

    g = _seed_map(dataset, cfg, dev)
    runner.count(dispatches=0, syncs=2)     # frame 0's depth and colors
    pstate = (pruning.init_state(g, st.grid.num_tiles, cfg.prune)
              if cfg.prune else None)
    # One parked baseline per §4.2 grid, the -1 sentinel ("no comparable
    # baseline") until that grid first reaches a boundary.
    tile_baselines = {}
    if cfg.prune and cfg.downsample.enabled:
        for f in (1, 2, 4):
            stages.setdefault(f, _Stage(intr, cfg, dev, f, runner=runner))
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
    _charge(stats, runner, before)
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
    sess.runner.count(syncs=3)      # densify's three boolean-mask reads
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
    # Past the log (a free serving slot) the write is dropped, as the
    # reference's out-of-range updates are.
    if sess.kf_total < sess.kf_psnr.shape[0]:
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


def _track_geometric(rows, bases, obs):
    """Photo-SLAM's tracking of each session of ``rows``: frame-to-frame
    direct odometry from its previous frame (no render, so nothing for
    pruning to accumulate), as one S-row segment of the shared runner.
    Returns each row's ``(xi, work, losses, fired)``."""
    cfg, intr, dev = rows[0].cfg, rows[0].intr, rows[0].device
    k = cfg.iters_track

    def segment(t):
        pts_w, cols, _, valid = geometric.backproject_grid(
            t["prev_rgb"], t["prev_depth"], t["pose"], intr, stride=4)
        return {"xi": geometric.geometric_track(
            intr, t["base"], pts_w, cols, valid, t["rgb"], t["depth"], iters=k,
            lr_pose=cfg.lr_pose)}

    inputs = {}
    for s, (sess, base, (rgb, depth)) in enumerate(zip(rows, bases, obs)):
        inputs.update(row_names(s, dict(
            prev_rgb=sess.prev_rgb, prev_depth=sess.prev_depth, pose=sess.pose,
            base=base, rgb=rgb, depth=depth)))
    _, runs = rows[0].runner.run(("geometric", k, len(rows)),
                                 rows_segment([segment] * len(rows)), inputs, iters=k)
    out = []
    for s in range(len(rows)):
        work = device_work_zero(dev)
        work = work._replace(
            pixels=work.pixels + (intr.height // 4) * (intr.width // 4) * k,
            iterations=work.iterations + k)
        out.append((row_view(s, runs[0])["xi"], work,
                    torch.zeros((k,), dtype=torch.float32, device=dev),
                    torch.zeros((k,), dtype=torch.bool, device=dev)))
    return out


def _step_rows(rows: List["SlamSession"], obs, factor: int, perms,
               stats: Optional[EngineStats]):
    """One step of each session of ``rows`` (one device, config and
    runner), each on its own ``(rgb, depth)`` of ``obs``: the solo step's
    work for every row, with the S rows' tracking as one run of an S-row
    segment and every device keyframe decision read in one transfer.
    Returns the advanced sessions and their step results."""
    runner = rows[0].runner
    before = dataclasses.replace(runner.stats)
    rows = [_maybe_retile(sess, factor) for sess in rows]
    cfg, dev, kp = rows[0].cfg, rows[0].device, rows[0].cfg.keyframe
    perms = perms if perms is not None else [None] * len(rows)
    idxs = [sess.frame_idx for sess in rows]
    since = [sess.frame_idx - sess.last_kf_idx for sess in rows]

    # GS-SLAM decides after tracking; the others before it.
    pre_kf = [kp.kind != "gsslam" and kp.keyframe_test(
        i, d, cur_rgb=rgb, last_kf_rgb=sess.last_kf_rgb)
        for sess, i, d, (rgb, _) in zip(rows, idxs, since, obs)]
    if kp.kind in ("gsslam", "photoslam"):
        pre_kf = read_decisions(pre_kf)
        runner.count(dispatches=0, syncs=1)     # the policy's device reads
    else:
        pre_kf = [bool(x) for x in pre_kf]

    # Each row's (xi, work, losses, fired); pruning also changes g and
    # pstate.
    bases = [sess.velocity @ sess.pose for sess in rows]
    gs, pstates = [sess.g for sess in rows], [sess.pstate for sess in rows]
    if cfg.base_algo == "photoslam":
        tracked = _track_geometric(rows, bases, obs)
    else:
        st_t = rows[0].stage_at(factor)
        obs_t = [(downsample_image(rgb, factor), downsample_depth(depth, factor))
                 for rgb, depth in obs]
        if cfg.prune is not None:
            out = st_t._track_rows_prune([
                (sess.g, sess.pstate, base, o_rgb, o_depth,
                 st_t._build_core(sess.g, sess.cur_masked, base), device_work_zero(dev))
                for sess, base, (o_rgb, o_depth) in zip(rows, bases, obs_t)])
            gs, pstates = [o[1] for o in out], [o[2] for o in out]
            tracked = [(xi, w, losses, fired) for xi, _, _, w, losses, fired in out]
        else:
            tracked = st_t._track_rows_noprune([
                (sess.g, sess.cur_masked, base, o_rgb, o_depth, device_work_zero(dev))
                for sess, base, (o_rgb, o_depth) in zip(rows, bases, obs_t)])

    with torch.no_grad():
        new_poses = [lie.se3_exp(t[0]) @ base for t, base in zip(tracked, bases)]
        velocities = [p @ torch.linalg.inv_ex(sess.pose).inverse
                      for p, sess in zip(new_poses, rows)]
    # A row stepped past its logs (a free serving slot on blank frames)
    # drops the writes, as the reference's out-of-range updates do.
    for sess, i, p in zip(rows, idxs, new_poses):
        if i < sess.max_frames:
            sess.traj[i] = p

    if kp.kind == "gsslam":
        is_kfs = read_decisions([
            kp.keyframe_test(i, d, cur_pose=p, last_kf_pose=sess.kf_w2c[sess.kf_count - 1])
            for sess, i, d, p in zip(rows, idxs, since, new_poses)])
    else:
        is_kfs = pre_kf

    out_rows, results = [], []
    for sess, i, (rgb, depth), g, pstate, (_, work_t, track_losses, fired), \
            new_pose, velocity, is_kf, perm in zip(
                rows, idxs, obs, gs, pstates, tracked, new_poses, velocities,
                is_kfs, perms):
        masked = pstate.masked if pstate is not None else sess.masked
        sess = sess.replace(pstate=pstate)
        if is_kf:
            sess, work_m, map_losses, psnr_v = _map_branch(
                sess, g, masked, rgb, depth, new_pose, perm)
            sess = sess.replace(last_kf_idx=i, last_kf_rgb=rgb)
        else:
            sess = sess.replace(g=g)
            work_m = device_work_zero(dev)
            map_losses = torch.zeros((cfg.iters_map,), dtype=torch.float32, device=dev)
            psnr_v = torch.full((), float("nan"), dtype=torch.float32, device=dev)

        alive_now = sess.g.alive.sum()
        if i < sess.max_frames:
            sess.alive_log[i] = alive_now
        step_work = device_work_merge(work_t, work_m)
        out_rows.append(sess.replace(
            pose=new_pose, velocity=velocity, frame_idx=i + 1, prev_rgb=rgb,
            prev_depth=depth, work=device_work_merge(sess.work, step_work)))
        results.append(StepResult(pose=new_pose, is_kf=is_kf, psnr=psnr_v,
                                  alive=alive_now, work=step_work,
                                  track_losses=track_losses, fired=fired,
                                  map_losses=map_losses))
    _charge(stats, runner, before)
    return out_rows, results


def session_step(sess: SlamSession, frame, *, factor: int = 1,
                 perm: Optional[torch.Tensor] = None,
                 stats: Optional[EngineStats] = None):
    """Advance the session by one frame; returns ``(session, StepResult)``.
    ``factor`` is the §4.2 side factor of this frame's tracking (the host
    chooses it, as :func:`run_sequence` does).  ``perm`` fixes the densify
    pick on a keyframe (see ``_densify_core``)."""
    if sess.batch is not None:
        raise ValueError("session_step takes a solo session; use step_many "
                         "for stacked sessions")
    rows, results = _step_rows([sess], [frame_arrays(frame, sess.device)],
                               factor, [perm], stats)
    return rows[0], results[0]


def session_finalize(sess: SlamSession, gt_w2c=None, *,
                     wall_time_s: float = 0.0,
                     stats: Optional[EngineStats] = None) -> SLAMResult:
    """Fetch the session's logs (two reads: the float logs, the integer
    ones) and assemble a :class:`SLAMResult`.  On the card's WSU path it
    also reads the scheduled kernels' fault word."""
    if sess.batch is not None:
        raise ValueError("session_finalize takes a solo session; copy a row "
                         "out of a stack with session_row first")
    runner = sess.runner
    before = dataclasses.replace(runner.stats)
    n, n_kf = sess.frame_idx, sess.kf_total
    if sess.stage.scheduled and sess.device.type == "cuda":
        raise_on_sched_fault(sess.device)
        runner.count(dispatches=0, syncs=1)
    removed = (sess.pstate.removed if sess.pstate is not None
               else torch.zeros((), dtype=torch.int64, device=sess.device))
    floats = torch.cat([sess.traj[:n].reshape(-1), sess.kf_psnr[:n_kf]]).cpu()
    ints = torch.cat([sess.alive_log[:n], torch.stack(list(sess.work)),
                      removed.reshape(1).to(torch.int64)]).cpu().tolist()
    runner.count(dispatches=0, syncs=2)
    traj = floats[:16 * n].reshape(n, 4, 4).numpy()
    est = [traj[i] for i in range(n)]
    gt = [np.asarray(p) for p in gt_w2c] if gt_w2c is not None else []
    ate = ate_rmse(est, gt[:n]) if len(gt) >= n >= 2 else float("nan")
    n_work = len(DeviceWork._fields)
    _charge(stats, runner, before)
    return SLAMResult(
        est_w2c=est, gt_w2c=gt,
        keyframe_psnr=[float(x) for x in floats[16 * n:]],
        ate=ate,
        work=WorkCounters(frames=n, **dict(zip(DeviceWork._fields,
                                               ints[n:n + n_work]))),
        alive_per_frame=ints[:n],
        wall_time_s=wall_time_s,
        prune_removed=ints[-1],
        dispatches=stats.dispatches if stats is not None else 0,
        syncs=stats.syncs if stats is not None else 0)


# ---------------------------------------------------------------------------
# stacked sessions: S streams stepped in lockstep
# ---------------------------------------------------------------------------


class Observation(NamedTuple):
    """One lockstep frame batch on the device: row ``s`` is session
    ``s``'s frame."""

    rgb: torch.Tensor     # (S, H, W, 3) float32
    depth: torch.Tensor   # (S, H, W) float32, 0 = invalid


def _copy(x):
    """A deep copy of a session field: tensors cloned, a generator with
    the same state, containers rebuilt, host values shared."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, torch.Generator):
        out = torch.Generator(device=x.device)
        out.set_state(x.get_state())
        return out
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{f.name: _copy(getattr(x, f.name))
                                         for f in dataclasses.fields(x)})
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_copy(v) for v in x))
    if isinstance(x, dict):
        return {k: _copy(v) for k, v in x.items()}
    return x


def copy_session(sess: SlamSession) -> SlamSession:
    """A copy of ``sess`` that shares no tensor or generator with it (a
    step writes its logs in place and draws from its generator), and the
    same config, stages and runner."""
    return dataclasses.replace(sess, stages=dict(sess.stages), **{
        f.name: _copy(getattr(sess, f.name)) for f in dataclasses.fields(sess)
        if f.name not in ("cfg", "intr", "stages")})


@dataclasses.dataclass
class SessionStack:
    """S solo sessions of one device, config and intrinsics, stepped in
    lockstep by :func:`step_many` through the phase runner they share.
    Made by :func:`stack_sessions`; :func:`session_row` copies a row
    out."""

    rows: List[SlamSession]

    @property
    def batch(self) -> int:
        return len(self.rows)

    @property
    def cfg(self) -> SLAMConfig:
        return self.rows[0].cfg

    @property
    def intr(self) -> Intrinsics:
        return self.rows[0].intr

    @property
    def device(self) -> torch.device:
        return self.rows[0].device

    @property
    def runner(self) -> PhaseRunner:
        return self.rows[0].runner

    @property
    def max_frames(self) -> int:
        return self.rows[0].max_frames

    def swap_row(self, slot: int, new_session: SlamSession) -> SlamSession:
        """Put a copy of ``new_session`` in row ``slot``; returns the row it
        replaces (which the stack no longer holds)."""
        old = self.rows[slot]
        self.rows[slot] = copy_session(new_session)
        return old


def _static_key(sess) -> tuple:
    return (repr(sess.cfg), tuple(sess.intr), sess.device, id(sess.runner))


def stack_sessions(sessions: Sequence[SlamSession]) -> SessionStack:
    """Stack copies of solo sessions for :func:`step_many`.  All sessions
    must share one device, config and intrinsics (and so one runner)."""
    sessions = list(sessions)
    if any(sess.batch is not None for sess in sessions):
        raise ValueError("stack_sessions takes solo sessions, not stacks")
    keys = {_static_key(sess) for sess in sessions}
    if len(keys) != 1:
        raise ValueError("stack_sessions needs sessions with identical "
                         "static config (device, SLAMConfig, intrinsics); "
                         f"got {len(keys)} distinct ones")
    return SessionStack(rows=[copy_session(sess) for sess in sessions])


def session_row(stacked: SessionStack, i: int) -> SlamSession:
    """A copy of row ``i`` of a stack as a solo session, which
    :func:`session_step` continues bit for bit."""
    return copy_session(stacked.rows[i])


def require_servable(cfg: SLAMConfig, what: str = "step_many") -> None:
    """Validate that a config can serve stacked multi-session steps:
    ``fused=True`` and downsampling off (the §4.2 side factor is a host
    choice per step that one shared step cannot make per session).  Shared
    by :func:`step_many` and the serving tier."""
    if not cfg.fused:
        raise ValueError(f"{what} requires cfg.fused=True")
    if cfg.downsample.enabled:
        raise ValueError(f"{what} requires downsampling disabled (the "
                         "side factor is a per-step host choice)")


def stack_observations(frames, batch: int, device=None) -> Observation:
    """Coerce S per-session frames (or an already stacked
    :class:`Observation`) to one :class:`Observation` on ``device``."""
    if isinstance(frames, Observation):
        return frames
    rows = [frame_arrays(f, device) for f in frames]
    if len(rows) != batch:
        raise ValueError(f"expected {batch} frames, got {len(rows)}")
    return Observation(rgb=torch.stack([r for r, _ in rows]),
                       depth=torch.stack([d for _, d in rows]))


def step_many(stacked: SessionStack, frames, *,
              stats: Optional[EngineStats] = None,
              perms: Optional[Sequence[Optional[torch.Tensor]]] = None
              ) -> Tuple[SessionStack, StepResult]:
    """Advance S stacked sessions by one frame each.  ``frames`` is a
    sequence of S per-session frames or an :class:`Observation`; ``perms``
    fixes each row's densify pick (tests only).  Each row does its solo
    step's work, bit for bit: the S rows' tracking is one run of an S-row
    segment (one graph replay when no row prunes), each keyframe row then
    maps in slot order through the shared runner, and GS-SLAM's and
    Photo-SLAM's decisions of all rows are read in one transfer.  Returns
    the advanced stack and the stacked :class:`StepResult` (``is_kf`` a
    tuple of S bools).

    Serving constraints (:func:`require_servable`): ``cfg.fused=True`` and
    downsampling disabled."""
    if stacked.batch is None:
        raise ValueError("step_many takes a stacked session "
                         "(see stack_sessions)")
    require_servable(stacked.cfg)
    obs = stack_observations(frames, stacked.batch, stacked.device)
    rows, results = _step_rows(
        stacked.rows, [(obs.rgb[s], obs.depth[s]) for s in range(stacked.batch)],
        1, perms, stats)

    def stack(*xs):
        return torch.stack(xs)

    res = StepResult(
        pose=stack(*(r.pose for r in results)),
        is_kf=tuple(r.is_kf for r in results),
        psnr=stack(*(r.psnr for r in results)),
        alive=stack(*(r.alive for r in results)),
        work=DeviceWork(*(stack(*xs) for xs in zip(*(r.work for r in results)))),
        track_losses=stack(*(r.track_losses for r in results)),
        fired=stack(*(r.fired for r in results)),
        map_losses=stack(*(r.map_losses for r in results)))
    return SessionStack(rows=rows), res


def validate_admission(new_session: SlamSession, stacked: SessionStack) -> None:
    """Shared admission preconditions for pool row swaps
    (:class:`SessionPool` and the serving tier's ``ShardedPool``): equal
    static config, solo shape, matching trajectory capacity."""
    if new_session.batch is not None:
        raise ValueError("admit a solo session, not a stack")
    if _static_key(new_session) != _static_key(stacked.rows[0]):
        raise ValueError("admitted session's static config differs from "
                         "the pool's")
    if new_session.max_frames != stacked.max_frames:
        raise ValueError(
            "admitted session's max_frames "
            f"({new_session.max_frames}) must match the pool's "
            f"({stacked.max_frames}); pass max_frames= to session_init")


class SessionPool:
    """Host wrapper serving S concurrent SLAM streams through one stack:
    every :meth:`step` steps all rows (one graph replay when no row takes a
    keyframe); :meth:`swap` admits or retires a sequence by replacing a
    row (the other rows' work is untouched: rows are independent)."""

    def __init__(self, sessions: Sequence[SlamSession]):
        self._stacked = stack_sessions(sessions)
        self.stats = EngineStats()

    @property
    def size(self) -> int:
        return self._stacked.batch

    @property
    def stacked(self) -> SessionStack:
        return self._stacked

    def session(self, slot: int) -> SlamSession:
        return session_row(self._stacked, slot)

    def step(self, frames, perms=None) -> StepResult:
        """Advance every slot by one frame.  Returns the stacked
        :class:`StepResult`."""
        self._stacked, res = step_many(self._stacked, frames, stats=self.stats,
                                       perms=perms)
        return res

    def swap(self, slot: int, new_session: SlamSession) -> SlamSession:
        """Retire the session in ``slot`` (returned as a solo session) and
        admit (a copy of) ``new_session`` in its place."""
        validate_admission(new_session, self._stacked)
        return self._stacked.swap_row(slot, new_session)

    def finalize(self, slot: int, gt_w2c=None, **kw) -> SLAMResult:
        return session_finalize(self.session(slot), gt_w2c=gt_w2c,
                                stats=self.stats, **kw)


def warm_keyframe(template: SlamSession) -> None:
    """Capture the mapping graphs a keyframe of ``template``'s config
    reaches (the sparse ones under ``cfg.sparse_opt``; the window fill is
    a device tensor, so they serve every fill) by one scratch keyframe on
    a copy of it, on its own previous frame."""
    sess = copy_session(template)
    _map_branch(sess, sess.g, sess.cur_masked, sess.prev_rgb, sess.prev_depth,
                sess.pose, None)


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
    :func:`frame_factor` chooses, finalize, counting dispatches and syncs
    in one :class:`EngineStats`.  ``perms`` maps a frame index to a fixed
    densify pick (tests only)."""
    t0 = time.perf_counter()
    stats = EngineStats()
    sess = session_init(dataset, cfg, seed=seed, device=device, stats=stats)
    last_kf_idx = 0
    for idx in range(1, dataset.num_frames):
        factor = frame_factor(dataset, idx, last_kf_idx, cfg)
        if cfg.downsample.enabled and cfg.keyframe.kind == "photoslam":
            stats.syncs += 1        # the photometric pre-decision's read
        sess, res = session_step(
            sess, dataset.frames[idx], factor=factor,
            perm=None if perms is None else perms.get(idx), stats=stats)
        if res.is_kf:
            last_kf_idx = idx
    if sess.device.type == "cuda":
        torch.cuda.synchronize(sess.device)
    return session_finalize(sess, gt_w2c=[f.w2c_gt for f in dataset.frames],
                            wall_time_s=time.perf_counter() - t0, stats=stats)
