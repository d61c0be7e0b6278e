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
the S rows' tracking is one CUDA graph replay, their keyframe branches a
second one (skipped when the host knows no row maps), and each row equals
its solo run bit for bit.
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
so they agree bit for bit.  A keyframe's whole mapping work (densify,
the ring pushes, the mapping phase, the PSNR and its log, the
serving-cache build and the keyframe counters) is one conditional body,
as the reference's ``lax.cond`` branch is one part of its step: a graph
replay runs it or skips it on a device flag.  MonoGS and SplaTAM decide
on host integers (the frame index against a host mirror of the last
keyframe's), so their tracking-only frame skips that replay; GS-SLAM and
Photo-SLAM decide inside the keyframe graph, on the device, so each of
their frames is two replays and reads nothing back.  The keyframe
counters, the last keyframe's index and image and the PSNR log are
device tensors, and the densify picks are drawn ahead at init into a
table the body indexes (nothing inside a graph may draw).  §4.1's
pruning boundary is a conditional body inside the tracking graph, on the
device interval clock, so an RTGS tracking phase is one replay too.  The
other ``lax.cond`` branches are host ``if``s on host integers (the frame
index).  ``stats=`` (an
:class:`~repro_torch.slam.graphs.EngineStats`) counts dispatches, syncs
and graph replays, as the reference counts its dispatches and syncs.  A
step writes the session's trajectory and alive logs in place and
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
from repro_torch.core.keyframes import KeyframePolicy
from repro_torch.core.losses import psnr as psnr_dev
from repro_torch.core.pruning import PruneConfig, PruneState
from repro_torch.core.sorting import FragmentLists, remap_fragment_rows
from repro_torch.kernels.tile_render import raise_on_sched_fault
from repro_torch.slam import geometric
from repro_torch.slam.engine import _Stage
from repro_torch.slam.graphs import (
    EngineStats, PhaseRunner, flat, row_names, row_view, rows_segment, unflat,
)
from repro_torch.slam.map import paged as pagedmap
from repro_torch.slam.map.paged import PagedConfig, PageTable
from repro_torch.slam.metrics import (
    DeviceWork, WorkCounters, ate_rmse, device_work_merge, device_work_zero,
)
from repro_torch.train import optimizer as optim
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
    paged: Optional[PagedConfig] = None     # PagedMap: each step on the
                                    # frame's frustum-culled working set
                                    # (needs fused)
    # Not ported yet: setting it raises.
    sched_bucket: int = 1           # WSU trip bucketing: only 1 (no rounding)

    def __post_init__(self):
        if self.sched_bucket != 1:
            raise NotImplementedError(
                "SLAMConfig: sched_bucket not ported to repro_torch yet")


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
    S axis, with ``is_kf`` a tuple of S bools or an (S,) bool tensor."""

    pose: torch.Tensor          # (4, 4) estimated w2c after tracking
    is_kf: object               # a host bool (MonoGS, SplaTAM) or a () bool
                                # tensor on the device (GS-SLAM, Photo-SLAM)
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
    kf_count: torch.Tensor      # () int64 populated ring slots (<= W)
    kf_total: torch.Tensor      # () int64 keyframes so far
    last_kf_idx: torch.Tensor   # () int64
    last_kf_rgb: torch.Tensor   # (H, Wd, 3) for the photoslam policy
    prev_rgb: torch.Tensor      # (H, Wd, 3) previous frame (photoslam
    prev_depth: torch.Tensor    # (H, Wd)     geometric tracking)
    kf_psnr: torch.Tensor       # (F,) per-keyframe PSNR log (NaN pad)
    alive_log: torch.Tensor     # (F,) int64
    work: DeviceWork            # run-cumulative counters (int64)
    frags: FragmentLists        # lists of the map at the last keyframe pose
    kf_picks: torch.Tensor      # (F, 2P) int64 densify picks drawn ahead:
                                # row k is the pick of the (k+1)-th keyframe
                                # after init (densify_picks)
    rng: torch.Generator        # drew kf_picks
    tile_baselines: dict        # {num_tiles: (T,) i32} §4.1 churn baselines
                                # parked across §4.2 factor switches
    page: Optional[PageTable] = None    # PagedMap's table (None unless
                                # cfg.paged); map_opt's rows are then the
                                # view's
    last_kf_host: Optional[int] = None  # last_kf_idx on the host where the
                                # policy decides from frame counts (MonoGS,
                                # SplaTAM); None where the device decides

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


def _median_linear(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """``jnp.nanmedian`` of the entries of the 1-D ``x`` where ``valid`` is
    True, without a read: the invalid entries sort to the end as +inf, the
    valid count stays on the device and picks the two middle values, which
    an even count blends as ``lo * 0.5 + hi * 0.5`` (linear quantile, where
    ``torch.median`` would return the lower one).  NaN when no entry is
    valid."""
    vals = torch.sort(torch.where(valid, x, torch.full_like(x, float("inf")))).values
    n = valid.sum()
    q = (n - 1).to(torch.float32) * 0.5
    lo, hi = torch.floor(q), torch.ceil(q)
    hw = q - lo

    def at(i):
        return vals.index_select(0, i.to(torch.int64).clamp(min=0).reshape(1))[0]

    med = at(lo) * (1.0 - hw) + at(hi) * hw
    return torch.where(n > 0, med, torch.full_like(med, float("nan")))


def _densify_perm(rng: torch.Generator, intr: Intrinsics, cfg: SLAMConfig):
    """Densification's random pick: a permutation of its ``2P`` candidates
    (fewer on a frame of fewer pixels), drawn on the session's generator."""
    n = min(2 * cfg.densify_per_kf, intr.height * intr.width)
    return torch.randperm(n, generator=rng, device=rng.device)


def densify_picks(rng: torch.Generator, intr: Intrinsics, cfg: SLAMConfig,
                  rows: int) -> torch.Tensor:
    """The densify picks of a session's first ``rows`` keyframes after
    init, drawn ahead on its generator in the order the keyframes take
    them: nothing inside a graph may draw, and which keyframe a frame is
    may be known only on the device.  (rows, 2P) int64."""
    return torch.stack([_densify_perm(rng, intr, cfg) for _ in range(rows)])


def _densify_core(g: G.GaussianField, rgb, depth, rendered, w2c,
                  intr: Intrinsics, cfg: SLAMConfig, rng: torch.Generator,
                  perm: Optional[torch.Tensor] = None, c2w=None):
    """Add Gaussians where the current render misses observed geometry:
    rank pixels by error (stable sort: the many zero scores tie), take a
    random ``P`` of the top ``2P``, back-project them.  Reads nothing back
    to the host.

    ``perm`` (a permutation of ``range(2P)``) fixes the random pick, so a
    test can feed the reference's ``jax.random`` draw; otherwise it comes
    from ``rng``.  ``c2w``, if given, is ``w2c``'s inverse (the keyframe
    segment takes it from before its graph).  Returns ``(g, dropped)``."""
    per = cfg.densify_per_kf
    err = torch.abs(rendered - rgb).mean(-1)
    score = torch.where(depth > 1e-3, err, torch.zeros_like(err)).reshape(-1)
    cand = torch.argsort(-score, stable=True)[: per * 2]
    if perm is None:
        perm = _densify_perm(rng, intr, cfg)
    sel = cand[perm.to(cand.device)][:per]
    vv, uu = sel // err.shape[1], sel % err.shape[1]
    d = depth[vv, uu]
    ok = d > 1e-3
    x_cam = torch.stack([(uu + 0.5 - intr.cx) / intr.fx * d,
                         (vv + 0.5 - intr.cy) / intr.fy * d, d], -1)
    if c2w is None:
        c2w = torch.linalg.inv_ex(w2c).inverse     # no error check: no sync
    pts = x_cam @ c2w[:3, :3].T + c2w[:3, 3]
    cols = torch.clamp(rgb[vv, uu], 0.02, 0.98)
    scale = _median_linear(d, ok) / intr.fx * 2.0
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


def _push_ring(buf: torch.Tensor, row: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """Append ``row`` to a fixed-shape oldest-first ring, as the reference
    does: write slot ``min(count, W - 1)`` while filling, shift left once
    full, and select by ``count >= W`` on the device (``count`` a () int64
    tensor), so one graph serves every fill."""
    w = buf.shape[0]
    appended = buf.index_copy(0, count.clamp(max=w - 1).reshape(1), row[None])
    shifted = torch.cat([buf[1:], row[None]], dim=0)
    return torch.where(count >= w, shifted, appended)


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

    # The bootstrap mapping, its PSNR and the serving-cache build: one run
    # of one segment (the reference's ``_boot_fn`` is one dispatch).
    _, (boot,) = runner.run(
        ("boot", cfg.backend), _boot_segment(st),
        {**flat("g", g), "masked": masked, "kf_w2c": kf_w2c, "kf_rgb": kf_rgb,
         "kf_depth": kf_depth}, iters=st._map_dispatches(False) + 1)
    g, map_opt = unflat(boot, "g", G.GaussianField), _adam_of(boot)
    page = None
    if cfg.paged is not None:
        # The bootstrap mapped the whole pool (frame 0 sees the whole seed
        # map).  The first page table; the Adam moments parked at the
        # frame-0 view's shape (every keyframe re-inits them, so only the
        # (M, ...) shape matters).
        page = pagedmap.build_page_table(g, cfg.paged)
        map_opt = optim.gather_rows(map_opt, st._working_set(page, pose0, kf_w2c))
    kf_psnr = torch.full((num_f,), float("nan"), dtype=torch.float32, device=dev)
    kf_psnr[0] = boot["psnr"]
    alive_log = torch.zeros((num_f,), dtype=torch.int64, device=dev)
    alive_log[0] = boot["alive"]
    traj = torch.zeros((num_f, 4, 4), dtype=torch.float32, device=dev)
    traj[0] = pose0
    rng = torch.Generator(device=dev)
    rng.manual_seed(seed)
    _charge(stats, runner, before)

    def count(v):
        return torch.full((), v, dtype=torch.int64, device=dev)

    return SlamSession(
        cfg=cfg, intr=intr, stages=stages, g=g, map_opt=map_opt,
        pstate=pstate, masked=masked,
        pose=pose0, velocity=torch.eye(4, dtype=torch.float32, device=dev),
        traj=traj, frame_idx=1, kf_rgb=kf_rgb, kf_depth=kf_depth,
        kf_w2c=kf_w2c, kf_count=count(1), kf_total=count(1), last_kf_idx=count(0),
        last_kf_rgb=rgb0, prev_rgb=rgb0, prev_depth=depth0,
        kf_psnr=kf_psnr, alive_log=alive_log, work=unflat(boot, "work", DeviceWork),
        frags=unflat(boot, "frags", FragmentLists),
        kf_picks=densify_picks(rng, intr, cfg, num_f), rng=rng,
        tile_baselines=tile_baselines, page=page,
        last_kf_host=0 if cfg.keyframe.on_host else None)


def _adam_of(t: dict) -> AdamState:
    """The map's Adam state that :func:`~repro_torch.slam.graphs.flat`
    named under ``"opt"``."""
    return AdamState(step=t["opt.step"],
                     mu={k: t[f"opt.mu.{k}"] for k in G.PARAM_FIELDS},
                     nu={k: t[f"opt.nu.{k}"] for k in G.PARAM_FIELDS})


def _boot_segment(st: _Stage):
    """``session_init``'s bootstrap mapping over the ring's first slot,
    then its PSNR, alive count and the serving-cache build, as one segment
    (``_boot_fn`` of ``repro/slam/session.py``)."""
    cfg = st.cfg

    def fn(t):
        g, masked = unflat(t, "g", G.GaussianField), t["masked"]
        opt0 = Adam(lr=cfg.lr_map).init(G.params_of(g))
        with torch.enable_grad():
            g, opt, work, _, image = st._map_scan_masked(
                g, masked, opt0, t["kf_w2c"], t["kf_rgb"], t["kf_depth"], 1,
                device_work_zero(st.device))
        # The serving-cache build below sweeps the pool once more.
        work = work._replace(frag_build_rows=work.frag_build_rows + g.capacity)
        return {**flat("g", g), **flat("opt", opt), **flat("work", work),
                "psnr": psnr_dev(image, t["kf_rgb"][0]), "alive": g.alive.sum(),
                **flat("frags", st._build(g, masked, t["kf_w2c"][0]))}

    return fn


def _keyframe_segment(st: _Stage, sparse: bool):
    """A keyframe's mapping work over the tensors :func:`_keyframe_inputs`
    names, in the order of the reference's ``map_branch``
    (``repro/slam/session.py:552-611``): the eval render at the tracked
    pose, densification (the pick of the caller's ``perm``, else row
    ``kf_total - 1`` of the session's ``picks``), under ``sparse`` the
    newcomers' stability reset, a fresh map Adam state, the three ring
    pushes at the device fill ``kf_count``, the mapping phase, its PSNR
    (written to the log at ``kf_total``; past the log the write is dropped,
    as the reference's out-of-range update is) and the serving-cache build
    (dense: renders from outside see the whole map); then the keyframe
    counters, ``last_kf_idx`` and ``last_kf_rgb``.

    In paged mode (``cfg.paged``) all of it runs on the frame's working set
    (the input ``view_idx`` from tracking), as the reference's step does
    (``:474-499, 596-601, 638-651``): the segment gathers the view's rows
    of the map, the mask and the stability leaves from storage, remaps the
    serving-cache lists to storage rows, scatters the map and the leaves
    back and rebuilds the page table."""
    cfg, intr = st.cfg, st.intr
    paged = cfg.paged is not None
    leaf_names = ("p.grad_ema", "p.age", "p.stable") if sparse else ()

    def fn(t):
        g, masked, pose = unflat(t, "g", G.GaussianField), t["masked"], t["pose"]
        count, total = t["kf_count"], t["kf_total"]
        leaves = {k: t[k] for k in leaf_names}
        if paged:
            view_idx = t["view_idx"]
            g = pagedmap.gather_field(g, view_idx)
            masked = masked.index_select(0, view_idx)
            leaves = {k: v.index_select(0, view_idx) for k, v in leaves.items()}
        if "perm" in t:
            perm = t["perm"]
        else:
            picks = t["picks"]
            perm = picks.index_select(
                0, (total - 1).clamp(0, picks.shape[0] - 1).reshape(1))[0]
        rendered = st._render_eval_core(g, masked, pose)
        g2, dropped = _densify_core(g, t["rgb"], t["depth"], rendered, pose, intr,
                                    cfg, None, perm, c2w=t["c2w"])
        stable = None
        if sparse:
            ema, age, stable = pruning.reset_born(
                leaves["p.grad_ema"], leaves["p.age"], leaves["p.stable"],
                g2.alive & ~g.alive)
            leaves = {"p.grad_ema": ema, "p.age": age, "p.stable": stable}
        g = g2
        opt0 = Adam(lr=cfg.lr_map).init(G.params_of(g))
        ring = {k: _push_ring(t[k], row, count)
                for k, row in (("kf_rgb", t["rgb"]), ("kf_depth", t["depth"]),
                               ("kf_w2c", pose))}
        filled = torch.clamp(count + 1, max=cfg.map_window)
        with torch.enable_grad():
            g, opt, work, losses, image = st._map_scan_masked(
                g, masked, opt0, ring["kf_w2c"], ring["kf_rgb"], ring["kf_depth"],
                filled, device_work_zero(st.device), stable)
        # The densify-eval render above and the serving-cache build below
        # each build one fragment list over g's rows.
        work = work._replace(densify_dropped=work.densify_dropped + dropped,
                             frag_build_rows=work.frag_build_rows + 2 * g.capacity)
        frags = st._build(g, masked, pose)
        out = {}
        if paged:
            frags = remap_fragment_rows(frags, view_idx)
            g = pagedmap.scatter_field(unflat(t, "g", G.GaussianField), g, view_idx)
            leaves = {k: t[k].index_copy(0, view_idx, v) for k, v in leaves.items()}
            # The keyframe is the only step that admits rows: newcomers move
            # from nursery pages to their Morton page.  Between keyframes the
            # table only over-covers (pruning shrinks pages, never grows them).
            out = flat("page", pagedmap.build_page_table(g, cfg.paged))
        psnr = psnr_dev(image, t["rgb"])
        log = t["kf_psnr"]
        at = total.clamp(max=log.shape[0] - 1).reshape(1)
        log = log.index_copy(0, at, torch.where(total < log.shape[0], psnr.reshape(1),
                                                log.index_select(0, at)))
        return {**out, **leaves, **ring, **flat("g", g), **flat("opt", opt),
                **flat("work", work), "losses": losses, "psnr": psnr,
                **flat("frags", frags), "kf_count": filled, "kf_total": total + 1,
                "kf_psnr": log, "last_kf_idx": t["idx"], "last_kf_rgb": t["rgb"]}

    return fn


# The session state a keyframe writes (the keyframe segment's carry): its
# map and Adam state, serving cache, page table and stability leaves (the
# names under these prefixes), and these.
_KF_STATE = ("kf_rgb", "kf_depth", "kf_w2c", "kf_count", "kf_total", "kf_psnr",
             "last_kf_idx", "last_kf_rgb")
_KF_STATE_PREFIXES = ("g.", "opt.", "frags.", "page.", "p.")


def _keyframe_inputs(sess: SlamSession, g, masked, pstate, rgb, depth, pose,
                     view_idx, perm) -> dict:
    """One row's inputs of the keyframe segment: the tracked map, the
    frame, the tracked pose and what must not run inside a graph, its
    inverse; the session's keyframe state; the densify pick (the caller's
    ``perm``, else the session's pick table) and the frame index."""
    cfg, dev = sess.cfg, sess.device
    t = {**flat("g", g), **flat("opt", sess.map_opt), **flat("frags", sess.frags),
         "masked": masked, "rgb": rgb, "depth": depth, "pose": pose,
         "c2w": torch.linalg.inv_ex(pose).inverse, "kf_rgb": sess.kf_rgb,
         "kf_depth": sess.kf_depth, "kf_w2c": sess.kf_w2c, "kf_count": sess.kf_count,
         "kf_total": sess.kf_total, "kf_psnr": sess.kf_psnr,
         "last_kf_idx": sess.last_kf_idx, "last_kf_rgb": sess.last_kf_rgb,
         "idx": torch.full((), sess.frame_idx, dtype=torch.int64, device=dev)}
    if perm is not None:
        t["perm"] = perm.to(dev)
    else:
        t["picks"] = sess.kf_picks
    if cfg.paged is not None:
        t.update(view_idx=view_idx, **flat("page", sess.page))
    if cfg.sparse_opt:
        t.update({"p.grad_ema": pstate.grad_ema, "p.age": pstate.age,
                  "p.stable": pstate.stable})
    return t


def _kf_decision(kp: KeyframePolicy):
    """GS-SLAM's and Photo-SLAM's decision on one row's keyframe inputs:
    the pose distance to the newest ring pose, or the RMSE against the
    last keyframe's image (``repro/slam/session.py:461-470, 538-545``)."""
    def decide(t):
        if kp.kind == "gsslam":
            last = t["kf_w2c"].index_select(0, (t["kf_count"] - 1).reshape(1))[0]
            return kp.device_decision(cur_pose=t["pose"], last_kf_pose=last)
        return kp.device_decision(cur_rgb=t["rgb"], last_kf_rgb=t["last_kf_rgb"])
    return decide


@torch.no_grad()
def _keyframe_rows(rows: List[SlamSession], gs, masks, pstates, obs, poses,
                   view_idxs, perms, flags) -> List[dict]:
    """The keyframe branch of S rows (one device, config and runner) as one
    run of the S-row keyframe segment: one graph replay when fused on the
    card, in which row ``s``'s mapping work runs under its flag
    (``flags[s]``, the host's decision, or ``None``: the device's,
    :func:`_kf_decision`), as the reference's ``lax.cond`` runs its
    ``map_branch``.  Returns each row's keyframe state (carried through
    when its flag is False), work, map losses, PSNR and flag."""
    cfg, st, dev = rows[0].cfg, rows[0].stage, rows[0].device
    sparse = cfg.sparse_opt
    inputs = {}
    for s, (sess, g, masked, pstate, (rgb, depth), pose, view_idx, perm) in enumerate(
            zip(rows, gs, masks, pstates, obs, poses, view_idxs, perms)):
        inputs.update(row_names(s, _keyframe_inputs(sess, g, masked, pstate, rgb, depth,
                                                    pose, view_idx, perm)))
    carry = [k for k in row_view(0, inputs)
             if k in _KF_STATE or k.startswith(_KF_STATE_PREFIXES)]
    defaults = {**flat("work", device_work_zero(dev)),
                "losses": torch.zeros((cfg.iters_map,), dtype=torch.float32, device=dev),
                "psnr": torch.full((), float("nan"), dtype=torch.float32, device=dev)}
    # Eager, a keyframe counts densify's eval render, densify, the mapping
    # phase's calls and the serving-cache build.
    return rows[0].runner.run_when(
        ("keyframe", cfg.backend, sparse, len(rows)), _kf_decision(cfg.keyframe),
        _keyframe_segment(st, sparse), inputs, flags, carry, defaults,
        iters=2 + st._map_dispatches(sparse) + 1)


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
    pruning to accumulate), as one S-row segment of the shared runner; in
    paged mode the segment also computes each row's working set.  Returns
    each row's ``(xi, work, losses, fired, view_idx)``."""
    cfg, intr, dev = rows[0].cfg, rows[0].intr, rows[0].device
    k, st = cfg.iters_track, rows[0].stage

    def segment(t):
        pts_w, cols, _, valid = geometric.backproject_grid(
            t["prev_rgb"], t["prev_depth"], t["pose"], intr, stride=4)
        out = {"xi": geometric.geometric_track(
            intr, t["base"], pts_w, cols, valid, t["rgb"], t["depth"], iters=k,
            lr_pose=cfg.lr_pose)}
        if cfg.paged is not None:
            out["view_idx"] = st._working_set(unflat(t, "page", PageTable), t["base"],
                                              t["kf_w2c"])
        return out

    inputs = {}
    for s, (sess, base, (rgb, depth)) in enumerate(zip(rows, bases, obs)):
        view = ({**flat("page", sess.page), "kf_w2c": sess.kf_w2c}
                if cfg.paged is not None else {})
        inputs.update(row_names(s, dict(
            prev_rgb=sess.prev_rgb, prev_depth=sess.prev_depth, pose=sess.pose,
            base=base, rgb=rgb, depth=depth, **view)))
    _, runs = rows[0].runner.run(("geometric", k, len(rows)),
                                 rows_segment([segment] * len(rows)), inputs, iters=k)
    out = []
    for s in range(len(rows)):
        work = device_work_zero(dev)
        work = work._replace(
            pixels=work.pixels + (intr.height // 4) * (intr.width // 4) * k,
            iterations=work.iterations + k)
        run = row_view(s, runs[0])
        out.append((run["xi"], work,
                    torch.zeros((k,), dtype=torch.float32, device=dev),
                    torch.zeros((k,), dtype=torch.bool, device=dev),
                    run.get("view_idx")))
    return out


def _step_rows(rows: List["SlamSession"], obs, factor: int, perms,
               stats: Optional[EngineStats]):
    """One step of each session of ``rows`` (one device, config and
    runner), each on its own ``(rgb, depth)`` of ``obs``: the solo step's
    work for every row, with the S rows' tracking as one run of an S-row
    segment and their keyframe branches as one run of the S-row keyframe
    segment, each row's under its own flag.  MonoGS and SplaTAM decide on
    the host from the frame counts (a step the host knows has no keyframe
    row skips the keyframe segment); GS-SLAM and Photo-SLAM inside the
    keyframe segment, on the device.  Returns the advanced sessions and
    their step results."""
    runner = rows[0].runner
    before = dataclasses.replace(runner.stats)
    rows = [_maybe_retile(sess, factor) for sess in rows]
    cfg, dev, kp = rows[0].cfg, rows[0].device, rows[0].cfg.keyframe
    perms = perms if perms is not None else [None] * len(rows)
    idxs = [sess.frame_idx for sess in rows]
    flags = [kp.host_decision(i, None if sess.last_kf_host is None
                              else i - sess.last_kf_host)
             for sess, i in zip(rows, idxs)]

    # Each row's (xi, work, losses, fired, view_idx); pruning also changes
    # g and pstate.  In paged mode ``view_idx`` is the frame's working set,
    # computed inside tracking and passed to the keyframe segment.
    bases = [sess.velocity @ sess.pose for sess in rows]
    gs, pstates = [sess.g for sess in rows], [sess.pstate for sess in rows]
    paged = cfg.paged is not None
    if cfg.base_algo == "photoslam":
        tracked = _track_geometric(rows, bases, obs)
    else:
        st_t = rows[0].stage_at(factor)
        obs_t = [(downsample_image(rgb, factor), downsample_depth(depth, factor))
                 for rgb, depth in obs]
        out = st_t._track_rows([
            (sess.g, sess.cur_masked, sess.pstate, base, o_rgb, o_depth,
             device_work_zero(dev))
            for sess, base, (o_rgb, o_depth) in zip(rows, bases, obs_t)],
            [(sess.page, sess.kf_w2c) for sess in rows] if paged else None)
        tracked = [o[:5] for o in out]
        gs, pstates = [o[5] for o in out], [o[6] for o in out]

    with torch.no_grad():
        new_poses = [lie.se3_exp(t[0]) @ base for t, base in zip(tracked, bases)]
        velocities = [p @ torch.linalg.inv_ex(sess.pose).inverse
                      for p, sess in zip(new_poses, rows)]
    # A row stepped past its logs (a free serving slot on blank frames)
    # drops the writes, as the reference's out-of-range updates do.
    for sess, i, p in zip(rows, idxs, new_poses):
        if i < sess.max_frames:
            sess.traj[i] = p

    masks = [pstate.masked if pstate is not None else sess.masked
             for sess, pstate in zip(rows, pstates)]
    if any(f is not False for f in flags):
        kf_out = _keyframe_rows(rows, gs, masks, pstates, obs, new_poses,
                                [t[4] for t in tracked], perms, flags)
    else:
        kf_out = [None] * len(rows)

    out_rows, results = [], []
    for sess, i, (rgb, depth), g, pstate, (_, work_t, track_losses, fired, _), \
            new_pose, velocity, kf in zip(rows, idxs, obs, gs, pstates, tracked,
                                          new_poses, velocities, kf_out):
        sess = sess.replace(pstate=pstate)
        if kf is None:
            sess = sess.replace(g=g)
            is_kf, work_m = False, device_work_zero(dev)
            map_losses = torch.zeros((cfg.iters_map,), dtype=torch.float32, device=dev)
            psnr_v = torch.full((), float("nan"), dtype=torch.float32, device=dev)
        else:
            if cfg.sparse_opt:
                sess = sess.replace(pstate=pstate._replace(
                    grad_ema=kf["p.grad_ema"], age=kf["p.age"], stable=kf["p.stable"]))
            is_kf, work_m = kf["when"], unflat(kf, "work", DeviceWork)
            map_losses, psnr_v = kf["losses"], kf["psnr"]
            sess = sess.replace(
                g=unflat(kf, "g", G.GaussianField), map_opt=_adam_of(kf),
                frags=unflat(kf, "frags", FragmentLists),
                page=unflat(kf, "page", PageTable) if paged else None,
                **{k: kf[k] for k in _KF_STATE})
        if sess.last_kf_host is not None and is_kf:
            sess = sess.replace(last_kf_host=i)

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
    ones with the keyframe count) and assemble a :class:`SLAMResult`.  The
    integer read also takes the runner's device counts of keyframe bodies
    run, which it folds into the kernel launch counters.  On the card's WSU
    path it also reads the scheduled kernels' fault word."""
    if sess.batch is not None:
        raise ValueError("session_finalize takes a solo session; copy a row "
                         "out of a stack with session_row first")
    runner = sess.runner
    before = dataclasses.replace(runner.stats)
    n = sess.frame_idx
    if sess.stage.scheduled and sess.device.type == "cuda":
        raise_on_sched_fault(sess.device)
        runner.count(dispatches=0, syncs=1)
    removed = (sess.pstate.removed if sess.pstate is not None
               else torch.zeros((), dtype=torch.int64, device=sess.device))
    runs = runner.run_counts()
    runs = runs if runs is not None else torch.zeros((0,), dtype=torch.int64,
                                                     device=sess.device)
    floats = torch.cat([sess.traj[:n].reshape(-1), sess.kf_psnr]).cpu()
    ints = torch.cat([sess.alive_log[:n], torch.stack(list(sess.work)),
                      removed.reshape(1).to(torch.int64), sess.kf_total.reshape(1),
                      runs]).cpu().tolist()
    runner.count(dispatches=0, syncs=2)
    if runs.numel():
        runner.fold_run_counts(ints[-runs.numel():])
    n_kf = ints[n + len(DeviceWork._fields) + 1]
    traj = floats[:16 * n].reshape(n, 4, 4).numpy()
    est = [traj[i] for i in range(n)]
    gt = [np.asarray(p) for p in gt_w2c] if gt_w2c is not None else []
    ate = ate_rmse(est, gt[:n]) if len(gt) >= n >= 2 else float("nan")
    n_work = len(DeviceWork._fields)
    _charge(stats, runner, before)
    return SLAMResult(
        est_w2c=est, gt_w2c=gt,
        keyframe_psnr=[float(x) for x in floats[16 * n:16 * n + n_kf]],
        ate=ate,
        work=WorkCounters(frames=n, **dict(zip(DeviceWork._fields,
                                               ints[n:n + n_work]))),
        alive_per_frame=ints[:n],
        wall_time_s=wall_time_s,
        prune_removed=ints[n + n_work],
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
    step writes its logs in place), its pick table and keyframe counters
    included, and the same config, stages and runner."""
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
    segment (one graph replay, pruning boundaries included), and their keyframe
    branches one run of the S-row keyframe segment (one replay, each row's
    mapping under its own flag), which a frame-step the host knows has no
    keyframe row skips.  Nothing is read back.  Returns the advanced stack
    and the stacked :class:`StepResult` (``is_kf`` a tuple of S bools for
    MonoGS and SplaTAM, an (S,) bool tensor on the device for GS-SLAM and
    Photo-SLAM).

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

    flags = [r.is_kf for r in results]
    if any(isinstance(f, torch.Tensor) for f in flags):
        flags = stack(*(torch.as_tensor(f, device=stacked.device) for f in flags))
    res = StepResult(
        pose=stack(*(r.pose for r in results)),
        is_kf=tuple(flags) if isinstance(flags, list) else flags,
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
    every :meth:`step` steps all rows (one graph replay, or two when a row
    may take a keyframe); :meth:`swap` admits or retires a sequence by replacing a
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


def warm_keyframe(template: SlamSession, batch: int = 1) -> None:
    """Capture the ``batch``-row keyframe graph of ``template``'s config
    (its sparse form under ``cfg.sparse_opt``; the window fill and the
    flags are device values, so it serves every fill and every mix of
    keyframe rows) by one scratch run on ``batch`` copies of it, each on
    its own previous frame.  The capture runs every body once; the run
    itself maps nothing where the host decides (its flags are False), and
    where the device decides, what the copies' decisions say."""
    rows = [copy_session(template) for _ in range(batch)]
    view_idx = [sess.stage._working_set(sess.page, sess.pose, sess.kf_w2c)
                if sess.cfg.paged is not None else None for sess in rows]
    on_host = template.cfg.keyframe.on_host
    _keyframe_rows(rows, [sess.g for sess in rows], [sess.cur_masked for sess in rows],
                   [sess.pstate for sess in rows],
                   [(sess.prev_rgb, sess.prev_depth) for sess in rows],
                   [sess.pose for sess in rows], view_idx, [None] * batch,
                   [False if on_host else None] * batch)


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
    densify pick (tests only).  A device keyframe flag (GS-SLAM,
    Photo-SLAM) is read only where the §4.2 schedule needs it, as the
    reference's ``run_sequence`` reads it (one sync per frame)."""
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
        if cfg.downsample.enabled:
            if isinstance(res.is_kf, torch.Tensor):
                stats.syncs += 1    # the keyframe flag's read
            if res.is_kf:
                last_kf_idx = idx
    if sess.device.type == "cuda":
        torch.cuda.synchronize(sess.device)
    return session_finalize(sess, gt_w2c=[f.w2c_gt for f in dataset.frames],
                            wall_time_s=time.perf_counter() - t0, stats=stats)
