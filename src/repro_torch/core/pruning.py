"""§4.1 adaptive Gaussian pruning (counterpart of ``repro/core/pruning.py``).

Importance (Eq. 7):  Score_k = ||dL/dmu_k|| + lambda * ||dL/dSigma_k||,
with ||dL/dlog_scale|| + ||dL/dquat|| as the covariance-gradient norm.  The
gradients are the ones tracking's backward already computes for the pose,
so scoring costs no extra backward pass.

Mask-prune protocol: scores accumulate over an interval of K tracking
iterations; at its end the lowest-score ``step_frac`` of the alive set
(under the global ``max_ratio`` cap) is masked (silenced, still resident),
and at the next interval end the masked set is removed for good.  K halves
when the tile-fragment counts churned by more than ``churn_threshold``
since the last boundary and doubles otherwise.

:class:`PruneState` also carries the stability bit (gradient-magnitude EMA,
low-EMA age, ``stable``) that :func:`accumulate` maintains whenever it is
given ``alive``; sparse mapping consumes it (:func:`optimizable_mask`,
:func:`mark_born`).

The reference keeps every leaf on the device and runs the boundary under
``lax.cond``.  Here the interval clock (``interval``, ``iters_left``) and
the accumulate clock (``opt_steps``) are host integers, so the boundary is
a host ``if`` that costs no sync; the one device value the host needs,
whether the churn crossed its threshold, is read once per fired boundary
(``interval_update.host_reads`` counts those reads).  Every count the
selection and the churn use is computed in float32 on the device, as the
reference does.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch._device import constant
from repro_torch.core.gaussians import GaussianField


class PruneConfig(NamedTuple):
    lam: float = 0.8            # lambda in Eq. 7
    k0: int = 5                 # initial pruning interval K0
    churn_threshold: float = 0.05
    step_frac: float = 0.10     # fraction of alive Gaussians masked per interval
    max_ratio: float = 0.5      # global pruning cap (Fig. 14a)
    k_min: int = 2
    k_max: int = 40
    # -- stability bit ------------------------------------------------------
    stable_ema_beta: float = 0.8   # EMA decay of the Eq. 7 score
    stable_rel: float = 0.5        # stable when EMA < stable_rel * mean alive EMA
    stable_thresh: float = 0.0     # absolute EMA floor OR-ed into the test
    stable_age: int = 8            # consecutive low-EMA iterations to freeze
    stable_warmup: int = 0         # accumulate() calls before bits may set


class PruneState(NamedTuple):
    score: torch.Tensor            # (N,) f32 accumulated importance this interval
    masked: torch.Tensor           # (N,) bool, mask-pruned, pending removal
    interval: int                  # current K (host)
    iters_left: int                # iterations until the interval ends (host)
    prev_tile_count: torch.Tensor  # (T,) i32 fragment counts at the last boundary
    initial_alive: torch.Tensor    # () i32 alive count at init (for the cap)
    removed: torch.Tensor          # () i32 total permanently removed
    grad_ema: torch.Tensor         # (N,) f32 Eq. 7 gradient-magnitude EMA
    age: torch.Tensor              # (N,) i32 consecutive low-EMA iterations
    stable: torch.Tensor           # (N,) bool stability bit
    opt_steps: int                 # accumulate() calls so far (host)


def init_state(g: GaussianField, num_tiles: int, cfg: PruneConfig) -> PruneState:
    n, dev = g.capacity, g.mu.device
    i32 = dict(dtype=torch.int32, device=dev)
    return PruneState(
        score=torch.zeros((n,), dtype=torch.float32, device=dev),
        masked=torch.zeros((n,), dtype=torch.bool, device=dev),
        interval=int(cfg.k0),
        iters_left=int(cfg.k0),
        prev_tile_count=torch.zeros((num_tiles,), **i32),
        initial_alive=g.num_alive().to(torch.int32),
        removed=torch.zeros((), **i32),
        grad_ema=torch.zeros((n,), dtype=torch.float32, device=dev),
        age=torch.zeros((n,), **i32),
        stable=torch.zeros((n,), dtype=torch.bool, device=dev),
        opt_steps=0,
    )


#: The gradients Eq. 7 reads: tracking differentiates these leaves only.
SCORE_FIELDS = ("mu", "log_scale", "quat")


def importance_scores(param_grads: dict, cfg: PruneConfig) -> torch.Tensor:
    """Eq. 7 from the gradients tracking's backward produced (only
    ``mu``, ``log_scale`` and ``quat`` are read)."""
    g_mu = torch.linalg.vector_norm(param_grads["mu"], dim=-1)
    g_cov = (torch.linalg.vector_norm(param_grads["log_scale"], dim=-1)
             + torch.linalg.vector_norm(param_grads["quat"], dim=-1))
    return g_mu + cfg.lam * g_cov


def accumulate(state: PruneState, param_grads: dict, cfg: PruneConfig,
               alive: Optional[torch.Tensor] = None) -> PruneState:
    """Per-tracking-iteration score accumulation.  With ``alive`` (the
    field's (N,) mask) the stability leaves are maintained from the same
    scores: EMA, the consecutive-low-EMA age and
    ``stable = alive & (age >= stable_age)`` once ``opt_steps`` has passed
    ``stable_warmup``."""
    s = importance_scores(param_grads, cfg)
    out = state._replace(score=state.score + s,
                         iters_left=state.iters_left - 1,
                         opt_steps=state.opt_steps + 1)
    if alive is None:
        return out
    ema, age, stable = stability_update(state.grad_ema, state.age, s, alive, cfg,
                                        settle=out.opt_steps >= cfg.stable_warmup)
    return out._replace(grad_ema=ema, age=age, stable=stable)


def stability_update(grad_ema: torch.Tensor, age: torch.Tensor, s: torch.Tensor,
                     alive: torch.Tensor, cfg: PruneConfig, settle):
    """One iteration of the stability leaves from the Eq. 7 scores ``s``:
    ``(grad_ema, age, stable)``, with ``stable`` all False unless
    ``settle`` (``opt_steps`` has reached ``stable_warmup``): a host bool,
    or a () bool tensor, which a CUDA graph reads at each replay.  Device
    math only."""
    alive_f = alive.to(torch.float32)
    ema = cfg.stable_ema_beta * grad_ema + (1.0 - cfg.stable_ema_beta) * s
    mean_ema = (ema * alive_f).sum() / torch.clamp(alive_f.sum(), min=1.0)
    thresh = torch.clamp(cfg.stable_rel * mean_ema, min=cfg.stable_thresh)
    low = alive & (ema < thresh)
    age = torch.where(low, age + 1, torch.zeros_like(age))
    stable = alive & (age >= cfg.stable_age)
    if isinstance(settle, torch.Tensor):
        stable = stable & settle
    elif not settle:
        stable = torch.zeros_like(stable)
    return ema, age, stable


def optimizable_mask(state: PruneState) -> torch.Tensor:
    """(N,) bool: the rows sparse mapping optimizes and rasterizes, every
    row not stability-frozen.  Dead and masked rows stay in on purpose:
    they are silenced and get zero gradients, and keeping them makes the
    all-unstable case equal the dense path bit for bit."""
    return ~state.stable


def mark_born(state: PruneState, born: torch.Tensor) -> PruneState:
    """Reset the stability of rows densification just wrote (``born``,
    (N,) bool): they land in dead slots whose stale EMA and age would
    otherwise freeze a newcomer through its first mapping phase."""
    return state._replace(
        grad_ema=torch.where(born, torch.zeros_like(state.grad_ema), state.grad_ema),
        age=torch.where(born, torch.zeros_like(state.age), state.age),
        stable=state.stable & ~born)


def effective_opacity_mask(g: GaussianField, state: PruneState) -> torch.Tensor:
    """(N,) multiplier silencing mask-pruned Gaussians in cached fragment
    lists (zero opacity renders nothing)."""
    return (~state.masked).to(torch.float32)


def retile_state(state: PruneState, num_tiles: int,
                 baselines: Optional[dict] = None) -> PruneState:
    """Give ``prev_tile_count`` the shape of a new tile grid (a §4.2 factor
    switch).  With ``baselines`` (a dict keyed by tile count, updated in
    place) the displaced grid's baseline is parked and the target grid's
    restored; a grid with no baseline gets the ``-1`` sentinel, which
    :func:`interval_update` reads as churn 0.  The (N,) leaves pass
    through untouched."""
    cur = state.prev_tile_count
    if cur.shape[0] == num_tiles:
        return state
    if baselines is not None:
        baselines[cur.shape[0]] = cur
        restored = baselines.get(num_tiles)
        if restored is not None:
            return state._replace(prev_tile_count=restored)
    return state._replace(prev_tile_count=torch.full(
        (num_tiles,), -1, dtype=torch.int32, device=cur.device))


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """A Python float as a float32 scalar, as JAX rounds a weakly typed
    constant that meets a float32 array."""
    return constant(x, torch.float32, like.device)


def interval_update(state: PruneState, g: GaussianField,
                    tile_count: torch.Tensor, cfg: PruneConfig):
    """Interval boundary: remove the previously masked set for good, mask
    the next lowest-score batch, adapt K from the tile churn.  Returns
    ``(state, g, did_anything)``; ``did_anything`` stays on the device."""
    # 1. Permanent removal of the last interval's masked set.
    alive = g.alive & ~state.masked
    removed = state.removed + (state.masked & g.alive).sum().to(torch.int32)

    # 2. The next batch: the ``want`` lowest scores among the alive.  The
    # sort is stable, so rows that tie (many score exactly 0: no fragment
    # in the tracked view) are taken in index order, as jnp.argsort does.
    alive_count = alive.sum().to(torch.int32)
    init = state.initial_alive
    floor_kept = torch.ceil(init.to(torch.float32)
                            * _f32(1.0 - cfg.max_ratio, init)).to(torch.int32)
    budget_left = torch.clamp(init - removed - floor_kept, min=0)
    want = torch.minimum(
        torch.floor(alive_count.to(torch.float32)
                    * _f32(cfg.step_frac, init)).to(torch.int32),
        budget_left)
    score = torch.where(alive, state.score, torch.full_like(state.score, float("inf")))
    order = torch.argsort(score, stable=True)
    rank = torch.empty_like(order, dtype=torch.int32).scatter_(
        0, order, torch.arange(g.capacity, dtype=torch.int32, device=order.device))
    new_mask = alive & (rank < want)

    # 3. K from the tile-fragment churn; a negative baseline is
    # retile_state's sentinel (no comparable grid): churn 0.
    prev = state.prev_tile_count
    denom = torch.clamp(prev.sum(), min=1)
    churn = torch.where((prev < 0).any(), _f32(0.0, prev),
                        (tile_count - prev).abs().sum() / denom)
    interval_update.host_reads += 1
    if bool(churn > _f32(cfg.churn_threshold, churn)):
        k_next = max(state.interval // 2, cfg.k_min)
    else:
        k_next = min(state.interval * 2, cfg.k_max)

    new_state = PruneState(
        score=torch.zeros_like(state.score),
        masked=new_mask,
        interval=k_next,
        iters_left=k_next,
        prev_tile_count=tile_count,
        initial_alive=state.initial_alive,
        removed=removed,
        grad_ema=state.grad_ema,
        age=state.age,
        stable=state.stable & alive,  # removed rows never stay frozen
        opt_steps=state.opt_steps,
    )
    return new_state, g.replace(alive=alive), want > 0


interval_update.host_reads = 0


def cond_interval_update(state: PruneState, g: GaussianField, cur_frags,
                         build_fn, cfg: PruneConfig):
    """The boundary as tracking's loop takes it: once ``iters_left`` has run
    out, rebuild the fragment lists (``build_fn(g, masked)``) and run
    :func:`interval_update`; otherwise pass everything through.  Returns
    ``(state, g, frags, fired)`` with ``fired`` a host bool."""
    if state.iters_left > 0:
        return state, g, cur_frags, False
    fresh = build_fn(g, state.masked)
    state, g, _ = interval_update(state, g, fresh.count, cfg)
    return state, g, fresh, True


def prune_ratio(state: PruneState) -> torch.Tensor:
    return state.removed / torch.clamp(state.initial_alive, min=1)
