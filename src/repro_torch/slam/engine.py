"""The SLAM step engine's cores as plain loops (counterpart of
``repro/slam/engine.py``).

The reference fuses each phase into one ``lax.scan`` dispatch.  PyTorch
runs eagerly, so each scan becomes a Python loop over iterations, each
``lax.cond`` a host ``if`` and each ``vmap`` over the keyframe window a
loop over views.  Every mapping iteration still renders the whole window
as ONE batched raster call (one stacked forward and one stacked backward
launch).  On the ``schedule`` backend a WSU schedule rides next to each
cached fragment list and is rebuilt only where the list is.  A stage
renders at one §4.2 downsampling factor; tracking with §4.1 pruning
(``_track_scan_prune``) accumulates the importance scores from the
tracking gradients and takes each interval boundary as a host ``if``.
With ``cfg.sparse_opt`` mapping freezes the stability-frozen Gaussians out
of the Adam step, the fragment builds and the WSU schedule, and composites
every iteration's render over one stable-background render per phase.
"""

from __future__ import annotations

import torch

from repro_torch.core import gaussians as G
from repro_torch.core import lie, pruning
from repro_torch.core.camera import Camera, Intrinsics
from repro_torch.core.losses import slam_loss
from repro_torch.core.raster_api import RasterPlan
from repro_torch.core.render import render
from repro_torch.core.schedule import scheduled_trips
from repro_torch.core.sorting import (
    FragmentLists, build_fragment_lists, count_skipped_fragments, make_tile_grid,
    stack_fragment_lists, tile_trips, update_fragment_slot,
)
from repro_torch.core.projection import project
from repro_torch.kernels.ops import build_plan_schedule
from repro_torch.slam.metrics import DeviceWork, device_work_add
from repro_torch.train.optimizer import (
    Adam, AdamState, apply_updates, apply_updates_masked,
)


def silence(g: G.GaussianField, masked: torch.Tensor) -> G.GaussianField:
    """Masked or dead Gaussians render as nothing."""
    off = masked | ~g.alive
    return g.replace(logit_o=torch.where(off, torch.full_like(g.logit_o, -30.0),
                                         g.logit_o))


def _pose_adam_zero(device) -> AdamState:
    z = torch.zeros(6, dtype=torch.float32, device=device)
    return AdamState(step=torch.zeros((), dtype=torch.int32, device=device),
                     mu={"xi": z}, nu={"xi": z})


def _slot(stack, b: int):
    """Window slot ``b`` of stacked fragment lists or schedules."""
    return type(stack)(*(x[b] for x in stack))


class _Stage:
    """The cores at one resolution: ``factor`` is the §4.2 per-side
    downsampling factor of the frames this stage renders."""

    def __init__(self, intr: Intrinsics, cfg, device: torch.device,
                 factor: int = 1):
        self.factor = factor
        self.intr = intr.scaled(factor)
        self.grid = make_tile_grid(self.intr.height, self.intr.width)
        self.plan = RasterPlan(grid=self.grid, backend=cfg.backend,
                               capacity=cfg.frag_capacity)
        # WSU: carry a schedule next to each cached fragment list.
        self.scheduled = cfg.backend == "schedule"
        self.pixels = self.intr.height * self.intr.width
        self.cfg = cfg
        self.device = device
        # Sparse stable/unstable mapping reads the stability bit that
        # PruneState carries, so it needs pruning on.
        if cfg.sparse_opt and cfg.prune is None:
            raise ValueError("sparse_opt=True requires cfg.prune (the "
                             "stability bit rides PruneState)")

    def _render(self, g, w2c, frags=None, sched=None):
        return render(g, Camera(self.intr, w2c), self.plan.with_sched(sched),
                      frags=frags, device=self.device)

    # ---- cores -----------------------------------------------------------

    @torch.no_grad()
    def _build_core(self, g, masked, w2c, keep=None) -> FragmentLists:
        proj = project(silence(g, masked), Camera(self.intr, w2c))
        return build_fragment_lists(proj, self.grid, self.cfg.frag_capacity,
                                    keep)

    @torch.no_grad()
    def _sparse_build_core(self, g, masked, keep, w2c):
        """The fragment lists of the rows in ``keep`` only, and the ()
        int32 count of fragments the mask dropped against the dense build
        (0 when ``keep`` is None).  Tiles that only dropped rows cover get
        ``count == 0``."""
        proj = project(silence(g, masked), Camera(self.intr, w2c))
        frags = build_fragment_lists(proj, self.grid, self.cfg.frag_capacity,
                                     keep)
        if keep is None:
            return frags, torch.zeros((), dtype=torch.int32, device=self.device)
        return frags, count_skipped_fragments(proj, self.grid, keep)

    def _sched_core(self, frags: FragmentLists):
        """The WSU schedule of one view's cached fragment counts (device
        math, no host sync)."""
        return build_plan_schedule(frags, self.plan)

    def _slot_programs_core(self, frags: FragmentLists, sched=None):
        """() scheduled raster programs of one view in the WSU's subtile
        unit: the schedule's total chunk trips on the ``schedule`` backend,
        the per-tile loop's trips otherwise."""
        if sched is not None:
            return scheduled_trips(sched)
        return tile_trips(frags.count, self.plan.chunk)

    def _track_iter_core(self, g, masked, xi, ostate, base_w2c, obs_rgb,
                         obs_depth, frags, sched=None, score_grads=False):
        """One tracking iteration: render -> Eq. 6 loss -> pose Adam step.
        With ``score_grads`` it also returns the gradients of the silenced
        field's ``mu``, ``log_scale`` and ``quat`` (all that Eq. 7 and the
        stability EMA read); otherwise only the pose is differentiated."""
        g_eff = silence(g, masked)
        xi_ = xi.detach().requires_grad_(True)
        leaves = {}
        if score_grads:
            leaves = {k: getattr(g_eff, k).detach().requires_grad_(True)
                      for k in pruning.SCORE_FIELDS}
            g_eff = g_eff.replace(**leaves)
        out = self._render(g_eff, lie.se3_exp(xi_) @ base_w2c, frags, sched)
        loss = slam_loss(out.image, out.depth, out.alpha, obs_rgb, obs_depth,
                         self.cfg.lambda_pho)
        g_xi, *g_leaves = torch.autograd.grad(loss, [xi_, *leaves.values()])
        upd, ostate = Adam(lr=self.cfg.lr_pose).update({"xi": g_xi}, ostate)
        return (loss.detach(), xi + upd["xi"], ostate,
                dict(zip(leaves, g_leaves)))

    def _map_iter_core(self, g, masked, opt_state, kf_w2c, kf_rgb, kf_depth,
                       cache, kf_valid, scheds=None, unstable=None,
                       stable_bg=None):
        """One mapping iteration over the whole keyframe window: one batched
        render, the valid-masked mean window loss, one Adam step.

        ``unstable`` (an (N,) bool row mask) makes the Adam step sparse: the
        other rows get no update, keep their moments and keep their bits.
        ``stable_bg`` is the per-slot ``(image, depth, final_t)`` of the
        stable-only render: the unstable render is composited over it
        (``c_u + T_u c_s``, ``T_u T_s``), so the loss still sees the whole
        map.  With no stable row it is ``(0, 0, 1)`` and the composite
        reduces to the dense expressions bit for bit."""
        # As in the reference, the differentiated params are g's own (the
        # silenced opacities are replaced); rows off the fragment lists get
        # exactly zero gradient either way.
        g_eff = silence(g, masked)
        params_g = G.params_of(g)
        params = {k: p.detach().requires_grad_(True) for k, p in params_g.items()}
        out = self._render(G.with_params(g_eff, params), kf_w2c, cache, scheds)
        if stable_bg is None:
            img, dep, alp = out.image, out.depth, out.alpha
        else:
            bg_img, bg_dep, bg_t = stable_bg
            t = out.final_t
            img = out.image + t[..., None] * bg_img
            dep = out.depth + t * bg_dep
            alp = 1.0 - t * bg_t
        w_len = kf_w2c.shape[0]
        vw = kf_valid.to(torch.float32)
        loss = sum(slam_loss(img[b], dep[b], alp[b],
                             kf_rgb[b], kf_depth[b], self.cfg.lambda_pho) * vw[b]
                   for b in range(w_len)) / vw.sum()
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        opt = Adam(lr=self.cfg.lr_map)
        if unstable is None:
            upd, opt_state = opt.update(grads, opt_state)
            new = apply_updates(params_g, upd)
        else:
            upd, opt_state = opt.update_masked(grads, opt_state, unstable)
            new = apply_updates_masked(params_g, upd, unstable)
        return loss.detach(), G.with_params(g, new), opt_state

    @torch.no_grad()
    def _stable_bg_core(self, g, masked, stable, kf_w2c):
        """The stable-only map rendered for every window slot, forward only:
        the background sparse mapping composites over.  Stable rows stay
        bit-frozen through the phase, so one render serves every iteration.
        Returns ``(image, depth, final_t)`` and each slot's fragment total
        and raster programs, which the caller counts once."""
        w_len = kf_w2c.shape[0]
        cache = stack_fragment_lists([self._build_core(g, masked, kf_w2c[b], stable)
                                      for b in range(w_len)])
        scheds = self._sched_core(cache) if self.scheduled else None
        out = self._render(silence(g, masked), kf_w2c, cache, scheds)
        progs = torch.stack([
            self._slot_programs_core(
                _slot(cache, b), None if scheds is None else _slot(scheds, b))
            for b in range(w_len)])
        return (out.image, out.depth, out.final_t), cache.total, progs

    @torch.no_grad()
    def _render_eval_core(self, g, masked, w2c):
        return self._render(silence(g, masked), w2c).image

    # ---- phases ----------------------------------------------------------

    def _track_scan_noprune(self, g, masked, base_w2c, obs_rgb, obs_depth,
                            frags, work: DeviceWork):
        """The K tracking iterations on the frame's fragment lists (and, on
        the ``schedule`` backend, one schedule built from them for the
        whole phase)."""
        sched = self._sched_core(frags) if self.scheduled else None
        work = work._replace(frag_build_rows=work.frag_build_rows + g.capacity)
        xi = torch.zeros(6, dtype=torch.float32, device=self.device)
        ostate = _pose_adam_zero(self.device)
        alive_eff = (g.alive & ~masked).sum()
        losses = []
        for _ in range(self.cfg.iters_track):
            loss, xi, ostate, _ = self._track_iter_core(
                g, masked, xi, ostate, base_w2c, obs_rgb, obs_depth, frags,
                sched)
            work = device_work_add(work, frags.total, self.pixels, alive_eff,
                                   unstable=0)
            losses.append(loss)
        fired = torch.zeros(self.cfg.iters_track, dtype=torch.bool,
                            device=self.device)
        return xi, work, torch.stack(losses), fired

    def _track_scan_prune(self, g, pstate: pruning.PruneState, base_w2c,
                          obs_rgb, obs_depth, frags, work: DeviceWork):
        """The K tracking iterations with §4.1 pruning: every iteration
        accumulates the Eq. 7 scores from its own backward; on a fired
        boundary the fragment lists are rebuilt at the current pose before
        ``interval_update`` (and, on the ``schedule`` backend, the schedule
        with them).  Returns ``(xi, g, pstate, work, losses, fired)``."""
        prune_cfg = self.cfg.prune
        sched = self._sched_core(frags) if self.scheduled else None
        n_rows = g.capacity
        # The caller's pre-track build, plus one per fired boundary below.
        work = work._replace(frag_build_rows=work.frag_build_rows + n_rows)
        xi = torch.zeros(6, dtype=torch.float32, device=self.device)
        ostate = _pose_adam_zero(self.device)
        losses, fired = [], []
        for _ in range(self.cfg.iters_track):
            loss, xi, ostate, g_params = self._track_iter_core(
                g, pstate.masked, xi, ostate, base_w2c, obs_rgb, obs_depth,
                frags, sched, score_grads=True)
            alive_eff = (g.alive & ~pstate.masked).sum()
            work = device_work_add(work, frags.total, self.pixels, alive_eff,
                                   unstable=0)
            pstate = pruning.accumulate(pstate, g_params, prune_cfg,
                                        alive=g.alive)

            def build_fn(gg, mm):
                return self._build_core(gg, mm, lie.se3_exp(xi) @ base_w2c)

            pstate, g, frags, hit = pruning.cond_interval_update(
                pstate, g, frags, build_fn, prune_cfg)
            if hit:
                work = work._replace(
                    frag_build_rows=work.frag_build_rows + n_rows)
                if self.scheduled:
                    sched = self._sched_core(frags)
            losses.append(loss)
            fired.append(hit)
        return (xi, g, pstate, work, torch.stack(losses),
                torch.tensor(fired, dtype=torch.bool, device=self.device))

    def _map_scan_masked(self, g, masked, opt_state, kf_w2c, kf_rgb, kf_depth,
                         n_valid: int, work: DeviceWork, stable=None):
        """The mapping phase over the fixed-shape keyframe ring: the window
        has ``map_window`` slots, the first ``n_valid`` populated (oldest
        first).  Invalid slots render but add nothing to the loss, the
        counters, the round-robin stride rebuild or the final eval.  On the
        ``schedule`` backend each window slot's schedule is rebuilt with
        its fragment list.

        ``stable`` (an (N,) bool mask, ``cfg.sparse_opt``) freezes the
        stable rows: the Adam step skips them, the fragment builds (stride
        rebuilds too) and so the schedules leave them out, and one
        stable-background render, counted once over the valid slots,
        stands in for them in every iteration's loss.  The final eval
        render stays dense.  An all-False ``stable`` equals ``None`` bit
        for bit."""
        cfg = self.cfg
        stride = cfg.map_rebuild_stride
        w_len = kf_w2c.shape[0]
        kf_valid = torch.arange(w_len, device=self.device) < n_valid
        valid_i = kf_valid.to(torch.int64)
        # Dead and masked rows stay in (pruning.optimizable_mask): they
        # render nothing and get zero gradients either way.
        keep = None if stable is None else ~stable
        # One view at a time: a full-size view's membership matrix is ~0.8 GB.
        built = [self._sparse_build_core(g, masked, keep, kf_w2c[b])
                 for b in range(w_len)]
        cache = stack_fragment_lists([f for f, _ in built])
        skipped_w = torch.stack([n for _, n in built])
        stable_bg = None
        if stable is not None:
            stable_bg, bg_total, bg_progs = self._stable_bg_core(
                g, masked, stable, kf_w2c)
            work = work._replace(
                fragments=work.fragments + (bg_total.to(torch.int64) * valid_i).sum(),
                sched_programs=work.sched_programs
                + (bg_progs.to(torch.int64) * valid_i).sum())
        scheds = (stack_fragment_lists([self._sched_core(_slot(cache, b))
                                        for b in range(w_len)])
                  if self.scheduled else None)
        # The window builds, the stride rebuilds and the eval render's
        # build; the stable-background builds are left out, so the
        # all-unstable sparse path counts what the dense one does.
        work = work._replace(
            frag_build_rows=work.frag_build_rows
            + (n_valid + cfg.iters_map // stride + 1) * g.capacity)
        losses = []
        for it in range(cfg.iters_map):
            loss, g, opt_state = self._map_iter_core(
                g, masked, opt_state, kf_w2c, kf_rgb, kf_depth, cache, kf_valid,
                scheds, unstable=keep, stable_bg=stable_bg)
            n_alive = g.alive.sum()
            n_opt = n_alive if stable is None else (g.alive & ~stable).sum()
            progs = torch.stack([
                self._slot_programs_core(
                    _slot(cache, b), None if scheds is None else _slot(scheds, b))
                for b in range(w_len)])
            work = device_work_add(
                work, (cache.total.to(torch.int64) * valid_i).sum(),
                n_valid * self.pixels, n_valid * n_alive,
                unstable=n_valid * n_opt, programs=(progs * valid_i).sum(),
                skipped=(skipped_w.to(torch.int64) * valid_i).sum())
            losses.append(loss)
            if (it + 1) % stride == 0:
                slot = ((it + 1) // stride - 1) % n_valid   # round-robin
                fresh, skipped_w[slot] = self._sparse_build_core(
                    g, masked, keep, kf_w2c[slot])
                cache = update_fragment_slot(cache, slot, fresh)
                if self.scheduled:
                    scheds = update_fragment_slot(scheds, slot,
                                                  self._sched_core(fresh))
        image = self._render_eval_core(g, masked, kf_w2c[n_valid - 1])
        return g, opt_state, work, torch.stack(losses), image
