"""The SLAM step engine (counterpart of ``repro/slam/engine.py``).

The reference fuses each phase into one ``lax.scan`` dispatch.  Here each
phase's iterations are *segments* (functions over fixed-shape tensors)
that the session's :class:`~repro_torch.slam.graphs.PhaseRunner` captures
once as a CUDA graph and replays (``SLAMConfig.fused``, the default), or
runs eagerly, one iteration after another (``fused=False``, the oracle):

* tracking: the frame's fragment-list build (and WSU schedule) and the K
  iterations, one segment, one replay per frame; with §4.1 pruning every
  iteration also accumulates the Eq. 7 scores and counts the device
  interval clock down, and each boundary (the rebuild, ``interval_update``
  and the schedule) runs inside the same segment under a conditional node
  on ``iters_left <= 0``, as the reference's ``lax.cond`` inside its
  ``lax.scan``;
* mapping: :meth:`_Stage._map_scan_masked` is device work only (the
  window builds and their schedules, the sparse stable background, every
  iteration with the round-robin stride rebuild at a device slot, and the
  eval render), which the session runs inside one segment with the rest
  of a keyframe's mapping work (``session._keyframe_segment``) or the
  bootstrap mapping (``session._boot_segment``).  The window fill is a
  device tensor, so one graph serves every fill.

Nothing reads the device.  Each ``lax.cond`` of a phase is a
conditional node, a host ``if`` on a host value or a select on the
device, and each ``vmap`` over the
keyframe window a loop over views; every mapping iteration still renders
the whole window as ONE batched raster call.  On the ``schedule``
backend a WSU schedule rides next to each cached fragment list and is
rebuilt only where the list is.  A stage renders at one §4.2
downsampling factor.  With ``cfg.sparse_opt`` mapping freezes the
stability-frozen Gaussians out of the Adam step, the fragment builds and
the WSU schedule, and composites every iteration's render over one
stable-background render per phase.
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
    stack_fragment_lists, tile_trips,
)
from repro_torch.core.projection import project
from repro_torch.kernels.ops import build_plan_schedule
from repro_torch.slam.graphs import (
    PhaseRunner, flat, row_carry, row_names, row_view, rows_segment, unflat,
)
from repro_torch.slam.map.paged import (
    PageTable, gather_field, validate_paged, working_set,
)
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


def _put_slot(stack, slot: torch.Tensor, one):
    """``stack`` with the window slot at the (1,) int64 device index
    ``slot`` replaced by the one-view ``one``."""
    return type(stack)(*(x.index_copy(0, slot, y[None]) for x, y in zip(stack, one)))


class _Stage:
    """The cores at one resolution: ``factor`` is the §4.2 per-side
    downsampling factor of the frames this stage renders."""

    def __init__(self, intr: Intrinsics, cfg, device: torch.device,
                 factor: int = 1, runner: PhaseRunner | None = None):
        self.factor = factor
        self.full_intr = intr       # the paged cull's frusta are full-size
        self.intr = intr.scaled(factor)
        self.grid = make_tile_grid(self.intr.height, self.intr.width)
        self.plan = RasterPlan(grid=self.grid, backend=cfg.backend,
                               capacity=cfg.frag_capacity)
        # WSU: carry a schedule next to each cached fragment list.
        self.scheduled = cfg.backend == "schedule"
        self.pixels = self.intr.height * self.intr.width
        self.cfg = cfg
        self.device = device
        # One runner per session: its graphs, memory pool and counts.
        self.runner = runner or PhaseRunner(device, cfg.fused)
        # Sparse stable/unstable mapping reads the stability bit that
        # PruneState carries, so it needs pruning on.
        if cfg.sparse_opt and cfg.prune is None:
            raise ValueError("sparse_opt=True requires cfg.prune (the "
                             "stability bit rides PruneState)")
        # PagedMap's cull, gather and scatter ride inside the fused
        # engine's segments (the reference's ``session_init`` checks).
        if cfg.paged is not None:
            if not cfg.fused:
                raise ValueError("SLAMConfig.paged requires cfg.fused=True: the "
                                 "frustum cull + working-set gather ride inside "
                                 "the fused step dispatch")
            validate_paged(cfg.paged, cfg.capacity)

    def build_rows(self, g) -> int:
        """Rows one fragment-list build over storage ``g`` sweeps: the paged
        view's M, or the whole pool."""
        p = self.cfg.paged
        return p.visible_pages * p.page_capacity if p is not None else g.capacity

    def _working_set(self, page: PageTable, w2c, kf_w2c) -> torch.Tensor:
        return working_set(page, self.full_intr, w2c, kf_w2c, self.cfg.paged)

    def _render(self, g, w2c, frags=None, sched=None, storage=None):
        return render(g, Camera(self.intr, w2c), self.plan.with_sched(sched),
                      frags=frags, storage=storage, device=self.device)

    # ---- cores -----------------------------------------------------------

    @torch.no_grad()
    def _build(self, g, masked, w2c, keep=None) -> FragmentLists:
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

    def _slot_programs_core(self, frags: FragmentLists, sched=None):
        """() scheduled raster programs of one view in the WSU's subtile
        unit: the schedule's total chunk trips on the ``schedule`` backend,
        the per-tile loop's trips otherwise."""
        if sched is not None:
            return scheduled_trips(sched)
        return tile_trips(frags.count, self.plan.chunk)

    def _track_iter_core(self, g, masked, xi, ostate, base_w2c, obs_rgb,
                         obs_depth, frags, sched=None, score_grads=False, storage=None):
        """One tracking iteration: render -> Eq. 6 loss -> pose Adam step.
        With ``score_grads`` it also returns the gradients of the silenced
        field's ``mu``, ``log_scale`` and ``quat`` (all that Eq. 7 and the
        stability EMA read); otherwise only the pose is differentiated.
        ``storage`` is a paged view's ``(rows, n)`` (``project``: the pose
        gradient then rounds as the flat step's)."""
        g_eff = silence(g, masked)
        xi_ = xi.detach().requires_grad_(True)
        leaves = {}
        if score_grads:
            leaves = {k: getattr(g_eff, k).detach().requires_grad_(True)
                      for k in pruning.SCORE_FIELDS}
            g_eff = g_eff.replace(**leaves)
        out = self._render(g_eff, lie.se3_exp(xi_) @ base_w2c, frags, sched, storage)
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
        cache = stack_fragment_lists([self._build(g, masked, kf_w2c[b], stable)
                                      for b in range(w_len)])
        scheds = build_plan_schedule(cache, self.plan) if self.scheduled else None
        out = self._render(silence(g, masked), kf_w2c, cache, scheds)
        progs = torch.stack([
            self._slot_programs_core(
                _slot(cache, b), None if scheds is None else _slot(scheds, b))
            for b in range(w_len)])
        return (out.image, out.depth, out.final_t), cache.total, progs

    @torch.no_grad()
    def _render_eval_core(self, g, masked, w2c):
        return self._render(silence(g, masked), w2c).image

    # ---- segments (one or more iterations over fixed-shape tensors) -------

    def _track_segment(self, n: int, prune: bool):
        """The frame's fragment-list build (and, on the ``schedule``
        backend, its schedule) at the base pose and ``n`` tracking
        iterations on them, over the tensors ``_track_inputs`` names.

        With ``prune`` (§4.1), a conditional segment (``fn(t, when)``,
        :meth:`PhaseRunner.run`): every iteration also accumulates the
        Eq. 7 scores and the stability leaves from its own backward and
        counts the interval clock down, then takes the boundary under
        ``when(iters_left <= 0, ...)`` (``pruning.cond_interval_update``:
        the rebuild at the current pose, ``interval_update`` and, on
        ``schedule``, the schedule), as the reference's
        ``_track_scan_prune`` body does.  The state a boundary rewrites
        (the pruning leaves and clocks, ``alive``, the lists and the
        schedule) lives in buffers the segment makes before its first
        iteration, which every iteration and boundary write in place, so
        a skipped boundary leaves them as they were.

        In paged mode (``cfg.paged``) the segment computes the frame's
        working set (the cull, the selection and the view's rows, from the
        page table, the base pose and the keyframe ring), gathers the view
        (and the pruning leaves' view rows), builds and tracks on it,
        returns ``view_idx`` and, with ``prune``, scatters the leaves and
        ``alive`` back to storage at the end (a gather after a scatter
        with the same rows is a copy, so this equals a gather and scatter
        per iteration bit for bit)."""
        prune_cfg, paged = self.cfg.prune, self.cfg.paged is not None

        def fn(t, when=None):
            g, base = unflat(t, "g", G.GaussianField), t["base"]
            ps = unflat(t, "p", pruning.PruneState) if prune else None
            masked, xi = (ps.masked if prune else t["masked"]), t["xi"]
            view_idx = storage = None
            if paged:
                view_idx = self._working_set(unflat(t, "page", PageTable), base,
                                             t["kf_w2c"])
                storage = (view_idx, g.capacity)
                g, masked = gather_field(g, view_idx), masked.index_select(0, view_idx)
                if prune:
                    ps = pruning.gather_rows(ps, view_idx)
            if prune:
                # The segment's own state buffers (the inputs stay as given).
                ps = pruning.PruneState(*(x.clone() for x in ps))
                g = g.replace(alive=g.alive.clone())
                masked = ps.masked
            frags = self._build(g, masked, base)
            sched = build_plan_schedule(frags, self.plan) if self.scheduled else None
            ostate = AdamState(step=t["opt.step"], mu={"xi": t["opt.mu.xi"]},
                               nu={"xi": t["opt.nu.xi"]})
            work = unflat(t, "work", DeviceWork)
            rows = torch.full_like(work.frag_build_rows, self.build_rows(g)) if prune else None

            def boundary_when(flag, body):
                def run():
                    body()
                    if self.scheduled:
                        pruning.assign(sched, build_plan_schedule(frags, self.plan))
                # Eager, the rebuild, interval_update and the schedule.
                when(flag, run, 2 + self.scheduled)

            losses, fired, alive_eff = [], [], None
            for _ in range(n):
                if prune or alive_eff is None:      # a boundary changes it
                    alive_eff = (g.alive & ~masked).sum()
                loss, xi, ostate, grads = self._track_iter_core(
                    g, masked, xi, ostate, base, t["obs_rgb"], t["obs_depth"],
                    frags, sched, score_grads=prune, storage=storage)
                work = device_work_add(work, frags.total, self.pixels, alive_eff,
                                       unstable=0)
                losses.append(loss)
                if not prune:
                    continue
                pruning.assign(ps, pruning.accumulate(ps, grads, prune_cfg, alive=g.alive))
                hit = pruning.cond_interval_update(
                    ps, g, frags,
                    lambda gg, mm, xi=xi: self._build(gg, mm, lie.se3_exp(xi) @ base),
                    prune_cfg, boundary_when)
                work = work._replace(frag_build_rows=work.frag_build_rows
                                     + torch.where(hit, rows, torch.zeros_like(rows)))
                fired.append(hit)
            out = {"xi": xi, **flat("opt", ostate), **flat("work", work),
                   "losses": torch.stack(losses)}
            if paged:
                out["view_idx"] = view_idx
            if prune:
                alive = g.alive
                if paged:
                    ps = pruning.scatter_rows(unflat(t, "p", pruning.PruneState), ps,
                                              view_idx)
                    alive = t["g.alive"].index_copy(0, view_idx, alive)
                out.update({**flat("p", ps), "g.alive": alive, "fired": torch.stack(fired)})
            return out

        return fn

    def _track_inputs(self, g, masked, base_w2c, obs_rgb, obs_depth, xi, ostate,
                      work, pstate=None, view=None) -> dict:
        """The tracking segment's inputs: with pruning, ``pstate`` in place
        of ``masked``; in paged mode ``view``, the page table and keyframe
        ring."""
        out = {**flat("g", g), "base": base_w2c, "obs_rgb": obs_rgb,
               "obs_depth": obs_depth, "xi": xi, **flat("opt", ostate),
               **flat("work", work)}
        out.update(flat("p", pstate) if pstate is not None else {"masked": masked})
        if view is not None:
            out.update({**flat("page", view[0]), "kf_w2c": view[1]})
        return out

    _TRACK_CARRY = ("xi", "opt.step", "opt.mu.xi", "opt.nu.xi",
                    *(f"work.{f}" for f in DeviceWork._fields))

    # ---- phases ----------------------------------------------------------

    def _pose_start(self):
        return (torch.zeros(6, dtype=torch.float32, device=self.device),
                _pose_adam_zero(self.device))

    def _track_scan_noprune(self, g, masked, base_w2c, obs_rgb, obs_depth,
                            work: DeviceWork):
        """The frame's fragment-list build at the base pose (and, on the
        ``schedule`` backend, one schedule from it for the whole phase) and
        the K tracking iterations on them: one segment run.  Returns
        ``(xi, work, losses, fired)``."""
        return self._track_rows(
            [(g, masked, None, base_w2c, obs_rgb, obs_depth, work)])[0][:4]

    def _track_scan_prune(self, g, pstate: pruning.PruneState, base_w2c,
                          obs_rgb, obs_depth, work: DeviceWork):
        """The frame's build and the K tracking iterations with §4.1
        pruning, every fired boundary inside (``_track_segment``): one
        segment run, one graph replay when fused on the card.  Returns
        ``(xi, g, pstate, work, losses, fired)``."""
        xi, work, losses, fired, _, g, pstate = self._track_rows(
            [(g, pstate.masked, pstate, base_w2c, obs_rgb, obs_depth, work)])[0]
        return xi, g, pstate, work, losses, fired

    def _track_rows(self, rows, views=None):
        """The tracking phase of S sessions at once: ``rows`` holds each
        one's ``(g, masked, pstate, base_w2c, obs_rgb, obs_depth, work)``
        (``pstate`` None without pruning) and, in paged mode, ``views``
        each one's ``(page table, keyframe ring)``.  One run of one S-row
        segment (each row's tensors and ops its own, as in a solo run): one
        graph replay when fused on the card, with or without pruning.
        Returns each row's ``(xi, work, losses, fired, view_idx, g,
        pstate)``: ``view_idx`` None unless paged, ``g`` and ``pstate``
        (storage-sized) as given without pruning."""
        k, n_rows = self.cfg.iters_track, len(rows)
        prune = self.cfg.prune is not None
        views = views or [None] * n_rows
        inputs = {}
        for s, ((g, masked, pstate, base_w2c, obs_rgb, obs_depth, work), view) in \
                enumerate(zip(rows, views)):
            # The pre-tracking build; pruning adds one per fired boundary.
            work = work._replace(frag_build_rows=work.frag_build_rows + self.build_rows(g))
            xi, ostate = self._pose_start()
            inputs.update(row_names(s, self._track_inputs(
                g, masked, base_w2c, obs_rgb, obs_depth, xi, ostate, work,
                pstate if prune else None, view)))
        # Eager, without pruning the K iterations; with it also the build
        # and the schedule (each fired boundary counts its own).
        final, runs = self.runner.run(
            ("track-prune" if prune else "track", self.cfg.backend, self.factor, k, n_rows),
            rows_segment([self._track_segment(k, prune)] * n_rows), inputs,
            row_carry(self._TRACK_CARRY, n_rows),
            iters=k + (1 + self.scheduled if prune else 0), conditional=prune)
        out = []
        for s, (g, _, pstate, *_) in enumerate(rows):
            f, r = row_view(s, final), row_view(s, runs[0])
            if prune:
                g = g.replace(alive=r["g.alive"])
                pstate = unflat(r, "p", pruning.PruneState)
                fired = r["fired"]
            else:
                fired = torch.zeros(k, dtype=torch.bool, device=self.device)
            out.append((f["xi"], unflat(f, "work", DeviceWork), r["losses"], fired,
                        r.get("view_idx"), g, pstate))
        return out

    def _map_scan_masked(self, g, masked, opt_state, kf_w2c, kf_rgb, kf_depth,
                         n_valid, work: DeviceWork, stable=None):
        """The mapping phase over the fixed-shape keyframe ring, as device
        work only: the window has ``map_window`` slots, the first
        ``n_valid`` populated (oldest first; a () int64 tensor, or an int).
        Invalid slots render but add nothing to the loss, the counters, the
        round-robin stride rebuild or the final eval.  The ``iters_map``
        iterations are unrolled; after every ``map_rebuild_stride``-th the
        window slot ``r % n_valid`` (a device index) is rebuilt at the
        current map and written into the cached lists (and, on the
        ``schedule`` backend, schedules) with ``index_copy``.  Nothing is
        read back, so the caller's segment captures the whole phase;
        :meth:`_map_dispatches` counts its eager calls.

        ``stable`` (an (N,) bool mask, ``cfg.sparse_opt``) freezes the
        stable rows: the Adam step skips them, the fragment builds (stride
        rebuilds too) and so the schedules leave them out, and one
        stable-background render, counted once over the valid slots,
        stands in for them in every iteration's loss.  The final eval
        render stays dense.  An all-False ``stable`` equals ``None`` bit
        for bit.  Returns ``(g, opt_state, work, losses, image)``."""
        cfg = self.cfg
        stride = cfg.map_rebuild_stride
        w_len = kf_w2c.shape[0]
        if not isinstance(n_valid, torch.Tensor):
            n_valid = torch.full((), n_valid, dtype=torch.int64, device=self.device)
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
        scheds = build_plan_schedule(cache, self.plan) if self.scheduled else None
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
            n_opt = n_alive if stable is None else (g.alive & keep).sum()
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
                # The round-robin stride rebuild: after stride r, slot r % n_valid.
                slot = torch.full_like(n_valid, (it + 1) // stride - 1).remainder(
                    n_valid).reshape(1)
                fresh, skipped = self._sparse_build_core(
                    g, masked, keep, kf_w2c.index_select(0, slot)[0])
                cache = _put_slot(cache, slot, fresh)
                if self.scheduled:
                    scheds = _put_slot(scheds, slot, build_plan_schedule(fresh, self.plan))
                skipped_w = skipped_w.index_copy(0, slot, skipped[None])
        last = kf_w2c.index_select(0, (n_valid - 1).reshape(1))[0]
        image = self._render_eval_core(g, masked, last)
        return g, opt_state, work, torch.stack(losses), image

    def _map_dispatches(self, sparse: bool) -> int:
        """The eager host calls :meth:`_map_scan_masked` stands for when
        not fused (``EngineStats`` units): each window build and stride
        rebuild and its schedule, each iteration and the eval render, and
        under sparse mapping the stable background's builds, schedule and
        render."""
        cfg = self.cfg
        builds = cfg.map_window + cfg.iters_map // cfg.map_rebuild_stride
        n = builds * (1 + self.scheduled) + cfg.iters_map + 1
        if sparse:
            n += cfg.map_window + self.scheduled + 1
        return n
