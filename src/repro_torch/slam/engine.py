"""The SLAM step engine (counterpart of ``repro/slam/engine.py``).

The reference fuses each phase into one ``lax.scan`` dispatch.  Here each
phase's iterations are *segments* (functions over fixed-shape tensors)
that the session's :class:`~repro_torch.slam.graphs.PhaseRunner` captures
once as a CUDA graph and replays (``SLAMConfig.fused``, the default), or
runs eagerly, one iteration after another (``fused=False``, the oracle):

* tracking without pruning: the frame's fragment-list build (and WSU
  schedule) and the K iterations, one segment, one replay per frame;
* tracking with §4.1 pruning: the host knows each interval boundary from
  its own clock, so the iterations between boundaries are replays of a
  one-iteration segment that carries the pose, its Adam state, the scores
  and the stability leaves; a fired boundary's rebuild and
  ``interval_update`` run eagerly in between;
* mapping: ``map_rebuild_stride`` iterations per segment, replayed
  ``iters_map / map_rebuild_stride`` times; the stride rebuild runs
  eagerly between replays and writes the fresh slot into the segment's
  cached fragment lists and schedules in place.  The window fill is a
  device tensor, so one graph serves every fill.

The other fragment-list builds (pruning's, mapping's window builds and
stride rebuilds) run eagerly between replays, though none reads the
device; so do densification, the eval renders and sparse mapping's one
stable-background render per phase.  Each ``lax.cond``
is a host ``if`` and each ``vmap`` over the keyframe window a loop over
views; every mapping iteration still renders the whole window as ONE
batched raster call.  On the ``schedule`` backend a WSU schedule rides
next to each cached fragment list and is rebuilt only where the list is.
A stage renders at one §4.2 downsampling factor.  With ``cfg.sparse_opt``
mapping freezes the stability-frozen Gaussians out of the Adam step, the
fragment builds and the WSU schedule, and composites every iteration's
render over one stable-background render per phase.
"""

from __future__ import annotations

import torch

from repro_torch._device import constant
from repro_torch.core import gaussians as G
from repro_torch.core import lie, pruning
from repro_torch.core.camera import Camera, Intrinsics
from repro_torch.core.losses import slam_loss
from repro_torch.core.raster_api import RasterPlan
from repro_torch.core.render import render
from repro_torch.core.schedule import TileSchedule, scheduled_trips
from repro_torch.core.sorting import (
    FragmentLists, build_fragment_lists, count_skipped_fragments, make_tile_grid,
    stack_fragment_lists, tile_trips,
)
from repro_torch.core.projection import project
from repro_torch.kernels.ops import build_plan_schedule
from repro_torch.slam.graphs import (
    PhaseRunner, flat, row_carry, row_names, row_view, rows_segment, unflat,
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


class _Stage:
    """The cores at one resolution: ``factor`` is the §4.2 per-side
    downsampling factor of the frames this stage renders."""

    def __init__(self, intr: Intrinsics, cfg, device: torch.device,
                 factor: int = 1, runner: PhaseRunner | None = None):
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
        # One runner per session: its graphs, memory pool and counts.
        self.runner = runner or PhaseRunner(device, cfg.fused)
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
    def _build(self, g, masked, w2c, keep=None) -> FragmentLists:
        proj = project(silence(g, masked), Camera(self.intr, w2c))
        return build_fragment_lists(proj, self.grid, self.cfg.frag_capacity,
                                    keep)

    def _build_core(self, g, masked, w2c, keep=None) -> FragmentLists:
        """:meth:`_build` as an eager call of its own."""
        self.runner.count()
        return self._build(g, masked, w2c, keep)

    @torch.no_grad()
    def _sparse_build_core(self, g, masked, keep, w2c):
        """The fragment lists of the rows in ``keep`` only, and the ()
        int32 count of fragments the mask dropped against the dense build
        (0 when ``keep`` is None).  Tiles that only dropped rows cover get
        ``count == 0``."""
        self.runner.count()
        proj = project(silence(g, masked), Camera(self.intr, w2c))
        frags = build_fragment_lists(proj, self.grid, self.cfg.frag_capacity,
                                     keep)
        if keep is None:
            return frags, torch.zeros((), dtype=torch.int32, device=self.device)
        return frags, count_skipped_fragments(proj, self.grid, keep)

    def _sched_core(self, frags: FragmentLists):
        """The WSU schedule of one view's cached fragment counts (device
        math, no host sync)."""
        self.runner.count()
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
        self.runner.count()             # the background render
        out = self._render(silence(g, masked), kf_w2c, cache, scheds)
        progs = torch.stack([
            self._slot_programs_core(
                _slot(cache, b), None if scheds is None else _slot(scheds, b))
            for b in range(w_len)])
        return (out.image, out.depth, out.final_t), cache.total, progs

    @torch.no_grad()
    def _render_eval_core(self, g, masked, w2c):
        self.runner.count()
        return self._render(silence(g, masked), w2c).image

    # ---- segments (one or more iterations over fixed-shape tensors) -------

    def _track_segment(self, n: int, prune: bool):
        """``n`` tracking iterations over the tensors ``_track_inputs``
        names.  Without ``prune`` the segment first builds the frame's
        fragment lists (and schedule) at the base pose; with it, it takes
        them as inputs and every iteration also accumulates the Eq. 7
        scores and the stability leaves from its own backward (the input
        ``settle``, a () bool, is False while ``opt_steps`` is under
        ``stable_warmup``)."""
        prune_cfg = self.cfg.prune

        def fn(t):
            g = unflat(t, "g", G.GaussianField)
            masked, xi = t["masked"], t["xi"]
            if prune:
                frags = unflat(t, "frags", FragmentLists)
                sched = unflat(t, "sched", TileSchedule) if self.scheduled else None
            else:
                frags = self._build(g, masked, t["base"])
                sched = build_plan_schedule(frags, self.plan) if self.scheduled else None
            ostate = AdamState(step=t["opt.step"], mu={"xi": t["opt.mu.xi"]},
                               nu={"xi": t["opt.nu.xi"]})
            work = unflat(t, "work", DeviceWork)
            if prune:
                score, ema, age = t["p.score"], t["p.grad_ema"], t["p.age"]
            alive_eff = (g.alive & ~masked).sum()
            losses = []
            for _ in range(n):
                loss, xi, ostate, grads = self._track_iter_core(
                    g, masked, xi, ostate, t["base"], t["obs_rgb"], t["obs_depth"],
                    frags, sched, score_grads=prune)
                work = device_work_add(work, frags.total, self.pixels, alive_eff,
                                       unstable=0)
                if prune:
                    s = pruning.importance_scores(grads, prune_cfg)
                    score = score + s
                    ema, age, stable = pruning.stability_update(
                        ema, age, s, g.alive, prune_cfg, t["settle"])
                losses.append(loss)
            out = {"xi": xi, **flat("opt", ostate), **flat("work", work),
                   "losses": torch.stack(losses)}
            if prune:
                out.update({"p.score": score, "p.grad_ema": ema, "p.age": age,
                            "p.stable": stable})
            return out

        return fn

    def _track_inputs(self, g, masked, base_w2c, obs_rgb, obs_depth, frags,
                      sched, xi, ostate, work, pstate=None) -> dict:
        out = {**flat("g", g), "masked": masked, "base": base_w2c,
               "obs_rgb": obs_rgb, "obs_depth": obs_depth,
               **flat("frags", frags), **flat("sched", sched), "xi": xi,
               **flat("opt", ostate), **flat("work", work)}
        if pstate is not None:
            out.update({"p.score": pstate.score, "p.grad_ema": pstate.grad_ema,
                        "p.age": pstate.age, "p.stable": pstate.stable})
        return out

    _TRACK_CARRY = ("xi", "opt.step", "opt.mu.xi", "opt.nu.xi",
                    *(f"work.{f}" for f in DeviceWork._fields))
    _PRUNE_CARRY = ("p.score", "p.grad_ema", "p.age", "p.stable")

    def _map_segment(self, n: int, sparse: bool):
        """``n`` mapping iterations over the tensors ``_map_scan_masked``
        names: each one batched window render, the valid-masked loss, an
        Adam step and the work counters (the window fill ``n_valid`` is a
        device tensor)."""
        keys = G.PARAM_FIELDS

        def fn(t):
            g = unflat(t, "g", G.GaussianField)
            opt = AdamState(step=t["opt.step"],
                            mu={k: t[f"opt.mu.{k}"] for k in keys},
                            nu={k: t[f"opt.nu.{k}"] for k in keys})
            cache = unflat(t, "cache", FragmentLists)
            scheds = unflat(t, "scheds", TileSchedule) if self.scheduled else None
            unstable = t["unstable"] if sparse else None
            stable_bg = ((t["bg.image"], t["bg.depth"], t["bg.final_t"])
                         if sparse else None)
            kf_valid, n_valid = t["kf_valid"], t["n_valid"]
            valid_i = kf_valid.to(torch.int64)
            w_len = kf_valid.shape[0]
            work = unflat(t, "work", DeviceWork)
            losses = []
            for _ in range(n):
                loss, g, opt = self._map_iter_core(
                    g, t["masked"], opt, t["kf_w2c"], t["kf_rgb"], t["kf_depth"],
                    cache, kf_valid, scheds, unstable=unstable, stable_bg=stable_bg)
                n_alive = g.alive.sum()
                n_opt = n_alive if not sparse else (g.alive & unstable).sum()
                progs = torch.stack([
                    self._slot_programs_core(
                        _slot(cache, b), None if scheds is None else _slot(scheds, b))
                    for b in range(w_len)])
                work = device_work_add(
                    work, (cache.total.to(torch.int64) * valid_i).sum(),
                    n_valid * self.pixels, n_valid * n_alive,
                    unstable=n_valid * n_opt, programs=(progs * valid_i).sum(),
                    skipped=(t["skipped_w"].to(torch.int64) * valid_i).sum())
                losses.append(loss)
            return {**flat("g", G.params_of(g)), **flat("opt", opt),
                    **flat("work", work), "losses": torch.stack(losses)}

        return fn

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
        return self._track_rows_noprune(
            [(g, masked, base_w2c, obs_rgb, obs_depth, work)])[0]

    def _track_rows_noprune(self, rows):
        """:meth:`_track_scan_noprune` of S sessions at once: ``rows`` holds
        each one's ``(g, masked, base_w2c, obs_rgb, obs_depth, work)``.
        One run of one S-row segment (each row's tensors and ops its own,
        as in a solo run); returns each row's ``(xi, work, losses,
        fired)``."""
        k = self.cfg.iters_track
        inputs = {}
        for s, (g, masked, base_w2c, obs_rgb, obs_depth, work) in enumerate(rows):
            work = work._replace(frag_build_rows=work.frag_build_rows + g.capacity)
            xi, ostate = self._pose_start()
            inputs.update(row_names(s, self._track_inputs(
                g, masked, base_w2c, obs_rgb, obs_depth, None, None, xi, ostate,
                work)))
        final, runs = self.runner.run(
            ("track", self.cfg.backend, self.factor, k, len(rows)),
            rows_segment([self._track_segment(k, prune=False)] * len(rows)),
            inputs, row_carry(self._TRACK_CARRY, len(rows)), iters=k)
        out = []
        for s in range(len(rows)):
            f = row_view(s, final)
            out.append((f["xi"], unflat(f, "work", DeviceWork),
                        row_view(s, runs[0])["losses"],
                        torch.zeros(k, dtype=torch.bool, device=self.device)))
        return out

    def _track_scan_prune(self, g, pstate: pruning.PruneState, base_w2c,
                          obs_rgb, obs_depth, frags, work: DeviceWork):
        """The K tracking iterations with §4.1 pruning: every iteration
        accumulates the Eq. 7 scores from its own backward; on a fired
        boundary the fragment lists are rebuilt at the current pose before
        ``interval_update`` (and, on the ``schedule`` backend, the schedule
        with them).  The iterations between boundaries (and on either side
        of the stability warmup's end) are runs of a one-iteration segment.
        Returns ``(xi, g, pstate, work, losses, fired)``."""
        return self._track_rows_prune(
            [(g, pstate, base_w2c, obs_rgb, obs_depth, frags, work)])[0]

    def _track_rows_prune(self, rows):
        """:meth:`_track_scan_prune` of S sessions at once: ``rows`` holds
        each one's ``(g, pstate, base_w2c, obs_rgb, obs_depth, frags,
        work)``.  The iterations run as replays of one one-iteration S-row
        segment, up to the next boundary any row's host clock knows (or a
        row's stability warmup end); after each run every row whose
        interval ran out takes its own boundary.  Returns each row's
        ``(xi, g, pstate, work, losses, fired)``."""
        prune_cfg = self.cfg.prune
        k, n_rows = self.cfg.iters_track, len(rows)
        st = []
        for g, pstate, base_w2c, obs_rgb, obs_depth, frags, work in rows:
            sched = self._sched_core(frags) if self.scheduled else None
            xi, ostate = self._pose_start()
            # The caller's pre-track build, plus one per fired boundary below.
            st.append(dict(
                g=g, pstate=pstate, base=base_w2c, rgb=obs_rgb, depth=obs_depth,
                frags=frags, sched=sched, xi=xi, ostate=ostate, losses=[],
                fired=[], work=work._replace(
                    frag_build_rows=work.frag_build_rows + g.capacity)))
        segment = rows_segment([self._track_segment(1, prune=True)] * n_rows)
        carry = row_carry(self._TRACK_CARRY + self._PRUNE_CARRY, n_rows)
        done = 0
        while done < k:
            # Iterations to the nearest boundary (a row's ``iters_left``
            # runs out), to the frame's end, or to a row's stability
            # warmup end.
            n, inputs = k - done, {}
            for s, r in enumerate(st):
                ps = r["pstate"]
                settle = ps.opt_steps + 1 >= prune_cfg.stable_warmup
                m = min(ps.iters_left, k - done)
                if not settle:
                    m = min(m, prune_cfg.stable_warmup - 1 - ps.opt_steps)
                n = min(n, max(m, 1))
                row = self._track_inputs(r["g"], ps.masked, r["base"], r["rgb"],
                                         r["depth"], r["frags"], r["sched"],
                                         r["xi"], r["ostate"], r["work"], ps)
                row["settle"] = constant(settle, torch.bool, self.device)
                inputs.update(row_names(s, row))
            final, runs = self.runner.run(
                ("track-prune", self.cfg.backend, self.factor, n_rows), segment,
                inputs, carry, times=n)
            done += n
            for s, r in enumerate(st):
                f = row_view(s, final)
                r["xi"] = f["xi"]
                r["ostate"] = AdamState(step=f["opt.step"], mu={"xi": f["opt.mu.xi"]},
                                        nu={"xi": f["opt.nu.xi"]})
                r["work"] = unflat(f, "work", DeviceWork)
                ps = r["pstate"]
                ps = ps._replace(
                    score=f["p.score"], grad_ema=f["p.grad_ema"], age=f["p.age"],
                    stable=f["p.stable"], iters_left=ps.iters_left - n,
                    opt_steps=ps.opt_steps + n)
                r["losses"] += [row_view(s, run)["losses"] for run in runs]
                r["fired"] += [False] * n

                def build_fn(gg, mm, xi=r["xi"], base=r["base"]):
                    return self._build_core(gg, mm, lie.se3_exp(xi) @ base)

                ps, r["g"], r["frags"], hit = pruning.cond_interval_update(
                    ps, r["g"], r["frags"], build_fn, prune_cfg)
                r["pstate"] = ps
                if hit:
                    self.runner.count(syncs=1)      # interval_update's churn read
                    r["fired"][-1] = True
                    r["work"] = r["work"]._replace(
                        frag_build_rows=r["work"].frag_build_rows + r["g"].capacity)
                    if self.scheduled:
                        r["sched"] = self._sched_core(r["frags"])
        return [(r["xi"], r["g"], r["pstate"], r["work"], torch.cat(r["losses"]),
                 torch.tensor(r["fired"], dtype=torch.bool, device=self.device))
                for r in st]

    def _map_scan_masked(self, g, masked, opt_state, kf_w2c, kf_rgb, kf_depth,
                         n_valid: int, work: DeviceWork, stable=None):
        """The mapping phase over the fixed-shape keyframe ring: the window
        has ``map_window`` slots, the first ``n_valid`` populated (oldest
        first).  Invalid slots render but add nothing to the loss, the
        counters, the round-robin stride rebuild or the final eval.  On the
        ``schedule`` backend each window slot's schedule is rebuilt with
        its fragment list.  The iterations run as segments of
        ``map_rebuild_stride`` iterations with the stride rebuild between
        them.

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
        tensors = {
            **flat("g", g), **flat("opt", opt_state), **flat("work", work),
            "masked": masked, "kf_w2c": kf_w2c, "kf_rgb": kf_rgb,
            "kf_depth": kf_depth, **flat("cache", cache), **flat("scheds", scheds),
            "kf_valid": kf_valid, "skipped_w": skipped_w,
            "n_valid": torch.full((), n_valid, dtype=torch.int64, device=self.device)}
        if stable is not None:
            tensors.update({"unstable": keep, "bg.image": stable_bg[0],
                            "bg.depth": stable_bg[1], "bg.final_t": stable_bg[2]})
        carry = (*flat("g", G.params_of(g)), *flat("opt", opt_state),
                 *flat("work", work))

        def rebuild(r, t):
            """The round-robin stride rebuild after segment run ``r``,
            written in place into the segment's cached lists, schedules and
            skipped counts (its static buffers when fused) and into
            ``tensors``, which a remainder segment reads."""
            slot = r % n_valid
            fresh, skipped = self._sparse_build_core(
                unflat(t, "g", G.GaussianField), masked, keep, kf_w2c[slot])
            fresh_scheds = self._sched_core(fresh) if self.scheduled else None
            for name, x in {**flat("cache", fresh), **flat("scheds", fresh_scheds),
                            "skipped_w": skipped}.items():
                t[name][slot] = x
                if tensors[name] is not t[name]:
                    tensors[name][slot] = x

        losses = []
        for n, times, between in ((stride, cfg.iters_map // stride, rebuild),
                                  (cfg.iters_map % stride, 1, None)):
            if n == 0 or times == 0:
                continue
            final, runs = self.runner.run(
                ("map", self.cfg.backend, self.factor, n, stable is not None),
                self._map_segment(n, sparse=stable is not None), tensors, carry,
                times=times, iters=n, between=between)
            tensors.update(final)
            losses += [r["losses"] for r in runs]
        g = G.with_params(g, {k: tensors[f"g.{k}"] for k in G.PARAM_FIELDS})
        opt_state = AdamState(
            step=tensors["opt.step"],
            mu={k: tensors[f"opt.mu.{k}"] for k in G.PARAM_FIELDS},
            nu={k: tensors[f"opt.nu.{k}"] for k in G.PARAM_FIELDS})
        image = self._render_eval_core(g, masked, kf_w2c[n_valid - 1])
        return (g, opt_state, unflat(tensors, "work", DeviceWork), torch.cat(losses),
                image)
