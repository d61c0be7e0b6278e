"""Differentiable rasterization behind the backend registry (counterpart of
``repro/kernels/ops.py``).

Four built-in backends:

  ref       the pure-tensor oracle; gradients by torch autograd.
  kernel    the counterpart of the reference's ``pallas`` backend: a
            ``torch.autograd.Function`` whose forward runs K1 and keeps its
            tile outputs (the R&B stash, color, depth and final T), and
            whose backward runs K2 on them (GMU level 1) and then GMU level
            2 (K3's merge) over all views at once.
  kernel_norb  the reference's ``pallas_norb``, the R&B Buffer ablation:
            the forward keeps only the packed attrs, and the backward
            re-runs K1 on them to regenerate its four outputs before K2.
            K1 is deterministic, so it equals ``kernel`` bit for bit.
  schedule  the WSU backend (the reference's ``schedule``): the same under a
            pairwise tile schedule, through K4 and K5.  The images go back
            to tile order, and the level-2 merge reads the gradients in
            tile order, so both equal the ``kernel`` backend's bit for bit
            on the card.

On CUDA tensors the kernels are the CUDA kernels; on CPU tensors they are
their plain versions.  Batched views (a leading ``B`` on every
``RasterInputs`` tensor) run as ONE stacked forward launch and ONE stacked
backward launch over ``B * T`` tile rows (``B * S`` slots when scheduled);
the packing runs per view, the level-2 merge once for all views.
"""

from __future__ import annotations

import torch

from repro_torch.core.raster_api import (
    RasterInputs, RasterPlan, get_backend, register_backend,
)
from repro_torch.core.schedule import TileSchedule, build_schedule
from repro_torch.core.sorting import (
    FragmentLists, TileGrid, stack_fragment_lists,
)
from repro_torch.kernels import gmu, ref
from repro_torch.kernels.tile_render import tile_render_fwd, tile_render_fwd_sched
from repro_torch.kernels.tile_render_bp import tile_render_bwd, tile_render_bwd_sched


def _pack_attrs(mu2d, conic, color, opacity, depth, frag_idx) -> torch.Tensor:
    """Gather (N,)-tensors into the packed (T, 12, K) tile layout."""
    present = frag_idx >= 0
    safe = frag_idx.clamp(min=0).long()
    zero = torch.zeros((), dtype=mu2d.dtype, device=mu2d.device)

    def take(x):
        return torch.where(present, x[safe], zero)

    return torch.stack(
        [
            take(mu2d[:, 0]), take(mu2d[:, 1]),
            take(conic[:, 0]), take(conic[:, 1]), take(conic[:, 2]),
            take(color[:, 0]), take(color[:, 1]), take(color[:, 2]),
            take(opacity), take(depth),
            present.to(torch.float32),
            torch.zeros(frag_idx.shape, dtype=torch.float32, device=mu2d.device),
        ],
        dim=1,
    )


def _view(inputs: RasterInputs, b: int) -> RasterInputs:
    return RasterInputs(inputs.mu2d[b], inputs.conic[b], inputs.color[b],
                        inputs.opacity[b], inputs.depth[b],
                        type(inputs.frags)(*(x[b] for x in inputs.frags)))


def _pack_views(mu2d, conic, color, opacity, depth, idx, views):
    """Packed attrs (B*T, 12, K) for 1 or B stacked views."""
    if views is None:
        return _pack_attrs(mu2d, conic, color, opacity, depth, idx)
    return torch.cat([_pack_attrs(mu2d[b], conic[b], color[b], opacity[b],
                                  depth[b], idx[b]) for b in range(views)])


# ---------------------------------------------------------------------------
# ref backend
# ---------------------------------------------------------------------------


def _ref_single(inputs: RasterInputs, grid: TileGrid):
    attrs = _pack_attrs(inputs.mu2d, inputs.conic, inputs.color,
                        inputs.opacity, inputs.depth, inputs.frags.idx)
    color_t, depth_t, finalt_t = ref.rasterize_tiles(attrs, grid)
    return (ref.tiles_to_image(color_t, grid), ref.tiles_to_image(depth_t, grid),
            ref.tiles_to_image(finalt_t, grid))


@register_backend("ref")
def _ref_backend(inputs: RasterInputs, plan: RasterPlan):
    if inputs.views is None:
        return _ref_single(inputs, plan.grid)
    outs = [_ref_single(_view(inputs, b), plan.grid) for b in range(inputs.views)]
    return tuple(torch.stack([o[i] for o in outs]) for i in range(3))


# ---------------------------------------------------------------------------
# kernel backend (K1 forward, K2 backward, GMU level 2)
# ---------------------------------------------------------------------------


def _images(color_t, depth_t, finalt_t, grid: TileGrid, views, rows=None):
    """Tile-order kernel outputs (B*T, ...) -> images, per view.  ``rows``
    picks each view's T rows out of its block of the outputs (the WSU
    backend's ``inv``)."""
    tiles = grid.num_tiles
    outs = []
    for b in range(views or 1):
        sel = slice(b * tiles, (b + 1) * tiles) if rows is None else rows[b]
        outs.append((ref.tiles_to_image(color_t[sel].transpose(1, 2), grid),
                     ref.tiles_to_image(depth_t[sel], grid),
                     ref.tiles_to_image(finalt_t[sel], grid)))
    if views is None:
        return outs[0]
    return tuple(torch.stack([o[i] for o in outs]) for i in range(3))


def _cotangent_tiles(g_img, g_depth, g_finalt, grid: TileGrid, views, rows=None):
    """Image cotangents -> contiguous (B*T, 3, 256), (B*T, 256), (B*T, 256)
    tile rows; ``rows`` gathers each view's rows (the WSU backend's
    ``perm``, which puts them in slot order)."""
    if views is None:
        g_img, g_depth, g_finalt = g_img[None], g_depth[None], g_finalt[None]
    nv = views or 1

    def tiles(x, b, move):
        t = ref.image_to_tiles(x[b], grid)
        t = t.transpose(1, 2) if move else t
        return t if rows is None else t[rows[b]]

    return (torch.cat([tiles(g_img, b, True) for b in range(nv)]).contiguous(),
            torch.cat([tiles(g_depth, b, False) for b in range(nv)]).contiguous(),
            torch.cat([tiles(g_finalt, b, False) for b in range(nv)]).contiguous())


def _merge_views(tile_grads, frag_idx, views, n, rows=None):
    """GMU level 2 of every view in one sort and one K3 merge over the
    (B*T, 10, K) tile-order gradients (``rows``: each view's tile rows of
    slot-order gradients, the WSU backend's ``inv``, which K3 reads
    through)."""
    idx = frag_idx if views is not None else frag_idx[None]
    merged = gmu.merge_views(tile_grads, idx.reshape(idx.shape[0], -1), n,
                             None if rows is None else torch.cat(rows))
    if views is None:
        merged = merged[0]
    return (merged[..., 0:2], merged[..., 2:5], merged[..., 5:8],
            merged[..., 8], merged[..., 9])


def kernel_backward(attrs, cnt, frag_idx, fwd, g_img, g_depth, g_finalt,
                    grid: TileGrid, chunk: int, views, n):
    """The ``kernel`` backends' backward: cotangents to tiles, K2 on K1's
    four outputs ``fwd`` (color, depth, final T, stash), GMU level 2.
    ``fwd=None`` regenerates them with K1 first (``kernel_norb``)."""
    kw = dict(chunk=chunk, tiles_per_view=grid.num_tiles)
    if fwd is None:
        fwd = tile_render_fwd(attrs, cnt, grid, **kw)
    cots = _cotangent_tiles(g_img, g_depth, g_finalt, grid, views)
    tile_grads = tile_render_bwd(attrs, cnt, *fwd, *cots, grid, **kw)  # (B*T, 10, K)
    return _merge_views(tile_grads, frag_idx, views, n)


class KernelRasterize(torch.autograd.Function):
    """Forward: pack, K1.  Backward: :func:`kernel_backward`, on K1's
    outputs kept from the forward when ``reuse_stash`` (the R&B Buffer),
    else on a K1 re-run.  ``frag_idx``/``count`` are index plumbing (no
    gradient)."""

    @staticmethod
    def forward(ctx, mu2d, conic, color, opacity, depth, frag_idx, count,
                grid: TileGrid, chunk: int, reuse_stash: bool):
        views = None if mu2d.ndim == 2 else mu2d.shape[0]
        attrs = _pack_views(mu2d, conic, color, opacity, depth, frag_idx,
                            views)
        cnt = count.reshape(-1)
        fwd = tile_render_fwd(attrs, cnt, grid, chunk=chunk,
                              tiles_per_view=grid.num_tiles)
        ctx.save_for_backward(attrs, cnt, frag_idx, *(fwd if reuse_stash else ()))
        ctx.grid, ctx.chunk, ctx.views, ctx.n = grid, chunk, views, mu2d.shape[-2]
        return _images(*fwd[:3], grid, views)

    @staticmethod
    def backward(ctx, g_img, g_depth, g_finalt):
        attrs, cnt, frag_idx, *fwd = ctx.saved_tensors
        return kernel_backward(attrs, cnt, frag_idx, fwd or None, g_img, g_depth,
                               g_finalt, ctx.grid, ctx.chunk, ctx.views,
                               ctx.n) + (None,) * 5


@register_backend("kernel")
def _kernel_backend(inputs: RasterInputs, plan: RasterPlan):
    return KernelRasterize.apply(inputs.mu2d, inputs.conic, inputs.color,
                                 inputs.opacity, inputs.depth,
                                 inputs.frags.idx, inputs.frags.count,
                                 plan.grid, plan.chunk, True)


@register_backend("kernel_norb")
def _kernel_norb_backend(inputs: RasterInputs, plan: RasterPlan):
    return KernelRasterize.apply(inputs.mu2d, inputs.conic, inputs.color,
                                 inputs.opacity, inputs.depth,
                                 inputs.frags.idx, inputs.frags.count,
                                 plan.grid, plan.chunk, False)


# ---------------------------------------------------------------------------
# schedule backend (WSU: K4 forward, K5 backward, GMU level 2)
# ---------------------------------------------------------------------------


def _flatten_sched(perm, trips, tiles: int, views):
    """Slot arrays of the stacked kernels: per-view perms offset to global
    attrs rows (``view * T + tile``), trips concatenated (int32)."""
    if views is None:
        return perm, trips
    offs = torch.arange(views, dtype=torch.int32, device=perm.device) * tiles
    return (perm + offs[:, None]).reshape(-1), trips.reshape(-1)


def _view_rows(idx, views, slots_per_view: int):
    """Per-view int64 row indices into the stacked slot-order outputs:
    view ``b``'s ``idx[b]`` (an ``inv``) offset by ``b * S``."""
    idx = idx if views is not None else idx[None]
    return [idx[b].long() + b * slots_per_view for b in range(views or 1)]


class SchedRasterize(torch.autograd.Function):
    """Forward: pack, K4 (its slot-order outputs kept), back to tile order with
    ``inv``.  Backward: cotangents to slot order with ``perm`` (a pad slot
    duplicates its tile's cotangent), K5, then GMU level 2 reading K5's
    rows in tile order through ``inv``, so the merge sums in the
    unscheduled path's order.
    The schedule and ``frag_idx`` are index plumbing (no gradient)."""

    @staticmethod
    def forward(ctx, mu2d, conic, color, opacity, depth, frag_idx, perm, inv,
                trips, grid: TileGrid, chunk: int):
        views = None if mu2d.ndim == 2 else mu2d.shape[0]
        attrs = _pack_views(mu2d, conic, color, opacity, depth, frag_idx,
                            views)
        tiles = grid.num_tiles
        perm_flat, trips_flat = _flatten_sched(perm, trips, tiles, views)
        color_s, depth_s, finalt_s, stash_s = tile_render_fwd_sched(
            attrs, perm_flat, trips_flat, grid, chunk=chunk, tiles_per_view=tiles)
        ctx.save_for_backward(attrs, frag_idx, perm, inv, trips, color_s,
                              depth_s, finalt_s, stash_s)
        ctx.grid, ctx.chunk, ctx.views, ctx.n = grid, chunk, views, mu2d.shape[-2]
        rows = _view_rows(inv, views, perm.shape[-1])
        return _images(color_s, depth_s, finalt_s, grid, views, rows)

    @staticmethod
    def backward(ctx, g_img, g_depth, g_finalt):
        attrs, frag_idx, perm, inv, trips, *fwd_s = ctx.saved_tensors
        grid, views = ctx.grid, ctx.views
        tiles = grid.num_tiles
        perm_flat, trips_flat = _flatten_sched(perm, trips, tiles, views)
        perm_v = perm if views is not None else perm[None]
        cots = _cotangent_tiles(g_img, g_depth, g_finalt, grid, views,
                                [p.long() for p in perm_v])
        slot_grads = tile_render_bwd_sched(
            attrs, perm_flat, trips_flat, *fwd_s, *cots, grid,
            chunk=ctx.chunk, tiles_per_view=tiles)  # (B*S, 10, K) slot order
        rows = _view_rows(inv, views, perm.shape[-1])
        return (_merge_views(slot_grads, frag_idx, views, ctx.n, rows)
                + (None,) * 6)


def build_plan_schedule(frags: FragmentLists, plan: RasterPlan) -> TileSchedule:
    """The schedule of ``frags`` under ``plan``: (S,) fields for one view,
    (B, S) / (B, T) when ``frags`` carries a leading view axis."""
    def one(count):
        return build_schedule(count, plan.chunk, max_trips=plan.max_trips)

    if frags.count.ndim == 1:
        return one(frags.count)
    return stack_fragment_lists([one(c) for c in frags.count])


@register_backend("schedule")
def _schedule_backend(inputs: RasterInputs, plan: RasterPlan):
    sched = plan.sched
    if sched is None:
        # No carried schedule: derive it from this frame's counts.
        sched = build_plan_schedule(inputs.frags, plan)
    want = 1 if inputs.views is None else 2
    if sched.perm.ndim != want:
        kind = ("per-view (B, S) schedules (e.g. from build_plan_schedule)"
                if inputs.views else "a single-view (S,) schedule")
        raise ValueError(
            f"schedule backend: carried sched.perm is {sched.perm.ndim}-D "
            f"but these inputs need {kind}")
    return SchedRasterize.apply(inputs.mu2d, inputs.conic, inputs.color,
                                inputs.opacity, inputs.depth, inputs.frags.idx,
                                sched.perm, sched.inv, sched.trips, plan.grid,
                                plan.chunk)


def rasterize(inputs: RasterInputs, plan: RasterPlan):
    """(H,W,3) premultiplied color, (H,W) blended depth and (H,W) final
    transmittance — with a leading ``B`` when ``inputs`` are batched."""
    return get_backend(plan.backend)(inputs, plan)
