"""Differentiable rasterization behind the backend registry (counterpart of
``repro/kernels/ops.py``).

Two built-in backends:

  ref     the pure-tensor oracle; gradients by torch autograd.
  kernel  the counterpart of the reference's ``pallas`` backend: a
          ``torch.autograd.Function`` whose forward runs K1 and keeps the
          R&B stash, and whose backward runs K2 on the stash (GMU level 1)
          and then GMU level 2 per view.  On CUDA tensors K1 and K2 are the
          CUDA kernels; on CPU tensors they are their plain versions.

Batched views (a leading ``B`` on every ``RasterInputs`` tensor) run as ONE
stacked K1 launch and ONE stacked K2 launch over ``B * T`` tile rows; the
packing and the level-2 merge run per view.
"""

from __future__ import annotations

import torch

from repro_torch.core.raster_api import (
    RasterInputs, RasterPlan, get_backend, register_backend,
)
from repro_torch.core.sorting import TileGrid
from repro_torch.kernels import gmu, ref
from repro_torch.kernels.tile_render import tile_render_fwd
from repro_torch.kernels.tile_render_bp import NUM_GRADS, tile_render_bwd


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


def _pack_views(mu2d, conic, color, opacity, depth, idx, count, views):
    """Packed attrs (B*T, 12, K) + flat counts for 1 or B stacked views."""
    if views is None:
        return _pack_attrs(mu2d, conic, color, opacity, depth, idx), count
    packed = [_pack_attrs(mu2d[b], conic[b], color[b], opacity[b], depth[b],
                          idx[b]) for b in range(views)]
    return torch.cat(packed), count.reshape(-1)


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


class KernelRasterize(torch.autograd.Function):
    """Forward: pack, K1 (stash kept).  Backward: cotangents to tiles, K2
    on the stash, GMU level 2 per view.  ``frag_idx``/``count`` are index
    plumbing (no gradient)."""

    @staticmethod
    def forward(ctx, mu2d, conic, color, opacity, depth, frag_idx, count,
                grid: TileGrid, chunk: int):
        views = None if mu2d.ndim == 2 else mu2d.shape[0]
        attrs, cnt = _pack_views(mu2d, conic, color, opacity, depth,
                                 frag_idx, count, views)
        tiles = grid.num_tiles
        color_t, depth_t, finalt_t, stash = tile_render_fwd(
            attrs, cnt, grid, chunk=chunk, tiles_per_view=tiles)
        ctx.save_for_backward(attrs, cnt, frag_idx, stash)
        ctx.grid, ctx.chunk, ctx.views, ctx.n = grid, chunk, views, mu2d.shape[-2]
        outs = []
        for b in range(views or 1):
            sl = slice(b * tiles, (b + 1) * tiles)
            outs.append((ref.tiles_to_image(color_t[sl].transpose(1, 2), grid),
                         ref.tiles_to_image(depth_t[sl], grid),
                         ref.tiles_to_image(finalt_t[sl], grid)))
        if views is None:
            return outs[0]
        return tuple(torch.stack([o[i] for o in outs]) for i in range(3))

    @staticmethod
    def backward(ctx, g_img, g_depth, g_finalt):
        attrs, cnt, frag_idx, stash = ctx.saved_tensors
        grid, views, n = ctx.grid, ctx.views, ctx.n
        tiles = grid.num_tiles
        if views is None:
            g_img, g_depth, g_finalt = g_img[None], g_depth[None], g_finalt[None]
        nv = views or 1
        g_color_t = torch.cat([ref.image_to_tiles(g_img[b], grid).transpose(1, 2)
                               for b in range(nv)]).contiguous()
        g_depth_t = torch.cat([ref.image_to_tiles(g_depth[b], grid)
                               for b in range(nv)]).contiguous()
        g_finalt_t = torch.cat([ref.image_to_tiles(g_finalt[b], grid)
                                for b in range(nv)]).contiguous()
        tile_grads = tile_render_bwd(attrs, cnt, stash, g_color_t, g_depth_t,
                                     g_finalt_t, grid, chunk=ctx.chunk,
                                     tiles_per_view=tiles)  # (B*T, 10, K)
        idx = frag_idx if views is not None else frag_idx[None]
        merged = torch.stack([
            gmu.segment_merge(
                tile_grads[b * tiles:(b + 1) * tiles].transpose(1, 2)
                .reshape(-1, NUM_GRADS), idx[b].reshape(-1), n)
            for b in range(nv)])
        if views is None:
            merged = merged[0]
        return (merged[..., 0:2], merged[..., 2:5], merged[..., 5:8],
                merged[..., 8], merged[..., 9], None, None, None, None)


@register_backend("kernel")
def _kernel_backend(inputs: RasterInputs, plan: RasterPlan):
    return KernelRasterize.apply(inputs.mu2d, inputs.conic, inputs.color,
                                 inputs.opacity, inputs.depth,
                                 inputs.frags.idx, inputs.frags.count,
                                 plan.grid, plan.chunk)


def rasterize(inputs: RasterInputs, plan: RasterPlan):
    """(H,W,3) premultiplied color, (H,W) blended depth and (H,W) final
    transmittance — with a leading ``B`` when ``inputs`` are batched."""
    return get_backend(plan.backend)(inputs, plan)
