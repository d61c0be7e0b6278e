"""K2 and K5 — backward tile rasterizer replaying the R&B stash (GMU
level 1).

K2 replaces ``repro/kernels/tile_render_bp.py::tile_render_bwd`` (Pallas,
``pallas_call`` at line 208), K5 its WSU-scheduled form
``tile_render_bwd_sched`` (``pallas_call`` at line 302).  Both kernels are
in ``csrc/tile_render_bp.cu`` and share one per-tile device function: K2
runs one 256-thread block per tile, K5 one block per balanced pair of
schedule slots, with the forward outputs, stash, cotangents and gradients
in slot order.  Per tile, ONE pass over the stash forms the per-fragment
gradients

    dL/dalpha_k = T_k s_k - (S_k + T_final g_T) / (1 - am_k),
    S_k = total - prefix_k,  s_k = gC . c_k + gD d_k,

with ``total = gC . C + gD D`` and ``T_final`` taken from the forward's own
tile outputs (color C, depth D, final_T): the reference's pass A, a replay
of the blend that recomputes them, is not needed.  The gradients are
chained to mu, conic and opacity (with the clip mask) and to color and
depth, and each of the 10 is summed over the tile's 256 pixels in the block
(a warp reduce-scatter over groups of :data:`REDUCE_GROUP` fragments, then
shared memory; no atomics), so the per-pixel gradients never reach
device memory.  The plain versions add the pixels in the kernels' order
(:func:`_pixel_sum`) and compute every other value with the same
operations, so on the card a kernel equals its plain version bit for bit.

:func:`tile_render_bwd` and :func:`tile_render_bwd_sched` launch the
kernels on CUDA tensors and run :func:`tile_render_bwd_plain` /
:func:`tile_render_bwd_sched_plain` on CPU tensors; their ``launches`` and
``calls`` count them.  K5 guards ``perm`` and ``trips`` as K4 does (see
``kernels/tile_render.py``).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.sorting import TileGrid
from repro_torch.kernels import _build
from repro_torch.kernels.ref import ALPHA_MAX, PIX, TERM_EPS
from repro_torch.kernels.tile_render import (
    DEFAULT_CHUNK, _check_cuda, _div_up, _pixel_coords_rows, _row_tiles,
    check_raster_operands, check_sched_operands, sched_fault_word,
)

NUM_GRADS = 10  # mu_x, mu_y, conic_a, conic_b, conic_c, r, g, b, opacity, depth
# Fragments per warp reduce-scatter in the kernels (GROUP in the source):
# a warp skips a whole group that none of its lanes draws.
REDUCE_GROUP = 8

_P, _I = ctypes.c_void_p, ctypes.c_int


def _lib():
    lib = _build.load("tile_render_bp")
    fn = lib.tile_render_bwd
    fn.argtypes = [_P] * 10 + [_I] * 5 + [_P]
    fn.restype = _I
    fn = lib.tile_render_bwd_sched
    fn.argtypes = [_P] * 12 + [_I] * 6 + [_P]
    fn.restype = _I
    return lib


def _check_bwd_operands(rows, cap, color, depth, final_t, stash, g_color,
                        g_depth, g_finalt):
    want = {"color": (color, (rows, 3, PIX)),
            "depth": (depth, (rows, PIX)),
            "final_t": (final_t, (rows, PIX)),
            "stash": (stash, (rows, cap, PIX)),
            "g_color": (g_color, (rows, 3, PIX)),
            "g_depth": (g_depth, (rows, PIX)),
            "g_finalt": (g_finalt, (rows, PIX))}
    for name, (t, shape) in want.items():
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be float32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")


def tile_render_bwd(attrs: torch.Tensor, count: torch.Tensor,
                    color: torch.Tensor, depth: torch.Tensor,
                    final_t: torch.Tensor, stash: torch.Tensor,
                    g_color: torch.Tensor, g_depth: torch.Tensor,
                    g_finalt: torch.Tensor, grid: TileGrid,
                    chunk: int = DEFAULT_CHUNK,
                    tiles_per_view: int | None = None) -> torch.Tensor:
    """Per-(tile, fragment) gradients, already summed over pixels:
    (R, 10, K).  ``color``, ``depth``, ``final_t`` and ``stash`` are K1's
    four outputs on the same attrs and counts."""
    rows, cap, tiles = check_raster_operands(attrs, count, chunk, tiles_per_view)
    fwd = (color, depth, final_t, stash)
    cots = (g_color, g_depth, g_finalt)
    _check_bwd_operands(rows, cap, *fwd, *cots)
    if attrs.device.type == "cpu":
        return tile_render_bwd_plain(attrs, count, *fwd, *cots, grid, chunk,
                                     tiles_per_view)
    if attrs.device.type != "cuda":
        raise ValueError(f"no K2 for device {attrs.device}")
    _check_cuda(attrs, count, *fwd, *cots)
    grads = torch.empty((rows, NUM_GRADS, cap), dtype=torch.float32,
                        device=attrs.device)
    with torch.cuda.device(attrs.device):
        err = _lib().tile_render_bwd(
            attrs.data_ptr(), count.data_ptr(), *(t.data_ptr() for t in fwd),
            *(t.data_ptr() for t in cots), grads.data_ptr(), rows, cap, chunk,
            tiles, grid.grid_w, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"K2 tile_render_bwd launch failed: cudaError {err}")
    tile_render_bwd.launches += 1
    return grads


tile_render_bwd.launches = 0


def tile_render_bwd_plain(attrs: torch.Tensor, count: torch.Tensor,
                          color: torch.Tensor, depth: torch.Tensor,
                          final_t: torch.Tensor, stash: torch.Tensor,
                          g_color: torch.Tensor, g_depth: torch.Tensor,
                          g_finalt: torch.Tensor, grid: TileGrid,
                          chunk: int = DEFAULT_CHUNK,
                          tiles_per_view: int | None = None) -> torch.Tensor:
    """Plain PyTorch K2, vectorized over tiles, with K1's chunk skips
    replayed."""
    tile_render_bwd_plain.calls += 1
    rows, cap, tiles = check_raster_operands(attrs, count, chunk, tiles_per_view)
    _check_bwd_operands(rows, cap, color, depth, final_t, stash, g_color,
                        g_depth, g_finalt)
    return _bwd_rows(attrs, _row_tiles(rows, tiles, attrs.device),
                     _div_up(count, chunk), color, depth, final_t, stash,
                     g_color, g_depth, g_finalt, grid, chunk)


tile_render_bwd_plain.calls = 0


def tile_render_bwd_sched(attrs: torch.Tensor, perm: torch.Tensor,
                          trips: torch.Tensor, color: torch.Tensor,
                          depth: torch.Tensor, final_t: torch.Tensor,
                          stash: torch.Tensor, g_color: torch.Tensor,
                          g_depth: torch.Tensor, g_finalt: torch.Tensor,
                          grid: TileGrid, chunk: int = DEFAULT_CHUNK,
                          tiles_per_view: int | None = None) -> torch.Tensor:
    """K5: K2 replaying a WSU schedule.  K4's four outputs (straight from
    K4) and the cotangents (gathered with ``perm``) arrive in slot order;
    the per-fragment gradients (S, 10, K) return in slot order."""
    rows, cap, tiles, slots = check_sched_operands(attrs, perm, trips, chunk,
                                                   tiles_per_view)
    fwd = (color, depth, final_t, stash)
    cots = (g_color, g_depth, g_finalt)
    _check_bwd_operands(slots, cap, *fwd, *cots)
    if attrs.device.type == "cpu":
        return tile_render_bwd_sched_plain(attrs, perm, trips, *fwd, *cots,
                                           grid, chunk, tiles_per_view)
    if attrs.device.type != "cuda":
        raise ValueError(f"no K5 for device {attrs.device}")
    _check_cuda(attrs, perm, trips, *fwd, *cots)
    grads = torch.empty((slots, NUM_GRADS, cap), dtype=torch.float32,
                        device=attrs.device)
    fault = sched_fault_word(attrs.device)
    with torch.cuda.device(attrs.device):
        err = _lib().tile_render_bwd_sched(
            attrs.data_ptr(), perm.data_ptr(), trips.data_ptr(),
            *(t.data_ptr() for t in fwd), *(t.data_ptr() for t in cots),
            grads.data_ptr(), fault.data_ptr(), rows, slots, cap, chunk, tiles,
            grid.grid_w, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"K5 tile_render_bwd_sched launch failed: cudaError {err}")
    tile_render_bwd_sched.launches += 1
    return grads


tile_render_bwd_sched.launches = 0


def tile_render_bwd_sched_plain(attrs: torch.Tensor, perm: torch.Tensor,
                                trips: torch.Tensor, color: torch.Tensor,
                                depth: torch.Tensor, final_t: torch.Tensor,
                                stash: torch.Tensor, g_color: torch.Tensor,
                                g_depth: torch.Tensor, g_finalt: torch.Tensor,
                                grid: TileGrid, chunk: int = DEFAULT_CHUNK,
                                tiles_per_view: int | None = None) -> torch.Tensor:
    """Plain PyTorch K5: K2's pass over the slots' gathered attrs rows,
    each slot bounded by its own trips."""
    tile_render_bwd_sched_plain.calls += 1
    _, cap, tiles, slots = check_sched_operands(attrs, perm, trips, chunk,
                                                tiles_per_view)
    _check_bwd_operands(slots, cap, color, depth, final_t, stash, g_color,
                        g_depth, g_finalt)
    return _bwd_rows(attrs[perm.long()], perm % tiles, trips, color, depth,
                     final_t, stash, g_color, g_depth, g_finalt, grid, chunk)


tile_render_bwd_sched_plain.calls = 0


def _pixel_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (a tile's 256 pixels) in the kernels' order,
    so that the plain versions equal them bit for bit: in each warp of 32
    pixels, lanes 16 apart first, then 8, 4, 2 and 1 apart (the warp
    exchanges; a float sum of two is the same in either order), then the 8
    warp sums one after another from 0."""
    x = x.reshape(*x.shape[:-1], PIX // 32, 32)
    half = 16
    while half:
        x = x[..., :half] + x[..., half:2 * half]
        half //= 2
    total = torch.zeros_like(x[..., 0, 0])
    for w in range(PIX // 32):
        total = total + x[..., w, 0]
    return total


def _bwd_rows(attrs, tile_ids, trips, color, depth, final_t, stash, g_color,
              g_depth, g_finalt, grid: TileGrid, chunk: int) -> torch.Tensor:
    """The plain one-pass backward over rows of attrs (R, 12, K), row ``r``
    being in-view tile ``tile_ids[r]`` with ``trips[r]`` chunk trips and
    forward outputs ``color[r]``, ``depth[r]``, ``final_t[r]``,
    ``stash[r]``.  A skipped chunk's alphas are zeroed (its carries stay
    bit-unchanged) and its gradient rows stay zero."""
    rows, _, cap = attrs.shape
    dev = attrs.device
    px, py = _pixel_coords_rows(grid, tile_ids)
    g_r, g_g, g_b = g_color[:, 0], g_color[:, 1], g_color[:, 2]
    g_d = g_depth
    # sum(w * s) and the final T, from the forward's outputs, added in the
    # kernels' order.
    total_ws = g_r * color[:, 0] + g_g * color[:, 1] + g_b * color[:, 2] + g_d * depth
    ft_gt = final_t * g_finalt

    grads = torch.zeros((rows, NUM_GRADS, cap), dtype=torch.float32, device=dev)
    trans = torch.ones((rows, PIX), dtype=torch.float32, device=dev)
    prefix = torch.zeros_like(trans)
    for c in range(cap // chunk):
        live = (c < trips) & (trans > TERM_EPS).any(dim=-1)
        if not bool(live.any()):
            break
        al = stash[:, c * chunk:(c + 1) * chunk]
        alpha = torch.where(live[:, None, None], al, torch.zeros_like(al))
        for i in range(chunk):
            k = c * chunk + i
            a = alpha[:, i]
            include = (trans > TERM_EPS).to(torch.float32)
            am = a * include
            w = trans * am
            s = (g_r * attrs[:, 5, k, None] + g_g * attrs[:, 6, k, None]
                 + g_b * attrs[:, 7, k, None] + g_d * attrs[:, 9, k, None])
            prefix = prefix + w * s
            suffix = total_ws - prefix
            dam = trans * s - (suffix + ft_gt) / (1.0 - am)
            da = dam * include
            inv_o = 1.0 / torch.clamp(attrs[:, 8, k, None], min=1e-12)
            clip = (a < ALPHA_MAX).to(torch.float32)
            dq = da * (-0.5 * a) * clip
            dx = px - attrs[:, 0, k, None]
            dy = py - attrs[:, 1, k, None]
            ca, cb, cc = (attrs[:, j, k, None] for j in (2, 3, 4))
            per_pixel = torch.stack([
                dq * (-2.0) * (ca * dx + cb * dy),
                dq * (-2.0) * (cb * dx + cc * dy),
                dq * dx * dx,
                dq * 2.0 * dx * dy,
                dq * dy * dy,
                w * g_r,
                w * g_g,
                w * g_b,
                da * (a * inv_o) * clip,
                w * g_d,
            ], dim=1)                                        # (R, 10, 256)
            sums = _pixel_sum(per_pixel)
            grads[:, :, k] = torch.where(live[:, None], sums, torch.zeros_like(sums))
            trans = trans * (1.0 - am)
    return grads
