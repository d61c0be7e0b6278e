"""K2 and K5 — backward tile rasterizer replaying the R&B stash (GMU
level 1).

K2 replaces ``repro/kernels/tile_render_bp.py::tile_render_bwd`` (Pallas,
``pallas_call`` at line 208), K5 its WSU-scheduled form
``tile_render_bwd_sched`` (``pallas_call`` at line 302).  Both kernels are
in ``csrc/tile_render_bp.cu`` and share one per-tile device function: K2
runs one 256-thread block per tile, K5 one block per balanced pair of
schedule slots, with the stash, cotangents and gradients in slot order.
Per tile, pass A replays the blend from the stash
with multiplies only, pass B forms the per-fragment gradients

    dL/dalpha_k = T_k s_k - (S_k + T_final g_T) / (1 - am_k),
    S_k = total - prefix_k,  s_k = gC . c_k + gD d_k,

chains them to mu, conic and opacity (with the clip mask) and to color
and depth, and sums each of the 10 over the tile's 256 pixels in the block
(warp shuffles, then shared memory; no atomics).  On the H100 it is bound
by bytes: it reads each view's 315 MB stash twice for ~60 flops per
(pixel, fragment), far below the fp32 ridge point; loads are coalesced
and the per-pixel gradients never reach device memory.

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

_P, _I = ctypes.c_void_p, ctypes.c_int


def _lib():
    lib = _build.load("tile_render_bp")
    fn = lib.tile_render_bwd
    fn.argtypes = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
    fn.restype = _I
    fn = lib.tile_render_bwd_sched
    fn.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
    fn.restype = _I
    return lib


def _check_cotangents(rows, cap, stash, g_color, g_depth, g_finalt):
    want = {"stash": (stash, (rows, cap, PIX)),
            "g_color": (g_color, (rows, 3, PIX)),
            "g_depth": (g_depth, (rows, PIX)),
            "g_finalt": (g_finalt, (rows, PIX))}
    for name, (t, shape) in want.items():
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be float32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")


def tile_render_bwd(attrs: torch.Tensor, count: torch.Tensor,
                    stash: torch.Tensor, g_color: torch.Tensor,
                    g_depth: torch.Tensor, g_finalt: torch.Tensor,
                    grid: TileGrid, chunk: int = DEFAULT_CHUNK,
                    tiles_per_view: int | None = None) -> torch.Tensor:
    """Per-(tile, fragment) gradients, already summed over pixels:
    (R, 10, K)."""
    rows, cap, tiles = check_raster_operands(attrs, count, chunk, tiles_per_view)
    _check_cotangents(rows, cap, stash, g_color, g_depth, g_finalt)
    if attrs.device.type == "cpu":
        return tile_render_bwd_plain(attrs, count, stash, g_color, g_depth,
                                     g_finalt, grid, chunk, tiles_per_view)
    if attrs.device.type != "cuda":
        raise ValueError(f"no K2 for device {attrs.device}")
    _check_cuda(attrs, count, stash, g_color, g_depth, g_finalt)
    grads = torch.empty((rows, NUM_GRADS, cap), dtype=torch.float32,
                        device=attrs.device)
    with torch.cuda.device(attrs.device):
        err = _lib().tile_render_bwd(
            attrs.data_ptr(), count.data_ptr(), stash.data_ptr(),
            g_color.data_ptr(), g_depth.data_ptr(), g_finalt.data_ptr(),
            grads.data_ptr(), rows, cap, chunk, tiles, grid.grid_w,
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"K2 tile_render_bwd launch failed: cudaError {err}")
    tile_render_bwd.launches += 1
    return grads


tile_render_bwd.launches = 0


def tile_render_bwd_plain(attrs: torch.Tensor, count: torch.Tensor,
                          stash: torch.Tensor, g_color: torch.Tensor,
                          g_depth: torch.Tensor, g_finalt: torch.Tensor,
                          grid: TileGrid, chunk: int = DEFAULT_CHUNK,
                          tiles_per_view: int | None = None) -> torch.Tensor:
    """Plain PyTorch K2, vectorized over tiles, with K1's chunk skips
    replayed."""
    tile_render_bwd_plain.calls += 1
    rows, cap, tiles = check_raster_operands(attrs, count, chunk, tiles_per_view)
    _check_cotangents(rows, cap, stash, g_color, g_depth, g_finalt)
    return _bwd_rows(attrs, _row_tiles(rows, tiles, attrs.device),
                     _div_up(count, chunk), stash, g_color, g_depth, g_finalt,
                     grid, chunk)


tile_render_bwd_plain.calls = 0


def tile_render_bwd_sched(attrs: torch.Tensor, perm: torch.Tensor,
                          trips: torch.Tensor, stash: torch.Tensor,
                          g_color: torch.Tensor, g_depth: torch.Tensor,
                          g_finalt: torch.Tensor, grid: TileGrid,
                          chunk: int = DEFAULT_CHUNK,
                          tiles_per_view: int | None = None) -> torch.Tensor:
    """K5: K2 replaying a WSU schedule.  The stash (straight from K4) and
    the cotangents (gathered with ``perm``) arrive in slot order; the
    per-fragment gradients (S, 10, K) return in slot order."""
    rows, cap, tiles, slots = check_sched_operands(attrs, perm, trips, chunk,
                                                   tiles_per_view)
    _check_cotangents(slots, cap, stash, g_color, g_depth, g_finalt)
    if attrs.device.type == "cpu":
        return tile_render_bwd_sched_plain(attrs, perm, trips, stash, g_color,
                                           g_depth, g_finalt, grid, chunk,
                                           tiles_per_view)
    if attrs.device.type != "cuda":
        raise ValueError(f"no K5 for device {attrs.device}")
    _check_cuda(attrs, perm, trips, stash, g_color, g_depth, g_finalt)
    grads = torch.empty((slots, NUM_GRADS, cap), dtype=torch.float32,
                        device=attrs.device)
    fault = sched_fault_word(attrs.device)
    with torch.cuda.device(attrs.device):
        err = _lib().tile_render_bwd_sched(
            attrs.data_ptr(), perm.data_ptr(), trips.data_ptr(),
            stash.data_ptr(), g_color.data_ptr(), g_depth.data_ptr(),
            g_finalt.data_ptr(), grads.data_ptr(), fault.data_ptr(), rows,
            slots, cap, chunk, tiles, grid.grid_w,
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"K5 tile_render_bwd_sched launch failed: cudaError {err}")
    tile_render_bwd_sched.launches += 1
    return grads


tile_render_bwd_sched.launches = 0


def tile_render_bwd_sched_plain(attrs: torch.Tensor, perm: torch.Tensor,
                                trips: torch.Tensor, stash: torch.Tensor,
                                g_color: torch.Tensor, g_depth: torch.Tensor,
                                g_finalt: torch.Tensor, grid: TileGrid,
                                chunk: int = DEFAULT_CHUNK,
                                tiles_per_view: int | None = None) -> torch.Tensor:
    """Plain PyTorch K5: K2's two passes over the slots' gathered attrs
    rows, each slot bounded by its own trips."""
    tile_render_bwd_sched_plain.calls += 1
    _, cap, tiles, slots = check_sched_operands(attrs, perm, trips, chunk,
                                                tiles_per_view)
    _check_cotangents(slots, cap, stash, g_color, g_depth, g_finalt)
    return _bwd_rows(attrs[perm.long()], perm % tiles, trips, stash, g_color,
                     g_depth, g_finalt, grid, chunk)


tile_render_bwd_sched_plain.calls = 0


def _bwd_rows(attrs, tile_ids, trips, stash, g_color, g_depth, g_finalt,
              grid: TileGrid, chunk: int) -> torch.Tensor:
    """The plain two-pass backward over rows of attrs (R, 12, K), row ``r``
    being in-view tile ``tile_ids[r]`` with ``trips[r]`` chunk trips.  A
    skipped chunk's alphas are zeroed (its carries stay bit-unchanged) and
    its gradient rows stay zero."""
    rows, _, cap = attrs.shape
    dev = attrs.device
    px, py = _pixel_coords_rows(grid, tile_ids)
    g_r, g_g, g_b = g_color[:, 0], g_color[:, 1], g_color[:, 2]
    g_d, g_t = g_depth, g_finalt
    n_chunks = cap // chunk

    def chunk_alpha(c, trans):
        live = (c < trips) & (trans > TERM_EPS).any(dim=-1)
        al = stash[:, c * chunk:(c + 1) * chunk]
        return live, torch.where(live[:, None, None], al, torch.zeros_like(al))

    def weight_cot(k):
        return (g_r * attrs[:, 5, k, None] + g_g * attrs[:, 6, k, None]
                + g_b * attrs[:, 7, k, None] + g_d * attrs[:, 9, k, None])

    # ---- pass A: total sum(w * s) and final T ------------------------------
    trans = torch.ones((rows, PIX), dtype=torch.float32, device=dev)
    total_ws = torch.zeros_like(trans)
    for c in range(n_chunks):
        live, alpha = chunk_alpha(c, trans)
        if not bool(live.any()):
            break
        for i in range(chunk):
            am = alpha[:, i] * (trans > TERM_EPS).to(torch.float32)
            w = trans * am
            total_ws = total_ws + w * weight_cot(c * chunk + i)
            trans = trans * (1.0 - am)
    ft_gt = trans * g_t

    # ---- pass B: fragment gradients, summed over the tile's pixels --------
    grads = torch.zeros((rows, NUM_GRADS, cap), dtype=torch.float32, device=dev)
    trans = torch.ones((rows, PIX), dtype=torch.float32, device=dev)
    prefix = torch.zeros_like(trans)
    for c in range(n_chunks):
        live, alpha = chunk_alpha(c, trans)
        if not bool(live.any()):
            break
        for i in range(chunk):
            k = c * chunk + i
            a = alpha[:, i]
            include = (trans > TERM_EPS).to(torch.float32)
            am = a * include
            w = trans * am
            s = weight_cot(k)
            prefix = prefix + w * s
            suffix = total_ws - prefix
            dam = trans * s - (suffix + ft_gt) / (1.0 - am)
            da = dam * include
            o = attrs[:, 8, k, None]
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
                da * (a / torch.clamp(o, min=1e-12)) * clip,
                w * g_d,
            ], dim=1)                                        # (R, 10, 256)
            sums = per_pixel.sum(dim=-1)
            grads[:, :, k] = torch.where(live[:, None], sums, torch.zeros_like(sums))
            trans = trans * (1.0 - am)
    return grads

