"""K1 — forward tile rasterizer with the R&B alpha stash.

Replaces ``repro/kernels/tile_render.py::tile_render_fwd`` (Pallas,
``pallas_call`` at line 175).  The kernel is ``csrc/tile_render.cu``:
one 256-thread block per 16x16 tile, the chunk's attributes staged in
shared memory, the chunk skip as a block vote.  On the H100 it is bound by
bytes — at the slice's shapes each view writes a 315 MB stash against
~78M ``exp`` evaluations — so its stash stores are fully coalesced and
written exactly once (see the source note in the ``.cu`` file).

:func:`tile_render_fwd` is the wrapper: on a CUDA tensor it launches the
kernel (or raises); on a CPU tensor it runs :func:`tile_render_fwd_plain`,
the plain PyTorch version with the same chunk, skip and stash semantics.
``tile_render_fwd.launches`` counts kernel launches and
``tile_render_fwd_plain.calls`` counts plain runs.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.sorting import TileGrid
from repro_torch.kernels import _build
from repro_torch.kernels.ref import (
    ALPHA_MAX, ALPHA_MIN, NUM_ATTRS, PIX, TERM_EPS, tile_pixel_coords,
)

DEFAULT_CHUNK = 16
MAX_CHUNK = 64  # shared-memory staging bound of the CUDA kernels

_P, _I = ctypes.c_void_p, ctypes.c_int


def _lib():
    lib = _build.load("tile_render")
    fn = lib.tile_render_fwd
    fn.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
    fn.restype = _I
    return lib


def _pixel_coords_rows(grid: TileGrid, rows: int, tiles: int, device):
    """(rows, 256) pixel centres; row r is tile r % tiles of its view."""
    px, py = tile_pixel_coords(grid, device)
    sel = torch.arange(rows, device=device) % tiles
    return px[sel], py[sel]


def check_raster_operands(attrs: torch.Tensor, count: torch.Tensor,
                          chunk: int, tiles_per_view):
    """Validate the operands shared by K1 and K2; returns (rows, K, tiles)."""
    if attrs.dtype != torch.float32 or count.dtype != torch.int32:
        raise TypeError("attrs must be float32 and count int32")
    if attrs.ndim != 3 or attrs.shape[1] != NUM_ATTRS:
        raise ValueError(f"attrs must be (rows, {NUM_ATTRS}, K), got {tuple(attrs.shape)}")
    rows, _, cap = attrs.shape
    if count.shape != (rows,):
        raise ValueError(f"count must be ({rows},), got {tuple(count.shape)}")
    if cap % chunk or not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk {chunk} must divide K={cap} and be <= {MAX_CHUNK}")
    tiles = tiles_per_view or rows
    if rows % tiles:
        raise ValueError(f"{rows} rows are not a whole number of {tiles}-tile views")
    return rows, cap, tiles


def _check_cuda(*ts: torch.Tensor) -> None:
    dev = ts[0].device
    for t in ts:
        if t.device != dev or not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous and on one device")


def tile_render_fwd(attrs: torch.Tensor, count: torch.Tensor, grid: TileGrid,
                    chunk: int = DEFAULT_CHUNK, tiles_per_view: int | None = None):
    """Returns (color (R,3,256), depth (R,256), final_T (R,256),
    stash (R,K,256)) for ``R`` rows of packed attrs (R, 12, K).

    ``tiles_per_view`` stacks views along the row axis: row ``r`` renders
    tile ``r % tiles_per_view`` of its view."""
    rows, cap, tiles = check_raster_operands(attrs, count, chunk, tiles_per_view)
    if attrs.device.type == "cpu":
        return tile_render_fwd_plain(attrs, count, grid, chunk, tiles_per_view)
    if attrs.device.type != "cuda":
        raise ValueError(f"no K1 for device {attrs.device}")
    _check_cuda(attrs, count)
    kw = dict(dtype=torch.float32, device=attrs.device)
    color = torch.empty((rows, 3, PIX), **kw)
    depth = torch.empty((rows, PIX), **kw)
    finalt = torch.empty((rows, PIX), **kw)
    stash = torch.empty((rows, cap, PIX), **kw)
    with torch.cuda.device(attrs.device):
        err = _lib().tile_render_fwd(
            attrs.data_ptr(), count.data_ptr(), color.data_ptr(),
            depth.data_ptr(), finalt.data_ptr(), stash.data_ptr(),
            rows, cap, chunk, tiles, grid.grid_w,
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"K1 tile_render_fwd launch failed: cudaError {err}")
    tile_render_fwd.launches += 1
    return color, depth, finalt, stash


tile_render_fwd.launches = 0


def tile_render_fwd_plain(attrs: torch.Tensor, count: torch.Tensor,
                          grid: TileGrid, chunk: int = DEFAULT_CHUNK,
                          tiles_per_view: int | None = None):
    """Plain PyTorch K1: the same chunk loop, chunk skip and stash contract
    (raw alpha of every pixel of every processed chunk, zeros elsewhere),
    vectorized over tiles.  A row whose chunk is skipped gets zero alphas,
    which leaves its accumulators and transmittance bit-unchanged."""
    tile_render_fwd_plain.calls += 1
    rows, cap, tiles = check_raster_operands(attrs, count, chunk, tiles_per_view)
    dev = attrs.device
    px, py = _pixel_coords_rows(grid, rows, tiles, dev)
    trips = torch.div(count + chunk - 1, chunk, rounding_mode="floor")
    zeros = torch.zeros((rows, PIX), dtype=torch.float32, device=dev)
    acc_r, acc_g, acc_b, acc_d = zeros, zeros, zeros, zeros
    trans = torch.ones((rows, PIX), dtype=torch.float32, device=dev)
    stash = torch.zeros((rows, cap, PIX), dtype=torch.float32, device=dev)
    for c in range(cap // chunk):
        live = (c < trips) & (trans > TERM_EPS).any(dim=-1)
        if not bool(live.any()):
            break
        sl = slice(c * chunk, (c + 1) * chunk)
        at = attrs[:, :, sl, None]                       # (R, 12, C, 1)
        dx = px[:, None, :] - at[:, 0]                   # (R, C, 256)
        dy = py[:, None, :] - at[:, 1]
        q = at[:, 2] * dx * dx + 2.0 * at[:, 3] * dx * dy + at[:, 4] * dy * dy
        gauss = torch.exp(-0.5 * torch.clamp(q, min=0.0))
        alpha = torch.clamp(at[:, 8] * gauss, max=ALPHA_MAX)
        keep = (alpha >= ALPHA_MIN) & (at[:, 10] > 0.5) & live[:, None, None]
        alpha = torch.where(keep, alpha, torch.zeros_like(alpha))
        stash[:, sl] = alpha
        for i in range(chunk):
            k = c * chunk + i
            am = alpha[:, i] * (trans > TERM_EPS).to(torch.float32)
            w = trans * am
            acc_r = acc_r + w * attrs[:, 5, k, None]
            acc_g = acc_g + w * attrs[:, 6, k, None]
            acc_b = acc_b + w * attrs[:, 7, k, None]
            acc_d = acc_d + w * attrs[:, 9, k, None]
            trans = trans * (1.0 - am)
    color = torch.stack([acc_r, acc_g, acc_b], dim=1)
    return color, acc_d, trans, stash


tile_render_fwd_plain.calls = 0
