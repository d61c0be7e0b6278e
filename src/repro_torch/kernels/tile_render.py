"""K1 and K4 — forward tile rasterizer with the R&B alpha stash.

K1 replaces ``repro/kernels/tile_render.py::tile_render_fwd`` (Pallas,
``pallas_call`` at line 175), K4 its WSU-scheduled form
``tile_render_fwd_sched`` (``pallas_call`` at line 280).  Both kernels are
in ``csrc/tile_render.cu`` and share one per-tile device function.  A
thread a pixel stages its tile's fragments once and runs the chunks: a
vote over its block's pixels, then per fragment the alpha, its stash store
and the blend step.  A tile runs on one block of :data:`FWD_THREADS`
threads, or, where the grid has fewer than two tiles (K1) or pairs (K4)
per SM (RTGS's 70-tile tracking grid), is split by pixels over a
thread-block cluster of two (:func:`fwd_cluster`), whose blocks exchange
how many chunks their pixels kept running once, at the end (see the
source note in the ``.cu`` file).  K4 runs one block or cluster per
balanced pair of slots, each slot bounded by its trips, outputs in slot
order.  Any K that the chunk divides is taken: a block stages at most
:data:`FWD_WINDOW` fragments at a time.

:func:`tile_render_fwd` and :func:`tile_render_fwd_sched` are the
wrappers: on a CUDA tensor they launch the kernel (or raise); on a CPU
tensor they run :func:`tile_render_fwd_plain` /
:func:`tile_render_fwd_sched_plain`, plain PyTorch versions with the same
chunk, skip and stash semantics.  Each wrapper's ``launches`` counts kernel
launches and each plain version's ``calls`` counts plain runs.

K4 and K5 do not check the values of ``perm`` and ``trips`` on the card
(that would cost a host sync per launch): a slot whose perm entry is
outside ``[0, rows)`` or whose trips are outside ``[0, K / chunk]`` runs as a
pad slot (or with clamped trips) and sets a bit of a per-device fault
word, which :func:`raise_on_sched_fault` reads.  On CPU tensors the values
are checked before the plain version runs.
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
# The launch shape of K1 and K4 (constants of ``csrc/tile_render.cu``):
FWD_THREADS = 256  # threads a tile, one a pixel
FWD_WINDOW = 1024  # the most fragments a block holds staged
# Fewer than this many tiles (K1) or pairs (K4) per SM: a cluster of
# FWD_SPLIT blocks a tile (pair), else one block.
FWD_SPLIT_BELOW = 2
FWD_SPLIT = 2

_P, _I = ctypes.c_void_p, ctypes.c_int


FAULT_PERM, FAULT_TRIPS = 1, 2  # bits of the scheduled kernels' fault word


def _lib():
    lib = _build.load("tile_render")
    fn = lib.tile_render_fwd
    fn.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _I]
    fn.restype = _I
    fn = lib.tile_render_fwd_sched
    fn.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _I]
    fn.restype = _I
    fn = lib.tile_render_fwd_smem
    fn.argtypes = [_I, _I]
    fn.restype = _I
    return lib


def fwd_cluster(blocks: int, sms: int) -> int:
    """Blocks per tile (K1) or per pair of slots (K4) for ``blocks`` tiles
    or pairs on a card of ``sms`` SMs: :data:`FWD_SPLIT` below
    :data:`FWD_SPLIT_BELOW` per SM, else one."""
    return FWD_SPLIT if blocks < FWD_SPLIT_BELOW * sms else 1


_SMS: dict[torch.device, int] = {}


def _cluster_for(device: torch.device, blocks: int) -> int:
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return fwd_cluster(blocks, _SMS[device])


def fwd_launch_shape(blocks: int, cap: int, chunk: int, device) -> dict:
    """The launch shape K1 (``blocks`` tiles) or K4 (``blocks`` pairs of
    slots) takes on ``device``: threads per block (a thread a pixel of the
    block's share of the tile), blocks per tile or pair (the cluster size)
    and each block's dynamic shared memory in bytes."""
    c = _cluster_for(torch.device(device), blocks)
    return dict(threads=FWD_THREADS // c, cluster=c,
                smem_bytes=int(_lib().tile_render_fwd_smem(cap, chunk)))


_FAULT_WORDS: dict[torch.device, torch.Tensor] = {}


def sched_fault_word(device: torch.device) -> torch.Tensor:
    """The (1,) int32 fault word K4 and K5 write on ``device``."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:  # "cuda" is cuda:<current>
        device = torch.device("cuda", torch.cuda.current_device())
    if device not in _FAULT_WORDS:
        _FAULT_WORDS[device] = torch.zeros(1, dtype=torch.int32, device=device)
    return _FAULT_WORDS[device]


def raise_on_sched_fault(device) -> None:
    """Read and clear the fault word of ``device`` (one host sync); raise if
    a scheduled kernel met a perm entry or trip count out of range."""
    word = sched_fault_word(device)
    bits = int(word.item())
    if bits:
        word.zero_()
        what = [name for bit, name in ((FAULT_PERM, "perm entry outside [0, rows)"),
                                       (FAULT_TRIPS, "trips outside [0, K / chunk]"))
                if bits & bit]
        raise RuntimeError(f"scheduled kernel fault on {device}: {', '.join(what)}")


def _pixel_coords_rows(grid: TileGrid, tile_ids: torch.Tensor):
    """(rows, 256) pixel centres of the given in-view tile ids."""
    px, py = tile_pixel_coords(grid, tile_ids.device)
    sel = tile_ids.long()
    return px[sel], py[sel]


def _row_tiles(rows: int, tiles: int, device) -> torch.Tensor:
    """In-view tile of each stacked row: ``r % tiles``."""
    return torch.arange(rows, device=device) % tiles


def _div_up(x: torch.Tensor, d: int) -> torch.Tensor:
    return torch.div(x + d - 1, d, rounding_mode="floor")


def _check_attrs(attrs: torch.Tensor, chunk: int, tiles_per_view):
    """Validate packed attrs (rows, 12, K) and the chunk and view split;
    returns (rows, K, tiles)."""
    if attrs.dtype != torch.float32:
        raise TypeError(f"attrs must be float32, got {attrs.dtype}")
    if attrs.ndim != 3 or attrs.shape[1] != NUM_ATTRS:
        raise ValueError(f"attrs must be (rows, {NUM_ATTRS}, K), got {tuple(attrs.shape)}")
    rows, _, cap = attrs.shape
    if cap % chunk or not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk {chunk} must divide K={cap} and be <= {MAX_CHUNK}")
    tiles = tiles_per_view or rows
    if rows % tiles:
        raise ValueError(f"{rows} rows are not a whole number of {tiles}-tile views")
    return rows, cap, tiles


def check_raster_operands(attrs: torch.Tensor, count: torch.Tensor,
                          chunk: int, tiles_per_view):
    """Validate the operands shared by K1 and K2; returns (rows, K, tiles)."""
    rows, cap, tiles = _check_attrs(attrs, chunk, tiles_per_view)
    if count.dtype != torch.int32:
        raise TypeError(f"count must be int32, got {count.dtype}")
    if count.shape != (rows,):
        raise ValueError(f"count must be ({rows},), got {tuple(count.shape)}")
    return rows, cap, tiles


def check_sched_operands(attrs: torch.Tensor, perm: torch.Tensor,
                         trips: torch.Tensor, chunk: int, tiles_per_view):
    """Validate the operands of K4 and K5; returns (rows, K, tiles, slots).

    The values of ``perm`` and ``trips`` are checked here only on the CPU;
    on the card the kernels guard them (see the module docstring)."""
    rows, cap, tiles = _check_attrs(attrs, chunk, tiles_per_view)
    for name, t in (("perm", perm), ("trips", trips)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.device != attrs.device:
            raise ValueError(f"{name} is on {t.device}, attrs on {attrs.device}")
        if t.ndim != 1:
            raise ValueError(f"{name} must be 1-D, got {tuple(t.shape)}")
    slots = perm.shape[0]
    if trips.shape != (slots,):
        raise ValueError(f"trips must be ({slots},), got {tuple(trips.shape)}")
    if slots % 2 or slots < rows:
        raise ValueError(f"{slots} slots: need an even count of at least {rows}")
    if attrs.device.type == "cpu" and slots:
        if int(perm.min()) < 0 or int(perm.max()) >= rows:
            raise ValueError(f"perm entries must lie in [0, {rows})")
        if int(trips.min()) < 0 or int(trips.max()) > cap // chunk:
            raise ValueError(f"trips must lie in [0, {cap // chunk}]")
    return rows, cap, tiles, slots


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
            torch.cuda.current_stream().cuda_stream,
            _cluster_for(attrs.device, rows))
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
    vectorized over tiles."""
    tile_render_fwd_plain.calls += 1
    rows, cap, tiles = check_raster_operands(attrs, count, chunk, tiles_per_view)
    return _fwd_rows(attrs, _row_tiles(rows, tiles, attrs.device),
                     _div_up(count, chunk), grid, chunk)


tile_render_fwd_plain.calls = 0


def tile_render_fwd_sched(attrs: torch.Tensor, perm: torch.Tensor,
                          trips: torch.Tensor, grid: TileGrid,
                          chunk: int = DEFAULT_CHUNK,
                          tiles_per_view: int | None = None):
    """K4: K1 under a WSU schedule.  Slot ``i`` renders attrs row
    ``perm[i]`` (tile ``perm[i] % tiles_per_view`` of its view) with
    ``trips[i]`` chunk trips; slots ``2p`` and ``2p+1`` run in one block
    or cluster (:func:`fwd_cluster`).
    Returns K1's four outputs with one row per slot, in slot order."""
    rows, cap, tiles, slots = check_sched_operands(attrs, perm, trips, chunk,
                                                   tiles_per_view)
    if attrs.device.type == "cpu":
        return tile_render_fwd_sched_plain(attrs, perm, trips, grid, chunk,
                                           tiles_per_view)
    if attrs.device.type != "cuda":
        raise ValueError(f"no K4 for device {attrs.device}")
    _check_cuda(attrs, perm, trips)
    kw = dict(dtype=torch.float32, device=attrs.device)
    color = torch.empty((slots, 3, PIX), **kw)
    depth = torch.empty((slots, PIX), **kw)
    finalt = torch.empty((slots, PIX), **kw)
    stash = torch.empty((slots, cap, PIX), **kw)
    fault = sched_fault_word(attrs.device)
    with torch.cuda.device(attrs.device):
        err = _lib().tile_render_fwd_sched(
            attrs.data_ptr(), perm.data_ptr(), trips.data_ptr(),
            color.data_ptr(), depth.data_ptr(), finalt.data_ptr(),
            stash.data_ptr(), fault.data_ptr(), rows, slots, cap, chunk, tiles,
            grid.grid_w, torch.cuda.current_stream().cuda_stream,
            _cluster_for(attrs.device, slots // 2))
    if err:
        raise RuntimeError(f"K4 tile_render_fwd_sched launch failed: cudaError {err}")
    tile_render_fwd_sched.launches += 1
    return color, depth, finalt, stash


tile_render_fwd_sched.launches = 0


def tile_render_fwd_sched_plain(attrs: torch.Tensor, perm: torch.Tensor,
                                trips: torch.Tensor, grid: TileGrid,
                                chunk: int = DEFAULT_CHUNK,
                                tiles_per_view: int | None = None):
    """Plain PyTorch K4: gather the slots' attrs rows and run K1's chunk
    loop on them, each slot bounded by its own trips."""
    tile_render_fwd_sched_plain.calls += 1
    _, _, tiles, _ = check_sched_operands(attrs, perm, trips, chunk,
                                          tiles_per_view)
    return _fwd_rows(attrs[perm.long()], perm % tiles, trips, grid, chunk)


tile_render_fwd_sched_plain.calls = 0


def _fwd_rows(attrs: torch.Tensor, tile_ids: torch.Tensor, trips: torch.Tensor,
              grid: TileGrid, chunk: int):
    """The plain chunk loop over rows of attrs (R, 12, K), row ``r`` being
    in-view tile ``tile_ids[r]`` with ``trips[r]`` chunk trips.  A row whose
    chunk is skipped gets zero alphas, which leaves its accumulators and
    transmittance bit-unchanged."""
    rows, _, cap = attrs.shape
    dev = attrs.device
    px, py = _pixel_coords_rows(grid, tile_ids)
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
