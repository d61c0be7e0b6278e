"""Gradient Merging Unit, level 2 (counterpart of ``repro/kernels/gmu.py``),
and K3, its adder.

Level 1 (pixel -> tile) happens inside K2 and K5.  Level 2 (tile ->
Gaussian) is here: sort the (tile, fragment) rows by Gaussian id (stable,
padding last), take the inclusive prefix sum, and add ``+pref`` at each run
end and ``-pref_excl`` at each run start, as the reference does; padding
rows are dropped (the reference's ``mode="drop"``).

K3 is the port of the Pallas ``block_cumsum`` (``pallas_call`` at
``gmu.py:83``): ``csrc/gmu.cu``, one row-scan kernel (two launches: block
totals, with the carries from the last blocks to arrive, then the rows)
with two epilogues:

* scan, :func:`block_cumsum`: the prefix sum itself, written out;
* merge, :func:`merge_runs`: GMU level 2's run reduction over the sorted
  rows.  It adds only at valid run boundaries, atomically, into a zeroed
  output: at most one end and one start add per Gaussian, so the result
  does not depend on the order the adds land in.  It writes no prefix.

Both add in one fixed order (see the source note), which their plain
versions :func:`block_cumsum_plain` and :func:`merge_runs_plain` repeat, so
on the card each kernel equals its plain version bit for bit.  The
reference's main path takes its prefix sum from ``jnp.cumsum`` instead
(``use_pallas=False``); here K3 serves every call, as PyTorch's CUDA scan
over the outer dimension of a thin (M, 10) tensor is slow.  The level-2 sum
is held to a float64 segment sum, not bit for bit to the reference (whose
scans sum in other orders).

:func:`merge_views` merges B views in one sort and one K3 merge: view
``b``'s keys are offset by ``b * (N + 1)``, so the stable sort puts the
views one after another, each in its own sorted order, and K3 restarts the
prefix at every view; the result equals B one-view merges bit for bit.

Counters: ``block_cumsum.launches`` and ``merge_runs.launches`` count kernel
runs (each two launches), ``block_cumsum_plain.calls`` and
``merge_runs_plain.calls`` plain runs.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

BLOCK = 256
GROUP = 32       # blocks per carry group
MAX_COLUMNS = 32  # K3's register and shared-memory bound

_P, _I = ctypes.c_void_p, ctypes.c_int

# Per-device arrival counters of K3's pass 1, zeroed once; every launch
# leaves them zero again.  A CUDA graph that captured a launch keeps the
# buffer's address, so a buffer that has to grow is retired, never freed.
_ARRIVALS: dict[torch.device, torch.Tensor] = {}
_RETIRED: list[torch.Tensor] = []


def _lib():
    lib = _build.load("gmu")
    lib.block_cumsum.argtypes = [_P, _P, _P, _P, _I, _I, _P]
    lib.block_cumsum.restype = _I
    lib.merge_runs.argtypes = [_P] * 7 + [_I] * 6 + [_P]
    lib.merge_runs.restype = _I
    return lib


def _scratch(device, views: int, rows: int, g: int, merge: bool):
    """K3's float scratch (block totals and group sums; for a merge also the
    rows in sorted order) and the device's arrival counters, for ``views``
    views of ``rows`` rows."""
    blocks = -(-rows // BLOCK)
    groups = -(-blocks // GROUP)
    size = views * (blocks + groups) * g
    if merge:
        size += 3 + views * blocks * BLOCK * g
    scratch = torch.empty(size, dtype=torch.float32, device=device)
    need = views * (groups + 1)
    if device not in _ARRIVALS or _ARRIVALS[device].numel() < need:
        if device in _ARRIVALS:
            _RETIRED.append(_ARRIVALS[device])
        _ARRIVALS[device] = torch.zeros(max(need, 4096), dtype=torch.int32,
                                        device=device)
    return scratch, _ARRIVALS[device]


def _check_columns(g: int) -> None:
    if not 1 <= g <= MAX_COLUMNS:
        raise ValueError(f"columns {g} must lie in [1, {MAX_COLUMNS}]")


def _check_block_operand(vals: torch.Tensor, block: int) -> None:
    if vals.dtype != torch.float32 or vals.ndim != 2:
        raise ValueError(f"vals must be a float32 (M, G) tensor, got "
                         f"{vals.dtype} {tuple(vals.shape)}")
    if block != BLOCK:
        raise ValueError(f"block must be {BLOCK}, got {block}")
    if vals.shape[0] % block:
        raise ValueError(f"rows {vals.shape[0]} must be a multiple of {block}")
    _check_columns(vals.shape[1])


def _launch_error(what: str, err: int) -> None:
    if err:
        raise RuntimeError(f"K3 {what} launch failed: cudaError {err}")


def _cuda_operand(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"no K3 for device {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"K3 needs a contiguous {what}")


def block_cumsum(vals: torch.Tensor, block: int = BLOCK) -> torch.Tensor:
    """K3 scan: inclusive prefix sum along axis 0 of (M, G) float32, M a
    multiple of ``block`` (256).  Launches on a CUDA tensor, runs
    :func:`block_cumsum_plain` on a CPU tensor."""
    _check_block_operand(vals, block)
    if vals.device.type == "cpu":
        return block_cumsum_plain(vals, block)
    _cuda_operand(vals, "tensor")
    m, g = vals.shape
    out = torch.empty_like(vals)
    scratch, arrivals = _scratch(vals.device, 1, m, g, merge=False)
    with torch.cuda.device(vals.device):
        err = _lib().block_cumsum(
            vals.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            arrivals.data_ptr(), m, g, torch.cuda.current_stream().cuda_stream)
    _launch_error("block_cumsum", err)
    block_cumsum.launches += 1
    return out


block_cumsum.launches = 0


def _warp_scan(x: torch.Tensor) -> torch.Tensor:
    """Inclusive log-step scan along dim 1 of (N, 32, G) lanes, adding as
    the kernel's ``warp_inclusive_scan`` does (lane i adds lane i - off)."""
    for off in (1, 2, 4, 8, 16):
        x = torch.cat([x[:, :off], x[:, off:] + x[:, :-off]], dim=1)
    return x


def _prefix_plain(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of each view of (B, M, G), M a multiple of 256,
    adding in K3's order: a log-step scan in each 32-row warp, the earlier
    warps' totals summed in turn, then each block's carry: ``run + (incl -
    total)``, with ``incl`` a log-step scan of the block totals in groups of
    32 blocks and ``run`` the earlier groups' totals summed in turn.  Float
    adds are exact IEEE operations, so this equals K3 bit for bit."""
    views, m, g = x.shape
    nb, warps = m // BLOCK, BLOCK // 32
    lanes = _warp_scan(x.reshape(-1, 32, g)).reshape(views, nb, warps, 32, g)
    warp_tot = lanes[:, :, :, 31]
    before = [torch.zeros_like(warp_tot[:, :, 0])]
    for w in range(1, warps):
        before.append(before[-1] + warp_tot[:, :, w - 1])
    local = torch.stack(before, 2)[:, :, :, None] + lanes  # (B, nb, warps, 32, g)
    totals = local[:, :, -1, 31]                            # (B, nb, g)
    padded = torch.cat([totals, totals.new_zeros((views, (-nb) % GROUP, g))], 1)
    groups = padded.shape[1] // GROUP
    padded = padded.reshape(views, groups, GROUP, g)
    incl = _warp_scan(padded.reshape(-1, GROUP, g)).reshape(padded.shape)
    part = incl - padded
    run, runs = torch.zeros_like(totals[:, 0]), []
    for i in range(groups):
        runs.append(run)
        run = run + incl[:, i, GROUP - 1]
    carry = (torch.stack(runs, 1)[:, :, None] + part).reshape(views, -1, g)[:, :nb]
    return (local + carry[:, :, None, None]).reshape(views, m, g)


def block_cumsum_plain(vals: torch.Tensor, block: int = BLOCK) -> torch.Tensor:
    """Plain PyTorch K3 scan, adding in the kernel's order."""
    block_cumsum_plain.calls += 1
    _check_block_operand(vals, block)
    return _prefix_plain(vals[None])[0]


block_cumsum_plain.calls = 0


def _check_merge_operands(vals, order, keys, views, num_segments, tile_rows):
    if vals.dtype != torch.float32 or vals.ndim != 3:
        raise ValueError(f"vals must be a float32 (tiles, G, K) tensor, got "
                         f"{vals.dtype} {tuple(vals.shape)}")
    _check_columns(vals.shape[1])
    if tile_rows is not None and (tile_rows.dtype != torch.int64 or tile_rows.ndim != 1):
        raise ValueError(f"tile_rows must be an int64 vector, got {tile_rows.dtype} "
                         f"{tuple(tile_rows.shape)}")
    tiles = vals.shape[0] if tile_rows is None else tile_rows.shape[0]
    rows = tiles * vals.shape[2]
    for name, x, dtype in (("order", order, torch.int64), ("keys", keys, torch.int32)):
        if x.dtype != dtype or x.shape != (rows,):
            raise ValueError(f"{name} must be a {dtype} ({rows},) tensor, got "
                             f"{x.dtype} {tuple(x.shape)}")
    if views < 1 or rows % views:
        raise ValueError(f"{rows} rows do not split into {views} views")
    if views * (num_segments + 1) >= 2 ** 31:
        raise ValueError(f"{views} views of {num_segments} segments overflow int32 keys")


def merge_runs(vals: torch.Tensor, order: torch.Tensor, keys: torch.Tensor,
               views: int, num_segments: int,
               tile_rows: torch.Tensor | None = None) -> torch.Tensor:
    """K3 merge: GMU level 2 of ``views`` views of sorted rows -> (B, N, G).

    ``vals`` (tiles, G, K) float32: row ``t * K + k`` is fragment ``k`` of
    tile ``t``, held in ``vals[t]``, or in ``vals[tile_rows[t]]`` when
    ``tile_rows`` (int64) is given (a (M, G) tensor is ``vals[:, :, None]``).
    ``keys`` (B*M,) int32 and ``order`` (B*M,) int64 are the stable sort of
    the per-view keys (Gaussian id, ``N`` for padding) offset by ``view *
    (N + 1)``; each view's M sorted rows follow the previous view's.
    Launches on CUDA tensors, runs :func:`merge_runs_plain` on CPU
    tensors."""
    _check_merge_operands(vals, order, keys, views, num_segments, tile_rows)
    if vals.device.type == "cpu":
        return merge_runs_plain(vals, order, keys, views, num_segments, tile_rows)
    operands = ((vals, "vals"), (order, "order"), (keys, "keys"))
    if tile_rows is not None:
        operands += ((tile_rows, "tile_rows"),)
    for x, what in operands:
        _cuda_operand(x, what)
    tiles, g, frags = vals.shape
    rows = keys.shape[0] // views
    out = torch.zeros((views, num_segments, g), dtype=torch.float32,
                      device=vals.device)
    scratch, arrivals = _scratch(vals.device, views, rows, g, merge=True)
    with torch.cuda.device(vals.device):
        err = _lib().merge_runs(
            vals.data_ptr(), None if tile_rows is None else tile_rows.data_ptr(),
            order.data_ptr(), keys.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            arrivals.data_ptr(), tiles, views, rows, frags, g, num_segments,
            torch.cuda.current_stream().cuda_stream)
    _launch_error("merge_runs", err)
    merge_runs.launches += 1
    return out


merge_runs.launches = 0


def merge_runs_plain(vals: torch.Tensor, order: torch.Tensor, keys: torch.Tensor,
                     views: int, num_segments: int,
                     tile_rows: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch K3 merge: the plain scan of each view's sorted rows
    (padding as zeros), then ``+pref`` at valid run ends and ``-(pref -
    v)`` at valid run starts, as the kernel adds them."""
    merge_runs_plain.calls += 1
    _check_merge_operands(vals, order, keys, views, num_segments, tile_rows)
    if tile_rows is not None:
        vals = vals[tile_rows]
    g = vals.shape[1]
    n, rows = num_segments, keys.shape[0] // views
    flat = vals.transpose(1, 2).reshape(-1, g)[order]
    view = torch.arange(views, device=keys.device).repeat_interleave(rows)
    seg = keys.long() - view * (n + 1)
    valid = (seg >= 0) & (seg < n)
    x = torch.where(valid[:, None], flat, torch.zeros_like(flat)).reshape(views, rows, g)
    pad = x.new_zeros((views, (-rows) % BLOCK, g))
    pref = _prefix_plain(torch.cat([x, pad], 1))[:, :rows].reshape(-1, g)
    x = x.reshape(-1, g)
    differs = keys[1:] != keys[:-1]
    one = torch.ones((1,), dtype=torch.bool, device=keys.device)
    is_start = torch.cat([one, differs]) & valid
    is_end = torch.cat([differs, one]) & valid
    dest = view * n + seg
    out = torch.zeros((views * n, g), dtype=torch.float32, device=vals.device)
    out.index_add_(0, dest[is_end], pref[is_end])
    out.index_add_(0, dest[is_start], -(pref - x)[is_start])
    return out.reshape(views, n, g)


merge_runs_plain.calls = 0


def merge_views(vals: torch.Tensor, ids: torch.Tensor, num_segments: int,
                tile_rows: torch.Tensor | None = None) -> torch.Tensor:
    """GMU level 2 of B views in one sort and one K3 merge.

    ``vals`` and ``tile_rows`` as :func:`merge_runs` takes them (B*T tiles),
    ``ids`` (B, T*K) int32 Gaussian ids in ``[0, N)`` or negative for
    padding -> (B, N, G): equal bit for bit to B one-view merges."""
    views = ids.shape[0]
    keys = torch.where(ids >= 0, ids, num_segments)
    if views > 1:
        offs = torch.arange(views, dtype=torch.int32, device=ids.device)
        keys = keys + offs[:, None] * (num_segments + 1)
    keys_s, order = torch.sort(keys.reshape(-1), stable=True)
    return merge_runs(vals, order, keys_s, views, num_segments, tile_rows)


def segment_merge_scatter(vals: torch.Tensor, ids: torch.Tensor,
                          num_segments: int) -> torch.Tensor:
    """Flat scatter-add baseline: vals (M, G), ids (M,) with -1 padding."""
    ok = ids >= 0
    out = torch.zeros((num_segments + 1, vals.shape[1]), dtype=vals.dtype,
                      device=vals.device)
    dump = torch.full_like(ids, num_segments)
    out.index_add_(0, torch.where(ok, ids, dump).long(), vals)
    return out[:num_segments]


def segment_merge(vals: torch.Tensor, ids: torch.Tensor,
                  num_segments: int) -> torch.Tensor:
    """Sorted run-reduction merge (the reference's signature): vals (M, G)
    float32, ids (M,) int32 with -1 padding -> (N, G), through K3's
    merge."""
    return merge_views(vals.contiguous()[:, :, None], ids[None].to(torch.int32),
                       num_segments)[0]


def scatter_operand_counts(ids: torch.Tensor, num_segments: int) -> dict:
    """Instrumentation for the GMU ablation: how many scatter operands the
    flat baseline and the merged path would issue (the reference's
    ``gmu.scatter_operand_counts``).  It reads its three counts back to
    the host."""
    ok = ids >= 0
    flat = int(torch.sum(ok))
    sorted_ids = torch.sort(torch.where(ok, ids, num_segments)).values
    uniq = int(torch.sum((sorted_ids[1:] != sorted_ids[:-1]) & (sorted_ids[1:] < num_segments)))
    uniq += int(sorted_ids[0] < num_segments)
    return {"flat_scatter_operands": flat, "merged_scatter_operands": 2 * uniq,
            "unique_gaussians": uniq}
