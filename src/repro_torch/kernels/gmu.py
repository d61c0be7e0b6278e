"""Gradient Merging Unit, level 2 (counterpart of ``repro/kernels/gmu.py``),
and K3, its block prefix sum.

Level 1 (pixel -> tile) happens inside K2 and K5.  Level 2 (tile ->
Gaussian) is here: sort the (tile, fragment) rows by Gaussian id (stable),
take the inclusive prefix sum, and scatter ``+pref`` at run ends and
``-pref_excl`` at run starts.  The reference's ``mode="drop"`` scatter
becomes an ``index_add_`` into ``N + 1`` rows whose last row collects the
padding and is sliced off.  Each real row receives at most one end and one
start write, so the result does not depend on the order the adds land in.

The prefix sum is K3, :func:`block_cumsum`, the port of the Pallas
``block_cumsum`` (``pallas_call`` at ``gmu.py:83``): ``csrc/gmu.cu``, an
inclusive prefix sum over 256-row blocks whose carry across blocks is a
second pass (block totals, their scan, then each block's local scan plus
its carry), since Hopper blocks run in no order.  It is bound by bytes: it
reads the tensor twice and writes it once.  The reference's main path takes
its prefix sum from ``jnp.cumsum`` instead (``use_pallas=False``); here
K3 serves every call, as PyTorch's CUDA scan over the outer dimension of a
thin (M, 10) tensor is slow.  The level-2 sum is then held to a float64
segment sum, not bit for bit to the reference (whose scan sums in yet
another order).  ``block_cumsum.launches`` counts calls that launch K3
(each call is three kernel launches) and ``block_cumsum_plain.calls``
counts plain runs.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

BLOCK = 256
MAX_COLUMNS = 32  # K3's shared-memory staging bound

_P, _I = ctypes.c_void_p, ctypes.c_int


def _lib():
    lib = _build.load("gmu")
    fn = lib.block_cumsum
    fn.argtypes = [_P, _P, _P, _P, _I, _I, _P]
    fn.restype = _I
    return lib


def _check_block_operand(vals: torch.Tensor, block: int) -> None:
    if vals.dtype != torch.float32 or vals.ndim != 2:
        raise ValueError(f"vals must be a float32 (M, G) tensor, got "
                         f"{vals.dtype} {tuple(vals.shape)}")
    if block != BLOCK:
        raise ValueError(f"block must be {BLOCK}, got {block}")
    if vals.shape[0] % block:
        raise ValueError(f"rows {vals.shape[0]} must be a multiple of {block}")
    if not 1 <= vals.shape[1] <= MAX_COLUMNS:
        raise ValueError(f"columns {vals.shape[1]} must lie in [1, {MAX_COLUMNS}]")


def block_cumsum(vals: torch.Tensor, block: int = BLOCK) -> torch.Tensor:
    """K3: inclusive prefix sum along axis 0 of (M, G) float32, M a multiple
    of ``block`` (256).  Launches on a CUDA tensor, runs
    :func:`block_cumsum_plain` on a CPU tensor."""
    _check_block_operand(vals, block)
    if vals.device.type == "cpu":
        return block_cumsum_plain(vals, block)
    if vals.device.type != "cuda":
        raise ValueError(f"no K3 for device {vals.device}")
    if not vals.is_contiguous():
        raise ValueError("K3 needs a contiguous tensor")
    m, g = vals.shape
    out = torch.empty_like(vals)
    scratch = torch.empty((2, m // block, g), dtype=torch.float32,
                          device=vals.device)
    with torch.cuda.device(vals.device):
        err = _lib().block_cumsum(
            vals.data_ptr(), out.data_ptr(), scratch[0].data_ptr(),
            scratch[1].data_ptr(), m, g, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"K3 block_cumsum launch failed: cudaError {err}")
    block_cumsum.launches += 1
    return out


block_cumsum.launches = 0


def _warp_scan(x: torch.Tensor) -> torch.Tensor:
    """Inclusive log-step scan along dim 1 of (N, 32, G) lanes, adding as
    the kernel's ``warp_inclusive_scan`` does (lane i adds lane i - off)."""
    for off in (1, 2, 4, 8, 16):
        x = torch.cat([x[:, :off], x[:, off:] + x[:, :-off]], dim=1)
    return x


def block_cumsum_plain(vals: torch.Tensor, block: int = BLOCK) -> torch.Tensor:
    """Plain PyTorch K3, adding in the kernel's order: a log-step scan in
    each 32-row warp, the earlier warps' totals summed in turn, then each
    block's carry, an exclusive scan of the block totals taken 32 blocks at
    a time with a running sum.  Float adds are exact IEEE operations, so
    it equals K3 bit for bit."""
    block_cumsum_plain.calls += 1
    _check_block_operand(vals, block)
    m, g = vals.shape
    nb, warps = m // block, block // 32
    lanes = _warp_scan(vals.reshape(nb * warps, 32, g)).reshape(nb, warps, 32, g)
    warp_tot = lanes[:, :, 31]
    before = [torch.zeros_like(warp_tot[:, 0])]
    for w in range(1, warps):
        before.append(before[-1] + warp_tot[:, w - 1])
    local = torch.stack(before, 1)[:, :, None] + lanes      # (nb, warps, 32, g)
    totals = local[:, -1, 31]                                # (nb, g)
    padded = torch.cat([totals, totals.new_zeros(((-nb) % 32, g))])
    incl = _warp_scan(padded.reshape(-1, 32, g))
    excl = incl - padded.reshape(-1, 32, g)
    run, carries = torch.zeros_like(totals[0]), []
    for c in range(incl.shape[0]):
        carries.append(run + excl[c])
        run = run + incl[c, 31]
    carry = torch.cat(carries)[:nb]
    return (local + carry[:, None, None]).reshape(m, g)


block_cumsum_plain.calls = 0


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
    """Sorted run-reduction merge: vals (M, G), ids (M,) -> (N, G), with
    the prefix sum from K3."""
    m, g = vals.shape
    ok = ids >= 0
    keys = torch.where(ok, ids, torch.full_like(ids, num_segments))
    order = torch.argsort(keys, stable=True)
    ids_s = keys[order]
    valid = ids_s < num_segments
    vals_s = torch.where(valid[:, None], vals[order], torch.zeros_like(vals))
    pad = torch.zeros(((-m) % BLOCK, g), dtype=vals.dtype, device=vals.device)
    pref = block_cumsum(torch.cat([vals_s, pad]))[:m]
    pref_excl = pref - vals_s

    differs = ids_s[1:] != ids_s[:-1]
    one = torch.ones((1,), dtype=torch.bool, device=vals.device)
    is_start = torch.cat([one, differs]) & valid
    is_end = torch.cat([differs, one]) & valid

    dump = torch.full_like(ids_s, num_segments)
    zero = torch.zeros_like(pref)
    out = torch.zeros((num_segments + 1, vals.shape[1]), dtype=vals.dtype,
                      device=vals.device)
    out.index_add_(0, torch.where(is_end, ids_s, dump).long(),
                   torch.where(is_end[:, None], pref, zero))
    out.index_add_(0, torch.where(is_start, ids_s, dump).long(),
                   torch.where(is_start[:, None], -pref_excl, zero))
    return out[:num_segments]
