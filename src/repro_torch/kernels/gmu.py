"""Gradient Merging Unit, level 2 (counterpart of ``repro/kernels/gmu.py``).

Level 1 (pixel -> tile) happens inside K2.  Level 2 (tile -> Gaussian) is
here, in torch ops, as the reference runs it on its main path
(``segment_merge(..., use_pallas=False)``): sort the (tile, fragment) rows
by Gaussian id (stable), take the inclusive prefix sum, and scatter
``+pref`` at run ends and ``-pref_excl`` at run starts.  The reference's
``mode="drop"`` scatter becomes an ``index_add_`` into ``N + 1`` rows whose
last row collects the padding and is sliced off.  Each real row receives
at most one end and one start write, so the result does not depend on the
order the adds land in.  The Pallas block prefix sum (K3) is not on this
path; its CUDA port is a later slice.
"""

from __future__ import annotations

import torch


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
    """Sorted run-reduction merge: vals (M, G), ids (M,) -> (N, G)."""
    ok = ids >= 0
    keys = torch.where(ok, ids, torch.full_like(ids, num_segments))
    order = torch.argsort(keys, stable=True)
    ids_s = keys[order]
    valid = ids_s < num_segments
    vals_s = torch.where(valid[:, None], vals[order], torch.zeros_like(vals))
    # Scan along the innermost dimension: PyTorch's CUDA scan over the outer
    # dimension of an (M, 10) tensor runs ~50 ms at M = 307200 (the slice's
    # 1200 tiles x K=256), the innermost one a fraction of a millisecond.
    pref = torch.cumsum(vals_s.t().contiguous(), dim=1).t()
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
