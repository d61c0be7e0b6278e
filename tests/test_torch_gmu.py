"""GMU level 2 through K3's merge on the CPU: the plain merge against the
plain scan's boundary sums (bit for bit) and against the reference's
``segment_merge``, and the one-merge-per-backward ``_merge_views`` of both
raster backends against one-view merges (bit for bit).  K3's scan order and
the merge's reference cases on ragged, all-padding, length-1 and long runs
are in ``test_torch_schedule.py``; the kernels themselves are held to these
plain versions on the card by ``test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

from _kernel_inputs import merge_case_ids
from _torch_parity import jx, np_, th
from _torch_parity import one_cpu_thread  # noqa: F401  (autouse fixture)
from repro.kernels import gmu as jgmu
from repro_torch.core.schedule import build_schedule
from repro_torch.kernels import gmu as tgmu
from repro_torch.kernels import ops as tops


def _boundary_sums(vals, ids, n):
    """GMU level 2 written out over the plain K3 scan: ``pref[e]`` at each
    valid run end plus ``-(pref[s] - v[s])`` at each valid run start of the
    stably sorted rows, one add each into zeros."""
    m, g = vals.shape
    keys = torch.where(ids >= 0, ids, n)
    order = torch.argsort(keys, stable=True)
    ids_s = keys[order]
    valid = ids_s < n
    v = torch.where(valid[:, None], vals[order], torch.zeros_like(vals))
    pref = tgmu.block_cumsum_plain(torch.cat([v, v.new_zeros(((-m) % 256, g))]))[:m]
    out = torch.zeros((n, g))
    for r in range(m):
        if not valid[r]:
            continue
        i = int(ids_s[r])
        if r == m - 1 or ids_s[r + 1] != ids_s[r]:
            out[i] = out[i] + pref[r]
        if r == 0 or ids_s[r - 1] != ids_s[r]:
            out[i] = out[i] + -(pref[r] - v[r])
    return out


@pytest.mark.parametrize("m,n,kind", [
    (1000, 50, "random"), (33 * 256 + 7, 90, "long"), (600, 500, "singles"),
    (300, 10, "padding"),
])
def test_plain_merge_equals_plain_scan_boundary_sums(m, n, kind):
    r = np.random.default_rng(m)
    vals = th(r.normal(size=(m, 10)).astype(np.float32))
    ids = th(merge_case_ids(kind, m, n, m))
    got = tgmu.segment_merge(vals, ids, n)
    assert torch.equal(got, _boundary_sums(vals, ids, n))


def _tile_case(views, tiles, cap, n, seed):
    """(B*T, 10, K) tile gradients and (B, T, K) ids, padding at each
    tile's end as in a fragment list."""
    r = np.random.default_rng(seed)
    grads = r.normal(size=(views * tiles, 10, cap)).astype(np.float32)
    count = r.integers(0, cap + 1, (views, tiles))
    ids = r.integers(0, n, (views, tiles, cap)).astype(np.int32)
    ids[np.arange(cap) >= count[..., None]] = -1
    return th(grads), th(ids), th(count.astype(np.int32))


@pytest.mark.parametrize("views", [None, 1, 3])
def test_merge_views_equals_one_view_merges_on_both_backends(views):
    """``_merge_views`` sorts and merges all views at once; on the
    ``kernel`` backend (tile-order gradients) and on the ``schedule`` backend
    (slot-order gradients gathered back by ``inv``) it equals one
    ``segment_merge`` per view bit for bit, and the reference within its
    GMU bound."""
    tiles, cap, n = 12, 48, 70
    nv = views or 1
    grads, ids, count = _tile_case(nv, tiles, cap, n, nv)
    want = [tgmu.segment_merge(grads[b * tiles:(b + 1) * tiles].transpose(1, 2)
                               .reshape(-1, 10), ids[b].reshape(-1), n)
            for b in range(nv)]
    idx = ids if views is not None else ids[0]

    before = tgmu.merge_runs_plain.calls
    by_tiles = tops._merge_views(grads, idx, views, n)
    scheds = [build_schedule(count[b], 16, max_trips=cap // 16) for b in range(nv)]
    slots = scheds[0].perm.shape[0]
    slot_rows = torch.cat([s.perm.long() + b * tiles for b, s in enumerate(scheds)])
    inv = torch.stack([s.inv for s in scheds]) if views is not None else scheds[0].inv
    rows = tops._view_rows(inv, views, slots)
    by_slots = tops._merge_views(grads[slot_rows], idx, views, n, rows)
    assert tgmu.merge_runs_plain.calls == before + 2   # one merge per backward

    for got in (by_tiles, by_slots):
        merged = torch.cat(got[:3] + (got[3][..., None], got[4][..., None]), -1)
        merged = merged if views is not None else merged[None]
        for b in range(nv):
            assert torch.equal(merged[b], want[b]), b
            ref = jgmu.segment_merge(
                jx(np_(grads[b * tiles:(b + 1) * tiles].transpose(1, 2).reshape(-1, 10))),
                jx(np_(ids[b].reshape(-1))), n)
            np.testing.assert_allclose(np_(merged[b]), np.asarray(ref), atol=1e-4)


@pytest.mark.parametrize("seed,n,segments", [(0, 1, 8), (1, 300, 64), (2, 2048, 2048),
                                             (3, 700, 5)])
def test_scatter_operand_counts_match_the_reference(seed, n, segments):
    """``fig17_breakdown``'s GMU operand counts on seeded ids with padding
    (-1), repeats and, in the first case, a single entry."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(-1, segments, size=n).astype(np.int32)
    if seed == 3:
        ids[:] = -1
    want = jgmu.scatter_operand_counts(jx(ids), segments)
    assert tgmu.scatter_operand_counts(th(ids), segments) == want
