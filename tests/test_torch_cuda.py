"""The port on a card: the CUDA kernels K1-K5 (K3's scan and merge)
against their plain versions, the scheduled kernels K4/K5 against K1/K2 bit for bit, the
``kernel`` backend against the ``ref`` backend, the ``schedule`` session
against the ``kernel`` one, and the default entry points.  Every test here is marked ``cuda`` and skips where
``torch.cuda.is_available()`` is false.

The file imports neither JAX nor ``repro``, so it runs on a machine that
has only PyTorch; there, skip the JAX fixtures of ``tests/conftest.py``::

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from _kernel_inputs import merge_case_ids, random_attrs
from repro_torch.core import gaussians as G
from repro_torch.core import lie
from repro_torch.core.camera import Camera, Intrinsics, look_at
from repro_torch.core.raster_api import RasterPlan
from repro_torch.core.render import render
from repro_torch.core.schedule import build_schedule
from repro_torch.core.sorting import make_tile_grid
from repro_torch.kernels import gmu
from repro_torch.kernels.tile_render import (
    raise_on_sched_fault, tile_render_fwd, tile_render_fwd_plain,
    tile_render_fwd_sched, tile_render_fwd_sched_plain,
)
from repro_torch.kernels.tile_render_bp import (
    tile_render_bwd, tile_render_bwd_plain, tile_render_bwd_sched,
    tile_render_bwd_sched_plain,
)

pytestmark = pytest.mark.cuda

FWD_ATOL, FWD_RTOL, DEPTH_TOL = 2e-5, 1e-4, 1e-4


@pytest.fixture
def dev():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _grad_atol(ref: torch.Tensor) -> float:
    return max(3e-6, 3e-5 * float(ref.abs().max()))


def _attrs(seed, rows, cap, height, width, near_tile=False):
    a, c = random_attrs(seed, rows, cap, height, width, sparse=True,
                        near_tile=near_tile)
    return torch.as_tensor(a), torch.as_tensor(c)


def _close(got, want, atol, rtol=0.0):
    torch.testing.assert_close(got, want, atol=atol, rtol=rtol)


@pytest.mark.parametrize("hw,cap,chunk,views,near_tile", [
    ((32, 32), 32, 16, 1, False),
    ((48, 64), 64, 16, 3, False),
    ((64, 64), 128, 32, 1, False),
    ((480, 640), 256, 16, 1, False),
    ((480, 640), 256, 16, 2, True),   # saturated tiles: chunk skips
])
def test_cuda_kernels_match_plain(dev, hw, cap, chunk, views, near_tile):
    grid = make_tile_grid(*hw)
    tiles = grid.num_tiles
    attrs, count = _attrs(7, views * tiles, cap, *hw, near_tile=near_tile)
    a, c = attrs.to(dev), count.to(dev)
    kw = dict(chunk=chunk, tiles_per_view=tiles)
    got = tile_render_fwd(a, c, grid, **kw)
    want = tile_render_fwd_plain(a, c, grid, **kw)
    torch.cuda.synchronize()
    for name, g, w in zip(("color", "depth", "final_T", "stash"), got, want):
        tol = DEPTH_TOL if name == "depth" else FWD_ATOL
        rtol = DEPTH_TOL if name == "depth" else FWD_RTOL
        _close(g, w, tol, rtol)
    r = np.random.default_rng(8)
    cots = [torch.as_tensor(r.normal(size=s).astype(np.float32), device=dev)
            for s in ((views * tiles, 3, 256), (views * tiles, 256),
                      (views * tiles, 256))]
    gg = tile_render_bwd(a, c, *got, *cots, grid, **kw)
    gw = tile_render_bwd_plain(a, c, *got, *cots, grid, **kw)
    torch.cuda.synchronize()
    _close(gg, gw, _grad_atol(gw))


def test_cuda_wrappers_reject_non_contiguous_operands(dev):
    grid = make_tile_grid(32, 32)
    attrs, count = _attrs(3, grid.num_tiles, 32, 32, 32)
    a = attrs.to(dev).transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        tile_render_fwd(a, count.to(dev), grid)


def _stacked_schedule(count, tiles, views, cap, chunk):
    """Flattened per-view schedules (perm offset to global rows) and the
    per-view tile -> global slot gather."""
    perms, trips, invs = [], [], []
    for b in range(views):
        s = build_schedule(count[b * tiles:(b + 1) * tiles], chunk,
                           max_trips=cap // chunk)
        slots = s.perm.shape[0]
        perms.append(s.perm + b * tiles)
        trips.append(s.trips)
        invs.append(s.inv.long() + b * slots)
    return torch.cat(perms), torch.cat(trips), torch.cat(invs)


@pytest.mark.parametrize("hw,cap,chunk,views,near_tile", [
    ((48, 48), 32, 8, 1, False),      # 9 tiles: slot 1 is the zero-work pad
    ((48, 48), 64, 16, 2, True),      # two odd views, saturated tiles
    ((64, 64), 128, 32, 1, False),
    ((480, 640), 256, 16, 2, True),   # the slice's shapes
])
def test_cuda_sched_kernels_match_plain_and_unscheduled(dev, hw, cap, chunk,
                                                        views, near_tile):
    """K4 and K5 against their plain versions, and gathered by ``inv``
    against K1 and K2 bit for bit."""
    grid = make_tile_grid(*hw)
    tiles = grid.num_tiles
    attrs, count = _attrs(9, views * tiles, cap, *hw, near_tile=near_tile)
    a, c = attrs.to(dev), count.to(dev)
    perm, trips, inv = _stacked_schedule(c, tiles, views, cap, chunk)
    kw = dict(chunk=chunk, tiles_per_view=tiles)
    got = tile_render_fwd_sched(a, perm, trips, grid, **kw)
    want = tile_render_fwd_sched_plain(a, perm, trips, grid, **kw)
    base = tile_render_fwd(a, c, grid, **kw)
    torch.cuda.synchronize()
    for name, g, w, u in zip(("color", "depth", "final_T", "stash"), got, want, base):
        tol = DEPTH_TOL if name == "depth" else FWD_ATOL
        rtol = DEPTH_TOL if name == "depth" else FWD_RTOL
        _close(g, w, tol, rtol)
        assert torch.equal(g[inv], u), name
    r = np.random.default_rng(10)
    cots = [torch.as_tensor(r.normal(size=s).astype(np.float32), device=dev)
            for s in ((views * tiles, 3, 256), (views * tiles, 256),
                      (views * tiles, 256))]
    base_g = tile_render_bwd(a, c, *base, *cots, grid, **kw)
    slot_cots = [x[perm.long()].contiguous() for x in cots]
    gg = tile_render_bwd_sched(a, perm, trips, *got, *slot_cots, grid, **kw)
    gw = tile_render_bwd_sched_plain(a, perm, trips, *got, *slot_cots, grid, **kw)
    torch.cuda.synchronize()
    _close(gg, gw, _grad_atol(gw))
    assert torch.equal(gg[inv], base_g)
    raise_on_sched_fault(dev)


def _empty_tiles(attrs, count, tiles, share, seed):
    """Empty more than ``share`` of each view's tiles (all of them at 1), as
    a stability-masked build leaves the tiles only stable Gaussians cover:
    count 0 and attrs zero (what the packer writes for absent fragments).
    With more than half of a view's tiles empty, the heavy-light fold pairs
    empty tiles with each other."""
    r = np.random.default_rng(seed)
    views = count.shape[0] // tiles
    n_empty = min(tiles, int(share * tiles) + 1)
    empty = np.zeros(count.shape[0], bool)
    for b in range(views):
        empty[b * tiles + r.permutation(tiles)[:n_empty]] = True
    empty = torch.as_tensor(empty)
    attrs, count = attrs.clone(), count.clone()
    attrs[empty] = 0.0
    count[empty] = 0
    return attrs, count, empty


@pytest.mark.parametrize("hw,cap,chunk,views,share", [
    ((480, 640), 512, 16, 1, 0.0),    # the sparse run's fragment capacity
    ((480, 640), 512, 16, 2, 0.6),    # most tiles empty, K=512
    ((480, 640), 256, 16, 2, 0.5),
    ((48, 48), 32, 8, 2, 1.0),        # views with no fragment at all (odd T)
])
def test_cuda_kernels_on_empty_tiles_match_plain(dev, hw, cap, chunk, views, share):
    """K1, K2, K4 and K5 against their plain versions where at least
    ``share`` of the tiles hold no fragment, with cotangents on every
    pixel (a stable background puts one on final T everywhere): empty
    tiles render color 0, depth 0 and final T 1 and get zero gradients;
    the schedule pairs empty tiles into zero-trip blocks, and K4/K5
    gathered by ``inv`` equal K1/K2 bit for bit."""
    grid = make_tile_grid(*hw)
    tiles = grid.num_tiles
    attrs, count = _attrs(21, views * tiles, cap, *hw, near_tile=True)
    attrs, count, empty = _empty_tiles(attrs, count, tiles, share, 22)
    assert float(empty.double().mean()) >= share
    a, c, e = attrs.to(dev), count.to(dev), empty.to(dev)
    kw = dict(chunk=chunk, tiles_per_view=tiles)
    got = tile_render_fwd(a, c, grid, **kw)
    want = tile_render_fwd_plain(a, c, grid, **kw)
    perm, trips, inv = _stacked_schedule(c, tiles, views, cap, chunk)
    pair_trips = trips.view(-1, 2)
    if share > 0:
        assert bool((pair_trips == 0).all(1).any())    # two empty tiles paired
    got4 = tile_render_fwd_sched(a, perm, trips, grid, **kw)
    want4 = tile_render_fwd_sched_plain(a, perm, trips, grid, **kw)
    torch.cuda.synchronize()
    for name, g, w, g4, w4 in zip(("color", "depth", "final_T", "stash"), got, want,
                                  got4, want4):
        tol = DEPTH_TOL if name == "depth" else FWD_ATOL
        rtol = DEPTH_TOL if name == "depth" else FWD_RTOL
        _close(g, w, tol, rtol)
        _close(g4, w4, tol, rtol)
        assert torch.equal(g4[inv], g), name
        fill = 1.0 if name == "final_T" else 0.0
        assert bool((g[e] == fill).all()), name
    r = np.random.default_rng(23)
    cots = [torch.as_tensor(r.normal(size=s).astype(np.float32), device=dev)
            for s in ((views * tiles, 3, 256), (views * tiles, 256),
                      (views * tiles, 256))]
    gg = tile_render_bwd(a, c, *got, *cots, grid, **kw)
    gw = tile_render_bwd_plain(a, c, *got, *cots, grid, **kw)
    slot_cots = [x[perm.long()].contiguous() for x in cots]
    g5 = tile_render_bwd_sched(a, perm, trips, *got4, *slot_cots, grid, **kw)
    g5_plain = tile_render_bwd_sched_plain(a, perm, trips, *got4, *slot_cots, grid, **kw)
    torch.cuda.synchronize()
    _close(gg, gw, _grad_atol(gw))
    _close(g5, g5_plain, _grad_atol(g5_plain))
    assert torch.equal(g5[inv], gg)
    assert not bool(gg[e].any())
    raise_on_sched_fault(dev)


def test_cuda_merge_views_with_an_empty_view(dev):
    """GMU level 2 when one view has no fragment (every id padding) and the
    other some: the empty view's gradients are exactly zero, and the merge
    equals its plain version and one-view merges bit for bit."""
    tiles, cap, n = 1200, 256, 131072
    r = np.random.default_rng(31)
    grads = torch.as_tensor(r.normal(size=(2 * tiles, 10, cap)).astype(np.float32),
                            device=dev)
    ids = r.integers(0, n, (2, tiles * cap)).astype(np.int32)
    ids[r.uniform(size=ids.shape) < 0.9] = -1
    ids[1] = -1
    ids = torch.as_tensor(ids, device=dev)
    got = gmu.merge_views(grads, ids, n)
    alone = gmu.merge_views(grads[tiles:], ids[1:], n)
    keys = torch.where(ids >= 0, ids, n) + torch.tensor([[0], [n + 1]], device=dev,
                                                        dtype=torch.int32)
    keys_s, order = torch.sort(keys.reshape(-1), stable=True)
    want = gmu.merge_runs_plain(grads, order, keys_s, 2, n)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert not bool(got[1].any()) and not bool(alone.any())
    assert torch.equal(got[0], gmu.merge_views(grads[:tiles], ids[:1], n)[0])


@pytest.mark.parametrize("chunk", [8, 16, 32])
def test_cuda_backward_skips_fragments_no_warp_draws(dev, chunk):
    """Narrow splats cover only part of each tile, so whole warps draw none
    of many fragments (and of whole groups of them) and skip them: K2 and K5
    against their plain versions, and K5 gathered by ``inv`` against K2 bit
    for bit."""
    hw, cap, views = (64, 96), 64, 2
    grid = make_tile_grid(*hw)
    tiles = grid.num_tiles
    attrs, count = _attrs(12, views * tiles, cap, *hw, near_tile=True)
    attrs[:, 2:5] *= 25.0            # conics: splats ~5x narrower
    a, c = attrs.to(dev), count.to(dev)
    kw = dict(chunk=chunk, tiles_per_view=tiles)
    fwd = tile_render_fwd(a, c, grid, **kw)
    warp_idle = (fwd[3].view(views * tiles, cap, 8, 32) == 0).all(-1)
    drawn = fwd[3].abs().amax(-1) > 0                        # (rows, cap)
    idle_share = float(warp_idle[drawn].double().mean())
    assert 0.2 < idle_share < 0.95, idle_share
    r = np.random.default_rng(13)
    cots = [torch.as_tensor(r.normal(size=s).astype(np.float32), device=dev)
            for s in ((views * tiles, 3, 256), (views * tiles, 256),
                      (views * tiles, 256))]
    gg = tile_render_bwd(a, c, *fwd, *cots, grid, **kw)
    gw = tile_render_bwd_plain(a, c, *fwd, *cots, grid, **kw)
    perm, trips, inv = _stacked_schedule(c, tiles, views, cap, chunk)
    fwd_s = tile_render_fwd_sched(a, perm, trips, grid, **kw)
    slot_cots = [x[perm.long()].contiguous() for x in cots]
    g5 = tile_render_bwd_sched(a, perm, trips, *fwd_s, *slot_cots, grid, **kw)
    g5_plain = tile_render_bwd_sched_plain(a, perm, trips, *fwd_s, *slot_cots, grid, **kw)
    torch.cuda.synchronize()
    _close(gg, gw, _grad_atol(gw))
    _close(g5, g5_plain, _grad_atol(g5_plain))
    assert torch.equal(g5[inv], gg)
    raise_on_sched_fault(dev)


@pytest.mark.parametrize("bad", ["strided", "int64", "perm_range", "trips_range"])
def test_cuda_sched_wrappers_reject_bad_schedules(dev, bad):
    """Layout and type are checked before the launch; the values of perm
    and trips by the kernels, which set the fault word instead of reading
    out of bounds."""
    grid = make_tile_grid(48, 48)
    attrs, count = _attrs(4, grid.num_tiles, 32, 48, 48)
    a = attrs.to(dev)
    s = build_schedule(count.to(dev), 8, max_trips=4)
    perm, trips = s.perm.clone(), s.trips.clone()
    if bad == "strided":
        perm = torch.stack([perm, perm], 1)[:, 0]
    elif bad == "int64":
        trips = trips.long()
    elif bad == "perm_range":
        perm[4] = grid.num_tiles
    else:
        trips[2] = 5
    if bad in ("strided", "int64"):
        with pytest.raises((TypeError, ValueError)):
            tile_render_fwd_sched(a, perm, trips, grid, chunk=8)
        return
    raise_on_sched_fault(dev)
    out = tile_render_fwd_sched(a, perm, trips, grid, chunk=8)
    z = torch.zeros((perm.shape[0], 3, 256), device=dev)
    tile_render_bwd_sched(a, perm, trips, *out, z, z[:, 0].contiguous(),
                          z[:, 0].contiguous(), grid, chunk=8)
    torch.cuda.synchronize()
    with pytest.raises(RuntimeError, match="perm" if bad == "perm_range" else "trips"):
        raise_on_sched_fault(dev)
    raise_on_sched_fault(dev)  # the fault word was cleared


K3_SHAPES = [(256, 1), (4096, 10), (307200, 10), (1024, 32)]


@pytest.mark.parametrize("m,g", K3_SHAPES)
def test_cuda_block_cumsum_matches_plain(dev, m, g):
    """K3's scan equals its plain version bit for bit (the plain version
    adds in K3's order) and gives the same bits on a second launch, and
    both lie within 1e-5 of the float64 prefix of |x| plus 1e-6 from a
    float64 prefix sum."""
    x = torch.as_tensor(np.random.default_rng(m).normal(size=(m, g)).astype(np.float32),
                        device=dev)
    got = gmu.block_cumsum(x)
    again = gmu.block_cumsum(x)
    want = gmu.block_cumsum_plain(x)
    torch.cuda.synchronize()
    exact = torch.cumsum(x.double(), 0)
    scale = torch.cumsum(x.double().abs(), 0)
    assert bool(((got.double() - exact).abs() <= 1e-5 * scale + 1e-6).all())
    assert torch.equal(got, want)
    assert torch.equal(got, again)


@pytest.mark.parametrize("kind", ["random", "one", "padding", "singles", "long"])
@pytest.mark.parametrize("m,g", K3_SHAPES + [(1000, 10), (307200 - 77, 10)])
def test_cuda_merge_runs_matches_plain(dev, m, g, kind):
    """K3's merge equals its plain version bit for bit, also on one id in
    every row, all padding and M not a multiple of the block, and gives the
    same bits on a second launch."""
    n = max(8, m // 20)
    r = np.random.default_rng(m + g)
    vals = torch.as_tensor(r.normal(size=(m, g)).astype(np.float32), device=dev)
    ids = torch.as_tensor(merge_case_ids(kind, m, n, m + 1), device=dev)
    before = gmu.merge_runs.launches
    got = gmu.segment_merge(vals, ids, n)
    again = gmu.segment_merge(vals, ids, n)
    assert gmu.merge_runs.launches == before + 2
    keys = torch.where(ids >= 0, ids, n)
    keys_s, order = torch.sort(keys, stable=True)
    want = gmu.merge_runs_plain(vals[:, :, None], order, keys_s, 1, n)[0]
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got, again)
    if kind == "padding":
        assert not bool(got.any())


@pytest.mark.parametrize("views", [1, 4])
def test_cuda_merge_views_equals_one_view_merges(dev, views):
    """All views in one K3 merge, from the gradients' (B*T, 10, K) layout,
    equal one-view merges and the plain version bit for bit, also when K3
    reads the tiles through a map from tile to row (the WSU backend's
    slot order)."""
    tiles, cap, n = 1200, 256, 131072
    r = np.random.default_rng(views)
    grads = torch.as_tensor(r.normal(size=(views * tiles, 10, cap)).astype(np.float32),
                            device=dev)
    ids = r.integers(0, n, (views, tiles * cap)).astype(np.int32)
    ids[r.uniform(size=ids.shape) < 0.5] = -1
    ids = torch.as_tensor(ids, device=dev)
    got = gmu.merge_views(grads, ids, n)
    for b in range(views):
        one = gmu.merge_views(grads[b * tiles:(b + 1) * tiles], ids[b:b + 1], n)[0]
        assert torch.equal(got[b], one), b
    keys = torch.where(ids >= 0, ids, n) + (torch.arange(views, device=dev,
                                                          dtype=torch.int32)[:, None]
                                            * (n + 1))
    keys_s, order = torch.sort(keys.reshape(-1), stable=True)
    want = gmu.merge_runs_plain(grads, order, keys_s, views, n)
    slot_of = torch.as_tensor(r.permutation(views * tiles), device=dev)
    slots = torch.empty_like(grads)
    slots[slot_of] = grads
    via_slots = gmu.merge_views(slots, ids, n, slot_of)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(via_slots, got)


def test_cuda_segment_merge_matches_float64_segment_sum(dev):
    """GMU level 2 through K3's merge: each run sum is a difference of two
    prefix sums, so it is held to twice the prefix bound."""
    r = np.random.default_rng(4)
    m, n = 40000, 3000
    ids = torch.as_tensor(r.integers(-1, n, m).astype(np.int32), device=dev)
    vals = torch.as_tensor(r.normal(size=(m, 10)).astype(np.float32), device=dev)
    before = gmu.merge_runs.launches
    got = gmu.segment_merge(vals, ids, n)
    assert gmu.merge_runs.launches == before + 1
    ok = ids >= 0
    exact = torch.zeros((n, 10), dtype=torch.float64, device=dev)
    exact.index_add_(0, ids[ok].long(), vals[ok].double())
    tol = 2 * (1e-5 * float(vals[ok].double().abs().sum(0).max()) + 1e-6)
    assert float((got.double() - exact).abs().max()) <= tol


def _scene(dev):
    r = np.random.default_rng(0)
    pts = r.uniform(-1, 1, (200, 3)) * np.array([1.5, 1.0, 0.5]) + np.array([0, 0, 3.0])
    g = G.from_points(torch.as_tensor(pts, dtype=torch.float32, device=dev),
                      torch.as_tensor(r.uniform(0, 1, (200, 3)), dtype=torch.float32,
                                      device=dev),
                      capacity=256, scale=0.08, opacity=0.8)
    w2c = look_at(torch.zeros(3, device=dev), torch.tensor([0.0, 0.0, 3.0], device=dev),
                  torch.tensor([0.0, -1.0, 0.0], device=dev))
    return g, Camera(Intrinsics(80.0, 80.0, 32.0, 32.0, 64, 64), w2c)


def test_cuda_kernel_backend_matches_ref_backend(dev):
    """Images and the gradients of every Gaussian parameter: K1 + K2 + GMU
    against autograd through the plain tensor oracle, both on the card."""
    g, cam = _scene(dev)
    target = torch.rand((64, 64, 3), generator=torch.Generator().manual_seed(1)).to(dev)
    res = {}
    for backend in ("kernel", "ref"):
        params = {k: v.clone().requires_grad_(True) for k, v in G.params_of(g).items()}
        out = render(G.with_params(g, params), cam,
                     RasterPlan(grid=make_tile_grid(64, 64), backend=backend,
                                capacity=64))
        loss = ((out.image - target) ** 2).mean() + 0.1 * out.depth.mean()
        res[backend] = (out, torch.autograd.grad(loss, list(params.values())))
    _close(res["kernel"][0].image, res["ref"][0].image, FWD_ATOL, FWD_RTOL)
    _close(res["kernel"][0].depth, res["ref"][0].depth, DEPTH_TOL, DEPTH_TOL)
    for gk, gr in zip(res["kernel"][1], res["ref"][1]):
        _close(gk, gr, _grad_atol(gr))


def test_cuda_session_runs_through_the_kernels(dev):
    """The default entry points run on the card, and the SLAM session goes
    through K1, K2 and K3's merge, never through a plain version."""
    from repro_torch.core.keyframes import KeyframePolicy
    from repro_torch.slam.datasets import make_dataset
    from repro_torch.slam.session import SLAMConfig, run_sequence

    ds = make_dataset("room0", num_frames=5, height=64, width=64,
                      num_gaussians=400, frag_capacity=48)
    assert ds.frames[0].rgb.device.type == "cuda"
    def counts():
        return (tile_render_fwd.launches, tile_render_bwd.launches,
                gmu.merge_runs.launches, tile_render_fwd_plain.calls,
                tile_render_bwd_plain.calls, gmu.merge_runs_plain.calls,
                gmu.block_cumsum_plain.calls)

    before = counts()
    res = run_sequence(ds, SLAMConfig(iters_track=3, iters_map=4, capacity=1024,
                                      frag_capacity=48, map_window=2,
                                      keyframe=KeyframePolicy(interval=2)))
    after = counts()
    assert all(a > b for a, b in zip(after[:3], before[:3]))
    assert after[2] - before[2] == after[1] - before[1]  # one merge per backward
    assert after[3:] == before[3:]
    assert np.isfinite(res.ate) and len(res.keyframe_psnr) == 3
    assert all(np.isfinite(p) for p in res.keyframe_psnr)


def test_cuda_schedule_session_equals_kernel_session(dev):
    """A tiny session on the ``schedule`` backend runs through K4 and K5 and
    equals the same session on the ``kernel`` backend bit for bit."""
    from repro_torch.core.keyframes import KeyframePolicy
    from repro_torch.slam.datasets import make_dataset
    from repro_torch.slam.session import SLAMConfig, run_sequence

    ds = make_dataset("room0", num_frames=5, height=48, width=48,
                      num_gaussians=300, frag_capacity=32)
    rng = np.random.default_rng(2)
    perms = {i: torch.as_tensor(rng.permutation(2 * 384)) for i in range(1, 5)}
    res = {}
    for backend in ("kernel", "schedule"):
        k4, k5 = tile_render_fwd_sched.launches, tile_render_bwd_sched.launches
        res[backend] = run_sequence(ds, SLAMConfig(
            iters_track=3, iters_map=4, capacity=768, frag_capacity=32,
            map_window=2, backend=backend, keyframe=KeyframePolicy(interval=2)),
            perms=perms)
        ran = (tile_render_fwd_sched.launches > k4, tile_render_bwd_sched.launches > k5)
        assert ran == ((True, True) if backend == "schedule" else (False, False))
    for a, b in zip(res["kernel"].est_w2c, res["schedule"].est_w2c):
        assert np.array_equal(a, b)
    assert res["kernel"].keyframe_psnr == res["schedule"].keyframe_psnr


@pytest.mark.parametrize("views", [1, 4])
def test_cuda_norb_backend_equals_kernel_backend(dev, views):
    """``kernel_norb`` re-runs K1 in its backward instead of keeping the
    stash: images and every parameter gradient equal ``kernel``'s bit for
    bit, with one more K1 launch per backward."""
    g, cam = _scene(dev)
    if views > 1:
        xis = torch.as_tensor(np.random.default_rng(4).normal(size=(views, 6)) * 0.05,
                              dtype=torch.float32, device=dev)
        cam = Camera(cam.intrinsics, lie.se3_exp(xis) @ cam.w2c)
    target = torch.rand((64, 64, 3), generator=torch.Generator().manual_seed(1)).to(dev)
    res = {}
    for backend in ("kernel", "kernel_norb"):
        k1 = tile_render_fwd.launches
        params = {k: v.clone().requires_grad_(True) for k, v in G.params_of(g).items()}
        out = render(G.with_params(g, params), cam,
                     RasterPlan(grid=make_tile_grid(64, 64), backend=backend, capacity=64))
        loss = ((out.image - target) ** 2).mean() + 0.1 * out.depth.mean()
        grads = torch.autograd.grad(loss, list(params.values()))
        res[backend] = (out.image, out.depth, out.alpha, *grads,
                        tile_render_fwd.launches - k1)
    *k, k1_kernel = res["kernel"]
    *n, k1_norb = res["kernel_norb"]
    assert all(torch.equal(a, b) for a, b in zip(n, k))
    assert (k1_kernel, k1_norb) == (1, 2)


def test_cuda_rtgs_session_runs_through_the_kernels(dev):
    """A small RTGS session (pruning and downsampling on) on the card goes
    through K1, K2 and K3's merge at every factor, removes Gaussians and
    never runs a plain version."""
    from repro_torch.core.downsample import DownsampleConfig
    from repro_torch.core.keyframes import KeyframePolicy
    from repro_torch.core.pruning import PruneConfig
    from repro_torch.slam.datasets import make_dataset
    from repro_torch.slam.session import SLAMConfig, run_sequence

    ds = make_dataset("room0", num_frames=6, height=64, width=64,
                      num_gaussians=400, frag_capacity=48)
    plains = (tile_render_fwd_plain, tile_render_bwd_plain, gmu.merge_runs_plain)
    before = [tile_render_fwd.launches, tile_render_bwd.launches, gmu.merge_runs.launches]
    calls = [p.calls for p in plains]
    res = run_sequence(ds, SLAMConfig(
        iters_track=3, iters_map=4, capacity=1024, frag_capacity=48, map_window=2,
        keyframe=KeyframePolicy(interval=3), prune=PruneConfig(k0=2, step_frac=0.08),
        downsample=DownsampleConfig(enabled=True)))
    after = [tile_render_fwd.launches, tile_render_bwd.launches, gmu.merge_runs.launches]
    assert all(a > b for a, b in zip(after, before))
    assert after[2] - before[2] == after[1] - before[1]
    assert [p.calls for p in plains] == calls
    assert res.prune_removed > 0 and np.isfinite(res.ate)


def _sparse_runs(dev, stable_age, backends):
    """The 64x64 desk0 session with sparse mapping (and, for comparison,
    dense), fixed densify picks, per backend: the step results, the final
    sessions, and the stable rows' parameters before and after each
    keyframe."""
    from repro_torch.core.keyframes import KeyframePolicy
    from repro_torch.core.pruning import PruneConfig
    from repro_torch.slam.datasets import make_dataset
    from repro_torch.slam.session import SLAMConfig, session_init, session_step

    ds = make_dataset("desk0", num_frames=6, height=64, width=64,
                      num_gaussians=600, frag_capacity=64)
    rng = np.random.default_rng(5)
    perms = {i: torch.as_tensor(rng.permutation(2 * 384)) for i in range(1, 6)}
    out = {}
    for backend, sparse in backends:
        cfg = SLAMConfig(iters_track=3, iters_map=4, capacity=1024, frag_capacity=64,
                         map_window=2, map_rebuild_stride=2, backend=backend,
                         keyframe=KeyframePolicy(interval=2), sparse_opt=sparse,
                         prune=PruneConfig(k0=2, step_frac=0.1, stable_ema_beta=0.5,
                                           stable_rel=1.0, stable_age=stable_age))
        sess = session_init(ds, cfg)
        steps, frozen = [], []
        for idx in range(1, 6):
            before = {k: v.clone() for k, v in G.params_of(sess.g).items()}
            sess, r = session_step(sess, ds.frames[idx], perm=perms[idx])
            steps.append(r)
            st = sess.pstate.stable
            if r.is_kf and bool(st.any()):
                after = G.params_of(sess.g)
                frozen.append(all(torch.equal(before[k][st], after[k][st]) for k in before)
                              and all(not bool(sess.map_opt.mu[k][st].any())
                                      for k in before))
        out[(backend, sparse)] = (steps, sess, frozen)
    return out


def _steps_equal(a, b):
    for x, y in zip(a, b):
        assert x.is_kf == y.is_kf
        for name in ("pose", "alive", "track_losses", "map_losses", "fired"):
            assert torch.equal(getattr(x, name), getattr(y, name)), name
        assert torch.equal(x.psnr, y.psnr) or bool(torch.isnan(x.psnr) & torch.isnan(y.psnr))
        assert [int(v) for v in x.work] == [int(v) for v in y.work]


def test_cuda_sparse_session_never_stable_equals_dense(dev):
    """On the card, sparse mapping whose stability rule never fires equals
    the dense run bit for bit (poses, losses, PSNR, counters): the empty
    stable background's K1 launch writes (0, 0, 1) and the composite
    reduces to the dense loss."""
    runs = _sparse_runs(dev, 10 ** 6, [("kernel", False), ("kernel", True)])
    _steps_equal(runs[("kernel", False)][0], runs[("kernel", True)][0])


def test_cuda_sparse_session_schedule_equals_kernel(dev):
    """A sparse session that freezes rows: the ``schedule`` backend (K4/K5,
    zero-trip pairs of tiles only stable rows cover) equals the ``kernel``
    backend bit for bit, stable rows keep their parameters and zero
    moments through every keyframe, and no plain version runs."""
    plains = (tile_render_fwd_plain, tile_render_bwd_plain, tile_render_fwd_sched_plain,
              tile_render_bwd_sched_plain, gmu.merge_runs_plain)
    calls = [p.calls for p in plains]
    runs = _sparse_runs(dev, 1, [("kernel", True), ("schedule", True)])
    assert [p.calls for p in plains] == calls
    (k_steps, k_sess, k_frozen), (s_steps, _, s_frozen) = (
        runs[("kernel", True)], runs[("schedule", True)])
    _steps_equal(k_steps, s_steps)
    assert k_frozen and all(k_frozen) and all(s_frozen)
    assert sum(int(r.work.skipped_fragments) for r in k_steps) > 0


# ---------------------------------------------------------------------------
# the fused engine: phases as CUDA graph replays
# ---------------------------------------------------------------------------


def _launches():
    return [tile_render_fwd.launches, tile_render_bwd.launches,
            tile_render_fwd_sched.launches, tile_render_bwd_sched.launches,
            gmu.merge_runs.launches, gmu.block_cumsum.launches]


def _fused_and_eager(path):
    """The 64x64 session of ``path`` run fused (graph replays) and eager:
    per mode, the result, the dispatch counts and the kernel launches."""
    from repro_torch.core.downsample import DownsampleConfig
    from repro_torch.core.keyframes import KeyframePolicy
    from repro_torch.core.pruning import PruneConfig
    from repro_torch.slam.datasets import make_dataset
    from repro_torch.slam.session import SLAMConfig, run_sequence

    ds = make_dataset("room0", num_frames=6, height=64, width=64,
                      num_gaussians=400, frag_capacity=48)
    kw = {"kernel": {}, "schedule": dict(backend="schedule"),
          "rtgs": dict(prune=PruneConfig(k0=2, step_frac=0.08),
                       downsample=DownsampleConfig(enabled=True))}[path]
    out = {}
    for fused in (True, False):
        before = _launches()
        res = run_sequence(ds, SLAMConfig(
            iters_track=3, iters_map=8, capacity=1024, frag_capacity=48,
            map_window=2, map_rebuild_stride=3, keyframe=KeyframePolicy(interval=2),
            fused=fused, **kw))
        out[fused] = (res, [a - b for a, b in zip(_launches(), before)])
    return out


@pytest.mark.parametrize("path", ["kernel", "schedule", "rtgs"])
def test_cuda_fused_session_equals_eager(dev, path):
    """Graph replays run the eager path's kernels on the same inputs in the
    same order: poses, PSNR, alive counts and work counters equal bit for
    bit, with the same kernel launch counts, one K3 merge per backward, in
    fewer dispatches."""
    out = _fused_and_eager(path)
    (fused, l_f), (eager, l_e) = out[True], out[False]
    assert all(np.array_equal(a, b) for a, b in zip(fused.est_w2c, eager.est_w2c))
    assert fused.keyframe_psnr == eager.keyframe_psnr
    assert fused.alive_per_frame == eager.alive_per_frame
    assert fused.work == eager.work and fused.prune_removed == eager.prune_removed
    assert l_f == l_e and l_f[4] == l_f[1] + l_f[3] > 0
    assert fused.syncs == eager.syncs and fused.dispatches < eager.dispatches


def _tracking_stage(dev, backend="kernel", fused=True):
    """A 64x64 full-resolution stage of a fresh session and the inputs of
    one tracking phase."""
    from repro_torch.core.keyframes import KeyframePolicy
    from repro_torch.slam.datasets import make_dataset
    from repro_torch.slam.metrics import device_work_zero
    from repro_torch.slam.session import SLAMConfig, session_init

    ds = make_dataset("room0", num_frames=3, height=64, width=64,
                      num_gaussians=400, frag_capacity=48)
    sess = session_init(ds, SLAMConfig(iters_track=3, iters_map=4, capacity=1024,
                                       frag_capacity=48, map_window=2,
                                       backend=backend, fused=fused,
                                       keyframe=KeyframePolicy(interval=2)))
    st = sess.stage
    frame = ds.frames[1]
    args = (sess.g, sess.masked, sess.pose, frame.rgb, frame.depth,
            device_work_zero(dev))
    return st, args


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("backend", ["kernel", "schedule"])
def test_cuda_replay_makes_no_sync(dev, backend, fused):
    """Once captured, a tracking phase (copies in, one replay of the
    fragment-list build and the iterations, clones out) makes no
    synchronizing CUDA call, and neither does it run eagerly (no device
    read, no copy from pageable host memory)."""
    st, args = _tracking_stage(dev, backend, fused)
    first = st._track_scan_noprune(*args)           # capture, if fused
    replays = st.runner.stats.replays
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = st._track_scan_noprune(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert st.runner.stats.replays == replays + fused
    assert torch.equal(first[0], again[0]) and torch.equal(first[2], again[2])


def test_cuda_replay_counts_launches_per_replay(dev):
    """The kernel wrappers count at capture only; the runner adds the
    captured delta on every replay, so N replays count N times one eager
    run's launches."""
    from repro_torch.slam.graphs import flat

    st, (g, masked, base, rgb, depth, work) = _tracking_stage(dev)
    xi, ostate = st._pose_start()
    inputs = st._track_inputs(g, masked, base, rgb, depth, None, None, xi,
                              ostate, work)
    fn = st._track_segment(2, prune=False)
    before = _launches()
    fn(inputs)
    eager = [a - b for a, b in zip(_launches(), before)]
    assert eager[0] == eager[1] == eager[4] == 2
    for times in (1, 5):
        before = _launches()
        st.runner.run(("count", times), fn, inputs, st._TRACK_CARRY, times=times)
        assert [a - b for a, b in zip(_launches(), before)] == [times * d for d in eager]


def test_cuda_failed_capture_raises_and_keeps_nothing(dev):
    """A segment that reads the card from the host cannot be captured: the
    runner raises on every attempt, keeps no segment and never runs it
    eagerly in the graph's place.  In a process of its own, as a failed
    capture may leave the CUDA context unusable."""
    import os
    import subprocess
    import sys
    import textwrap

    code = textwrap.dedent("""
        import torch
        from repro_torch.slam.graphs import PhaseRunner
        runner = PhaseRunner("cuda")
        x = torch.ones(4, device="cuda")
        def fn(t):
            return {"y": t["x"] * int(t["x"].sum())}   # a device read
        for attempt in range(2):
            try:
                runner.run("bad", fn, {"x": x})
            except RuntimeError:
                pass
            else:
                raise SystemExit(f"attempt {attempt} did not raise")
        assert not runner._segments and runner.stats.captures == 0
        assert runner.stats.dispatches == 0
        print("raised")
    """)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(sys.path)}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=env)
    assert out.returncode == 0 and out.stdout.strip().endswith("raised"), out.stderr


# ---------------------------------------------------------------------------
# stacked sessions and the serving pool
# ---------------------------------------------------------------------------


def _pool_run(prune):
    """Two 64x64 streams (room0, stairs0) stepped as an S=2 pool and alone:
    the pool's rows after 4 frame-steps, the solo sessions, the per-step
    counts and the pool."""
    import dataclasses

    from repro_torch.core.keyframes import KeyframePolicy
    from repro_torch.core.pruning import PruneConfig
    from repro_torch.slam.datasets import make_dataset
    from repro_torch.slam.server import ShardedPool
    from repro_torch.slam.session import SLAMConfig, session_init, session_step

    cfg = SLAMConfig(iters_track=3, iters_map=4, capacity=1024, frag_capacity=48,
                     map_window=2, map_rebuild_stride=2,
                     keyframe=KeyframePolicy(interval=3),
                     prune=PruneConfig(k0=2, step_frac=0.1) if prune else None)
    scenes = [make_dataset(n, num_frames=5, height=64, width=64, num_gaussians=400,
                           frag_capacity=48) for n in ("room0", "stairs0")]
    solos = []
    for ds in scenes:
        sess = session_init(ds, cfg)
        for t in range(1, 5):
            sess, _ = session_step(sess, ds.frames[t])
        solos.append(sess)
    pool = ShardedPool([session_init(ds, cfg) for ds in scenes])
    steps = []
    for t in range(1, 5):
        before = dataclasses.replace(pool.stats)
        res = pool.step([ds.frames[t] for ds in scenes])
        steps.append((pool.stats.since(before), res.is_kf))
    return [pool.session(s) for s in range(2)], solos, steps, pool, scenes


@pytest.mark.parametrize("prune", [False, True])
def test_cuda_pool_rows_equal_solo_runs(dev, prune):
    """An S=2 pool on the card: every row equals its solo run bit for bit
    (graph replays of the S-row tracking segment, the mapping graphs shared
    with the solo sessions)."""
    from _session_state import same_session

    rows, solos, steps, _, _ = _pool_run(prune)
    assert all(same_session(r, s) for r, s in zip(rows, solos))
    assert any(any(kf) for _, kf in steps) and not all(any(kf) for _, kf in steps)


def test_cuda_pool_tracking_step_is_one_replay(dev):
    """Once captured, a tracking-only frame-step of both rows is one graph
    replay, one dispatch and no synchronizing CUDA call."""
    import dataclasses

    _, _, steps, pool, scenes = _pool_run(False)
    assert [kf for _, kf in steps] == [(False, False), (False, False), (True, True),
                                       (False, False)]
    counts = steps[3][0]
    assert (counts.dispatches, counts.syncs, counts.replays, counts.captures) == (1, 0, 1, 0)
    obs = pool.stage([(ds.frames[4].rgb, ds.frames[4].depth) for ds in scenes])
    before = dataclasses.replace(pool.stats)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = pool.step(obs)                    # frame 5 of 5: tracking only
    finally:
        torch.cuda.set_sync_debug_mode("default")
    counts = pool.stats.since(before)
    assert res.is_kf == (False, False)
    assert (counts.dispatches, counts.syncs, counts.replays) == (1, 0, 1)


def test_cuda_swap_captures_nothing(dev):
    """Swapping a row and stepping the pool on adds no segment and no
    capture to the runner census, and the admitted row steps as its solo
    run."""
    from _session_state import same_session
    from repro_torch.slam.server import compile_cache_stats
    from repro_torch.slam.session import session_init, session_step

    _, _, _, pool, scenes = _pool_run(False)
    fresh = session_init(scenes[1], pool.cfg)
    census = compile_cache_stats()
    pool.swap(0, fresh)
    pool.step([scenes[1].frames[1], scenes[1].frames[1]])
    assert compile_cache_stats() == census and pool.admin_dispatches == 1
    solo, _ = session_step(session_init(scenes[1], pool.cfg), scenes[1].frames[1])
    assert same_session(pool.session(0), solo)
