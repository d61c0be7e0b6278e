"""The port on a card: the CUDA kernels K1-K5 (K3's scan and merge)
against their plain versions, the scheduled kernels K4/K5 against K1/K2 bit for bit, the
``kernel`` backend against the ``ref`` backend, the ``schedule`` session
against the ``kernel`` one, the default entry points, and the LM serving
path (the ten architectures at reduced size against the port's CPU run, a
decode step that reads nothing back, ``launch/serve.py``) and the LM
training path (a train step of each architecture against the CPU's, the
remat modes bit for bit, the Trainer's checkpoint and resume,
``launch/train.py``), the distributed layer on a one-rank NCCL group, and
the dry run (``launch/dryrun.py``: a peak predicted on a fake group against
the measured one; a fake run's record equal on the card and the CPU; a
one-rank step's census).  Every test here is marked ``cuda`` and skips where
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
    FWD_SPLIT, FWD_WINDOW, fwd_launch_shape, raise_on_sched_fault, tile_render_fwd,
    tile_render_fwd_plain, tile_render_fwd_sched, tile_render_fwd_sched_plain,
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


# K1/K4 on the card at their launch shapes: on an H100 (132 SMs) K1 takes a
# cluster of two blocks a tile at 70 tiles and one block at 280 and 1200,
# K4 a cluster a pair of slots at 70 and 280 tiles and one block at 1200.
@pytest.mark.parametrize("hw,cap,chunk,near_tile,fill", [
    ((112, 160), 256, 16, False, "full"),   # 70 tiles (factor 4), full lists
    ((224, 320), 256, 16, False, "full"),   # 280 tiles (factor 2), full lists
    ((480, 640), 256, 16, False, "full"),   # 1200 tiles (a full view)
    ((112, 160), 512, 16, False, "full"),   # the sparse run's K
    ((112, 160), 256, 8, True, "some"),     # saturated tiles: chunks skipped
    ((112, 160), 256, 32, True, "empty"),   # and rows with count 0
    ((112, 160), 256, 64, False, "empty"),
    ((112, 160), 2048, 64, False, "full"),  # rows wider than a staging window
    ((224, 320), 1536, 48, False, "some"),
])
def test_cuda_forward_equals_plain_bit_for_bit(dev, hw, cap, chunk, near_tile, fill):
    """K1 and K4 equal their plain versions bit for bit, K4 gathered by
    ``inv`` equals K1, and K2/K5 on those outputs equal their plain
    versions (K5 gathered by ``inv`` equals K2)."""
    grid = make_tile_grid(*hw)
    tiles = grid.num_tiles
    attrs, count = _attrs(51 + chunk, tiles, cap, *hw, near_tile=near_tile)
    if fill == "full":
        count[:] = cap
        attrs[:, 10] = 1.0
    elif fill == "empty":
        attrs, count, empty = _empty_tiles(attrs, count, tiles, 0.3, 52)
        assert bool(empty.any())
    a, c = attrs.to(dev), count.to(dev)
    perm, trips, inv = _stacked_schedule(c, tiles, 1, cap, chunk)
    kw = dict(chunk=chunk, tiles_per_view=tiles)
    got = tile_render_fwd(a, c, grid, **kw)
    want = tile_render_fwd_plain(a, c, grid, **kw)
    got4 = tile_render_fwd_sched(a, perm, trips, grid, **kw)
    want4 = tile_render_fwd_sched_plain(a, perm, trips, grid, **kw)
    torch.cuda.synchronize()
    for name, g, w, g4, w4 in zip(("color", "depth", "final_T", "stash"), got, want,
                                  got4, want4):
        assert torch.equal(g, w), name
        assert torch.equal(g4, w4), name
        assert torch.equal(g4[inv], g), name
    if near_tile:  # some chunks below the trip count were skipped
        first_of_last = ((c.long() - 1) // chunk * chunk).clamp(min=0)
        last = want[3][torch.arange(tiles, device=dev), first_of_last]
        assert bool(((last == 0).all(1) & (c > 0)).any())
    if cap > FWD_WINDOW:  # some tile ran past its first window
        ran = (want[3] != 0).any(-1).any(0).nonzero()
        assert int(ran.max()) >= FWD_WINDOW
    r = np.random.default_rng(53)
    cots = [torch.as_tensor(r.normal(size=s).astype(np.float32), device=dev)
            for s in ((tiles, 3, 256), (tiles, 256), (tiles, 256))]
    gg = tile_render_bwd(a, c, *got, *cots, grid, **kw)
    gw = tile_render_bwd_plain(a, c, *got, *cots, grid, **kw)
    slot_cots = [x[perm.long()].contiguous() for x in cots]
    g5 = tile_render_bwd_sched(a, perm, trips, *got4, *slot_cots, grid, **kw)
    g5_plain = tile_render_bwd_sched_plain(a, perm, trips, *got4, *slot_cots, grid, **kw)
    torch.cuda.synchronize()
    _close(gg, gw, _grad_atol(gw))
    _close(g5, g5_plain, _grad_atol(g5_plain))
    assert torch.equal(g5[inv], gg)
    raise_on_sched_fault(dev)


def test_cuda_forward_shapes_cover_both_launches(dev):
    """The 70-, 280- and 1200-tile grids of the test above take both of
    K1's and both of K4's launch shapes (one block, or a cluster of
    :data:`FWD_SPLIT`), with 256 / cluster threads a block."""
    got = {}
    for tiles in (70, 280, 1200):
        for name, blocks in (("K1", tiles), ("K4", (tiles + 1) // 2)):
            shape = fwd_launch_shape(blocks, 256, 16, dev)
            assert shape["threads"] * shape["cluster"] == 256
            assert shape["smem_bytes"] == 256 * 40
            got.setdefault(name, set()).add(shape["cluster"])
    assert got == {"K1": {1, FWD_SPLIT}, "K4": {1, FWD_SPLIT}}


@pytest.mark.parametrize("hw", [(48, 80), (496, 624)])   # K4: a cluster, one block
@pytest.mark.parametrize("bad", ["perm", "trips"])
def test_cuda_sched_forward_pads_and_guards_slots(dev, bad, hw):
    """K4 on an odd tile count (the schedule's slot 1 is a pad slot) with
    one slot's perm entry or trips out of range: that slot runs as a pad
    slot (color and depth 0, final T 1, a zero stash) or with its trips
    clamped, every slot equals the plain version bit for bit, and the fault
    word says which."""
    grid = make_tile_grid(*hw)
    tiles = grid.num_tiles
    cap, chunk = 64, 16
    attrs, count = _attrs(54, tiles, cap, *hw)
    a, c = attrs.to(dev), count.to(dev)
    perm, trips, _ = _stacked_schedule(c, tiles, 1, cap, chunk)
    assert perm.shape[0] == tiles + 1
    want_perm, want_trips = perm.clone(), trips.clone()
    if bad == "perm":
        perm[4] = tiles
        want_perm[4], want_trips[4] = 0, 0
    else:
        trips[4] = cap // chunk + 3
        want_trips[4] = cap // chunk
    raise_on_sched_fault(dev)
    kw = dict(chunk=chunk, tiles_per_view=tiles)
    got = tile_render_fwd_sched(a, perm, trips, grid, **kw)
    want = tile_render_fwd_sched_plain(a, want_perm, want_trips, grid, **kw)
    torch.cuda.synchronize()
    for name, g, w in zip(("color", "depth", "final_T", "stash"), got, want):
        assert torch.equal(g, w), name
    if bad == "perm":
        assert not bool(got[0][4].any()) and not bool(got[3][4].any())
        assert bool((got[2][4] == 1.0).all())
    with pytest.raises(RuntimeError, match=bad):
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
    # Eager, RTGS reads its boundary check once per tracking iteration (3
    # iterations, 5 steps); fused, the boundaries run inside the replay.
    reads = 3 * 5 if path == "rtgs" else 0
    assert eager.syncs == fused.syncs + reads and fused.dispatches < eager.dispatches


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
    inputs = st._track_inputs(g, masked, base, rgb, depth, xi, ostate, work)
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


# ---------------------------------------------------------------------------
# the keyframe's mapping work as one graph replay
# ---------------------------------------------------------------------------


def _keyframe_session(path, fused):
    """A 64x64 room0 session of ``path`` stepped to its keyframe at frame
    2 (frame 1 captures the tracking graph): the dataset, the session and
    the keyframe's result and counts."""
    from repro_torch.core.keyframes import KeyframePolicy
    from repro_torch.core.pruning import PruneConfig
    from repro_torch.slam.datasets import make_dataset
    from repro_torch.slam.graphs import EngineStats
    from repro_torch.slam.session import SLAMConfig, session_init, session_step

    ds = make_dataset("room0", num_frames=5, height=64, width=64, num_gaussians=400,
                      frag_capacity=48)
    kw = {"kernel": {}, "schedule": dict(backend="schedule"),
          "sparse": dict(backend="schedule", sparse_opt=True, prune=PruneConfig(
              k0=2, step_frac=0.1, stable_ema_beta=0.6, stable_rel=4.0,
              stable_age=1, stable_warmup=2))}[path]
    cfg = SLAMConfig(iters_track=3, iters_map=8, capacity=1024, frag_capacity=48,
                     map_window=2, map_rebuild_stride=3,
                     keyframe=KeyframePolicy(interval=2), fused=fused, **kw)
    sess = session_init(ds, cfg)
    sess, _ = session_step(sess, ds.frames[1])
    stats = EngineStats()
    sess, res = session_step(sess, ds.frames[2], stats=stats)
    assert res.is_kf
    return ds, sess, res, stats


@pytest.mark.parametrize("path", ["kernel", "schedule", "sparse"])
def test_cuda_fused_keyframe_equals_eager(dev, path):
    """A keyframe's mapping work replays as one graph: the session (its
    densify generator's state included) and the step's results equal the
    eager run's bit for bit, and the keyframe counts 2 dispatches, no sync
    and 2 replays, with pruning too (eager, pruning reads its boundary
    check once per tracking iteration)."""
    from _session_state import same_bits, same_session

    _, s_f, r_f, c_f = _keyframe_session(path, True)
    _, s_e, r_e, c_e = _keyframe_session(path, False)
    assert same_session(s_f, s_e)
    assert torch.equal(s_f.rng.get_state(), s_e.rng.get_state())
    for name in ("pose", "alive", "psnr", "map_losses"):
        assert same_bits(getattr(r_f, name), getattr(r_e, name)), name
    assert all(same_bits(a, b) for a, b in zip(r_f.work, r_e.work))
    assert c_e.syncs == (s_f.cfg.iters_track if path == "sparse" else 0)
    assert c_e.replays == 0
    if path == "sparse":
        assert int(s_f.pstate.stable.sum()) > 0
    assert (c_f.dispatches, c_f.syncs, c_f.replays) == (2, 0, 2)


def test_cuda_keyframe_replay_makes_no_sync(dev):
    """Once captured, a keyframe (the tracking replay, the densify draw and
    the keyframe replay) makes no synchronizing CUDA call and captures
    nothing."""
    from repro_torch.slam.graphs import EngineStats
    from repro_torch.slam.session import session_step

    ds, sess, _, _ = _keyframe_session("kernel", True)
    sess, res = session_step(sess, ds.frames[3])
    assert not res.is_kf
    stats = EngineStats()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        sess, res = session_step(sess, ds.frames[4], stats=stats)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert res.is_kf
    assert (stats.dispatches, stats.syncs, stats.replays, stats.captures) == (2, 0, 2, 0)


def test_cuda_pool_keyframes_after_warmup_capture_nothing(dev):
    """``PoolLadder.warmup`` captures the S-row keyframe graph: an S=2 pool
    stepped through keyframe frame-steps afterwards adds no segment and no
    capture, and a frame-step with keyframe rows adds one dispatch and one
    replay, however many rows map."""
    import dataclasses

    from repro_torch.core.keyframes import KeyframePolicy
    from repro_torch.slam.datasets import make_dataset
    from repro_torch.slam.sched import PoolLadder
    from repro_torch.slam.server import compile_cache_stats
    from repro_torch.slam.session import SLAMConfig, session_init

    cfg = SLAMConfig(iters_track=3, iters_map=4, capacity=1024, frag_capacity=48,
                     map_window=2, map_rebuild_stride=2,
                     keyframe=KeyframePolicy(interval=2))
    ds = make_dataset("stairs0", num_frames=5, height=64, width=64, num_gaussians=400,
                      frag_capacity=48)
    ladder = PoolLadder(session_init(ds, cfg), widths=(2,))
    census = ladder.warmup()
    pool = ladder[0].pool
    kf_rows = 0
    for t in range(1, 5):
        before = dataclasses.replace(pool.stats)
        res = pool.step([ds.frames[t]] * 2)
        counts = pool.stats.since(before)
        kf_rows += sum(res.is_kf)
        assert (counts.dispatches, counts.syncs, counts.replays) == (
            1 + any(res.is_kf), 0, 1 + any(res.is_kf)), t
    assert kf_rows > 0 and compile_cache_stats() == census


# ---------------------------------------------------------------------------
# the keyframe branch on the device: conditional nodes
# ---------------------------------------------------------------------------


def _cond_body(t):
    y = t["x"] @ t["w"]                          # cuBLAS
    spare = torch.zeros_like(y)                  # a memset, freed in the body
    order = torch.sort(y.reshape(-1)).values     # CUB's scratch
    return {"x": torch.tanh(y + spare), "n": t["n"] + 1,
            "loss": y.sum() + 0 * order[0]}


def _cond_decide(t):
    return t["x"].sum() > 0


def _cond_rows(dev, seed, n):
    r = np.random.default_rng(seed)
    return [{"x": torch.as_tensor(r.standard_normal((64, 64)), dtype=torch.float32,
                                  device=dev),
             "w": torch.as_tensor(r.standard_normal((64, 64)) * 0.1,
                                  dtype=torch.float32, device=dev),
             "n": torch.zeros((), dtype=torch.int64, device=dev)} for _ in range(n)]


def _cond_run(runner, rows, flags):
    from repro_torch.slam.graphs import row_names

    inputs = {}
    for s, row in enumerate(rows):
        inputs.update(row_names(s, row))
    defaults = {"loss": torch.full((), float("nan"), device=rows[0]["x"].device)}
    return runner.run_when("cond", _cond_decide, _cond_body, inputs, flags, ("x", "n"),
                           defaults)


@pytest.mark.parametrize("flags", [[False], [True], [True, False, True],
                                   [None, False, None]])
def test_cuda_conditional_replay_runs_and_skips(dev, flags):
    """One graph of S conditional nodes: on replays with other inputs (and,
    where the device decides, other flags), a row whose flag is false keeps
    every carried buffer bit for bit and takes the defaults, and a row whose
    flag is true equals its eager body.  Each run is one dispatch and one
    replay, with no synchronizing call; the bodies' allocations stay in the
    runner's pools (an eager tensor made between replays is untouched)."""
    from _session_state import same_bits
    from repro_torch.slam.graphs import PhaseRunner

    runner = PhaseRunner(dev)
    _cond_run(runner, _cond_rows(dev, 0, len(flags)), flags)      # capture
    assert runner.stats.captures == 1
    for seed in (1, 2, 3):
        rows = _cond_rows(dev, seed, len(flags))
        # Flip the device's decisions from run to run.
        for row in rows[seed % 2::2]:
            row["x"].neg_()
        junk = torch.full((1 << 20,), 7.0, device=dev)
        before = runner.stats.replays
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = _cond_run(runner, rows, flags)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert runner.stats.replays == before + 1 and runner.stats.syncs == 0
        for row, f, o in zip(rows, flags, out):
            want = bool(_cond_decide(row)) if f is None else f
            assert bool(o["when"]) == want
            ref = _cond_body(row) if want else dict(
                row, loss=torch.tensor(float("nan"), device=dev))
            for k in ("x", "n", "loss"):
                assert same_bits(o[k], ref[k]), (seed, k)
        assert bool((junk == 7.0).all())
    assert runner.stats.captures == 1 and len(runner._segments) == 1


def test_cuda_conditional_run_counts_fold_into_launches(dev):
    """A device-decided body's launches are counted on the device and
    folded into the wrappers' counters by ``fold_launches`` (one read); a
    host-decided body's are added at its replay."""
    from repro_torch.slam.graphs import PhaseRunner

    def body(t):
        return {"y": gmu.block_cumsum(t["y"]), "loss": t["y"].sum()}

    def decide(t):
        return t["y"].sum() > 0

    def rows(sign):
        return {f"{s}/y": sign * torch.ones((256, 4), device=dev) for s in range(2)}

    runner = PhaseRunner(dev)
    defaults = {"loss": torch.zeros((), device=dev)}
    runner.run_when("fold", decide, body, rows(1), [None, True], ("y",), defaults)
    runner.fold_launches()
    before = gmu.block_cumsum.launches
    for sign in (1, -1, 1):     # the device row runs, skips, runs; the host row runs
        runner.run_when("fold", decide, body, rows(sign), [None, True], ("y",), defaults)
    assert gmu.block_cumsum.launches == before + 3
    syncs = runner.stats.syncs
    runner.fold_launches()
    assert gmu.block_cumsum.launches == before + 3 + 2
    assert runner.stats.syncs == syncs + 1


def _loop_segment(n):
    """``n`` iterations over a state buffer: each halves it, then under a
    device flag (the sign of a gate) a body runs K3's scan on it in place;
    every iteration's state is returned."""
    def fn(t, when):
        x, seen = t["x"].clone(), []
        for i in range(n):
            x.copy_(x * 0.5)
            when(t["gate"][i] > 0, lambda: x.copy_(gmu.block_cumsum(x)))
            seen.append(x.clone())
        return {"x": x, "seen": torch.stack(seen)}
    return fn


@pytest.mark.parametrize("gates", [[-1.0] * 4, [1.0, -1.0, -1.0, 1.0], [1.0] * 4])
def test_cuda_conditional_body_inside_a_segment(dev, gates):
    """A conditional body inside a segment's loop (``PhaseRunner.run`` with
    ``conditional``), one IF node per iteration in one graph: replays with
    other gates skip or run each body as its flag says, without a
    synchronizing call, and equal the same function run eagerly bit for
    bit (every iteration's state: a skipped body leaves the previous
    iteration's); the bodies' K3 launches are counted on the device and
    folded by ``fold_launches``."""
    from _session_state import same_bits
    from repro_torch.slam.graphs import PhaseRunner

    fused, eager = PhaseRunner(dev), PhaseRunner(dev, fused=False)
    fn = _loop_segment(4)

    def inputs(seed, g):
        r = np.random.default_rng(seed)
        return {"x": torch.as_tensor(r.normal(size=(256, 4)).astype(np.float32), device=dev),
                "gate": torch.tensor(g, device=dev)}

    fused.run("loop", fn, inputs(0, [1.0] * 4), conditional=True)       # capture
    fused.fold_launches()
    for seed in (1, 2):
        t = inputs(seed, gates)
        before, syncs = fused.stats.replays, fused.stats.syncs
        launches = gmu.block_cumsum.launches
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            _, (got,) = fused.run("loop", fn, t, conditional=True)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert fused.stats.replays == before + 1 and fused.stats.syncs == syncs
        fused.fold_launches()
        assert gmu.block_cumsum.launches - launches == sum(g > 0 for g in gates)
        _, (want,) = eager.run("loop", fn, t, conditional=True)
        assert same_bits(got["x"], want["x"]) and same_bits(got["seen"], want["seen"])
    assert fused.stats.captures == 1 and eager.stats.syncs == 2 * len(gates)


@pytest.mark.parametrize("backend", ["kernel", "schedule"])
def test_cuda_rtgs_tracking_phase_is_one_replay(dev, backend):
    """§4.1 pruning on the card: once the tracking graph is captured, a
    tracking-only frame whose boundary fires is one replay with no
    synchronizing call (1 / 0 / 1), a keyframe 2 / 0 / 2 (the first one
    captures the keyframe graph, outside the sync check), and the session
    equals its eager run bit for bit."""
    from _session_state import same_session
    from repro_torch.core.keyframes import KeyframePolicy
    from repro_torch.core.pruning import PruneConfig
    from repro_torch.slam.datasets import make_dataset
    from repro_torch.slam.graphs import EngineStats
    from repro_torch.slam.session import SLAMConfig, session_init, session_step

    ds = make_dataset("room0", num_frames=5, height=64, width=64, num_gaussians=400,
                      frag_capacity=48)
    sessions = {}
    for fused in (True, False):
        cfg = SLAMConfig(iters_track=3, iters_map=4, capacity=1024, frag_capacity=48,
                         map_window=2, backend=backend, fused=fused,
                         keyframe=KeyframePolicy(interval=4),
                         prune=PruneConfig(k0=2, step_frac=0.1))
        sess, fired = session_init(ds, cfg), []
        sess, _ = session_step(sess, ds.frames[1])          # captures
        # Frame 4, the first keyframe, captures the keyframe graph.
        for t, want in ((2, (1, 0, 1, 0)), (3, (1, 0, 1, 0)), (4, (2, 0, 2, 1))):
            stats = EngineStats()
            if fused and t < 4:
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
            try:
                sess, res = session_step(sess, ds.frames[t], stats=stats)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            assert res.is_kf == (t == 4)
            if fused:
                assert (stats.dispatches, stats.syncs, stats.replays,
                        stats.captures) == want, t
            fired.append(int(res.fired.sum()))
        assert fired[0] > 0
        sessions[fused] = sess
    assert same_session(sessions[True], sessions[False])


def _device_kf_run(algo, fused, frames=5):
    """A 48x64 room0 session of ``algo`` (GS-SLAM or Photo-SLAM, decisions
    on the device): the session, each step's result and counts, the result
    and the kernel launches (finalize folds the device-counted ones)."""
    import dataclasses

    from repro_torch.core.keyframes import KeyframePolicy
    from repro_torch.slam.datasets import make_dataset
    from repro_torch.slam.graphs import EngineStats
    from repro_torch.slam.session import (
        SLAMConfig, session_finalize, session_init, session_step)

    ds = make_dataset("room0", num_frames=frames, height=48, width=64,
                      num_gaussians=400, frag_capacity=48)
    policy = {"gsslam": KeyframePolicy(kind="gsslam", trans_thresh=0.02, rot_thresh=0.02),
              "photoslam": KeyframePolicy(kind="photoslam", pho_thresh=0.14)}[algo]
    cfg = SLAMConfig(base_algo=algo, keyframe=policy, iters_track=3, iters_map=4,
                     capacity=1024, frag_capacity=48, map_window=2,
                     map_rebuild_stride=2, fused=fused)
    before = _launches()
    stats = EngineStats()
    sess = session_init(ds, cfg, stats=stats)
    steps = []
    for t in range(1, frames):
        b = dataclasses.replace(stats)
        sess, r = session_step(sess, ds.frames[t], stats=stats)
        steps.append((r, stats.since(b)))
    res = session_finalize(sess)
    return sess, steps, res, [a - b for a, b in zip(_launches(), before)]


@pytest.mark.parametrize("algo", ["gsslam", "photoslam"])
def test_cuda_device_keyframes_fused_equals_eager(dev, algo):
    """GS-SLAM and Photo-SLAM fused on the card: every step after the first
    (which captures) is 2 dispatches, no sync and 2 replays, keyframe or
    not, and the run (a mix of both) equals the eager run (which reads each
    flag) bit for bit, with the same kernel launches once finalize has
    folded the device-counted ones."""
    from _session_state import same_bits, same_session

    s_f, st_f, res_f, l_f = _device_kf_run(algo, True)
    s_e, st_e, res_e, l_e = _device_kf_run(algo, False)
    flags = [bool(r.is_kf) for r, _ in st_f]
    assert any(flags) and not all(flags), flags
    assert [bool(r.is_kf) for r, _ in st_e] == flags
    for (r_f, c_f), (r_e, c_e) in zip(st_f, st_e):
        assert isinstance(r_f.is_kf, torch.Tensor)
        for name in ("pose", "alive", "psnr", "map_losses"):
            assert same_bits(getattr(r_f, name), getattr(r_e, name)), name
        assert (c_f.dispatches, c_f.syncs, c_f.replays) == (2, 0, 2)
        assert c_e.syncs == 1
    assert same_session(s_f, s_e)
    assert res_f.keyframe_psnr == res_e.keyframe_psnr
    assert l_f == l_e and l_f[4] == l_f[1] > 0


def test_cuda_device_keyframe_step_makes_no_sync(dev):
    """Once both graphs are captured, a Photo-SLAM step (its tracking
    replay, the eager inverse and velocity, the keyframe replay) makes no
    synchronizing CUDA call, keyframe or not."""
    import dataclasses

    from repro_torch.core.keyframes import KeyframePolicy
    from repro_torch.slam.datasets import make_dataset
    from repro_torch.slam.graphs import EngineStats
    from repro_torch.slam.session import SLAMConfig, session_init, session_step

    ds = make_dataset("room0", num_frames=5, height=48, width=64, num_gaussians=400,
                      frag_capacity=48)
    cfg = SLAMConfig(base_algo="photoslam", iters_track=3, iters_map=4, capacity=1024,
                     frag_capacity=48, map_window=2,
                     keyframe=KeyframePolicy(kind="photoslam", pho_thresh=0.14))
    sess = session_init(ds, cfg)
    sess, _ = session_step(sess, ds.frames[1])
    stats = EngineStats()
    flags = []
    for t in range(2, 5):
        b = dataclasses.replace(stats)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            sess, r = session_step(sess, ds.frames[t], stats=stats)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        c = stats.since(b)
        assert (c.dispatches, c.syncs, c.replays, c.captures) == (2, 0, 2, 0)
        flags.append(bool(r.is_kf))
    assert any(flags) and not all(flags), flags


def test_cuda_pool_maps_device_keyframe_rows_in_one_replay(dev):
    """An S=2 Photo-SLAM pool whose rows take keyframes on different
    frame-steps: each frame-step after the first is 2 dispatches, no sync
    and 2 replays, and each row equals its solo run bit for bit."""
    import dataclasses

    from _session_state import same_session
    from repro_torch.core.keyframes import KeyframePolicy
    from repro_torch.slam.datasets import make_dataset
    from repro_torch.slam.session import SessionPool, SLAMConfig, session_init, session_step

    cfg = SLAMConfig(base_algo="photoslam", iters_track=3, iters_map=4, capacity=1024,
                     frag_capacity=48, map_window=2,
                     keyframe=KeyframePolicy(kind="photoslam", pho_thresh=0.14))
    scenes = [make_dataset(n, num_frames=5, height=48, width=64, num_gaussians=400,
                           frag_capacity=48, seed=seed)
              for n, seed in (("room0", 0), ("hall0", 2))]
    pool = SessionPool([session_init(ds, cfg) for ds in scenes])
    mixed = False
    for t in range(1, 5):
        b = dataclasses.replace(pool.stats)
        res = pool.step([ds.frames[t] for ds in scenes])
        c = pool.stats.since(b)
        if t > 1:
            assert (c.dispatches, c.syncs, c.replays) == (2, 0, 2), t
        flags = res.is_kf.tolist()
        mixed |= any(flags) and not all(flags)
    assert mixed
    for s, ds in enumerate(scenes):
        solo = session_init(ds, cfg)
        for t in range(1, 5):
            solo, _ = session_step(solo, ds.frames[t])
        assert same_session(pool.session(s), solo), s


def test_cuda_failed_conditional_capture_raises_and_keeps_nothing(dev):
    """A conditional body that reads the card from the host cannot be
    captured: ``run_when`` raises on every attempt and keeps no segment.
    In a process of its own, as a failed capture may leave the CUDA
    context unusable."""
    import os
    import subprocess
    import sys
    import textwrap

    code = textwrap.dedent("""
        import torch
        from repro_torch.slam.graphs import PhaseRunner
        runner = PhaseRunner("cuda")
        x = torch.ones(4, device="cuda")
        def body(t):
            return {"x": t["x"] * int(t["x"].sum())}   # a device read
        for attempt in range(2):
            try:
                runner.run_when("bad", lambda t: t["x"].sum() > 0, body,
                                {"0/x": x}, [None], ("x",), {})
            except RuntimeError:
                pass
            else:
                raise SystemExit(f"attempt {attempt} did not raise")
        assert not runner._segments and runner.stats.captures == 0
        assert runner.stats.dispatches == 0
        print("raised")
    """)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(sys.path)}
    out = subprocess.run([sys.executable, "-X", "faulthandler", "-c", code],
                         capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 0 and out.stdout.strip().endswith("raised"), out.stderr


# ---------------------------------------------------------------------------
# PagedMap: the cull, the gather, the scatter and the table rebuild inside
# the graphs
# ---------------------------------------------------------------------------


def _paged_cfg(pages, **kw):
    """A 64x64 room0 config with pruning; ``pages`` visible pages of 128
    rows of a 1024-row pool (8: every page, the view is the identity), or
    flat with ``pages=None``."""
    from repro_torch.core.keyframes import KeyframePolicy
    from repro_torch.core.pruning import PruneConfig
    from repro_torch.slam.map.paged import PagedConfig
    from repro_torch.slam.session import SLAMConfig

    base = dict(iters_track=3, iters_map=4, capacity=1024, frag_capacity=48,
                map_window=2, map_rebuild_stride=2, densify_per_kf=64,
                keyframe=KeyframePolicy(interval=2),
                prune=PruneConfig(k0=2, step_frac=0.1),
                paged=None if pages is None else PagedConfig(128, pages))
    base.update(kw)
    return SLAMConfig(**base)


def _paged_run(cfg, frames=5):
    """A solo run on the card: the session, the step results and each
    step's (dispatches, syncs, replays)."""
    import dataclasses

    from repro_torch.slam.datasets import make_dataset
    from repro_torch.slam.graphs import EngineStats
    from repro_torch.slam.session import session_init, session_step

    ds = make_dataset("room0", num_frames=frames, height=64, width=64,
                      num_gaussians=400, frag_capacity=48)
    stats = EngineStats()
    sess = session_init(ds, cfg, stats=stats)
    results, counts = [], []
    for t in range(1, frames):
        before = dataclasses.replace(stats)
        sess, res = session_step(sess, ds.frames[t], stats=stats)
        d = stats.since(before)
        results.append(res)
        counts.append((d.dispatches, d.syncs, d.replays))
    return sess, results, counts


@pytest.mark.parametrize("path", ["kernel", "schedule", "noprune"])
def test_cuda_paged_all_visible_equals_flat(dev, path):
    """On the card, a paged session whose view holds every page equals the
    flat one bit for bit (the map, poses, PSNR, every work counter) with
    the same dispatches, syncs and replays per step: the cull, the gather,
    the scatter and the table rebuild ride inside the graphs."""
    from repro_torch.core import gaussians as TG

    kw = {"kernel": {}, "schedule": dict(backend="schedule"),
          "noprune": dict(prune=None)}[path]
    s_f, r_f, c_f = _paged_run(_paged_cfg(None, **kw))
    s_p, r_p, c_p = _paged_run(_paged_cfg(8, **kw))
    assert all(torch.equal(getattr(s_f.g, k), getattr(s_p.g, k))
               for k in TG.PARAM_FIELDS + ("alive",))
    for a, b in zip(r_f, r_p):
        assert torch.equal(a.pose, b.pose) and a.is_kf == b.is_kf
        assert [int(v) for v in a.work] == [int(v) for v in b.work]
        assert torch.equal(a.psnr.nan_to_num(), b.psnr.nan_to_num())
    assert c_f == c_p
    assert c_p[1:] == [(2, 0, 2) if r.is_kf else (1, 0, 1) for r in r_p[1:]]


def test_cuda_paged_partial_view_runs_through_the_kernels(dev):
    """A partial view (6 of 8 pages) on the card: K1, K2 and K3 carry it
    (one K3 merge per backward), no plain version runs, densification
    spills into nursery pages and drops nothing, and every build sweeps the
    view's 768 rows; once captured, a tracking-only frame and a keyframe
    make no synchronizing CUDA call and count 1 / 0 / 1 and 2 / 0 / 2."""
    from repro_torch.slam.datasets import make_dataset
    from repro_torch.slam.graphs import EngineStats
    from repro_torch.slam.session import session_step

    plains = (tile_render_fwd_plain, tile_render_bwd_plain, gmu.merge_runs_plain)
    calls, before = [p.calls for p in plains], _launches()
    cfg = _paged_cfg(6, prune=None)
    sess, results, _ = _paged_run(cfg)
    launched = [a - b for a, b in zip(_launches(), before)]
    assert [p.calls for p in plains] == calls
    assert launched[0] > 0 and launched[1] > 0 and launched[4] == launched[1]
    assert all(int(r.work.densify_dropped) == 0 for r in results)
    assert all(int(r.work.frag_build_rows) % 768 == 0 for r in results)
    ds = make_dataset("room0", num_frames=7, height=64, width=64, num_gaussians=400,
                      frag_capacity=48)
    for t, want in ((5, (1, 0, 1, 0)), (6, (2, 0, 2, 0))):
        stats = EngineStats()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            sess, res = session_step(sess, ds.frames[t], stats=stats)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert res.is_kf == (want[0] == 2)
        assert (stats.dispatches, stats.syncs, stats.replays, stats.captures) == want


@pytest.mark.parametrize("prune", [False, True])
def test_cuda_paged_pool_after_warmup(dev, prune):
    """A paged S=2 pool after ``PoolLadder.warmup``: serving frame-steps add
    no segment and no capture, count the flat formula (1 dispatch and
    replay, 2 with keyframe rows, no sync, with or without pruning), and every row
    equals its solo paged run bit for bit, its page table included."""
    import dataclasses

    from _session_state import same_session
    from repro_torch.slam.datasets import make_dataset
    from repro_torch.slam.sched import PoolLadder
    from repro_torch.slam.server import compile_cache_stats
    from repro_torch.slam.session import session_init, session_step

    cfg = _paged_cfg(6, **({} if prune else dict(prune=None)))
    ds = make_dataset("stairs0", num_frames=5, height=64, width=64, num_gaussians=400,
                      frag_capacity=48)
    solo = session_init(ds, cfg)
    for t in range(1, 5):
        solo, _ = session_step(solo, ds.frames[t])
    ladder = PoolLadder(session_init(ds, cfg), widths=(2,))
    census = ladder.warmup()
    pool = ladder[0].pool
    pool.swap(0, session_init(ds, cfg))
    pool.swap(1, session_init(ds, cfg))
    for t in range(1, 5):
        before = dataclasses.replace(pool.stats)
        res = pool.step([ds.frames[t]] * 2)
        counts = pool.stats.since(before)
        assert (counts.dispatches, counts.syncs, counts.replays) == (
            1 + any(res.is_kf), 0, 1 + any(res.is_kf)), t
    assert compile_cache_stats() == census
    assert same_session(pool.session(0), solo) and same_session(pool.session(1), solo)
    assert solo.page is not None


@pytest.mark.parametrize("prune", [False, True])
def test_cuda_paged_partial_view_equals_flat_while_the_alive_rows_fit(dev, prune):
    """A partial view (6 of 8 pages) on the card equals the flat session
    bit for bit (poses, the map, every work counter but the build rows)
    at every step whose view holds every alive row: the tracking
    iterations' products with the pose run over storage-sized operands, so
    cuBLAS sums the pose gradient over the flat step's lengths."""
    from repro_torch.core import gaussians as TG
    from repro_torch.slam.datasets import make_dataset
    from repro_torch.slam.session import session_init, session_step

    ds = make_dataset("room0", num_frames=5, height=64, width=64, num_gaussians=400,
                      frag_capacity=48)
    kw = {} if prune else dict(prune=None)
    flat, paged = session_init(ds, _paged_cfg(None, **kw)), session_init(ds, _paged_cfg(6, **kw))
    for t in range(1, 5):
        view = paged.stage._working_set(paged.page, paged.velocity @ paged.pose,
                                        paged.kf_w2c)
        assert not (paged.g.alive & ~torch.zeros_like(paged.g.alive).index_fill(
            0, view, True)).any(), t
        flat, r_f = session_step(flat, ds.frames[t])
        paged, r_p = session_step(paged, ds.frames[t])
        assert torch.equal(r_f.pose, r_p.pose) and r_f.is_kf == r_p.is_kf, t
        assert [int(v) for f, v in zip(r_f.work._fields, r_f.work) if f != "frag_build_rows"] \
            == [int(v) for f, v in zip(r_p.work._fields, r_p.work) if f != "frag_build_rows"]
        assert all(torch.equal(getattr(flat.g, k), getattr(paged.g, k))
                   for k in TG.PARAM_FIELDS + ("alive",)), t


# ---------------------------------------------------------------------------
# the LM scaffold's serving path (models/, launch/serve.py)
# ---------------------------------------------------------------------------

LM_ARCHS = ("gemma3-27b", "h2o-danube-1.8b", "llama3-405b", "llava-next-mistral-7b",
            "phi4-mini-3.8b", "qwen3-moe-235b-a22b", "qwen3-moe-30b-a3b",
            "whisper-large-v3", "xlstm-125m", "zamba2-1.2b")


def _lm_tree(tree, fn):
    return {k: _lm_tree(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _lm_setup(name):
    """A reduced architecture's params drawn on the CPU, its smoke batch and
    four decode tokens (numpy)."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.models.lm import Model, init_params
    from repro_torch.train.data import synthetic_batch

    cfg = get_arch(name).reduced()
    gen = torch.Generator()
    gen.manual_seed(0)
    params = init_params(cfg, gen, device="cpu")
    batch = synthetic_batch(cfg, ShapeSpec("smoke", 32, 2, "prefill"), 0)
    feed = np.random.default_rng(1).integers(0, cfg.vocab_size, size=(4, 2, 1)).astype(np.int32)
    return Model(cfg), params, batch, feed


def _lm_run(model, params, batch, feed, device):
    from repro_torch.launch.serve import device_batch

    b = device_batch(batch, device)
    logits, cache = model.prefill(params, b)
    cache = model.pad_cache(cache, model.prompt_len(b) + len(feed) + 1)
    out = [logits]
    for tok in feed:
        logits, cache = model.decode_step(params, cache, torch.from_numpy(tok).to(device))
        out.append(logits)
    return out


@pytest.mark.parametrize("name", LM_ARCHS)
def test_cuda_lm_reduced_matches_cpu(dev, name):
    """Prefill and four teacher-forced decode steps on the card against the
    port's CPU run from the same params: 3e-2 / 7e-2, the reference's own
    prefill and decode tolerances (whisper-large-v3's prefill 7e-2: cuBLAS
    and MKL sum its bf16 GEMMs in other orders, and its six layers, each
    attending over the whole memory, spread a flipped rounding to ~5e-2)."""
    model, params, batch, feed = _lm_setup(name)
    cpu = _lm_run(model, params, batch, feed, "cpu")
    card = _lm_run(model, _lm_tree(params, lambda t: t.to(dev)), batch, feed, dev)
    for i, (g, w) in enumerate(zip(card, cpu)):
        assert g.device.type == "cuda"
        tol = 3e-2 if i == 0 and name != "whisper-large-v3" else 7e-2
        _close(g.cpu(), w, atol=tol, rtol=tol)


@pytest.mark.parametrize("name", LM_ARCHS)
def test_cuda_lm_decode_reads_nothing_back(dev, name):
    """A decode step makes no host sync (no ``.item()``, no pageable copy):
    under ``set_sync_debug_mode("error")`` it runs, and gives the same
    logits and cache as the same step run normally."""
    from repro_torch.launch.serve import device_batch

    model, params, batch, feed = _lm_setup(name)
    params = _lm_tree(params, lambda t: t.to(dev))
    logits, cache = model.prefill(params, device_batch(batch, dev))
    cache = model.pad_cache(cache, model.prompt_len(batch) + 3)
    tok = torch.argmax(logits, dim=-1)
    again = _lm_tree(cache, torch.clone)
    want, want_cache = model.decode_step(params, cache, tok)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got, got_cache = model.decode_step(params, again, tok)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(got, want)
    flat = lambda t: [x for v in t.values() for x in (flat(v) if isinstance(v, dict) else [v])]
    assert all(torch.equal(a, b) for a, b in zip(flat(got_cache), flat(want_cache)))


def test_cuda_lm_serve_runs_on_the_card(dev):
    from repro_torch.launch.serve import main

    res = main(["--arch", "xlstm-125m", "--gen", "4"])
    assert res.tokens.device.type == "cuda" and tuple(res.tokens.shape) == (2, 5)
    assert bool(res.finite)


def test_cuda_lm_serve_raises_without_a_card(dev, monkeypatch):
    from repro_torch.launch.serve import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--arch", "xlstm-125m"])


# ---------------------------------------------------------------------------
# LM training: train/optimizer.py, train/trainer.py, train/checkpoint.py,
# launch/train.py on the card.
# ---------------------------------------------------------------------------


# loss_fn's gradients card against CPU, leaf by leaf: the bound the CPU
# tests hold the port's gradients to the reference's (relative L2 and
# cosine; a leaf whose CPU gradient is under 1e-6 in norm held below 1e-5).
# Worst measured on an H100 with chip_smoke.py's [lm-train] inputs: 2.31e-2
# / 0.999735 (whisper-large-v3).
LM_GRAD_BOUND = dict(rel=5e-2, cos=0.998)


@pytest.mark.parametrize("name", LM_ARCHS)
def test_cuda_lm_train_step_matches_cpu(dev, name):
    """loss_fn's gradients and one train step (AdamW with clipping) on the
    card against the port's CPU run from the same state: the gradients leaf
    by leaf to LM_GRAD_BOUND; the loss and gradient norm rtol 1e-2; the
    parameters atol 3e-2 (the reference's microbatch tolerance, a sanity
    check only: a first Adam step moves each element by about lr whatever
    the gradient)."""
    from repro_torch.train.data import device_batch
    from repro_torch.train.optimizer import Adam, tree_paths
    from repro_torch.train.trainer import loss_and_grads, make_train_step

    model, params, batch, _ = _lm_setup(name)
    opt = Adam(lr=3e-4, weight_decay=0.01, clip_norm=1.0)
    step = make_train_step(model, opt)
    out, grads = {}, {}
    for d in ("cpu", dev):
        p = _lm_tree(params, lambda t: t.to(d))
        b = device_batch(batch, d)
        grads[str(d)] = tree_paths(loss_and_grads(model, p, b)[1])
        m, p, st = step(p, opt.init(p), b)
        out[str(d)] = (float(m["loss"]), float(m["grad_norm"]), tree_paths(p), st)
    for k, w in grads["cpu"].items():
        g = grads[str(dev)][k]
        assert g.device.type == "cuda" and g.dtype == w.dtype, k
        wv, gv = w.double().reshape(-1), g.cpu().double().reshape(-1)
        if float(wv.norm()) < 1e-6:
            assert float(gv.norm()) < 1e-5, k
            continue
        rel = float((gv - wv).norm() / wv.norm())
        cos = float(gv @ wv / (gv.norm() * wv.norm()))
        assert rel <= LM_GRAD_BOUND["rel"] and cos >= LM_GRAD_BOUND["cos"], (k, rel, cos)
    (lc, gc_, pc, _), (lg, gg, pg, sg) = out["cpu"], out[str(dev)]
    assert all(t.device.type == "cuda" for t in pg.values()) and sg.step.device.type == "cuda"
    assert abs(lg - lc) <= 1e-2 * abs(lc) and abs(gg - gc_) <= 1e-2 * abs(gc_)
    for k in pc:
        _close(pg[k].cpu().float(), pc[k].float(), atol=3e-2)


def test_cuda_lm_remat_modes_equal_bit_for_bit(dev):
    import dataclasses

    from repro_torch.train.data import device_batch
    from repro_torch.train.optimizer import tree_paths
    from repro_torch.train.trainer import loss_and_grads

    model, params, batch, _ = _lm_setup("phi4-mini-3.8b")
    params = _lm_tree(params, lambda t: t.to(dev))
    b = device_batch(batch, dev)
    runs = {m: loss_and_grads(type(model)(dataclasses.replace(model.cfg, remat=m)), params, b)
            for m in ("none", "group", "block")}
    for m in ("group", "block"):
        assert torch.equal(runs[m][0], runs["none"][0])
        ga, gb = tree_paths(runs[m][1]), tree_paths(runs["none"][1])
        assert all(torch.equal(ga[k], gb[k]) for k in gb)


def test_cuda_lm_trainer_checkpoint_and_resume(dev, tmp_path):
    """A Trainer on the card by default: 4 straight steps equal 2 steps, a
    checkpoint restored onto the card, a resume and 2 more, bit for bit."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.data import data_iterator
    from repro_torch.train.optimizer import tree_paths
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = get_arch("xlstm-125m").reduced()
    shape = ShapeSpec("smoke", 32, 2, "train")

    def trainer(d, steps, every, start=0):
        return Trainer(cfg, TrainerConfig(steps=steps, ckpt_every=every, ckpt_dir=str(d),
                                          lr=1e-3),
                       data_iterator(cfg, shape, seed=0, start_step=start))

    end_a = trainer(tmp_path / "a", 4, 10).run()
    trainer(tmp_path / "b", 2, 2).run()
    back = ckpt.restore(str(tmp_path / "b"))
    assert back["step"] == 2 and all(t.device.type == "cuda"
                                     for t in tree_paths(back["params"]).values())
    end_b = trainer(tmp_path / "b", 4, 10, start=2).run()
    pa, pb = tree_paths(end_a["params"]), tree_paths(end_b["params"])
    assert all(pa[k].device.type == "cuda" and torch.equal(pa[k], pb[k]) for k in pa)
    assert torch.equal(end_a["opt"].step, end_b["opt"].step)


def test_cuda_lm_launch_train_runs_on_the_card(dev, capsys):
    from repro_torch.launch.train import main

    tr = main(["--arch", "zamba2-1.2b", "--steps", "2", "--seq-len", "32", "--batch", "2",
               "--log-every", "1"])
    assert tr.device.type == "cuda" and len(tr.history) == 2
    assert all(np.isfinite(h["loss"]) for h in tr.history)
    assert "done: 2 steps" in capsys.readouterr().out


def test_cuda_lm_launch_train_raises_without_a_card(dev, monkeypatch):
    from repro_torch.launch.train import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--arch", "xlstm-125m", "--steps", "1"])


# ---------------------------------------------------------------------------
# the distributed layer and the roofline counts on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def nccl_one_rank(dev, tmp_path):
    """A one-rank NCCL process group from a FileStore under ``tmp_path``,
    destroyed after the test (the card tests run in one process)."""
    import torch.distributed as dist

    torch.cuda.set_device(torch.cuda.current_device())
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_cuda_dist_mesh_and_shard_tree_on_one_rank(dev, nccl_one_rank):
    from torch.distributed.tensor import DTensor
    from repro_torch.configs import get_arch
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.lm import init_params
    from repro_torch.train.optimizer import tree_paths

    mesh = make_mesh((1, 1), ("data", "model"))
    assert mesh.device_type == "cuda" and mesh.device_mesh is not None
    assert tuple(mesh.device_mesh.mesh_dim_names) == ("data", "model")
    cfg = get_arch("llama3-405b").reduced()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = init_params(cfg, gen, device=dev)
    specs = sharding.param_specs(cfg, params, mesh)
    got = tree_paths(sharding.shard_tree(params, mesh, specs))
    flat_s = tree_paths(specs)
    for k, t in tree_paths(params).items():
        d = got[k]
        assert isinstance(d, DTensor) and d.to_local().device.type == "cuda"
        assert d.placements == sharding.placements(mesh.axis_names, flat_s[k])
        assert torch.equal(d.to_local(), t) and torch.equal(d.full_tensor(), t)


def test_cuda_pipeline_one_stage_matches_the_stack(dev):
    """S=1 on the card, no process group: forward and gradients of the
    sequential stack, microbatch by microbatch."""
    from repro_torch.distributed.pipeline_parallel import pipeline_apply
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((1,), ("stage",))
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    w0 = torch.randn((1, 64, 64), generator=g, device=dev) / 8
    x0 = torch.randn((6, 8, 64), generator=g, device=dev)
    cot = torch.randn((6, 8, 64), generator=g, device=dev)
    res = []
    for how in ("pipeline", "stack"):
        w, x = w0.clone().requires_grad_(True), x0.clone().requires_grad_(True)
        if how == "pipeline":
            y = pipeline_apply(lambda p, xb: torch.tanh(xb @ p["w"]), {"w": w}, x, mesh)
        else:
            y = torch.stack([torch.tanh(x[m] @ w[0]) for m in range(6)])
        (y * cot).sum().backward()
        res.append((y.detach(), x.grad, w.grad))
    (yp, gxp, gwp), (ys, gxs, gws) = res
    assert yp.device.type == "cuda"
    assert torch.equal(yp, ys) and torch.equal(gxp, gxs)
    torch.testing.assert_close(gwp, gws, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name", LM_ARCHS)
def test_cuda_lm_ctx_set_equals_unset_bit_for_bit(dev, name):
    """``ctx`` set (dp, model and sequence axes) against unset on the card's
    plain tensors: prefill logits and cache, the loss and its gradients
    bit for bit.  This shows the calls are there and leave a plain tensor
    alone; ``test_cuda_lm_ctx_on_dtensors_equals_plain`` runs them on DTensors."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed import ctx
    from repro_torch.models.lm import Model, init_params
    from repro_torch.train.data import device_batch, synthetic_batch
    from repro_torch.train.optimizer import tree_leaves
    from repro_torch.train.trainer import loss_and_grads

    cfg = get_arch(name).reduced()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = init_params(cfg, gen, device=dev)
    model = Model(cfg)
    batch = device_batch(synthetic_batch(cfg, ShapeSpec("smoke", 32, 2, "train"), 0), dev)

    def outputs():
        logits, cache = model.prefill(params, batch)
        loss, grads = loss_and_grads(model, params, batch)
        return [logits, loss, *tree_leaves(grads), *tree_leaves(cache)]

    unset = outputs()
    ctx.set_dp_axes(("data",), 2)
    ctx.set_model_axis("model", 2)
    ctx.set_seq_axis("model", 2)
    try:
        got = outputs()
    finally:
        ctx.set_dp_axes(None)
        ctx.set_model_axis(None)
        ctx.set_seq_axis(None)
    assert len(got) == len(unset)
    assert all(torch.equal(a, b) for a, b in zip(got, unset))


# The families whose plain model runs on replicated DTensors under the
# card's PyTorch: the MoE dispatch, xLSTM's log_sigmoid backward and a
# zamba2 unsqueeze have no sharding rule there, which is why a sharded call
# runs the model on local shards (models/sharded.py).
DTENSOR_ARCHS = ("gemma3-27b", "h2o-danube-1.8b", "llama3-405b", "llava-next-mistral-7b",
                 "phi4-mini-3.8b", "whisper-large-v3")


@pytest.mark.parametrize("name", DTENSOR_ARCHS)
def test_cuda_lm_ctx_on_dtensors_equals_plain(dev, nccl_one_rank, name):
    """The parameters ``shard_tree``'d onto the 1x1 mesh as pure data
    parallelism lays them out (replicated) and the inputs replicated
    DTensors, ``ctx``'s data and model axes set: every ``constrain_batch``
    in prefill and in loss_fn (under remat, and its backward)
    redistributes its activation to (Shard(0), Replicate()), and logits,
    cache, loss and gradients equal the plain run's bit for bit.  The
    parameters on their own specs run through ``models/sharded.py``'s
    local map instead (``test_cuda_build_case_*``)."""
    import dataclasses

    from torch.distributed.tensor import DTensor, Replicate, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed import ctx, sharding
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.lm import Model, init_params
    from repro_torch.train.data import device_batch, synthetic_batch
    from repro_torch.train.optimizer import tree_leaves
    from repro_torch.train.trainer import loss_and_grads

    mesh = make_mesh((1, 1), ("data", "model"))
    cfg = get_arch(name).reduced()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = init_params(cfg, gen, device=dev)
    model = Model(cfg)
    batch = device_batch(synthetic_batch(cfg, ShapeSpec("smoke", 32, 2, "train"), 0), dev)

    def outputs(p, b):
        logits, cache = model.prefill(p, b)
        loss, grads = loss_and_grads(model, p, b)
        return [logits, loss, *tree_leaves(grads), *tree_leaves(cache)]

    plain = outputs(params, batch)
    pure_dp = dataclasses.replace(cfg, pure_dp=True)
    sharded = sharding.shard_tree(params, mesh, sharding.param_specs(pure_dp, params, mesh))
    dbatch = {k: distribute_tensor(v, mesh.device_mesh, [Replicate(), Replicate()])
              for k, v in batch.items()}
    seen, constrain_batch = [], ctx.constrain_batch

    def spy(x):
        y = constrain_batch(x)
        seen.append(tuple(str(p) for p in y.placements) if isinstance(y, DTensor) else None)
        return y

    ctx.constrain_batch = spy
    ctx.set_dp_axes(("data",), 1)
    ctx.set_model_axis("model", 1)
    try:
        with implicit_replication():
            got = outputs(sharded, dbatch)
    finally:
        ctx.constrain_batch = constrain_batch
        ctx.set_dp_axes(None)
        ctx.set_model_axis(None)
    assert seen and set(seen) == {("S(0)", "R")}
    assert isinstance(got[0], DTensor) and got[0].to_local().device.type == "cuda"
    assert len(got) == len(plain)
    assert all(torch.equal(a.full_tensor() if isinstance(a, DTensor) else a, b)
               for a, b in zip(got, plain))


@pytest.mark.parametrize("name", LM_ARCHS)
def test_cuda_build_case_train_step_equals_plain_on_one_rank(dev, nccl_one_rank, name):
    """``build_case``'s sharded train step (2 microbatches, the specs'
    placements, AdamW with clipping) on the 1x1 mesh against the same
    step on plain tensors from the same seed: loss, grad norm and every
    parameter bit for bit, each parameter leaving on its spec."""
    import dataclasses

    from torch.distributed.tensor import DTensor
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed import ctx, sharding
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.optimizer import tree_paths

    mesh = make_mesh((1, 1), ("data", "model"))
    cfg = dataclasses.replace(get_arch(name).reduced(), microbatches=2)
    try:
        step, (params, opt_state, batch) = dryrun.build_case(
            cfg, ShapeSpec("t", 64, 8, "train"), mesh)
    finally:
        ctx.set_dp_axes(None)
        ctx.set_model_axis(None)
        ctx.set_seq_axis(None)
    specs = tree_paths(sharding.param_specs(cfg, params, mesh))
    m_s, p_s, _ = step(params, opt_state, batch)
    plain, opt_plain = dryrun.abstract_state(cfg, True, dev, 0)
    m_p, p_p, _ = step(plain, opt_plain, {k: v.to_local() for k, v in batch.items()})
    assert float(m_s["loss"]) == float(m_p["loss"])
    assert float(m_s["grad_norm"]) == float(m_p["grad_norm"])
    for k, t in tree_paths(p_p).items():
        got = tree_paths(p_s)[k]
        assert isinstance(got, DTensor) and got.to_local().device.type == "cuda"
        assert got.placements == sharding.placements(mesh.axis_names, specs[k])
        assert torch.equal(got.to_local(), t), k


@pytest.mark.parametrize("name", ("qwen3-moe-30b-a3b", "zamba2-1.2b", "whisper-large-v3"))
def test_cuda_build_case_decode_step_equals_plain_on_one_rank(dev, nccl_one_rank, name):
    """``build_case``'s prefill and two decode steps at (64, 8) on the 1x1
    mesh (the cache on ``cache_specs``) against the plain ones: logits
    and every cache leaf bit for bit."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed import ctx
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.optimizer import tree_paths

    mesh = make_mesh((1, 1), ("data", "model"))
    cfg = get_arch(name).reduced()
    model = dryrun.Model(cfg)
    try:
        prefill, (params, batch) = dryrun.build_case(cfg, ShapeSpec("d", 64, 8, "prefill"), mesh)
        decode, (_, cache, tokens) = dryrun.build_case(cfg, ShapeSpec("d", 64, 8, "decode"),
                                                       mesh)
    finally:
        ctx.set_dp_axes(None)
        ctx.set_model_axis(None)
        ctx.set_seq_axis(None)
    plain = {k: (v.to_local() if not isinstance(v, dict) else
                 {n: t.to_local() for n, t in v.items()}) for k, v in params.items()}
    logits, caches = prefill(params, batch)
    want, want_caches = model.prefill(plain, {k: v.to_local() for k, v in batch.items()})
    assert torch.equal(logits.to_local(), want)
    for k, v in tree_paths(want_caches).items():
        assert torch.equal(tree_paths(caches)[k].to_local(), v), k
    plain_cache = model.cache_struct(8, 64, device=dev)
    plain_tokens = tokens.to_local()
    for _ in range(2):
        logits, cache = decode(params, cache, tokens)
        want, plain_cache = model.decode_step(plain, plain_cache, plain_tokens)
        assert torch.equal(logits.to_local(), want)
        for k, v in tree_paths(plain_cache).items():
            assert torch.equal(tree_paths(cache)[k].to_local(), v), k


def test_cuda_count_step_counts_the_backward_on_the_card(dev):
    """``count_step`` of a reduced train step's gradients counts on the card
    what it counts on the CPU: the backward runs on the engine's device
    threads, which the counting modes must reach."""
    import dataclasses

    from repro_torch.analysis.roofline import count_step
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.models.lm import Model, init_params
    from repro_torch.train.data import device_batch, synthetic_batch
    from repro_torch.train.trainer import loss_and_grads

    cfg = dataclasses.replace(get_arch("phi4-mini-3.8b").reduced(), remat="block")
    counts = {}
    for where in ("cpu", dev):
        gen = torch.Generator(device=where)
        gen.manual_seed(0)
        params = init_params(cfg, gen, device=where)
        batch = device_batch(synthetic_batch(cfg, ShapeSpec("smoke", 32, 2, "train"), 0), where)
        counts[str(where)] = count_step(loss_and_grads, Model(cfg), params, batch)
    cpu, card = counts["cpu"], counts[str(dev)]
    assert card["flops"] == cpu["flops"] > 0
    assert card["bytes"] > 0


def test_cuda_census_of_a_one_rank_nccl_step_is_zero(dev, nccl_one_rank):
    """``build_case``'s train and decode steps on the 1x1 mesh of a one-rank
    NCCL group, counted by ``count_step``: the census sees no collective,
    so the roofline's collective term is 0."""
    import dataclasses

    from repro_torch.analysis import roofline
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((1, 1), ("data", "model"))
    cfg = dataclasses.replace(get_arch("phi4-mini-3.8b").reduced(), microbatches=2)
    for kind in ("train", "decode"):
        shape = ShapeSpec(kind, 64, 8, kind)
        try:
            fn, args = dryrun.build_case(cfg, shape, mesh)
        finally:
            dryrun.clear_ctx()
        c = roofline.count_step(fn, *args)
        assert c["flops"] > 0 and c["collective_bytes"] == 0 and c["collectives"] == {}, kind
        assert roofline.from_counts(cfg, shape, "1x1", 1, c, 1e9).t_collective == 0


def test_cuda_dryrun_records_the_same_on_the_card_and_the_cpu(dev):
    """Reduced phi4's train step (8 microbatches over 16 data ranks) and
    decode step on the 16x16 fake group, fake tensors on the card and on
    the CPU: the memory record and the counted FLOPs and collectives are
    equal."""
    import dataclasses

    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh

    cfg = dataclasses.replace(get_arch("phi4-mini-3.8b").reduced(), microbatches=8)
    with dryrun.fake_group(256):
        for shape in (ShapeSpec("t", 256, 32, "train"), ShapeSpec("d", 256, 32, "decode")):
            got = {}
            for where in ("cuda", "cpu"):
                mesh = make_mesh((16, 16), ("data", "model"), device=where)
                try:
                    with FakeTensorMode(allow_non_fake_inputs=True):
                        fn, args = dryrun.build_case(cfg, shape, mesh)
                        m = dryrun.measure_step(fn, args)
                finally:
                    dryrun.clear_ctx()
                got[where] = (m["memory"], m["counts"]["flops"], m["counts"]["collectives"])
            assert got["cuda"] == got["cpu"], shape.kind


def test_cuda_dryrun_predicts_the_peak_of_a_step(dev, tmp_path):
    """``[dryrun]``'s check at a cut size: phi4-mini at full width cut to 2
    layers, a train step of 2 microbatches of 1 x 512.  The peak predicted
    on a one-rank fake group, fake tensors on the card, against the peak of
    the same step on a one-rank NCCL group, measured after a warm-up step
    with its arguments allocated: within 10%."""
    import dataclasses

    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh

    cfg = dataclasses.replace(get_arch("phi4-mini-3.8b"), num_layers=2, microbatches=2)
    shape = ShapeSpec("t", 512, 2, "train")
    with dryrun.fake_group(1):
        mesh = make_mesh((1, 1), ("data", "model"))   # outside the fake mode
        try:
            with FakeTensorMode(allow_non_fake_inputs=True):
                fn, args = dryrun.build_case(cfg, shape, mesh)
                assert all(t.device.type == "cuda" for t in dryrun.local_tensors(args))
                predicted = dryrun.measure_step(fn, args)["memory"]["peak"]
                del fn, args
        finally:
            dryrun.clear_ctx()
    torch.cuda.set_device(torch.cuda.current_device())
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        try:
            step, (params, opt, batch) = dryrun.build_case(
                cfg, shape, make_mesh((1, 1), ("data", "model")))
        finally:
            dryrun.clear_ctx()
        _, params, opt = step(params, opt, batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated() - dryrun.local_bytes((params, opt, batch))
        step(params, opt, batch)
        torch.cuda.synchronize()
        measured = torch.cuda.max_memory_allocated() - base
    finally:
        dist.destroy_process_group()
    assert abs(predicted - measured) <= 0.10 * measured, (predicted, measured)
