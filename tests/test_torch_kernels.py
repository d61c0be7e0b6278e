"""Parity of the port's kernels K1 (forward tile rasterizer) and K2
(backward) with ``repro``'s Pallas kernels run in interpret mode, at the
shape sweep of ``tests/test_kernels.py`` and its tolerances; GMU level 2
against ``repro.kernels.gmu``; the premise of K2's single pass over the
stash (K1's final T is the stash replay's, bit for bit); a numpy emulation
of K2's warp reduce-scatter; a torch emulation of K1's order on the card
(a block's vote, the cluster's exchange, the staging window); and the
wrappers' checks.  The CUDA kernels
themselves are held against these plain versions on a card by
``tests/test_torch_cuda.py``.
"""

import re
from pathlib import Path

import jax  # noqa: F401  (the reference's kernels below run on JAX)
import numpy as np
import pytest
import torch

from _kernel_inputs import random_attrs
from _torch_parity import DEPTH_TOL, FWD_ATOL, FWD_RTOL, grad_atol, jx, np_, th
from _torch_parity import first_cpu_exp_spent  # noqa: F401  (autouse fixture)
from _torch_parity import one_cpu_thread  # noqa: F401  (autouse fixture)
from repro.core.sorting import make_tile_grid as jgrid
from repro.kernels import gmu as jgmu
from repro.kernels.tile_render import tile_render_fwd as j_fwd
from repro.kernels.tile_render_bp import tile_render_bwd as j_bwd
from repro_torch.core.sorting import make_tile_grid as tgrid
from repro_torch.kernels import gmu as tgmu
from repro_torch.kernels.tile_render import (
    FWD_SPLIT, FWD_THREADS, FWD_WINDOW, MAX_CHUNK, fwd_cluster, tile_render_fwd,
    tile_render_fwd_plain,
)
from repro_torch.kernels.ref import (
    ALPHA_MAX, ALPHA_MIN, NUM_ATTRS, TERM_EPS, tile_pixel_coords,
)
from repro_torch.kernels.tile_render_bp import (
    REDUCE_GROUP, tile_render_bwd, tile_render_bwd_plain,
)

SWEEP = [((32, 32), 32, 16), ((16, 48), 64, 16), ((48, 16), 16, 8),
         ((64, 64), 128, 32)]
OUT_NAMES = ("color", "depth", "final_T", "stash")


def _assert_fwd_close(got, want, where):
    for name, g, w in zip(OUT_NAMES, got, want):
        tol = DEPTH_TOL if name == "depth" else FWD_ATOL
        rtol = DEPTH_TOL if name == "depth" else FWD_RTOL
        np.testing.assert_allclose(np_(g), np_(w), atol=tol, rtol=rtol,
                                   err_msg=f"{name} ({where})")


def _cotangents(seed, rows):
    r = np.random.default_rng(seed)
    return (r.normal(size=(rows, 3, 256)).astype(np.float32),
            r.normal(size=(rows, 256)).astype(np.float32),
            r.normal(size=(rows, 256)).astype(np.float32))


@pytest.mark.parametrize("hw,cap,chunk", SWEEP)
def test_plain_forward_matches_pallas(hw, cap, chunk):
    grid = jgrid(*hw)
    attrs, count = random_attrs(42, grid.num_tiles, cap, *hw)
    want = j_fwd(jx(attrs), jx(count), grid, chunk=chunk)
    got = tile_render_fwd(th(attrs), th(count), tgrid(*hw), chunk=chunk)
    _assert_fwd_close(got, want, f"{hw} K={cap} C={chunk}")


@pytest.mark.parametrize("hw,cap,chunk", SWEEP)
def test_plain_backward_matches_pallas(hw, cap, chunk):
    """K2 on the same stash and cotangents; gradients within the
    reference's backward tolerance."""
    grid = jgrid(*hw)
    attrs, count = random_attrs(43, grid.num_tiles, cap, *hw, sparse=True)
    fwd = [np_(x) for x in j_fwd(jx(attrs), jx(count), grid, chunk=chunk)]
    cots = _cotangents(1, grid.num_tiles)
    want = j_bwd(jx(attrs), jx(count), jx(fwd[3]), *map(jx, cots), grid, chunk=chunk)
    got = tile_render_bwd(th(attrs), th(count), *map(th, fwd), *map(th, cots),
                          tgrid(*hw), chunk=chunk)
    np.testing.assert_allclose(np_(got), np_(want), atol=grad_atol(want))


def test_plain_kernels_stacked_views_match_pallas():
    """B=3 views stacked along the tile axis (``tiles_per_view``), the
    mapping window's single launch."""
    hw, cap, chunk, views = (32, 48), 32, 16, 3
    grid = jgrid(*hw)
    tiles = grid.num_tiles
    attrs, count = random_attrs(44, views * tiles, cap, *hw)
    kw = dict(chunk=chunk, tiles_per_view=tiles)
    want = j_fwd(jx(attrs), jx(count), grid, **kw)
    got = tile_render_fwd(th(attrs), th(count), tgrid(*hw), **kw)
    _assert_fwd_close(got, want, "stacked")
    cots = _cotangents(2, views * tiles)
    fwd = [np_(x) for x in want]
    gw = j_bwd(jx(attrs), jx(count), jx(fwd[3]), *map(jx, cots), grid, **kw)
    gg = tile_render_bwd(th(attrs), th(count), *map(th, fwd), *map(th, cots),
                         tgrid(*hw), **kw)
    np.testing.assert_allclose(np_(gg), np_(gw), atol=grad_atol(gw))


def test_plain_kernels_saturated_tiles_match_pallas():
    """Wide splats near each row's own tile: most tiles saturate and skip
    their remaining chunks (the block vote), the others blend every
    fragment; both kernels against the reference."""
    hw, cap, chunk = (32, 64), 256, 16
    grid = jgrid(*hw)
    tiles = grid.num_tiles
    attrs, count = random_attrs(45, tiles, cap, *hw, near_tile=True)
    want = j_fwd(jx(attrs), jx(count), grid, chunk=chunk)
    got = tile_render_fwd(th(attrs), th(count), tgrid(*hw), chunk=chunk)
    _assert_fwd_close(got, want, "saturated")
    fwd = [np_(x) for x in want]
    stash = fwd[3]
    last_chunk = stash[np.arange(tiles), (count - 1) // chunk * chunk]
    skipped = np.abs(last_chunk).max(axis=1) == 0.0
    saturated = np_(got[2]).max(axis=1) <= 1e-4
    assert skipped.any() and not skipped.all() and (skipped <= saturated).all()
    cots = _cotangents(3, tiles)
    gw = j_bwd(jx(attrs), jx(count), jx(stash), *map(jx, cots), grid, chunk=chunk)
    gg = tile_render_bwd(th(attrs), th(count), *map(th, fwd), *map(th, cots),
                         tgrid(*hw), chunk=chunk)
    np.testing.assert_allclose(np_(gg), np_(gw), atol=grad_atol(gw))


def _stash_replay_final_t(stash, count, chunk):
    """The final T as a separate replay pass over the stash gives it: the
    blend's transmittance chain from the stashed alphas alone, with K1's
    chunk skips (the reference backward's pass A)."""
    rows, cap, _ = stash.shape
    trips = (count + chunk - 1) // chunk
    trans = torch.ones((rows, 256), dtype=torch.float32)
    for c in range(cap // chunk):
        live = (c < trips) & (trans > TERM_EPS).any(dim=-1)
        if not bool(live.any()):
            break
        al = stash[:, c * chunk:(c + 1) * chunk]
        al = torch.where(live[:, None, None], al, torch.zeros_like(al))
        for i in range(chunk):
            am = al[:, i] * (trans > TERM_EPS).to(torch.float32)
            trans = trans * (1.0 - am)
    return trans


@pytest.mark.parametrize("hw,cap,chunk,near_tile", [
    *((hw, cap, chunk, False) for hw, cap, chunk in SWEEP),
    ((32, 64), 256, 16, True), ((64, 64), 256, 16, True)])
def test_plain_forward_final_t_is_the_stash_replay(hw, cap, chunk, near_tile):
    """K2 takes the final T from K1's outputs instead of replaying the
    stash: the two are equal bit for bit, saturated tiles included."""
    grid = tgrid(*hw)
    attrs, count = random_attrs(42, grid.num_tiles, cap, *hw, near_tile=near_tile)
    _, _, final_t, stash = tile_render_fwd(th(attrs), th(count), grid, chunk=chunk)
    assert torch.equal(final_t, _stash_replay_final_t(stash, th(count), chunk))


@pytest.mark.parametrize("chunk", [16, 32])
def test_plain_backward_near_tile_64x64_matches_pallas(chunk):
    """The single-pass K2 on saturating splats at K=256, where ``suffix =
    total - prefix`` cancels most, against the reference's two passes."""
    hw, cap = (64, 64), 256
    grid = jgrid(*hw)
    attrs, count = random_attrs(46, grid.num_tiles, cap, *hw, near_tile=True)
    fwd = [np_(x) for x in j_fwd(jx(attrs), jx(count), grid, chunk=chunk)]
    assert (fwd[2].max(axis=1) <= 1e-4).mean() > 0.5   # mostly saturated
    cots = _cotangents(4, grid.num_tiles)
    want = j_bwd(jx(attrs), jx(count), jx(fwd[3]), *map(jx, cots), grid, chunk=chunk)
    got = tile_render_bwd(th(attrs), th(count), *map(th, fwd), *map(th, cots),
                          tgrid(*hw), chunk=chunk)
    np.testing.assert_allclose(np_(got), np_(want), atol=grad_atol(want))


def _warp_reduce_scatter(vals, group):
    """numpy emulation of K2's GMU level 1 in one warp: ``vals`` (group, 32
    lanes, 10) per-pixel gradients of ``group`` fragments.  Follows
    ``backward_tile``: each slot carries up the exchange levels (lane offset
    16 >> l, the lane's bit 4 - l picks the later half), a butterfly over
    the lanes left, and each lane stores the gradients ``g`` with
    ``g % sharers == lane % sharers`` of its slot.  Returns the stored
    (group, 10) sums and how often each was stored."""
    log_g = group.bit_length() - 1
    lane = np.arange(32)
    sharers = 32 // group
    out = np.zeros((group, 10), np.float32)
    stores = np.zeros((group, 10), int)
    pend = [None] * log_g
    for s in range(group):
        v = vals[s].copy()
        ones = next(n for n in range(log_g + 1) if not (s >> n) & 1)
        for lvl in range(min(ones, log_g)):
            off = 16 >> lvl
            upper = ((lane >> (4 - lvl)) & 1).astype(bool)[:, None]
            send = np.where(upper, pend[lvl], v)
            mine = np.where(upper, v, pend[lvl])
            v = mine + send[lane ^ off]
        if ones < log_g:
            pend[ones] = v
    off = sharers // 2
    while off:
        v = v + v[lane ^ off]
        off //= 2
    slot = sum(((lane >> (4 - lvl)) & 1) << lvl for lvl in range(log_g))
    for ln in range(32):
        for g in range(10):
            if g % sharers == ln % sharers:
                out[slot[ln], g] = v[ln, g]
                stores[slot[ln], g] += 1
    return out, stores


@pytest.mark.parametrize("group", [4, 8, 16])
def test_warp_reduce_scatter_emulation_sums_each_fragment(group):
    vals = np.random.default_rng(group).normal(size=(group, 32, 10)).astype(np.float32)
    out, stores = _warp_reduce_scatter(vals, group)
    assert (stores == 1).all()
    np.testing.assert_allclose(out, vals.astype(np.float64).sum(axis=1), rtol=1e-5,
                               atol=1e-5)


def test_reduce_group_matches_the_kernel_source():
    src = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
           / "tile_render_bp.cu").read_text()
    assert int(re.search(r"constexpr int GROUP = (\d+);", src).group(1)) == REDUCE_GROUP


def _card_order_fwd(attrs, count, grid, chunk, cluster, window):
    """torch emulation of K1 on the card (``render_tile`` in
    ``csrc/tile_render.cu``), row by row: each tile's pixels split over
    ``cluster`` blocks; each block stages its row's fragments into a
    window of at most ``window`` (whole chunks; the first 64 fragments up
    front, later chunks when first needed, a new window where a chunk would
    overflow the last), reads every fragment from the window, and runs
    chunks while a vote over its own pixels finds one alive, each pixel
    evaluating and blending its fragments in order; the blocks' prefixes
    meet in a max, rows that only another block kept running are written
    from the block's own window, and zero rows fill the rest.  Returns K1's
    outputs, the number of times each stash element was written, the
    blocks whose prefix was shorter than their tile's, the blocks whose
    last window started past fragment 0, and the rows that processed more
    fragments than a window holds."""
    rows, _, cap = attrs.shape
    p = 256 // cluster
    win = cap if cap <= window else window // chunk * chunk
    trips = torch.clamp((count.long() + chunk - 1) // chunk, 0, cap // chunk).tolist()
    px, py = tile_pixel_coords(grid)
    color = torch.zeros((rows, 3, 256))
    depth = torch.zeros((rows, 256))
    final_t = torch.zeros((rows, 256))
    stash = torch.full((rows, cap, 256), float("nan"))
    writes = torch.zeros((rows, cap, 256), dtype=torch.int64)
    deferred = restarts = past = 0
    for r in range(rows):
        tile = r % grid.num_tiles
        blocks = []
        for b in range(cluster):
            sl = slice(b * p, (b + 1) * p)
            blk = dict(sl=sl, x=px[tile, sl], y=py[tile, sl], base=0,
                       buf=torch.full((NUM_ATTRS, win), float("nan")))
            blk["end"] = min(min(trips[r], -(-64 // chunk)) * chunk, win)
            blk["buf"][:, :blk["end"]] = attrs[r, :, :blk["end"]]
            blocks.append(blk)

        def stage_from(blk, k0, limit):
            if k0 + chunk > blk["base"] + win:
                blk["base"] = k0
            blk["end"] = min(limit, blk["base"] + win)
            i0, i1 = k0 - blk["base"], blk["end"] - blk["base"]
            blk["buf"][:, i0:i1] = attrs[r, :, k0:blk["end"]]

        def alpha(blk, k):
            at = blk["buf"][:, k - blk["base"]]
            dx, dy = blk["x"] - at[0], blk["y"] - at[1]
            q = at[2] * dx * dx + 2.0 * at[3] * dx * dy + at[4] * dy * dy
            a = torch.clamp(at[8] * torch.exp(-0.5 * torch.clamp(q, min=0.0)), max=ALPHA_MAX)
            keep = (a >= ALPHA_MIN) & (at[10] > 0.5)
            return torch.where(keep, a, torch.zeros_like(a))

        def put(blk, k, a):
            stash[r, k, blk["sl"]] = a
            writes[r, k, blk["sl"]] += 1

        for blk in blocks:
            acc = torch.zeros((4, p))
            trans = torch.ones(p)
            done = 0
            while done < trips[r] and bool((trans > TERM_EPS).any()):   # the vote
                k0 = done * chunk
                if k0 == blk["end"]:
                    stage_from(blk, k0, trips[r] * chunk)
                for k in range(k0, k0 + chunk):
                    a = alpha(blk, k)
                    put(blk, k, a)
                    am = a * (trans > TERM_EPS).to(torch.float32)
                    w = trans * am
                    for i, row in enumerate((5, 6, 7, 9)):
                        acc[i] = acc[i] + w * attrs[r, row, k]
                    trans = trans * (1.0 - am)
                done += 1
            blk["done"] = done
            color[r, :, blk["sl"]] = acc[:3]
            depth[r, blk["sl"]] = acc[3]
            final_t[r, blk["sl"]] = trans
        total = max(blk["done"] for blk in blocks)          # the cluster's exchange
        past += total * chunk > win
        for blk in blocks:
            deferred += blk["done"] < total
            for k0 in range(blk["done"] * chunk, total * chunk, chunk):
                if k0 == blk["end"]:
                    stage_from(blk, k0, total * chunk)
                for k in range(k0, k0 + chunk):
                    put(blk, k, alpha(blk, k))
            restarts += blk["base"] > 0
        stash[r, total * chunk:] = 0.0
        writes[r, total * chunk:] += 1
    return (color, depth, final_t, stash), writes, deferred, restarts, past


@pytest.mark.parametrize("window", [FWD_WINDOW, 32])
@pytest.mark.parametrize("cluster", [1, FWD_SPLIT])
@pytest.mark.parametrize("hw,cap,chunk,near_tile", [
    ((32, 64), 256, 16, True),    # saturated: most tiles skip their last chunks
    ((48, 48), 64, 8, False),     # sparse counts, some rows empty
    ((32, 32), 128, 32, False),
])
def test_card_order_equals_plain_forward(hw, cap, chunk, near_tile, cluster, window):
    """K1's order on the card (a block's vote over its own pixels, one
    exchange of the blocks' prefixes per tile, the deferred rows, the
    staging window) equals the plain forward bit for bit and writes each
    stash element once; a 32-fragment window makes rows restart it."""
    grid = tgrid(*hw)
    attrs, count = random_attrs(61 + cap, grid.num_tiles, cap, *hw, sparse=not near_tile,
                                near_tile=near_tile)
    attrs, count = th(attrs), th(count)
    if not near_tile:
        count[::3] = 0
    got, writes, deferred, restarts, past = _card_order_fwd(attrs, count, grid, chunk,
                                                            cluster, window)
    want = tile_render_fwd_plain(attrs, count, grid, chunk=chunk)
    for name, g, w in zip(OUT_NAMES, got, want):
        assert torch.equal(g, w), name
    assert bool((writes == 1).all())
    if near_tile and cluster > 1:   # some blocks stopped before their tile
        assert deferred > 0
    assert restarts == cluster * past     # each of a row's blocks, once it passes
    if window < cap:
        assert past > 0


def test_forward_design_constants_match_the_kernel_source():
    """The wrappers' copy of the launch shape is the kernels': a thread a
    pixel (256 / cluster threads a block), the cluster sizes the launch
    switches take (one block or :data:`FWD_SPLIT`), the staging window and
    the widest chunk."""
    src = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
           / "tile_render.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("TILE") ** 2 == FWD_THREADS
    assert re.search(r"constexpr int PIX = TILE \* TILE;", src)
    assert re.search(r"__launch_bounds__\(PIX / CLUSTER, 1\)", src)
    assert const("WINDOW") == FWD_WINDOW
    assert const("MAX_CHUNK") == MAX_CHUNK
    for kind in ("fwd", "sched"):
        cases = re.findall(rf"case (\d+): return launch_{kind}<(\d+)>", src)
        assert [tuple(map(int, c)) for c in cases] == [(1, 1), (FWD_SPLIT, FWD_SPLIT)]


@pytest.mark.parametrize("blocks,sms,want", [
    (70, 132, 2), (280, 132, 1), (1200, 132, 1), (4800, 132, 1),   # K1: tiles
    (35, 132, 2), (140, 132, 2), (600, 132, 1), (2400, 132, 1),   # K4: pairs
    (263, 132, 2), (264, 132, 1), (1, 132, 2), (0, 132, 2), (70, 16, 1)])
def test_forward_cluster_choice(blocks, sms, want):
    """Two blocks a tile (pair) below two tiles (pairs) per SM, else one."""
    assert fwd_cluster(blocks, sms) == want


@pytest.mark.parametrize("bad", ["color", "depth", "final_t"])
def test_bwd_wrapper_rejects_bad_forward_outputs(bad):
    grid = tgrid(16, 32)
    attrs, count = random_attrs(5, grid.num_tiles, 16, 16, 32)
    fwd = list(tile_render_fwd(th(attrs), th(count), grid, chunk=8))
    i = ("color", "depth", "final_t").index(bad)
    fwd[i] = fwd[i][:1]
    with pytest.raises(ValueError, match=bad):
        tile_render_bwd(th(attrs), th(count), *fwd, *map(th, _cotangents(0, 2)),
                        grid, chunk=8)


def test_empty_tiles_render_background():
    grid = tgrid(32, 32)
    attrs, count = random_attrs(0, grid.num_tiles, 16, 32, 32)
    attrs[:, 10] = 0.0
    color, depth, final_t, stash = tile_render_fwd(
        th(attrs), th(np.zeros_like(count)), grid, chunk=8)
    assert float(color.abs().max()) == 0.0 and float(stash.abs().max()) == 0.0
    np.testing.assert_allclose(np_(final_t), 1.0)


def test_wrappers_count_plain_runs_on_cpu_and_no_launches():
    grid = tgrid(16, 32)
    attrs, count = random_attrs(5, grid.num_tiles, 16, 16, 32)
    before = (tile_render_fwd.launches, tile_render_bwd.launches,
              tile_render_fwd_plain.calls, tile_render_bwd_plain.calls)
    out = tile_render_fwd(th(attrs), th(count), grid, chunk=8)
    tile_render_bwd(th(attrs), th(count), *out, *map(th, _cotangents(0, 2)),
                    grid, chunk=8)
    after = (tile_render_fwd.launches, tile_render_bwd.launches,
             tile_render_fwd_plain.calls, tile_render_bwd_plain.calls)
    assert after == (before[0], before[1], before[2] + 1, before[3] + 1)


@pytest.mark.parametrize("bad", ["dtype", "attrs_rows", "count_shape", "chunk",
                                 "views", "device"])
def test_wrappers_reject_bad_operands(bad):
    grid = tgrid(16, 32)
    attrs, count = th(random_attrs(6, 2, 16, 16, 32)[0]), th(np.full(2, 9, np.int32))
    kw = dict(chunk=8)
    if bad == "dtype":
        attrs = attrs.double()
    elif bad == "attrs_rows":
        attrs = attrs[:, :11]
    elif bad == "count_shape":
        count = count[:1]
    elif bad == "chunk":
        kw["chunk"] = 5
    elif bad == "views":
        kw["tiles_per_view"] = 3
    elif bad == "device":  # neither the CPU nor a card: no kernel, no fallback
        attrs, count = attrs.to("meta"), count.to("meta")
    with pytest.raises((TypeError, ValueError)):
        tile_render_fwd(attrs, count, grid, **kw)


@pytest.mark.parametrize("m,n,seed", [(1, 3, 0), (57, 5, 1), (300, 40, 2),
                                      (2048, 600, 3)])
def test_gmu_segment_merge_matches_reference(m, n, seed):
    r = np.random.default_rng(seed)
    ids = r.integers(-1, n, m).astype(np.int32)
    vals = r.normal(size=(m, 10)).astype(np.float32)
    want = jgmu.segment_merge(jx(vals), jx(ids), n)
    got = tgmu.segment_merge(th(vals), th(ids), n)
    # Run sums come out of prefix-sum differences, so the error grows with
    # the running sum: the reference's own GMU test bound (atol 1e-4).
    np.testing.assert_allclose(np_(got), np_(want), atol=1e-4)
    flat = tgmu.segment_merge_scatter(th(vals), th(ids), n)
    np.testing.assert_allclose(np_(flat), np_(jgmu.segment_merge_scatter(
        jx(vals), jx(ids), n)), atol=1e-4)
