"""Parity of the port's kernels K1 (forward tile rasterizer) and K2
(backward) with ``repro``'s Pallas kernels run in interpret mode, at the
shape sweep of ``tests/test_kernels.py`` and its tolerances; GMU level 2
against ``repro.kernels.gmu``; the premise of K2's single pass over the
stash (K1's final T is the stash replay's, bit for bit); a numpy emulation
of K2's warp reduce-scatter; and the wrappers' checks.  The CUDA kernels
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
from repro_torch.kernels.tile_render import tile_render_fwd, tile_render_fwd_plain
from repro_torch.kernels.ref import TERM_EPS
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
