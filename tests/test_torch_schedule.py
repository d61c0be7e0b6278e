"""Parity of the port's WSU path with ``repro``'s: the schedule builders
(bitwise), the plain versions of K4 and K5 against the reference's
scheduled Pallas kernels in interpret mode, the ``schedule`` raster
backend, K3's scan and the GMU merge through K3's merge, and a whole CPU session on the
``schedule`` backend against the same session on ``kernel``.  The
engine's scheduled phases are in ``test_torch_schedule_engine.py``.

The scheduled kernels on the card are held against K1 and K2 bit for bit by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.  On the CPU the plain
versions are held within the reference's kernel tolerances instead: CPU
``torch.exp`` is not always repeatable (ROADMAP, Queue 3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _kernel_inputs import merge_case_ids, random_attrs
from _torch_parity import (
    DEPTH_TOL, FWD_ATOL, FWD_RTOL, assert_grads_close, grad_atol, jx, np_, th,
    tiny_cloud,
)
from _torch_parity import first_cpu_exp_spent  # noqa: F401  (autouse fixture)
from _torch_parity import one_cpu_thread  # noqa: F401  (autouse fixture)
from repro.core import gaussians as JG
from repro.core import schedule as jsched
from repro.core.camera import Camera as JCamera
from repro.core.camera import Intrinsics as JIntr
from repro.core.camera import look_at as jlook_at
from repro.core.projection import project as jproject
from repro.core.raster_api import RasterInputs as JInputs
from repro.core.raster_api import RasterPlan as JPlan
from repro.core.sorting import FragmentLists as JFrags
from repro.core.sorting import balanced_pair_permutation as j_bpp
from repro.core.sorting import build_fragment_lists as jbuild
from repro.core.sorting import make_tile_grid as jgrid
from repro.kernels import gmu as jgmu
from repro.kernels import ops as jops
from repro.kernels.tile_render import tile_render_fwd_sched as j_fwd_sched
from repro.kernels.tile_render_bp import tile_render_bwd_sched as j_bwd_sched
from repro.slam import metrics as jmetrics
from repro.slam.datasets import make_dataset as jmake_dataset
from repro_torch import convert
from repro_torch.core import schedule as tsched
from repro_torch.core.keyframes import KeyframePolicy as TPolicy
from repro_torch.core.raster_api import RasterInputs as TInputs
from repro_torch.core.raster_api import RasterPlan as TPlan
from repro_torch.core.sorting import FragmentLists
from repro_torch.core.sorting import balanced_pair_permutation as t_bpp
from repro_torch.core.sorting import make_tile_grid as tgrid
from repro_torch.kernels import gmu as tgmu
from repro_torch.kernels import ops as tops
from repro_torch.kernels.tile_render import (
    tile_render_fwd_sched, tile_render_fwd_sched_plain,
)
from repro_torch.kernels.tile_render_bp import (
    tile_render_bwd_sched, tile_render_bwd_sched_plain,
)
from repro_torch.slam import metrics as tmetrics
from repro_torch.slam import session as tsession

OUT_NAMES = ("color", "depth", "final_T", "stash")


def _counts(t, seed, tied):
    """(T,) int32 counts; ``tied`` draws from 0..3 so equal counts abound."""
    r = np.random.default_rng(seed)
    return r.integers(0, 4 if tied else 65, t).astype(np.int32)


# ---------------------------------------------------------------------------
# schedule construction: bitwise against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("t", [1, 2, 3, 9, 16, 1200])
def test_balanced_pair_permutation_bitwise(t, tied):
    count = _counts(t, t, tied)
    perm_j, load_j = j_bpp(jx(count))
    perm_t, load_t = t_bpp(th(count))
    assert perm_t.dtype == load_t.dtype == torch.int32
    assert np.array_equal(np_(perm_t), np.asarray(perm_j))
    assert np.array_equal(np_(load_t), np.asarray(load_j))


@pytest.mark.parametrize("bucket", [1, 2])
@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("t", [3, 9, 16, 1200])
def test_build_schedule_and_counters_bitwise(t, tied, bucket):
    count = _counts(t, 100 + t, tied)
    chunk, max_trips = 8, 64 // 8
    want = jsched.build_schedule(jx(count), chunk, bucket=bucket, max_trips=max_trips)
    got = tsched.build_schedule(th(count), chunk, bucket=bucket, max_trips=max_trips)
    for name in tsched.TileSchedule._fields:
        g = getattr(got, name)
        assert g.dtype == torch.int32, name
        assert np.array_equal(np_(g), np.asarray(getattr(want, name))), name
    assert np.array_equal(np_(tsched.pair_loads(got)), np.asarray(jsched.pair_loads(want)))
    assert int(tsched.active_programs(got)) == int(jsched.active_programs(want))
    assert int(tsched.scheduled_trips(got)) == int(jsched.scheduled_trips(want))
    assert int(tsched.active_tile_programs(th(count))) == int(
        jsched.active_tile_programs(jx(count)))


def test_schedule_from_order_bitwise_and_bucket_needs_bound():
    count = _counts(16, 5, False)
    order = np.random.default_rng(6).permutation(16).astype(np.int32)
    want = jsched.schedule_from_order(jx(order), jx(count), 8)
    got = tsched.schedule_from_order(th(order), th(count), 8)
    for name in tsched.TileSchedule._fields:
        assert np.array_equal(np_(getattr(got, name)), np.asarray(getattr(want, name)))
    with pytest.raises(ValueError, match="max_trips"):
        tsched.build_schedule(th(count), 8, bucket=2)


# ---------------------------------------------------------------------------
# plain K4 / K5 against the reference's scheduled Pallas kernels
# ---------------------------------------------------------------------------


def _sched_inputs(hw, cap, chunk, views, seed, empty=0.0):
    """Packed attrs of ``views`` stacked views with empty and full tiles,
    and their flattened schedule (per-view perms offset to global rows).
    ``empty`` empties that share of the tiles besides, as a
    stability-masked build does (attrs zero, count 0)."""
    grid = jgrid(*hw)
    tiles = grid.num_tiles
    attrs, count = random_attrs(seed, views * tiles, cap, *hw, sparse=True)
    gone = np.random.default_rng(seed).uniform(size=count.shape) < empty
    attrs[gone] = 0.0
    count[gone] = 0
    count[0], count[1] = 0, cap
    attrs[:, 10] = (np.arange(cap)[None, :] < count[:, None]).astype(np.float32)
    perms, trips = [], []
    for b in range(views):
        s = jsched.build_schedule(jx(count[b * tiles:(b + 1) * tiles]), chunk,
                                  max_trips=cap // chunk)
        perms.append(np.asarray(s.perm) + b * tiles)
        trips.append(np.asarray(s.trips))
    return grid, attrs, np.concatenate(perms).astype(np.int32), np.concatenate(trips)


@pytest.mark.parametrize("hw,cap,chunk,views", [
    ((48, 48), 32, 8, 1),     # 9 tiles: slot 1 is the zero-work pad
    ((64, 64), 32, 8, 1),
    ((48, 48), 32, 8, 2),     # two stacked views, each with its pad slot
])
def test_plain_sched_kernels_match_pallas(hw, cap, chunk, views):
    _check_plain_sched_kernels(hw, cap, chunk, views, 0.0)


def test_plain_sched_kernels_on_empty_tiles_match_pallas():
    """Most tiles empty, as a stability-masked build leaves them: the
    heavy-light fold pairs empty tiles with each other into zero-trip
    blocks."""
    _check_plain_sched_kernels((64, 64), 32, 8, 2, 0.7)


def _check_plain_sched_kernels(hw, cap, chunk, views, empty):
    """Plain K4/K5 against the interpreted scheduled Pallas kernels, with
    cotangents on every pixel.  Slots with no trips (the pad, empty tiles)
    render color 0, depth 0 and final T 1 and get zero gradients."""
    grid, attrs, perm, trips = _sched_inputs(hw, cap, chunk, views, 11, empty)
    if empty:   # the heavy-light fold pairs empty tiles with each other
        assert (trips.reshape(-1, 2) == 0).all(1).any()
    tiles = grid.num_tiles
    kw_j = dict(chunk=chunk, tiles_per_view=tiles)
    want = j_fwd_sched(jx(attrs), jx(perm), jx(trips), grid, **kw_j)
    before = tile_render_fwd_sched_plain.calls
    got = tile_render_fwd_sched(th(attrs), th(perm), th(trips), tgrid(*hw),
                                chunk=chunk, tiles_per_view=tiles)
    assert tile_render_fwd_sched_plain.calls == before + 1
    for name, g, w in zip(OUT_NAMES, got, want):
        tol = DEPTH_TOL if name == "depth" else FWD_ATOL
        rtol = DEPTH_TOL if name == "depth" else FWD_RTOL
        np.testing.assert_allclose(np_(g), np.asarray(w), atol=tol, rtol=rtol,
                                   err_msg=name)
    idle = trips == 0
    np.testing.assert_array_equal(np_(got[2])[idle], 1.0)
    assert not np_(got[0])[idle].any() and not np_(got[1])[idle].any()
    assert not np_(got[3])[idle].any()

    r = np.random.default_rng(12)
    slots = perm.shape[0]
    cots = (r.normal(size=(slots, 3, 256)).astype(np.float32),
            r.normal(size=(slots, 256)).astype(np.float32),
            r.normal(size=(slots, 256)).astype(np.float32))
    stash = np.asarray(want[3])
    g_want = j_bwd_sched(jx(attrs), jx(perm), jx(trips), jx(stash),
                         *(jx(c) for c in cots), grid, **kw_j)
    before = tile_render_bwd_sched_plain.calls
    # K5 takes the reference forward's four outputs, in slot order.
    g_got = tile_render_bwd_sched(th(attrs), th(perm), th(trips),
                                  *(th(np.asarray(x)) for x in want),
                                  *(th(c) for c in cots), tgrid(*hw),
                                  chunk=chunk, tiles_per_view=tiles)
    assert tile_render_bwd_sched_plain.calls == before + 1
    np.testing.assert_allclose(np_(g_got), np.asarray(g_want),
                               atol=grad_atol(g_want))
    assert not np_(g_got)[idle].any()


@pytest.mark.parametrize("bad", ["perm_dtype", "odd_slots", "few_slots",
                                 "perm_range", "trips_range", "trips_shape"])
def test_sched_wrappers_reject_bad_operands(bad):
    grid = tgrid(32, 32)
    attrs, count = random_attrs(3, grid.num_tiles, 32, 32, 32)
    sched = tsched.build_schedule(th(count), 16, max_trips=2)
    perm, trips = sched.perm, sched.trips
    if bad == "perm_dtype":
        perm = perm.long()
    elif bad == "odd_slots":
        perm, trips = torch.cat([perm, perm[:1]]), torch.cat([trips, trips[:1]])
    elif bad == "few_slots":
        perm, trips = perm[:2], trips[:2]
    elif bad == "perm_range":
        perm = perm.clone()
        perm[3] = grid.num_tiles
    elif bad == "trips_range":
        trips = trips.clone()
        trips[0] = 3
    else:
        trips = trips[:-2]
    with pytest.raises((TypeError, ValueError)):
        tile_render_fwd_sched(th(attrs), perm, trips, grid, chunk=16)


# ---------------------------------------------------------------------------
# the schedule backend against the reference's, and K3
# ---------------------------------------------------------------------------


HW, CAP, CHUNK = 48, 32, 8  # 9 tiles: odd, so the pad slot is on the path
INTR = dict(fx=60.0, fy=60.0, cx=24.0, cy=24.0, width=HW, height=HW)
RASTER_LEAVES = ("mu2d", "conic", "color", "opacity", "depth")


def _raster_scene():
    pts, cols, cap = tiny_cloud(2)
    g_j = JG.from_points(jx(pts), jx(cols), capacity=cap, scale=0.08, opacity=0.8)
    w2c = jlook_at(jnp.zeros(3), jnp.array([0.0, 0.0, 3.0]), jnp.array([0.0, -1.0, 0.0]))
    proj = jproject(g_j, JCamera(JIntr(**INTR), w2c))
    return proj, jbuild(proj, jgrid(HW, HW), CAP)


def test_schedule_backend_matches_reference():
    """Images and the gradients of every raster input through the port's
    ``schedule`` backend (plain K4/K5) against the reference's ``schedule``
    backend (interpreted Pallas)."""
    proj, frags = _raster_scene()
    target = np.random.default_rng(4).uniform(size=(HW, HW, 3)).astype(np.float32)
    leaves_j = [getattr(proj, k) for k in RASTER_LEAVES]

    def loss_j(*leaves):
        img, dep, ft = jops.rasterize(
            JInputs(*leaves, frags=frags),
            JPlan(grid=jgrid(HW, HW), backend="schedule", capacity=CAP,
                  chunk=CHUNK))
        return (jnp.mean((img - jx(target)) ** 2) + 0.1 * jnp.mean(dep)
                + 0.05 * jnp.mean(ft)), (img, dep, ft)

    (_, out_j), g_j = jax.jit(jax.value_and_grad(
        loss_j, argnums=(0, 1, 2, 3, 4), has_aux=True))(*leaves_j)
    leaves_t = [th(np.asarray(x), requires_grad=True) for x in leaves_j]
    frags_t = FragmentLists(*(th(np.asarray(x)) for x in frags))
    img, dep, ft = tops.rasterize(
        TInputs(*leaves_t, frags=frags_t),
        TPlan(grid=tgrid(HW, HW), backend="schedule", capacity=CAP, chunk=CHUNK))
    loss = ((img - th(target)) ** 2).mean() + 0.1 * dep.mean() + 0.05 * ft.mean()
    g_t = torch.autograd.grad(loss, leaves_t)
    for name, a, b, tol, rtol in (("image", img, out_j[0], FWD_ATOL, FWD_RTOL),
                                  ("depth", dep, out_j[1], DEPTH_TOL, DEPTH_TOL),
                                  ("final_T", ft, out_j[2], FWD_ATOL, FWD_RTOL)):
        np.testing.assert_allclose(np_(a), np.asarray(b), atol=tol, rtol=rtol,
                                   err_msg=name)
    assert_grads_close(g_j, g_t, RASTER_LEAVES)


def test_schedule_backend_checks_the_carried_schedule():
    proj, frags = _raster_scene()
    frags_t = FragmentLists(*(th(np.asarray(x)) for x in frags))
    inputs = TInputs(*(th(np.asarray(getattr(proj, k))) for k in RASTER_LEAVES),
                     frags=frags_t)
    plan = TPlan(grid=tgrid(HW, HW), backend="schedule", capacity=CAP)
    batched = tops.build_plan_schedule(
        FragmentLists(*(x[None] for x in frags_t)), plan)
    with pytest.raises(ValueError, match="single-view"):
        tops.rasterize(inputs, plan.with_sched(batched))
    # A carried schedule equals the one the backend builds itself.
    own = tops.rasterize(inputs, plan)
    carried = tops.rasterize(inputs, plan.with_sched(tops.build_plan_schedule(
        frags_t, plan)))
    for a, b in zip(own, carried):
        assert torch.equal(a, b)


@pytest.mark.parametrize("m,g", [(256, 1), (1024, 8), (4096, 10)])
def test_block_cumsum_plain_matches_pallas(m, g):
    x = np.random.default_rng(m + g).normal(size=(m, g)).astype(np.float32)
    want = jgmu.block_cumsum(jx(x), block=256)
    before = tgmu.block_cumsum_plain.calls
    got = tgmu.block_cumsum(th(x))
    assert tgmu.block_cumsum_plain.calls == before + 1
    # The reference's own bound for its kernel against numpy's cumsum.
    np.testing.assert_allclose(np_(got), np.asarray(want), atol=1e-3, rtol=1e-5)
    with pytest.raises(ValueError, match="multiple"):
        tgmu.block_cumsum(th(x[:-1]))


def _k3_order_emulation(x):
    """K3's additions one float32 at a time, in ``csrc/gmu.cu``'s order:
    a log-step scan per 32-row warp, earlier warp totals summed in turn;
    each block's carry ``run + (incl - total)``, with ``incl`` a log-step
    scan of the block totals in each group of 32 blocks (pass 1's last
    block in the group) and ``run`` the earlier groups' totals summed in
    turn (the view's last group)."""
    f = np.float32

    def warp_scan(v):
        for off in (1, 2, 4, 8, 16):
            v = np.concatenate([v[:off], v[off:] + v[:-off]]).astype(np.float32)
        return v

    nb, g = x.shape[0] // 256, x.shape[1]
    local = np.zeros_like(x)
    for b in range(nb):
        for c in range(g):
            warps = [warp_scan(x[b * 256 + w * 32:b * 256 + (w + 1) * 32, c])
                     for w in range(8)]
            before = f(0)
            for w in range(8):
                local[b * 256 + w * 32:b * 256 + (w + 1) * 32, c] = before + warps[w]
                before = f(before + warps[w][31])
    totals = local[255::256]
    carry = np.zeros((nb, g), np.float32)
    for c in range(g):
        run = f(0)
        for base in range(0, nb, 32):
            xs = np.zeros(32, np.float32)
            xs[:min(32, nb - base)] = totals[base:base + 32, c]
            incl = warp_scan(xs)
            n = min(32, nb - base)
            carry[base:base + n, c] = run + (incl - xs)[:n]
            run = f(run + incl[31])
    return local + np.repeat(carry, 256, axis=0)


def test_block_cumsum_plain_adds_in_the_kernel_order():
    """The plain K3 equals a one-add-at-a-time emulation of the kernel's
    order bit for bit (33 blocks: the carry scan crosses a 32-block step);
    on the card K3 equals the plain version bit for bit
    (``test_torch_cuda.py``)."""
    x = np.random.default_rng(8).normal(size=(33 * 256, 2)).astype(np.float32)
    assert np.array_equal(np_(tgmu.block_cumsum(th(x))), _k3_order_emulation(x))


@pytest.mark.parametrize("m,n,seed,kind", [
    (1, 3, 0, "random"), (300, 20, 1, "random"), (2048, 600, 3, "random"),
    (1000, 50, 4, "random"),       # M not a multiple of the block
    (700, 40, 5, "padding"), (1500, 1200, 6, "singles"), (2000, 30, 7, "long"),
])
def test_segment_merge_kernel_path_matches_pallas_path(m, n, seed, kind):
    """The port's merge is K3's merge (here its plain version) and agrees
    with the reference's merge on both of its prefix sums."""
    r = np.random.default_rng(seed)
    ids = merge_case_ids(kind, m, n, seed)
    vals = r.normal(size=(m, 10)).astype(np.float32)
    before = tgmu.merge_runs_plain.calls
    got = tgmu.segment_merge(th(vals), th(ids), n)
    assert tgmu.merge_runs_plain.calls == before + 1
    # The reference's own GMU bound (tests/test_kernels.py, atol 1e-4).
    for use_pallas in (True, False):
        want = jgmu.segment_merge(jx(vals), jx(ids), n, use_pallas=use_pallas)
        np.testing.assert_allclose(np_(got), np.asarray(want), atol=1e-4)


def test_imbalance_stats_match():
    loads = _counts(1200, 9, False)
    for a, b in zip(tmetrics.imbalance_stats(th(loads)),
                    jmetrics.imbalance_stats(jx(loads))):
        assert a == pytest.approx(b, rel=1e-12)


# ---------------------------------------------------------------------------
# whole sessions (the engine's phases: test_torch_schedule_engine.py)
# ---------------------------------------------------------------------------


SESSION_CFG = dict(iters_track=3, iters_map=4, capacity=1024, frag_capacity=48,
                   map_window=2)


@pytest.fixture(scope="module")
def cpu_sessions():
    """The same 6-frame 64x64 port session on ``schedule`` and ``kernel``."""
    ds_j = jmake_dataset("room0", num_frames=6, height=64, width=64,
                         num_gaussians=400, frag_capacity=48)
    ds_t = convert.dataset_from_numpy(ds_j, device="cpu")
    rng = np.random.default_rng(5)
    perms = {i: torch.as_tensor(rng.permutation(2 * 384)) for i in range(1, 6)}
    out = {}
    for backend in ("schedule", "kernel"):
        cfg = tsession.SLAMConfig(backend=backend, keyframe=TPolicy(interval=2),
                                  **SESSION_CFG)
        sess = tsession.session_init(ds_t, cfg, device="cpu")
        for idx in range(1, 6):
            sess, _ = tsession.session_step(sess, ds_t.frames[idx], perm=perms[idx])
        out[backend] = (sess, tsession.session_finalize(
            sess, gt_w2c=[f.w2c_gt for f in ds_t.frames]))
    return out


def test_schedule_session_matches_kernel_session(cpu_sessions):
    (s_s, r_s), (s_k, r_k) = cpu_sessions["schedule"], cpu_sessions["kernel"]
    assert len(r_s.keyframe_psnr) == len(r_k.keyframe_psnr) == 3
    for a, b in zip(r_s.est_w2c, r_k.est_w2c):
        np.testing.assert_allclose(a, b, atol=1e-5)
    assert r_s.alive_per_frame == r_k.alive_per_frame
    for f in ("fragments", "pixels", "iterations", "frag_build_rows"):
        assert getattr(r_s.work, f) == getattr(r_k.work, f), f


def test_only_the_schedule_backend_builds_schedules(cpu_sessions):
    """The session stages schedule only on the WSU backend; trip bucketing
    other than 1 is not ported and raises."""
    s_s, s_k = cpu_sessions["schedule"][0], cpu_sessions["kernel"][0]
    assert s_s.stage.scheduled and not s_k.stage.scheduled
    tsession.SLAMConfig(backend="schedule", sched_bucket=1)
    for bucket in (0, 2):
        with pytest.raises(NotImplementedError, match="sched_bucket"):
            tsession.SLAMConfig(backend="schedule", sched_bucket=bucket)


@pytest.mark.parametrize("views", [None, 3])
def test_build_plan_schedule_matches_reference(views):
    """Per-view schedules of one view or of stacked views, bitwise."""
    hw = (48, 64)
    tiles = tgrid(*hw).num_tiles
    count = _counts((views or 1) * tiles, 21, True).reshape(views or 1, tiles)
    count = count[0] if views is None else count
    leaves = dict(idx=np.zeros(count.shape + (CAP,), np.int32), count=count,
                  overflow=np.zeros(count.shape[:-1], np.int32),
                  total=count.sum(-1).astype(np.int32))
    want = jops.build_plan_schedule(
        JFrags(**{k: jx(v) for k, v in leaves.items()}),
        JPlan(grid=jgrid(*hw), backend="schedule", capacity=CAP, chunk=CHUNK))
    got = tops.build_plan_schedule(
        FragmentLists(**{k: th(v) for k, v in leaves.items()}),
        TPlan(grid=tgrid(*hw), backend="schedule", capacity=CAP, chunk=CHUNK))
    for name in tsched.TileSchedule._fields:
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        assert g.dtype == torch.int32 and g.shape == w.shape, name
        assert np.array_equal(np_(g), w), name
