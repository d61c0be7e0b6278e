"""PagedMap in the port (``repro_torch/slam/map/paged.py``) against the
reference's (``repro/slam/map/paged.py``), and the paged session on the
CPU.

* Each function of the port's ``paged.py`` and the view helpers
  (``pruning`` / ``optimizer`` ``gather_rows`` / ``scatter_rows``,
  ``sorting.remap_fragment_rows``) equals the reference's bit for bit on
  inputs made from a seed with numpy (``frustum_planes`` and
  ``page_distances``, whose 3-long dot products each library rounds its
  own way, within ulps, and the visibility tests on them bit for bit on
  inputs clear of a tie), and the reference's own unit cases
  (``tests/test_paged.py:87-187``) hold in the port.
* The paged session (``tests/test_paged.py:223-328`` in the port): with
  every page selected it equals the flat session bit for bit on every
  path (``kernel``, ``schedule``, pruning on and off, sparse mapping, the
  other base algorithms) with the same dispatches, syncs and replays; a
  partial view spills densification into nursery pages where a flat pool
  of the same size drops it; pruning across pages keeps the alive count
  exact; paged pool rows equal their solo runs bit for bit.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _session_state import same_session
from _torch_parity import np_, th
from repro.core import gaussians as JG
from repro.core import pruning as jpruning
from repro.core import sorting as jsort
from repro.core.camera import Intrinsics as JIntr
from repro.slam.map import paged as jpaged
from repro.train import optimizer as joptim
from repro_torch import convert
from repro_torch.core import gaussians as TG
from repro_torch.core import pruning as tpruning
from repro_torch.core import sorting as tsort
from repro_torch.core.camera import Intrinsics as TIntr
from repro_torch.core.camera import look_at as tlook_at
from repro_torch.core.keyframes import KeyframePolicy
from repro_torch.core.pruning import PruneConfig
from repro_torch.slam import session as S
from repro_torch.slam.datasets import make_dataset
from repro_torch.slam.graphs import EngineStats
from repro_torch.slam.map import paged as tpaged
from repro_torch.train import optimizer as toptim

INTR = dict(fx=60.0, fy=60.0, cx=32.0, cy=24.0, width=64, height=48)


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _same(port, ref):
    a, b = np_(port), np.asarray(ref)
    return a.shape == b.shape and np.array_equal(a, b.astype(a.dtype), equal_nan=True)


def _np_field(seed, n, alive_frac=0.5, spread=4.0):
    r = np.random.default_rng(seed)
    alive = np.zeros((n,), bool)
    alive[: int(n * alive_frac)] = True
    r.shuffle(alive)
    return dict(mu=r.uniform(-spread, spread, (n, 3)).astype(np.float32),
                log_scale=r.normal(size=(n, 3)).astype(np.float32),
                quat=r.normal(size=(n, 4)).astype(np.float32),
                logit_o=r.normal(size=(n,)).astype(np.float32),
                color=r.normal(size=(n, 3)).astype(np.float32), alive=alive)


def _fields(arrays):
    return (JG.GaussianField(**{k: jnp.asarray(v) for k, v in arrays.items()}),
            TG.GaussianField(**{k: th(v) for k, v in arrays.items()}))


def _poses(seed, n):
    """World-to-camera poses around the origin, looking in random
    directions (some at the cloud, some away)."""
    r = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        eye = r.uniform(-3.0, 3.0, 3).astype(np.float32)
        target = r.uniform(-3.0, 3.0, 3).astype(np.float32)
        out.append(np_(tlook_at(th(eye), th(target), th(np.array([0.0, -1.0, 0.0],
                                                                np.float32)))))
    return np.stack(out).astype(np.float32)


# ---------------------------------------------------------------------------
# the functions, bit for bit against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spread", [4.0, 300.0])
def test_morton_keys_match(spread):
    """30-bit keys, positions inside and far outside the 10-bit span."""
    mu = np.random.default_rng(3).uniform(-spread, spread, (4096, 3)).astype(np.float32)
    for cell in (0.25, 0.1):
        assert _same(tpaged.morton_keys(th(mu), cell),
                     jpaged.morton_keys(jnp.asarray(mu), cell))


@pytest.mark.parametrize("n,c,alive_frac", [(256, 32, 0.5), (1024, 128, 0.9),
                                            (512, 64, 0.0)])
def test_build_page_table_matches(n, c, alive_frac):
    """``row2page``, the AABBs (+-inf for empty pages) and the occupancy;
    then the reference's own invariants: C rows per page, occupancy = alive
    members, nursery pages last, AABBs bound their members."""
    arrays = _np_field(n + c, n, alive_frac)
    gj, gt = _fields(arrays)
    pcfg_j, pcfg_t = jpaged.PagedConfig(page_capacity=c), tpaged.PagedConfig(page_capacity=c)
    tj, tt = jpaged.build_page_table(gj, pcfg_j), tpaged.build_page_table(gt, pcfg_t)
    for f in tpaged.PageTable._fields:
        assert _same(getattr(tt, f), getattr(tj, f)), f
    r2p, occ = np_(tt.row2page), np_(tt.occupancy)
    alive, mu = arrays["alive"], arrays["mu"]
    p = n // c
    assert np.array_equal(np.bincount(r2p, minlength=p), np.full((p,), c))
    assert occ.sum() == alive.sum()
    nonempty = np.nonzero(occ)[0]
    if len(nonempty):
        assert occ[: len(nonempty)].min() > 0
    lo, hi = np_(tt.lo), np_(tt.hi)
    for pg in nonempty:
        m = alive & (r2p == pg)
        assert (mu[m] >= lo[pg]).all() and (mu[m] <= hi[pg]).all()


def _ulp_close(port, ref, scale):
    """Within 4 float32 epsilons of ``scale``, the sum of the magnitudes
    of the terms summed: the reference's XLA dot fuses its multiply-adds,
    the port's BLAS rounds each shape its own way, and each rounds at most
    twice a 3-long sum."""
    a, b = np_(port).astype(np.float64), np.asarray(ref, np.float64)
    assert a.shape == b.shape
    tol = 4 * np.finfo(np.float32).eps * np.asarray(scale, np.float64)
    assert (np.abs(a - b) <= tol).all(), np.abs(a - b).max()


def _plane_gaps(table, intr, poses, margin):
    """The smallest distance, over pages and planes, of a p-vertex test
    from its threshold (float64): the boolean tests are compared bit for
    bit only on inputs far from a tie."""
    n_cam = np.array([[0.0, 0.0, 1.0], [intr.fx, 0.0, intr.cx],
                      [-intr.fx, 0.0, intr.width - intr.cx], [0.0, intr.fy, intr.cy],
                      [0.0, -intr.fy, intr.height - intr.cy]])
    lo, hi = np_(table.lo).astype(np.float64), np_(table.hi).astype(np.float64)
    live = np.isfinite(lo).all(-1)
    gaps = []
    for w2c in np.asarray(poses, np.float64):
        m = n_cam @ w2c[:3, :3]
        b = np.array([0.05, 0, 0, 0, 0]) - n_cam @ w2c[:3, 3]
        v = np.where(m[:, None, :] > 0, hi[None], lo[None])
        gaps.append(np.abs((m[:, None, :] * v).sum(-1) - (b[:, None] - margin))[:, live])
    return np.concatenate(gaps, axis=None).min()


def test_frustum_and_visibility_match():
    """``frustum_planes`` per camera within ulps of the reference's, and
    ``pages_visible`` bit for bit over a batch of cameras (some seeing the
    cloud, some not), margins 0 and 0.5, on inputs whose every p-vertex
    test lies well clear of its threshold."""
    arrays = _np_field(7, 2048, 0.6)
    gj, gt = _fields(arrays)
    tj = jpaged.build_page_table(gj, jpaged.PagedConfig(page_capacity=64))
    tt = tpaged.build_page_table(gt, tpaged.PagedConfig(page_capacity=64))
    intr_j, intr_t = JIntr(**INTR), TIntr(**INTR)
    poses = _poses(11, 6)
    for w2c in poses:
        mj, bj = jpaged.frustum_planes(intr_j, jnp.asarray(w2c))
        mt, bt = tpaged.frustum_planes(intr_t, th(w2c))
        n_abs = np.abs(np_(tpaged.frustum_planes(intr_t, torch.eye(4))[0]))
        _ulp_close(mt, mj, n_abs @ np.abs(w2c[:3, :3]))
        _ulp_close(bt, bj, 0.05 + n_abs @ np.abs(w2c[:3, 3]))
    seen = []
    for margin in (0.0, 0.5):
        assert _plane_gaps(tt, intr_t, poses, margin) > 1e-4
        for b in (1, 3, 6):
            vj = jpaged.pages_visible(tj, intr_j, jnp.asarray(poses[:b]), margin=margin)
            vt = tpaged.pages_visible(tt, intr_t, th(poses[:b]), margin=margin)
            assert _same(vt, vj)
            seen.append(int(np_(vt).sum()))
    assert 0 < max(seen) < 2048 // 64     # some pages seen, not all


def test_empty_page_is_never_visible():
    """The reference's case: the one alive page straight ahead is seen,
    nursery pages never are, and a camera looking away sees nothing."""
    n, c = 128, 32
    mu = np.zeros((n, 3), np.float32)
    mu[:, 2] = 3.0
    alive = np.zeros((n,), bool)
    alive[:c] = True
    arrays = dict(_np_field(0, n), mu=mu, alive=alive)
    _, gt = _fields(arrays)
    table = tpaged.build_page_table(gt, tpaged.PagedConfig(page_capacity=c))
    intr = TIntr(**INTR)
    vis, occ = np_(tpaged.pages_visible(table, intr, torch.eye(4)[None])), np_(table.occupancy)
    assert vis[occ > 0].all() and not vis[occ == 0].any()
    away = tlook_at(torch.zeros(3), torch.tensor([0.0, 0.0, -5.0]),
                    torch.tensor([0.0, -1.0, 0.0]))
    assert not np_(tpaged.pages_visible(table, intr, away[None])).any()


SELECT_CASES = {
    # the reference's cases
    "all-visible-identity": (np.ones(8, bool), np.full(8, 32), 8, None),
    "quota-fill-nursery": (np.array([1, 0, 0, 0, 0, 0], bool),
                           np.array([32, 32, 5, 0, 17, 0]), 3, None),
    "overflow-drops-far": (np.ones(4, bool), np.full(4, 8), 2,
                           np.array([9.0, 1.0, 4.0, 0.0], np.float32)),
    "overflow-all-selected": (np.ones(4, bool), np.full(4, 8), 4,
                              np.array([9.0, 1.0, 4.0, 0.0], np.float32)),
    # ties and infinite priorities (empty pages)
    "ties-and-inf": (np.random.default_rng(5).uniform(size=64) < 0.4,
                     np.random.default_rng(6).integers(0, 4, 64), 20,
                     np.where(np.random.default_rng(7).uniform(size=64) < 0.3, np.inf,
                              np.random.default_rng(8).integers(0, 5, 64)).astype(np.float32)),
}


@pytest.mark.parametrize("case", list(SELECT_CASES))
def test_select_pages_matches(case):
    visible, occ, v_max, prio = SELECT_CASES[case]
    sj = jpaged.select_pages(jnp.asarray(visible), jnp.asarray(occ, jnp.int32), v_max,
                             None if prio is None else jnp.asarray(prio))
    st = tpaged.select_pages(th(visible), th(occ, torch.int32), v_max,
                             None if prio is None else th(prio))
    assert _same(st, sj)
    if case == "all-visible-identity" or case == "overflow-all-selected":
        assert np.array_equal(np_(st), np.arange(len(visible)))
    if case == "quota-fill-nursery":
        assert np.array_equal(np_(st), [0, 3, 5])
    if case == "overflow-drops-far":
        assert np.array_equal(np_(st), [1, 3])


def test_page_distances_match():
    """Squared distances to each page's AABB from cameras outside and
    inside the cloud, within ulps of the reference's (the camera centre's
    3-long dot products round as ``frustum_planes``' do); inf for empty
    pages, 0 inside a box."""
    arrays = _np_field(9, 1024, 0.7, spread=2.0)
    gj, gt = _fields(arrays)
    tj = jpaged.build_page_table(gj, jpaged.PagedConfig(page_capacity=64))
    tt = tpaged.build_page_table(gt, tpaged.PagedConfig(page_capacity=64))
    for w2c in _poses(12, 5):
        dj, dt = jpaged.page_distances(tj, jnp.asarray(w2c)), tpaged.page_distances(tt, th(w2c))
        occ = np_(tt.occupancy)
        assert _same(np.isinf(np_(dt)), np.isinf(np.asarray(dj)))
        eye = -w2c[:3, :3].T.astype(np.float64) @ w2c[:3, 3]
        # d^2's error: 2 |d| times the centre's (ulps of |eye|), plus its own.
        d = np.sqrt(np.asarray(dj, np.float64)[occ > 0])
        _ulp_close(np_(dt)[occ > 0], np.asarray(dj)[occ > 0],
                   6 * d * np.abs(eye).max() + d * d)
        assert np.isinf(np_(dt)[occ == 0]).all() and np.isfinite(np_(dt)[occ > 0]).all()
    assert np_(tpaged.page_distances(tt, torch.eye(4)))[np_(tt.occupancy) > 0].min() == 0.0


@pytest.mark.parametrize("v_max", [1, 5, 16])
def test_view_rows_and_working_set_match(v_max):
    """``view_rows`` of a selection (ascending storage rows, ``arange(N)``
    when every page is selected), and the port's ``working_set`` as the
    reference step's cull, select and ``view_rows``."""
    n, c = 1024, 64
    arrays = _np_field(13, n, 0.6, spread=3.0)
    gj, gt = _fields(arrays)
    pj, pt = jpaged.PagedConfig(c, v_max), tpaged.PagedConfig(c, v_max)
    tj, tt = jpaged.build_page_table(gj, pj), tpaged.build_page_table(gt, pt)
    intr_j, intr_t = JIntr(**INTR), TIntr(**INTR)
    poses = _poses(14, 3)
    base, ring = poses[0], poses[1:]
    vis = jpaged.pages_visible(tj, intr_j, jnp.asarray(poses), margin=pj.margin)
    sel = jpaged.select_pages(vis, tj.occupancy, v_max,
                              priority=jpaged.page_distances(tj, jnp.asarray(base)))
    rows_j = jpaged.view_rows(tj.row2page, sel, c)
    assert _same(tpaged.view_rows(tt.row2page, th(np.asarray(sel)), c), rows_j)
    assert _same(tpaged.working_set(tt, intr_t, th(base), th(ring), pt), rows_j)
    all_sel = th(np.arange(n // c, dtype=np.int32))
    assert np.array_equal(np_(tpaged.view_rows(tt.row2page, all_sel, c)), np.arange(n))


def test_project_over_storage_equals_the_flat_projection():
    """``project(view, cam, storage=(rows, n))``: the view's rows of every
    output the pose reaches equal the flat projection's bit for bit, and
    so does the pose gradient of a loss over the rendered (valid) rows,
    which the flat pose gradient sums over all n rows and the view's over
    its storage-sized operands (zero off the view).  The view holds every
    alive row.  (Colour and opacity are activations of the field's own
    leaves, untouched by ``storage``.)"""
    from repro_torch.core import lie
    from repro_torch.core.camera import Camera
    from repro_torch.core.projection import project

    n = 512
    arrays = _np_field(21, n, 0.3, spread=1.5)
    arrays["mu"][:, 2] += 4.0
    _, g = _fields(arrays)
    alive = np_(g.alive)
    extra = np.random.default_rng(22).choice(np.flatnonzero(~alive), 64, replace=False)
    rows = th(np.sort(np.concatenate([np.flatnonzero(alive), extra])), torch.int64)
    view = tpaged.gather_field(g, rows)
    cam_base, intr = torch.eye(4), TIntr(**INTR)
    weights = th(np.random.default_rng(24).normal(size=(n, 6)).astype(np.float32))
    outs = []
    for field, storage, w in ((g, None, weights), (view, (rows, n), weights[rows])):
        xi = torch.zeros(6, requires_grad=True)
        p = project(field, Camera(intr, lie.se3_exp(xi) @ cam_base), storage)
        per_row = torch.cat([p.mu2d, p.conic, p.depth[:, None]], -1)[:, :6]
        loss = torch.where(p.valid[:, None], per_row * w, torch.zeros_like(per_row)).sum()
        outs.append((p, torch.autograd.grad(loss, [xi])[0]))
    (p_f, grad_f), (p_v, grad_v) = outs
    assert int(np_(p_f.valid).sum()) > 0
    for f in ("mu2d", "conic", "depth", "radius", "valid"):
        assert torch.equal(getattr(p_f, f).index_select(0, rows), getattr(p_v, f)), f
    assert torch.equal(grad_f, grad_v) and bool(grad_f.abs().sum() > 0)


def test_view_helpers_match():
    """``gather_field`` / ``scatter_field``, the pruning and Adam states'
    ``gather_rows`` / ``scatter_rows`` and ``remap_fragment_rows``."""
    n, m = 512, 192
    r = np.random.default_rng(15)
    idx = np.sort(r.choice(n, m, replace=False)).astype(np.int32)
    ij, it = jnp.asarray(idx), th(idx, torch.int64)
    gj, gt = _fields(_np_field(16, n))
    vj, vt = _fields(_np_field(17, m))
    for a, b in ((tpaged.gather_field(gt, it), jpaged.gather_field(gj, ij)),
                 (tpaged.scatter_field(gt, vt, it), jpaged.scatter_field(gj, vj, ij))):
        assert all(_same(getattr(a, f), getattr(b, f)) for f in TG.PARAM_FIELDS + ("alive",))

    def prune_state(seed, rows):
        q = np.random.default_rng(seed)
        return dict(score=q.normal(size=rows).astype(np.float32),
                    masked=q.uniform(size=rows) < 0.3, interval=np.int32(4),
                    iters_left=np.int32(2),
                    prev_tile_count=q.integers(0, 9, 12).astype(np.int32),
                    initial_alive=np.int32(300), removed=np.int32(seed),
                    grad_ema=q.normal(size=rows).astype(np.float32),
                    age=q.integers(0, 5, rows).astype(np.int32),
                    stable=q.uniform(size=rows) < 0.5, opt_steps=np.int32(7))

    full, view = prune_state(1, n), prune_state(2, m)

    def ps_j(d):
        return jpruning.PruneState(**{k: jnp.asarray(v) for k, v in d.items()})

    def ps_t(d):
        return convert.prune_state_from_numpy(type("P", (), d), device="cpu")

    for a, b in ((tpruning.gather_rows(ps_t(full), it), jpruning.gather_rows(ps_j(full), ij)),
                 (tpruning.scatter_rows(ps_t(full), ps_t(view), it),
                  jpruning.scatter_rows(ps_j(full), ps_j(view), ij))):
        for f in tpruning.PruneState._fields:
            x, y = getattr(a, f), getattr(b, f)
            assert _same(x, y), f

    def adam(seed, rows):
        q = np.random.default_rng(seed)
        mom = {f: q.normal(size=(rows,) + ((3,) if f != "logit_o" else ())).astype(np.float32)
               for f in ("mu", "logit_o")}
        return np.int32(seed), mom, {k: v * v for k, v in mom.items()}

    def ad_j(a):
        return joptim.AdamState(step=jnp.asarray(a[0]), mu={k: jnp.asarray(v) for k, v in a[1].items()},
                                nu={k: jnp.asarray(v) for k, v in a[2].items()})

    def ad_t(a):
        return toptim.AdamState(step=th(a[0]), mu={k: th(v) for k, v in a[1].items()},
                                nu={k: th(v) for k, v in a[2].items()})

    fa, va = adam(3, n), adam(4, m)
    for a, b in ((toptim.gather_rows(ad_t(fa), it), joptim.gather_rows(ad_j(fa), ij)),
                 (toptim.scatter_rows(ad_t(fa), ad_t(va), it),
                  joptim.scatter_rows(ad_j(fa), ad_j(va), ij))):
        assert _same(a.step, b.step)
        assert all(_same(a.mu[k], b.mu[k]) and _same(a.nu[k], b.nu[k]) for k in a.mu)

    fidx = np.where(r.uniform(size=(20, 16)) < 0.4, -1,
                    r.integers(0, m, (20, 16))).astype(np.int32)
    count, total = (fidx >= 0).sum(1).astype(np.int32), np.int32(99)
    fj = jsort.FragmentLists(jnp.asarray(fidx), jnp.asarray(count), jnp.asarray(np.int32(3)),
                             jnp.asarray(total))
    ft = tsort.FragmentLists(th(fidx), th(count), th(np.int32(3)), th(total))
    rj, rt = jsort.remap_fragment_rows(fj, ij), tsort.remap_fragment_rows(ft, it)
    assert all(_same(x, y) for x, y in zip(rt, rj))


def test_ladder_and_validation():
    """The reference's ladder cases, and the reference's ``ValueError`` for
    an off-ladder page, more visible pages than pages, an indivisible
    capacity, and paging without the fused engine; ``sched_bucket`` is
    still not ported."""
    assert tpaged.ladder_page_capacity(1024) == 256
    assert tpaged.ladder_page_capacity(4096) == 1024
    assert tpaged.ladder_page_capacity(128, min_pages=4) == 32
    assert tpaged.PAGE_LADDER == jpaged.PAGE_LADDER
    assert tpaged.PagedConfig() == tuple(jpaged.PagedConfig())
    ds = make_dataset("room0", num_frames=2, height=48, width=64, num_gaussians=64,
                      device="cpu")
    for bad in (dict(paged=tpaged.PagedConfig(page_capacity=48)),
                dict(paged=tpaged.PagedConfig(page_capacity=128, visible_pages=99)),
                dict(capacity=1000, paged=tpaged.PagedConfig(page_capacity=128)),
                dict(fused=False, paged=tpaged.PagedConfig(page_capacity=128))):
        with pytest.raises(ValueError):
            S.session_init(ds, _cfg(**bad), device="cpu")
    with pytest.raises(NotImplementedError, match="sched_bucket"):
        _cfg(sched_bucket=2)


# ---------------------------------------------------------------------------
# the paged session on the CPU
# ---------------------------------------------------------------------------


def _cfg(**kw):
    base = dict(iters_track=3, iters_map=4, capacity=1024, frag_capacity=48,
                map_window=2, map_rebuild_stride=2, densify_per_kf=64,
                keyframe=KeyframePolicy(kind="monogs", interval=2),
                prune=PruneConfig(k0=2, step_frac=0.1))
    base.update(kw)
    return S.SLAMConfig(**base)


ALL_VISIBLE = tpaged.PagedConfig(page_capacity=128, visible_pages=8)
PARTIAL = tpaged.PagedConfig(page_capacity=128, visible_pages=6)


@pytest.fixture(scope="module")
def scenes():
    return {name: make_dataset(name, num_frames=5, height=48, width=64,
                               num_gaussians=400, frag_capacity=48, device="cpu")
            for name in ("room0", "room1")}


def _replay(ds, cfg):
    """A solo run; returns the session, the step results and each step's
    (dispatches, syncs, replays)."""
    stats = EngineStats()
    sess = S.session_init(ds, cfg, device="cpu", stats=stats)
    results, counts = [], []
    for f in ds.frames[1:]:
        before = dataclasses.replace(stats)
        sess, r = S.session_step(sess, f, stats=stats)
        results.append(r)
        d = stats.since(before)
        counts.append((d.dispatches, d.syncs, d.replays))
    return sess, results, counts


def _work(w):
    return tuple(int(x) for x in w)


def _same_field(a, b):
    return all(torch.equal(getattr(a, f), getattr(b, f))
               for f in TG.PARAM_FIELDS + ("alive",))


PATHS = {
    "kernel-prune": {}, "kernel-noprune": dict(prune=None),
    "schedule-prune": dict(backend="schedule"), "sparse": dict(sparse_opt=True),
    "gsslam": dict(base_algo="gsslam",
                   keyframe=KeyframePolicy(kind="gsslam", trans_thresh=0.03)),
    "photoslam-noprune": dict(base_algo="photoslam", prune=None,
                              keyframe=KeyframePolicy(kind="photoslam")),
}


@pytest.mark.parametrize("path", list(PATHS))
def test_paged_all_visible_bitwise_equals_flat(scenes, path):
    """capacity 1024 / page 128 / visible 8: every page is selected each
    frame, the view is the identity, and everything the step produces (the
    map, poses, PSNR, every work counter, alive counts) equals the flat
    session bit for bit, with the same dispatches, syncs and replays per
    step."""
    ds = scenes["room0"]
    sf, rf, cf = _replay(ds, _cfg(**PATHS[path]))
    sp, rp, cp = _replay(ds, _cfg(paged=ALL_VISIBLE, **PATHS[path]))
    assert sp.page is not None and sf.page is None
    assert _same_field(sf.g, sp.g)
    for a, b in zip(rf, rp):
        assert torch.equal(a.pose, b.pose)
        assert _work(a.work) == _work(b.work)
        assert a.is_kf == b.is_kf
        assert torch.equal(a.psnr.isnan(), b.psnr.isnan())
        assert torch.equal(a.psnr.nan_to_num(), b.psnr.nan_to_num())
        assert torch.equal(a.alive, b.alive)
    assert cf == cp
    assert any(r.is_kf for r in rp) and any(not r.is_kf for r in rp)
    if sf.pstate is not None:
        assert all(torch.equal(getattr(sf.pstate, f), getattr(sp.pstate, f))
                   for f in tpruning.ROW_FIELDS)
    assert torch.equal(sf.frags.idx, sp.frags.idx)


def test_flat_drops_where_paged_spills(scenes):
    """A 256-row flat pool seeded with 128 alive, 256 newcomers per
    keyframe: the shortfall shows in ``densify_dropped`` (per step and in
    the finalized counters).  A partial view (6 of 8 pages) of a 1024-row
    pool, whose visible pages are full after seeding, drops nothing, since
    the selection tops the view up with nursery pages, and the map grows;
    every build sweeps the view's 768 rows."""
    ds = scenes["room0"]
    sess, results, _ = _replay(ds, _cfg(capacity=256, densify_per_kf=256, prune=None))
    dropped = [int(r.work.densify_dropped) for r in results]
    fin = S.session_finalize(sess, gt_w2c=[f.w2c_gt for f in ds.frames])
    assert any(d > 0 for d in dropped) and fin.work.densify_dropped == sum(dropped)

    sess0 = S.session_init(ds, _cfg(paged=PARTIAL), device="cpu")
    alive0 = int(sess0.g.alive.sum())
    sess, results, _ = _replay(ds, _cfg(paged=PARTIAL))
    assert all(int(r.work.densify_dropped) == 0 for r in results)
    assert any(r.is_kf for r in results)
    assert int(sess.g.alive.sum()) > alive0
    track_rows = [int(r.work.frag_build_rows) for r in results if not r.is_kf]
    assert track_rows and all(x % 768 == 0 for x in track_rows)


def test_paged_partial_view_prunes_across_pages(scenes):
    """Pruning on a 6-of-8-page view: removals move, the rebuilt table's
    occupancy equals the stored alive count, and the carried table (last
    rebuilt at a keyframe) never counts fewer."""
    ds = scenes["room0"]
    cfg = _cfg(prune=PruneConfig(k0=2, step_frac=0.3), paged=PARTIAL)
    sess, _, _ = _replay(ds, cfg)
    assert int(sess.pstate.removed) > 0
    alive = int(sess.g.alive.sum())
    table = tpaged.build_page_table(sess.g, cfg.paged)
    assert int(table.occupancy.sum()) == alive
    assert int(sess.page.occupancy.sum()) >= alive


@pytest.mark.parametrize("prune", [True, False], ids=["prune", "noprune"])
def test_paged_pool_rows_equal_solo_runs(scenes, prune):
    """Two paged rows (room0, room1) on a partial view, stepped by
    ``SessionPool``: each row equals its solo paged run bit for bit (page
    table included), and the pool counts what a flat pool of the same
    scenes counts."""
    extra = {} if prune else dict(prune=None)
    cfg = _cfg(paged=PARTIAL, **extra)
    ds_a, ds_b = scenes["room0"], scenes["room1"]
    solos = [_replay(ds, cfg)[0] for ds in (ds_a, ds_b)]
    pools = []
    for c in (cfg, _cfg(**extra)):
        pool = S.SessionPool([S.session_init(ds, c, device="cpu") for ds in (ds_a, ds_b)])
        for fa, fb in zip(ds_a.frames[1:], ds_b.frames[1:]):
            pool.step([fa, fb])
        pools.append(pool)
    paged, flat = pools
    for s, solo in enumerate(solos):
        assert same_session(paged.session(s), solo)
        assert paged.session(s).page is not None
    assert (paged.stats.dispatches, paged.stats.syncs) == (flat.stats.dispatches,
                                                           flat.stats.syncs)


def test_memory_profile_and_row_copies(scenes):
    """``ShardedPool.memory_profile``'s paged figures (the reference's
    ``server.py:250-277``), and ``session_row`` / ``swap`` carry the page
    table."""
    from repro_torch.slam.server import ShardedPool
    cfg = _cfg(paged=PARTIAL)
    sess = S.session_init(scenes["room0"], cfg, device="cpu")
    pool = ShardedPool([sess, S.session_init(scenes["room1"], cfg, device="cpu")])
    mem = pool.memory_profile()
    assert mem["paged"] and mem["storage_rows"] == 1024 and mem["working_rows"] == 768
    assert mem["working_fraction"] == 0.75
    assert mem["working_bytes_per_row"] * 4 == mem["storage_bytes_per_row"] * 3
    old = pool.swap(1, sess)
    assert old.page is not None and same_session(pool.session(1), sess)
    assert not pool.session(1).page.row2page is sess.page.row2page
