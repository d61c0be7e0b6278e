"""Parity of the port's sparse stable/unstable pieces with ``repro``'s:
the row-masked Adam step, ``optimizable_mask`` / ``mark_born``, the
``keep``-masked fragment build and its skipped-fragment count,
``render(keep=)`` and the mapping phase's stable-background render.

Inputs come from numpy seeds; the cloud is ``tiny_scene``-sized (200
Gaussians, 64x64, K=64).  Index plumbing (lists, counts, masks, counters)
is held equal exactly; float results to the reference's kernel tolerances
(``_torch_parity``); the Adam step to 1 ulp-level rtol 2e-6 (XLA and
PyTorch round ``sqrt``/``rsqrt`` independently); and the port's own
identities (all-True mask == dense step, frozen rows, ``-0.0``) bit for
bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (
    DEPTH_TOL, FWD_ATOL, FWD_RTOL, jx, np_, th, tiny_cloud,
)
from _torch_parity import first_cpu_exp_spent  # noqa: F401  (autouse fixture)
from _torch_parity import one_cpu_thread  # noqa: F401  (autouse fixture)
from repro.core import gaussians as JG
from repro.core import pruning as jpruning
from repro.core import sorting as jsort
from repro.core.camera import Camera as JCamera
from repro.core.camera import Intrinsics as JIntr
from repro.core.camera import look_at as jlook_at
from repro.core.keyframes import KeyframePolicy as JPolicy
from repro.core.projection import project as jproject
from repro.core.pruning import PruneConfig as JPrune
from repro.core.raster_api import RasterPlan as JPlan
from repro.core.render import render as jrender
from repro.slam import engine as jengine
from repro.slam import session as jsession
from repro.train import optimizer as jopt
from repro_torch.core import gaussians as TG
from repro_torch.core import pruning as tpruning
from repro_torch.core import sorting as tsort
from repro_torch.core.camera import Camera as TCamera
from repro_torch.core.camera import Intrinsics as TIntr
from repro_torch.core.keyframes import KeyframePolicy as TPolicy
from repro_torch.core.projection import ProjectedGaussians, project as tproject
from repro_torch.core.pruning import PruneConfig as TPrune
from repro_torch.core.raster_api import RasterPlan as TPlan
from repro_torch.core.render import render as trender
from repro_torch.slam import engine as tengine
from repro_torch.slam import session as tsession
from repro_torch.train import optimizer as topt

HW, CAP = 64, 64
INTR = dict(fx=80.0, fy=80.0, cx=32.0, cy=32.0, width=HW, height=HW)
ADAM_RTOL = 2e-6


def _scene(seed=0):
    pts, cols, cap = tiny_cloud(seed)
    g_j = JG.from_points(jx(pts), jx(cols), capacity=cap, scale=0.08, opacity=0.8)
    g_t = TG.from_points(th(pts), th(cols), capacity=cap, scale=0.08, opacity=0.8)
    w2c = np_(jlook_at(jnp.zeros(3), jnp.array([0.0, 0.0, 3.0]),
                       jnp.array([0.0, -1.0, 0.0])))
    return g_j, g_t, w2c


def _keep(n, seed=7, p=0.6):
    return np.random.default_rng(seed).uniform(size=n) < p


def _window(w2c, views):
    """``views`` poses (numpy): ``w2c`` and copies shifted 10 cm apart in x."""
    poses = np.repeat(w2c[None], views, axis=0).astype(np.float32)
    poses[:, 0, 3] += 0.1 * np.arange(views)
    return poses


# ---------------------------------------------------------------------------
# masked Adam
# ---------------------------------------------------------------------------


def _toy(seed, n=8):
    r = np.random.default_rng(seed)
    return {"a": r.normal(size=(n, 3)).astype(np.float32),
            "b": r.normal(size=(n,)).astype(np.float32)}


def _bytes(d):
    return {k: np_(v).tobytes() for k, v in d.items()}


def test_update_masked_all_true_is_the_dense_step_bitwise():
    params = {k: th(v) for k, v in _toy(0).items()}
    grads = {k: th(v) for k, v in _toy(1).items()}
    opt = topt.Adam(lr=1e-2)
    state = opt.init(params)
    every = torch.ones(8, dtype=torch.bool)
    for _ in range(2):       # the second step sees nonzero moments
        upd_d, st_d = opt.update(grads, state)
        upd_m, st_m = opt.update_masked(grads, state, every)
        assert _bytes(upd_m) == _bytes(upd_d)
        assert _bytes(st_m.mu) == _bytes(st_d.mu) and _bytes(st_m.nu) == _bytes(st_d.nu)
        assert int(st_m.step) == int(st_d.step)
        assert (_bytes(topt.apply_updates_masked(params, upd_m, every))
                == _bytes(topt.apply_updates(params, upd_d)))
        params, state = topt.apply_updates(params, upd_d), st_d


def test_update_masked_matches_the_reference_and_freezes_rows():
    """A partial mask after one warm step: the reference's updates, moments
    and parameters within ADAM_RTOL; the frozen rows' moments and
    parameters bit for bit what they were, their updates zero."""
    p_np, g_np = _toy(2), _toy(3)
    mask = np.array([True, False, True, False, True, True, False, True])
    res = {}
    for pkg, opt, conv in (("jax", jopt.Adam(lr=1e-2), jx),
                           ("torch", topt.Adam(lr=1e-2), th)):
        params = {k: conv(v) for k, v in p_np.items()}
        grads = {k: conv(v) for k, v in g_np.items()}
        state = opt.init(params)
        upd, state = opt.update(grads, state)
        params = (jopt if pkg == "jax" else topt).apply_updates(params, upd)
        upd_m, st_m = opt.update_masked(grads, state, conv(mask))
        new = (jopt if pkg == "jax" else topt).apply_updates_masked(
            params, upd_m, conv(mask))
        res[pkg] = (params, state, upd_m, st_m, new)
    _, _, uj, mj, nj = res["jax"]
    pt, st, ut, mt, nt = res["torch"]
    assert int(mt.step) == int(mj.step) == 2
    off = ~mask
    for k in p_np:
        np.testing.assert_allclose(np_(ut[k]), np_(uj[k]), rtol=ADAM_RTOL, atol=1e-9)
        np.testing.assert_allclose(np_(mt.mu[k]), np_(mj.mu[k]), rtol=ADAM_RTOL)
        np.testing.assert_allclose(np_(mt.nu[k]), np_(mj.nu[k]), rtol=ADAM_RTOL)
        np.testing.assert_allclose(np_(nt[k]), np_(nj[k]), rtol=ADAM_RTOL, atol=1e-9)
        assert not np_(ut[k])[off].any()
        assert np_(mt.mu[k])[off].tobytes() == np_(st.mu[k])[off].tobytes()
        assert np_(mt.nu[k])[off].tobytes() == np_(st.nu[k])[off].tobytes()
        assert np_(nt[k])[off].tobytes() == np_(pt[k])[off].tobytes()


def test_apply_updates_masked_keeps_negative_zero():
    """A frozen -0.0 stays -0.0: the masked apply selects, it does not add
    0 (which gives +0.0); the reference keeps it too."""
    want = np.array([-0.0, 6.0], np.float32).tobytes()
    for mod, conv in ((jopt, jx), (topt, th)):
        out = mod.apply_updates_masked({"a": conv(np.array([-0.0, 1.0], np.float32))},
                                       {"a": conv(np.array([5.0, 5.0], np.float32))},
                                       conv(np.array([False, True])))
        assert np_(out["a"]).tobytes() == want


# ---------------------------------------------------------------------------
# stability bookkeeping
# ---------------------------------------------------------------------------


def test_optimizable_mask_and_mark_born_match():
    g_j, g_t, _ = _scene()
    n = g_t.capacity
    r = np.random.default_rng(4)
    ema = r.uniform(0, 1, n).astype(np.float32)
    age = r.integers(0, 9, n).astype(np.int32)
    stable = r.uniform(size=n) < 0.5
    born = r.uniform(size=n) < 0.2
    s_j = jpruning.init_state(g_j, 16, JPrune())._replace(
        grad_ema=jx(ema), age=jx(age), stable=jx(stable))
    s_t = tpruning.init_state(g_t, 16, TPrune())._replace(
        grad_ema=th(ema), age=th(age), stable=th(stable))
    assert np.array_equal(np_(tpruning.optimizable_mask(s_t)),
                          np_(jpruning.optimizable_mask(s_j)))
    b_j = jpruning.mark_born(s_j, jx(born))
    b_t = tpruning.mark_born(s_t, th(born))
    for f in ("grad_ema", "age", "stable"):
        a, b = np_(getattr(b_t, f)), np_(getattr(b_j, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert not np_(b_t.stable)[born].any() and not np_(b_t.age)[born].any()


# ---------------------------------------------------------------------------
# masked fragment build, skipped fragments, render(keep=)
# ---------------------------------------------------------------------------


def _projections():
    g_j, _, w2c = _scene()
    p_j = jproject(g_j, JCamera(JIntr(**INTR), jx(w2c)))
    return p_j, ProjectedGaussians(*(th(np_(x)) for x in p_j))


@pytest.mark.parametrize("kind", ["partial", "all", "none"])
@pytest.mark.parametrize("cap", [8, 64])
def test_masked_fragment_lists_and_skipped_count_match(kind, cap):
    """``idx``, ``count``, ``overflow`` and ``total`` equal the reference's
    exactly, and so does the skipped count, which is the dense total less
    the masked one; an all-True ``keep`` gives the unmasked lists, an
    all-False one empty lists."""
    p_j, p_t = _projections()
    n = p_t.mu2d.shape[0]
    keep = {"partial": _keep(n), "all": np.ones(n, bool), "none": np.zeros(n, bool)}[kind]
    f_j = jsort.build_fragment_lists(p_j, jsort.make_tile_grid(HW, HW), cap, keep=jx(keep))
    grid = tsort.make_tile_grid(HW, HW)
    f_t = tsort.build_fragment_lists(p_t, grid, cap, keep=th(keep))
    for name in ("idx", "count", "overflow", "total"):
        a, b = np_(getattr(f_j, name)), np_(getattr(f_t, name))
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    skipped = tsort.count_skipped_fragments(p_t, grid, th(keep))
    assert skipped.dtype == torch.int32
    assert int(skipped) == int(jsort.count_skipped_fragments(
        p_j, jsort.make_tile_grid(HW, HW), jx(keep)))
    dense = tsort.build_fragment_lists(p_t, grid, cap)
    assert int(dense.total) - int(f_t.total) == int(skipped)
    if kind == "all":
        assert int(skipped) == 0
        assert all(torch.equal(a, b) for a, b in zip(f_t, dense))
    elif kind == "none":
        assert int(f_t.count.sum()) == 0 and bool((f_t.idx == -1).all())
        assert int(skipped) == int(dense.total) > 0
    else:
        assert 0 < int(skipped) < int(dense.total)
        assert bool((f_t.count <= dense.count).all())


@pytest.mark.parametrize("views", [None, 3])
def test_render_keep_matches(views):
    """``render(keep=)`` through the port's ``kernel`` backend (plain K1 on
    the CPU) against the reference's ``ref`` backend: the same lists
    exactly, images within the forward tolerances; rows outside ``keep``
    render nothing."""
    g_j, g_t, w2c = _scene()
    keep = _keep(g_t.capacity, seed=11)
    poses = w2c if views is None else _window(w2c, views)
    out_j = jrender(g_j, JCamera(JIntr(**INTR), jx(poses)),
                    JPlan(grid=jsort.make_tile_grid(HW, HW), backend="ref", capacity=CAP),
                    keep=jx(keep))
    plan = TPlan(grid=tsort.make_tile_grid(HW, HW), backend="kernel", capacity=CAP)
    cam = TCamera(TIntr(**INTR), th(poses))
    out_t = trender(g_t, cam, plan, keep=th(keep), device="cpu")
    for name in ("idx", "count", "total"):
        assert np.array_equal(np_(getattr(out_t.frags, name)),
                              np_(getattr(out_j.frags, name))), name
    for name, tol, rtol in (("image", FWD_ATOL, FWD_RTOL), ("depth", DEPTH_TOL, DEPTH_TOL),
                            ("final_t", FWD_ATOL, FWD_RTOL)):
        np.testing.assert_allclose(np_(getattr(out_t, name)), np_(getattr(out_j, name)),
                                   atol=tol, rtol=rtol, err_msg=name)
    # Rows outside ``keep`` silenced by hand render the same image.
    dead = g_t.replace(alive=g_t.alive & th(keep))
    same = trender(dead, cam, plan, device="cpu")
    np.testing.assert_allclose(np_(same.image), np_(out_t.image), atol=FWD_ATOL)
    every = trender(g_t, cam, plan, keep=torch.ones(g_t.capacity, dtype=torch.bool),
                    device="cpu")
    full = trender(g_t, cam, plan, device="cpu")
    assert torch.equal(every.image, full.image) and torch.equal(every.final_t, full.final_t)


# ---------------------------------------------------------------------------
# the stable background
# ---------------------------------------------------------------------------


SESSION_CFG = dict(iters_track=3, iters_map=4, capacity=256, frag_capacity=CAP,
                   map_window=2, sparse_opt=True)


@pytest.mark.parametrize("backend", ["kernel", "schedule"])
def test_stable_bg_core_matches(backend):
    """The stable-only render of a 2-view window: images within the forward
    tolerances of the reference's (its interpreted ``pallas`` backend; its
    ``ref`` backend parts from both by 2.5e-3 at one pixel, where a
    fragment's alpha grazes the 1/255 cut-off), each slot's
    fragment total and programs (chunk trips) exactly; an empty stable set
    gives the (0, 0, 1) background, no fragment and no program."""
    g_j, g_t, w2c = _scene()
    stable = _keep(g_t.capacity, seed=5, p=0.5) & np_(g_t.alive)
    poses = _window(w2c, 2)
    cfg_j = jsession.SLAMConfig(backend="pallas", keyframe=JPolicy(), prune=JPrune(),
                                **SESSION_CFG)
    st_j = jengine._Stage(JIntr(**INTR), cfg_j, 1)
    masked = np.zeros(g_t.capacity, bool)
    (img_j, dep_j, t_j), tot_j, prog_j = st_j._stable_bg_core(
        g_j, jx(masked), jx(stable), jx(poses))
    cfg_t = tsession.SLAMConfig(backend=backend, keyframe=TPolicy(), prune=TPrune(),
                                **SESSION_CFG)
    st_t = tengine._Stage(TIntr(**INTR), cfg_t, torch.device("cpu"))
    (img_t, dep_t, t_t), tot_t, prog_t = st_t._stable_bg_core(
        g_t, th(masked), th(stable), th(poses))
    assert not img_t.requires_grad
    np.testing.assert_allclose(np_(img_t), np_(img_j), atol=FWD_ATOL, rtol=FWD_RTOL)
    np.testing.assert_allclose(np_(dep_t), np_(dep_j), atol=DEPTH_TOL, rtol=DEPTH_TOL)
    np.testing.assert_allclose(np_(t_t), np_(t_j), atol=FWD_ATOL, rtol=FWD_RTOL)
    assert np_(tot_t).tolist() == np_(tot_j).tolist() and int(tot_t.sum()) > 0
    assert np_(prog_t).tolist() == np_(prog_j).tolist()
    (img0, dep0, t0), tot0, prog0 = st_t._stable_bg_core(
        g_t, th(masked), torch.zeros(g_t.capacity, dtype=torch.bool), th(poses))
    assert not img0.any() and not dep0.any() and bool((t0 == 1.0).all())
    assert not tot0.any() and not prog0.any()


def test_sparse_without_prune_raises_the_reference_error():
    cfg_t = tsession.SLAMConfig(sparse_opt=True)
    with pytest.raises(ValueError, match="requires cfg.prune"):
        tengine._Stage(TIntr(**INTR), cfg_t, torch.device("cpu"))
    with pytest.raises(ValueError, match="requires cfg.prune"):
        jengine._Stage(JIntr(**INTR), jsession.SLAMConfig(sparse_opt=True), 1)
