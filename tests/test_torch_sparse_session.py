"""Parity of the port's sparse stable/unstable mapping with ``repro``'s, in
the engine and in the session.

* One mapping phase (``_map_scan_masked``) of each package from the same
  seeded map with every other alive Gaussian stable, over a 3-slot ring
  with 2 valid slots: every work counter equal (the stable background's
  fragments and programs, counted once over the valid slots, included),
  the losses within 1e-3 relative (Adam's rounding drift, as in
  ``test_torch_schedule_engine.py``), the stable rows' parameters and
  moments bit-frozen.
* The port's all-unstable sparse run equals its dense run bit for bit:
  one mapping phase, and a 5-frame session whose stability rule never
  fires (on both kernel backends).
* One sparse ``session_step`` (a keyframe: tracking with pruning, densify,
  ``mark_born``, sparse mapping) from the reference's carried state on the
  48x64 ``desk0`` of ``tests/test_sparse.py``: the pose within 1e-4 per
  entry and the three sparse counters equal.

The reference runs on its ``ref`` backend, the port on ``kernel`` (plain
K1/K2 on the CPU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _shared_runs import shared
from _torch_parity import jx, np_, th
from _torch_parity import one_cpu_thread  # noqa: F401  (autouse fixture)
from repro.core import gaussians as JG
from repro.core.keyframes import KeyframePolicy as JPolicy
from repro.core.pruning import PruneConfig as JPrune
from repro.slam import engine as jengine
from repro.slam import metrics as jmetrics
from repro.slam import session as jsession
from repro.slam.datasets import make_dataset as jmake_dataset
from repro_torch import convert
from repro_torch.core import gaussians as TG
from repro_torch.core.keyframes import KeyframePolicy as TPolicy
from repro_torch.core.pruning import PruneConfig as TPrune
from repro_torch.slam import engine as tengine
from repro_torch.slam import metrics as tmetrics
from repro_torch.slam import session as tsession
from repro_torch.slam.datasets import make_dataset as tmake_dataset

MAP_CFG = dict(iters_track=3, iters_map=6, capacity=1024, frag_capacity=48,
               map_window=3, map_rebuild_stride=3, sparse_opt=True)
SESSION_CFG = dict(iters_track=3, iters_map=4, capacity=1024, frag_capacity=48,
                   map_window=2, map_rebuild_stride=2)
SEED = 0


def _port_map(g_t, ds_t, masked, window, n_valid, stable, backend="kernel"):
    cfg = tsession.SLAMConfig(keyframe=TPolicy(interval=2), prune=TPrune(),
                              backend=backend, **MAP_CFG)
    st = tengine._Stage(ds_t.intrinsics, cfg, torch.device("cpu"))
    kf_w2c, kf_rgb, kf_depth = (th(x) for x in window)
    opt = tsession.Adam(lr=cfg.lr_map).init(TG.params_of(g_t))
    return st._map_scan_masked(g_t, masked, opt, kf_w2c, kf_rgb, kf_depth, n_valid,
                               tmetrics.device_work_zero(), stable)


@pytest.fixture(scope="module")
def map_phase(request, tmp_path_factory):
    """The reference's and the port's mapping phase from one seeded map,
    frames 0 and 1 in the ring's first two slots and frame 2 in its
    invalid third, built once per test run (``tests/_shared_runs.py``)."""
    return shared(request, tmp_path_factory, "torch_sparse_session_map_phase", _build_map_phase)


def _build_map_phase():
    ds_j = jmake_dataset("room0", num_frames=3, height=64, width=64,
                         num_gaussians=400, frag_capacity=48)
    cfg_j = jsession.SLAMConfig(keyframe=JPolicy(interval=2), scan_unroll=1,
                                prune=JPrune(), **MAP_CFG)
    g_j = jsession._seed_map(ds_j, cfg_j)
    stable = np.asarray(g_j.alive) & (np.arange(cfg_j.capacity) % 2 == 0)
    window = tuple(np.stack([np.asarray(getattr(f, k)) for f in ds_j.frames])
                   for k in ("w2c_gt", "rgb", "depth"))
    st_j = jengine._Stage(ds_j.intrinsics, cfg_j, 1)
    opt_j = jsession.Adam(lr=cfg_j.lr_map).init(JG.params_of(g_j))
    _, _, work_j, losses_j, _ = st_j.map_scan_masked(
        g_j, jnp.zeros((cfg_j.capacity,), bool), opt_j, *(jx(x) for x in window),
        jnp.asarray([True, True, False]), jmetrics.device_work_zero(), jx(stable))

    ds_t = convert.dataset_from_numpy(ds_j, device="cpu")
    g_t = convert.field_from_numpy(jax.device_get(g_j), device="cpu")
    masked = torch.zeros((cfg_j.capacity,), dtype=torch.bool)
    out_t = _port_map(g_t, ds_t, masked, window, 2, th(stable))
    return dict(ds_t=ds_t, g_t=g_t, masked=masked, window=window, stable=stable,
                ref=(work_j, losses_j), port=out_t)


def test_map_phase_with_stable_rows_matches(map_phase):
    work_j, losses_j = map_phase["ref"]
    _, _, work_t, losses_t, _ = map_phase["port"]
    for f in work_j._fields:
        assert int(getattr(work_t, f)) == int(getattr(work_j, f)), f
    assert int(work_t.skipped_fragments) > 0
    assert int(work_t.unstable_gaussians) < int(work_t.gaussians_iters)
    np.testing.assert_allclose(np_(losses_t), np.asarray(losses_j), rtol=1e-3)


def test_map_phase_freezes_stable_rows(map_phase):
    """The stable rows' parameters keep their bits and their moments stay
    at Adam's initial zeros; unstable alive rows move; the optimized-Gaussian
    counter counts ``alive & ~stable`` per valid slot per iteration."""
    g_t, stable = map_phase["g_t"], map_phase["stable"]
    g_new, opt, work, _, _ = map_phase["port"]
    before, after = TG.params_of(g_t), TG.params_of(g_new)
    moving = np_(g_t.alive) & ~stable
    moved = False
    for k in before:
        assert np_(after[k])[stable].tobytes() == np_(before[k])[stable].tobytes(), k
        assert not np_(opt.mu[k])[stable].any() and not np_(opt.nu[k])[stable].any(), k
        moved = moved or bool((np_(after[k])[moving] != np_(before[k])[moving]).any())
    assert moved
    iters = MAP_CFG["iters_map"]
    assert int(work.unstable_gaussians) == iters * 2 * int(moving.sum())
    assert int(work.gaussians_iters) == iters * 2 * int(np_(g_t.alive).sum())


def test_map_phase_all_unstable_equals_dense_bitwise(map_phase):
    """``stable`` all False (an empty background, every row in the lists)
    equals ``stable=None`` bit for bit: parameters, moments, losses, eval
    image and every counter."""
    args = (map_phase["g_t"], map_phase["ds_t"], map_phase["masked"],
            map_phase["window"], 2)
    dense = _port_map(*args, None)
    sparse = _port_map(*args, torch.zeros_like(map_phase["masked"]))
    (g_d, opt_d, work_d, loss_d, img_d), (g_s, opt_s, work_s, loss_s, img_s) = dense, sparse
    for k, v in TG.params_of(g_d).items():
        assert torch.equal(TG.params_of(g_s)[k], v), k
        assert torch.equal(opt_s.mu[k], opt_d.mu[k]) and torch.equal(opt_s.nu[k], opt_d.nu[k])
    assert torch.equal(loss_s, loss_d) and torch.equal(img_s, img_d)
    assert [int(x) for x in work_s] == [int(x) for x in work_d]
    assert int(work_s.skipped_fragments) == 0


@pytest.mark.parametrize("backend", ["kernel", "schedule"])
def test_never_stable_session_equals_dense_bitwise(backend):
    """``sparse_opt=True`` with a stability rule that never fires replays
    the dense run bit for bit over 5 frames (two keyframes): poses, PSNR,
    alive counts, tracking and mapping losses, fired boundaries and every
    work counter."""
    ds = tmake_dataset("room0", num_frames=5, height=48, width=64,
                       num_gaussians=400, frag_capacity=48, device="cpu")
    prune = TPrune(k0=2, step_frac=0.1, stable_age=10 ** 6)
    perms = {i: torch.as_tensor(np.random.default_rng(i).permutation(2 * 384))
             for i in range(1, 5)}
    steps = {}
    for sparse in (False, True):
        cfg = tsession.SLAMConfig(keyframe=TPolicy(interval=2), prune=prune,
                                  sparse_opt=sparse, backend=backend, **SESSION_CFG)
        sess = tsession.session_init(ds, cfg, device="cpu")
        steps[sparse] = []
        for idx in range(1, 5):
            sess, r = tsession.session_step(sess, ds.frames[idx], perm=perms[idx])
            steps[sparse].append(r)
    assert sum(r.is_kf for r in steps[True]) == 2
    for d, s in zip(steps[False], steps[True]):
        assert d.is_kf == s.is_kf
        for name in ("pose", "psnr", "alive", "track_losses", "map_losses", "fired"):
            assert torch.equal(getattr(s, name), getattr(d, name)) or (
                name == "psnr" and bool(torch.isnan(s.psnr) and torch.isnan(d.psnr))), name
        assert [int(x) for x in s.work] == [int(x) for x in d.work]


def _jax_perm(idx, per):
    key = jax.random.fold_in(jax.random.PRNGKey(SEED), idx)
    return torch.as_tensor(np.array(jax.random.permutation(key, 2 * per)))


def test_one_sparse_step_from_carried_state():
    """The reference's sparse session (the aggressive stability rule of
    ``tests/test_sparse.py``, which freezes rows in frame 1's tracking)
    carried across after frame 1; both packages step frame 2, a keyframe
    that maps sparse over a nonempty stable set."""
    prune = dict(k0=2, step_frac=0.1, stable_ema_beta=0.5, stable_rel=1.0,
                 stable_age=1)
    ds_j = jmake_dataset("desk0", num_frames=8, height=48, width=64,
                         num_gaussians=400, frag_capacity=48)
    cfg_j = jsession.SLAMConfig(keyframe=JPolicy(kind="monogs", interval=2),
                                scan_unroll=1, sparse_opt=True, prune=JPrune(**prune),
                                **SESSION_CFG)
    sess_j = jsession.session_init(ds_j, cfg_j, seed=SEED)
    sess_j, _ = jsession.session_step(sess_j, ds_j.frames[1])
    carried = jax.device_get(sess_j)
    assert np.asarray(carried.pstate.stable).any()
    sess_j, ref = jsession.session_step(sess_j, ds_j.frames[2])
    ref = jax.device_get(ref)

    cfg_t = tsession.SLAMConfig(keyframe=TPolicy(kind="monogs", interval=2),
                                sparse_opt=True, prune=TPrune(**prune), **SESSION_CFG)
    ds_t = convert.dataset_from_numpy(ds_j, device="cpu")
    sess_t = convert.session_from_numpy(carried, cfg_t, ds_t.intrinsics, device="cpu")
    sess_t, res = tsession.session_step(sess_t, ds_t.frames[2],
                                        perm=_jax_perm(2, cfg_t.densify_per_kf))
    assert res.is_kf and bool(ref.is_kf)
    np.testing.assert_allclose(np_(res.pose), np.asarray(ref.pose), atol=1e-4)
    for f in ("unstable_gaussians", "sched_programs", "skipped_fragments"):
        assert int(getattr(res.work, f)) == int(getattr(ref.work, f)), f
    assert int(res.work.skipped_fragments) > 0
    assert int(res.work.unstable_gaussians) < int(res.work.gaussians_iters)
    assert np.array_equal(np_(sess_t.pstate.stable), np.asarray(sess_j.pstate.stable))
