"""Parity of the port's scheduled SLAM engine with ``repro``'s: one
tracking phase and one mapping phase (stride rebuilds included) on the
``schedule`` backend, from the same seeded map.  The pose, the losses and
every work counter, ``sched_programs`` (the schedules' trips) included,
are compared.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _shared_runs import Builds
from _torch_parity import jx, np_, one_cpu_thread, th  # noqa: F401 (autouse)
from repro.core import gaussians as JG
from repro.core.keyframes import KeyframePolicy as JPolicy
from repro.slam import engine as jengine
from repro.slam import metrics as jmetrics
from repro.slam import session as jsession
from repro.slam.datasets import make_dataset as jmake_dataset
from repro_torch import convert
from repro_torch.core import gaussians as TG
from repro_torch.core.keyframes import KeyframePolicy as TPolicy
from repro_torch.slam import engine as tengine
from repro_torch.slam import metrics as tmetrics
from repro_torch.slam import session as tsession

ENGINE_CFG = dict(iters_track=3, iters_map=6, capacity=1024, frag_capacity=48,
                  map_window=2, map_rebuild_stride=3, backend="schedule")


def _setup():
    """Both packages' seeded map and stage on the schedule backend."""
    ds_j = jmake_dataset("room0", num_frames=3, height=64, width=64,
                         num_gaussians=400, frag_capacity=48)
    # scan_unroll=1 keeps the reference's scans rolled: it compiles faster.
    cfg_j = jsession.SLAMConfig(keyframe=JPolicy(interval=2), scan_unroll=1,
                                **ENGINE_CFG)
    cfg_t = tsession.SLAMConfig(keyframe=TPolicy(interval=2), **ENGINE_CFG)
    g_j = jsession._seed_map(ds_j, cfg_j)
    masked_j = jnp.zeros((cfg_j.capacity,), bool)
    st_j = jengine._Stage(ds_j.intrinsics, cfg_j, 1)
    ds_t = convert.dataset_from_numpy(ds_j, device="cpu")
    g_t = convert.field_from_numpy(jax.device_get(g_j), device="cpu")
    masked_t = torch.zeros((cfg_t.capacity,), dtype=torch.bool)
    st_t = tengine._Stage(ds_t.intrinsics, cfg_t, torch.device("cpu"))
    return ds_j, cfg_j, cfg_t, g_j, masked_j, st_j, ds_t, g_t, masked_t, st_t


def _build_track(_):
    """One tracking phase of each package's engine."""
    ds_j, _, _, g_j, masked_j, st_j, ds_t, g_t, masked_t, st_t = _setup()
    f1 = ds_j.frames[1]
    base = np.asarray(ds_j.frames[0].w2c_gt)
    frags_j = st_j.build(g_j, masked_j, jx(base))
    xi_j, work_tj, losses_tj, _ = st_j.track_scan_noprune(
        g_j, masked_j, jx(base), jnp.asarray(f1.rgb), jnp.asarray(f1.depth),
        frags_j, jmetrics.device_work_zero())
    # The port's tracking segment builds the frame's lists itself.
    xi_t, work_tt, losses_tt, _ = st_t._track_scan_noprune(
        g_t, masked_t, th(base), ds_t.frames[1].rgb, ds_t.frames[1].depth,
        tmetrics.device_work_zero())
    return dict(track=jax.device_get((xi_j, work_tj, losses_tj)) + (xi_t, work_tt, losses_tt))


def _build_map(_):
    """One mapping phase (stride rebuilds included) of each package's
    engine."""
    ds_j, cfg_j, cfg_t, g_j, masked_j, st_j, _, g_t, masked_t, st_t = _setup()
    f1 = ds_j.frames[1]
    kf = [ds_j.frames[0], f1]
    kf_w2c = np.stack([np.asarray(f.w2c_gt) for f in kf])
    kf_rgb = np.stack([np.asarray(f.rgb) for f in kf])
    kf_depth = np.stack([np.asarray(f.depth) for f in kf])
    opt_j = jsession.Adam(lr=cfg_j.lr_map).init(JG.params_of(g_j))
    _, _, work_mj, losses_mj, image_j = st_j.map_scan_masked(
        g_j, masked_j, opt_j, jx(kf_w2c), jx(kf_rgb), jx(kf_depth),
        jnp.ones((2,), bool), jmetrics.device_work_zero())
    opt_t = tsession.Adam(lr=cfg_t.lr_map).init(TG.params_of(g_t))
    _, _, work_mt, losses_mt, image_t = st_t._map_scan_masked(
        g_t, masked_t, opt_t, th(kf_w2c), th(kf_rgb), th(kf_depth), 2,
        tmetrics.device_work_zero())
    return dict(map=jax.device_get((work_mj, losses_mj, image_j)) + (work_mt, losses_mt, image_t),
                rgb=np.asarray(f1.rgb))


@pytest.fixture(scope="module")
def engine_runs(request, tmp_path_factory):
    """One tracking phase and one mapping phase (stride rebuilds included)
    of each package's engine on the schedule backend, from the same seeded
    map: each built once per test run (``tests/_shared_runs.py``) and
    apart, so two workers build them at once."""
    return Builds(request, tmp_path_factory, "torch_schedule_engine", {
        "track": (("track",), _build_track), "map": (("map", "rgb"), _build_map)})


def _assert_work_equal(work_j, work_t):
    for f in work_j._fields:
        assert int(getattr(work_t, f)) == int(getattr(work_j, f)), f


def test_engine_scheduled_tracking_phase_matches(engine_runs):
    xi_j, work_j, losses_j, xi_t, work_t, losses_t = engine_runs["track"]
    np.testing.assert_allclose(np_(xi_t), np.asarray(xi_j), atol=1e-4)
    np.testing.assert_allclose(np_(losses_t), np.asarray(losses_j), rtol=1e-4)
    _assert_work_equal(work_j, work_t)


def test_engine_scheduled_mapping_phase_matches(engine_runs):
    """Every work counter (``sched_programs`` counts the schedules'
    trips, rebuilt on the stride) is equal; the losses agree to
    1e-3 relative and the eval image's PSNR to 0.1 dB.  Over six Adam steps
    the losses drift apart by ~2e-4 relative and a few eval pixels by up to
    7e-3 (measured): Adam moves a Gaussian whose gradient is at rounding
    level by a whole learning-rate step (ROADMAP, Queue 3)."""
    work_j, losses_j, image_j, work_t, losses_t, image_t = engine_runs["map"]
    np.testing.assert_allclose(np_(losses_t), np.asarray(losses_j), rtol=1e-3)
    rgb = engine_runs["rgb"]
    assert tmetrics.psnr_np(np_(image_t), rgb) == pytest.approx(
        tmetrics.psnr_np(np.asarray(image_j), rgb), abs=0.1)
    _assert_work_equal(work_j, work_t)
    assert int(work_t.sched_programs) > 0
