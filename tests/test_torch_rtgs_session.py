"""Parity of the port's RTGS session (§4.1 pruning + §4.2 downsampling on
MonoGS) with ``repro``'s.

Both packages run the same 6-frame 64x64 room0 dataset (made by ``repro``,
carried across with ``dataset_from_numpy``): MonoGS keyframes every 3
frames, so the tracking factors are 4, 2, 1 (keyframe), 4, 2 and all three
tile grids (1, 4 and 16 tiles) occur; ``PruneConfig(k0=2,
step_frac=0.08)``, so pruning boundaries fire inside the first frame's
tracking.  The reference runs on its ``ref`` backend, the port on
``kernel`` (plain K1/K2 on the CPU), fed the reference's densify
permutations.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from _shared_runs import Builds
from _torch_parity import np_
from _torch_parity import one_cpu_thread  # noqa: F401  (autouse fixture)
from repro.core.downsample import DownsampleConfig as JDown
from repro.core.downsample import side_factor as jside_factor
from repro.core.keyframes import KeyframePolicy as JPolicy
from repro.core.pruning import PruneConfig as JPrune
from repro.slam import session as jsession
from repro.slam.datasets import make_dataset as jmake_dataset
from repro_torch import convert
from repro_torch.core import pruning as tpruning
from repro_torch.core.downsample import DownsampleConfig as TDown
from repro_torch.core.keyframes import KeyframePolicy as TPolicy
from repro_torch.core.pruning import PruneConfig as TPrune
from repro_torch.slam import session as tsession

CFG = dict(iters_track=3, iters_map=4, capacity=1024, frag_capacity=48,
           map_window=2)
PRUNE = dict(k0=2, step_frac=0.08)
FRAMES, SEED, INTERVAL = 6, 0, 3


def _jax_perm(idx, per):
    key = jax.random.fold_in(jax.random.PRNGKey(SEED), idx)
    return torch.as_tensor(np.array(jax.random.permutation(key, 2 * per)))


def _cfg_t(**kw):
    return tsession.SLAMConfig(keyframe=TPolicy(interval=INTERVAL),
                               prune=TPrune(**PRUNE),
                               downsample=TDown(enabled=True), **CFG, **kw)


def _run_port(ds_t, cfg_t, perms):
    sess = tsession.session_init(ds_t, cfg_t, seed=SEED, device="cpu")
    steps, factors, last = [], [], 0
    for idx in range(1, FRAMES):
        f = tsession.frame_factor(ds_t, idx, last, cfg_t)
        sess, r = tsession.session_step(sess, ds_t.frames[idx], factor=f,
                                        perm=perms[idx])
        steps.append(r)
        factors.append(f)
        last = idx if r.is_kf else last
    res = tsession.session_finalize(sess, gt_w2c=[f.w2c_gt for f in ds_t.frames])
    return sess, steps, factors, res


def _build_data(_):
    ds_j = jmake_dataset("room0", num_frames=FRAMES, height=64, width=64,
                         num_gaussians=400, frag_capacity=48)
    cfg_t = _cfg_t()
    perms = {i: _jax_perm(i, cfg_t.densify_per_kf) for i in range(1, FRAMES)}
    return dict(ds_j=ds_j, ds_t=convert.dataset_from_numpy(ds_j, device="cpu"),
                cfg_t=cfg_t, perms=perms)


def _build_ref(runs):
    """The reference's run: its state after every frame, its steps and
    factors, and its results."""
    ds_j = runs["ds_j"]
    cfg_j = jsession.SLAMConfig(backend="ref", keyframe=JPolicy(interval=INTERVAL),
                                prune=JPrune(**PRUNE),
                                downsample=JDown(enabled=True), **CFG)
    sess = jsession.session_init(ds_j, cfg_j, seed=SEED)
    states, steps, factors, last = [jax.device_get(sess)], [], [], 0
    for idx in range(1, FRAMES):
        f = jside_factor(idx - last, idx - last >= INTERVAL, cfg_j.downsample)
        sess, res = jsession.session_step(sess, ds_j.frames[idx], factor=f)
        states.append(jax.device_get(sess))
        steps.append(jax.device_get(res))
        factors.append(f)
        last = idx if bool(res.is_kf) else last
    res_j = jsession.session_finalize(sess, gt_w2c=[f.w2c_gt for f in ds_j.frames])
    return dict(states=states, steps=steps, factors=factors, res_j=res_j)


def _build_port(runs):
    _, steps_t, factors_t, res_t = _run_port(runs["ds_t"], runs["cfg_t"], runs["perms"])
    return dict(steps_t=steps_t, factors_t=factors_t, res_t=res_t)


@pytest.fixture(scope="module")
def runs(request, tmp_path_factory):
    """The inputs, the reference's run and the port's, each built once per
    test run (``tests/_shared_runs.py``) and apart, so two workers build
    the two runs at once."""
    return Builds(request, tmp_path_factory, "torch_rtgs_session", {
        "data": (("ds_j", "ds_t", "cfg_t", "perms"), _build_data),
        "ref": (("states", "steps", "factors", "res_j"), _build_ref),
        "port": (("steps_t", "factors_t", "res_t"), _build_port)})


def test_factors_keyframes_fired_alive_and_removed_match(runs):
    runs.prefetch("ref", "port")
    assert runs["factors"] == [4, 2, 1, 4, 2]
    assert runs["factors_t"] == runs["factors"]
    assert [s.is_kf for s in runs["steps_t"]] == [bool(s.is_kf) for s in runs["steps"]]
    for s_t, s_j in zip(runs["steps_t"], runs["steps"]):
        assert np_(s_t.fired).tolist() == np.asarray(s_j.fired).tolist()
    assert any(np.asarray(s.fired).any() for s in runs["steps"])
    res_t, res_j = runs["res_t"], runs["res_j"]
    assert res_t.alive_per_frame == res_j.alive_per_frame
    assert res_t.prune_removed == res_j.prune_removed > 0


class _SelectionRecorder:
    """Wraps the port's ``interval_update`` and keeps the scores and alive
    set each boundary selected from."""

    def __init__(self):
        self.cuts = []
        self.inner = tpruning.interval_update

    def __call__(self, state, g, tile_count, cfg):
        self.cuts.append((state.score.clone(), (g.alive & ~state.masked).clone()))
        return self.inner(state, g, tile_count, cfg)


def near_cut(score, alive, want):
    """Alive rows whose selection score lies within 1e-5 of the cut (the
    ``want``-th lowest alive score), relative to the larger of the cut and
    the largest alive score.  The scale is the view's: most cuts sit at
    0, among the rows with no fragment, and a row whose alpha grazes the
    1/255 cut-off on one side only scores ~1e-9 there and 0 on the other."""
    s = score[alive]
    if want == 0 or s.numel() == 0:
        return torch.zeros_like(alive)
    cut = torch.sort(s).values[want - 1]
    scale = torch.maximum(cut.abs(), s.abs().max())
    return alive & ((score - cut).abs() <= 1e-5 * scale)


@pytest.mark.parametrize("after,n_differ", [(0, 0), (1, 0), (2, 0), (3, 0), (4, 2)])
def test_one_step_from_carried_state(runs, after, n_differ, monkeypatch):
    """Start the port from the reference's state after frame ``after`` and
    step both once: pose within 1e-4 per entry, equal work counters, equal
    alive and mask counts, and masked sets that differ only at near-ties
    of the selection cut, in as many rows as measured (frame 5: two rows
    that tie at the cut 0, one scoring 1e-9 in the port)."""
    state = runs["states"][after]
    sess = convert.session_from_numpy(state, runs["cfg_t"], runs["ds_t"].intrinsics,
                                      device="cpu")
    idx = after + 1
    rec = _SelectionRecorder()
    monkeypatch.setattr(tpruning, "interval_update", rec)
    sess, res = tsession.session_step(sess, runs["ds_t"].frames[idx],
                                      factor=runs["factors"][after],
                                      perm=runs["perms"][idx])
    ref, ref_state = runs["steps"][after], runs["states"][idx]
    assert res.is_kf == bool(ref.is_kf)
    assert np_(res.fired).tolist() == np.asarray(ref.fired).tolist()
    np.testing.assert_allclose(np_(res.pose), np.asarray(ref.pose), atol=1e-4)
    assert int(res.alive) == int(ref.alive)
    for f, v in zip(ref.work._fields, ref.work):
        assert int(getattr(res.work, f)) == int(v), f
    got, want = np_(sess.pstate.masked), np.asarray(ref_state.pstate.masked)
    assert got.sum() == want.sum()
    differ = got != want
    if rec.cuts:
        score, alive = rec.cuts[-1]
        near = np_(near_cut(score, alive, int(got.sum())))
        assert not (differ & ~near).any()
    assert int(differ.sum()) == n_differ
    for f in ("interval", "iters_left", "opt_steps"):
        assert int(getattr(sess.pstate, f)) == int(getattr(ref_state.pstate, f)), f
    for f in ("removed", "initial_alive", "prev_tile_count", "age", "stable"):
        assert np.array_equal(np_(getattr(sess.pstate, f)),
                              np.asarray(getattr(ref_state.pstate, f))), f
    assert sorted(sess.tile_baselines) == sorted(int(k) for k in ref_state.tile_baselines)
    if res.is_kf:
        np.testing.assert_allclose(float(res.psnr), float(ref.psnr), atol=0.1)


def test_whole_run_centres_match(runs):
    """Camera centres within 1e-4 m until the second mapping phase and
    within 3 cm over the run, ATE within 1 cm, mean keyframe PSNR within
    0.1 dB.

    The first keyframe's mapping leaves the maps apart by the rounding
    drift ``test_torch_session.py::test_six_frame_run_matches`` explains
    (0.38 mm at frame 4, measured).  Tracking then amplifies it: Adam's
    first pose steps move each tangent entry by about ``lr_pose`` in the
    sign of its gradient, so an entry whose gradient is near 0 at the
    downsampled 32x32 frame 5 steps the other way in the other package,
    up to 2 * 3e-3 per entry per iteration (1.7 cm measured).  The port's
    ``ref`` and ``kernel`` backends stay within 5e-7 m of each other over
    the same run, and one step from a shared state agrees within 1e-4
    (``test_one_step_from_carried_state``)."""
    runs.prefetch("ref", "port")
    res_j, res_t = runs["res_j"], runs["res_t"]

    def centres(poses):
        return np.stack([np.linalg.inv(np.asarray(p, np.float64))[:3, 3] for p in poses])

    d = np.linalg.norm(centres(res_t.est_w2c) - centres(res_j.est_w2c), axis=-1)
    assert d[:4].max() < 1e-4, d
    assert d.max() < 3e-2, d
    assert abs(res_t.ate - res_j.ate) < 1e-2
    assert abs(res_t.mean_psnr - res_j.mean_psnr) < 0.1


def test_schedule_equals_kernel_on_cpu(runs):
    """The WSU backend with pruning and downsampling gives the kernel
    backend's run bit for bit (boundaries rebuild its schedule)."""
    _, _, factors, res_s = _run_port(runs["ds_t"], _cfg_t(backend="schedule"),
                                     runs["perms"])
    res_k = runs["res_t"]
    assert factors == runs["factors_t"]
    assert np.array_equal(np.stack(res_s.est_w2c), np.stack(res_k.est_w2c))
    assert res_s.alive_per_frame == res_k.alive_per_frame
    assert res_s.prune_removed == res_k.prune_removed


def test_rtgs_reduces_work_against_port_baseline(runs):
    """``tests/test_system.py::test_rtgs_full_reduces_work_keeps_quality``'s
    criteria on the port: against the same config without pruning and
    downsampling, fewer pixels and Gaussian-iterations, Gaussians removed,
    ATE and PSNR in the baseline's regime."""
    cfg = dataclasses.replace(runs["cfg_t"], prune=None,
                              downsample=TDown(enabled=False))
    _, _, factors, base = _run_port(runs["ds_t"], cfg, runs["perms"])
    ours = runs["res_t"]
    assert factors == [1] * (FRAMES - 1)
    assert base.ate < 0.6 and base.mean_psnr > 14.0
    assert ours.work.pixels < base.work.pixels
    assert ours.work.gaussians_iters < base.work.gaussians_iters
    assert ours.prune_removed > 0
    assert ours.ate < max(2.0 * base.ate, 0.35)
    assert ours.mean_psnr > base.mean_psnr - 3.0
