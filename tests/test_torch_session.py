"""Parity of the port's MonoGS session with ``repro``'s.

Both packages run the same 6-frame 64x64 room0 dataset (made by ``repro``
and carried across with ``dataset_from_numpy``) under the same config, the
reference on its ``ref`` backend and the port on its ``kernel`` backend
(plain K1/K2 on the CPU).  The densify pick is the one random draw of the
step; the port is fed the reference's ``jax.random`` permutation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _shared_runs import Builds
from _torch_parity import jx, np_, th
from _torch_parity import one_cpu_thread  # noqa: F401  (autouse fixture)
from repro.core import gaussians as JG
from repro.core.camera import Intrinsics as JIntr
from repro.core.keyframes import KeyframePolicy as JPolicy
from repro.slam import session as jsession
from repro.slam.datasets import make_dataset as jmake_dataset
from repro_torch import convert
from repro_torch.core import gaussians as TG
from repro_torch.core.camera import Intrinsics as TIntr
from repro_torch.core.keyframes import KeyframePolicy as TPolicy
from repro_torch.slam import session as tsession

CFG = dict(iters_track=3, iters_map=4, capacity=1024, frag_capacity=48,
           map_window=2)
FRAMES, SEED = 6, 0


def _jax_perm(idx, per):
    """The reference's densify permutation of frame ``idx`` (its
    ``jax.random.permutation`` of the 2P candidates), as indices."""
    key = jax.random.fold_in(jax.random.PRNGKey(SEED), idx)
    return torch.as_tensor(np.array(jax.random.permutation(key, 2 * per)))


def _build_data(_):
    ds_j = jmake_dataset("room0", num_frames=FRAMES, height=64, width=64,
                         num_gaussians=400, frag_capacity=48)
    cfg_t = tsession.SLAMConfig(keyframe=TPolicy(interval=2), **CFG)
    perms = {i: _jax_perm(i, cfg_t.densify_per_kf) for i in range(1, FRAMES)}
    return dict(ds_j=ds_j, ds_t=convert.dataset_from_numpy(ds_j, device="cpu"),
                cfg_t=cfg_t, perms=perms)


def _build_ref(runs):
    """The reference's run: its state after every frame and its results."""
    ds_j = runs["ds_j"]
    cfg_j = jsession.SLAMConfig(backend="ref", keyframe=JPolicy(interval=2), **CFG)
    sess = jsession.session_init(ds_j, cfg_j, seed=SEED)
    states, steps = [jax.device_get(sess)], []
    for idx in range(1, FRAMES):
        sess, res = jsession.session_step(sess, ds_j.frames[idx])
        states.append(jax.device_get(sess))
        steps.append(jax.device_get(res))
    res_j = jsession.session_finalize(sess, gt_w2c=[f.w2c_gt for f in ds_j.frames])
    return dict(states=states, steps=steps, res_j=res_j)


def _build_port(runs):
    """The port's run, fed the reference's densify permutations."""
    ds_t, perms = runs["ds_t"], runs["perms"]
    sess_t = tsession.session_init(ds_t, runs["cfg_t"], seed=SEED, device="cpu")
    steps_t = []
    for idx in range(1, FRAMES):
        sess_t, r = tsession.session_step(sess_t, ds_t.frames[idx], perm=perms[idx])
        steps_t.append(r)
    res_t = tsession.session_finalize(sess_t, gt_w2c=[f.w2c_gt for f in ds_t.frames])
    return dict(steps_t=steps_t, res_t=res_t)


@pytest.fixture(scope="module")
def runs(request, tmp_path_factory):
    """The inputs, the reference's run and the port's, each built once per
    test run (``tests/_shared_runs.py``) and apart, so two workers build
    the two runs at once."""
    return Builds(request, tmp_path_factory, "torch_session", {
        "data": (("ds_j", "ds_t", "cfg_t", "perms"), _build_data),
        "ref": (("states", "steps", "res_j"), _build_ref),
        "port": (("steps_t", "res_t"), _build_port)})


def test_keyframe_flags_match(runs):
    runs.prefetch("ref", "port")
    flags_j = [bool(s.is_kf) for s in runs["steps"]]
    assert flags_j == [s.is_kf for s in runs["steps_t"]]
    assert flags_j == [False, True, False, True, False]
    assert len(runs["res_t"].keyframe_psnr) == len(runs["res_j"].keyframe_psnr)


@pytest.mark.parametrize("after", [1, 2, 3])
def test_one_step_from_carried_state(runs, after):
    """Start the port from the reference's state after frame ``after`` and
    step both once: the tracked pose agrees within 1e-4 per entry; on a
    keyframe the densified map keeps the same alive set."""
    ds_t, cfg_t = runs["ds_t"], runs["cfg_t"]
    intr = ds_t.intrinsics
    sess = convert.session_from_numpy(runs["states"][after], cfg_t, intr,
                                      device="cpu")
    assert sess.frame_idx == after + 1
    idx = after + 1
    sess, res = tsession.session_step(sess, ds_t.frames[idx], perm=runs["perms"][idx])
    ref = runs["steps"][after]
    assert res.is_kf == bool(ref.is_kf)
    np.testing.assert_allclose(np_(res.pose), np.asarray(ref.pose), atol=1e-4)
    assert int(res.alive) == int(ref.alive)
    for f, v in zip(ref.work._fields, ref.work):
        assert int(getattr(res.work, f)) == int(v), f
    if res.is_kf:
        np.testing.assert_allclose(float(res.psnr), float(ref.psnr), atol=0.1)


def test_six_frame_run_matches(runs):
    """Whole-run agreement: camera centres within 1 cm, ATE within 1 cm,
    mean keyframe PSNR within 0.1 dB, the same alive counts.

    The centres agree to 2e-5 m until the first keyframe's mapping and to
    7.5e-3 m after it (measured).  Adam divides each gradient by its own
    running RMS, so a Gaussian whose gradient is at rounding level moves a
    whole learning-rate step (8e-3) in the direction of its rounding error:
    the two backends' last-bit differences move such Gaussians by up to
    6 mm per mapping phase, and later tracking follows the moved map.  One
    step from a shared state (``test_one_step_from_carried_state``) agrees
    within 1e-4."""
    runs.prefetch("ref", "port")
    res_j, res_t = runs["res_j"], runs["res_t"]

    def centres(poses):
        return np.stack([np.linalg.inv(np.asarray(p, np.float64))[:3, 3] for p in poses])

    d = np.linalg.norm(centres(res_t.est_w2c) - centres(res_j.est_w2c), axis=-1)
    assert d[:3].max() < 1e-4, d
    assert d.max() < 1e-2, d
    assert abs(res_t.ate - res_j.ate) < 1e-2
    assert abs(res_t.mean_psnr - res_j.mean_psnr) < 0.1
    assert res_t.alive_per_frame == res_j.alive_per_frame


def test_work_counters_match(runs):
    """Run totals of the work counters equal the reference's; the fragment
    total follows the poses and maps (see above), within 1% (0.5%
    measured)."""
    runs.prefetch("ref", "port")
    w_j, w_t = runs["res_j"].work, runs["res_t"].work
    for f in ("pixels", "gaussians_iters", "iterations", "frames",
              "unstable_gaussians", "skipped_fragments", "densify_dropped",
              "frag_build_rows", "sched_programs"):
        assert getattr(w_t, f) == getattr(w_j, f), f
    assert abs(w_t.fragments - w_j.fragments) <= 0.01 * w_j.fragments


def test_densify_core_matches(runs):
    """One densification on the same inputs and permutation: the same rows
    become alive with the same parameters (1-ulp float slack)."""
    state = runs["states"][3]
    ds_j = runs["ds_j"]
    frame = ds_j.frames[4]
    intr_j = ds_j.intrinsics
    cfg_j = jsession.SLAMConfig(backend="ref", **CFG)
    r = np.random.default_rng(0)
    rendered = np.clip(frame.rgb + r.normal(scale=0.1, size=frame.rgb.shape),
                       0, 1).astype(np.float32)
    key = jax.random.fold_in(jax.random.PRNGKey(SEED), 4)
    g_j, drop_j = jsession._densify_core(
        JG.GaussianField(*map(jx, state.g)), jx(frame.rgb), jx(frame.depth),
        jx(rendered), jx(state.pose), intr_j, cfg_j, key)
    intr_t = TIntr(*intr_j)
    g_t, drop_t = tsession._densify_core(
        convert.field_from_numpy(state.g, device="cpu"), th(frame.rgb),
        th(frame.depth), th(rendered), th(state.pose), intr_t, runs["cfg_t"], None,
        perm=runs["perms"][4])
    assert int(drop_t) == int(drop_j)
    for f in TG.PARAM_FIELDS + ("alive",):
        np.testing.assert_allclose(np_(getattr(g_t, f)), np_(getattr(g_j, f)),
                                   rtol=1e-6, atol=1e-6, err_msg=f)


@pytest.mark.parametrize("n", [1, 2, 5, 8])
def test_median_is_the_reference_nanmedian(n):
    """An even count averages the two middle values, as ``jnp.nanmedian``
    does (``torch.median`` returns the lower one)."""
    x = np.random.default_rng(n).uniform(0.5, 4.0, n).astype(np.float32)
    want = float(jnp.nanmedian(jnp.where(jnp.arange(n + 3) < n,
                                         jnp.pad(jx(x), (0, 3)), jnp.nan)))
    got = tsession._median_linear(th(x), torch.ones(n, dtype=torch.bool))
    assert float(got) == pytest.approx(want, rel=1e-7)


@pytest.mark.parametrize("count", [0, 1, 2, 5])
def test_push_ring_matches(count):
    r = np.random.default_rng(count)
    buf = r.normal(size=(2, 3, 4)).astype(np.float32)
    row = r.normal(size=(3, 4)).astype(np.float32)
    want = jsession._push_ring(jx(buf), jx(row), jnp.asarray(count))
    got = tsession._push_ring(th(buf), th(row), torch.tensor(count))
    assert np.array_equal(np_(got), np_(want))


def test_converters_carry_state_across(runs):
    state = runs["states"][2]
    sess = convert.session_from_numpy(state, runs["cfg_t"], runs["ds_t"].intrinsics,
                                  device="cpu")
    assert np.array_equal(np_(sess.g.mu), np.asarray(state.g.mu))
    assert sess.kf_count == int(state.kf_count) and sess.kf_total == int(state.kf_total)
    opt = convert.adam_from_numpy(state.map_opt, device="cpu")
    assert int(opt.step) == int(state.map_opt.step)
    for k in TG.PARAM_FIELDS:
        assert np.array_equal(np_(opt.mu[k]), np.asarray(state.map_opt.mu[k]))
    assert sess.work.fragments.dtype == torch.int64
    assert tuple(runs["ds_t"].intrinsics) == tuple(JIntr(*runs["ds_j"].intrinsics))
