"""Parity of the port's other base algorithms with ``repro``'s: GS-SLAM
(pose-distance keyframes, decided after tracking), Photo-SLAM (geometric
frame-to-frame tracking, ``slam/geometric.py``, and photometric keyframes)
and SplaTAM (every frame a keyframe), each with §4.1 pruning on as RTGS
applies it (Photo-SLAM's tracking renders nothing, so nothing accumulates
there).

Both packages run the same 5-frame 64x64 room0 dataset (made by ``repro``,
carried across with ``dataset_from_numpy``), the reference on its ``ref``
backend, the port on ``kernel`` (plain K1/K2 on the CPU), fed the
reference's densify permutations.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _shared_runs import Builds
from _torch_parity import jx, np_, th
from _torch_parity import one_cpu_thread  # noqa: F401  (autouse fixture)
from repro.core import lie as jlie
from repro.core.keyframes import KeyframePolicy as JPolicy
from repro.core.pruning import PruneConfig as JPrune
from repro.slam import geometric as jgeo
from repro.slam import session as jsession
from repro.slam.datasets import make_dataset as jmake_dataset
from repro_torch import convert
from repro_torch.core.keyframes import KeyframePolicy as TPolicy
from repro_torch.core.pruning import PruneConfig as TPrune
from repro_torch.slam import geometric as tgeo
from repro_torch.slam import session as tsession

CFG = dict(iters_track=3, iters_map=4, capacity=1024, frag_capacity=48,
           map_window=2)
PRUNE = dict(k0=2, step_frac=0.08)
POLICIES = {"gsslam": dict(kind="gsslam", trans_thresh=0.08, rot_thresh=0.08),
            "photoslam": dict(kind="photoslam", pho_thresh=0.04),
            "splatam": dict(kind="splatam")}
FRAMES, SEED = 5, 0


def _jax_perm(idx, per):
    key = jax.random.fold_in(jax.random.PRNGKey(SEED), idx)
    return torch.as_tensor(np.array(jax.random.permutation(key, 2 * per)))


def _datasets():
    ds_j = jmake_dataset("room0", num_frames=FRAMES, height=64, width=64,
                         num_gaussians=400, frag_capacity=48)
    return ds_j, convert.dataset_from_numpy(ds_j, device="cpu")


@pytest.fixture(scope="module")
def dataset():
    return _datasets()


def _cfg_t(algo):
    return tsession.SLAMConfig(base_algo=algo, prune=TPrune(**PRUNE),
                               keyframe=TPolicy(**POLICIES[algo]), **CFG)


def _build_data(_):
    ds_j, ds_t = _datasets()
    per = _cfg_t("splatam").densify_per_kf      # the config's default, as every algo's
    return dict(ds_j=ds_j, ds_t=ds_t, perms={i: _jax_perm(i, per) for i in range(1, FRAMES)})


def _build_ref(algo):
    def build(runs):
        """The reference's run of ``algo``: its state after every frame and
        its results."""
        ds_j = runs["ds_j"]
        cfg_j = jsession.SLAMConfig(backend="ref", base_algo=algo, prune=JPrune(**PRUNE),
                                    keyframe=JPolicy(**POLICIES[algo]), **CFG)
        sess = jsession.session_init(ds_j, cfg_j, seed=SEED)
        states, steps = [jax.device_get(sess)], []
        for idx in range(1, FRAMES):
            sess, res = jsession.session_step(sess, ds_j.frames[idx])
            states.append(jax.device_get(sess))
            steps.append(jax.device_get(res))
        res_j = jsession.session_finalize(sess, gt_w2c=[f.w2c_gt for f in ds_j.frames])
        return {f"states_{algo}": states, f"steps_{algo}": steps, f"res_j_{algo}": res_j}

    return build


def _build_port(algo):
    def build(runs):
        """The port's run of ``algo``, fed the reference's densify picks."""
        return {f"res_t_{algo}": tsession.run_sequence(runs["ds_t"], _cfg_t(algo), device="cpu",
                                                       seed=SEED, perms=runs["perms"])}

    return build


class _AlgoRuns:
    """One base algorithm's view of the module's builds: ``runs["steps"]``
    is ``builds["steps_<algo>"]``."""

    def __init__(self, builds, algo):
        self.builds, self.algo, self.cfg_t = builds, algo, _cfg_t(algo)

    def prefetch(self):
        """Both runs of this algorithm, the one no other worker is making
        first."""
        self.builds.prefetch(f"ref_{self.algo}", f"port_{self.algo}")

    def __getitem__(self, key):
        if key == "algo":
            return self.algo
        if key == "cfg_t":
            return self.cfg_t
        if key in ("ds_t", "perms"):
            return self.builds[key]
        return self.builds[f"{key}_{self.algo}"]


@pytest.fixture(scope="module")
def builds(request, tmp_path_factory):
    """The inputs, and each base algorithm's reference run and port run,
    each built once per test run (``tests/_shared_runs.py``) and apart, so
    several workers build them at once."""
    parts = {"data": (("ds_j", "ds_t", "perms"), _build_data)}
    for algo in POLICIES:
        parts[f"ref_{algo}"] = ((f"states_{algo}", f"steps_{algo}", f"res_j_{algo}"),
                                _build_ref(algo))
        parts[f"port_{algo}"] = ((f"res_t_{algo}",), _build_port(algo))
    return Builds(request, tmp_path_factory, "torch_algos", parts)


@pytest.fixture(scope="module", params=sorted(POLICIES))
def runs(request, builds):
    return _AlgoRuns(builds, request.param)


def test_keyframes_and_alive_over_a_run_match(runs):
    runs.prefetch()
    flags = [bool(s.is_kf) for s in runs["steps"]]
    res_t, res_j = runs["res_t"], runs["res_j"]
    assert len(res_t.keyframe_psnr) == len(res_j.keyframe_psnr) == 1 + sum(flags)
    # SplaTAM maps every frame, and so does Photo-SLAM at pho_thresh 0.04
    # on this scene; GS-SLAM's pose distance skips some frames.
    if runs["algo"] == "gsslam":
        assert 0 < sum(flags) < FRAMES - 1, flags
    else:
        assert all(flags), flags
    assert res_t.alive_per_frame == res_j.alive_per_frame
    assert res_t.prune_removed == res_j.prune_removed
    assert (res_t.prune_removed == 0) == (runs["algo"] == "photoslam")
    assert res_t.ate < 0.6 and res_t.mean_psnr > 14.0


@pytest.mark.parametrize("after", [1, 3])
def test_one_step_from_carried_state(runs, after):
    """The port started from the reference's state after frame ``after``:
    one step gives the pose within 1e-4 per entry, the keyframe flag, the
    alive count and the work counters."""
    sess = convert.session_from_numpy(runs["states"][after], runs["cfg_t"],
                                      runs["ds_t"].intrinsics, device="cpu")
    idx = after + 1
    sess, res = tsession.session_step(sess, runs["ds_t"].frames[idx],
                                      perm=runs["perms"][idx])
    ref = runs["steps"][after]
    assert res.is_kf == bool(ref.is_kf)
    np.testing.assert_allclose(np_(res.pose), np.asarray(ref.pose), atol=1e-4)
    assert int(res.alive) == int(ref.alive)
    for f, v in zip(ref.work._fields, ref.work):
        assert int(getattr(res.work, f)) == int(v), f
    assert np_(res.fired).tolist() == np.asarray(ref.fired).tolist()


def test_geometric_tracker_matches(dataset):
    """Back-projection, bilinear sampling, the loss and its pose gradient,
    and the 12-step geometric track, against ``repro.slam.geometric``."""
    ds_j, ds_t = dataset
    intr_j, intr_t = ds_j.intrinsics, ds_t.intrinsics
    prev, cur = ds_j.frames[1], ds_j.frames[2]
    pose = np.asarray(prev.w2c_gt, np.float32)
    out_j = jgeo.backproject_grid(jx(prev.rgb), jx(prev.depth), jx(pose), intr_j, stride=4)
    out_t = tgeo.backproject_grid(th(prev.rgb), th(prev.depth), th(pose), intr_t, stride=4)
    for a, b in zip(out_t, out_j):
        np.testing.assert_allclose(np_(a), np.asarray(b), rtol=1e-5, atol=1e-6)
    r = np.random.default_rng(0)
    uv = r.uniform(-2, 66, size=(200, 2)).astype(np.float32)
    np.testing.assert_allclose(np_(tgeo.bilinear_sample(th(cur.rgb), th(uv))),
                               np.asarray(jgeo.bilinear_sample(jx(cur.rgb), jx(uv))),
                               rtol=1e-5, atol=1e-6)
    base = np.asarray(cur.w2c_gt, np.float32)
    base = (np.asarray(jlie.se3_exp(jnp.asarray([0.01, -0.02, 0.01, 0.005, 0.0, -0.01])))
            @ base).astype(np.float32)
    xi = np.array([0.002, 0.001, -0.003, 0.001, -0.002, 0.0], np.float32)
    loss_j, g_j = jgeo.make_geometric_tracker(intr_j)(
        jx(xi), jx(base), *out_j[:2], out_j[3], jx(cur.rgb), jx(cur.depth))
    loss_t, g_t = tgeo.make_geometric_tracker(intr_t)(
        th(xi), th(base), out_t[0], out_t[1], out_t[3], th(cur.rgb), th(cur.depth))
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    np.testing.assert_allclose(np_(g_t), np.asarray(g_j), rtol=1e-4,
                               atol=1e-4 * float(np.abs(np.asarray(g_j)).max()))
    xi_t = tgeo.geometric_track(intr_t, th(base), out_t[0], out_t[1], out_t[3],
                                th(cur.rgb), th(cur.depth), iters=12, lr_pose=3e-3)
    cfg_j = jsession.SLAMConfig(iters_track=12, lr_pose=3e-3)
    geo_scan = jsession.get_geo_scan(intr_j, cfg_j)[0]
    xi_j = geo_scan(jx(base), *out_j[:2], out_j[3], jx(cur.rgb), jx(cur.depth))
    np.testing.assert_allclose(np_(xi_t), np.asarray(xi_j), atol=1e-5)


@pytest.mark.parametrize("kind", ["monogs", "gsslam", "photoslam", "splatam"])
def test_keyframe_policy_matches(kind):
    """``KeyframePolicy.is_keyframe`` on the host against the reference's
    for poses and images on both sides of each threshold."""
    r = np.random.default_rng(len(kind))
    kw = dict(kind=kind, interval=4, trans_thresh=0.1, rot_thresh=0.1, pho_thresh=0.1)
    jpol, tpol = JPolicy(**kw), TPolicy(**kw)
    last = np.asarray(jlie.se3_exp(jx(r.normal(size=6) * 0.3)), np.float32)
    rgb0 = r.uniform(size=(8, 8, 3)).astype(np.float32)
    for step in (0.0, 0.03, 0.3):
        cur = (np.asarray(jlie.se3_exp(jx(r.normal(size=6) * step))) @ last
               ).astype(np.float32)
        rgb = np.clip(rgb0 + r.normal(scale=step, size=rgb0.shape), 0, 1).astype(np.float32)
        for idx, since in ((0, 0), (3, 3), (9, 5)):
            want = jpol.is_keyframe(idx, since, cur, last, rgb, rgb0)
            got = tpol.is_keyframe(idx, since, cur_pose=th(cur), last_kf_pose=th(last),
                                   cur_rgb=th(rgb), last_kf_rgb=th(rgb0))
            assert got == want, (idx, since, step)
    with pytest.raises(ValueError):
        TPolicy(kind="orbslam")
