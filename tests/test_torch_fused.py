"""The port's fused step engine (``SLAMConfig.fused``, ``slam/graphs.py``)
on the CPU.

On the CPU a fused session runs every phase segment through the runner's
static buffers with no capture, so these tests hold the buffer copies,
the carried state, the aliasing rules and the ``EngineStats`` counts; the
card tests (``tests/test_torch_cuda.py``) hold the CUDA graph replays.

* ``fused=True`` equals ``fused=False`` bit for bit on MonoGS (``kernel``),
  the WSU ``schedule`` backend, RTGS (§4.1 pruning and §4.2
  downsampling) and sparse mapping;
* a step's results and the session's fields are not written by the next
  step, and share no memory with the runner's buffers;
* dispatches and syncs follow the formula of ``slam/graphs.py``;
* the fused port against the reference's fused ``run_sequence`` on the
  same scene, within ``tests/test_torch_session.py``'s tolerances.

Inputs: the reference's 5-frame 64x64 room0 dataset, carried across with
``dataset_from_numpy``; densify picks drawn with numpy from a seed, or the
reference's ``jax.random`` permutation where the reference runs too.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core.keyframes import KeyframePolicy as JPolicy
from repro.slam import session as jsession
from repro.slam.datasets import make_dataset as jmake_dataset
from repro_torch import convert
from repro_torch.core.downsample import DownsampleConfig
from repro_torch.core.keyframes import KeyframePolicy
from repro_torch.core.pruning import PruneConfig
from repro_torch.slam import session as tsession
from repro_torch.slam.graphs import EngineStats

FRAMES, SEED = 5, 0
BASE = dict(iters_track=3, iters_map=8, capacity=1024, frag_capacity=48,
            map_window=2, map_rebuild_stride=3)
PATHS = {
    "monogs": {},
    "schedule": dict(backend="schedule"),
    "rtgs": dict(prune=PruneConfig(k0=2, step_frac=0.08),
                 downsample=DownsampleConfig(enabled=True)),
    # The stability warmup ends inside frame 3's tracking, so the
    # one-iteration pruning segment runs both before and after it.
    "sparse": dict(backend="schedule", sparse_opt=True,
                   prune=PruneConfig(k0=2, step_frac=0.1, stable_ema_beta=0.6,
                                     stable_rel=4.0, stable_age=2, stable_warmup=8)),
}


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """The sessions here are thousands of tiny CPU ops, which a pool of
    intra-op threads only slows, the more so when the test run's other
    workers hold every core; fused and eager run under the same setting,
    so their bits are compared like with like."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def data():
    ds_j = jmake_dataset("room0", num_frames=FRAMES, height=64, width=64,
                         num_gaussians=400, frag_capacity=48)
    rng = np.random.default_rng(SEED)
    perms = {i: torch.as_tensor(rng.permutation(2 * 384)) for i in range(1, FRAMES)}
    return ds_j, convert.dataset_from_numpy(ds_j, device="cpu"), perms


@pytest.fixture(scope="module")
def runs(data):
    """``_steps`` of each (path, fused), computed once for the module."""
    _, ds, perms = data
    cache = {}

    def get(path, fused):
        if (path, fused) not in cache:
            cache[(path, fused)] = _steps(ds, _cfg(path, fused), perms)
        return cache[(path, fused)]

    return get


def _cfg(path, fused, **kw):
    return tsession.SLAMConfig(keyframe=KeyframePolicy(interval=2), fused=fused,
                               **BASE, **PATHS[path], **kw)


def _steps(ds, cfg, perms):
    """Init and one step per frame at ``run_sequence``'s factors: the
    session after each step, the step results and each step's counts."""
    stats = EngineStats()
    sess = tsession.session_init(ds, cfg, seed=SEED, device="cpu", stats=stats)
    out, last = [], 0
    for idx in range(1, FRAMES):
        before = dataclasses.replace(stats)
        sess, r = tsession.session_step(
            sess, ds.frames[idx], factor=tsession.frame_factor(ds, idx, last, cfg),
            perm=perms[idx], stats=stats)
        out.append((sess, r, stats.since(before)))
        last = idx if r.is_kf else last
    return out


@pytest.mark.parametrize("path", list(PATHS))
def test_fused_equals_eager_bit_for_bit(runs, path):
    """Every step's pose, losses, boundary flags, PSNR and work counters
    and the final map, Adam state and pruning state: fused == eager."""
    fused, eager = runs(path, True), runs(path, False)
    for (s_f, r_f, _), (s_e, r_e, _) in zip(fused, eager):
        assert r_f.is_kf == r_e.is_kf
        for name in ("pose", "alive", "track_losses", "map_losses", "fired", "psnr"):
            assert _same(getattr(r_f, name), getattr(r_e, name)), name
        assert [int(v) for v in r_f.work] == [int(v) for v in r_e.work]
    s_f, s_e = fused[-1][0], eager[-1][0]
    for a, b in zip(_tensors(s_f), _tensors(s_e)):
        assert _same(a, b)
    if path in ("rtgs", "sparse"):
        assert sum(int(r.fired.sum()) for _, r, _ in fused) > 0
    if path == "sparse":
        assert int(s_f.pstate.stable.sum()) > 0


def _same(a, b) -> bool:
    """Bit for bit, NaNs included."""
    if a.is_floating_point():
        return torch.equal(a.isnan(), b.isnan()) and torch.equal(a.nan_to_num(),
                                                                 b.nan_to_num())
    return torch.equal(a, b)


def _tensors(tree):
    """Every tensor a session (or any nesting of dataclasses, NamedTuples,
    dicts and lists) holds, in a fixed order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        items = [tree[k] for k in sorted(tree)]
    elif dataclasses.is_dataclass(tree):
        items = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    elif isinstance(tree, (tuple, list)):
        items = list(tree)
    else:
        return []
    return [t for x in items for t in _tensors(x)]


def test_step_results_do_not_alias_the_next_step(data):
    """A fused step's results and the session's fields (all but the logs a
    step writes in place: trajectory, PSNR and alive) keep their values
    through the next step and share no memory with the runner's static
    buffers."""
    _, ds, perms = data
    cfg = _cfg("rtgs", True)
    stats = EngineStats()
    sess = tsession.session_init(ds, cfg, seed=SEED, device="cpu", stats=stats)
    logs = {id(sess.traj), id(sess.kf_psnr), id(sess.alive_log)}
    last = 0
    for idx in range(1, FRAMES):
        sess, r = tsession.session_step(
            sess, ds.frames[idx], factor=tsession.frame_factor(ds, idx, last, cfg),
            perm=perms[idx])
        last = idx if r.is_kf else last
        held = [t for t in _tensors(sess) if id(t) not in logs] + [
            t for t in r if isinstance(t, torch.Tensor)] + list(r.work)
        buffers = {t.untyped_storage().data_ptr()
                   for seg in sess.runner._segments.values()
                   for t in seg.inputs.values()}
        assert not any(t.untyped_storage().data_ptr() in buffers for t in held)
        copies = [t.clone() for t in held]
        if idx + 1 < FRAMES:
            tsession.session_step(
                sess.replace(), ds.frames[idx + 1],
                factor=tsession.frame_factor(ds, idx + 1, last, cfg),
                perm=perms[idx + 1])
            assert all(_same(a, b) for a, b in zip(held, copies)), idx
    assert sess.runner._segments      # the run went through the runner


def _expected(cfg, kf, fired):
    """Dispatches and syncs of one MonoGS step by the formula of
    ``slam/graphs.py``; ``fired`` are the step's boundary flags.  Without
    pruning, tracking (its build and schedule included) is one replay of a
    K-iteration segment; with pruning, an eager build (and schedule), K
    replays of a one-iteration segment and, per fired boundary, a rebuild,
    a schedule and ``interval_update`` (its one read); eager, K iterations
    in place of the replays.  No fragment-list build reads the device."""
    sched = cfg.backend == "schedule"
    k = cfg.iters_track
    if cfg.prune is None:
        d, s = (1 if cfg.fused else k), 0
    else:
        d = 1 + sched + k + sum(fired) * (2 + sched)
        s = sum(fired)
    if kf:
        w, m, stride = cfg.map_window, cfg.iters_map, cfg.map_rebuild_stride
        segs = (m // stride + (m % stride > 0)) if cfg.fused else m
        builds = w + m // stride
        # eval render and densify (its 3 reads), window builds and
        # schedules, segments, stride rebuilds (and their schedules), eval
        # render, serving build
        d += 2 + builds * (1 + sched) + segs + 1 + 1
        s += 3
    return d, s


@pytest.mark.parametrize("path", ["monogs", "schedule", "rtgs"])
@pytest.mark.parametrize("fused", [True, False])
def test_engine_stats_follow_the_formula(runs, path, fused):
    cfg = _cfg(path, fused)
    for sess, r, counts in runs(path, fused):
        want = _expected(cfg, r.is_kf, [bool(f) for f in r.fired])
        assert (counts.dispatches, counts.syncs) == want
        assert counts.replays == 0          # no CUDA graph on the CPU
    stats = EngineStats()
    res = tsession.session_finalize(sess, stats=stats)
    assert (stats.dispatches, stats.syncs) == (0, 2)
    assert (res.dispatches, res.syncs) == (0, 2)


def test_fused_port_matches_the_reference_fused_run(data):
    """The reference's fused ``run_sequence`` (one dispatch per frame) and
    the port's, on the same dataset and densify picks: camera centres
    within 1e-4 m through frame 2 and 1 cm after, ATE within 1 cm, mean
    keyframe PSNR within 0.1 dB, the same alive counts
    (``test_torch_session.py::test_six_frame_run_matches``'s bounds).  The
    reference counts one dispatch per frame and one sync; the port counts
    its eager builds around the graph replays."""
    ds_j, ds_t, _ = data
    cfg_j = jsession.SLAMConfig(backend="ref", keyframe=JPolicy(interval=2),
                                iters_track=3, iters_map=4, capacity=1024,
                                frag_capacity=48, map_window=2)
    cfg_t = tsession.SLAMConfig(keyframe=KeyframePolicy(interval=2), iters_track=3,
                                iters_map=4, capacity=1024, frag_capacity=48,
                                map_window=2)
    assert cfg_j.fused and cfg_t.fused
    res_j = jsession.run_sequence(ds_j, cfg_j)

    def perm(idx):
        key = jax.random.fold_in(jax.random.PRNGKey(SEED), idx)
        return torch.as_tensor(np.array(jax.random.permutation(
            key, 2 * cfg_t.densify_per_kf)))

    res_t = tsession.run_sequence(ds_t, cfg_t, device="cpu", seed=SEED,
                                  perms={i: perm(i) for i in range(1, FRAMES)})

    def centres(poses):
        return np.stack([np.linalg.inv(np.asarray(p, np.float64))[:3, 3] for p in poses])

    d = np.linalg.norm(centres(res_t.est_w2c) - centres(res_j.est_w2c), axis=-1)
    assert d[:3].max() < 1e-4, d
    assert d.max() < 1e-2, d
    assert abs(res_t.ate - res_j.ate) < 1e-2
    assert abs(res_t.mean_psnr - res_j.mean_psnr) < 0.1
    assert res_t.alive_per_frame == res_j.alive_per_frame
    assert (res_j.dispatches, res_j.syncs) == (FRAMES, 1)
    # Per tracking-only frame 1 dispatch (one replay) and no sync, as the
    # reference; keyframes (frames 2 and 4) add densify (3 reads), the
    # window builds, the mapping replay and the eval and serving builds.
    assert res_t.dispatches > FRAMES and res_t.syncs > 1
