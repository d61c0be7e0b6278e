"""The port's stacked sessions (``stack_sessions``, ``step_many``,
``SessionPool``) on the CPU.

* S rows stepped in lockstep equal their solo runs bit for bit, across a
  mid-stream swap, for every base algorithm (GS-SLAM's and Photo-SLAM's
  decisions of all rows read in one transfer);
* a row copied out with ``session_row`` continues under ``session_step``
  as its solo run does;
* the port's S=2 pool against the reference's S=2 pool over the same
  frames and densify picks, within ``tests/test_torch_session.py``'s
  tolerances;
* the guards, and the ``EngineStats`` counts of an S=4 pool against the
  formula of ``slam/graphs.py``.

Inputs: the reference's 48x64 scenes from ``make_dataset``, carried across
with ``dataset_from_numpy``; the config is the reference's serving one
(``tests/test_session.py``'s ``_cfg``).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from _session_state import same_session
from repro.core.keyframes import KeyframePolicy as JPolicy
from repro.core.pruning import PruneConfig as JPrune
from repro.slam import session as jsession
from repro.slam.datasets import make_dataset as jmake_dataset
from repro_torch import convert
from repro_torch.core.downsample import DownsampleConfig
from repro_torch.core.keyframes import KeyframePolicy
from repro_torch.core.pruning import PruneConfig
from repro_torch.slam import session as S
from repro_torch.slam.graphs import EngineStats

BASE = dict(iters_track=3, iters_map=4, capacity=1024, frag_capacity=48,
            map_window=2, map_rebuild_stride=2)


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """Sessions of tiny CPU ops run faster on one intra-op thread, the
    more so beside the test run's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(**kw):
    base = dict(BASE, keyframe=KeyframePolicy(kind="monogs", interval=2),
                prune=PruneConfig(k0=2, step_frac=0.1))
    base.update(kw)
    return S.SLAMConfig(**base)


_SCENES = {}


def _scene(name, seed):
    """The reference's dataset and the port's copy of it."""
    if (name, seed) not in _SCENES:
        ds_j = jmake_dataset(name, num_frames=5, height=48, width=64,
                             num_gaussians=400, frag_capacity=48, seed=seed)
        _SCENES[(name, seed)] = ds_j, convert.dataset_from_numpy(ds_j, device="cpu")
    return _SCENES[(name, seed)]


def _solo(ds, cfg, n_steps, seed=0):
    sess = S.session_init(ds, cfg, seed=seed, device="cpu")
    for t in range(1, n_steps + 1):
        sess, _ = S.session_step(sess, ds.frames[t])
    return sess


def test_pool_rows_equal_solo_runs_across_a_swap():
    """``tests/test_session.py``'s pool test on the port: S=3, two steps,
    stream B retired for a fresh one on its row, two more steps; the
    retired row and every live row equal their solo runs bit for bit."""
    cfg = _cfg()
    ds_a, ds_b, ds_c = (_scene(n, i)[1] for i, n in
                        enumerate(("room0", "room1", "hall0")))
    pool = S.SessionPool([S.session_init(ds, cfg, device="cpu")
                          for ds in (ds_a, ds_b, ds_c)])
    for t in (1, 2):
        pool.step([ds.frames[t] for ds in (ds_a, ds_b, ds_c)])
    ds_b2 = _scene("desk0", 7)[1]
    retired = pool.swap(1, S.session_init(ds_b2, cfg, device="cpu"))
    assert same_session(retired, _solo(ds_b, cfg, 2))
    pool.step([ds_a.frames[3], ds_b2.frames[1], ds_c.frames[3]])
    res = pool.step([ds_a.frames[4], ds_b2.frames[2], ds_c.frames[4]])
    assert res.pose.shape == (3, 4, 4) and len(res.is_kf) == 3
    for slot, (ds, steps) in enumerate([(ds_a, 4), (ds_b2, 2), (ds_c, 4)]):
        assert same_session(pool.session(slot), _solo(ds, cfg, steps)), slot
    # Every frame-step fired a boundary in some row (k0=2 over 3 iters).
    assert pool.stats.syncs > 0


def test_session_row_continues_as_a_solo_run():
    """A row copied out of the pool (as a retired row is) is a solo session
    that ``session_step`` continues bit for bit, and stepping the pool on
    does not touch it."""
    cfg = _cfg()
    ds_a, ds_b = _scene("room0", 0)[1], _scene("stairs0", 1)[1]
    stack = S.stack_sessions([S.session_init(ds, cfg, device="cpu")
                              for ds in (ds_a, ds_b)])
    for t in (1, 2):
        stack, _ = S.step_many(stack, [ds_a.frames[t], ds_b.frames[t]])
    row = S.session_row(stack, 0)
    stack, _ = S.step_many(stack, [ds_a.frames[3], ds_b.frames[3]])
    for t in (3, 4):
        row, _ = S.session_step(row, ds_a.frames[t])
    assert same_session(row, _solo(ds_a, cfg, 4))
    assert same_session(S.session_row(stack, 1), _solo(ds_b, cfg, 3))


@pytest.mark.parametrize("algo,policy", [
    ("gsslam", KeyframePolicy(kind="gsslam", trans_thresh=0.02, rot_thresh=0.02)),
    ("photoslam", KeyframePolicy(kind="photoslam", pho_thresh=0.14)),
    ("splatam", KeyframePolicy(kind="splatam")),
])
def test_other_base_algorithms_stack_bit_for_bit(algo, policy):
    """GS-SLAM, Photo-SLAM (geometric tracking as one S-row segment) and
    SplaTAM: each row equals its solo run, and a frame-step reads the
    device keyframe decisions of all rows in one sync."""
    cfg = _cfg(base_algo=algo, keyframe=policy, prune=None)
    scenes = [_scene(n, i)[1] for i, n in enumerate(("room0", "stairs0"))]
    stack = S.stack_sessions([S.session_init(ds, cfg, device="cpu") for ds in scenes])
    kfs = []
    for t in range(1, 5):
        stats = EngineStats()
        stack, res = S.step_many(stack, [ds.frames[t] for ds in scenes], stats=stats)
        kfs += res.is_kf
        reads = 1 if algo in ("gsslam", "photoslam") else 0
        assert stats.syncs == reads + 3 * sum(res.is_kf)
    for s, ds in enumerate(scenes):
        assert same_session(S.session_row(stack, s), _solo(ds, cfg, 4)), s
    assert any(kfs) and (algo == "splatam" or not all(kfs))


def _jax_perm(seed, idx, per):
    """The reference's densify permutation of frame ``idx`` of a session
    seeded ``seed``."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), idx)
    return torch.as_tensor(np.array(jax.random.permutation(key, 2 * per)))


def test_port_pool_matches_the_reference_pool():
    """The reference's ``SessionPool`` and the port's at S=2 over 3
    frame-steps from the same datasets and densify picks: keyframe flags
    and alive counts equal, poses within 1e-4 per entry after the first
    step and camera centres within 1 cm after that."""
    names = ("room0", "stairs0")
    data = [_scene(n, i) for i, n in enumerate(names)]
    cfg_j = jsession.SLAMConfig(
        backend="ref", scan_unroll=1, keyframe=JPolicy(kind="monogs", interval=2),
        prune=JPrune(k0=2, step_frac=0.1), **BASE)
    pool_j = jsession.SessionPool([jsession.session_init(ds_j, cfg_j)
                                   for ds_j, _ in data])
    cfg_t = _cfg()
    pool_t = S.SessionPool([S.session_init(ds_t, cfg_t, device="cpu")
                            for _, ds_t in data])
    flags = []
    for t in (1, 2, 3):
        res_j = jax.device_get(pool_j.step([ds_j.frames[t] for ds_j, _ in data]))
        res_t = pool_t.step([ds_t.frames[t] for _, ds_t in data],
                            perms=[_jax_perm(0, t, cfg_t.densify_per_kf)] * 2)
        assert [bool(k) for k in res_j.is_kf] == list(res_t.is_kf), t
        flags += res_t.is_kf
        assert np.array_equal(np.asarray(res_j.alive), res_t.alive.numpy()), t
        pose_j, pose_t = np.asarray(res_j.pose), res_t.pose.numpy()
        if t == 1:
            np.testing.assert_allclose(pose_t, pose_j, atol=1e-4)
        else:
            c_j = np.linalg.inv(pose_j.astype(np.float64))[:, :3, 3]
            c_t = np.linalg.inv(pose_t.astype(np.float64))[:, :3, 3]
            assert np.linalg.norm(c_t - c_j, axis=-1).max() < 1e-2, t
    assert any(flags) and not all(flags)      # frame 2 is a keyframe


def test_stack_guards():
    """``tests/test_session.py``'s guards on the port: a stack is refused
    by ``session_step`` and ``session_finalize``; ``step_many`` needs
    ``fused=True`` and no downsampling; ``stack_sessions`` needs one
    static config and solo sessions; admission needs a solo session of the
    pool's static config and ``max_frames``."""
    cfg = _cfg()
    ds = _scene("room0", 0)[1]
    stack = S.stack_sessions([S.session_init(ds, cfg, device="cpu") for _ in range(2)])
    with pytest.raises(ValueError, match="stacked"):
        S.session_step(stack, ds.frames[1])
    with pytest.raises(ValueError, match="solo"):
        S.session_finalize(stack)
    with pytest.raises(ValueError, match="solo sessions"):
        S.stack_sessions([stack])
    cfg_u = _cfg(fused=False)
    stack_u = S.stack_sessions([S.session_init(ds, cfg_u, device="cpu")] * 2)
    with pytest.raises(ValueError, match="fused"):
        S.step_many(stack_u, [ds.frames[1]] * 2)
    cfg_d = dataclasses.replace(cfg, downsample=DownsampleConfig(enabled=True))
    stack_d = S.SessionStack(rows=[r.replace(cfg=cfg_d) for r in stack.rows])
    with pytest.raises(ValueError, match="downsampling"):
        S.step_many(stack_d, [ds.frames[1]] * 2)
    other = S.session_init(ds, _cfg(iters_map=5), device="cpu")
    with pytest.raises(ValueError, match="static config"):
        S.stack_sessions([stack.rows[0], other])
    pool = S.SessionPool(stack.rows)
    with pytest.raises(ValueError, match="static config"):
        pool.swap(0, other)
    with pytest.raises(ValueError, match="solo"):
        pool.swap(0, stack)
    with pytest.raises(ValueError, match="max_frames"):
        pool.swap(0, S.session_init(ds, cfg, max_frames=9, device="cpu"))
    with pytest.raises(ValueError, match="expected 2 frames"):
        S.step_many(stack, [ds.frames[1]] * 3)


def _expected(cfg, n_rows, kfs, fired):
    """Dispatches and syncs of one frame-step of ``n_rows`` rows by the
    formula of ``slam/graphs.py`` (``kernel`` backend, fused): without
    pruning one replay for all rows; with it one eager build per row, K
    runs of the one-iteration segment and 2 dispatches and 1 read per
    fired boundary; each keyframe row adds a solo keyframe's mapping work
    (``tests/test_torch_fused.py``)."""
    k = cfg.iters_track
    if cfg.prune is None:
        d, s = 1, 0
    else:
        d, s = n_rows + k + 2 * sum(fired), sum(fired)
    w, m, stride = cfg.map_window, cfg.iters_map, cfg.map_rebuild_stride
    segs = m // stride + (m % stride > 0)
    per_kf = 2 + (w + m // stride) + segs + 1 + 1
    return d + per_kf * sum(kfs), s + 3 * sum(kfs)


@pytest.mark.parametrize("prune", [False, True])
def test_engine_stats_follow_the_formula_at_s4(prune):
    """An S=4 pool of four streams: every frame-step's counts follow the
    formula; a tracking-only step without pruning is one dispatch and no
    sync, whatever S."""
    cfg = _cfg(prune=PruneConfig(k0=2, step_frac=0.1) if prune else None)
    scenes = [_scene(n, i)[1] for i, n in enumerate(("room0", "room1", "hall0",
                                                      "stairs0"))]
    pool = S.SessionPool([S.session_init(ds, cfg, device="cpu") for ds in scenes])
    seen = set()
    for t in range(1, 5):
        before = dataclasses.replace(pool.stats)
        res = pool.step([ds.frames[t] for ds in scenes])
        counts = pool.stats.since(before)
        fired = [int(f.sum()) for f in res.fired]
        assert (counts.dispatches, counts.syncs) == _expected(
            cfg, 4, res.is_kf, fired), t
        assert counts.replays == 0          # no CUDA graph on the CPU
        seen.add(any(res.is_kf))
    assert seen == {False, True}
