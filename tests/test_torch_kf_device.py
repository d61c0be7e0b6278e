"""The keyframe branch on the device, on the CPU: conditional segments
(``PhaseRunner.run_when``, ``slam/graphs.py``) and the S-row keyframe
segment of ``slam/session.py``, through which GS-SLAM's and Photo-SLAM's
steps read nothing back and a frame-step maps all its keyframe rows in one
run.

* a conditional segment runs a row's body where its flag holds and leaves
  the row's state as it was where it does not, fused (one dispatch, no
  sync) and eager (one sync for the flags the device decides);
* GS-SLAM and Photo-SLAM, fused, equal their eager runs bit for bit over
  frames that hold keyframes and tracking-only frames, at 2 dispatches and
  no sync per step;
* their port runs against the reference's ``run_sequence`` fed the
  reference's densify picks, within ``tests/test_torch_algos.py``'s bounds;
* S = 2 and S = 3 Photo-SLAM pools whose rows take keyframes on different
  frame-steps: each row equals its solo run, at 2 dispatches and no sync
  per frame-step; a server counts a free slot's device-decided keyframes
  at its next drain.

Inputs: 48x64 scenes of 5 frames, the reference's room0 from its
``make_dataset`` (carried across with ``dataset_from_numpy``) where the
reference runs too, else the port's; the toy segment's inputs drawn with
numpy from a seed.  On the card, ``tests/test_torch_cuda.py`` holds
the conditional nodes themselves.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from _session_state import same_bits, same_session, tree_tensors
from _shared_runs import Builds
from repro.core.keyframes import KeyframePolicy as JPolicy
from repro.slam import session as jsession
from repro.slam.datasets import make_dataset as jmake_dataset
from repro_torch import convert
from repro_torch.core.keyframes import KeyframePolicy
from repro_torch.slam import session as S
from repro_torch.slam.datasets import make_dataset
from repro_torch.slam.graphs import EngineStats, PhaseRunner, row_names

FRAMES, SEED = 5, 0
BASE = dict(iters_track=3, iters_map=4, capacity=1024, frag_capacity=48,
            map_window=2, map_rebuild_stride=2)
POLICIES = {"gsslam": dict(kind="gsslam", trans_thresh=0.02, rot_thresh=0.02),
            "photoslam": dict(kind="photoslam", pho_thresh=0.14)}
SCENES = ("room0", "stairs0", "hall0")


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """Sessions of tiny CPU ops run faster on one intra-op thread, the
    more so beside the test run's other workers; fused and eager run under
    the same setting."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


_SCENES, _SOLOS = {}, {}        # by scene name


def _port_scene(name):
    """A scene of the port's ``make_dataset``, seeded by its place in
    ``SCENES``."""
    if name not in _SCENES:
        _SCENES[name] = make_dataset(name, num_frames=FRAMES, height=48, width=64,
                                     num_gaussians=400, frag_capacity=48,
                                     seed=SCENES.index(name), device="cpu")
    return _SCENES[name]


def _cfg(algo, **kw):
    return S.SLAMConfig(base_algo=algo, keyframe=KeyframePolicy(**POLICIES[algo]),
                        **BASE, **kw)


# ---------------------------------------------------------------------------
# conditional segments
# ---------------------------------------------------------------------------


def _toy_body(t):
    y = t["x"] @ t["w"]
    return {"x": torch.tanh(y), "n": t["n"] + 1, "loss": y.sum()}


def _toy_decide(t):
    return t["x"].sum() > 0


def _toy_rows(seed, n):
    r = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        x = torch.as_tensor(r.standard_normal((4, 4)), dtype=torch.float32)
        rows.append({"x": x, "w": torch.as_tensor(r.standard_normal((4, 4)),
                                                  dtype=torch.float32),
                     "n": torch.zeros((), dtype=torch.int64)})
    return rows


def _toy_run(runner, rows, flags):
    inputs = {}
    for s, row in enumerate(rows):
        inputs.update(row_names(s, row))
    defaults = {"loss": torch.full((), float("nan"))}
    return runner.run_when("toy", _toy_decide, _toy_body, inputs, flags, ("x", "n"),
                           defaults, iters=3)


@pytest.mark.parametrize("flags", [[True], [False], [True, False, True],
                                   [None, None, False, None]])
@pytest.mark.parametrize("fused", [True, False])
def test_conditional_segment_runs_and_skips(flags, fused):
    """Each row's body runs where its flag (the host's, or ``None``: the
    device's decision) holds; a skipped row keeps its state and takes the
    defaults.  Fused: one dispatch and no sync per run, whatever runs, and
    a second run on other inputs through the same buffers.  Eager: the
    bodies' dispatches, and one sync where the device decides."""
    runner = PhaseRunner("cpu", fused=fused)
    for seed in (1, 2):
        rows = _toy_rows(seed, len(flags))
        before = dataclasses.replace(runner.stats)
        out = _toy_run(runner, rows, flags)
        ran = 0
        for row, f, o in zip(rows, flags, out):
            want = bool(_toy_decide(row)) if f is None else f
            assert bool(o["when"]) == want
            assert isinstance(o["when"], torch.Tensor) == (f is None)
            ref = _toy_body(row) if want else dict(row, loss=torch.tensor(float("nan")))
            for k in ("x", "n", "loss"):
                assert same_bits(o[k], ref[k]), k
            ran += want
        counts = runner.stats.since(before)
        if fused:
            assert (counts.dispatches, counts.syncs) == (1, 0)
        else:
            assert (counts.dispatches, counts.syncs) == (3 * ran, int(None in flags))
    assert len(runner._segments) == (1 if fused else 0)


def test_conditional_segment_outputs_do_not_alias_its_buffers():
    """A fused run's results (state and per-step outputs) share no memory
    with the segment's buffers, so the next run does not change them."""
    runner = PhaseRunner("cpu", fused=True)
    out = _toy_run(runner, _toy_rows(3, 2), [True, None])
    held = [t for o in out for t in tree_tensors(o)]
    copies = [t.clone() for t in held]
    buffers = {t.untyped_storage().data_ptr()
               for seg in runner._segments.values()
               for t in (*seg.inputs.values(), *seg.outputs.values())}
    assert not any(t.untyped_storage().data_ptr() in buffers for t in held)
    _toy_run(runner, _toy_rows(4, 2), [True, None])
    assert all(same_bits(a, b) for a, b in zip(held, copies))


# ---------------------------------------------------------------------------
# GS-SLAM and Photo-SLAM sessions
# ---------------------------------------------------------------------------


def _steps(ds, cfg, frames):
    """Init and one step per frame up to ``frames``: the session and each
    step's result and counts."""
    stats = EngineStats()
    sess = S.session_init(ds, cfg, seed=SEED, device="cpu", stats=stats)
    out = []
    for idx in range(1, frames):
        before = dataclasses.replace(stats)
        sess, r = S.session_step(sess, ds.frames[idx], stats=stats)
        out.append((r, stats.since(before)))
    return sess, out


@pytest.mark.parametrize("algo", sorted(POLICIES))
def test_fused_equals_eager_with_device_decisions(algo):
    """Fused, every step counts 2 dispatches and no sync (tracking and the
    keyframe segment, whose body runs under the device's flag); eager reads
    the flag (one sync).  Every step's results and the final session are
    equal bit for bit, and the frames hold keyframes and tracking-only
    frames (frames 1 to 3: GS-SLAM maps at 2 and 3, Photo-SLAM at 2)."""
    ds = _port_scene("room0")
    s_f, fused = _steps(ds, _cfg(algo), 4)
    s_e, eager = _steps(ds, _cfg(algo, fused=False), 4)
    flags = []
    for (r_f, c_f), (r_e, c_e) in zip(fused, eager):
        assert isinstance(r_f.is_kf, torch.Tensor) and r_f.is_kf.dtype == torch.bool
        assert bool(r_f.is_kf) == bool(r_e.is_kf)
        flags.append(bool(r_f.is_kf))
        for name in ("pose", "alive", "psnr", "track_losses", "map_losses", "fired"):
            assert same_bits(getattr(r_f, name), getattr(r_e, name)), name
        assert all(same_bits(a, b) for a, b in zip(r_f.work, r_e.work))
        assert (c_f.dispatches, c_f.syncs, c_f.replays) == (2, 0, 0)
        assert c_e.syncs == 1
    assert any(flags) and not all(flags), flags
    assert same_session(s_f, s_e)
    assert int(s_f.kf_total) == 1 + sum(flags)


def _data(_):
    ds_j = jmake_dataset("room0", num_frames=FRAMES, height=48, width=64,
                         num_gaussians=400, frag_capacity=48)
    return dict(ds_j=ds_j, ds_t=convert.dataset_from_numpy(ds_j, device="cpu"))


def _reference_run(algo):
    def build(refs):
        """The reference's run of ``algo``'s policy on room0."""
        ds_j = refs["ds_j"]
        cfg_j = jsession.SLAMConfig(backend="ref", scan_unroll=1, base_algo=algo,
                                    keyframe=JPolicy(**POLICIES[algo]), **BASE)
        sess = jsession.session_init(ds_j, cfg_j, seed=SEED)
        flags = []
        for idx in range(1, FRAMES):
            sess, res = jsession.session_step(sess, ds_j.frames[idx])
            flags.append(bool(jax.device_get(res.is_kf)))
        res = jsession.session_finalize(sess, gt_w2c=[f.w2c_gt for f in ds_j.frames])
        return {algo: dict(flags=flags, psnr=res.keyframe_psnr, alive=res.alive_per_frame)}

    return build


@pytest.fixture(scope="module")
def references(request, tmp_path_factory):
    """The reference's room0 in the port's form and its run of each policy,
    each built once per test run (``tests/_shared_runs.py``) and apart, so
    two workers build the two runs at once."""
    parts = {"data": (("ds_j", "ds_t"), _data)}
    for algo in POLICIES:
        parts[f"ref_{algo}"] = ((algo,), _reference_run(algo))
    return Builds(request, tmp_path_factory, "torch_kf_device", parts)


def _jax_perm(idx, per):
    key = jax.random.fold_in(jax.random.PRNGKey(SEED), idx)
    return torch.as_tensor(np.array(jax.random.permutation(key, 2 * per)))


@pytest.mark.parametrize("algo", sorted(POLICIES))
def test_port_run_matches_the_reference_run(references, algo):
    """The port's ``run_sequence`` fed the reference's densify picks: the
    same number of keyframes (the PSNR log's length) and alive counts,
    ATE < 0.6 m and PSNR > 14 dB (``test_torch_algos.py``'s bounds)."""
    ref = references[algo]
    cfg = _cfg(algo)
    perms = {i: _jax_perm(i, cfg.densify_per_kf) for i in range(1, FRAMES)}
    res = S.run_sequence(references["ds_t"], cfg, device="cpu", seed=SEED, perms=perms)
    assert len(res.keyframe_psnr) == len(ref["psnr"]) == 1 + sum(ref["flags"])
    assert res.alive_per_frame == ref["alive"]
    assert res.ate < 0.6 and res.mean_psnr > 14.0
    # No downsampling: nothing read per frame; init's two reads, finalize's two.
    assert (res.dispatches, res.syncs) == (1 + 2 * (FRAMES - 1), 2 + 2)


def _solo(name, cfg, steps):
    """A solo Photo-SLAM session of ``name`` after ``steps`` steps."""
    if name not in _SOLOS:
        ds = _port_scene(name)
        sess = S.session_init(ds, cfg, device="cpu")
        for t in range(1, steps + 1):
            sess, _ = S.session_step(sess, ds.frames[t])
        _SOLOS[name] = sess
    return _SOLOS[name]


@pytest.mark.parametrize("names", [("room0", "hall0"), SCENES])
def test_pool_maps_its_keyframe_rows_in_one_run(names):
    """Photo-SLAM pools whose rows take keyframes on different frame-steps
    (frame 2 maps room0's and stairs0's rows, not hall0's): every frame-step is 2
    dispatches and no sync, however many rows map, and each row equals its
    solo run bit for bit."""
    cfg, steps = _cfg("photoslam"), 2
    scenes = [_port_scene(n) for n in names]
    pool = S.SessionPool([S.session_init(ds, cfg, device="cpu") for ds in scenes])
    mixed = False
    for t in range(1, steps + 1):
        before = dataclasses.replace(pool.stats)
        res = pool.step([ds.frames[t] for ds in scenes])
        counts = pool.stats.since(before)
        assert (counts.dispatches, counts.syncs) == (2, 0), t
        flags = res.is_kf.tolist()
        mixed |= any(flags) and not all(flags)
    assert mixed
    for s, name in enumerate(names):
        assert same_session(pool.session(s), _solo(name, cfg, steps)), s


def test_server_counts_device_keyframes_of_free_slots_at_drain():
    """A Photo-SLAM ``SlamServer`` with a retired slot stepped on blank
    frames: the free slot's keyframes, decided on the device, are summed
    there without a read and counted into ``blank_keyframes`` by the next
    ``drain``, as a host count of the same flags gives."""
    from repro_torch.slam.server import ShardedPool, SlamServer

    cfg = _cfg("photoslam")
    scenes = [_port_scene(n) for n in ("room0", "hall0")]
    srv = SlamServer(ShardedPool([S.session_init(ds, cfg, device="cpu") for ds in scenes]))
    srv.retire(1)
    flags = []
    for t in range(1, 4):
        srv.submit(0, scenes[0].frames[t])
        srv.pump()
        flags.append(bool(srv.last_result.is_kf[1]))
    assert srv.stats.blank_row_steps == 3 and srv.stats.blank_keyframes == 0
    srv.drain()
    assert srv.stats.blank_keyframes == sum(flags) > 0
