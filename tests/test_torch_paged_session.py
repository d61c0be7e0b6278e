"""The reference and the port at the reference PagedMap bench's corridor
config (``benchmarks/bench_paged.py:57-78``), flat and paged.

corridor0 at 48x64 from the reference's ``make_dataset`` (carried across
with ``dataset_from_numpy``), capacity 4096, ``PagedConfig(page_capacity=
256, visible_pages=6)``, ``iters_track=8``, ``lr_pose=0.02``,
``iters_map=8``, window 3, stride 3, densify 128, MonoGS interval 2,
``PruneConfig(k0=3, step_frac=0.1)``, in the bench's quick form of 12
frames (PSNR gate 0.35 dB).  The port is fed the reference's densify
permutations.  Measured:

* paged equals flat bit for bit in each package (the map's alive rows fit
  the working set), and the bench's gates hold in both;
* one step from the reference's state agrees within 1e-6 m through frame
  6; from frame 7 on a fragment-list rebuild differs by one fragment at a
  tile's edge, and the pose steps (below) carry that to a few millimetres;
* one step from the reference's paged state with the view cut to 2 pages
  of 128 rows, which leaves alive rows out, agrees as closely;
* the whole runs agree within 1e-5 m through frame 2 and part from frame
  3 on (9.1 mm there), after the first keyframe's map.  With
  ``lr_pose=0.02`` Adam's first pose steps move each tangent entry by about
  0.02 in the sign of its gradient, so a near-zero gradient entry that
  rounds to the other sign in the other package moves the camera the other
  way; both packages lose the corridor's track (ATE 45.2 cm reference,
  27.5 cm port, and 50.48 cm in the reference bench's 24-frame record).
  So the loss of track is the config's, not a fault of the port, and the
  whole runs are held to the keyframes, the alive counts and the frames
  before they part.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from _shared_runs import Builds
from _torch_parity import np_
from repro.core.keyframes import KeyframePolicy as JPolicy
from repro.core.pruning import PruneConfig as JPrune
from repro.slam import session as jsession
from repro.slam.datasets import make_dataset as jmake_dataset
from repro.slam.map import PagedConfig as JPaged
from repro_torch import convert
from repro_torch.core.keyframes import KeyframePolicy as TPolicy
from repro_torch.core.pruning import PruneConfig as TPrune
from repro_torch.slam import session as tsession
from repro_torch.slam.graphs import EngineStats
from repro_torch.slam.map import PagedConfig as TPaged

FRAMES, SEED = 12, 0
CFG = dict(iters_track=8, lr_pose=0.02, iters_map=8, capacity=4096, frag_capacity=256,
           map_window=3, map_rebuild_stride=3, densify_per_kf=128)
PAGED = dict(page_capacity=256, visible_pages=6)
PARTED = 3          # the first frame whose whole-run centres part (measured)
STEADY = 6          # one step from a shared state agrees to 1e-6 m up to here
# A view of 2 pages of 128 rows: from the states after frames 4 and 5 (371
# alive rows) it leaves alive pages out; after frame 3 (243) it holds them
# all but has no room for densification.
SMALL = dict(page_capacity=128, visible_pages=2)
SMALL_AFTER = (3, 4, 5)
ULP_AFTER = 9       # a keyframe step after the track is lost


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg_j(paged, view=PAGED):
    return jsession.SLAMConfig(keyframe=JPolicy(kind="monogs", interval=2), fused=True,
                               paged=JPaged(**view) if paged else None,
                               prune=JPrune(k0=3, step_frac=0.1), **CFG)


def _cfg_t(paged, view=PAGED):
    return tsession.SLAMConfig(keyframe=TPolicy(kind="monogs", interval=2),
                               paged=TPaged(**view) if paged else None,
                               prune=TPrune(k0=3, step_frac=0.1), **CFG)


def _jax_perm(idx):
    key = jax.random.fold_in(jax.random.PRNGKey(SEED), idx)
    return torch.as_tensor(np.array(jax.random.permutation(key, 2 * CFG["densify_per_kf"])))


def _dataset():
    return jmake_dataset("corridor0", num_frames=FRAMES, height=48, width=64,
                         num_gaussians=CFG["capacity"], frag_capacity=CFG["frag_capacity"])


def _build_data():
    return dict(ds_t=convert.dataset_from_numpy(_dataset(), device="cpu"),
                perms={i: _jax_perm(i) for i in range(1, FRAMES)})


def _build_ref(name):
    """The reference's run: its state after every frame and its results;
    flat, also its step from the state after frame ``ULP_AFTER`` with the
    pose's x translation moved one float32 ulp
    (``test_reference_keyframe_psnr_moves_with_one_ulp``), taken here
    where the step is compiled."""
    import jax.numpy as jnp

    ds_j = _dataset()
    sess = jsession.session_init(ds_j, _cfg_j(name == "paged"), seed=SEED)
    states, steps = [jax.device_get(sess)], []
    for f in ds_j.frames[1:]:
        sess, r = jsession.session_step(sess, f)
        states.append(jax.device_get(sess))
        steps.append(jax.device_get(r))
    out = dict(states=states, steps=steps, res_j=jsession.session_finalize(
        sess, gt_w2c=[f.w2c_gt for f in ds_j.frames]))
    if name == "flat":
        state = states[ULP_AFTER]
        pose = np.array(state.pose)
        pose[0, 3] = np.nextafter(pose[0, 3], np.float32(np.inf))
        out["ulp_step"] = jax.device_get(jsession.session_step(
            state.replace(pose=jnp.asarray(pose)), ds_j.frames[ULP_AFTER + 1])[1])
    return out


def _build_port(name, data):
    """The port's run, fed the reference's densify picks: its step results,
    result and per-step (dispatches, syncs, replays)."""
    ds_t, perms = data["ds_t"], data["perms"]
    stats = EngineStats()
    sess = tsession.session_init(ds_t, _cfg_t(name == "paged"), seed=SEED, device="cpu",
                                 stats=stats)
    steps, counts = [], []
    for i, f in enumerate(ds_t.frames[1:], start=1):
        before = dataclasses.replace(stats)
        sess, r = tsession.session_step(sess, f, perm=perms[i], stats=stats)
        steps.append(r)
        d = stats.since(before)
        counts.append((d.dispatches, d.syncs, d.replays))
    return dict(steps_t=steps, counts=counts, res_t=tsession.session_finalize(
        sess, gt_w2c=[f.w2c_gt for f in ds_t.frames]))


def _build_small(states):
    """The reference's one step from its paged run's state after each frame
    of ``SMALL_AFTER`` with the view cut to ``SMALL``: the state (its page
    table rebuilt at 128 rows a page, the parked Adam moments cut to the
    view's rows, which every keyframe re-inits), the view its step
    gathers, its step result and the state after."""
    import jax.numpy as jnp
    from repro.slam.map import paged as jpaged
    from repro.train import optimizer as joptim

    ds_j, pc = _dataset(), JPaged(**SMALL)
    out = {}
    for after in SMALL_AFTER:
        st = states[after]
        table = jpaged.build_page_table(st.g, pc)
        state = st.replace(
            meta=jsession.SessionMeta(_cfg_j(True, SMALL), st.meta.intr), page=table,
            map_opt=joptim.gather_rows(st.map_opt, jnp.arange(pc.visible_pages
                                                              * pc.page_capacity)))
        base = st.velocity @ st.pose
        vis = jpaged.pages_visible(table, st.meta.intr,
                                   jnp.concatenate([base[None], st.kf_w2c]), margin=pc.margin)
        view = jpaged.view_rows(table.row2page, jpaged.select_pages(
            vis, table.occupancy, pc.visible_pages,
            priority=jpaged.page_distances(table, base)), pc.page_capacity)
        nxt, step = jsession.session_step(state, ds_j.frames[after + 1])
        out[after] = jax.device_get(dict(state=state, view=view, next=nxt, step=step))
    return out


class _Runs:
    """The module's runs, each built on first use and once per test run
    (``_shared_runs.Builds``), so different workers can build different runs
    at the same time: ``runs["ds_t"]`` / ``runs["perms"]``, and
    ``runs["flat"]`` / ``runs["paged"]`` (the reference's and the port's
    run of that config); ``runs.ref(name)`` is the reference's alone;
    ``runs.prefetch(*names)`` builds the named configs' runs, those no other
    worker is building first."""

    def __init__(self, request, tmp_path_factory):
        parts = {"data": (("ds_t", "perms"), lambda _: _build_data())}
        for name in ("flat", "paged"):
            parts[f"ref_{name}"] = ((), lambda _, name=name: _build_ref(name))
        for name in ("flat", "paged"):
            parts[f"port_{name}"] = ((), lambda b, name=name: _build_port(name, b.build("data")))
        # last, in the order a waiting worker makes them: it reads a reference run
        parts["small"] = (("small",), lambda b: {"small": _build_small(
            b.build("ref_paged")["states"])})
        self.builds = Builds(request, tmp_path_factory, "torch_paged_session", parts)

    def ref(self, name):
        return self.builds.build(f"ref_{name}")

    def small(self):
        return self.builds["small"]

    def prefetch(self, *names):
        self.builds.prefetch(*(f"{part}_{n}" for n in names for part in ("ref", "port")))

    def __getitem__(self, key):
        if key in ("ds_t", "perms"):
            return self.builds[key]
        return {**self.ref(key), **self.builds.build(f"port_{key}")}


@pytest.fixture(scope="module")
def runs(request, tmp_path_factory):
    return _Runs(request, tmp_path_factory)


def _centres(poses):
    return np.stack([np.linalg.inv(np.asarray(p, np.float64))[:3, 3] for p in poses])


def _rows(steps):
    return [int(s.work.frag_build_rows) for s in steps]


def test_paged_equals_flat_in_each_package(runs):
    """The corridor's alive rows (at most 755 here) fit the 6 x 256-row
    working set, so paged runs the flat step bit for bit in both packages,
    sweeping 1536 rows per build instead of 4096; the port's paged run
    counts the flat run's dispatches, syncs and replays at every step."""
    runs.prefetch("flat", "paged")
    flat, paged = runs["flat"], runs["paged"]
    for res in ("res_j", "res_t"):
        assert np.array_equal(np.stack(flat[res].est_w2c), np.stack(paged[res].est_w2c))
        assert flat[res].keyframe_psnr == paged[res].keyframe_psnr
        assert flat[res].alive_per_frame == paged[res].alive_per_frame
    for steps in ("steps", "steps_t"):
        for a, b in zip(flat[steps], paged[steps]):
            assert int(a.work.frag_build_rows) * 6 == int(b.work.frag_build_rows) * 16
    assert flat["counts"] == paged["counts"]
    assert _rows(paged["steps_t"])[:5] == _rows(paged["steps"])[:5]


def test_bench_gates_hold_in_both_packages(runs):
    """``bench_paged.py:159-171``'s gates, unchanged, in each package: the
    last 3 steps' fragment-build rows fall >= 1.6x, the mean keyframe PSNR
    loses <= 0.35 dB (the quick form's gate) and the paged ATE is within
    5% + 2 cm of flat's.  Its fourth gate, one dispatch per frame-step for
    paged and flat alike, reads here as paged counting what flat counts
    (``test_paged_equals_flat_in_each_package``)."""
    runs.prefetch("flat", "paged")
    flat, paged = runs["flat"], runs["paged"]
    for steps, res in (("steps", "res_j"), ("steps_t", "res_t")):
        late = sum(_rows(flat[steps])[-3:]) / sum(_rows(paged[steps])[-3:])
        assert late >= 1.6, late
        assert flat[res].mean_psnr - paged[res].mean_psnr <= 0.35
        assert paged[res].ate <= flat[res].ate * 1.05 + 2e-2


@pytest.mark.parametrize("name", ["flat", "paged"])
def test_whole_runs_agree_until_they_part(runs, name):
    """The same keyframes and alive counts at every frame; camera centres
    within 1e-5 m before the runs part at frame 3 (module docstring), with
    the same work counters but for the first keyframe's fragments and
    raster programs, which follow the maps within 1% (0.2% measured).  The
    maps part by the rounding drift ``test_torch_session.py`` explains (a
    Gaussian whose gradient is at rounding level moves a whole ``lr_map``
    step, either way), and 2 of the first keyframe's 10 masked rows differ
    at ties of the selection cut (``test_torch_rtgs_session.py``), so its
    PSNR is held within 0.2 dB (0.12 dB measured; 4e-6 dB from a shared
    state, ``test_one_step_from_carried_state``).  After frame 3 both
    packages lose the track (ATE > 20 cm)."""
    runs.prefetch(name)
    r = runs[name]
    res_j, res_t = r["res_j"], r["res_t"]
    assert [s.is_kf for s in r["steps_t"]] == [bool(s.is_kf) for s in r["steps"]]
    assert res_t.alive_per_frame == res_j.alive_per_frame
    d = np.linalg.norm(_centres(res_t.est_w2c) - _centres(res_j.est_w2c), axis=-1)
    assert d[:PARTED].max() < 1e-5, d
    for s_t, s_j in zip(r["steps_t"][:PARTED - 1], r["steps"][:PARTED - 1]):
        for f, v in zip(s_j.work._fields, s_j.work):
            got = int(getattr(s_t.work, f))
            if s_t.is_kf and f in ("fragments", "sched_programs"):
                assert abs(got - int(v)) <= 0.01 * int(v), f
            else:
                assert got == int(v), f
    assert abs(res_t.keyframe_psnr[1] - res_j.keyframe_psnr[1]) < 0.2
    assert res_j.ate > 0.2 and res_t.ate > 0.2


@pytest.mark.parametrize("name", ["flat", "paged"])
@pytest.mark.parametrize("after", list(range(FRAMES - 1)))
def test_one_step_from_carried_state(runs, name, after):
    """Start the port from the reference's state after frame ``after`` (the
    page table carried across when paged) and step both once.  Through
    frame 6: centres within 1e-6 m (4.5e-7 measured), the same work
    counters and alive count, keyframe PSNR within 1e-3 dB.  From frame 7
    on a boundary's rebuild differs by one fragment at a tile's edge (8774
    against 8773 at frame 7), and the 0.02 pose steps carry it: centres
    within 1 cm (5.2 mm measured); the fragment counters within 0.1% and
    the raster programs within 1% (0.07% and 0.83% measured), every other
    counter and the alive count equal; keyframe PSNR within 1 dB (0.25 and
    0.78 dB measured at frames 8 and 10, with centres 0.76 and 1.57 mm
    apart), since there the reference's own keyframe PSNR moves 0.2 dB
    when its pose moves one ulp
    (``test_reference_keyframe_psnr_moves_with_one_ulp``).  The mapping
    step itself is held to 1e-3 dB where tracking agrees (through frame 6
    here, and with alive pages out of the view in
    ``test_one_step_with_alive_pages_out_of_view``).  Paged, the page
    table after a keyframe equals the reference's through frame 6; later
    the maps part, a few rows' Morton keys with them, and the pages'
    occupancy stays equal."""
    r = runs.ref(name)
    state, ref = r["states"][after], r["steps"][after]
    cfg = _cfg_t(name == "paged")
    sess = convert.session_from_numpy(state, cfg, runs["ds_t"].intrinsics, device="cpu")
    assert (sess.page is not None) == (name == "paged")
    idx = after + 1
    sess, res = tsession.session_step(sess, runs["ds_t"].frames[idx],
                                      perm=runs["perms"][idx])
    assert res.is_kf == bool(ref.is_kf)
    assert int(res.alive) == int(ref.alive)
    d = np.linalg.norm(_centres([np_(res.pose)]) - _centres([np.asarray(ref.pose)]))
    steady = idx <= STEADY
    assert d < (1e-6 if steady else 1e-2), d
    slack = {} if steady else {"fragments": 1e-3, "sched_programs": 1e-2}
    for f, v in zip(ref.work._fields, ref.work):
        got, want = int(getattr(res.work, f)), int(v)
        assert abs(got - want) <= slack.get(f, 0.0) * want, (f, got, want)
    if res.is_kf:
        assert abs(float(res.psnr) - float(ref.psnr)) < (1e-3 if steady else 1.0)
    if name == "paged" and res.is_kf:
        page_j = r["states"][idx].page
        for f in ("row2page", "occupancy") if steady else ("occupancy",):
            assert np.array_equal(np_(getattr(sess.page, f)), np.asarray(getattr(page_j, f)))


def test_bench_data_file_is_the_references_dataset():
    """``tests/data/corridor0_48x64_24.npz``, the inputs ``chip_smoke.py``'s
    ``[paged]`` runs the bench's config on (the card has no JAX), holds the
    reference bench's corridor0 dataset bit for bit."""
    import _bench_data

    want = _bench_data.reference_arrays()
    with np.load(_bench_data.PATH) as got:
        assert sorted(got.files) == sorted(want)
        for k, v in want.items():
            assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k


@pytest.mark.parametrize("after", SMALL_AFTER)
def test_one_step_with_alive_pages_out_of_view(runs, after):
    """From the reference's paged state after frame ``after`` with the view
    cut to 2 pages of 128 rows (``_build_small``): after frames 4 and 5 the
    working set leaves 115 alive rows out, and at the keyframes (frames 4
    and 6) it holds no nursery page, so densification drops rows (115 and
    128 measured).  The port gathers the reference's view bit for bit, and
    its step agrees as the full view's does through frame 6
    (``test_one_step_from_carried_state``): centres within 1e-6 m (2.4e-7
    measured), every work counter (the drops included) and the alive count
    equal, the keyframe PSNR within 1e-3 dB (2.5e-5 measured), the page
    table after the step (rebuilt at a keyframe) equal."""
    ref = runs.small()[after]
    state = ref["state"]
    sess = convert.session_from_numpy(state, _cfg_t(True, SMALL), runs["ds_t"].intrinsics,
                                      device="cpu")
    view = sess.stage._working_set(sess.page, sess.velocity @ sess.pose, sess.kf_w2c)
    assert np.array_equal(np_(view), np.asarray(ref["view"]))
    in_view = np.zeros(CFG["capacity"], bool)
    in_view[np.asarray(ref["view"])] = True
    assert (np.asarray(state.g.alive) & ~in_view).sum() > 0 or after == 3
    idx = after + 1
    sess, res = tsession.session_step(sess, runs["ds_t"].frames[idx],
                                      perm=runs["perms"][idx])
    step = ref["step"]
    assert res.is_kf == bool(step.is_kf) and int(res.alive) == int(step.alive)
    d = np.linalg.norm(_centres([np_(res.pose)]) - _centres([np.asarray(step.pose)]))
    assert d < 1e-6, d
    assert tuple(int(x) for x in res.work) == tuple(int(x) for x in step.work)
    if res.is_kf:
        assert abs(float(res.psnr) - float(step.psnr)) < 1e-3
        assert int(res.work.densify_dropped) > 0
    for f in ("row2page", "occupancy"):
        assert np.array_equal(np_(getattr(sess.page, f)), np.asarray(getattr(ref["next"].page, f)))


def test_reference_keyframe_psnr_moves_with_one_ulp(runs):
    """The reference alone, from its flat state after frame 9, stepped
    twice: once as is (its run) and once with its pose's x translation
    moved by one float32 ulp (``_build_ref``).  The centres stay within
    1e-4 m (8.4e-6 measured), yet the keyframe PSNR moves by more than 0.1
    dB (0.20 dB measured): after the track is lost, a last-bit change
    moves a keyframe's PSNR by tenths of a dB, the scale
    ``test_one_step_from_carried_state`` allows after frame 7."""
    r = runs.ref("flat")
    a, b = r["steps"][ULP_AFTER], r["ulp_step"]
    assert bool(a.is_kf) and bool(b.is_kf)
    d = np.linalg.norm(_centres([np.asarray(a.pose)]) - _centres([np.asarray(b.pose)]))
    assert d < 1e-4, d
    assert abs(float(a.psnr) - float(b.psnr)) > 0.1
