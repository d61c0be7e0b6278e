"""The port's continuous-batching tier (``slam/sched``) on the CPU.

* the port's ``QueueDepthPolicy`` and the reference's return equal plans on
  the same hand-built views (``tests/test_sched.py``'s policy cases);
* a ladder of widths (1, 2): a stream migrated S=1→S=2 mid-trajectory
  with a frame queued, beside admissions and retirements on both pools,
  finishes bit for bit as its solo run, and ``compile_cache_stats()`` is
  unchanged after ``warmup`` (no new segment);
* the policy's eviction end to end, threaded ingest end to end, and the
  scheduler's guards.

Sessions run the reference's serving config on its 48x64 scenes, carried
across with ``dataset_from_numpy``.
"""

import time

import pytest
import torch

from _session_state import same_session
from repro.slam.datasets import make_dataset as jmake_dataset
from repro.slam.sched import policy as jpolicy
from repro_torch import convert
from repro_torch.core.keyframes import KeyframePolicy
from repro_torch.core.pruning import PruneConfig
from repro_torch.obs import Telemetry, latency_summary
from repro_torch.slam import session as S
from repro_torch.slam.sched import (
    IngestWorker, PoolLadder, QueueDepthPolicy, SlamScheduler, default_decode,
)
from repro_torch.slam.sched import policy as tpolicy
from repro_torch.slam.server import PoolFull, compile_cache_stats


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# the policy: the port against the reference on the same views
# ---------------------------------------------------------------------------


def _views(mod, groups):
    """GroupViews of ``mod`` from ``(rung, width, free, blocked_for,
    [(slot, stream, fill, age), ...])`` tuples."""
    return [mod.GroupView(rung=r, name=f"S{w}", width=w, free=f, blocked_for_s=b,
                          slots=tuple(mod.SlotView(slot=s, stream=n, fill=fl,
                                                   head_age_s=a)
                                      for s, n, fl, a in svs))
            for r, w, f, b, svs in groups]


_BLOCKED = (0, 2, 0, 0.2, [(0, "fast", 2, 0.4), (1, "slow", 0, None)])
_LANE = (1, 4, 1, 0.0, [(0, "crawl", 0, None)])
_BLOCKED2 = (2, 2, 0, 0.3, [(0, "f2", 1, 0.2), (1, "s2", 0, None)])
_CASES = {
    "pump-order": ("pump", {}, [
        (0, 2, 0, 0.0, [(0, "a", 1, 0.10), (1, "b", 1, 0.02)]),
        (1, 4, 2, 0.0, [(0, "c", 2, 0.50), (1, "d", 1, 0.30)]),
        (2, 8, 7, 0.0, [(0, "e", 0, None)]),
        (3, 16, 16, 0.0, [])], {}),
    "evict-to-slow-lane": ("migrate", dict(starve_s=0.05), [_BLOCKED, _LANE], {}),
    "slow-with-slow": ("migrate", dict(starve_s=0.05), [
        _BLOCKED,
        (1, 4, 1, 0.0, [(0, "f1", 1, 0.05), (1, "s1", 0, None)]),
        (2, 4, 1, 0.0, [(0, "f2", 1, 0.05), (1, "f3", 1, 0.05)])], {}),
    "almost-clean-first": ("migrate", dict(starve_s=0.05, max_migrations_per_tick=1), [
        (0, 2, 0, 0.1, [(0, "fa", 2, 0.3), (1, "sa", 0, None)]),
        (1, 4, 0, 0.9, [(0, "fb", 2, 0.8), (1, "sb", 0, None), (2, "sc", 0, None)]),
        (2, 8, 1, 0.0, [(0, "sd", 0, None)])], {}),
    "rescue-oldest-waiter": ("migrate", dict(starve_s=0.05), [
        (0, 2, 0, 0.2, [(0, "w1", 1, 0.40), (1, "w2", 1, 0.90), (2, "slow", 0, None)]),
        (1, 4, 1, 0.0, [(0, "x", 1, 0.01), (1, "y", 1, 0.02)])], {}),
    "frozen-no-lane": ("migrate", dict(starve_s=0.05), [_BLOCKED, _LANE],
                       dict(frozen=frozenset({"slow"}))),
    "frozen-clean-lane": ("migrate", dict(starve_s=0.05), [
        _BLOCKED, _LANE, (3, 4, 1, 0.0, [(0, "x", 1, 0.01)])],
        dict(frozen=frozenset({"slow"}))),
    "under-starve": ("migrate", dict(starve_s=10.0), [_BLOCKED, _LANE], {}),
    "free-slot-accounting": ("migrate", dict(starve_s=0.05, max_migrations_per_tick=4),
                             [_BLOCKED, _BLOCKED2, _LANE], {}),
    "tick-budget": ("migrate", dict(starve_s=0.05, max_migrations_per_tick=1),
                    [_BLOCKED, _BLOCKED2, _LANE], {}),
}
_WANT = {
    "pump-order": [1, 0],
    "evict-to-slow-lane": [("slow", 0, 1, "evict-starved")],
    "almost-clean-first": [("sa", 0, 2, "evict-starved")],
    "rescue-oldest-waiter": [("w2", 0, 1, "rescue-waiter")],
    "frozen-no-lane": [],
    "frozen-clean-lane": [("fast", 0, 3, "rescue-waiter")],
    "under-starve": [],
}


def _decide(mod, kind, policy_kw, groups, call_kw):
    views = _views(mod, groups)
    policy = mod.QueueDepthPolicy(**policy_kw)
    if kind == "pump":
        return policy.pump_order(views)
    return [(m.stream, m.src, m.dst, m.reason)
            for m in policy.migrations(views, **call_kw)]


@pytest.mark.parametrize("case", list(_CASES))
def test_policy_plans_match_the_reference(case):
    port = _decide(tpolicy, *_CASES[case])
    assert port == _decide(jpolicy, *_CASES[case])
    if case in _WANT:
        assert port == _WANT[case]
    if case == "slow-with-slow":
        assert port[0] == ("slow", 0, 1, "evict-starved")
    if case == "free-slot-accounting":
        assert port[0] == ("s2", 2, 1, "evict-starved")
        assert port[1][1:3] == (0, 2) and len(port) == 2
    if case == "tick-budget":
        assert len(port) == 1


# ---------------------------------------------------------------------------
# integration: a ladder of widths (1, 2)
# ---------------------------------------------------------------------------


def _cfg():
    return S.SLAMConfig(iters_track=3, iters_map=4, capacity=1024, frag_capacity=48,
                        map_window=2, map_rebuild_stride=2,
                        keyframe=KeyframePolicy(kind="monogs", interval=2),
                        prune=PruneConfig(k0=2, step_frac=0.1))


@pytest.fixture(scope="module")
def rig():
    scenes = {}
    for i, name in enumerate(("room0", "stairs0", "desk0", "hall0")):
        ds_j = jmake_dataset(name, num_frames=5, height=48, width=64,
                             num_gaussians=400, frag_capacity=48, seed=i)
        scenes[name] = convert.dataset_from_numpy(ds_j, device="cpu")
    return _cfg(), scenes


def _init(ds, cfg):
    return S.session_init(ds, cfg, device="cpu")


def _solo(ds, cfg, upto=None):
    sess = _init(ds, cfg)
    for f in ds.frames[1:upto]:
        sess, _ = S.session_step(sess, f)
    return sess


def _queued(sched, sid):
    loc = sched.placement(sid)
    return sched.ladder[loc[0]].server.queue.fill(loc[1]) if loc else 0


def _drive(sched, feeds, close=(), timeout_s=120.0):
    """Single-threaded feeder: offer every frame of ``feeds`` with
    backpressure retries, close each sid of ``close`` when its feed runs
    out, tick until every queue drains and every closed stream finished."""
    pending = {sid: list(frames) for sid, frames in feeds.items()}
    close = set(close)
    deadline = time.monotonic() + timeout_s

    def behind():
        return (any(pending.values())
                or any(_queued(sched, sid) for sid in feeds)
                or any(sid not in sched.finished() for sid in close))

    while behind():
        assert time.monotonic() < deadline, "feeder stalled"
        for sid in list(pending):
            frames = pending[sid]
            while frames and sched.offer(sid, frames[0]):
                frames.pop(0)
            if not frames:
                if sid in close:
                    sched.close(sid)
                del pending[sid]
        sched.tick()
    sched.drain()


def test_ladder_migration_parity_and_zero_capture(rig):
    """One stream steps on S=1, migrates to S=2 mid-trajectory with a frame
    queued (transplanted, not dropped), and goes on beside an admission on
    the destination pool and an admission and retirement on the source
    pool: every stream finishes bit for bit as its solo run, the runner
    census is what ``warmup`` left, and the registry counts one step
    dispatch per frame-step per group."""
    cfg, scenes = rig
    ds_main, ds_other, ds_third = scenes["room0"], scenes["stairs0"], scenes["desk0"]
    tele = Telemetry.on(trace=True)
    ladder = PoolLadder(_init(ds_main, cfg), widths=(1, 2), queue_depth=2,
                        telemetry=tele)
    baseline = ladder.warmup()
    assert baseline["segments"] > 0 and baseline["captures"] == 0   # CPU
    sched = SlamScheduler(ladder, telemetry=tele, reserve_slots=0)

    sched.admit("main", _init(ds_main, cfg))
    assert sched.placement("main") == (0, 0)
    assert sched.offer("main", ds_main.frames[1])
    assert sched.offer("main", ds_main.frames[2])
    while ladder[0].server.queue.fill(0):
        sched.tick()

    sched.admit("other", _init(ds_other, cfg))
    assert sched.placement("other") == (1, 0)
    assert sched.offer("main", ds_main.frames[3])
    sched.migrate("main", 1)
    assert sched.placement("main")[0] == 1
    assert ladder[0].server.stats.frames_dropped == 0
    assert ladder[1].server.queue.fill(sched.placement("main")[1]) == 1

    sched.admit("third", _init(ds_third, cfg))
    assert sched.placement("third") == (0, 0)
    assert sched.offer("third", ds_third.frames[1])
    _drive(sched, {"main": [ds_main.frames[4]],
                   "other": list(ds_other.frames[1:]),
                   "third": list(ds_third.frames[2:3])},
           close=("main", "other", "third"))
    assert sorted(sched.finished()) == ["main", "other", "third"]
    assert sched.stats.migrations == 1

    assert compile_cache_stats() == baseline

    for rung in ladder.rungs:
        disp = tele.registry.sum_counters("dispatches", kind="step", group=rung.name)
        assert disp == rung.server.stats.steps
    assert tele.registry.sum_counters("migrations") == 1
    assert tele.registry.sum_counters("dispatches", kind="admin") == 4

    assert same_session(sched.row("main"), _solo(ds_main, cfg))
    assert same_session(sched.row("other"), _solo(ds_other, cfg))
    assert same_session(sched.row("third"), _solo(ds_third, cfg, upto=3))

    lat = latency_summary(tele.registry, "frame_latency_ms", stream="main")
    assert lat["count"] == 4 and lat["p50_ms"] <= lat["p99_ms"]


def test_policy_driven_eviction_unblocks_waiters(rig):
    cfg, scenes = rig
    ds_a, ds_b, ds_c = scenes["room0"], scenes["stairs0"], scenes["hall0"]
    tele = Telemetry()
    ladder = PoolLadder(_init(ds_a, cfg), widths=(1, 2), queue_depth=2,
                        telemetry=tele)
    ladder.warmup()
    sched = SlamScheduler(ladder, policy=QueueDepthPolicy(starve_s=0.0, cooldown_s=0.0),
                          telemetry=tele, reserve_slots=0)

    sched.admit("a", _init(ds_a, cfg))
    sched.admit("b", _init(ds_b, cfg))
    assert sched.offer("b", ds_b.frames[1])
    sched.admit("c", _init(ds_c, cfg))
    assert sched.placement("b")[0] == 1 and sched.placement("c")[0] == 1

    assert sched.tick() == 0
    assert sched.stats.migrations == 0

    sched.close("a")
    assert sched.tick() == 1
    assert sched.placement("c") == (0, 0)
    assert sched.stats.migrations == 1 and sched.stats.completions == 1

    _drive(sched, {"b": list(ds_b.frames[2:]), "c": list(ds_c.frames[1:])},
           close=("b", "c"))
    assert same_session(sched.row("a"), _init(ds_a, cfg))
    assert same_session(sched.row("b"), _solo(ds_b, cfg))
    assert same_session(sched.row("c"), _solo(ds_c, cfg))


def test_threaded_ingest_end_to_end(rig):
    """Producer-thread ingest (one rate-limited stream) and the dispatch
    thread's serve loop, one admission waiting for a slot, auto-retire
    handing slots over: every stream bit for bit as its solo run, nothing
    dropped, and no new segment."""
    cfg, scenes = rig
    tele = Telemetry()
    ladder = PoolLadder(_init(scenes["room0"], cfg), widths=(1, 2), queue_depth=2,
                        telemetry=tele)
    baseline = ladder.warmup()
    sched = SlamScheduler(ladder, policy=QueueDepthPolicy(starve_s=0.02, cooldown_s=0.05),
                          telemetry=tele, reserve_slots=1)
    sids = list(scenes)
    for name in sids:
        sched.admit(name, _init(scenes[name], cfg))
    worker = IngestWorker(sched, {name: scenes[name].frames[1:] for name in sids},
                          period_s={"hall0": 0.05})
    worker.start()
    try:
        sched.serve(worker=worker, timeout_s=300)
    finally:
        worker.stop()
    assert not worker.is_alive()
    assert worker.error is None and worker.done.is_set()
    assert worker.offered == 4 * 4
    assert sorted(sched.finished()) == sorted(sids)
    assert sched.stats.admits == 4 and sched.stats.completions == 4
    assert compile_cache_stats() == baseline
    for name in sids:
        assert same_session(sched.row(name), _solo(scenes[name], cfg)), name
    for rung in ladder.rungs:
        disp = tele.registry.sum_counters("dispatches", kind="step", group=rung.name)
        assert disp == rung.server.stats.steps
        assert rung.server.stats.frames_dropped == 0


def test_default_decode_makes_host_tensors(rig):
    _, scenes = rig
    rgb, depth = default_decode(scenes["room0"].frames[1])
    assert rgb.device.type == "cpu" and rgb.dtype == torch.float32
    assert rgb.is_contiguous() and depth.shape == (48, 64)
    assert torch.equal(rgb, scenes["room0"].frames[1].rgb)
    assert torch.equal(default_decode((rgb.numpy(), depth.numpy()))[1], depth)


def test_scheduler_admission_and_api_guards(rig):
    cfg, scenes = rig
    tele = Telemetry()
    ladder = PoolLadder(_init(scenes["room0"], cfg), widths=(1,), telemetry=tele)
    sched = SlamScheduler(ladder, telemetry=tele, reserve_slots=1)
    sched.admit("a", _init(scenes["room0"], cfg))
    assert sched.placement("a") == (0, 0)
    with pytest.raises(ValueError, match="already admitted"):
        sched.admit("a", _init(scenes["room0"], cfg))
    with pytest.raises(KeyError):
        sched.offer("ghost", scenes["room0"].frames[1])
    with pytest.raises(PoolFull):
        sched.migrate("a", 0)
    sched.admit("b", _init(scenes["stairs0"], cfg))
    assert sched.placement("b") is None
    sched.close("a")
    sched.close("b")
    sched.serve(timeout_s=60)
    assert sorted(sched.finished()) == ["a", "b"]
    with pytest.raises(KeyError):
        sched.offer("b", scenes["stairs0"].frames[1])
    with pytest.raises(ValueError, match="solo"):
        PoolLadder(S.stack_sessions([_init(scenes["room0"], cfg)]))
    with pytest.raises(ValueError, match="positive"):
        PoolLadder(_init(scenes["room0"], cfg), widths=(0,))
