"""The port's serving tier (``slam/server.py``) on the CPU.

* ``FrameQueue`` of the port and of the reference, driven through the same
  sequences of operations, give the same results: bounded lockstep,
  ``take``/``load``, head age, telemetry accounting, concurrent producers;
* ``ShardedPool`` at D=1 equals ``step_many`` bit for bit, one step
  dispatch per tracking-only frame-step;
* ``SlamServer``'s backpressure, admission, retire and non-blocking
  ``offer`` (``tests/test_serve.py`` without its multi-device test, which
  the port cannot run: a list of more than one device raises);
* telemetry on and off give bit-identical rows and the same counts.

Sessions run the reference's serving config on its 48x64 scenes, carried
across with ``dataset_from_numpy``.
"""

import threading

import pytest
import torch

from _session_state import same_session
from repro.obs import Telemetry as JTelemetry
from repro.slam.datasets import make_dataset as jmake_dataset
from repro.slam.server import FrameQueue as JFrameQueue
from repro_torch import convert
from repro_torch.core.keyframes import KeyframePolicy
from repro_torch.core.pruning import PruneConfig
from repro_torch.obs import Telemetry
from repro_torch.slam import session as S
from repro_torch.slam.server import (
    FrameQueue, PoolFull, QueueFull, ShardedPool, SlamServer,
    compile_cache_stats,
)


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(**kw):
    base = dict(iters_track=3, iters_map=4, capacity=1024, frag_capacity=48,
                map_window=2, map_rebuild_stride=2,
                keyframe=KeyframePolicy(kind="monogs", interval=2),
                prune=PruneConfig(k0=2, step_frac=0.1))
    base.update(kw)
    return S.SLAMConfig(**base)


def _scene(name, seed):
    ds_j = jmake_dataset(name, num_frames=5, height=48, width=64,
                         num_gaussians=400, frag_capacity=48, seed=seed)
    return convert.dataset_from_numpy(ds_j, device="cpu")


@pytest.fixture(scope="module")
def duo():
    return _cfg(), [_scene(n, i) for i, n in enumerate(("room0", "stairs0"))]


def _init(ds, cfg, **kw):
    return S.session_init(ds, cfg, device="cpu", **kw)


# ---------------------------------------------------------------------------
# FrameQueue: the port against the reference on the same operations
# ---------------------------------------------------------------------------


def _bounded_lockstep(FQ, _):
    q = FQ(slots=3, depth=2)
    out = [q.ready([0, 1]), q.put(0, "a0"), q.put(0, "a1"), q.put(0, "a2"),
           q.ready([0, 1]), q.put(1, "b0"), q.ready([0, 1])]
    frame, waited, fid = q.pop(0)
    out += [frame, waited >= 0.0, fid >= 0, q.fill(0), q.clear(0), q.fill(0)]
    try:
        FQ(slots=1, depth=0)
    except ValueError as e:
        out.append(("ValueError", "depth" in str(e)))
    return out


def _take_load_head_age(FQ, _):
    q = FQ(slots=2, depth=2)
    out = [q.head_age_s(0), q.put(0, "a0"), q.put(0, "a1")]
    age = q.head_age_s(0)
    out.append(age is not None and age >= 0.0)
    entries = q.take(0)
    out += [[e[0] for e in entries], q.fill(0), q.head_age_s(0)]
    q2 = FQ(slots=1, depth=2)
    q2.load(0, entries)
    frame, waited, fid = q2.pop(0)
    out += [q2.fill(0), frame, fid == entries[0][2], waited >= age]
    for target in (q2, FQ(slots=1, depth=1)):
        try:
            target.load(0, entries)
        except ValueError as e:
            out.append(str(e).split(";")[0].split(" (")[0])
    return out


def _telemetry_accounting(FQ, Tele):
    tele = Tele.on(trace=True)
    q = FQ(slots=2, depth=2, telemetry=tele)
    out = [q.put(0, "a0"), q.put(0, "a1"), q.put(0, "a2"), q.put(1, "b0")]
    reg = tele.registry
    out += [reg.gauge("queue_depth", slot=0).hwm, reg.gauge("queue_depth", slot=1).hwm]
    starts = [e for e in tele.trace.events if e["ph"] == "s"]
    out += [len(starts), len({e["id"] for e in starts})]
    q.pop(0)
    q.clear(0)
    out += [reg.gauge("queue_depth", slot=0).value, reg.gauge("queue_depth", slot=0).hwm,
            sorted(e["name"] for e in tele.trace.events if e["ph"] == "C")]
    return out


def _concurrent_producers(FQ, _):
    slots, n = 3, 200
    q = FQ(slots=slots, depth=4)

    def produce(slot):
        sent = 0
        while sent < n:
            if q.put(slot, (slot, sent)):
                sent += 1

    producers = [threading.Thread(target=produce, args=(s,), daemon=True)
                 for s in range(slots)]
    for t in producers:
        t.start()
    popped = {s: [] for s in range(slots)}
    fids = []
    while any(len(popped[s]) < n for s in range(slots)):
        for s in range(slots):
            if len(popped[s]) < n and q.fill(s):
                frame, _, fid = q.pop(s)
                popped[s].append(frame)
                fids.append(fid)
    for t in producers:
        t.join(timeout=10.0)
    return [[not t.is_alive() for t in producers], popped, len(set(fids))]


@pytest.mark.parametrize("scenario", [_bounded_lockstep, _take_load_head_age,
                                      _telemetry_accounting, _concurrent_producers],
                         ids=lambda f: f.__name__.strip("_"))
def test_frame_queue_matches_the_reference(scenario):
    port = scenario(FrameQueue, Telemetry)
    ref = scenario(JFrameQueue, JTelemetry)
    assert port == ref
    if scenario is _bounded_lockstep:
        assert port == [False, True, True, False, False, True, True, "a0", True,
                        True, 1, 1, 0, ("ValueError", True)]
    if scenario is _concurrent_producers:
        assert port[1] == {s: [(s, i) for i in range(200)] for s in range(3)}
        assert port[2] == 600 and all(port[0])


# ---------------------------------------------------------------------------
# ShardedPool at D=1 and the server
# ---------------------------------------------------------------------------


def test_sharded_pool_matches_step_many_bit_for_bit(duo):
    cfg, scenes = duo
    stack = S.stack_sessions([_init(ds, cfg) for ds in scenes])
    for t in (1, 2, 3):
        stack, _ = S.step_many(stack, [ds.frames[t] for ds in scenes])

    pool = ShardedPool([_init(ds, cfg) for ds in scenes])
    srv = SlamServer(pool)
    steps = []
    for t in (1, 2, 3):
        for i, ds in enumerate(scenes):
            srv.submit(i, ds.frames[t])
        before = pool.stats.dispatches
        assert srv.pump() == 1
        steps.append((pool.stats.dispatches - before, srv.last_result.is_kf))
    srv.drain()
    # The first frame-step is tracking-only, the second maps both rows.
    assert steps[0][1] == (False, False) and steps[1][1] == (True, True)
    assert srv.stats.steps == 3 and srv.stats.frames_in == 6
    assert srv.stats.queue_wait_s >= 0.0
    for i in range(2):
        assert same_session(pool.session(i), S.session_row(stack, i)), i
    mem = pool.memory_profile()
    assert mem["rows"] == 2 and mem["storage_rows"] == cfg.capacity
    assert mem["allocated_bytes"] == 0          # no card here


def test_pool_without_pruning_steps_in_one_dispatch(duo):
    """Without pruning a tracking-only frame-step of every row is one
    dispatch and no sync (one graph replay on the card)."""
    cfg = _cfg(prune=None)
    _, scenes = duo
    pool = ShardedPool([_init(ds, cfg) for ds in scenes])
    res = pool.step([ds.frames[1] for ds in scenes])
    assert res.is_kf == (False, False)
    assert (pool.stats.dispatches, pool.stats.syncs) == (1, 0)


def test_server_backpressure_and_admission(duo):
    cfg, scenes = duo
    ds_a, ds_b = scenes
    pool = ShardedPool([_init(ds, cfg) for ds in scenes])
    srv = SlamServer(pool, queue_depth=2)

    srv.submit(0, ds_a.frames[1])
    srv.submit(0, ds_a.frames[2])
    with pytest.raises(QueueFull, match="starved"):
        srv.submit(0, ds_a.frames[3])
    assert srv.stats.backpressure_events == 1
    assert srv.pump() == 0

    srv.submit(1, ds_b.frames[1])
    srv.submit(1, ds_b.frames[2])
    assert srv.pump() == 2

    with pytest.raises(PoolFull, match="retire"):
        srv.admit(_init(ds_b, cfg))

    retired = srv.retire(1)
    assert retired.batch is None
    assert srv.free_slots() == [1]
    with pytest.raises(ValueError, match="not live"):
        srv.submit(1, ds_b.frames[3])
    # The free slot steps on a blank frame (row 1 is at its frame 3: no
    # keyframe), which the server counts.
    srv.submit(0, ds_a.frames[3])
    assert srv.pump() == 1
    assert (srv.stats.blank_row_steps, srv.stats.blank_keyframes) == (1, 0)
    ds_c = _scene("desk0", 9)
    slot = srv.admit(_init(ds_c, cfg))
    assert slot == 1 and srv.live_slots() == [0, 1]
    assert pool.admin_dispatches == 1

    # The admitted row then steps bit for bit as its solo run.
    srv.submit(0, ds_a.frames[4])
    srv.submit(1, ds_c.frames[1])
    srv.pump()
    srv.drain()
    solo, _ = S.session_step(_init(ds_c, cfg), ds_c.frames[1])
    assert same_session(pool.session(1), solo)
    # The retired row is a snapshot: the free slot's blank steps did not
    # write into it, and it continues as its solo run.
    solo_b = _init(ds_b, cfg)
    for t in (1, 2):
        solo_b, _ = S.session_step(solo_b, ds_b.frames[t])
    assert same_session(retired, solo_b)


def test_retire_drops_queued_frames_and_accounts_them(duo):
    cfg, scenes = duo
    pool = ShardedPool([_init(ds, cfg) for ds in scenes])
    srv = SlamServer(pool, queue_depth=2)
    srv.submit(1, scenes[1].frames[1])
    srv.submit(1, scenes[1].frames[2])
    assert srv.queue.fill(1) == 2

    retired = srv.retire(1)
    assert retired.batch is None
    assert srv.queue.fill(1) == 0
    assert srv.stats.frames_dropped == 2
    assert srv.stats.frames_in == 2
    with pytest.raises(ValueError, match="not live"):
        srv.offer(1, scenes[1].frames[3])

    slot = srv.admit(_init(scenes[1], cfg))
    assert slot == 1 and srv.queue.fill(1) == 0
    assert srv.stats.frames_dropped == 2


def test_offer_is_nonblocking_and_never_dispatches(duo):
    cfg, scenes = duo
    pool = ShardedPool([_init(ds, cfg) for ds in scenes])
    srv = SlamServer(pool, queue_depth=2)
    for t in (1, 2):
        assert srv.offer(0, scenes[0].frames[t])
        assert srv.offer(1, scenes[1].frames[t])
    assert not srv.offer(0, scenes[0].frames[3])
    assert srv.stats.backpressure_events == 1
    assert srv.stats.steps == 0 and pool.stats.dispatches == 0
    assert srv.stats.frames_in == 4
    assert srv.pump() == 2
    srv.drain()
    assert srv.stats.steps == 2 and pool.stats.syncs > 0


def test_sharded_pool_validation(duo):
    cfg, scenes = duo
    sess = _init(scenes[0], cfg)
    with pytest.raises(ValueError, match="at least one"):
        ShardedPool([])
    with pytest.raises(ValueError, match="fused"):
        ShardedPool([_init(scenes[0], _cfg(fused=False))])
    with pytest.raises(NotImplementedError, match="more than one device"):
        ShardedPool([sess], devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="do not hold"):
        ShardedPool([sess], devices=["cuda:0"])
    pool = ShardedPool([sess, _init(scenes[1], cfg)], devices=["cpu"])
    assert pool.num_devices == 1
    with pytest.raises(ValueError, match="static config"):
        pool.swap(0, _init(scenes[0], _cfg(iters_map=5)))
    with pytest.raises(ValueError, match="max_frames"):
        pool.swap(0, _init(scenes[0], cfg, max_frames=9))


def test_telemetry_on_and_off_are_bit_identical(duo):
    """A telemetry-on serving run and a telemetry-off one: the same rows
    bit for bit, the same dispatches and syncs, no new segment; the
    registry and the trace hold what the server saw.

    Every segment serving reaches exists before the census, as after
    ``PoolLadder.warmup``: a solo step, a 2-row frame-step and a 2-row
    keyframe segment (whether an earlier test in the same process made
    them does not matter)."""
    cfg, scenes = duo
    S.session_step(_init(scenes[0], cfg), scenes[0].frames[1])
    ShardedPool([_init(ds, cfg) for ds in scenes]).step([ds.frames[1] for ds in scenes])
    S.warm_keyframe(_init(scenes[0], cfg), 2)
    census = compile_cache_stats()
    runs = []
    for tele in (None, Telemetry.on(trace=True)):
        pool = ShardedPool([_init(ds, cfg) for ds in scenes])
        srv = SlamServer(pool, telemetry=tele)
        for t in (1, 2, 3):
            for i, ds in enumerate(scenes):
                srv.submit(i, ds.frames[t])
            srv.pump()
        srv.drain()
        assert compile_cache_stats() == census
        runs.append((pool, tele))
    (off, _), (on, tele) = runs
    for i in range(2):
        assert same_session(on.session(i), off.session(i))
    assert (on.stats.dispatches, on.stats.syncs) == (off.stats.dispatches,
                                                    off.stats.syncs)
    reg = tele.registry
    assert reg.sum_counters("dispatches", kind="step") == 3
    assert reg.merged_histogram("frame_latency_ms").count == 6
    names = {e["name"] for e in tele.trace.events if e["ph"] == "X"}
    assert {"stage", "dispatch", "drain", "submit"} <= names
    flows = [e["ph"] for e in tele.trace.events if e["ph"] in "sf"]
    assert flows.count("s") == flows.count("f") == 6
