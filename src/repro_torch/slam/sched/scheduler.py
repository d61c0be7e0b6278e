"""SlamScheduler — continuous batching over the pool-width ladder (the
port's copy of ``repro/slam/sched/scheduler.py``).

The scheduler is the dispatch-thread orchestrator tying the tier together:
streams are admitted into whichever rung has room (never recompiling —
the ladder captured every width's graphs in its warmup), each group pumps on its own cadence
(a starved group skips the tick; it never stalls another group), and when
a group blocks the policy migrates a row between pool widths.

**Migration is the v1 slot-swap machinery, re-aimed.**  Moving stream X
from rung A to rung B is: transplant X's queued frames
(``FrameQueue.take`` — original timestamps and flow ids ride along),
``retire`` the row from A (a row copy, ``kind="admin"``), ``admit`` it
into B (same machinery), ``load`` the frames into B's queue.  Nothing
about the row's *contents* changes and each row runs the solo ops at
every width, so the stream's trajectory is bitwise-equal to a solo run no
matter how often it moves — test-enforced in tests/test_torch_sched.py.

**Threading model.**  Exactly one dispatch thread calls :meth:`tick` /
:meth:`drain`; the ingest worker (any number of producer threads) calls
:meth:`offer` / :meth:`close`.  One scheduler lock guards the placement
map, so an ``offer`` either lands wholly before a migration (the frame is
transplanted with the queue) or wholly after (it lands in the destination
queue) — never in between.  Pumping happens OUTSIDE the lock: device
dispatch must not block producers.  Only the dispatch thread touches the
card; producers only queue host tensors.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Dict, List, Optional

from repro_torch.obs import Telemetry, now_s, telemetry_or_off
from repro_torch.slam.server import PoolFull
from repro_torch.slam.session import SLAMResult, SlamSession, session_finalize
from repro_torch.slam.sched.ladder import PoolLadder
from repro_torch.slam.sched.policy import (
    GroupView,
    Migration,
    QueueDepthPolicy,
    SlotView,
)

__all__ = ["SchedStats", "SlamScheduler"]


@dataclasses.dataclass
class _Stream:
    sid: object
    session: Optional[SlamSession]   # held while waiting for placement
    rung: Optional[int] = None
    slot: Optional[int] = None
    closed: bool = False             # producer promises no more frames
    last_move_s: float = float("-inf")
    migrations: int = 0
    slow_marks: int = 0              # times evicted as the starving row


@dataclasses.dataclass
class SchedStats:
    """Scheduler-level counters (per-group serving counters live on each
    rung's ``ServeStats``; device counters on each pool's ``stats``)."""

    ticks: int = 0
    steps: int = 0                   # frame-steps dispatched, all groups
    admits: int = 0                  # placements (first admission only)
    migrations: int = 0              # row moves between rungs
    completions: int = 0             # streams retired with queues drained
    migrations_by_reason: Dict[str, int] = dataclasses.field(
        default_factory=dict)        # "evict-starved" | "rescue-waiter" | ...


class SlamScheduler:
    """Continuous-batching front end over a :class:`PoolLadder`.

    ``admit`` registers a stream (placing it immediately when a slot is
    free, else queueing the admission); ``offer`` feeds frames from any
    thread; ``tick`` — the dispatch thread's heartbeat — completes
    finished streams, places waiting ones, executes the policy's
    migrations, and pumps ready groups oldest-deadline-first.
    ``reserve_slots`` keeps that many slots free as the migration lane so
    a blocked group can always shed a row even under full admission
    pressure (migration chains re-balance which rung holds the reserve).
    """

    def __init__(self, ladder: PoolLadder,
                 policy: Optional[QueueDepthPolicy] = None,
                 telemetry: Optional[Telemetry] = None,
                 reserve_slots: int = 1):
        self.ladder = ladder
        self.policy = policy if policy is not None else QueueDepthPolicy()
        self.tele = telemetry_or_off(telemetry)
        self.reserve = max(0, min(reserve_slots, ladder.capacity - 1))
        self.stats = SchedStats()
        self._lock = threading.RLock()
        self._streams: Dict = {}
        self._waiting: collections.deque = collections.deque()
        self._finished: Dict = {}
        self._blocked_since: Dict[int, Optional[float]] = {
            i: None for i in range(len(ladder.rungs))}

    # -- stream lifecycle (any thread) -------------------------------------

    def admit(self, sid, session: SlamSession) -> None:
        """Register stream ``sid`` with its freshly-initialized solo
        session.  Placement happens now if a harmless slot is free
        (respecting the migration reserve and never joining a starving
        lane), else at a later tick when one opens."""
        with self._lock:
            if sid in self._streams or sid in self._finished:
                raise ValueError(f"stream {sid!r} already admitted")
            self._streams[sid] = _Stream(sid=sid, session=session)
            self._waiting.append(sid)
            self._admit_waiting()

    def offer(self, sid, frame) -> bool:
        """Feed one frame to stream ``sid``; False when the stream is not
        placed yet or its queue is full (caller retries — the producer
        thread's non-blocking entry point; never dispatches)."""
        with self._lock:
            st = self._streams.get(sid)
            if st is None:
                raise KeyError(f"unknown stream {sid!r}")
            if st.closed:
                raise ValueError(f"stream {sid!r} is closed")
            if st.slot is None:
                return False
            server = self.ladder.rungs[st.rung].server
            ok = server.offer(st.slot, frame)
            # A full queue is measured proof the producer outpaces the
            # lane — whatever starving eviction once marked this stream
            # slow was a hiccup, not a rate.  Without this exoneration a
            # single false mark bars a fast stream from rescue forever.
            if ok and server.queue.fill(st.slot) >= server.queue.depth:
                st.slow_marks = 0
            return ok

    def close(self, sid) -> None:
        """Producer promise: no more frames for ``sid``.  The stream
        auto-retires once its queue drains, freeing the slot."""
        with self._lock:
            self._streams[sid].closed = True

    # -- the dispatch-thread heartbeat -------------------------------------

    def tick(self) -> int:
        """One scheduler heartbeat: complete, admit, migrate, pump.
        Returns the number of frame-steps dispatched (0 when every group
        skipped — nobody was ready)."""
        with self._lock:
            self.stats.ticks += 1
            self._complete_finished()
            self._admit_waiting()
            views = self._views()
            frozen = frozenset(
                st.sid for st in self._streams.values()
                if now_s() - st.last_move_s < self.policy.cooldown_s)
            for mig in self.policy.migrations(views, frozen=frozen):
                self._execute(mig)
            order = self.policy.pump_order(self._views())
            servers = [self.ladder.rungs[ix].server for ix in order]
        steps = 0
        for server in servers:           # outside the lock: device work
            steps += server.pump()
        self.stats.steps += steps
        return steps

    def drain(self) -> None:
        """Pump every group dry of ready batches, then block until all
        in-flight device work completes (one sync per rung)."""
        for rung in self.ladder.rungs:
            rung.server.drain()

    def serve(self, worker=None, timeout_s: float = 600.0,
              idle_sleep_s: float = 5e-4) -> int:
        """Tick until every registered stream has finished (its producer
        closed it and its queue drained), then drain.  ``worker`` — an
        :class:`~repro_torch.slam.sched.ingest.IngestWorker` — is checked for a
        producer-thread error each pass.  Returns total steps."""
        deadline = now_s() + timeout_s
        total = 0
        while True:
            steps = self.tick()
            total += steps
            if worker is not None and getattr(worker, "error", None):
                raise worker.error
            with self._lock:
                done = not self._streams   # finished streams move out
            if done:
                break
            if now_s() > deadline:
                with self._lock:
                    stuck = [st.sid for st in self._streams.values()]
                raise RuntimeError(
                    f"scheduler serve timed out after {timeout_s:.0f}s; "
                    f"unfinished streams: {stuck}")
            if steps == 0:
                time.sleep(idle_sleep_s)
        self.drain()
        return total

    # -- results -----------------------------------------------------------

    def row(self, sid) -> SlamSession:
        """The finished solo session of ``sid`` (bitwise the row that left
        the pool at retirement)."""
        with self._lock:
            return self._finished[sid]

    def result(self, sid, gt_w2c=None, **kw) -> SLAMResult:
        """Finalize finished stream ``sid`` into a :class:`SLAMResult`."""
        return session_finalize(self.row(sid), gt_w2c=gt_w2c, **kw)

    def finished(self) -> List:
        with self._lock:
            return list(self._finished)

    def migrate(self, sid, dst_rung: int) -> int:
        """Manually move ``sid`` to rung ``dst_rung`` now (tests and
        explicit placement use this; the policy path goes through
        :meth:`tick`).  Returns the new slot index."""
        with self._lock:
            st = self._streams[sid]
            if st.slot is None:
                raise ValueError(f"stream {sid!r} is not placed")
            if not self.ladder.rungs[dst_rung].server.free_slots():
                raise PoolFull(f"rung {dst_rung} has no free slot")
            self._execute(Migration(sid, st.rung, dst_rung, "manual"))
            return st.slot

    def placement(self, sid):
        """Current ``(rung, slot)`` of ``sid``, or None while waiting."""
        with self._lock:
            st = self._streams.get(sid)
            if st is None or st.slot is None:
                return None
            return (st.rung, st.slot)

    # -- internals (call with self._lock held) -----------------------------

    def _complete_finished(self) -> None:
        for sid in list(self._streams):
            st = self._streams[sid]
            if not st.closed:
                continue
            if st.slot is None:
                # Closed before placement: never stepped; its session IS
                # the finished row.
                if st.session is not None:
                    self._finished[sid] = st.session
                    try:
                        self._waiting.remove(sid)
                    except ValueError:
                        pass
                    del self._streams[sid]
                    self.stats.completions += 1
                continue
            rung = self.ladder.rungs[st.rung]
            if rung.server.queue.fill(st.slot) == 0:
                self._finished[sid] = rung.server.retire(st.slot)
                del self._streams[sid]
                self.stats.completions += 1
                self.tele.count("completions", stream=sid)

    def _admit_waiting(self) -> None:
        while self._waiting:
            free = self.ladder.free_slots()
            budget = free - (self.reserve if self.ladder.live_streams()
                             else 0)
            if budget <= 0:
                break
            sid = self._waiting[0]
            st = self._streams[sid]
            rung_ix = self._admission_rung()
            if rung_ix is None:        # only starving lanes have room: hold
                break
            rung = self.ladder.rungs[rung_ix]
            st.slot = rung.server.admit(st.session, label=sid)
            st.rung = rung_ix
            st.session = None
            self._waiting.popleft()
            self.stats.admits += 1

    def _admission_rung(self) -> Optional[int]:
        """Harmless-only placement for a fresh stream of unknown rate.
        Tier 0 — empty rungs, narrowest first: a solo stream runs at its
        own rate whatever that rate turns out to be, so nobody is harmed
        while the policy learns it.  Tier 1 — clean running rungs (no
        starving slot), fewest peers first: if the newcomer turns out
        slow, one cheap 1-starving eviction repairs the lane.  A lane
        with a starving slot is NEVER an admission target — returns None
        (hold the stream unplaced) instead: a fast newcomer dumped into
        a slow pool pays whole slow-producer periods per frame waiting
        to be rescued, while a held stream pays nothing and lands solo
        in the next lane a completion empties."""
        best = None
        for ix, rung in enumerate(self.ladder.rungs):
            if not rung.server.free_slots():
                continue
            q = rung.server.queue
            live = rung.server.live_slots()
            if any(q.fill(s) == 0 for s in live):
                continue
            tier = 0 if not live else 1
            key = (tier, len(live), rung.width, ix)
            if best is None or key < best[0]:
                best = (key, ix)
        return None if best is None else best[1]

    def _views(self) -> List[GroupView]:
        now = now_s()
        views = []
        for ix, rung in enumerate(self.ladder.rungs):
            q = rung.server.queue
            svs = []
            for s in rung.server.live_slots():
                sid = rung.server.slot_label(s)
                st = self._streams.get(sid)
                svs.append(SlotView(
                    slot=s, stream=sid, fill=q.fill(s),
                    head_age_s=q.head_age_s(s),
                    slow_marks=st.slow_marks if st is not None else 0))
            svs = tuple(svs)
            waiters = any(sv.fill > 0 for sv in svs)
            starving = any(sv.fill == 0 for sv in svs)
            blocked = waiters and starving
            if blocked:
                if self._blocked_since[ix] is None:
                    self._blocked_since[ix] = now
                bf = now - self._blocked_since[ix]
            else:
                self._blocked_since[ix] = None
                bf = 0.0
            views.append(GroupView(
                rung=ix, name=rung.name, width=rung.width,
                free=len(rung.server.free_slots()), blocked_for_s=bf,
                slots=svs))
        return views

    def _execute(self, mig: Migration) -> None:
        st = self._streams.get(mig.stream)
        if st is None or st.slot is None or st.rung != mig.src:
            return                      # stale plan; stream moved/finished
        src = self.ladder.rungs[mig.src]
        dst = self.ladder.rungs[mig.dst]
        if mig.src == mig.dst or not dst.server.free_slots():
            return
        with self.tele.span("migrate", src=src.name, dst=dst.name,
                            reason=mig.reason):
            # Queue transplant first (original timestamps + flow ids),
            # then the two admin-kind row swaps.  Offers cannot interleave
            # here — they take the scheduler lock we hold.
            entries = src.server.queue.take(st.slot)
            row = src.server.retire(st.slot)
            new_slot = dst.server.admit(row, label=st.sid)
            dst.server.queue.load(new_slot, entries)
        st.rung, st.slot = mig.dst, new_slot
        st.last_move_s = now_s()
        st.migrations += 1
        if mig.reason == "evict-starved":
            st.slow_marks += 1
        self.stats.migrations += 1
        by = self.stats.migrations_by_reason
        by[mig.reason] = by.get(mig.reason, 0) + 1
        self.tele.count("migrations", stream=st.sid, reason=mig.reason)
