"""SlamServe on one card (counterpart of ``repro/slam/server.py``): the
queue-fed multi-session SLAM serving tier.

* :class:`ShardedPool` holds S stacked sessions (:func:`~repro_torch.slam.
  session.stack_sessions`) on one device and steps them through
  :func:`~repro_torch.slam.session.step_many`: one shared phase runner, so
  a frame-step in which no row takes a keyframe is one CUDA graph replay
  for all S rows, and every row stays bit for bit its solo run.  The
  reference lays the rows over a mesh of D devices; the port's card
  machine has one H100, so the pool runs at D=1 and a list of more devices
  raises ``NotImplementedError``.
* :class:`FrameQueue` + :class:`SlamServer` form the host pipeline:
  per-stream bounded ingest queues with backpressure, and a dispatcher
  that stages each lockstep frame batch from pinned host memory
  (``non_blocking`` copies, which overlap the step in flight) and steps
  the pool.  The host waits for the card only in :meth:`SlamServer.drain`
  and ``finalize``, and where a keyframe reads the device (densify).
* Admission control: :meth:`SlamServer.admit` / :meth:`SlamServer.retire`
  swap rows in place mid-stream, so heterogeneous scenes run concurrently
  and finished streams hand their slots to waiting ones.  A full pool
  raises :class:`PoolFull`, and full ingest queues push back through
  :meth:`SlamServer.submit`.

Free slots (retired, not yet re-admitted) keep stepping on blank frames —
the pool is lockstep by construction — and their row state is scratch
until the next ``admit`` overwrites it.  That scratch work is real device
work (a blank row may even take a keyframe) and is counted like any other.

Serving constraints are the session tier's
(:func:`~repro_torch.slam.session.require_servable`): ``cfg.fused=True``,
downsampling off.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import threading
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch._device import constant
from repro_torch.obs import Stopwatch, Telemetry, now_s, telemetry_or_off
from repro_torch.slam import session as S
from repro_torch.slam.session import (
    Observation, SLAMResult, SessionPool, SlamSession, StepResult,
    require_servable,
)


class PoolFull(RuntimeError):
    """Admission backpressure: every slot is live; retire one first."""


class QueueFull(RuntimeError):
    """Ingest backpressure: a stream is ahead of its lockstep peers and
    its bounded queue cannot absorb more frames."""


# ---------------------------------------------------------------------------
# the device pool
# ---------------------------------------------------------------------------


def compile_cache_stats() -> dict:
    """Census of the phase-runner cache (``session.runner_for``): runners,
    segments and CUDA graph captures, ``session_init``'s bootstrap mapping
    included.  The sched tier's **zero-capture invariant** is this dict
    being EQUAL before and after a serving phase (admissions, migrations
    and steps included): a new segment or capture shows up as a changed
    number.  On the CPU nothing is captured, and a new segment still
    shows."""
    runners = S.cached_runners()
    return {
        "runners": len(runners),
        "segments": sum(len(r._segments) for r in runners),
        "captures": sum(r.stats.captures for r in runners),
    }


def _pool_device(sessions: Sequence[SlamSession], devices) -> torch.device:
    """The one device a pool runs on: the sessions' own, which ``devices``
    (None, or a list of one device) must name if given."""
    dev = sessions[0].device
    if devices is None:
        return dev
    devices = [torch.device(d) for d in devices]
    if len(devices) > 1:
        raise NotImplementedError(
            "ShardedPool over more than one device is not ported to "
            "repro_torch yet (the card machine has one H100)")
    want = devices[0]
    if want.type != dev.type or (want.index is not None
                                 and want.index != (dev.index or 0)):
        raise ValueError(f"ShardedPool devices {devices} do not hold the "
                         f"sessions, which are on {dev}")
    return dev


class ShardedPool(SessionPool):
    """S stacked sessions on one device, stepped in lockstep: a
    :class:`~repro_torch.slam.session.SessionPool` that stages host frames
    onto the device and counts its row swaps.

    :meth:`step` stages the S frames and runs :func:`~repro_torch.slam.
    session.step_many`: a frame-step in which no row takes a keyframe is
    one graph replay and no sync for all S rows; each keyframe row adds
    its mapping work.  :meth:`swap` is the admission tier's device op:
    replace one row (a copy of its tensors; nothing is captured), counted
    in ``admin_dispatches``.
    """

    def __init__(self, sessions: Sequence[SlamSession], devices=None):
        sessions = list(sessions)
        if not sessions:
            raise ValueError("ShardedPool needs at least one session")
        require_servable(sessions[0].cfg, what="ShardedPool")
        self.device = _pool_device(sessions, devices)
        super().__init__(sessions)
        self.admin_dispatches = 0      # admit/retire row swaps

    @property
    def num_devices(self) -> int:
        return 1

    @property
    def cfg(self):
        return self._stacked.cfg

    @property
    def intr(self):
        return self._stacked.intr

    # -- the data plane ----------------------------------------------------

    def stage(self, frames) -> Observation:
        """Host→device staging of one lockstep frame batch: each row's
        frame is copied from pinned host memory with ``non_blocking=True``
        (a frame already on the device is copied on the device), so the
        copy overlaps any step in flight."""
        if isinstance(frames, Observation):
            return frames
        frames = list(frames)
        if len(frames) != self.size:
            raise ValueError(f"expected {self.size} frames, got {len(frames)}")
        h, w, dev = self.intr.height, self.intr.width, self.device
        rgb = torch.empty((self.size, h, w, 3), dtype=torch.float32, device=dev)
        depth = torch.empty((self.size, h, w), dtype=torch.float32, device=dev)
        for s, f in enumerate(frames):
            r, d = S.frame_arrays(f)
            rgb[s].copy_(_pinned(r, dev), non_blocking=True)
            depth[s].copy_(_pinned(d, dev), non_blocking=True)
        return Observation(rgb=rgb, depth=depth)

    def step(self, frames) -> StepResult:
        """Advance all S rows by one frame.  ``frames`` is S per-row frames
        or an already :meth:`stage`-d ``Observation``.  Returns the stacked
        :class:`StepResult`."""
        return super().step(self.stage(frames))

    # -- the control plane -------------------------------------------------

    def swap(self, slot: int, new_session: SlamSession) -> SlamSession:
        """Replace row ``slot`` with (a copy of) ``new_session`` and return
        the retired row as a solo session."""
        old = super().swap(slot, new_session)
        self.admin_dispatches += 1
        return old

    def memory_profile(self) -> dict:
        """Per-row memory shape of this pool, and the device's allocator
        counters (``torch.cuda`` memory stats; zeros on the CPU).
        ``storage_rows`` is each row's Gaussian pool; ``working_rows`` the
        rows a frame-step optimizes (the frustum-culled view when
        ``cfg.paged`` is set, the whole pool otherwise); the byte figures
        scale them by the bytes of one Gaussian's leaves."""
        g = self._stacked.rows[0].g
        row_bytes = sum(t[0].numel() * t.element_size() for t in
                        (getattr(g, f.name) for f in dataclasses.fields(g)))
        storage_rows = self.cfg.capacity
        paged = self.cfg.paged
        working_rows = (paged.visible_pages * paged.page_capacity
                        if paged is not None else storage_rows)
        out = {
            "rows": self.size,
            "storage_rows": storage_rows,
            "working_rows": working_rows,
            "working_fraction": working_rows / storage_rows,
            "storage_bytes_per_row": storage_rows * row_bytes,
            "working_bytes_per_row": working_rows * row_bytes,
            "paged": paged is not None,
        }
        cuda = self.device.type == "cuda"
        for key, fn in (("allocated_bytes", torch.cuda.memory_allocated),
                        ("reserved_bytes", torch.cuda.memory_reserved),
                        ("peak_allocated_bytes", torch.cuda.max_memory_allocated)):
            out[key] = int(fn(self.device)) if cuda else 0
        return out


def _pinned(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """``t`` in page-locked host memory when it goes from the host to the
    card (a ``non_blocking`` copy from pageable memory would wait)."""
    if dev.type == "cuda" and t.device.type == "cpu" and not t.is_pinned():
        return t.pin_memory()
    return t


# ---------------------------------------------------------------------------
# the host-side frame pipeline
# ---------------------------------------------------------------------------


#: Flow ids are allocated process-globally (not per queue) so a trace fed
#: by several queues — the sched tier runs one FrameQueue per pool group —
#: never reuses an arrow id, and a frame migrated between queues keeps the
#: arrow it opened at first enqueue.  ``itertools.count`` is atomic under
#: the GIL, so producer threads share it without a lock.
_FLOW_IDS = itertools.count()


class FrameQueue:
    """Bounded per-slot frame staging queues (host memory only).

    ``put`` returns ``False`` when a slot's queue is at depth — the
    caller's backpressure signal.  Enqueue timestamps (``obs.now_s``, the
    codebase's one wall clock) and a flow id ride along so the dispatcher
    can account queue wait per frame AND draw the enqueue→dispatch flow
    arrow in the trace.  The telemetry sink sees every depth change
    (``queue_depth`` gauge per slot — its ``hwm`` is the queue-depth
    high-water mark).

    Thread-safe: every mutation (``put``/``pop``/``fill``/``clear``/
    ``take``/``load``) and the ``ready`` check hold one internal lock, and
    the depth gauge updates ride inside it — the sched tier's ingest worker
    produces from its own thread while the dispatch thread consumes.
    """

    def __init__(self, slots: int, depth: int = 2,
                 telemetry: Optional[Telemetry] = None):
        if depth < 1:
            raise ValueError(f"queue depth must be >= 1, got {depth}")
        self.depth = depth
        self.tele = telemetry_or_off(telemetry)
        self._q: List[collections.deque] = [
            collections.deque() for _ in range(slots)]
        self._lock = threading.Lock()

    def _depth_changed(self, slot: int) -> None:
        n = len(self._q[slot])
        self.tele.gauge("queue_depth", n, slot=slot)
        self.tele.trace.counter(f"queue_depth/slot{slot}", depth=n)

    def put(self, slot: int, frame) -> bool:
        with self._lock:
            q = self._q[slot]
            if len(q) >= self.depth:
                return False
            fid = next(_FLOW_IDS)
            q.append((frame, now_s(), fid))
            self.tele.flow_start(fid, "frame")
            self._depth_changed(slot)
            return True

    def pop(self, slot: int):
        """Oldest queued ``(frame, waited_s, flow_id)`` for ``slot``."""
        with self._lock:
            frame, t0, fid = self._q[slot].popleft()
            self._depth_changed(slot)
        return frame, now_s() - t0, fid

    def fill(self, slot: int) -> int:
        with self._lock:
            return len(self._q[slot])

    def clear(self, slot: int) -> int:
        with self._lock:
            n = len(self._q[slot])
            self._q[slot].clear()
            if n:
                self._depth_changed(slot)
            return n

    def ready(self, slots) -> bool:
        """True when every listed slot has a frame queued — a lockstep
        batch can dispatch."""
        with self._lock:
            return all(self._q[s] for s in slots)

    def head_age_s(self, slot: int) -> Optional[float]:
        """Seconds the oldest queued frame of ``slot`` has been waiting
        (the scheduler policy's oldest-deadline signal), or None when
        empty."""
        with self._lock:
            q = self._q[slot]
            return (now_s() - q[0][1]) if q else None

    # -- migration support (the sched tier's queue transplant) -------------

    def take(self, slot: int) -> List[Tuple]:
        """Drain ``slot``'s raw entries — ``(frame, enqueue_ts, flow_id)``
        triples with their ORIGINAL timestamps and flow ids — so a row
        migration can transplant them into the destination pool's queue
        without dropping frames, resetting waits, or breaking trace
        arrows."""
        with self._lock:
            q = self._q[slot]
            entries = list(q)
            q.clear()
            if entries:
                self._depth_changed(slot)
            return entries

    def load(self, slot: int, entries: Sequence[Tuple]) -> None:
        """Requeue entries previously ``take``-n from a source queue, at
        the head-preserving order.  The destination slot must be empty and
        the batch must fit the depth bound (migrations move whole queues
        between equal-depth queues, so this never triggers in practice)."""
        if not entries:
            return
        with self._lock:
            q = self._q[slot]
            if q:
                raise ValueError(f"slot {slot} is not empty "
                                 f"({len(q)} frames); cannot load into it")
            if len(entries) > self.depth:
                raise ValueError(f"{len(entries)} entries exceed queue "
                                 f"depth {self.depth}")
            q.extend(entries)
            self._depth_changed(slot)


@dataclasses.dataclass
class ServeStats:
    """Host-observable serving pipeline counters (the device-side
    dispatch/sync counters live on ``ShardedPool.stats``)."""

    steps: int = 0                 # lockstep frame-steps dispatched
    frames_in: int = 0             # frames accepted by submit()
    frames_dropped: int = 0        # queued frames discarded by retire()
    admits: int = 0
    retires: int = 0
    backpressure_events: int = 0   # submits that hit a full queue
    queue_wait_s: float = 0.0      # total enqueue->dispatch latency
    stage_s: float = 0.0           # host time staging batches
    blank_row_steps: int = 0       # free slots stepped on blank frames
    blank_keyframes: int = 0       # ... and the keyframes they took (the
                                   # device-decided ones as of the last drain)

    @property
    def queue_wait_ms_per_frame(self) -> float:
        n = max(self.frames_in - self.frames_dropped, 1)
        return 1e3 * self.queue_wait_s / n


class SlamServer:
    """The queue-fed dispatcher over a :class:`ShardedPool`.

    Streams ``submit`` frames into bounded per-slot queues; ``pump``
    dispatches one lockstep frame-step whenever every live slot has a
    frame queued.  A tracking-only frame-step returns as soon as its graph
    replay is enqueued, so the host moves on to staging the next batch
    while the card computes; only :meth:`drain` (and a keyframe's reads)
    wait for the card.

    ``admit``/``retire`` are the admission tier: retire snapshots a row as
    a solo session and frees the slot (blank frames keep the lockstep
    shape; the row's leftover state is scratch), admit overwrites a free
    slot with a fresh session.  A full pool raises :class:`PoolFull`.

    ``telemetry`` (SlamScope) instruments the pump as spans (``stage``,
    ``dispatch``, ``drain``, ``admit``, ``retire``) with an
    enqueue→dispatch flow arrow per frame, and feeds the registry
    per-stream ``frame_latency_ms``/``queue_wait_ms`` histograms, the
    ``queue_depth`` gauges, and ``dispatches`` counters split by
    ``kind="step"`` vs ``kind="admin"``.  Everything rides host-side
    values the server already holds — telemetry on/off runs are
    bitwise-identical with exactly the same dispatch count
    (tests/test_torch_serve.py).
    """

    def __init__(self, pool: ShardedPool, queue_depth: int = 2,
                 live: Optional[Sequence[int]] = None,
                 telemetry: Optional[Telemetry] = None, name: str = ""):
        self.pool = pool
        self.name = name
        # Per-group label on the kind-split dispatch counters, so a ladder
        # of servers sharing one registry stays measurable per group.  A
        # nameless server keeps the unlabeled series.
        self._glab = {"group": name} if name else {}
        self.tele = telemetry_or_off(telemetry)
        self.queue = FrameQueue(pool.size, queue_depth, telemetry=self.tele)
        self.stats = ServeStats()
        self._live = [False] * pool.size
        for s in (range(pool.size) if live is None else live):
            self._live[s] = True
        # Telemetry stream label per slot — defaults to the slot index; the
        # sched tier relabels on admit so a stream's latency series
        # survives row migrations between pools.
        self._labels: List = list(range(pool.size))
        intr = pool.intr
        self._blank = tuple(_pinned(torch.zeros(shape, dtype=torch.float32),
                                    pool.device)
                            for shape in ((intr.height, intr.width, 3),
                                          (intr.height, intr.width)))
        self.last_result: Optional[StepResult] = None
        # Keyframes of free slots that the device decided, summed on the
        # device and folded into ``stats`` at the next drain's read.
        self._blank_keyframes_dev: Optional[torch.Tensor] = None

    # -- introspection -----------------------------------------------------

    def live_slots(self) -> List[int]:
        return [s for s, lv in enumerate(self._live) if lv]

    def free_slots(self) -> List[int]:
        return [s for s, lv in enumerate(self._live) if not lv]

    def slot_label(self, slot: int):
        """The telemetry ``stream=`` label of ``slot``."""
        return self._labels[slot]

    def label_slot(self, slot: int, label) -> None:
        """Relabel ``slot``'s telemetry stream series (sched tier: stream
        ids follow sessions across migrations; slots are transient)."""
        self._labels[slot] = label

    # -- ingest ------------------------------------------------------------

    def submit(self, slot: int, frame) -> None:
        """Queue one frame for ``slot``.  On a full queue, backpressure:
        pump (dispatching any ready lockstep batches) to make room; if the
        queue is still full — this stream is ahead of a starved peer —
        raise :class:`QueueFull`."""
        if not self._live[slot]:
            raise ValueError(f"slot {slot} is not live; admit a session "
                             "first")
        with self.tele.span("submit", slot=slot):
            if not self.queue.put(slot, frame):
                self.stats.backpressure_events += 1
                self.tele.count("backpressure", stream=self._labels[slot])
                self.pump()
                if not self.queue.put(slot, frame):
                    raise QueueFull(
                        f"slot {slot}'s queue is at depth "
                        f"{self.queue.depth} and no lockstep batch can "
                        "dispatch (a peer stream is starved); submit "
                        "frames for the other live slots")
            self.stats.frames_in += 1

    def offer(self, slot: int, frame) -> bool:
        """Non-blocking ingest: queue one frame for ``slot`` if its queue
        has room, else return ``False`` — and NEVER pump.  This is the
        producer-thread entry point (the sched tier's ingest worker calls
        it off the dispatch thread; dispatching from a producer thread
        would race the dispatcher), so unlike :meth:`submit` it must not
        launch device work under backpressure."""
        if not self._live[slot]:
            raise ValueError(f"slot {slot} is not live; admit a session "
                             "first")
        if not self.queue.put(slot, frame):
            self.stats.backpressure_events += 1
            self.tele.count("backpressure", stream=self._labels[slot])
            return False
        self.stats.frames_in += 1
        return True

    # -- dispatch ----------------------------------------------------------

    def pump(self) -> int:
        """Dispatch as many lockstep frame-steps as the queues allow.
        Returns the number of steps dispatched.

        Telemetry per step: a ``stage`` span (frame pops + the host→device
        copies) and a ``dispatch`` span (the step) with each popped frame's
        flow arrow ending inside it; per-frame ``queue_wait_ms`` and
        ``frame_latency_ms`` (enqueue→dispatch-return, the
        host-observable latency; device time is only knowable at
        :meth:`drain`) land in per-stream histograms."""
        live = self.live_slots()
        steps = 0
        while live and self.queue.ready(live):
            step_no = self.stats.steps
            sw = Stopwatch()
            rows, popped = [], []
            with self.tele.span("stage", step=step_no):
                for s in range(self.pool.size):
                    if self._live[s]:
                        frame, waited, fid = self.queue.pop(s)
                        self.stats.queue_wait_s += waited
                        self.tele.latency("queue_wait_ms", waited * 1e3,
                                          stream=self._labels[s])
                        popped.append((s, now_s() - waited, fid))
                        rows.append(frame)
                    else:
                        rows.append(self._blank)
                obs = self.pool.stage(rows)
            self.stats.stage_s += sw.elapsed()
            with self.tele.span("dispatch", step=step_no, **self._glab):
                for _, _, fid in popped:
                    self.tele.flow_end(fid, "frame")
                self.last_result = self.pool.step(obs)
            free = self.free_slots()
            self.stats.blank_row_steps += len(free)
            self._count_blank_keyframes(free)
            self.tele.count("dispatches", kind="step", **self._glab)
            t1 = now_s()
            for s, t_enq, _ in popped:
                self.tele.latency("frame_latency_ms", (t1 - t_enq) * 1e3,
                                  stream=self._labels[s])
            self.tele.latency("step_host_ms", sw.elapsed() * 1e3)
            self.stats.steps += 1
            steps += 1
        return steps

    def _count_blank_keyframes(self, free: List[int]) -> None:
        """Add the free slots' keyframes of the last step: host flags now,
        device flags (GS-SLAM, Photo-SLAM) on the device, without a read."""
        is_kf = self.last_result.is_kf
        if not isinstance(is_kf, torch.Tensor):
            self.stats.blank_keyframes += sum(is_kf[s] for s in free)
            return
        mask = constant([s in free for s in range(self.pool.size)], torch.bool,
                        is_kf.device)
        taken = (is_kf & mask).sum()
        self._blank_keyframes_dev = (taken if self._blank_keyframes_dev is None
                                     else self._blank_keyframes_dev + taken)

    def drain(self) -> None:
        """Pump the remaining ready batches, then block until the card has
        finished every step in flight; the same read folds the free slots'
        device-decided keyframes into ``stats.blank_keyframes``."""
        self.pump()
        with self.tele.span("drain"):
            if self.pool.device.type == "cuda":
                torch.cuda.synchronize(self.pool.device)
            if self._blank_keyframes_dev is not None:
                self.stats.blank_keyframes += int(self._blank_keyframes_dev)
                self._blank_keyframes_dev = None
        self.pool.stats.syncs += 1
        self.tele.count("syncs")

    # -- admission control -------------------------------------------------

    def admit(self, session: SlamSession, label=None) -> int:
        """Place ``session`` in the first free slot (one row swap) and mark
        it live.  Raises :class:`PoolFull` when every slot is serving — the
        admission backpressure signal.  ``label`` names the slot's
        telemetry stream series (default: the slot index)."""
        free = self.free_slots()
        if not free:
            raise PoolFull(
                f"all {self.pool.size} slots are live; retire a session "
                "first (admission backpressure)")
        slot = free[0]
        with self.tele.span("admit", slot=slot, **self._glab):
            self.pool.swap(slot, session)
        self.tele.count("dispatches", kind="admin", **self._glab)
        # A free slot's queue is empty in normal operation (retire clears
        # it and dead slots refuse submits), but any straggler frames a
        # caller managed to park there must not leak into the new stream —
        # drop and account them like retire does.
        self.stats.frames_dropped += self.queue.clear(slot)
        self._live[slot] = True
        self._labels[slot] = slot if label is None else label
        self.stats.admits += 1
        return slot

    def retire(self, slot: int) -> SlamSession:
        """Snapshot ``slot``'s row as a solo session and free the slot.
        Queued-but-undispatched frames for the slot are dropped (counted
        in ``stats.frames_dropped``; a migration that must NOT drop them
        ``queue.take``-s the entries first and ``load``-s them into the
        destination queue)."""
        if not self._live[slot]:
            raise ValueError(f"slot {slot} is not live")
        self.stats.frames_dropped += self.queue.clear(slot)
        self._live[slot] = False
        self.stats.retires += 1
        with self.tele.span("retire", slot=slot, **self._glab):
            row = self.pool.session(slot)
        return row

    def finalize(self, slot: int, gt_w2c=None, **kw) -> SLAMResult:
        """Drain and assemble ``slot``'s :class:`SLAMResult` (syncs)."""
        self.drain()
        return self.pool.finalize(slot, gt_w2c=gt_w2c, **kw)
