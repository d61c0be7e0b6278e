"""IngestWorker — the producer thread feeding the scheduler's queues (the
port's copy of ``repro/slam/sched/ingest.py``).

v1's serving loop decoded and submitted frames on the SAME thread that
dispatches device work, so host-side decode time subtracted directly from
dispatch throughput.  The ingest worker moves decode/staging off the
dispatch thread: it round-robins its streams, decodes the next frame of
each (``decode`` runs HERE, on the producer thread), rate-limits per
stream (``period_s`` models camera frame rates), and hands frames over
with the scheduler's non-blocking :meth:`~SlamScheduler.offer` — a full
queue or a not-yet-placed stream just means "retry next pass", never a
device dispatch from this thread.  When a stream's source iterator is
exhausted the worker :meth:`~SlamScheduler.close`-s it, which is what
lets the scheduler auto-retire the stream and hand its slot to a waiting
admission.

Thread safety comes from the tiers below: ``offer`` takes the scheduler
lock (so it serializes against migrations) and the FrameQueue locks its
own mutations.  The worker never touches the card: its decode makes
page-locked host tensors, and only the dispatch thread copies them to the
device.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Mapping, Optional

import torch

from repro_torch.obs import now_s

__all__ = ["IngestWorker", "default_decode"]


def default_decode(frame):
    """Stage one raw frame into the dispatcher's expected form: a
    contiguous float32 ``(rgb, depth)`` pair of CPU tensors, page-locked
    where a CUDA device is present, so the dispatcher's copy to the card
    is asynchronous.  Accepts either that
    pair (host arrays or tensors) or any object with ``.rgb``/``.depth``
    attributes."""
    if hasattr(frame, "rgb"):
        rgb, depth = frame.rgb, frame.depth
    else:
        rgb, depth = frame
    pin = torch.cuda.is_available()
    out = []
    for x in (rgb, depth):
        t = torch.as_tensor(x).to("cpu", torch.float32).contiguous()
        out.append(t.pin_memory() if pin else t)
    return tuple(out)


class IngestWorker(threading.Thread):
    """Decode/stage frames into the scheduler from a producer thread.

    ``sources`` maps stream id → iterable of raw frames; ``period_s`` maps
    stream id → minimum seconds between offered frames (missing = as fast
    as backpressure allows).  ``done`` is set when every source is
    exhausted and closed (or on :meth:`stop`); a producer-side exception
    lands in ``error`` and is re-raised by ``SlamScheduler.serve``.
    """

    def __init__(self, scheduler, sources: Mapping,
                 period_s: Optional[Mapping] = None,
                 decode: Callable = default_decode,
                 idle_sleep_s: float = 1e-3, name: str = "slam-ingest"):
        super().__init__(name=name, daemon=True)
        self.scheduler = scheduler
        self._iters = {sid: iter(src) for sid, src in sources.items()}
        self._period = dict(period_s or {})
        self._decode = decode
        self._idle_sleep_s = idle_sleep_s
        self._halt = threading.Event()
        self.done = threading.Event()
        self.error: Optional[BaseException] = None
        self.offered = 0            # frames accepted by the scheduler
        self.rejected = 0           # offers bounced (backpressure/waiting)

    def run(self) -> None:
        pending: Dict = {sid: None for sid in self._iters}
        due: Dict = {sid: 0.0 for sid in self._iters}
        active = set(self._iters)
        try:
            while active and not self._halt.is_set():
                progressed = False
                for sid in list(active):
                    if pending[sid] is None:
                        try:
                            raw = next(self._iters[sid])
                        except StopIteration:
                            # Every frame of sid was ACCEPTED (pending is
                            # clear) — safe to promise "no more".
                            self.scheduler.close(sid)
                            active.discard(sid)
                            progressed = True
                            continue
                        pending[sid] = self._decode(raw)
                    if now_s() < due[sid]:
                        continue
                    if self.scheduler.offer(sid, pending[sid]):
                        pending[sid] = None
                        due[sid] = now_s() + self._period.get(sid, 0.0)
                        self.offered += 1
                        progressed = True
                    else:
                        self.rejected += 1
                if not progressed:
                    time.sleep(self._idle_sleep_s)
        except BaseException as e:     # surface to the dispatch thread
            self.error = e
        finally:
            self.done.set()

    def stop(self, timeout_s: float = 10.0) -> None:
        """Ask the worker to exit and join it."""
        self._halt.set()
        self.join(timeout=timeout_s)
