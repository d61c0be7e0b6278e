"""SlamScope tracing (the port's copy of ``repro/obs/trace.py``): the single wall-clock definition, span recording, and
Chrome-trace-event JSON export (loadable in Perfetto / ``chrome://tracing``).

Wall clock
----------
:func:`now_s` (``time.perf_counter``) is THE wall-clock of the codebase:
queue waits, server stage timing, benchmark timeit loops and trace
timestamps all read this one monotonic source, so every latency number in
a BENCH row and every span in a trace share a time base.

Tracing
-------
:class:`TraceRecorder` records complete-duration spans (``ph="X"``),
instants, counter tracks, and flow arrows (``ph="s"``/``"f"`` — the
enqueue→dispatch arrow of each served frame), then :meth:`~TraceRecorder.
export`-s them as Chrome trace-event JSON.  A disabled recorder costs one
attribute check per call — telemetry-off serving runs the identical code
path (tests/test_torch_serve.py holds the outputs bitwise-equal).

:meth:`TraceRecorder.device_trace` is an optional passthrough to
``torch.profiler.profile`` so a host-span trace can be correlated with a
device-side profile of the same run; it writes the profile's Chrome trace
to the given directory on exit.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import List, Optional

__all__ = ["now_s", "Stopwatch", "TraceRecorder"]

#: The one wall-clock definition (monotonic, sub-microsecond on CPython).
now_s = time.perf_counter


class Stopwatch:
    """Minimal elapsed-time helper over :func:`now_s` — the hoisted form of
    the hand-rolled ``t0 = time.monotonic(); ...; dt = ... - t0`` pattern."""

    __slots__ = ("t0",)

    def __init__(self):
        self.t0 = now_s()

    def elapsed(self) -> float:
        return now_s() - self.t0

    def lap(self) -> float:
        """Elapsed seconds since start (or last lap), then restart."""
        t1 = now_s()
        dt = t1 - self.t0
        self.t0 = t1
        return dt


_NULL_CM = contextlib.nullcontext()


class TraceRecorder:
    """Append-only trace-event buffer with Chrome trace-event JSON export.

    Timestamps are microseconds since the recorder's construction, all read
    from :func:`now_s`.  Spans on one ``tid`` nest by containment (the
    Chrome trace rule), so nested ``with`` blocks render as nested slices.
    """

    def __init__(self, enabled: bool = True, process: str = "slamscope"):
        self.enabled = enabled
        self.process = process
        self.epoch = now_s()
        self.events: List[dict] = []

    # -- primitives --------------------------------------------------------

    def _ts(self, t: Optional[float] = None) -> float:
        return ((now_s() if t is None else t) - self.epoch) * 1e6

    def span(self, name: str, tid: int = 0, **args):
        """Context manager recording one complete-duration slice."""
        if not self.enabled:
            return _NULL_CM
        return self._span(name, tid, args)

    @contextlib.contextmanager
    def _span(self, name, tid, args):
        t0 = now_s()
        try:
            yield self
        finally:
            self.events.append({
                "ph": "X", "name": name, "pid": 0, "tid": tid,
                "ts": self._ts(t0), "dur": (now_s() - t0) * 1e6,
                **({"args": args} if args else {})})

    def instant(self, name: str, tid: int = 0, **args) -> None:
        if not self.enabled:
            return
        self.events.append({
            "ph": "i", "s": "t", "name": name, "pid": 0, "tid": tid,
            "ts": self._ts(), **({"args": args} if args else {})})

    def counter(self, name: str, **values) -> None:
        """One sample on a counter track (queue depth over time)."""
        if not self.enabled:
            return
        self.events.append({"ph": "C", "name": name, "pid": 0,
                            "ts": self._ts(), "args": values})

    def flow_start(self, flow_id: int, name: str, tid: int = 0) -> None:
        """Open a flow arrow (must fall inside a span on ``tid``)."""
        if not self.enabled:
            return
        self.events.append({"ph": "s", "name": name, "id": flow_id,
                            "cat": name, "pid": 0, "tid": tid,
                            "ts": self._ts()})

    def flow_end(self, flow_id: int, name: str, tid: int = 0) -> None:
        """Close a flow arrow (binds to the enclosing span on ``tid``)."""
        if not self.enabled:
            return
        self.events.append({"ph": "f", "bp": "e", "name": name,
                            "id": flow_id, "cat": name, "pid": 0,
                            "tid": tid, "ts": self._ts()})

    # -- device-side correlation ------------------------------------------

    def device_trace(self, logdir: Optional[str]):
        """Context manager wrapping ``torch.profiler.profile`` (CPU and, where
        a card is present, CUDA activities) when a logdir is given; the
        profile's Chrome trace lands in ``logdir/device_trace.json`` on
        exit.  Otherwise a no-op.  Lets one run produce both a host-span
        trace (this recorder) and a device-side profile over the same
        wall-clock window."""
        if not (self.enabled and logdir):
            return _NULL_CM
        return self._device_trace(logdir)

    @contextlib.contextmanager
    def _device_trace(self, logdir: str):
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        os.makedirs(logdir, exist_ok=True)
        with profile(activities=acts) as prof:
            yield prof
        prof.export_chrome_trace(os.path.join(logdir, "device_trace.json"))

    # -- export ------------------------------------------------------------

    def thread_name(self, tid: int, name: str) -> None:
        if not self.enabled:
            return
        self.events.append({"ph": "M", "name": "thread_name", "pid": 0,
                            "tid": tid, "args": {"name": name}})

    def trace_events(self) -> List[dict]:
        meta = [{"ph": "M", "name": "process_name", "pid": 0,
                 "args": {"name": self.process}}]
        return meta + sorted(self.events,
                             key=lambda e: e.get("ts", -1.0))

    def export(self, path: str) -> str:
        """Write ``{"traceEvents": [...]}`` JSON; returns ``path``.  Open
        the file at https://ui.perfetto.dev or ``chrome://tracing``."""
        with open(path, "w") as fh:
            json.dump({"traceEvents": self.trace_events(),
                       "displayTimeUnit": "ms"}, fh)
        return path
