"""SlamScope's sink protocol (the port's copy of ``repro/obs/hooks.py``):
the one object threaded through the server and the scheduler.

A :class:`Telemetry` bundles a :class:`~repro_torch.obs.registry.MetricsRegistry`
and a :class:`~repro_torch.obs.trace.TraceRecorder` behind tiny guard-checked
methods, so instrumented code reads as ``tele.latency("frame_latency_ms",
ms, stream=slot)`` with a disabled sink costing one attribute check and no
allocation.  The discipline instrumented code must keep (and
tests/test_torch_serve.py enforces): **telemetry only consumes values the host
already has** — a wall-clock stamp, a queue length, a ``DeviceWork``
snapshot some existing code path already fetched.  No sink method may
make a device fetch or a dispatch; with telemetry on, session/server
outputs stay bitwise-identical and the dispatch count stays the
same.

Conventions (shared by the server and the scheduler):

* ``frame_latency_ms``   histogram, per-``stream`` — submit→dispatch-return
  for served frames, host step wall for solo loops.
* ``queue_wait_ms``      histogram, per-``stream`` — enqueue→dispatch wait.
* ``queue_depth``        gauge, per-``slot`` — ``hwm`` is the high-water mark.
* ``dispatches``         counter, ``kind="step"`` (frame-steps) vs
  ``kind="admin"`` (admit/retire row swaps) — the two must never share a
  series, or the dispatches-per-frame-step count becomes unmeasurable.
* ``work/<field>``       counter, per-``stream`` — fragments, pixels, … from
  fetched work snapshots.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.obs.registry import Histogram, MetricsRegistry
from repro_torch.obs.trace import TraceRecorder, _NULL_CM

__all__ = ["Telemetry", "TELEMETRY_OFF", "telemetry_or_off",
           "latency_summary"]


class Telemetry:
    """Registry + trace behind no-op-cheap guard methods."""

    __slots__ = ("enabled", "registry", "trace")

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 trace: Optional[TraceRecorder] = None, *,
                 enabled: bool = True):
        self.enabled = enabled
        self.registry = registry if registry is not None else MetricsRegistry()
        self.trace = (trace if trace is not None
                      else TraceRecorder(enabled=enabled))

    @classmethod
    def on(cls, trace: bool = True) -> "Telemetry":
        """A live sink (the usual entry point): fresh registry, trace
        recording on/off per ``trace``."""
        return cls(trace=TraceRecorder(enabled=trace))

    # -- metrics -----------------------------------------------------------

    def count(self, name: str, n=1, **labels) -> None:
        if self.enabled:
            self.registry.counter(name, **labels).inc(n)

    def gauge(self, name: str, v, **labels) -> None:
        if self.enabled:
            self.registry.gauge(name, **labels).set(v)

    def latency(self, name: str, ms: float, **labels) -> None:
        if self.enabled:
            self.registry.histogram(name, **labels).record(ms)

    def work(self, stream, w) -> None:
        """Fold a host-side work snapshot (``DeviceWork`` already fetched,
        or a ``WorkCounters``) into per-stream ``work/<field>`` counters.
        Call ONLY with values an existing code path fetched — never fetch
        for telemetry's sake."""
        if not self.enabled:
            return
        if hasattr(w, "_fields"):                       # NamedTuple
            items = zip(w._fields, w)
        else:                                           # dataclass
            items = dataclasses.asdict(w).items()
        for field, v in items:
            self.registry.counter(f"work/{field}", stream=stream).inc(int(v))

    def result(self, stream, res) -> None:
        """Fold a finalized ``SLAMResult``: work counters plus the run's
        dispatch/sync totals (labeled per stream)."""
        if not self.enabled:
            return
        self.work(stream, res.work)
        self.registry.counter("dispatches", kind="step",
                              stream=stream).inc(res.dispatches)
        self.registry.counter("syncs", stream=stream).inc(res.syncs)

    # -- tracing -----------------------------------------------------------

    def span(self, name: str, tid: int = 0, **args):
        if not self.enabled:
            return _NULL_CM
        return self.trace.span(name, tid=tid, **args)

    def flow_start(self, flow_id: int, name: str, tid: int = 0) -> None:
        if self.enabled:
            self.trace.flow_start(flow_id, name, tid=tid)

    def flow_end(self, flow_id: int, name: str, tid: int = 0) -> None:
        if self.enabled:
            self.trace.flow_end(flow_id, name, tid=tid)

    def export_trace(self, path: Optional[str]) -> Optional[str]:
        """Write the Chrome trace JSON if tracing ran and ``path`` is set."""
        if path and self.enabled and self.trace.enabled:
            return self.trace.export(path)
        return None


#: The disabled singleton: every method is a guard-check no-op.  Code takes
#: ``telemetry: Optional[Telemetry] = None`` and normalizes with
#: :func:`telemetry_or_off` so the instrumented path is the only path.
TELEMETRY_OFF = Telemetry(enabled=False,
                          trace=TraceRecorder(enabled=False))


def telemetry_or_off(telemetry: Optional[Telemetry]) -> Telemetry:
    return telemetry if telemetry is not None else TELEMETRY_OFF


def latency_summary(registry: MetricsRegistry,
                    name: str = "frame_latency_ms", **match) -> dict:
    """The BENCH-row latency fields: p50/p90/p99/mean/count of the merged
    (pool-aggregate) histogram ``name``, rounded for JSON."""
    h: Histogram = registry.merged_histogram(name, **match)
    if h.count == 0:
        return {"count": 0}
    return {
        "count": h.count,
        "p50_ms": round(h.quantile(0.50), 4),
        "p90_ms": round(h.quantile(0.90), 4),
        "p99_ms": round(h.quantile(0.99), 4),
        "mean_ms": round(h.mean, 4),
        "max_ms": round(h.max, 4),
    }
