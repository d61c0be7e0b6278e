"""SlamScope, the port's own copy (counterpart of ``repro/obs``): the
host-side telemetry of the serving tier.

Three layers (see each module's docstring):

* :mod:`repro_torch.obs.registry` — counters, gauges, log-bucketed latency
  histograms (mergeable, per-stream labels).
* :mod:`repro_torch.obs.trace` — the single wall-clock definition
  (:func:`now_s`/:class:`Stopwatch`) and span tracing with Perfetto-loadable
  Chrome-trace-event JSON export; ``device_trace`` wraps
  ``torch.profiler``.
* :mod:`repro_torch.obs.hooks` — the :class:`Telemetry` sink protocol
  threaded through the server and the scheduler.

The load-bearing invariant: telemetry rides data the host already has
(wall-clock stamps, queue lengths, already-fetched work counters), so a
telemetry-on run is bitwise-identical to a telemetry-off run and the
serving tier keeps exactly the same dispatch count
(tests/test_torch_serve.py).
"""

from repro_torch.obs.hooks import (
    TELEMETRY_OFF,
    Telemetry,
    latency_summary,
    telemetry_or_off,
)
from repro_torch.obs.registry import Counter, Gauge, Histogram, MetricsRegistry
from repro_torch.obs.trace import Stopwatch, TraceRecorder, now_s

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "Stopwatch",
    "TELEMETRY_OFF",
    "Telemetry",
    "TraceRecorder",
    "latency_summary",
    "now_s",
    "telemetry_or_off",
]
