"""SlamScope metrics registry (the port's copy of
``repro/obs/registry.py``): counters, gauges, and log-bucketed latency
histograms — the host-side half of the telemetry subsystem.

Design constraints (the same reuse discipline as the WSU scheduler):

* **Zero device cost.**  Every instrument is plain host Python over values
  the pipeline already has on host — a fetched ``DeviceWork`` snapshot, a
  wall-clock stamp, a queue length.  Nothing here touches the device.

* **Mergeable.**  Histograms with equal bucketing merge exactly
  (bucket-count addition), so S per-stream latency series fold into one
  pool aggregate, and per-device registries fold into one host view
  (:meth:`MetricsRegistry.merged_histogram`, :meth:`MetricsRegistry.merge`).

* **Bounded-error quantiles.**  :class:`Histogram` buckets are geometric
  with growth factor ``g`` (bucket ``i`` covers ``[g**i, g**(i+1))``), so a
  quantile estimate — the geometric midpoint of the bucket holding the
  rank — is within a relative factor ``sqrt(g)`` of the numpy-sorted
  oracle, and exact at the observed min/max (tests/test_torch_obs.py checks both
  against random samples).  The default ``g = 1.04`` bounds quantile error
  at ~2%.

Instruments are keyed by ``(name, labels)``: ``registry.histogram(
"frame_latency_ms", stream=3)`` yields stream 3's series; the pool
aggregate is ``registry.merged_histogram("frame_latency_ms")``.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry"]

_DEFAULT_GROWTH = 1.04


class Counter:
    """A monotonically increasing count (int or float)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n=1) -> None:
        self.value += n

    def snapshot(self):
        return self.value


class Gauge:
    """A last-value instrument that also tracks its high-water mark —
    ``set`` records the current level, ``hwm`` remembers the peak (queue
    depth high-water marks are gauges)."""

    __slots__ = ("value", "hwm")

    def __init__(self):
        self.value = 0
        self.hwm = 0

    def set(self, v) -> None:
        self.value = v
        if v > self.hwm:
            self.hwm = v

    def snapshot(self):
        return {"value": self.value, "hwm": self.hwm}


class Histogram:
    """Log-bucketed histogram with bounded-relative-error quantiles.

    Values ``v > 0`` land in bucket ``floor(log(v)/log(growth))``; values
    ``<= 0`` are counted in a dedicated zero bucket (latencies of exactly
    0.0 happen on coarse clocks).  Sum/min/max are tracked exactly.
    Two histograms with the same ``growth`` merge exactly.
    """

    __slots__ = ("growth", "_log_g", "buckets", "zeros", "count", "sum",
                 "min", "max")

    def __init__(self, growth: float = _DEFAULT_GROWTH):
        if growth <= 1.0:
            raise ValueError(f"histogram growth must be > 1.0, got {growth}")
        self.growth = growth
        self._log_g = math.log(growth)
        self.buckets: Dict[int, int] = {}
        self.zeros = 0
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    # -- recording ---------------------------------------------------------

    def record(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        if v <= 0.0:
            self.zeros += 1
            return
        ix = math.floor(math.log(v) / self._log_g)
        self.buckets[ix] = self.buckets.get(ix, 0) + 1

    # -- reading -----------------------------------------------------------

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        """Estimate the ``q``-quantile (``0 <= q <= 1``): the geometric
        midpoint of the bucket containing rank ``q * (count - 1)``, clamped
        to the exact observed [min, max]."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        if self.count == 0:
            return 0.0
        rank = q * (self.count - 1)
        seen = self.zeros
        if rank < seen:                      # inside the <= 0 bucket
            return min(self.min, 0.0)
        est = self.max
        for ix in sorted(self.buckets):
            seen += self.buckets[ix]
            if rank < seen:
                est = self.growth ** (ix + 0.5)   # geometric bucket mid
                break
        return min(max(est, self.min), self.max)

    def percentiles(self, qs: Iterable[float] = (0.5, 0.9, 0.99)
                    ) -> Dict[str, float]:
        return {f"p{round(q * 100):d}": self.quantile(q) for q in qs}

    # -- merging -----------------------------------------------------------

    def merge(self, other: "Histogram") -> "Histogram":
        """Fold ``other`` into self (exact: bucket-count addition).  Both
        histograms must share one bucketing."""
        if abs(other.growth - self.growth) > 1e-12:
            raise ValueError(
                f"cannot merge histograms with different bucketing "
                f"(growth {self.growth} vs {other.growth})")
        for ix, n in other.buckets.items():
            self.buckets[ix] = self.buckets.get(ix, 0) + n
        self.zeros += other.zeros
        self.count += other.count
        self.sum += other.sum
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)
        return self

    def snapshot(self) -> Dict[str, float]:
        if self.count == 0:
            return {"count": 0}
        out = {"count": self.count, "mean": self.mean,
               "min": self.min, "max": self.max}
        out.update(self.percentiles())
        return out


def _label_key(labels: dict) -> Tuple:
    return tuple(sorted(labels.items()))


class MetricsRegistry:
    """Host-side instrument table keyed by ``(name, labels)``.

    ``counter``/``gauge``/``histogram`` are get-or-create; per-stream
    series come from labeling (``stream=slot``), and pool aggregates from
    :meth:`merged_histogram` / :meth:`sum_counters`.

    Instrument *creation* is lock-guarded so a producer thread (the sched
    tier's ingest worker) and the dispatch thread get-or-creating the same
    key never orphan an instrument.  Recording into one series stays
    single-writer by convention — each series is owned by exactly one
    thread (queue-side series ride the FrameQueue lock; dispatch-side
    series are only touched by the dispatch thread).
    """

    def __init__(self):
        self._instruments: Dict[Tuple[str, str, Tuple], object] = {}
        self._create_lock = threading.Lock()

    def _get(self, kind: str, name: str, labels: dict, factory):
        key = (kind, name, _label_key(labels))
        inst = self._instruments.get(key)
        if inst is None:
            with self._create_lock:
                inst = self._instruments.get(key)
                if inst is None:
                    inst = self._instruments[key] = factory()
        return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", name, labels, Counter)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", name, labels, Gauge)

    def histogram(self, name: str, growth: float = _DEFAULT_GROWTH,
                  **labels) -> Histogram:
        return self._get("histogram", name, labels,
                         lambda: Histogram(growth))

    # -- cross-series reads ------------------------------------------------

    def series(self, name: str, kind: Optional[str] = None
               ) -> List[Tuple[dict, object]]:
        """Every ``(labels, instrument)`` pair registered under ``name``."""
        out = []
        for (k, n, lk), inst in sorted(self._instruments.items(),
                                       key=lambda kv: repr(kv[0])):
            if n == name and (kind is None or k == kind):
                out.append((dict(lk), inst))
        return out

    def merged_histogram(self, name: str, **match) -> Histogram:
        """One histogram folding every series of ``name`` whose labels
        include ``match`` — the S-stream pool aggregate."""
        merged: Optional[Histogram] = None
        for labels, h in self.series(name, kind="histogram"):
            if any(labels.get(k) != v for k, v in match.items()):
                continue
            if merged is None:
                merged = Histogram(h.growth)
            merged.merge(h)
        return merged if merged is not None else Histogram()

    def sum_counters(self, name: str, **match):
        """Sum of every counter series of ``name`` matching ``match``."""
        total = 0
        for labels, c in self.series(name, kind="counter"):
            if any(labels.get(k) != v for k, v in match.items()):
                continue
            total += c.value
        return total

    def max_gauge_hwm(self, name: str, **match):
        """Max high-water mark across every gauge series of ``name``."""
        hwm = 0
        for labels, g in self.series(name, kind="gauge"):
            if any(labels.get(k) != v for k, v in match.items()):
                continue
            hwm = max(hwm, g.hwm)
        return hwm

    def merge(self, other: "MetricsRegistry") -> "MetricsRegistry":
        """Fold another registry (e.g. a per-device worker's) into self."""
        for (kind, name, lk), inst in other._instruments.items():
            if kind == "counter":
                self._get(kind, name, dict(lk), Counter).inc(inst.value)
            elif kind == "gauge":
                g = self._get(kind, name, dict(lk), Gauge)
                g.set(inst.value)
                g.hwm = max(g.hwm, inst.hwm)
            else:
                self._get(kind, name, dict(lk),
                          lambda i=inst: Histogram(i.growth)).merge(inst)
        return self

    def snapshot(self) -> dict:
        """Plain-dict dump of every instrument — the shape BENCH rows and
        JSON exports consume.  Keys are ``name{k=v,...}``."""
        out = {}
        for (kind, name, lk), inst in sorted(self._instruments.items(),
                                             key=lambda kv: repr(kv[0])):
            tag = name if not lk else (
                name + "{" + ",".join(f"{k}={v}" for k, v in lk) + "}")
            out[tag] = inst.snapshot()
        return out
