"""The port's SlamScope copy (``repro_torch/obs``) against the reference's
(``repro/obs``) on the same seeded data: histogram quantiles and their
error bound, exact merges, the registry's labelled series and snapshots,
latency summaries, and the trace events and their Chrome-trace export.
The port's ``device_trace`` wraps ``torch.profiler``.
"""

import json

import numpy as np
import pytest

from _torch_parity import one_cpu_thread  # noqa: F401  (autouse fixture)
from repro import obs as jobs
from repro_torch import obs as tobs


def _latencies(seed=0):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.lognormal(1.0, 0.7, 5000),
                           rng.lognormal(3.0, 0.3, 250)])


@pytest.mark.parametrize("growth", [1.04, 1.2])
def test_histogram_quantiles_match_the_reference(growth):
    data = _latencies()
    h_t, h_j = tobs.Histogram(growth), jobs.Histogram(growth)
    for v in data:
        h_t.record(v)
        h_j.record(v)
    qs = (0.0, 0.1, 0.5, 0.9, 0.99, 1.0)
    assert [h_t.quantile(q) for q in qs] == [h_j.quantile(q) for q in qs]
    assert h_t.snapshot() == h_j.snapshot()
    tol = np.sqrt(h_t.growth)
    for q in (0.5, 0.9, 0.99):
        oracle = float(np.quantile(data, q))
        assert oracle / tol <= h_t.quantile(q) <= oracle * tol
    assert h_t.quantile(0.0) == data.min() and h_t.quantile(1.0) == data.max()
    with pytest.raises(ValueError, match="quantile"):
        h_t.quantile(1.5)


def test_histogram_merges_are_exact_and_match():
    out = []
    for mod in (tobs, jobs):
        a, b = mod.Histogram(), mod.Histogram()
        for v in (0.0, -1.0, 2.0, 4.0):
            a.record(v)
        for v in _latencies(1)[:300]:
            b.record(v)
        merged = mod.Histogram().merge(a).merge(b)
        whole = mod.Histogram()
        for v in (0.0, -1.0, 2.0, 4.0, *_latencies(1)[:300]):
            whole.record(v)
        assert merged.buckets == whole.buckets and merged.count == whole.count
        assert merged.zeros == whole.zeros == 2
        with pytest.raises(ValueError, match="bucketing"):
            mod.Histogram(growth=1.5).merge(a)
        out.append((merged.snapshot(), merged.quantile(0.0), sorted(merged.buckets.items())))
    assert out[0] == out[1]


def _registry_run(mod):
    reg = mod.MetricsRegistry()
    data = _latencies(2)
    for s in range(3):
        for v in data[s::3][:500]:
            reg.histogram("frame_latency_ms", stream=s).record(v * (s + 1))
    reg.counter("dispatches", kind="step").inc(7)
    reg.counter("dispatches", kind="admin").inc(2)
    for v in (2, 1, 3):
        reg.gauge("queue_depth", slot=0).set(v)
    other = mod.MetricsRegistry()
    other.counter("dispatches", kind="step").inc(3)
    other.histogram("frame_latency_ms", stream=0).record(64.0)
    other.gauge("queue_depth", slot=1).set(5)
    reg.merge(other)
    return (reg.snapshot(), mod.latency_summary(reg),
            mod.latency_summary(reg, stream=1),
            reg.sum_counters("dispatches"), reg.sum_counters("dispatches", kind="step"),
            reg.max_gauge_hwm("queue_depth"),
            mod.latency_summary(mod.MetricsRegistry()))


def test_registry_series_merges_and_summaries_match():
    port, ref = _registry_run(tobs), _registry_run(jobs)
    assert port == ref
    assert port[3] == 12 and port[4] == 10 and port[5] == 5
    assert port[1]["count"] == 1501 and port[6] == {"count": 0}


def _trace_run(mod, path):
    """A recorder driven through every event kind, with the timestamps
    taken out (they are wall-clock readings)."""
    tele = mod.Telemetry.on(trace=True)
    tr = tele.trace
    tr.thread_name(1, "ingest")
    with tele.span("dispatch", step=0, group="S2"):
        tele.flow_end(3, "frame")
        with tele.span("stage", tid=1):
            tr.instant("tick", n=1)
    tele.flow_start(4, "frame")
    tr.counter("queue_depth/slot0", depth=2)
    tele.count("dispatches", kind="step")
    tele.latency("frame_latency_ms", 12.5, stream="a")
    off = mod.Telemetry(enabled=False)
    off.count("dispatches")
    with off.span("nothing"):
        pass
    tele.export_trace(str(path))
    events = [{k: v for k, v in e.items() if k not in ("ts", "dur")}
              for e in json.loads(path.read_text())["traceEvents"]]
    spans = [e for e in tr.events if e["ph"] == "X"]
    nested = spans[0]["ts"] >= spans[1]["ts"] and (
        spans[0]["ts"] + spans[0]["dur"] <= spans[1]["ts"] + spans[1]["dur"])
    return events, nested, tele.registry.snapshot(), off.registry.snapshot()


def test_trace_events_and_export_match(tmp_path):
    port = _trace_run(tobs, tmp_path / "port.json")
    ref = _trace_run(jobs, tmp_path / "ref.json")
    assert port == ref
    events, nested, _, off = port
    assert nested and off == {}
    assert [e["ph"] for e in events][:2] == ["M", "M"]
    assert {e["ph"] for e in events} == {"M", "X", "f", "i", "s", "C"}


def test_device_trace_wraps_the_torch_profiler(tmp_path):
    import torch

    tr = tobs.TraceRecorder()
    with tr.device_trace(str(tmp_path / "prof")):
        torch.ones(8).sum()
    trace = json.loads((tmp_path / "prof" / "device_trace.json").read_text())
    assert any("aten::" in e.get("name", "") for e in trace["traceEvents"])
    off = tobs.TraceRecorder(enabled=False)
    with off.device_trace(str(tmp_path / "none")):
        pass
    with tr.device_trace(None):
        pass
    assert not (tmp_path / "none").exists()
    sw = tobs.Stopwatch()
    assert sw.elapsed() >= 0.0 and sw.lap() >= 0.0 and tobs.now_s() > 0.0
