"""Phase segments replayed as CUDA graphs: the fused step engine's dispatch
layer (counterpart of the reference's one ``lax.scan`` dispatch per
tracking phase and per mapping phase, ``repro/slam/engine.py``).

A *segment* is a function over a dict of fixed-shape tensors that runs one
or more iterations of a phase and returns a dict of tensors.  The
:class:`PhaseRunner` of a session runs each segment in one of three ways:

* ``fused`` on a CUDA session: the segment is captured once as a CUDA
  graph (``torch.cuda.CUDAGraph``), keyed by the caller's key and the
  inputs' names, shapes and dtypes, after one warm-up run on a side stream
  that makes every lazily built buffer (cuBLAS workspaces, K3's arrival
  counters, K4/K5's fault word) before capture; every later run replays it.
  All of a runner's graphs share one memory pool.  A failed capture or
  replay raises: nothing falls back to eager.
* ``fused`` on a CPU session: the same function runs directly, through the
  same static buffers, with no capture, so the CPU tests exercise the
  copies and the aliasing rules below.
* not ``fused`` (``SLAMConfig(fused=False)``, the oracle): the function runs
  eagerly on the caller's tensors.

Conditional segments (:meth:`PhaseRunner.run_when`), the counterpart of
the reference's ``lax.cond``: S one-row bodies, row ``s``'s under its own
flag, a host ``bool`` or a () bool tensor that the segment computes on the
device.  Fused on the card, each body is captured under a CUDA graph
conditional IF node (``csrc/graph_cond.cu``: PyTorch 2.11 has no binding
for them) on a stream of the bodies' own, with its allocations routed
into a pool of the bodies' own, so one replay runs or skips each body
without a read;
on the CPU, the same function runs under ``if bool(flag)``; eager, the
flags are read.  A body writes its ``carry`` outputs into the inputs of
the same name, so a skipped body leaves the state as it was, and its
per-step outputs over defaults written before its node.  A segment may
also run bodies under device flags anywhere inside its own loop
(:meth:`PhaseRunner.run` with ``conditional``: the segment gets a
``when(flag, body)``, the counterpart of a ``lax.cond`` inside a
``lax.scan`` body, which §4.1's pruning boundary is): each body is
captured under an IF node of its own and writes in place into buffers
made before it.

Static buffers and aliasing.  The runner owns each segment's input buffers:
:meth:`PhaseRunner.run` copies the caller's tensors in with ``copy_``.
Outputs named in ``carry`` are written back into the input of the same
name at the end of every run (inside the graph), so a segment replayed
``times`` times carries its state (pose, Adam moments, counters) from one
run to the next without leaving the device; the other outputs are cloned
out after every run and the carried ones once at the end.  Nothing a
caller gets back aliases graph memory that a later replay overwrites.

Launch counters.  The kernel wrappers' ``launches`` counters are Python
integers that only run when a kernel is launched from Python, which under
a graph happens once, at capture.  The runner takes each counter's delta
over the capture and adds it again on every replay (the warm-up's launches
are taken back), so the counters stay exact through replays.  A
conditional body's delta is added at a replay where the host knows its
flag; where the device decides, the body counts its runs in a device
tensor, which :meth:`PhaseRunner.fold_launches` (one read) or
``session_finalize``'s integer read folds into the counters.

Units of :class:`EngineStats` (the reference's ``engine.py:96-110``):

* **dispatch** — one graph replay (one run of a segment when fused, also
  on the CPU); when not fused, each eager host call that one run of a
  segment stands for (its iterations and the phase cores it calls: each
  fragment-list build, schedule build and forward render, densification),
  and those of each conditional body that runs (a fired §4.1 boundary:
  its rebuild, ``interval_update`` and, on ``schedule``, its schedule);
* **sync** — one device-to-host read: under §4.2 Photo-SLAM's host
  factor choice and the read of a device keyframe flag
  (``session.run_sequence``), an eager (not fused) run's read of a
  device flag (GS-SLAM's and Photo-SLAM's keyframe decision; §4.1's
  boundary check, once per tracking iteration, as the reference's
  unfused loop reads it), the seed map's two frame reads and finalize's
  reads.  Neither a fragment-list build (``core/sorting.py``), a pruning
  boundary, densification nor a keyframe decision reads anything back;
* **replay** — one CUDA graph replay (0 on the CPU);
* **capture** — one segment captured as a CUDA graph (its warm-up run and
  its capture: a session's first use of a phase at a factor and shape).

The reference counts 1 dispatch and no sync per frame, because its whole
step is one XLA program, its keyframe mapping under ``lax.cond``.  Here a
MonoGS or SplaTAM tracking-only frame counts 1 dispatch (the tracking
replay, the frame's fragment-list build inside it) and no sync, and a
keyframe 2 dispatches, no sync and 2 replays: tracking, then the keyframe
segment (the eval render, densification, the ring pushes, the window
builds, the iterations with their stride rebuilds, the PSNR and the
serving-cache build; ``session._keyframe_segment``).  GS-SLAM and
Photo-SLAM count 2 / 0 / 2 on every frame: their decision is computed
inside the keyframe graph, ahead of the conditional node it gates, so a
tracking-only frame replays the keyframe graph with its body skipped.
(The pose inverse and velocity between the two replays are launches, not
syncs; folding both replays into one would need that inverse inside a
graph with the same bits.)  ``session_init``'s bootstrap mapping is one
replay too.  When not fused a keyframe's mapping counts ``2 +
(W + iters_map // stride) * (1 + scheduled) + iters_map + 2`` (``W`` the
window; ``W + scheduled + 1`` more under sparse mapping), the same kernels
in the same order.  RTGS (§4.1 pruning) counts the same fused: its
tracking phase, the frame's build, the K iterations and every fired
boundary, is one replay, so a tracking-only frame counts 1 / 0 / 1 and a
keyframe 2 / 0 / 2 (the reference's ``_track_scan_prune`` is one
``lax.scan``); eager it counts ``1 + scheduled + K + fired * (2 +
scheduled)`` dispatches and K syncs.  ``tests/test_torch_fused.py`` holds
the counts to the formula.

S rows (``session.step_many``).  S stacked sessions share one runner, and
each tracking segment has an S-row form (:func:`rows_segment`): row ``s``'s
tensors are named ``"{s}/name"`` and each row runs the solo segment's ops
on its own tensors, so every row equals its solo run bit for bit.  The
keyframe segment is S one-row conditional bodies in one graph
(:meth:`PhaseRunner.run_when`), each under its row's flag.  Both are keyed
by S; solo is S = 1.  A frame-step of S rows counts:

* no row takes a keyframe, as the host knows (MonoGS, SplaTAM): 1
  dispatch, 0 syncs and 1 replay, for any S (the S rows' fragment-list
  builds ride inside the one replay);
* any row may take one: 2 dispatches, 0 syncs and 2 replays, however many
  rows map (GS-SLAM and Photo-SLAM: every frame-step);
* with §4.1 pruning the same: each row's build, iterations and fired
  boundaries ride inside the one S-row tracking replay; Photo-SLAM's
  geometric tracking is 1 replay for all rows.

``tests/test_torch_stacked.py`` holds the S-row counts to this formula.
"""

from __future__ import annotations

import ctypes
import dataclasses
import time
from typing import Callable, Optional

import torch

from repro_torch._device import constant
from repro_torch.kernels import _build, gmu, tile_render, tile_render_bp


@dataclasses.dataclass
class EngineStats:
    """Host-side accounting of a session's pipeline (units: module
    docstring)."""

    dispatches: int = 0
    syncs: int = 0
    replays: int = 0
    captures: int = 0

    def since(self, earlier: "EngineStats") -> "EngineStats":
        return EngineStats(*(a - b for a, b in zip(dataclasses.astuple(self),
                                                   dataclasses.astuple(earlier))))

    def add(self, other: "EngineStats") -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, getattr(self, f.name) + getattr(other, f.name))


def launch_counters():
    """The kernel wrappers whose ``launches`` attribute counts launches."""
    return (tile_render.tile_render_fwd, tile_render.tile_render_fwd_sched,
            tile_render_bp.tile_render_bwd, tile_render_bp.tile_render_bwd_sched,
            gmu.block_cumsum, gmu.merge_runs)


def flat(prefix: str, tree) -> dict:
    """The tensors of a NamedTuple, dataclass or dict of tensors (nested),
    named ``prefix.field``; ``None`` gives nothing."""
    if tree is None:
        return {}
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    if isinstance(tree, dict):
        items = tree.items()
    elif dataclasses.is_dataclass(tree):
        items = ((f.name, getattr(tree, f.name)) for f in dataclasses.fields(tree))
    else:
        items = zip(tree._fields, tree)
    out = {}
    for k, v in items:
        out.update(flat(f"{prefix}.{k}", v))
    return out


def unflat(tensors: dict, prefix: str, cls):
    """The NamedTuple or dataclass ``cls`` of flat tensor fields that
    :func:`flat` named under ``prefix``."""
    names = (cls._fields if hasattr(cls, "_fields")
             else [f.name for f in dataclasses.fields(cls)])
    return cls(**{k: tensors[f"{prefix}.{k}"] for k in names})


def row_names(s: int, tensors: dict) -> dict:
    """Row ``s``'s tensors, named ``"{s}/name"`` in an S-row segment."""
    return {f"{s}/{k}": v for k, v in tensors.items()}


def row_view(s: int, tensors: dict) -> dict:
    """Row ``s``'s tensors of an S-row dict, under their one-row names."""
    p = f"{s}/"
    return {k[len(p):]: v for k, v in tensors.items() if k.startswith(p)}


def row_carry(carry, n_rows: int) -> tuple:
    """The carried names of an ``n_rows``-row segment."""
    return tuple(f"{s}/{k}" for s in range(n_rows) for k in carry)


def rows_segment(fns) -> Callable[..., dict]:
    """The S-row segment that runs one-row segment ``fns[s]`` on row
    ``s``'s tensors (:func:`row_names`), one row after another; any
    further argument (a conditional segment's ``when``) is passed on."""
    def fn(t, *args):
        out = {}
        for s, f in enumerate(fns):
            out.update(row_names(s, f(row_view(s, t), *args)))
        return out
    return fn


_P = ctypes.c_void_p


def _cond_lib():
    """``csrc/graph_cond.cu``: a conditional IF node in the graph a stream
    is capturing, and the capture of its body on a second stream."""
    lib = _build.load("graph_cond")
    lib.cond_begin.argtypes = [_P, _P, _P, ctypes.POINTER(_P)]
    lib.cond_end.argtypes = [_P, _P]
    lib.cond_stream_create.argtypes = [ctypes.POINTER(_P)]
    for fn in (lib.cond_begin, lib.cond_end, lib.cond_stream_create):
        fn.restype = ctypes.c_int
    return lib


# Per device index: the stream every conditional body is captured on and the
# memory pool its allocations go to, shared by all runners.  Bodies replay
# one at a time on the replaying stream, and each writes its temporaries
# before it reads them, so they may share memory as the graphs of one pool
# do; a body that a replay skips leaves nothing another body reads.
_BODY: dict = {}


def _body_stream_and_pool(device: torch.device):
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _BODY:
        raw = _P()
        with torch.cuda.device(index):
            _cuda_check("creating the conditional bodies' stream",
                        _cond_lib().cond_stream_create(ctypes.byref(raw)))
        _BODY[index] = (torch.cuda.ExternalStream(raw.value, device=index),
                        torch.cuda.graph_pool_handle())
    return _BODY[index]


def _cuda_check(what: str, err: int) -> None:
    if err:
        raise RuntimeError(f"{what} failed: cudaError {err}")


def _check_like(name: str, got: torch.Tensor, buf: torch.Tensor) -> None:
    """A body's output must fit the buffer it is written into."""
    if got.shape != buf.shape or got.dtype != buf.dtype:
        raise ValueError(f"segment output {name!r} is {got.dtype} {tuple(got.shape)}, "
                         f"its buffer {buf.dtype} {tuple(buf.shape)}")


class _Segment:
    def __init__(self, inputs: dict):
        self.inputs = {k: v.clone() for k, v in inputs.items()}
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs: dict = {}
        self.deltas: tuple = ()
        # Conditional segments (PhaseRunner.run_when): each row's flag, its
        # per-step defaults, its body's launch deltas at capture, and the
        # body runs of the rows the device decides, counted on the device
        # (``runs``) and folded into the launch counters on a read.
        self.flags: list = []
        self.defaults: dict = {}
        self.host_rows: tuple = ()
        self.body_deltas: list = []
        self.runs: Optional[torch.Tensor] = None
        self.folded: list = []


class PhaseRunner:
    """Runs the phase segments of every session of one device, config and
    intrinsics (``session.runner_for``; see the module docstring) and keeps
    their :class:`EngineStats`."""

    def __init__(self, device, fused: bool = True):
        self.device = torch.device(device)
        self.fused = fused
        self.capture = fused and self.device.type == "cuda"
        self.stats = EngineStats()
        self._segments: dict = {}
        self._pool = None
        # Kernel launches counted through replays, by wrapper name.
        self.replayed_launches = {c.__name__: 0 for c in launch_counters()}
        # (key, host seconds) of every capture, warm-up included.
        self.capture_times: list = []

    def count(self, dispatches: int = 1, syncs: int = 0) -> None:
        """Count an eager host call of a phase core and its reads."""
        self.stats.dispatches += dispatches
        self.stats.syncs += syncs

    def run(self, key, fn: Callable[..., dict], inputs: dict, carry=(),
            times: int = 1, iters: int = 1, conditional: bool = False):
        """Run ``fn`` ``times`` times from ``inputs``; returns ``(carried,
        runs)``: the final value of every ``carry`` output and, per run,
        the other outputs.  ``iters`` is the dispatches one eager run of
        ``fn`` counts (its iterations and the phase cores it calls).

        ``conditional``: ``fn`` is called as ``fn(t, when)``, where
        ``when(flag, body, iters)`` runs the zero-argument ``body`` under
        the () bool device tensor ``flag`` at that point of the segment
        (the counterpart of a ``lax.cond`` inside a ``lax.scan`` body).
        ``body`` must write its results in place into tensors that exist
        before the call, so a skipped body leaves them as they were.
        Fused on the card it is captured under a CUDA graph IF node, and a
        replay runs or skips it without a read; fused on the CPU it runs
        under ``if bool(flag)``; eager, the flag is read (one sync) and a
        body that runs counts ``iters`` dispatches."""
        if not self.fused:
            tensors, runs = dict(inputs), []
            args = (self._eager_when,) if conditional else ()
            for _ in range(times):
                out = fn(tensors, *args)
                tensors.update({k: out[k] for k in carry})
                runs.append({k: v for k, v in out.items() if k not in carry})
                self.stats.dispatches += iters
            return {k: tensors[k] for k in carry}, runs

        seg = self._segment(key, fn, inputs, carry, conditional)
        for k, v in inputs.items():
            seg.inputs[k].copy_(v)
        runs = []
        for _ in range(times):
            if seg.graph is None:
                out = fn(seg.inputs, *((_cpu_when,) if conditional else ()))
                for k in carry:
                    seg.inputs[k].copy_(out[k])
            else:
                self._replay(seg)
                out = seg.outputs
            runs.append({k: v.clone() for k, v in out.items() if k not in carry})
            self.stats.dispatches += 1
        return {k: seg.inputs[k].clone() for k in carry}, runs

    def _eager_when(self, flag, body, iters: int = 1) -> None:
        self.stats.syncs += 1
        if bool(flag):
            body()
            self.stats.dispatches += iters

    def run_when(self, key, decide: Callable[[dict], torch.Tensor],
                 body: Callable[[dict], dict], inputs: dict, flags, carry,
                 defaults: dict, iters: int = 1) -> list:
        """Run one-row segment ``body`` on each row ``s`` of the S-row
        ``inputs`` (named ``"{s}/name"``, :func:`row_names`) whose flag
        holds: ``flags[s]`` where it is a host ``bool``, else the () bool
        tensor ``decide`` computes from the row's inputs on the device.
        Each row's ``carry`` outputs are written into its inputs of the
        same name, so a skipped row keeps them; its per-step outputs (the
        names of ``defaults``) are the body's, or ``defaults`` when it is
        skipped.  Returns one dict per row: those values and ``"when"``,
        the row's flag (the host ``bool``, or the device tensor).

        Fused on the card, the rows are one graph: each row's decision,
        then its defaults, then its body under a conditional IF node
        (``csrc/graph_cond.cu``), so a run is one replay whether or not a
        body runs and reads nothing back.  Fused on the CPU, the same
        function runs through the same buffers under ``if bool(flag)``.
        Not fused, the flags are read on the host (one sync for all the
        rows the device decides) and each body that runs counts ``iters``
        dispatches."""
        n = len(flags)
        if not self.fused:
            return self._run_when_eager(decide, body, inputs, flags, carry,
                                        defaults, iters)
        inputs = dict(inputs)
        for s, f in enumerate(flags):
            if f is not None:
                inputs[f"{s}/when"] = constant(bool(f), torch.bool, self.device)
        full_key = ("when", key, tuple(carry), tuple(defaults), tuple(
            (k, tuple(v.shape), v.dtype) for k, v in sorted(inputs.items())))
        seg = self._segments.get(full_key)
        if seg is None:
            seg = _Segment(inputs)
            seg.defaults = {k: v.clone() for k, v in defaults.items()}
            seg.outputs = {f"{s}/{k}": v.clone() for s in range(n)
                           for k, v in defaults.items()}
            seg.host_rows = tuple(f is not None for f in flags)
            seg.flags = [None] * n
            if self.capture:
                self._capture_when(key, seg, self._when_plan(seg, decide, body, n, carry),
                                   decide, body, n)
            self._segments[full_key] = seg
        for k, v in inputs.items():
            seg.inputs[k].copy_(v)
        if seg.graph is None:
            self._when_plan(seg, decide, body, n, carry)(
                lambda flag, fn, device_decided: _cpu_when(flag, fn))
        else:
            self._replay(seg)
            for s, f in enumerate(flags):
                if f:       # a host flag: its body's launches are known now
                    self._add_launches(seg.body_deltas[s])
        self.stats.dispatches += 1
        return [{**{k: seg.inputs[f"{s}/{k}"].clone() for k in carry},
                 **{k: seg.outputs[f"{s}/{k}"].clone() for k in defaults},
                 "when": flags[s] if flags[s] is not None else seg.flags[s].clone()}
                for s in range(n)]

    def _run_when_eager(self, decide, body, inputs, flags, carry, defaults, iters):
        rows = [row_view(s, inputs) for s in range(len(flags))]
        tests = {s: decide(t) for s, t in enumerate(rows) if flags[s] is None}
        read = {}
        if tests:
            read = dict(zip(tests, torch.stack(list(tests.values())).tolist()))
            self.stats.syncs += 1
        out = []
        for s, t in enumerate(rows):
            if flags[s] if flags[s] is not None else read[s]:
                res = body(t)
                row = {k: res[k] for k in (*carry, *defaults)}
                self.stats.dispatches += iters
            else:
                row = {**{k: t[k] for k in carry},
                       **{k: v.clone() for k, v in defaults.items()}}
            row["when"] = flags[s] if flags[s] is not None else tests[s]
            out.append(row)
        return out

    def _when_plan(self, seg: _Segment, decide, body, n: int, carry):
        """The rows of a conditional segment over its buffers, given
        ``cond(flag, fn)``, which runs ``fn`` under ``flag``: each row's
        decision, then its per-step defaults, then its body."""
        def plan(cond):
            for s in range(n):
                t = row_view(s, seg.inputs)
                flag = t["when"] if seg.host_rows[s] else decide(t)
                seg.flags[s] = flag
                for k, d in seg.defaults.items():
                    seg.outputs[f"{s}/{k}"].copy_(d)

                def run_body(s=s, t=t):
                    out = body(t)
                    for k in carry:
                        _check_like(k, out[k], t[k])
                        t[k].copy_(out[k])
                    for k in seg.defaults:
                        buf = seg.outputs[f"{s}/{k}"]
                        _check_like(k, out[k], buf)
                        buf.copy_(out[k])

                cond(flag, run_body, not seg.host_rows[s])
        return plan

    def _replay(self, seg: _Segment) -> None:
        seg.graph.replay()
        self._add_launches(seg.deltas)
        self.stats.replays += 1

    def _add_launches(self, deltas) -> None:
        for counter, d in zip(launch_counters(), deltas):
            counter.launches += d
            self.replayed_launches[counter.__name__] += d

    def run_counts(self) -> Optional[torch.Tensor]:
        """The device-decided body runs of every captured conditional
        segment, as one int64 tensor for a caller's read (``None`` if
        there are none); :meth:`fold_run_counts` takes the values read."""
        runs = [seg.runs for seg in self._segments.values() if seg.runs is not None]
        return torch.cat(runs) if runs else None

    def fold_run_counts(self, counts) -> None:
        """Add the launches of the body runs counted since the last fold
        (``counts`` read from :meth:`run_counts`) to the launch counters."""
        counts = iter(counts)
        for seg in self._segments.values():
            if seg.runs is None:
                continue
            for s, deltas in enumerate(seg.body_deltas):
                runs = int(next(counts))
                for counter, d in zip(launch_counters(), deltas):
                    counter.launches += (runs - seg.folded[s]) * d
                    self.replayed_launches[counter.__name__] += (runs - seg.folded[s]) * d
                seg.folded[s] = runs

    def fold_launches(self) -> None:
        """Read the device-decided body runs (one sync, if any) and fold
        their launches into the launch counters."""
        counts = self.run_counts()
        if counts is not None:
            self.fold_run_counts(counts.tolist())
            self.stats.syncs += 1

    def _segment(self, key, fn, inputs: dict, carry, conditional: bool) -> _Segment:
        full_key = (key, tuple(carry), tuple(
            (k, tuple(v.shape), v.dtype) for k, v in sorted(inputs.items())))
        seg = self._segments.get(full_key)
        if seg is None:
            seg = _Segment(inputs)
            if self.capture:
                # raises on failure; nothing kept
                self._capture(key, seg, fn, carry, conditional)
            self._segments[full_key] = seg
        return seg

    def _capture(self, key, seg: _Segment, fn, carry, conditional: bool) -> None:
        """Capture a segment: one warm-up run on a side stream (with every
        conditional body run on the bodies' stream, whatever its flag),
        then the graph, each conditional body under an IF node
        (:meth:`_capture_node`)."""
        t0 = time.perf_counter()
        counters = launch_counters()
        before = [c.launches for c in counters]
        bs = _body_stream_and_pool(self.device)[0] if conditional else None
        nodes = []

        def warm_when(flag, body, iters=1):
            cur = torch.cuda.current_stream()
            bs.wait_stream(cur)
            with torch.cuda.stream(bs):
                body()
            cur.wait_stream(bs)
            nodes.append(flag)

        def node_when(flag, body, iters=1):
            self._capture_node(seg, flag, body, True)

        try:
            with torch.cuda.device(self.device):
                # Warm-up off the capture: lazy initialisation and the
                # kernels' per-device buffers must exist before capture.
                side = torch.cuda.Stream()
                side.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(side):
                    fn(seg.inputs, *((warm_when,) if conditional else ()))
                torch.cuda.current_stream().wait_stream(side)
                for c, b in zip(counters, before):
                    c.launches = b
                if nodes:
                    seg.runs = torch.zeros((len(nodes),), dtype=torch.int64,
                                           device=self.device)
                    seg.folded = [0] * len(nodes)
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph, pool=self._graph_pool()):
                    out = fn(seg.inputs, *((node_when,) if conditional else ()))
                    for k in carry:
                        seg.inputs[k].copy_(out[k])
            seg.deltas = tuple(c.launches - b for c, b in zip(counters, before))
        finally:
            for c, b in zip(counters, before):
                c.launches = b
        seg.graph, seg.outputs = graph, out
        self.stats.captures += 1
        self.capture_times.append((key, time.perf_counter() - t0))

    def _graph_pool(self):
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    def _capture_node(self, seg: _Segment, flag: torch.Tensor, fn,
                      device_decided: bool) -> None:
        """Inside a capture: ``fn`` under a conditional IF node on the ()
        bool device tensor ``flag``, captured on the bodies' stream into
        the node's body graph with its allocations routed into the bodies'
        pool (:data:`_BODY`), so nothing outside a body shares their
        memory.  Its launches are kept apart in ``seg.body_deltas`` (the
        node's index); a ``device_decided`` node counts its runs in
        ``seg.runs`` on the device."""
        counters = launch_counters()
        lib = _cond_lib()
        bs, body_pool = _body_stream_and_pool(self.device)
        node, mid = len(seg.body_deltas), [c.launches for c in counters]
        cs, dev_index = torch.cuda.current_stream(), torch.cuda.current_device()
        body_graph = _P()
        _cuda_check("opening a conditional node", lib.cond_begin(
            cs.cuda_stream, flag.data_ptr(), bs.cuda_stream, ctypes.byref(body_graph)))
        try:
            with torch.cuda.stream(bs):
                torch._C._cuda_beginAllocateCurrentStreamToPool(dev_index, body_pool)
                try:
                    fn()
                    if device_decided:
                        seg.runs[node:node + 1].add_(1)
                finally:
                    torch._C._cuda_endAllocateToPool(dev_index, body_pool)
        except BaseException:
            # The body's error is the one raised; its node stays empty.
            lib.cond_end(bs.cuda_stream, body_graph)
            raise
        _cuda_check("closing a conditional node",
                    lib.cond_end(bs.cuda_stream, body_graph))
        seg.body_deltas.append(tuple(c.launches - m for c, m in zip(counters, mid)))
        for c, m in zip(counters, mid):
            c.launches = m

    def _capture_when(self, key, seg: _Segment, plan, decide, body, n: int) -> None:
        """Capture a conditional segment: one warm-up run of every row's
        decision and body on the body stream (which makes the lazily built
        buffers, the body stream's cuBLAS workspace among them), then the
        graph, each row's body under an IF node (:meth:`_capture_node`)."""
        t0 = time.perf_counter()
        counters = launch_counters()
        before = [c.launches for c in counters]
        bs = _body_stream_and_pool(self.device)[0]
        try:
            with torch.cuda.device(self.device):
                bs.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(bs):
                    for s in range(n):
                        t = row_view(s, seg.inputs)
                        if not seg.host_rows[s]:
                            decide(t)
                        body(t)
                torch.cuda.current_stream().wait_stream(bs)
                for c, b in zip(counters, before):
                    c.launches = b
                if not all(seg.host_rows):
                    seg.runs = torch.zeros((n,), dtype=torch.int64, device=self.device)
                    seg.folded = [0] * n
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph, pool=self._graph_pool()):
                    plan(lambda flag, fn, device_decided: self._capture_node(
                        seg, flag, fn, device_decided))
            seg.deltas = tuple(c.launches - b for c, b in zip(counters, before))
        finally:
            for c, b in zip(counters, before):
                c.launches = b
        seg.graph = graph
        self.stats.captures += 1
        self.capture_times.append((key, time.perf_counter() - t0))


def _cpu_when(flag, body, iters: int = 1) -> None:
    """A conditional body fused on the CPU: the flag is a host read there,
    which costs no sync."""
    if bool(flag):
        body()
