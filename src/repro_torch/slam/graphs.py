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
are taken back), so the counters stay exact through replays.

Units of :class:`EngineStats` (the reference's ``engine.py:96-110``):

* **dispatch** — one graph replay (one run of a segment when fused, also
  on the CPU), one eager iteration of a segment when not fused, or one
  eager host call of a phase core outside the segments: a fragment-list
  build (``_build_core`` and its sparse form), a schedule build
  (``_sched_core``), a forward render (the eval render and densify's, the
  stable background), densification, and a fired §4.1 boundary's
  ``interval_update``;
* **sync** — one device-to-host read: densification's three boolean-mask
  reads, GS-SLAM's and Photo-SLAM's keyframe reads
  (``core/keyframes.py``), a fired boundary's churn read
  (``core/pruning.py``), Photo-SLAM's host factor choice under §4.2, the
  seed map's two frame reads and finalize's reads.  A fragment-list build
  reads nothing back (``core/sorting.py``);
* **replay** — one CUDA graph replay (0 on the CPU);
* **capture** — one segment captured as a CUDA graph (its warm-up run and
  its capture: a session's first use of a phase at a factor and shape).

The reference counts 1 dispatch and no sync per frame, because its whole
step is one XLA program.  Here a MonoGS tracking-only frame counts the
same, 1 dispatch (the tracking replay, the frame's fragment-list build
inside it) and no sync; a keyframe adds the eager mapping work around its
replays (densify and its 3 reads, the window builds, the stride rebuilds,
the eval renders) and a fired §4.1 boundary its rebuild and read;
``tests/test_torch_fused.py`` holds the counts to the formula.

S rows (``session.step_many``).  S stacked sessions share one runner, and
each tracking segment has an S-row form (:func:`rows_segment`): row ``s``'s
tensors are named ``"{s}/name"`` and each row runs the solo segment's ops
on its own tensors, so every row equals its solo run bit for bit.  The
S-row segment is keyed by S; the mapping segments are keyed by their
shapes only and serve every row.  A frame-step of S rows counts:

* no row takes a keyframe: 1 dispatch, 0 syncs and 1 replay, for any S
  (the S rows' fragment-list builds ride inside the one replay);
* each keyframe row adds its own mapping work, as in a solo keyframe (17
  dispatches and 3 syncs on ``kernel``);
* GS-SLAM and Photo-SLAM read all S rows' keyframe decisions in 1 sync;
* with §4.1 pruning, tracking is S eager builds (and schedules) and K
  replays of a one-iteration S-row segment, plus each row's fired
  boundaries (2 dispatches and 1 sync each, 3 and 1 on ``schedule``);
  Photo-SLAM's geometric tracking is 1 replay for all rows.

``tests/test_torch_stacked.py`` holds the S-row counts to this formula.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.kernels import gmu, tile_render, tile_render_bp


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


def rows_segment(fns) -> Callable[[dict], dict]:
    """The S-row segment that runs one-row segment ``fns[s]`` on row
    ``s``'s tensors (:func:`row_names`), one row after another."""
    def fn(t):
        out = {}
        for s, f in enumerate(fns):
            out.update(row_names(s, f(row_view(s, t))))
        return out
    return fn


class _Segment:
    def __init__(self, inputs: dict):
        self.inputs = {k: v.clone() for k, v in inputs.items()}
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs: dict = {}
        self.deltas: tuple = ()


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

    def count(self, dispatches: int = 1, syncs: int = 0) -> None:
        """Count an eager host call of a phase core and its reads."""
        self.stats.dispatches += dispatches
        self.stats.syncs += syncs

    def run(self, key, fn: Callable[[dict], dict], inputs: dict, carry=(),
            times: int = 1, iters: int = 1,
            between: Optional[Callable[[int, dict], None]] = None):
        """Run ``fn`` ``times`` times from ``inputs``; returns ``(carried,
        runs)``: the final value of every ``carry`` output and, per run,
        the other outputs.  ``iters`` is the iterations one run of ``fn``
        does (the eager dispatch count).  ``between(r, tensors)``, if
        given, runs eagerly after run ``r`` and may write into the inputs
        in place (the runner's static buffers when fused, else the
        caller's tensors, which it must own)."""
        if not self.fused:
            tensors, runs = dict(inputs), []
            for r in range(times):
                out = fn(tensors)
                tensors.update({k: out[k] for k in carry})
                runs.append({k: v for k, v in out.items() if k not in carry})
                self.stats.dispatches += iters
                if between is not None:
                    between(r, tensors)
            return {k: tensors[k] for k in carry}, runs

        seg = self._segment(key, fn, inputs, carry)
        for k, v in inputs.items():
            seg.inputs[k].copy_(v)
        runs = []
        for r in range(times):
            if seg.graph is None:
                out = fn(seg.inputs)
                for k in carry:
                    seg.inputs[k].copy_(out[k])
            else:
                seg.graph.replay()
                out = seg.outputs
                for counter, d in zip(launch_counters(), seg.deltas):
                    counter.launches += d
                    self.replayed_launches[counter.__name__] += d
                self.stats.replays += 1
            runs.append({k: v.clone() for k, v in out.items() if k not in carry})
            self.stats.dispatches += 1
            if between is not None:
                between(r, seg.inputs)
        return {k: seg.inputs[k].clone() for k in carry}, runs

    def _segment(self, key, fn, inputs: dict, carry) -> _Segment:
        full_key = (key, tuple(carry), tuple(
            (k, tuple(v.shape), v.dtype) for k, v in sorted(inputs.items())))
        seg = self._segments.get(full_key)
        if seg is None:
            seg = _Segment(inputs)
            if self.capture:
                self._capture(seg, fn, carry)   # raises on failure; nothing kept
            self._segments[full_key] = seg
        return seg

    def _capture(self, seg: _Segment, fn, carry) -> None:
        counters = launch_counters()
        before = [c.launches for c in counters]
        try:
            with torch.cuda.device(self.device):
                # Warm-up off the capture: lazy initialisation and the
                # kernels' per-device buffers must exist before capture.
                side = torch.cuda.Stream()
                side.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(side):
                    fn(seg.inputs)
                torch.cuda.current_stream().wait_stream(side)
                for c, b in zip(counters, before):
                    c.launches = b
                if self._pool is None:
                    self._pool = torch.cuda.graph_pool_handle()
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph, pool=self._pool):
                    out = fn(seg.inputs)
                    for k in carry:
                        seg.inputs[k].copy_(out[k])
            seg.deltas = tuple(c.launches - b for c, b in zip(counters, before))
        finally:
            for c, b in zip(counters, before):
                c.launches = b
        seg.graph, seg.outputs = graph, out
        self.stats.captures += 1
