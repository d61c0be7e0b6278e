"""Pool-width ladder: serving pools at a ladder of widths, every graph
captured up front (counterpart of ``repro/slam/sched/ladder.py``).

A :class:`~repro_torch.slam.server.ShardedPool`'s S-row tracking graph is
specialized on the pool width, so "one more stream than the pool holds"
would capture a new graph on the serving path.  The ladder builds the
handful of widths the deployment will use UP FRONT and captures every
segment a serving step can reach in :meth:`PoolLadder.warmup`; from then
on admission is a row swap into whichever rung has room and growth is a
row migration up the ladder — neither captures anything.

All rungs share one phase runner (``session.runner_for``: one per
device, config and intrinsics), so the mapping graphs are captured once
for every rung and every session of the config, and
:func:`~repro_torch.slam.server.compile_cache_stats` taken after
:meth:`PoolLadder.warmup` must equal the same census after any amount of
serving (tests/test_torch_sched.py and ``chip_smoke.py [sched]`` enforce
it).

Captures happen only in the warmup, before any producer thread runs: a
CUDA graph capture in PyTorch's default ("global") mode fails if another
thread makes an unsafe CUDA call meanwhile.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch

from repro_torch.obs import Telemetry, telemetry_or_off
from repro_torch.slam.graphs import EngineStats
from repro_torch.slam.server import ServeStats, ShardedPool, SlamServer
from repro_torch.slam.session import SlamSession, warm_keyframe

__all__ = ["LadderRung", "PoolLadder"]


@dataclasses.dataclass
class LadderRung:
    """One width of the ladder: a pool plus its queue-fed server.  Rungs
    start with every slot free (template-filled scratch rows)."""

    width: int
    pool: ShardedPool
    server: SlamServer

    @property
    def name(self) -> str:
        return f"S{self.width}"


class PoolLadder:
    """Serving pools at a ladder of widths, one shared telemetry sink, one
    phase runner.

    Construction stacks ``template`` (a freshly ``session_init``-ed solo
    session — its state is scratch until a real stream is admitted) into
    one pool per width; :meth:`warmup` then captures every segment a
    serving step can reach and resets the counters, so everything the
    registry measures afterwards is real serving work and admission never
    captures.  Each rung's server is named ``S{width}`` — the ``group``
    label on its dispatch counters and spans — and defaults to no live
    slots (streams arrive via the scheduler's admission).
    """

    def __init__(self, template: SlamSession,
                 widths: Sequence[int] = (2, 4, 8), queue_depth: int = 2,
                 devices=None, telemetry: Optional[Telemetry] = None):
        widths = sorted(set(int(w) for w in widths))
        if not widths or widths[0] < 1:
            raise ValueError(f"ladder widths must be positive, got {widths}")
        if template.batch is not None:
            raise ValueError("ladder template must be a solo session; got "
                             f"batch={template.batch}")
        self.tele = telemetry_or_off(telemetry)
        self.template = template
        self.rungs: List[LadderRung] = []
        for w in widths:
            pool = ShardedPool([template] * w, devices=devices)
            server = SlamServer(pool, queue_depth=queue_depth, live=[],
                                telemetry=self.tele, name=f"S{w}")
            self.rungs.append(LadderRung(width=w, pool=pool, server=server))

    # -- introspection -----------------------------------------------------

    def __len__(self) -> int:
        return len(self.rungs)

    def __getitem__(self, ix: int) -> LadderRung:
        return self.rungs[ix]

    @property
    def widths(self) -> List[int]:
        return [r.width for r in self.rungs]

    @property
    def capacity(self) -> int:
        return sum(r.width for r in self.rungs)

    def free_slots(self) -> int:
        return sum(len(r.server.free_slots()) for r in self.rungs)

    def live_streams(self) -> int:
        return sum(len(r.server.live_slots()) for r in self.rungs)

    # -- warmup ------------------------------------------------------------

    def warmup(self) -> dict:
        """Capture every segment a serving step can reach: each rung's
        S-row tracking graph (one blank-frame step; with pruning, the
        one-iteration graph) and one template swap, then the mapping
        graphs of a keyframe (a scratch keyframe on a copy of the
        template: the dense graphs, or the sparse ones under
        ``cfg.sparse_opt``; the window fill is a device tensor, so they
        serve every fill).  Waits for the card, then resets the dispatch
        counters so warmup never pollutes the measured dispatches per
        frame-step.  Returns the post-warmup
        :func:`~repro_torch.slam.server.compile_cache_stats` census — the
        baseline the zero-capture gate compares against."""
        from repro_torch.slam.server import compile_cache_stats

        for rung in self.rungs:
            with self.tele.span("warmup", group=rung.name):
                rung.pool.step([rung.server._blank] * rung.width)
                rung.pool.swap(0, self.template)
            # Warmup state is scratch (no slot is live); drop its counters.
            rung.pool.stats = EngineStats()
            rung.pool.admin_dispatches = 0
            rung.server.stats = ServeStats()
        with self.tele.span("warmup", group="keyframe"):
            warm_keyframe(self.template)
        dev = self.template.device
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return compile_cache_stats()
