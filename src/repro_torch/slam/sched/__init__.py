"""SlamServe v2 on one card (counterpart of ``repro/slam/sched``): the
continuous-batching scheduler tier above ShardedPool.

A single lockstep pool lets a starved stream stall its peers
(head-of-line blocking), and a new pool width means new CUDA graph
captures.  This package is the continuous-batching answer for SLAM
streams, in four pieces:

* :mod:`~repro_torch.slam.sched.ladder` — :class:`PoolLadder`: serving
  pools at a ladder of widths sharing one phase runner, every segment a
  serving step can reach captured once in :meth:`PoolLadder.warmup`, so
  admission and migration NEVER capture.
* :mod:`~repro_torch.slam.sched.policy` — :class:`QueueDepthPolicy`: the
  queue-depth / oldest-deadline policy deciding which group to pump and
  which row to migrate when a group blocks.
* :mod:`~repro_torch.slam.sched.scheduler` — :class:`SlamScheduler`: the
  dispatch-thread orchestrator — admission, row migration between pool
  widths (retire + admit via the row-swap machinery, counted as
  ``kind="admin"`` dispatches, bitwise-transparent to the stream), and
  independent per-group pumping.
* :mod:`~repro_torch.slam.sched.ingest` — :class:`IngestWorker`: the
  producer thread that decodes frames into page-locked host tensors and
  queues them, off the dispatch thread.

The invariants of the tiers below carry forward: every stream's row stays
bitwise-equal to its solo run regardless of which pool stepped it or how
often it migrated, and the per-group step dispatches equal the frame-steps
in the obs registry (tests/test_torch_sched.py).
"""

from repro_torch.slam.sched.ingest import IngestWorker, default_decode
from repro_torch.slam.sched.ladder import LadderRung, PoolLadder
from repro_torch.slam.sched.policy import (
    GroupView,
    Migration,
    QueueDepthPolicy,
    SlotView,
)
from repro_torch.slam.sched.scheduler import SchedStats, SlamScheduler

__all__ = [
    "GroupView",
    "IngestWorker",
    "LadderRung",
    "Migration",
    "PoolLadder",
    "QueueDepthPolicy",
    "SchedStats",
    "SlamScheduler",
    "SlotView",
    "default_decode",
]
