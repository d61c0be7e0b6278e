"""Queue-depth / oldest-deadline scheduling policy for the pool ladder (the
port's own copy of ``repro/slam/sched/policy.py``: pure Python).

The policy is PURE — it reads immutable :class:`GroupView` snapshots and
returns decisions (:meth:`QueueDepthPolicy.pump_order`,
:meth:`QueueDepthPolicy.migrations`); the scheduler owns the clock, the
locks and the execution.  That split keeps the whole decision surface
unit-testable with hand-built views (tests/test_torch_sched.py) and keeps the
dispatch loop free of policy state.

The two decisions:

* **Which group pumps, in what order.**  A group is *ready* when every
  live slot has a frame queued (the lockstep-batch invariant of the tier
  below).  Ready groups pump oldest-deadline-first — the group whose head
  frame has waited longest goes first; a non-ready group simply skips the
  tick instead of stalling anyone.

* **Who migrates when a group blocks.**  A group *blocks* when it holds
  both waiters (slots with frames queued) and starving slots (live, queue
  empty) — the classic head-of-line stall.  After ``starve_s`` of that,
  the policy picks between two moves.  **Evict-starved** sheds a
  starving row into a lane that can absorb a slow one: first a *slow
  lane* (free slot, no waiters — its peers are as slow as the mover, or
  it is alone), else a lane that is itself starving (the slow pool with
  the slow, which costs its waiters nothing they weren't already
  paying); a pure ready lane is NEVER an eviction target — that would
  poison the one group running clean.  **Rescue-waiter** pulls the
  oldest-deadline waiter out into a *clean* lane (free slot, nobody
  starving).  Priority depends on depth of the mix: a group with ONE
  starving row evicts it (the lane comes out ready — every waiter
  unblocks at once, and a clean lane is born for later rescues); a
  deeper-mixed group rescues first, because evicting one of several
  slow rows leaves it just as blocked while its fast waiters rot.
  Blocked groups are served fewest-starving-first so the almost-clean
  lane gets cleaned before the hopeless one gets shuffled, and lane
  classification tracks the plans already made this tick, so one tick
  can chain moves through a single free slot without poisoning a lane
  an earlier plan just cleaned.  This is how rate-based grouping
  emerges: nobody declares a stream "fast" or "slow" up front —
  blocking pressure sorts slow rows toward slow lanes and fast rows
  toward clean ones, even from a fully mixed, fully saturated start.
"""

from __future__ import annotations

import dataclasses
from typing import FrozenSet, List, Optional, Sequence, Set, Tuple

__all__ = ["GroupView", "Migration", "QueueDepthPolicy", "SlotView"]


@dataclasses.dataclass(frozen=True)
class SlotView:
    """One live slot of a group at snapshot time."""

    slot: int
    stream: object          # the scheduler's stream id (telemetry label)
    fill: int               # queued frames
    head_age_s: Optional[float]   # oldest queued frame's wait; None if empty
    slow_marks: int = 0     # times this stream was evicted as starving —
                            # the emergent per-stream rate label


@dataclasses.dataclass(frozen=True)
class GroupView:
    """One ladder rung at snapshot time (live slots only)."""

    rung: int
    name: str
    width: int
    free: int               # free slots (admission / migration headroom)
    blocked_for_s: float    # seconds this group has been blocked (0 if not)
    slots: Tuple[SlotView, ...]

    @property
    def waiters(self) -> List[SlotView]:
        return [sv for sv in self.slots if sv.fill > 0]

    @property
    def starving(self) -> List[SlotView]:
        return [sv for sv in self.slots if sv.fill == 0]

    @property
    def ready(self) -> bool:
        """A lockstep batch can dispatch: live and nobody is starving."""
        return bool(self.slots) and not self.starving

    @property
    def blocked(self) -> bool:
        """Head-of-line stall: waiters held up by starving peers."""
        return bool(self.slots) and bool(self.waiters) and bool(self.starving)

    @property
    def oldest_head_age_s(self) -> float:
        ages = [sv.head_age_s for sv in self.slots
                if sv.head_age_s is not None]
        return max(ages) if ages else 0.0


@dataclasses.dataclass(frozen=True)
class Migration:
    """One planned row move: ``stream`` leaves rung ``src`` for ``dst``."""

    stream: object
    src: int
    dst: int
    reason: str             # "evict-starved" | "rescue-waiter" | "manual"


class QueueDepthPolicy:
    """The default policy: queue-depth readiness, oldest-deadline pump
    order, starvation-triggered migration with per-stream cooldown.

    ``starve_s`` — how long a group may stay blocked before the policy
    moves somebody.  ``cooldown_s`` — how long a migrated stream is frozen
    (the scheduler translates this into the ``frozen`` set), damping
    ping-pong.  ``max_migrations_per_tick`` bounds admin work per tick so
    migration storms cannot crowd out frame-steps.
    """

    def __init__(self, starve_s: float = 0.05, cooldown_s: float = 0.25,
                 max_migrations_per_tick: int = 2):
        self.starve_s = starve_s
        self.cooldown_s = cooldown_s
        self.max_migrations_per_tick = max_migrations_per_tick

    # -- pump decision -----------------------------------------------------

    def pump_order(self, views: Sequence[GroupView]) -> List[int]:
        """Rung indices to pump this tick: every ready group,
        oldest-deadline first.  Groups not listed skip the tick."""
        ready = [v for v in views if v.ready and v.slots]
        ready.sort(key=lambda v: (-v.oldest_head_age_s, v.rung))
        return [v.rung for v in ready]

    # -- migration decision ------------------------------------------------

    def migrations(self, views: Sequence[GroupView],
                   frozen: FrozenSet = frozenset()) -> List[Migration]:
        """Planned moves for this tick (the scheduler re-checks
        feasibility at execution).  ``frozen`` streams — typically those
        inside their post-migration cooldown — are never moved."""
        plans: List[Migration] = []
        moved: Set = set()
        free = {v.rung: v.free for v in views}
        # Effective same-tick composition: earlier plans this tick
        # already changed who lives where, and classifying a destination
        # from the stale snapshot would e.g. evict a slow row into a
        # lane the PREVIOUS plan just cleaned.  ``in_wait``/``in_starv``
        # count planned arrivals; planned departures are in ``moved``.
        in_wait = {v.rung: 0 for v in views}
        in_starv = {v.rung: 0 for v in views}

        def eff(g: GroupView) -> Tuple[int, int]:
            """(waiters, starving) counts as of the plans so far."""
            w = sum(1 for sv in g.waiters if sv.stream not in moved)
            s = sum(1 for sv in g.starving if sv.stream not in moved)
            return w + in_wait[g.rung], s + in_starv[g.rung]

        # Fewest starving rows first: the group one eviction away from
        # clean gets that eviction, so a clean lane FORMS this tick and
        # becomes the rescue target.  Cleaning the almost-clean lane
        # beats serving the longest-blocked one — from a fully mixed
        # start no clean lane exists, and without one the rescue path
        # never opens and every fast stream stays paced by slow peers.
        # Blocked-longest breaks ties.
        blocked = sorted((v for v in views
                          if v.blocked and v.blocked_for_s >= self.starve_s),
                         key=lambda v: (len(v.starving), -v.blocked_for_s))
        for v in blocked:
            if len(plans) >= self.max_migrations_per_tick:
                break
            lanes = [g for g in views
                     if g.rung != v.rung and free.get(g.rung, 0) > 0]
            # Lanes that can absorb a slow row: waiter-free first (slow
            # peers or empty — one move unblocks every waiter at once),
            # else already-starving lanes (the slow pool with the slow);
            # never a pure ready lane, whose waiters ARE running clean.
            # Rescue targets are the duals: lanes with nobody starving.
            slow, slowish, clean = [], [], []
            for g in lanes:
                w, s = eff(g)
                # Waiters never marked slow: probably fast — dumping a
                # slow row next to them would re-trap streams the sort
                # already saved.
                unmarked = sum(1 for sv in g.waiters
                               if sv.stream not in moved
                               and sv.slow_marks == 0)
                if w == 0:
                    slow.append((g, w, s))
                elif s > 0:
                    slowish.append((g, w, s, unmarked))
                if s == 0:
                    clean.append((g, w, s))
            evict_cands = [sv for sv in v.starving
                           if sv.stream not in frozen
                           and sv.stream not in moved]
            rescue_cands = [sv for sv in v.waiters
                            if sv.stream not in frozen
                            and sv.stream not in moved]

            def plan_evict():
                if not evict_cands or not (slow or slowish):
                    return None
                if slow:
                    # Smallest and narrowest first, so slow streams pool
                    # where they stall the fewest peers.
                    g = min(slow, key=lambda t: (t[1] + t[2],
                                                 t[0].width, t[0].rung))[0]
                else:
                    # Fewest probably-fast waiters first, then
                    # most-starving: concentrate the slow rows where
                    # they re-trap nobody.
                    g = min(slowish, key=lambda t: (t[3], -t[2], t[1],
                                                    t[0].rung))[0]
                # Known-slow rows move first; an unmarked starving row
                # may just be a fast stream's producer hiccup.
                victim = max(evict_cands, key=lambda sv: sv.slow_marks)
                return victim, g, "evict-starved"

            def plan_rescue():
                if not rescue_cands or not clean:
                    return None
                # Pack fast with fast: fullest clean lane first.
                g = min(clean, key=lambda t: (-t[1], t[0].rung))[0]
                # Deepest queue first: a full queue is live measured
                # proof the producer outpaces this lane, which no
                # history bit can fake.  Oldest deadline breaks ties.
                victim = max(rescue_cands,
                             key=lambda sv: (sv.fill,
                                             sv.head_age_s or 0.0))
                return victim, g, "rescue-waiter"

            # One eviction away from clean → evict (the lane comes out
            # ready, every waiter unblocks at once).  Deeper-mixed →
            # rescue first: with 2+ starving rows a single eviction
            # leaves the group just as blocked, so pulling the oldest
            # waiter OUT is the only move that helps anyone this tick.
            _, s_v = eff(v)
            choice = (plan_evict() or plan_rescue() if s_v <= 1
                      else plan_rescue() or plan_evict())
            if choice is not None:
                victim, dst, reason = choice
                plans.append(Migration(victim.stream, v.rung, dst.rung,
                                       reason))
                moved.add(victim.stream)
                free[dst.rung] -= 1
                free[v.rung] = free.get(v.rung, 0) + 1
                if reason == "evict-starved":
                    in_starv[dst.rung] += 1
                else:
                    in_wait[dst.rung] += 1
        return plans
