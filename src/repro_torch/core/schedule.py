"""WSU: the Workload Scheduling Unit's execution schedules (counterpart of
``repro/core/schedule.py``).

A :class:`TileSchedule` turns per-tile fragment counts into the order the
scheduled kernels K4 and K5 run tiles in:

* **pairwise scheduling** — tiles are sorted by fragment count and the
  heaviest is folded onto the lightest
  (``sorting.balanced_pair_permutation``), so each kernel block runs one
  balanced pair of tiles;
* **subtile streaming** — each slot carries the chunk trips its load needs
  (optionally rounded up to a multiple of ``bucket``), and the kernels stop
  a slot's chunk loop there;
* **previous-iteration reuse** — a schedule is a function of ``count``
  alone, so the engine builds it where it builds the fragment lists and
  keeps it until they are rebuilt.

Everything here is device tensor math with no host synchronisation: no
``.item()`` and no ``int()`` of a device tensor, because the engine builds
schedules inside its iteration loops.  The schedule is exact: pair blocks
replay each tile's chunk sequence, and trips drop only chunks whose
contribution is zero, so scheduled rendering equals unscheduled rendering.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.sorting import balanced_pair_permutation


class TileSchedule(NamedTuple):
    """A schedule over ``S = 2 * ceil(T / 2)`` slots (S/2 pairs), int32.

    Slot ``i`` renders tile ``perm[i]``; slots ``2p`` and ``2p+1`` form pair
    ``p`` and run in one kernel block.  Kernel outputs come out in slot
    order and go back to tile order with ``inv``."""

    perm: torch.Tensor   # (S,) slot -> tile (one tile may repeat as the pad)
    inv: torch.Tensor    # (T,) tile -> slot of its working occurrence
    trips: torch.Tensor  # (S,) chunk trips the slot runs
    load: torch.Tensor   # (S,) fragments the slot owes (0 for the pad)


def _div_up(x: torch.Tensor, d: int) -> torch.Tensor:
    return torch.div(x + d - 1, d, rounding_mode="floor")


def _inverse_slots(perm: torch.Tensor, num_tiles: int) -> torch.Tensor:
    """tile -> slot.  With an odd tile count ``perm`` holds a zero-work
    duplicate of the lightest tile in slot 1; a scatter-max from -1 with
    that slot demoted to -1 resolves the tile to its working slot whatever
    order the scatter runs in."""
    s = perm.shape[0]
    slots = torch.arange(s, dtype=torch.int32, device=perm.device)
    if s != num_tiles:
        slots = torch.where(slots == 1, torch.full_like(slots, -1), slots)
    inv = torch.full((num_tiles,), -1, dtype=torch.int32, device=perm.device)
    return inv.scatter_reduce_(0, perm.long(), slots, reduce="amax")


def build_schedule(count: torch.Tensor, chunk: int, *, bucket: int = 1,
                   max_trips: Optional[int] = None) -> TileSchedule:
    """The pairwise schedule of per-tile fragment counts ``count`` (T,).

    ``bucket`` rounds trips up to multiples of ``bucket``; that needs the
    capacity bound ``max_trips`` (= K / chunk), which clamps the rounding."""
    if bucket < 1:
        raise ValueError(f"bucket must be >= 1, got {bucket}")
    if bucket > 1 and max_trips is None:
        raise ValueError("bucket > 1 needs max_trips, the capacity bound")
    t = count.shape[0]
    perm, load = balanced_pair_permutation(count)
    trips = _div_up(load, chunk)
    if bucket > 1:
        trips = _div_up(trips, bucket) * bucket
        trips = torch.where(load > 0, trips, torch.zeros_like(trips))
    if max_trips is not None:
        trips = torch.clamp(trips, max=max_trips)
    return TileSchedule(perm=perm, inv=_inverse_slots(perm, t),
                        trips=trips.to(torch.int32), load=load)


def schedule_from_order(perm: torch.Tensor, count: torch.Tensor,
                        chunk: int) -> TileSchedule:
    """Schedule an arbitrary even-length tile permutation (every tile once;
    consecutive slots pair up), for ablations and permutation tests."""
    t = count.shape[0]
    if perm.shape != (t,) or t % 2:
        raise ValueError("need a permutation of an even number of tiles")
    perm = perm.to(torch.int32)
    load = count[perm.long()].to(torch.int32)
    inv = torch.zeros((t,), dtype=torch.int32, device=perm.device)
    inv[perm.long()] = torch.arange(t, dtype=torch.int32, device=perm.device)
    return TileSchedule(perm=perm, inv=inv, trips=_div_up(load, chunk).to(torch.int32),
                        load=load)


def pair_loads(sched: TileSchedule) -> torch.Tensor:
    """Fragments per pair block, (S/2,): what pairing balances."""
    return sched.load.reshape(-1, 2).sum(dim=1)


def active_programs(sched: TileSchedule) -> torch.Tensor:
    """() — pair blocks with nonzero trips, the ones that stream fragments."""
    pair_trips = sched.trips.reshape(-1, 2).sum(dim=1)
    return (pair_trips > 0).sum(dtype=torch.int32)


def active_tile_programs(count: torch.Tensor) -> torch.Tensor:
    """() — tiles with fragments: the unscheduled counterpart of
    :func:`active_programs`."""
    return (count > 0).sum(dtype=torch.int32)


def scheduled_trips(sched: TileSchedule) -> torch.Tensor:
    """() — total chunk trips the schedule streams (the WSU's subtile
    programs)."""
    return sched.trips.sum(dtype=torch.int32)
