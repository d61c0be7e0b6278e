"""PagedMap: spatially bucketed Gaussian storage and frustum-culled views
(counterpart of ``repro/slam/map/paged.py``).

The flat storage (one fixed-capacity ``GaussianField``) stays as it is; a
page table lies over it:

* every storage row, alive or dead, belongs to one of ``P = N / C`` pages
  of ``C`` rows (``PagedConfig.page_capacity``, a rung of
  :data:`PAGE_LADDER`);
* :func:`build_page_table` orders the alive rows by the Morton key of
  their quantized position and cuts the order into pages, so a page's
  members share a locale and its AABB (``lo`` / ``hi`` over its alive
  members) is tight.  Dead rows sort after every alive row: the emptiest
  pages (the nursery) hold densification's headroom;
* each frame, :func:`pages_visible` tests each page's AABB against the
  frusta of the predicted camera and of every keyframe of the mapping
  ring, and :func:`select_pages` picks exactly ``visible_pages`` pages:
  the visible ones first (the nearest when there are too many), then
  nursery pages.  The selection is sorted ascending, so when every page is
  selected the view is the identity and the paged step equals the flat
  one bit for bit;
* :func:`view_rows` turns the selection into the (M = ``visible_pages``
  * C,) storage rows of the view, which the session gathers, steps and
  scatters back.

Everything is fixed-shape tensor work that reads nothing back to the host,
so it runs inside the session's CUDA graphs: the sorts are stable
(``jnp.argsort`` is), empty pages' AABBs come from ``scatter_reduce``
into +-inf, and :func:`view_rows` scatters the rows off the view to a dump
slot instead of indexing with a mask.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch._device import constant
from repro_torch.core.camera import Intrinsics
from repro_torch.core.gaussians import GaussianField

#: Page capacities a config may choose (rows per page): a fixed menu, as
#: the serving tier's pool widths are.
PAGE_LADDER = (32, 64, 128, 256, 512, 1024)

#: Morton quantization: 10 bits per axis around a fixed origin, so an
#: unchanged map keys the same at every rebuild.
_MORTON_BITS = 10
_MORTON_SPAN = 1 << _MORTON_BITS
#: Dead rows' sort key, above every 30-bit alive key.
_DEAD_KEY = 1 << (3 * _MORTON_BITS)


class PagedConfig(NamedTuple):
    page_capacity: int = 128     # rows per page (C), from PAGE_LADDER
    visible_pages: int = 8       # pages per view; M = visible_pages * C
    cell: float = 0.25           # Morton quantization cell (world units)
    margin: float = 0.5          # frustum slack (world units)


class PageTable(NamedTuple):
    row2page: torch.Tensor   # (N,) int32 page of every storage row
    lo: torch.Tensor         # (P, 3) f32 AABB min over alive members (+inf if none)
    hi: torch.Tensor         # (P, 3) f32 AABB max over alive members (-inf if none)
    occupancy: torch.Tensor  # (P,) int32 alive members per page


def num_pages(capacity: int, pcfg: PagedConfig) -> int:
    return capacity // pcfg.page_capacity


def validate_paged(pcfg: PagedConfig, capacity: int) -> None:
    if pcfg.page_capacity not in PAGE_LADDER:
        raise ValueError(
            f"page_capacity {pcfg.page_capacity} is not on the static "
            f"ladder {PAGE_LADDER}")
    if capacity % pcfg.page_capacity != 0:
        raise ValueError(
            f"capacity {capacity} must be a multiple of page_capacity "
            f"{pcfg.page_capacity} (pages are fixed-size)")
    p = num_pages(capacity, pcfg)
    if not 1 <= pcfg.visible_pages <= p:
        raise ValueError(
            f"visible_pages {pcfg.visible_pages} must be in [1, {p}] "
            f"(= capacity {capacity} / page_capacity {pcfg.page_capacity})")


def ladder_page_capacity(capacity: int, min_pages: int = 4) -> int:
    """The largest :data:`PAGE_LADDER` rung that cuts ``capacity`` into at
    least ``min_pages`` pages (else the largest that divides it).  Kept
    for parity with the reference's API: the session takes its page
    capacity from the config and does not call it."""
    for rung in sorted(PAGE_LADDER, reverse=True):
        if capacity % rung == 0 and capacity // rung >= min_pages:
            return rung
    for rung in sorted(PAGE_LADDER, reverse=True):
        if capacity % rung == 0:
            return rung
    raise ValueError(
        f"no PAGE_LADDER rung {PAGE_LADDER} divides capacity {capacity}")


# ---------------------------------------------------------------------------
# the page table: Morton order cut into fixed-size pages
# ---------------------------------------------------------------------------


def _part1by2(x: torch.Tensor) -> torch.Tensor:
    """Spread a 10-bit integer over every third bit (int32 shifts)."""
    x = x & (_MORTON_SPAN - 1)
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton_keys(mu: torch.Tensor, cell: float) -> torch.Tensor:
    """(N,) int32 30-bit Morton keys of positions quantized to ``cell``."""
    # The clamp before the cast keeps far-off (or dead, garbage) positions
    # in int32's range; in range it changes nothing.
    q = torch.clamp(torch.floor(mu / cell), -2.0 ** 20, 2.0 ** 20).to(torch.int32)
    q = torch.clamp(q + _MORTON_SPAN // 2, 0, _MORTON_SPAN - 1)
    return (_part1by2(q[:, 0]) | (_part1by2(q[:, 1]) << 1)
            | (_part1by2(q[:, 2]) << 2))


def build_page_table(g: GaussianField, pcfg: PagedConfig) -> PageTable:
    """Every storage row's page and each page's AABB and occupancy: alive
    rows in Morton order, dead rows after them (stable sort: ties keep row
    order), cut into pages of ``page_capacity`` rows.  Storage never
    moves."""
    n, c, dev = g.capacity, pcfg.page_capacity, g.mu.device
    p = n // c
    key = torch.where(g.alive, morton_keys(g.mu, pcfg.cell),
                      torch.full((n,), _DEAD_KEY, dtype=torch.int32, device=dev))
    order = torch.sort(key, stable=True).indices
    row2page = torch.empty((n,), dtype=torch.int32, device=dev).index_copy_(
        0, order, torch.arange(n, dtype=torch.int32, device=dev) // c)
    index = row2page.to(torch.int64)
    alive3 = g.alive[:, None]
    inf = torch.full_like(g.mu, float("inf"))

    def reduce(vals, init, how):
        return torch.full((p, 3), init, dtype=torch.float32, device=dev).scatter_reduce_(
            0, index[:, None].expand(n, 3), vals, how, include_self=True)

    lo = reduce(torch.where(alive3, g.mu, inf), float("inf"), "amin")
    hi = reduce(torch.where(alive3, g.mu, -inf), float("-inf"), "amax")
    occ = torch.zeros((p,), dtype=torch.int32, device=dev).index_add_(
        0, index, g.alive.to(torch.int32))
    return PageTable(row2page=row2page, lo=lo, hi=hi, occupancy=occ)


# ---------------------------------------------------------------------------
# the frustum cull: page AABBs against the camera frusta
# ---------------------------------------------------------------------------


def frustum_planes(intr: Intrinsics, w2c: torch.Tensor, near: float = 0.05):
    """World-space inward half-spaces of a pinhole frustum: ``(m, b)`` with
    ``m`` (..., 5, 3) and ``b`` (..., 5) such that a world point ``x`` is
    inside iff ``m @ x >= b`` for all five planes (near, left, right, top,
    bottom; no far plane).  ``w2c`` is (4, 4) or (B, 4, 4)."""
    dev = w2c.device
    n_cam = constant([[0.0, 0.0, 1.0],
                      [intr.fx, 0.0, intr.cx],
                      [-intr.fx, 0.0, intr.width - intr.cx],
                      [0.0, intr.fy, intr.cy],
                      [0.0, -intr.fy, intr.height - intr.cy]], torch.float32, dev)
    d = constant([near, 0.0, 0.0, 0.0, 0.0], torch.float32, dev)
    r, t = w2c[..., :3, :3], w2c[..., :3, 3]
    m = n_cam @ r                                   # rows are R^T n
    b = d - (n_cam @ t[..., None])[..., 0]
    return m, b


def pages_visible(table: PageTable, intr: Intrinsics, w2cs: torch.Tensor,
                  near: float = 0.05, margin: float = 0.5) -> torch.Tensor:
    """(P,) bool: pages whose AABB meets any of the (B, 4, 4) ``w2cs``'
    frusta (the p-vertex test per plane), empty pages never."""
    m, b = frustum_planes(intr, w2cs, near=near)          # (B,5,3), (B,5)
    mm = m[:, :, None, :]
    v = torch.where(mm > 0, table.hi, table.lo)           # (B,5,P,3) p-vertex
    dots = (mm * v).sum(-1)                               # (B,5,P)
    vis = (dots >= (b[..., None] - margin)).all(dim=1).any(dim=0)
    return vis & (table.occupancy > 0)


# ---------------------------------------------------------------------------
# the selection and the view
# ---------------------------------------------------------------------------


def select_pages(visible: torch.Tensor, occupancy: torch.Tensor, v_max: int,
                 priority=None) -> torch.Tensor:
    """(v_max,) int32 ascending page ids of the frame's working set: the
    visible pages first, ranked by ``priority`` (lowest first; page id
    when None), then the least occupied of the others (the nursery)."""
    p, dev = visible.shape[0], visible.device
    ids = torch.arange(p, dtype=torch.int32, device=dev)
    if priority is None:
        rank = ids
    else:
        first = torch.sort(priority, stable=True).indices
        rank = torch.sort(first, stable=True).indices.to(torch.int32)
    key = torch.where(visible, rank, p + occupancy.to(torch.int32) * p + ids)
    chosen = torch.sort(key, stable=True).indices[:v_max]
    return torch.sort(chosen).values.to(torch.int32)


def page_distances(table: PageTable, w2c: torch.Tensor) -> torch.Tensor:
    """(P,) f32 squared distance from the camera centre to each page's AABB
    (0 inside it, inf for an empty page)."""
    rot, t = w2c[:3, :3], w2c[:3, 3]
    eye = -rot.T @ t
    nearest = torch.minimum(table.hi, torch.maximum(table.lo, eye[None, :]))
    d2 = ((nearest - eye[None, :]) ** 2).sum(-1)
    return torch.where(table.occupancy > 0, d2, torch.full_like(d2, float("inf")))


def view_rows(row2page: torch.Tensor, selected: torch.Tensor,
              page_capacity: int) -> torch.Tensor:
    """(M,) int64 storage rows of the view, M = len(selected) * C, in
    ascending storage order (``arange(N)`` when every page is selected).
    Rows off the view are written to a dump slot past the end."""
    n, dev = row2page.shape[0], row2page.device
    m = selected.shape[0] * page_capacity
    sel = torch.zeros((n // page_capacity,), dtype=torch.bool, device=dev)
    sel = sel.index_fill(0, selected.to(torch.int64), True)
    member = sel.index_select(0, row2page.to(torch.int64))
    rank = torch.cumsum(member.to(torch.int64), 0) - 1
    dest = torch.where(member, rank, torch.full_like(rank, m))
    rows = torch.full((m + 1,), -1, dtype=torch.int64, device=dev)
    rows.scatter_(0, dest, torch.arange(n, dtype=torch.int64, device=dev))
    return rows[:m]


def working_set(table: PageTable, intr: Intrinsics, w2c: torch.Tensor,
                kf_w2c: torch.Tensor, pcfg: PagedConfig) -> torch.Tensor:
    """The view's (M,) storage rows at the predicted pose ``w2c`` with the
    keyframe ring ``kf_w2c`` (W, 4, 4): the reference step's cull, select
    and ``view_rows`` (``repro/slam/session.py:484-492``)."""
    cams = torch.cat([w2c[None], kf_w2c], dim=0)
    vis = pages_visible(table, intr, cams, margin=pcfg.margin)
    selected = select_pages(vis, table.occupancy, pcfg.visible_pages,
                            priority=page_distances(table, w2c))
    return view_rows(table.row2page, selected, pcfg.page_capacity)


def gather_field(g: GaussianField, idx: torch.Tensor) -> GaussianField:
    """The rows ``idx`` of every leaf of ``g``."""
    return GaussianField(**{k: v.index_select(0, idx) for k, v in vars(g).items()})


def scatter_field(full: GaussianField, view: GaussianField,
                  idx: torch.Tensor) -> GaussianField:
    """``full`` with the view's rows written back at ``idx``."""
    return GaussianField(**{k: v.index_copy(0, idx, getattr(view, k))
                            for k, v in vars(full).items()})
