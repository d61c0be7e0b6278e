"""Tile intersection and per-tile depth-ordered fragment lists.

Counterpart of ``repro/core/sorting.py``: every tile owns ``K`` slots of
Gaussian indices in ascending depth order (``-1`` padding), built from one
global depth argsort and a (T, N) membership matrix.  ``idx``, ``count``,
``overflow`` and ``total`` equal the reference's bit for bit:

* ``jnp.argsort`` is stable and ``torch.argsort`` is not unless asked, so
  the depth sort passes ``stable=True`` (ties among invalid rows at +inf);
* the reference scatters every membership pair with dropped ones aimed at
  an out-of-range column (``mode="drop"``); here the kept ``(row, col)``
  pairs come from a fixed-size ``nonzero_static`` (at most ``K`` per tile),
  whose padding writes ``-1`` into one spare slot.  The build reads
  nothing back to the host, so a CUDA graph can capture it.

At the full slice size (1200 tiles x 131072 Gaussians) the membership is a
157 MB bool matrix plus a 629 MB int32 prefix sum per view; callers build
one view at a time.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.projection import ProjectedGaussians

TILE = 16


class TileGrid(NamedTuple):
    height: int
    width: int
    grid_h: int
    grid_w: int

    @property
    def num_tiles(self) -> int:
        return self.grid_h * self.grid_w


def make_tile_grid(height: int, width: int) -> TileGrid:
    if height % TILE or width % TILE:
        raise ValueError(f"image {height}x{width} must be a multiple of {TILE}")
    return TileGrid(height, width, height // TILE, width // TILE)


class FragmentLists(NamedTuple):
    idx: torch.Tensor       # (T, K) int32 Gaussian indices, -1 padded
    count: torch.Tensor     # (T,) int32 fragments per tile (<= K)
    overflow: torch.Tensor  # () int32 dropped fragments
    total: torch.Tensor     # () int32 intersections before the drop


def _tile_range(lo_hi: torch.Tensor, n: int) -> torch.Tensor:
    return torch.clamp(torch.floor(lo_hi / TILE), 0, n - 1).to(torch.int32)


@torch.no_grad()
def build_fragment_lists(proj: ProjectedGaussians, grid: TileGrid,
                         capacity: int,
                         keep: Optional[torch.Tensor] = None) -> FragmentLists:
    """Vectorized tile intersection + depth sort (index plumbing only).

    ``keep`` (an (N,) bool mask) drops rows from the lists altogether:
    sparse mapping passes ``~stable``, so frozen Gaussians emit no fragments
    and tiles only they cover get ``count == 0``.  An all-True ``keep``
    gives the lists of ``keep=None``."""
    mu2d, radius, valid = proj.mu2d, proj.radius, proj.valid
    if keep is not None:
        valid = valid & keep
    depth = proj.depth
    dev = mu2d.device
    n = mu2d.shape[0]
    order = torch.argsort(torch.where(valid, depth, float("inf")), stable=True)
    mu_s, rad_s, val_s = mu2d[order], radius[order], valid[order]

    tx0 = _tile_range(mu_s[:, 0] - rad_s, grid.grid_w)
    tx1 = _tile_range(mu_s[:, 0] + rad_s, grid.grid_w)
    ty0 = _tile_range(mu_s[:, 1] - rad_s, grid.grid_h)
    ty1 = _tile_range(mu_s[:, 1] + rad_s, grid.grid_h)

    ty = torch.arange(grid.grid_h, dtype=torch.int32, device=dev)[:, None]
    tx = torch.arange(grid.grid_w, dtype=torch.int32, device=dev)[:, None]
    in_y = (ty >= ty0[None]) & (ty <= ty1[None])   # (gh, N)
    in_x = (tx >= tx0[None]) & (tx <= tx1[None])   # (gw, N)
    m = (in_y[:, None, :] & in_x[None, :, :] & val_s[None, None, :]).reshape(
        grid.num_tiles, n)
    del in_y, in_x

    pos = torch.cumsum(m, dim=1, dtype=torch.int32)  # 1-based slot in tile
    last = pos[:, -1] if n else torch.zeros(grid.num_tiles, dtype=torch.int32,
                                            device=dev)
    total = last.sum(dtype=torch.int32)
    count = torch.clamp(last, max=capacity)
    overflow = torch.clamp(last - capacity, min=0).sum(dtype=torch.int32)

    keep = m & (pos <= capacity)
    del m
    slots = grid.num_tiles * capacity
    out = torch.full((slots + 1,), -1, dtype=torch.int32, device=dev)
    if n:
        rows, cols_n = torch.nonzero_static(keep, size=slots, fill_value=-1).unbind(1)
        kept = rows >= 0
        rows, cols_n = rows.clamp(min=0), cols_n.clamp(min=0)
        dest = torch.where(kept, rows * capacity + pos[rows, cols_n] - 1, slots)
        out[dest] = torch.where(kept, order[cols_n].to(torch.int32), -1)
    return FragmentLists(idx=out[:slots].view(grid.num_tiles, capacity), count=count,
                         overflow=overflow, total=total)


@torch.no_grad()
def count_skipped_fragments(proj: ProjectedGaussians, grid: TileGrid,
                            keep: torch.Tensor) -> torch.Tensor:
    """() int32: the tile-Gaussian intersections a ``keep``-masked
    :func:`build_fragment_lists` leaves out against the unmasked build.  A
    valid row's membership count is its clipped tile box's area, so this
    sums box areas over the valid rows ``keep`` drops: (N,) math, no (T, N)
    membership matrix.  Counted before the capacity cut, as ``total``."""
    mu2d, radius = proj.mu2d, proj.radius
    tx0 = _tile_range(mu2d[:, 0] - radius, grid.grid_w)
    tx1 = _tile_range(mu2d[:, 0] + radius, grid.grid_w)
    ty0 = _tile_range(mu2d[:, 1] - radius, grid.grid_h)
    ty1 = _tile_range(mu2d[:, 1] + radius, grid.grid_h)
    area = (tx1 - tx0 + 1) * (ty1 - ty0 + 1)
    dropped = proj.valid & ~keep
    return torch.where(dropped, area, torch.zeros_like(area)).sum(dtype=torch.int32)


def stack_fragment_lists(lists):
    """Stack per-view lists (or any NamedTuples of tensors, such as
    schedules) along a new leading axis."""
    return type(lists[0])(*(torch.stack(xs) for xs in zip(*lists)))


def tile_trips(count: torch.Tensor, chunk: int) -> torch.Tensor:
    """Chunk trips a per-tile loop streams: ``sum(ceil(count / chunk))``."""
    return torch.sum(torch.div(count + chunk - 1, chunk, rounding_mode="floor"))


def balanced_pair_permutation(count: torch.Tensor):
    """Heavy-light fold of tiles into balanced work pairs (the WSU's
    pairwise scheduling at tile granularity).

    Tiles are sorted by fragment count and the heaviest is paired with the
    lightest, the second-heaviest with the second-lightest, and so on.  For
    an odd tile count a zero-load duplicate of the lightest tile pads the
    schedule to an even number of slots; it always lands in slot 1.

    Returns ``(perm, load)``, both (S,) int32 with ``S = 2 * ceil(T / 2)``:
    ``perm[2p]`` / ``perm[2p+1]`` are pair ``p``'s heavy and light tiles and
    ``load`` the fragments each slot owes (0 for the pad).  The sort is
    stable, as ``jnp.argsort`` is: equal counts are common and keep their
    tile order, so ``perm`` equals the reference's bit for bit."""
    t = count.shape[0]
    p = (t + 1) // 2
    order = torch.argsort(count, stable=True).to(torch.int32)
    load = count[order.long()].to(torch.int32)
    if 2 * p != t:
        order = torch.cat([order[:1], order])
        load = torch.cat([torch.zeros(1, dtype=torch.int32, device=count.device),
                          load])
    light, light_load = order[:p], load[:p]
    heavy, heavy_load = order[p:].flip(0), load[p:].flip(0)
    perm = torch.stack([heavy, light], dim=1).reshape(-1)
    slot_load = torch.stack([heavy_load, light_load], dim=1).reshape(-1)
    return perm, slot_load
