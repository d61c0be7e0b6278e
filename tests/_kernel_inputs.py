"""Packed inputs of the tile-rasterizer kernels K1 and K2 and Gaussian ids
of GMU level 2's merge cases, drawn with numpy from a seed.  Imports neither
JAX nor torch, so the CPU parity tests, the card tests and ``chip_smoke.py``
all draw from these recipes."""

import numpy as np

TILE = 16


def random_attrs(seed, rows, cap, height, width, sparse=False, near_tile=False):
    """Packed (rows, 12, K) float32 attrs and (rows,) int32 counts of
    plausible Gaussians, the recipe of ``tests/test_kernels.py::_random_attrs``.

    Row ``r`` renders tile ``r % tiles`` of a ``height x width`` frame.  By
    default the centres lie anywhere in the frame, as in the reference's
    test.  With ``near_tile`` each centre is drawn at its row's tile origin
    plus U(-8, 24) pixels and the conic is scaled by 0.2 (splats ~2.2x
    wider), so that at any frame size the splats cover their tile: most
    tiles saturate, their pixels terminate and the kernels skip the
    remaining chunks (on 256 fragments, ~7/8 of the tiles and ~28% of the
    chunks), while the other tiles blend every fragment."""
    r = np.random.default_rng(seed)
    shape = (rows, cap)
    if near_tile:
        grid_w = width // TILE
        tile = np.arange(rows) % (grid_w * (height // TILE))
        px = (tile % grid_w * TILE)[:, None] + r.uniform(-8, 24, shape)
        py = (tile // grid_w * TILE)[:, None] + r.uniform(-8, 24, shape)
    else:
        px = r.uniform(0, width, shape)
        py = r.uniform(0, height, shape)
    ca = r.uniform(0.05, 0.6, shape)
    cc = r.uniform(0.05, 0.6, shape)
    cb = r.uniform(-1.0, 1.0, shape) * 0.9 * np.sqrt(ca * cc)
    if near_tile:
        ca, cb, cc = 0.2 * ca, 0.2 * cb, 0.2 * cc
    rgb = r.uniform(0, 1, (rows, 3, cap))
    o = r.uniform(0.2, 0.95, shape)
    depth = r.uniform(0.5, 5.0, shape)
    count = r.integers(0 if sparse else cap // 2, cap + 1, rows)
    present = np.arange(cap)[None, :] < count[:, None]
    attrs = np.stack([px, py, ca, cb, cc, rgb[:, 0], rgb[:, 1], rgb[:, 2], o,
                      depth, present, np.zeros(shape)], axis=1)
    return attrs.astype(np.float32), count.astype(np.int32)


def merge_case_ids(kind, m, n, seed):
    """(M,) int32 Gaussian ids of one GMU level-2 merge case: ``random`` in
    [-1, N); ``padding`` all -1; ``singles`` mostly padding and each id at
    most once, so runs have length 1; ``long`` one id over more than 3
    blocks of 256 sorted rows among random ones; ``one`` one id in every
    row, a single run over all blocks."""
    r = np.random.default_rng(seed)
    ids = r.integers(-1, n, m).astype(np.int32)
    if kind == "padding":
        ids[:] = -1
    elif kind == "singles":
        ids = r.permutation(np.arange(-m, n))[:m].clip(min=-1).astype(np.int32)
    elif kind == "long":
        ids[m // 8:m // 8 + 3 * 256 + 100] = n // 2
    elif kind == "one":
        ids[:] = n // 2
    return ids
