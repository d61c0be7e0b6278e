#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # the checks and the main path
    python3 chip_smoke.py profile    # the same, then torch.profiler tables

Run from the root of a checkout.  In order, it

1. prints the PyTorch version and the card's name and power limit;
2. builds the CUDA kernels K1 (forward tile rasterizer), K2 (backward),
   K4 and K5 (the two under a WSU schedule) and K3 (GMU level 2's adder:
   a row scan with a prefix-sum epilogue and a run-merge epilogue) from
   ``src/repro_torch/csrc`` with ``nvcc`` for ``sm_90a``, prints the
   ``-Xptxas -v`` lines and each kernel's registers and spills, and checks
   that K2, K5 and K3's merge at the main path's width spill nothing;
3. holds K1, K2, K4 and K5 against their plain PyTorch versions on the
   card at the slice's shapes (1200 tiles of a 640x480 frame, K=256
   fragments per tile, B=1 and B=4 stacked views), K4 and K5 gathered back
   to tile order against K1 and K2 bit for bit, and times all of them with
   CUDA events (K2 and K5 take K1's and K4's outputs, and the share of
   (warp, fragment) pairs their warp skips leave out and their achieved
   GB/s are printed); the packed attrs are wide splats near their own tile
   (``tests/_kernel_inputs``), so most tiles saturate and skip chunks while
   the rest blend them all; holds K3's scan against its plain version (bit
   for bit: the plain version adds in K3's order), a second launch and a
   float64 prefix sum at (307200, 10) and times it beside ``torch.cumsum``
   (K3 and ``index_add_`` as device time from CUDA-graph replays, since
   their kernels take less time than the host needs to launch them);
4. repeats the comparisons and times of step 3 on the packed attrs of a
   full-size ground-truth view (uneven tile loads), prints their tile-load
   and pair-load imbalance, and holds K3's merge (GMU level 2) on that
   view's K2 gradients, alone and as four views at once, against its plain
   version (bit for bit), a second launch and a float64 segment sum, and
   times it, the whole ``merge_views`` call and one ``index_add_`` of the
   valid rows;
5. renders the full-size ground-truth scene through the ``kernel`` backend
   and the pure-tensor ``ref`` backend and compares images and gradients;
   checks that the ``schedule`` backend equals the ``kernel`` backend bit
   for bit (images and per-Gaussian gradients, 1 and 4 views) and that a
   batched 4-view render equals four single-view renders;
6. runs a small session on the card and on the CPU from the same inputs
   and compares poses and PSNR;
7. runs the MonoGS SLAM session on the full-size room0 scene (640x480,
   12 frames, a 131072-Gaussian pool) with every launch counter set to 0
   just before, fused (the default: each phase's iterations replayed as a
   CUDA graph), and checks that K1, K2 and K3 carried it (one K3 merge per
   backward, counted through the replays), that no plain version ran, and
   that ATE < 0.30 m and mean keyframe PSNR > 17 dB; then ``[main-eager]``,
   the same session with ``fused=False``, which must equal it bit for bit
   with the same launches, and both once more in turns (fused, eager,
   eager, fused), printing ms per frame, dispatches, syncs and graph
   replays per tracking-only frame and keyframe;
8. runs the same session on the ``schedule`` backend, counters set to 0
   again, and checks that K4, K5 and K3 carried it (one K3 merge per
   backward; no K1, K2 or plain run), the same bounds, the same keyframes,
   and camera centres within 1 mm of step 7's; then [main]'s first frames
   on ``kernel_norb``, the RTGS session (pruning and downsampling, 640x448)
   on both backends and eager (``[rtgs-eager]``, equal bit for bit), and
   the other three base algorithms with RTGS;
9. ``[scenes]``: builds desk0, stairs0 and corridor0 at 640x480 through K1
   and holds K1, K2, K4 and K5 against their plain versions on one view of
   each;
10. ``[sparse]``: sparse stable/unstable mapping against dense on room0 and
    desk0 (640x480, 16 frames, ``schedule``), then sparse room0 on
    ``kernel``: the warmup poses equal dense bit for bit, ``kernel``
    equals ``schedule``, stable rows stay byte-frozen, the tail optimizes
    fewer Gaussians and schedules fewer programs, the PSNR loss is under
    0.35 dB, and K3 merges once per backward with no plain run;
11. ``[serve]``: a ``SlamServer`` over a ``ShardedPool`` of S=4 stacked
    sessions on [main]'s config (room0, desk0, stairs0, corridor0, 12
    frames each, fed through ``submit`` and ``pump``; stairs0 retired after
    its frame 6 and a fresh room1 session admitted in its slot), then S=2:
    every row equals its solo run bit for bit (room0's poses hash to
    [main]'s), a tracking-only frame-step is 1 dispatch, 0 syncs and 1
    graph replay for all rows, a keyframe frame-step adds [main]'s
    keyframe work per keyframe row, K1/K2/K3 launch the sum of the solo
    runs' launches and no plain version runs; prints ms per frame-step and
    aggregate frames/s at S=1, 2 and 4, capture ms and peak memory;
    ``[serve-prune]``: S=2 rows under [rtgs]'s pruning without
    downsampling, 8 frames, equal to their solo runs with the same
    boundaries; ``[sched]``: a ``PoolLadder`` of widths (1, 2, 4),
    ``warmup``, three streams through an ``IngestWorker`` thread with one
    migration S=1 -> S=2 while frames are queued; the runner census after
    serving equals the warmup's and every stream its solo run;
12. with ``profile``, traces the tail keyframe of each ``[sparse]`` run,
    then one tracking-only frame and one keyframe of a further full-size
    session, fused and eager, and one RTGS tracking frame with
    ``torch.profiler``, and prints the tables, each frame's
    ``cudaLaunchKernel`` and ``cudaGraphLaunch`` calls, dispatches, syncs
    and the device's idle share, and the time of ``aten::index_add_``,
    ``aten::sort`` and K3's kernels.

It prints one JSON line with every kernel's numbers, then the card's name
and power limit, then as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failed check raises, so the script exits non-zero and prints no result;
it also refuses to run without a CUDA device or outside a checkout.
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
TESTS = ROOT / "tests"

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s and fp32 FLOP/s
# outside the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12

# Arithmetic per (pixel, fragment) pair that a processed chunk needs.
# K1: dx, dy (2), the quadratic form (9), clamp and scale (2), exp (1),
# opacity and clips (4), the blend weight and four accumulations (11),
# the transmittance update (2).
OPS_K1 = 31
# K2: the replay and prefix (13), dL/dalpha (6), the chain to q and the 10
# per-pixel gradients (31), the sum over the tile's pixels (10), the
# transmittance update (2).  One pass: sum(w * s) and the final T come from
# the forward's outputs (9 operations per pixel, not per pair: not counted).
OPS_K2 = 62

H, W, K, CHUNK = 480, 640, 256, 16
FWD_ATOL, FWD_RTOL, DEPTH_TOL = 2e-5, 1e-4, 1e-4


class CheckFailed(AssertionError):
    pass


def require(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def log(*parts) -> None:
    print(*parts, flush=True)


def grad_atol(ref) -> float:
    return max(3e-6, 3e-5 * float(ref.abs().max()))


def max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def close(got, want, atol, rtol=0.0) -> bool:
    return bool(((got - want).abs() <= atol + rtol * want.abs()).all())


def bound(nbytes: int, ops: int):
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_FP32_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def processed_chunks(stash, count, chunk):
    """Chunks that K1 and K2 ran, per row: the block vote replayed from the
    stash in float64 (a chunk below its row's trip count runs while some
    pixel's transmittance is above 1e-4; a skipped chunk stashes zeros)."""
    import math
    import torch
    rows, cap, pix = stash.shape
    n = cap // chunk
    log_t = torch.log1p(-stash.double()).view(rows, n, chunk, pix).sum(2).cumsum(1)
    before = torch.cat([log_t.new_zeros(rows, 1, pix), log_t[:, :-1]], 1)
    alive = (before > math.log(1e-4)).any(-1)
    trips = torch.div(count + chunk - 1, chunk, rounding_mode="floor")
    return alive & (torch.arange(n, device=stash.device)[None] < trips[:, None])


def warp_skips(stash, count, chunk, group):
    """Shares of the (warp, fragment) pairs of processed chunks that K2 and
    K5 leave out: pairs no lane of the warp draws (their arithmetic is
    skipped), and pairs in a group of ``group`` fragments no lane draws
    (their shuffles are skipped too).  Replays the kernels' transmittance
    chain in float32."""
    import torch
    rows, cap, pix = stash.shape
    trips = torch.div(count + chunk - 1, chunk, rounding_mode="floor")
    trans = torch.ones((rows, pix), dtype=torch.float32, device=stash.device)
    idle = torch.zeros((rows, cap, pix // 32), dtype=torch.bool, device=stash.device)
    ran = torch.zeros((rows, cap), dtype=torch.bool, device=stash.device)
    for c in range(cap // chunk):
        live = (c < trips) & (trans > 1e-4).any(-1)
        ran[:, c * chunk:(c + 1) * chunk] = live[:, None]
        for k in range(c * chunk, (c + 1) * chunk):
            am = stash[:, k] * (trans > 1e-4).to(torch.float32)
            idle[:, k] = (am == 0).view(rows, -1, 32).all(-1)
            trans = trans * (1.0 - am)
    pairs = ran[:, :, None].expand_as(idle)
    in_idle_group = idle.view(rows, cap // group, group, -1).all(2, keepdim=True)
    in_idle_group = in_idle_group.expand(-1, -1, group, -1).reshape(idle.shape)
    return (float(idle[pairs].double().mean()),
            float(in_idle_group[pairs].double().mean()))


def graph_ms(fn, reps: int = 20) -> float:
    """Device time of one ``fn()``: ``reps`` calls captured in one CUDA
    graph, replayed, timed with CUDA events.  For calls whose kernels take
    less time than the host needs to launch them (K3, ``index_add_``),
    where :func:`cuda_ms` would time the host."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (5 * reps)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` launches, after warm-up."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


KERNEL_SYMBOLS = {"K1": "tile_render_fwd_kernel", "K2": "tile_render_bwd_kernel",
                  "K4": "tile_render_fwd_sched_kernel",
                  "K5": "tile_render_bwd_sched_kernel",
                  # K3 at the main path's width (G = 10 columns)
                  "K3 merge pass 1": "k3_totalsILb1ELi10E",
                  "K3 merge pass 2": "k3_rowsILb1ELi10E",
                  "K3 scan pass 1": "k3_totalsILb0ELi10E",
                  "K3 scan pass 2": "k3_rowsILb0ELi10E"}
NO_SPILLS = ("K2", "K5", "K3 merge pass 1", "K3 merge pass 2")  # the main path's


def ptxas_usage(report: str) -> dict:
    """{kernel symbol: (registers, spill store bytes, spill load bytes)}
    from an ``-Xptxas -v`` report."""
    import re
    usage, fn = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
            usage[fn] = [0, 0, 0]
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and fn:
            usage[fn][1:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            usage[fn][0] = int(m.group(1))
    return {k: tuple(v) for k, v in usage.items()}


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.build_all(force=True)
    log(f"[build] nvcc {' '.join(_build.NVCC_FLAGS)}: "
        f"{time.perf_counter() - t0:.1f} s")
    usage = {}
    for name in _build.SOURCES:
        for line in _build.PTXAS_REPORT[name].splitlines():
            if any(k in line for k in ("registers", "spill", "Compiling")):
                log(f"[build] {name}: {line.strip()}")
        usage.update(ptxas_usage(_build.PTXAS_REPORT[name]))
    for key, sym in KERNEL_SYMBOLS.items():
        found = [v for k, v in usage.items() if sym + "E" in k]
        require(len(found) == 1, f"ptxas reported no single {sym}: {sorted(usage)}")
        regs, st, ld = found[0]
        log(f"[build] {key} {sym}: {regs} registers, spill stores {st} B, "
            f"spill loads {ld} B")
        if key in NO_SPILLS:
            require(st == 0 and ld == 0, f"{key} spills: {st} B stored, {ld} B loaded")


def sched_flat(count, tiles: int, views: int):
    """Per-view schedules ``build_schedule(count, 16, max_trips=16)`` of
    stacked rows, flattened for K4/K5 (perms offset to global rows), and the
    int64 gather from slot order back to tile order."""
    import torch
    from repro_torch.core.schedule import build_schedule
    perms, trips, invs, scheds = [], [], [], []
    for b in range(views):
        s = build_schedule(count[b * tiles:(b + 1) * tiles], CHUNK,
                           max_trips=K // CHUNK)
        perms.append(s.perm + b * tiles)
        trips.append(s.trips)
        invs.append(s.inv.long() + b * s.perm.shape[0])
        scheds.append(s)
    return torch.cat(perms), torch.cat(trips), torch.cat(invs), scheds


def check_fwd(name, got, want, label):
    import torch
    for out, g, w_ in zip(("color", "depth", "final_T", "stash"), got, want):
        tol = DEPTH_TOL if out == "depth" else FWD_ATOL
        rtol = DEPTH_TOL if out == "depth" else FWD_RTOL
        require(bool(torch.isfinite(g).all()), f"{name} {out} not finite ({label})")
        require(close(g, w_, tol, rtol),
                f"{name} {out} disagrees with plain ({label}): max |d| {max_err(g, w_):.3g}")
    return max(max_err(g, w_) for g, w_ in zip(got, want))


def check_bwd(name, got, want, label):
    import torch
    require(bool(torch.isfinite(got).all()), f"{name} grads not finite ({label})")
    atol = grad_atol(want)
    require(close(got, want, atol),
            f"{name} disagrees with plain ({label}): max |d| {max_err(got, want):.3g} > {atol:.3g}")
    return max_err(got, want)


def raster_suite(dev, grid, attrs, count, views, label, seed):
    """K1, K2, K4 and K5 on one set of packed attrs: each against its plain
    version, K4/K5 gathered by ``inv`` against K1/K2 bit for bit, CUDA-event
    times and bounds.  Returns {name: numbers} and K2's gradients."""
    import numpy as np
    import torch
    from repro_torch.kernels.tile_render import (
        raise_on_sched_fault, tile_render_fwd, tile_render_fwd_plain,
        tile_render_fwd_sched, tile_render_fwd_sched_plain)
    from repro_torch.kernels.tile_render_bp import (
        REDUCE_GROUP, tile_render_bwd, tile_render_bwd_plain,
        tile_render_bwd_sched, tile_render_bwd_sched_plain)

    tiles = grid.num_tiles
    kw = dict(chunk=CHUNK, tiles_per_view=tiles)
    perm, trips, inv, _ = sched_flat(count, tiles, views)

    got = tile_render_fwd(attrs, count, grid, **kw)
    err1 = check_fwd("K1", got, tile_render_fwd_plain(attrs, count, grid, **kw), label)
    got4 = tile_render_fwd_sched(attrs, perm, trips, grid, **kw)
    err4 = check_fwd("K4", got4, tile_render_fwd_sched_plain(attrs, perm, trips, grid, **kw),
                     label)
    for out, g4, g1 in zip(("color", "depth", "final_T", "stash"), got4, got):
        require(torch.equal(g4[inv], g1), f"K4 {out} gathered by inv is not K1's ({label})")
    stash = got[3]

    r = np.random.default_rng(seed)
    rows = views * tiles
    g_color = torch.as_tensor(r.normal(size=(rows, 3, 256)).astype(np.float32), device=dev)
    g_depth = torch.as_tensor(r.normal(size=(rows, 256)).astype(np.float32), device=dev)
    g_finalt = torch.as_tensor(r.normal(size=(rows, 256)).astype(np.float32), device=dev)
    bargs = (attrs, count, *got, g_color, g_depth, g_finalt, grid)
    got2 = tile_render_bwd(*bargs, **kw)
    err2 = check_bwd("K2", got2, tile_render_bwd_plain(*bargs, **kw), label)
    pl = perm.long()
    sargs = (attrs, perm, trips, *got4, g_color[pl].contiguous(),
             g_depth[pl].contiguous(), g_finalt[pl].contiguous(), grid)
    got5 = tile_render_bwd_sched(*sargs, **kw)
    err5 = check_bwd("K5", got5, tile_render_bwd_sched_plain(*sargs, **kw), label)
    require(torch.equal(got5[inv], got2), f"K5 gathered by inv is not K2's ({label})")
    torch.cuda.synchronize()
    raise_on_sched_fault(dev)

    # Bounds count what this data needs: the forward reads the attrs of the
    # chunks it runs and writes every output (zeros included); the backward
    # reads the attrs and stash of those chunks, the forward's color, depth
    # and final T and the cotangents, and writes every gradient.  K4/K5
    # also read their perm and trips.
    ran = processed_chunks(stash, count, CHUNK)
    n_ran = int(ran.sum())
    n_trips = int(torch.div(count + CHUNK - 1, CHUNK, rounding_mode="floor").sum())
    saturated = float((got[2].amax(1) <= 1e-4).double().mean())
    pairs = n_ran * CHUNK * 256
    elt = 4
    fwd_bytes = elt * (n_ran * CHUNK * 12 + count.numel() + sum(t.numel() for t in got))
    bwd_bytes = elt * (n_ran * CHUNK * (12 + 256) + count.numel()
                       + sum(t.numel() for t in got[:3]) + g_color.numel()
                       + g_depth.numel() + g_finalt.numel() + got2.numel())
    slot_extra = elt * (perm.numel() + trips.numel() - count.numel())
    bounds = {"K1": bound(fwd_bytes, pairs * OPS_K1),
              "K4": bound(fwd_bytes + slot_extra, pairs * OPS_K1),
              "K2": bound(bwd_bytes, pairs * OPS_K2),
              "K5": bound(bwd_bytes + slot_extra, pairs * OPS_K2)}
    calls = {
        "K1": (lambda: tile_render_fwd(attrs, count, grid, **kw),
               lambda: tile_render_fwd_plain(attrs, count, grid, **kw), err1),
        "K4": (lambda: tile_render_fwd_sched(attrs, perm, trips, grid, **kw),
               lambda: tile_render_fwd_sched_plain(attrs, perm, trips, grid, **kw), err4),
        "K2": (lambda: tile_render_bwd(*bargs, **kw),
               lambda: tile_render_bwd_plain(*bargs, **kw), err2),
        "K5": (lambda: tile_render_bwd_sched(*sargs, **kw),
               lambda: tile_render_bwd_sched_plain(*sargs, **kw), err5),
    }
    out = {}
    for name, (kernel, plain, err) in calls.items():
        b, by = bounds[name]
        out[name] = dict(max_abs_err=err, ms=cuda_ms(kernel, 40),
                         plain_ms=cuda_ms(plain, 2), bound_ms=b, bound_by=by)
    frag_skip, group_skip = warp_skips(stash, count, CHUNK, REDUCE_GROUP)
    log(f"[kernels] {label}: {n_ran} of {n_trips} chunks below the trip count ran, "
        f"{100 * saturated:.1f}% of tiles saturated; K4 == K1 and K5 == K2 bitwise "
        f"after inv; backward warp skips: {100 * frag_skip:.1f}% of (warp, fragment) "
        f"pairs drawn by no lane, {100 * group_skip:.1f}% in idle groups of "
        f"{REDUCE_GROUP}")
    for name, o in out.items():
        rate = (f", {bwd_bytes / o['ms'] / 1e6:.0f} GB/s of the backward's bytes"
                if name in ("K2", "K5") else "")
        log(f"[kernels] {label}: {name} {o['ms']:.3f} ms (plain {o['plain_ms']:.1f} ms, "
            f"bound {o['bound_ms']:.3f} ms by {o['bound_by']}, max |d| "
            f"{o['max_abs_err']:.2e}{rate})")
    return out, got2


def phase_kernels(dev):
    """K1, K2, K4 and K5 against their plain versions at the slice's shapes."""
    import torch
    from repro_torch.core.sorting import make_tile_grid

    from _kernel_inputs import random_attrs

    grid = make_tile_grid(H, W)
    rows_out = {}
    for views in (1, 4):
        a_np, c_np = random_attrs(42 + views, views * grid.num_tiles, K, H, W,
                                  near_tile=True)
        attrs = torch.as_tensor(a_np, device=dev)
        count = torch.as_tensor(c_np, device=dev)
        out, _ = raster_suite(dev, grid, attrs, count, views,
                              f"near-tile B={views}", 7 + views)
        for name, o in out.items():
            rows_out[(name, views)] = o
        del attrs, count, out
        torch.cuda.empty_cache()
    return rows_out


def cumsum_bound_ratio(got, x):
    """Worst |got - exact| / (1e-5 * prefix of |x| + 1e-6) per column,
    with ``exact`` the float64 prefix sum of the same input."""
    import torch
    exact = torch.cumsum(x.double(), 0)
    scale = torch.cumsum(x.double().abs(), 0)
    return float(((got.double() - exact).abs() / (1e-5 * scale + 1e-6)).max())


def phase_gmu(dev):
    """K3's scan against its plain version, a second launch and a float64
    prefix sum at the slice's shape, (1200 * 256, 10), timed beside torch's
    own scans."""
    import numpy as np
    import torch
    from repro_torch.kernels import gmu

    m, g = H // 16 * W // 16 * K, 10
    x = torch.as_tensor(np.random.default_rng(5).normal(size=(m, g)).astype(np.float32),
                        device=dev)
    got = gmu.block_cumsum(x)
    again = gmu.block_cumsum(x)
    want = gmu.block_cumsum_plain(x)
    torch.cuda.synchronize()
    ratio = cumsum_bound_ratio(got, x)
    require(ratio <= 1.0, f"K3 scan off a float64 prefix sum: {ratio:.3g} of its bound")
    err = max_err(got, want)
    require(torch.equal(got, want), f"K3 scan differs from its plain version: max |d| {err:.3g}")
    require(torch.equal(got, again), "K3 scan differs between two launches")
    b, by = bound(2 * 4 * m * g, m * g)   # one read and one write; one add each
    res = dict(max_abs_err=err, ms=graph_ms(lambda: gmu.block_cumsum(x)),
               host_ms=cuda_ms(lambda: gmu.block_cumsum(x), 40),
               plain_ms=cuda_ms(lambda: gmu.block_cumsum_plain(x), 5),
               bound_ms=b, bound_by=by,
               library_ms=cuda_ms(lambda: torch.cumsum(x, 0), 5),
               inner_ms=graph_ms(lambda: torch.cumsum(x.t().contiguous(), 1).t()))
    log(f"[kernels] K3 scan ({m}, {g}): {res['ms']:.4f} ms of device time (a call "
        f"{res['host_ms']:.4f} ms with the host's launches, plain {res['plain_ms']:.3f} ms, "
        f"bound {b:.4f} ms by {by}, bitwise equal to plain and across launches); worst "
        f"error {ratio:.3f} of 1e-5 x prefix|x| + 1e-6 from a float64 prefix sum; "
        f"torch.cumsum(x, 0) {res['library_ms']:.3f} ms, transposed inner-dim "
        f"cumsum {res['inner_ms']:.3f} ms")
    return res


def gt_view(dev, ds, factor=1, frame=3):
    """Projection and fragment lists of the ground-truth scene seen from
    ``frame``'s pose, at ``1 / factor`` of the dataset's resolution per side."""
    import torch
    from repro_torch.core.camera import Camera
    from repro_torch.core.projection import project
    from repro_torch.core.sorting import build_fragment_lists, make_tile_grid

    intr = ds.intrinsics.scaled(factor)
    grid = make_tile_grid(intr.height, intr.width)
    cam = Camera(intr, torch.as_tensor(ds.frames[frame].w2c_gt, device=dev))
    with torch.no_grad():
        proj = project(ds.gt_field, cam)
        frags = build_fragment_lists(proj, grid, K)
    return grid, proj, frags


def view_attrs(proj, frags):
    import torch
    from repro_torch.kernels import ops
    with torch.no_grad():
        attrs = ops._pack_attrs(proj.mu2d, proj.conic, proj.color, proj.opacity,
                                proj.depth, frags.idx).contiguous()
    return attrs, frags.count.contiguous()


def phase_real_view(dev, ds):
    """The kernel suite on the packed attrs of a real view, its load
    imbalance, and GMU level 2 (K3's merge) on that view's K2 gradients."""
    from repro_torch.core.schedule import pair_loads
    from repro_torch.slam.metrics import imbalance_stats

    grid, proj, frags = gt_view(dev, ds)
    attrs, count = view_attrs(proj, frags)
    out, grads = raster_suite(dev, grid, attrs, count, 1, "real view B=1", 17)
    _, _, _, scheds = sched_flat(count, grid.num_tiles, 1)
    tile_l, pair_l = imbalance_stats(count), imbalance_stats(pair_loads(scheds[0]))
    log(f"[kernels] real view: {int(frags.total)} fragments, tile loads max "
        f"{tile_l.max_load:.0f} / mean {tile_l.mean_load:.2f} (tail ratio "
        f"{tile_l.tail_ratio:.2f}), pair loads max {pair_l.max_load:.0f} / mean "
        f"{pair_l.mean_load:.2f} (tail ratio {pair_l.tail_ratio:.2f})")

    n = proj.mu2d.shape[0]
    merge = {views: merge_suite(dev, grads, frags.idx.reshape(1, -1), n, views)
             for views in (1, 4)}
    return out, merge


def merge_suite(dev, grads, ids, n, views):
    """K3's merge (GMU level 2) on one view's K2 gradients (T, 10, K) and
    ids (1, T*K), repeated ``views`` times as the mapping window's one
    merge: against its plain version (bit for bit), a second launch and a
    float64 segment sum; each copy equal to the first; times beside the
    whole ``merge_views`` call and one ``index_add_`` of the valid rows."""
    import torch
    from repro_torch.kernels import gmu

    tiles, g, cap = grads.shape
    grads = grads.repeat(views, 1, 1).contiguous()
    ids = ids.repeat(views, 1).contiguous()
    offs = torch.arange(views, dtype=torch.int32, device=dev)[:, None] * (n + 1)
    keys_s, order = torch.sort((torch.where(ids >= 0, ids, n) + offs).reshape(-1),
                               stable=True)
    before = gmu.merge_runs.launches
    got = gmu.merge_views(grads, ids, n)
    require(gmu.merge_runs.launches == before + 1, "merge_views did not launch one K3 merge")
    again = gmu.merge_runs(grads, order, keys_s, views, n)
    want = gmu.merge_runs_plain(grads, order, keys_s, views, n)
    torch.cuda.synchronize()
    label = f"real view B={views}"
    err = max_err(got, want)
    require(torch.equal(got, want), f"K3 merge differs from its plain version ({label}): "
            f"max |d| {err:.3g}")
    require(torch.equal(got, again), f"K3 merge differs between two launches ({label})")
    require(all(torch.equal(got[b], got[0]) for b in range(views)),
            f"K3 merge's copies of one view differ ({label})")
    # A run sum is a difference of two K3 prefix sums, so it may be off by
    # twice the prefix bound.
    flat = grads[:tiles].transpose(1, 2).reshape(-1, g)
    ok = ids[0] >= 0
    exact = torch.zeros((n, g), dtype=torch.float64, device=dev)
    exact.index_add_(0, ids[0][ok].long(), flat[ok].double())
    tol = 2 * (1e-5 * float(flat[ok].double().abs().sum(0).max()) + 1e-6)
    e = float((got[0].double() - exact).abs().max())
    require(e <= tol, f"K3 merge off a float64 segment sum by {e:.3g} > {tol:.3g}")

    # What this data needs: one read of the valid sorted rows and of every
    # key, the zero fill of (B, N, G), and one end and one start add of G
    # floats per unique Gaussian; one add per valid element.
    valid = int(ok.sum()) * views
    seg = keys_s.long() - torch.arange(views, device=dev).repeat_interleave(
        tiles * cap) * (n + 1)
    live = seg < n
    differs = keys_s[1:] != keys_s[:-1]
    one = torch.ones((1,), dtype=torch.bool, device=dev)
    boundary = int(((torch.cat([one, differs]) | torch.cat([differs, one])) & live).sum())
    unique = int((torch.cat([one, differs]) & live).sum())
    b, by = bound(4 * (valid * g + keys_s.numel() + views * n * g + 2 * unique * g),
                  valid * g)
    rows = torch.cat([grads[v * tiles:(v + 1) * tiles].transpose(1, 2).reshape(-1, g)[ok]
                      for v in range(views)])
    dest = torch.cat([ids[v][ok].long() + v * n for v in range(views)])
    acc = torch.zeros((views * n, g), dtype=torch.float32, device=dev)
    res = dict(max_abs_err=err, ms=graph_ms(lambda: gmu.merge_runs(grads, order, keys_s,
                                                                    views, n)),
               call_ms=graph_ms(lambda: gmu.merge_views(grads, ids, n)),
               host_ms=cuda_ms(lambda: gmu.merge_views(grads, ids, n), 40),
               plain_ms=cuda_ms(lambda: gmu.merge_runs_plain(grads, order, keys_s,
                                                             views, n), 2),
               library_ms=graph_ms(lambda: acc.index_add_(0, dest, rows)),
               bound_ms=b, bound_by=by, unique=unique // views,
               boundary_share=boundary / keys_s.numel())
    log(f"[kernels] K3 merge, {label}: {res['ms']:.4f} ms of device time (zero fill "
        f"and kernel; whole merge_views call {res['call_ms']:.4f} ms, {res['host_ms']:.4f} "
        f"ms with the host's launches; plain {res['plain_ms']:.1f} ms, bound {b:.4f} ms "
        f"by {by}, index_add_ of the valid rows {res['library_ms']:.4f} ms); bitwise equal "
        f"to plain and across launches; {valid // views} valid rows and {res['unique']} "
        f"Gaussians per view, {100 * res['boundary_share']:.2f}% of rows are run "
        f"boundaries; max |d| {e:.2e} from a float64 segment sum, bound {tol:.2e}")
    return res


def make_scene(dev, name="room0", frames=12, height=H):
    import torch
    from repro_torch.slam.datasets import make_dataset
    t0 = time.perf_counter()
    ds = make_dataset(name, num_frames=frames, height=height, width=W,
                      num_gaussians=16384, frag_capacity=K, device=dev)
    torch.cuda.synchronize()
    log(f"[dataset] {name} {W}x{height}, {frames} frames, 16384 Gaussians: "
        f"{time.perf_counter() - t0:.2f} s")
    for f in ds.frames:
        require(bool(torch.isfinite(f.rgb).all() and torch.isfinite(f.depth).all()),
                "dataset frame not finite")
    return ds


def raster_with_grads(inputs, plan, backend, target):
    """Images and the gradients of every raster input of one rasterize
    call under ``backend``."""
    import dataclasses
    import torch
    from repro_torch.core.raster_api import RasterInputs
    from repro_torch.kernels import ops

    leaves = [x.detach().clone().requires_grad_(True) for x in inputs[:5]]
    img, dep, ft = ops.rasterize(RasterInputs(*leaves, frags=inputs.frags),
                                 dataclasses.replace(plan, backend=backend))
    loss = ((img - target) ** 2).mean() + 0.1 * dep.mean() + 0.05 * ft.mean()
    grads = torch.autograd.grad(loss, leaves)
    return (img.detach(), dep.detach(), ft.detach()), grads


def phase_render(dev, ds):
    """The kernel backend against the ref backend, and the schedule and
    kernel_norb backends against the kernel backend, on the full-size
    scene; then the two kernel backwards timed."""
    import numpy as np
    import torch
    from repro_torch.core.camera import Camera
    from repro_torch.core.projection import ProjectedGaussians, project
    from repro_torch.core.raster_api import RasterInputs, RasterPlan
    from repro_torch.core.render import render
    from repro_torch.core.sorting import build_fragment_lists, stack_fragment_lists

    grid, proj, frags = gt_view(dev, ds)
    plan = RasterPlan(grid=grid, capacity=K)
    target = torch.as_tensor(np.random.default_rng(3).uniform(
        size=(H, W, 3)).astype(np.float32), device=dev)
    inputs = RasterInputs.from_projection(proj, frags)
    outs, grads = {}, {}
    for backend in ("kernel", "schedule", "kernel_norb", "ref"):
        outs[backend], grads[backend] = raster_with_grads(inputs, plan, backend, target)
        torch.cuda.empty_cache()
    for name, g, w_ in zip(("color", "depth", "final_T"), outs["kernel"], outs["ref"]):
        tol = DEPTH_TOL if name == "depth" else FWD_ATOL
        rtol = DEPTH_TOL if name == "depth" else FWD_RTOL
        require(close(g, w_, tol, rtol),
                f"kernel render {name} disagrees with ref: max |d| {max_err(g, w_):.3g}")
    worst = 0.0
    leaves = ("mu2d", "conic", "color", "opacity", "depth")
    for name, g, w_ in zip(leaves, grads["kernel"], grads["ref"]):
        atol = grad_atol(w_)
        require(close(g, w_, atol),
                f"kernel gradient of {name} disagrees with ref: max |d| "
                f"{max_err(g, w_):.3g} > {atol:.3g}")
        worst = max(worst, max_err(g, w_) / atol)
    log(f"[render] kernel vs ref at {W}x{H}, {int(frags.total)} fragments "
        f"({int(frags.overflow)} over K={K}): images within {FWD_ATOL}/{FWD_RTOL}, "
        f"gradients within max(3e-6, 3e-5 max|g|) (worst at {worst:.2f} of it)")

    def require_equal(a, b, what, backend="schedule"):
        for name, x, y in zip(what, a, b):
            require(torch.equal(x, y), f"{backend} backend {name} differs from kernel's: "
                    f"max |d| {max_err(x, y):.3g}")

    for backend in ("schedule", "kernel_norb"):
        require_equal(outs[backend], outs["kernel"], ("color", "depth", "final_T"), backend)
        require_equal(grads[backend], grads["kernel"], leaves, backend)
    del outs, grads

    # Four stacked views: the schedule backend equals the kernel backend.
    poses = torch.stack([torch.as_tensor(ds.frames[i].w2c_gt, device=dev)
                         for i in (0, 4, 8, 11)])
    with torch.no_grad():
        projs = [project(ds.gt_field, Camera(ds.intrinsics, p)) for p in poses]
        frags4 = stack_fragment_lists([build_fragment_lists(p, grid, K) for p in projs])
    inputs4 = RasterInputs.from_projection(
        ProjectedGaussians(*(torch.stack(xs) for xs in zip(*projs))), frags4)
    o_k, g_k = raster_with_grads(inputs4, plan, "kernel", target)
    for backend in ("schedule", "kernel_norb"):
        o_s, g_s = raster_with_grads(inputs4, plan, backend, target)
        require_equal(o_s, o_k, ("color", "depth", "final_T"), backend)
        require_equal(g_s, g_k, leaves, backend)
    log(f"[render] schedule and kernel_norb backends == kernel backend bitwise at "
        f"{W}x{H}, 1 and 4 views: images and per-Gaussian gradients")
    del o_k, g_k, o_s, g_s
    times = {1: backward_times(dev, inputs, grid), 4: backward_times(dev, inputs4, grid)}
    del inputs4
    torch.cuda.empty_cache()

    # Batched: one stacked launch over 4 views equals 4 single-view renders.
    plan = RasterPlan(grid=grid, backend="kernel", capacity=K)
    with torch.no_grad():
        batched = render(ds.gt_field, Camera(ds.intrinsics, poses), plan, device=dev)
        for b in range(4):
            single = render(ds.gt_field, Camera(ds.intrinsics, poses[b]), plan,
                            device=dev)
            require(torch.equal(batched.image[b], single.image)
                    and torch.equal(batched.depth[b], single.depth),
                    f"batched render view {b} differs from its single-view render")
    log("[render] 4-view batched render is bitwise equal to 4 single-view renders")
    return times


def backward_times(dev, inputs, grid):
    """Device time of the kernel backends' whole backward (cotangents to
    tiles, K2, GMU level 2) from CUDA-graph replays: on K1's kept outputs
    (``kernel``, the R&B Buffer) and with K1 re-run first (``kernel_norb``)."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.tile_render import tile_render_fwd

    views = inputs.views
    nv = views or 1
    with torch.no_grad():
        attrs = ops._pack_views(*inputs[:5], inputs.frags.idx, views).contiguous()
        cnt = inputs.frags.count.reshape(-1).contiguous()
        fwd = tile_render_fwd(attrs, cnt, grid, chunk=CHUNK, tiles_per_view=grid.num_tiles)
    r = np.random.default_rng(21)
    lead = () if views is None else (nv,)
    cot = [torch.as_tensor(r.normal(size=lead + shape).astype(np.float32), device=dev)
           for shape in ((grid.height, grid.width, 3), (grid.height, grid.width),
                         (grid.height, grid.width))]
    n = inputs.mu2d.shape[-2]

    def run(kept):
        return lambda: ops.kernel_backward(attrs, cnt, inputs.frags.idx, kept, *cot, grid,
                                           CHUNK, views, n)

    with torch.no_grad():
        out = {"kernel": graph_ms(run(fwd), reps=10), "kernel_norb": graph_ms(run(None), reps=10)}
    log(f"[render] backward at {W}x{H}, B={nv}: kernel {out['kernel']:.4f} ms, kernel_norb "
        f"(K1 re-run) {out['kernel_norb']:.4f} ms of device time (CUDA-graph replays); the "
        f"R&B Buffer saves {out['kernel_norb'] - out['kernel']:.4f} ms per backward")
    return out


def small_dataset(dev):
    """The 64x64 room0 scene, made on the CPU and copied to ``dev``."""
    from repro_torch.slam.datasets import make_dataset
    ds = make_dataset("room0", num_frames=6, height=64, width=64,
                      num_gaussians=400, frag_capacity=48, device="cpu")
    if str(dev) != "cpu":
        for f in ds.frames:
            f.rgb, f.depth = f.rgb.to(dev), f.depth.to(dev)
    return ds


def centre_distance(a, b) -> float:
    import numpy as np
    return max(float(np.linalg.norm(np.linalg.inv(x)[:3, 3] - np.linalg.inv(y)[:3, 3]))
               for x, y in zip(a, b))


def phase_small_session(dev):
    """A 64x64 session on the card and on the CPU from the same inputs."""
    import numpy as np
    import torch
    from repro_torch.core.keyframes import KeyframePolicy
    from repro_torch.slam.session import SLAMConfig, run_sequence

    cfg = SLAMConfig(iters_track=3, iters_map=4, capacity=1024, frag_capacity=48,
                     map_window=2, keyframe=KeyframePolicy(interval=2))
    rng = np.random.default_rng(11)
    perms = {i: rng.permutation(2 * cfg.densify_per_kf) for i in range(1, 6)}
    res = {}
    for d in ("cpu", dev):
        res[str(d)] = run_sequence(small_dataset(d), cfg, device=d,
                                   perms={k: torch.as_tensor(v) for k, v in perms.items()})
    a, b = res["cpu"], res[str(dev)]
    pose_d = max(float(np.abs(x - y).max()) for x, y in zip(a.est_w2c, b.est_w2c))
    centre_d = centre_distance(a.est_w2c, b.est_w2c)
    psnr_d = abs(a.mean_psnr - b.mean_psnr)
    log(f"[small] 64x64 room0, 6 frames: card vs CPU pose entries within "
        f"{pose_d:.2e}, camera centres within {centre_d * 1e3:.2f} mm, mean PSNR "
        f"{b.mean_psnr:.3f} vs {a.mean_psnr:.3f} dB, ATE {b.ate * 100:.2f} vs "
        f"{a.ate * 100:.2f} cm")
    # The card sums in other orders than the CPU (K2's warp tree, cuBLAS),
    # and five frames of optimization grow those last-bit differences: on an
    # H100 80GB HBM3 the camera centres read 0.19-0.33 mm apart (pose
    # entries up to 2.9e-3) in three runs with a torch.cumsum prefix in GMU
    # level 2, and 0.53 mm (pose entries up to 8.8e-3) with K3's prefix,
    # whose plain version adds in K3's order.
    require(centre_d < 1e-3, f"card and CPU camera centres differ by {centre_d:.3g} m")
    require(psnr_d < 0.1, f"card and CPU PSNR differ by {psnr_d:.3g} dB")
    for backend in ("kernel", "schedule"):
        small_rtgs(dev, backend, perms)


class SelectionRecorder:
    """Keeps the scores and the alive set of the last pruning boundary
    while it is entered (it wraps ``pruning.interval_update``)."""

    def __enter__(self):
        from repro_torch.core import pruning
        self.inner, self.last = pruning.interval_update, None

        def recorded(state, g, tile_count, cfg):
            self.last = (state.score.clone(), (g.alive & ~state.masked).clone())
            return self.inner(state, g, tile_count, cfg)

        recorded.host_reads = 0
        pruning.interval_update = recorded
        return self

    def __exit__(self, *exc):
        from repro_torch.core import pruning
        pruning.interval_update = self.inner


def near_cut(score, alive, want):
    """Alive rows whose selection score lies within 1e-5 of the cut (the
    ``want``-th lowest alive score), relative to the larger of the cut and
    the largest alive score (most cuts sit at 0)."""
    import torch
    s = score[alive]
    if want == 0 or s.numel() == 0:
        return torch.zeros_like(alive)
    cut = torch.sort(s).values[want - 1]
    scale = torch.maximum(cut.abs(), s.abs().max())
    return alive & ((score - cut).abs() <= 1e-5 * scale)


def small_rtgs(dev, backend, perms):
    """The 64x64 card-vs-CPU session with §4.1 pruning and §4.2
    downsampling on: camera centres within 1 mm, the same Gaussians
    removed, and after every frame masked sets equal outside near-ties at
    the last selection cut."""
    import numpy as np
    import torch
    from repro_torch.core.downsample import DownsampleConfig
    from repro_torch.core.keyframes import KeyframePolicy
    from repro_torch.core.pruning import PruneConfig
    from repro_torch.slam.session import (
        SLAMConfig, frame_factor, session_finalize, session_init, session_step)

    cfg = SLAMConfig(iters_track=3, iters_map=4, capacity=1024, frag_capacity=48,
                     map_window=2, keyframe=KeyframePolicy(interval=2), backend=backend,
                     prune=PruneConfig(k0=2, step_frac=0.08),
                     downsample=DownsampleConfig(enabled=True))
    out = {}
    for d in ("cpu", dev):
        ds = small_dataset(d)
        masks = []      # per frame: the masked set and the rows near its cut
        with SelectionRecorder() as rec:
            sess, last, factors = session_init(ds, cfg, device=d), 0, []
            for idx in range(1, ds.num_frames):
                factors.append(frame_factor(ds, idx, last, cfg))
                sess, r = session_step(sess, ds.frames[idx], factor=factors[-1],
                                       perm=torch.as_tensor(perms[idx]))
                last = idx if r.is_kf else last
                masked = sess.pstate.masked.cpu()
                near = (near_cut(rec.last[0].cpu(), rec.last[1].cpu(), int(masked.sum()))
                        if rec.last is not None else torch.zeros_like(masked))
                masks.append((masked, near))
        res = session_finalize(sess, gt_w2c=[f.w2c_gt for f in ds.frames])
        out[str(d)] = (res, masks, factors)
    (a, ma, fa), (b, mb, fb) = out["cpu"], out[str(dev)]
    centre_d = centre_distance(a.est_w2c, b.est_w2c)
    differ = [x[0] != y[0] for x, y in zip(ma, mb)]
    near = [x[1] | y[1] for x, y in zip(ma, mb)]
    log(f"[small] RTGS on {backend}, factors {fb}: card vs CPU camera centres within "
        f"{centre_d * 1e3:.2f} mm, removed {b.prune_removed} vs {a.prune_removed}, "
        f"alive {b.alive_per_frame} vs {a.alive_per_frame}; masked per frame "
        f"{[int(m.sum()) for m, _ in mb]} vs {[int(m.sum()) for m, _ in ma]}, rows that "
        f"differ {[int(x.sum()) for x in differ]}, rows within 1e-5 of the selection cut "
        f"{[int(x.sum()) for x in near]}")
    require(fa == fb, f"card and CPU factors differ: {fb} vs {fa}")
    require(centre_d < 1e-3, f"RTGS card and CPU camera centres differ by {centre_d:.3g} m")
    require(a.prune_removed == b.prune_removed > 0,
            f"RTGS card and CPU removed {b.prune_removed} vs {a.prune_removed}")
    require(not any(bool((x & ~y).any()) for x, y in zip(differ, near)),
            "RTGS card and CPU masked sets differ away from the selection cut")
    require(np.isfinite(b.ate), "RTGS small session ATE not finite")


def launch_counters():
    """Every kernel wrapper's launch counter (K3 twice: its merge and its
    scan epilogue) and every plain version's call counter, by name."""
    from repro_torch.kernels import gmu
    from repro_torch.kernels import tile_render as fwd
    from repro_torch.kernels import tile_render_bp as bwd
    kernels = {"K1": fwd.tile_render_fwd, "K2": bwd.tile_render_bwd,
               "K3": gmu.merge_runs, "K3 scan": gmu.block_cumsum,
               "K4": fwd.tile_render_fwd_sched, "K5": bwd.tile_render_bwd_sched}
    plains = (fwd.tile_render_fwd_plain, bwd.tile_render_bwd_plain,
              gmu.merge_runs_plain, gmu.block_cumsum_plain,
              fwd.tile_render_fwd_sched_plain, bwd.tile_render_bwd_sched_plain)
    return kernels, plains


def frame_split(stats_rows, kf_flags, step_ms):
    """Mean ms, dispatches, syncs and graph replays of the tracking-only
    frames and of the keyframes that captured no graph, from per-step
    ``EngineStats`` deltas."""
    import numpy as np
    out = {}
    for kind in ("tracking", "keyframe"):
        idx = [i for i, k in enumerate(kf_flags)
               if i > 0 and k == (kind == "keyframe") and not stats_rows[i].captures]
        out[kind] = {
            "ms": float(np.mean([step_ms[i] for i in idx])) if idx else float("nan"),
            **{f: float(np.mean([getattr(stats_rows[i], f) for i in idx]))
               if idx else float("nan") for f in ("dispatches", "syncs", "replays")}}
    return out


def split_text(split) -> str:
    return "; ".join(
        f"{kind} {v['ms']:.1f} ms, {v['dispatches']:.1f} dispatches, {v['syncs']:.1f} "
        f"syncs, {v['replays']:.1f} graph replays" for kind, v in split.items())


def phase_main(dev, ds, backend="kernel", fused=True, label=None):
    """The MonoGS session on the full-size scene under ``backend``, fused
    (phases as CUDA graph replays) or eager, every counter set to 0 just
    before; returns its launches, results, keyframes, per-frame launches
    and the per-frame split of times and counts."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.slam.graphs import EngineStats
    from repro_torch.slam.session import (
        SLAMConfig, session_finalize, session_init, session_step)

    tag = label or ("[main]" if backend == "kernel" else f"[main-{backend[:5]}]")
    cfg = SLAMConfig(capacity=131072, frag_capacity=K, map_window=4,
                     iters_track=12, iters_map=24, backend=backend, fused=fused)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels, plains = reset_counters()
    stats = EngineStats()
    t_run = time.perf_counter()
    sess = session_init(ds, cfg, device=dev, stats=stats)
    torch.cuda.synchronize()
    step_ms, kf_flags = [(time.perf_counter() - t_run) * 1e3], [True]
    per_frame = [{k: fn.launches for k, fn in kernels.items()}]
    stats_rows = [dataclasses.replace(stats)]
    for idx in range(1, ds.num_frames):
        before = dataclasses.replace(stats)
        t0 = time.perf_counter()
        sess, out = session_step(sess, ds.frames[idx], stats=stats)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        kf_flags.append(bool(out.is_kf))
        per_frame.append({k: fn.launches for k, fn in kernels.items()})
        stats_rows.append(stats.since(before))
    wall = time.perf_counter() - t_run
    res = session_finalize(sess, gt_w2c=[f.w2c_gt for f in ds.frames],
                           wall_time_s=wall, stats=stats)
    launches = {k: fn.launches for k, fn in kernels.items()}
    plain_calls = sum(fn.calls for fn in plains)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    frames = ds.num_frames
    kf_ms = [t for t, k in zip(step_ms[1:], kf_flags[1:]) if k]
    tr_ms = [t for t, k in zip(step_ms[1:], kf_flags[1:]) if not k]
    keyframes = [i for i, k in enumerate(kf_flags) if k]
    split = frame_split(stats_rows, kf_flags, step_ms)
    log(f"{tag} room0 {W}x{H}, {frames} frames, capacity {cfg.capacity}, "
        f"K={K}, window {cfg.map_window}, backend {backend}, "
        f"{'fused' if fused else 'eager'}: wall {wall:.2f} s, "
        f"{wall * 1e3 / frames:.1f} ms per frame (init+boot {step_ms[0]:.0f} ms, "
        f"tracking-only frame {np.mean(tr_ms):.1f} ms, keyframe "
        f"{np.mean(kf_ms) if kf_ms else float('nan'):.1f} ms); run totals "
        f"{res.dispatches} dispatches, {res.syncs} syncs, {stats.replays} graph "
        f"replays, {stats.captures} captures; per frame without a capture: "
        f"{split_text(split)}; frames that captured a graph: "
        + (", ".join(f"{i} {step_ms[i]:.1f} ms" for i in range(1, frames)
                     if stats_rows[i].captures) or "none"))
    digest = hashlib.sha256(np.ascontiguousarray(np.stack(res.est_w2c)).tobytes())
    log(f"{tag} ATE {res.ate * 100:.2f} cm, mean keyframe PSNR {res.mean_psnr:.2f} dB "
        f"({', '.join(f'{p:.2f}' for p in res.keyframe_psnr)}), keyframes "
        f"{keyframes}, alive {res.alive_per_frame[-1]}, poses sha256 "
        f"{digest.hexdigest()[:16]}")
    log(f"{tag} launches: " + ", ".join(
        f"{k} {v} ({v / frames:.2f} per frame)" for k, v in launches.items())
        + f", plain versions {plain_calls}; peak device memory {peak_gb:.2f} GB; "
        f"cached-list fragments {int(sess.frags.total)}, overflow "
        f"{int(sess.frags.overflow)}; launched through graph replays: "
        f"{sess.runner.replayed_launches}; work {res.work}")
    ours = ("K1", "K2", "K3") if backend == "kernel" else ("K4", "K5", "K3")
    others = [k for k in ("K1", "K2", "K4", "K5") if k not in ours]
    require(all(launches[k] > 0 for k in ours),
            f"the {backend} path did not launch {ours}: {launches}")
    require(launches["K3"] == launches[ours[1]],
            f"the {backend} path ran {launches['K3']} K3 merges for "
            f"{launches[ours[1]]} backwards")
    require(all(launches[k] == 0 for k in others),
            f"the {backend} path launched {others}: {launches}")
    require(plain_calls == 0, f"the main path ran a plain version {plain_calls} times")
    require(np.isfinite(res.ate) and res.ate < 0.30, f"ATE {res.ate:.3f} m >= 0.30 m")
    require(res.mean_psnr > 17.0, f"mean keyframe PSNR {res.mean_psnr:.2f} dB <= 17")
    require((stats.replays > 0) == fused,
            f"{tag} fused={fused} made {stats.replays} graph replays")
    return launches, res, keyframes, per_frame, dict(
        split=split, peak_gb=peak_gb, ms=wall * 1e3 / frames,
        replayed=dict(sess.runner.replayed_launches), sess=sess,
        digest=digest.hexdigest()[:16])


def phase_main_eager(dev, ds, main):
    """``[main-eager]``: the same session with ``fused=False``, equal to
    ``[main]`` bit for bit with the same kernel launches; then the two
    again in turns (fused, eager, eager, fused), for ms per frame within
    one call."""
    import numpy as np
    launches, res, kfs, _, info = phase_main(dev, ds, fused=False, label="[main-eager]")
    m_launches, m_res, m_kfs, _, m_info = main
    same = (all(np.array_equal(a, b) for a, b in zip(res.est_w2c, m_res.est_w2c))
            and res.keyframe_psnr == m_res.keyframe_psnr and kfs == m_kfs
            and res.work == m_res.work)
    log(f"[main-eager] vs [main]: poses, PSNR, keyframes and work equal bit for bit: "
        f"{same}; launches equal: {launches == m_launches}; dispatches {res.dispatches} "
        f"vs {m_res.dispatches}, syncs {res.syncs} vs {m_res.syncs}")
    require(same, "[main-eager] differs from [main]")
    require(launches == m_launches,
            f"[main-eager] launches {launches} != [main]'s {m_launches}")
    turns = [("fused", m_info), ("eager", info)]
    for fused in (False, True):
        *_, again = phase_main(dev, ds, fused=fused,
                               label="[main]" if fused else "[main-eager]")
        turns.append(("fused" if fused else "eager", again))
    log("[main] fused / eager in turns (fused, eager, eager, fused), ms per frame, "
        "tracking-only frame and keyframe ms: " + "; ".join(
            f"{mode} {t['ms']:.1f} / {t['split']['tracking']['ms']:.1f} / "
            f"{t['split']['keyframe']['ms']:.1f}" for mode, t in turns))
    return launches, turns


def phase_main_sched(dev, ds, main_res, main_keyframes):
    """The same session on the WSU ``schedule`` backend, against [main]."""
    import numpy as np
    launches, res, keyframes, _, info = phase_main(dev, ds, backend="schedule")
    require(keyframes == main_keyframes,
            f"schedule session keyframes {keyframes} != kernel session's {main_keyframes}")
    pose_d = max(float(np.abs(a - b).max()) for a, b in zip(res.est_w2c, main_res.est_w2c))
    centre_d = max(float(np.linalg.norm(np.linalg.inv(a)[:3, 3] - np.linalg.inv(b)[:3, 3]))
                   for a, b in zip(res.est_w2c, main_res.est_w2c))
    # K4/K5 equal K1/K2 bit for bit and every other op is the same, so the
    # two sessions are expected to be identical.
    log(f"[main-sched] vs [main]: largest pose entry difference {pose_d:.3g}, "
        f"camera centres within {centre_d * 1e3:.4f} mm, same keyframes")
    require(centre_d < 1e-3, f"schedule and kernel camera centres differ by {centre_d:.3g} m")
    return launches, info["replayed"]


RTGS_H = 448     # TUM's 640x480 less 32 rows: 64-divisible, as §4.2 needs
RTGS_FACTORS = [4, 2, 2, 2, 2, 2, 2, 1, 4, 2, 2]   # frames 1-11, keyframe 8


def reset_counters():
    """Every launch and plain-version counter set to 0, and every phase
    runner's count of launches made by graph replays (sessions of one
    config share a runner across phases)."""
    from repro_torch.slam.session import cached_runners
    kernels, plains = launch_counters()
    for fn in kernels.values():
        fn.launches = 0
    for fn in plains:
        fn.calls = 0
    for runner in cached_runners():
        runner.replayed_launches = dict.fromkeys(runner.replayed_launches, 0)
    return kernels, plains


def rtgs_config(backend="kernel", **kw):
    """The reference's RTGS variant (``benchmarks/table6_quality.py``) at
    the main path's sizes."""
    from repro_torch.core.downsample import DownsampleConfig
    from repro_torch.core.pruning import PruneConfig
    from repro_torch.slam.session import SLAMConfig
    return SLAMConfig(capacity=131072, frag_capacity=K, map_window=4, iters_track=12,
                      iters_map=24, prune=PruneConfig(k0=5, step_frac=0.08),
                      downsample=DownsampleConfig(enabled=True), backend=backend, **kw)


def phase_new_grids(dev, ds):
    """K1, K2, K4 and K5 against their plain versions on a ground-truth
    view of the 640x448 scene at the tracking grids of factors 2 and 4."""
    out = {}
    for factor in (2, 4):
        grid, proj, frags = gt_view(dev, ds, factor)
        attrs, count = view_attrs(proj, frags)
        label = (f"{W // factor}x{RTGS_H // factor} view ({grid.num_tiles} tiles, "
                 f"factor {factor}, {int(frags.total)} fragments, overflow "
                 f"{int(frags.overflow)})")
        out[factor], _ = raster_suite(dev, grid, attrs, count, 1, label, 30 + factor)
    return out


def phase_rtgs(dev, ds, backend="kernel", fused=True):
    """The RTGS session (MonoGS + §4.1 pruning + §4.2 downsampling) on the
    640x448 scene under ``backend``, fused or eager, each frame at the
    factor ``run_sequence`` chooses, every counter set to 0 just before."""
    import numpy as np
    import torch
    from repro_torch.core import pruning
    from repro_torch.slam.graphs import EngineStats
    from repro_torch.slam.session import (
        frame_factor, session_finalize, session_init, session_step)

    tag = "[rtgs" + ("" if backend == "kernel" else "-sched") + ("" if fused else "-eager") + "]"
    cfg = rtgs_config(backend, fused=fused)
    stats = EngineStats()
    fwd_k, bwd_k = ("K1", "K2") if backend == "kernel" else ("K4", "K5")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels, plains = reset_counters()
    reads0 = pruning.interval_update.host_reads
    t0 = time.perf_counter()
    sess = session_init(ds, cfg, device=dev, stats=stats)
    torch.cuda.synchronize()
    init_ms, rows, last = (time.perf_counter() - t0) * 1e3, [], 0
    for idx in range(1, ds.num_frames):
        factor = frame_factor(ds, idx, last, cfg)
        # The frame's tracking lists, built again outside the timed step
        # (no kernel runs in a build): how far they overflow K.
        with torch.no_grad():
            pre = sess.stage_at(factor)._build_core(sess.g, sess.cur_masked,
                                                    sess.velocity @ sess.pose)
        before = {k: fn.launches for k, fn in kernels.items()}
        counts0 = EngineStats(**vars(stats))
        t0 = time.perf_counter()
        sess, out = session_step(sess, ds.frames[idx], factor=factor, stats=stats)
        torch.cuda.synchronize()
        rows.append(dict(idx=idx, factor=factor, kf=out.is_kf,
                         ms=(time.perf_counter() - t0) * 1e3,
                         counts=stats.since(counts0),
                         fired=int(out.fired.sum()), alive=int(out.alive),
                         overflow=int(pre.overflow), frags=int(pre.total),
                         launches={k: fn.launches - before[k] for k, fn in kernels.items()}))
        last = idx if out.is_kf else last
    res = session_finalize(sess, gt_w2c=[f.w2c_gt for f in ds.frames], stats=stats)
    launches = {k: fn.launches for k, fn in kernels.items()}
    plain_calls = sum(fn.calls for fn in plains)
    host_reads = pruning.interval_update.host_reads - reads0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    factors = [r["factor"] for r in rows]
    keyframes = [0] + [r["idx"] for r in rows if r["kf"]]
    groups = {}
    for r in rows:
        groups.setdefault("keyframe" if r["kf"] else f"factor {r['factor']}", []).append(r)
    log(f"{tag} room0 {W}x{RTGS_H}, {ds.num_frames} frames, capacity {cfg.capacity}, "
        f"K={K}, backend {backend}, factors {factors}: init+boot {init_ms:.0f} ms, "
        + ", ".join(f"{k} {np.mean([r['ms'] for r in v]):.1f} ms ({len(v)} frames)"
                    for k, v in sorted(groups.items()))
        + f"; {np.mean([r['ms'] for r in rows]):.1f} ms per tracked frame; "
        + ", ".join(f"{k} {np.mean([r['counts'].dispatches for r in v]):.1f} dispatches "
                    f"{np.mean([r['counts'].syncs for r in v]):.1f} syncs "
                    f"{np.mean([r['counts'].replays for r in v]):.1f} graph replays"
                    for k, v in sorted(groups.items()))
        + f"; run totals {res.dispatches} dispatches, {res.syncs} syncs, "
        f"{stats.replays} graph replays")
    fired = [r["fired"] for r in rows]
    log(f"{tag} pruning boundaries fired per frame {fired} ({sum(fired)} in all), "
        f"{host_reads} host reads for them; alive per frame {res.alive_per_frame}; "
        f"removed {res.prune_removed}")
    by_factor = {}
    for r in rows:
        by_factor.setdefault(r["factor"], []).append((r["overflow"], r["frags"]))
    log(f"{tag} tracking fragment lists at the frame's start, (overflow, fragments) "
        "per frame: " + "; ".join(f"factor {f}: {v}" for f, v in sorted(by_factor.items())))
    tiles = {f: (W // f // 16) * (RTGS_H // f // 16) for f in (1, 2, 4)}
    at_grid = {f: [r["launches"][fwd_k] for r in rows if r["factor"] == f and not r["kf"]]
               for f in (2, 4)}
    at_grid[1] = [r["launches"][fwd_k] for r in rows if r["kf"]]
    digest = hashlib.sha256(np.ascontiguousarray(np.stack(res.est_w2c)).tobytes())
    log(f"{tag} ATE {res.ate * 100:.2f} cm, mean keyframe PSNR {res.mean_psnr:.2f} dB, "
        f"keyframes {keyframes}, poses sha256 {digest.hexdigest()[:16]}; launches "
        + ", ".join(f"{k} {v}" for k, v in launches.items())
        + f", plain versions {plain_calls}; {fwd_k} launches per frame at "
        + ", ".join(f"{tiles[f]} tiles {at_grid[f]}" for f in (4, 2, 1))
        + f"; peak device memory {peak_gb:.2f} GB; launched through graph replays: "
        f"{sess.runner.replayed_launches}; work {res.work}")
    full = W * RTGS_H
    pixels_f1 = res.work.pixels + cfg.iters_track * sum(
        full - (W // r["factor"]) * (RTGS_H // r["factor"]) for r in rows)
    log(f"{tag} pixels {res.work.pixels} against {pixels_f1} at factor 1 "
        f"({100 * res.work.pixels / pixels_f1:.1f}%)")
    require(factors == RTGS_FACTORS, f"{tag} factors {factors} != {RTGS_FACTORS}")
    others = [k for k in ("K1", "K2", "K4", "K5") if k not in (fwd_k, bwd_k)]
    require(all(launches[k] > 0 for k in (fwd_k, bwd_k, "K3")),
            f"{tag} did not launch {fwd_k}, {bwd_k} and K3: {launches}")
    require(all(launches[k] == 0 for k in others), f"{tag} launched {others}: {launches}")
    require(launches["K3"] == launches[bwd_k],
            f"{tag} ran {launches['K3']} K3 merges for {launches[bwd_k]} backwards")
    require(all(v and all(n > 0 for n in v) for v in at_grid.values()),
            f"{tag} a factor's frames launched no {fwd_k}: {at_grid}")
    require(plain_calls == 0, f"{tag} ran a plain version {plain_calls} times")
    require(np.isfinite(res.ate) and res.ate < 0.30, f"{tag} ATE {res.ate:.3f} m >= 0.30 m")
    require(res.mean_psnr > 17.0, f"{tag} mean keyframe PSNR {res.mean_psnr:.2f} dB <= 17")
    require(res.prune_removed > 0, f"{tag} removed no Gaussian")
    require(res.work.pixels < pixels_f1, f"{tag} pixels not below the factor-1 count")
    require(host_reads == sum(fired), f"{tag} {host_reads} host reads for {sum(fired)} boundaries")
    require((stats.replays > 0) == fused, f"{tag} made {stats.replays} graph replays")
    return launches, res, keyframes, rows


def phase_rtgs_eager(dev, ds, rtgs):
    """``[rtgs-eager]``: the RTGS session with ``fused=False``, equal to
    ``[rtgs]`` bit for bit with the same launches; prints both runs' ms per
    tracking frame by factor."""
    import numpy as np
    launches, res, keyframes, rows = phase_rtgs(dev, ds, fused=False)
    f_launches, f_res, f_keyframes, f_rows = rtgs
    same = (all(np.array_equal(a, b) for a, b in zip(res.est_w2c, f_res.est_w2c))
            and keyframes == f_keyframes and res.prune_removed == f_res.prune_removed
            and res.work == f_res.work)

    def by_factor(rs):
        steady = [r for r in rs if not r["kf"] and not r["counts"].captures]
        return ", ".join(
            f"factor {f} {np.mean([r['ms'] for r in steady if r['factor'] == f]):.1f}"
            for f in (4, 2)) + "; frames that captured a graph: " + (", ".join(
                f"{r['idx']} (factor {r['factor']}) {r['ms']:.1f}" for r in rs
                if r["counts"].captures) or "none")

    log(f"[rtgs-eager] vs [rtgs]: equal bit for bit: {same}, launches equal: "
        f"{launches == f_launches}; tracking-only ms per frame, fused: {by_factor(f_rows)}; "
        f"eager: {by_factor(rows)}")
    require(same, "[rtgs-eager] differs from [rtgs]")
    require(launches == f_launches, f"[rtgs-eager] launches {launches} != {f_launches}")


def phase_rtgs_sched(dev, ds, rtgs_res, rtgs_keyframes):
    """The RTGS session on the WSU ``schedule`` backend, against [rtgs]."""
    import numpy as np
    launches, res, keyframes, _ = phase_rtgs(dev, ds, backend="schedule")
    pose_d = max(float(np.abs(a - b).max()) for a, b in zip(res.est_w2c, rtgs_res.est_w2c))
    centre_d = centre_distance(res.est_w2c, rtgs_res.est_w2c)
    log(f"[rtgs-sched] vs [rtgs]: largest pose entry difference {pose_d:.3g}, camera "
        f"centres within {centre_d * 1e3:.4f} mm, keyframes {keyframes}, removed "
        f"{res.prune_removed} vs {rtgs_res.prune_removed}")
    require(keyframes == rtgs_keyframes,
            f"[rtgs-sched] keyframes {keyframes} != [rtgs]'s {rtgs_keyframes}")
    require(res.prune_removed == rtgs_res.prune_removed,
            f"[rtgs-sched] removed {res.prune_removed} != [rtgs]'s {rtgs_res.prune_removed}")
    require(centre_d < 1e-3, f"[rtgs-sched] camera centres {centre_d:.3g} m from [rtgs]'s")
    return launches


def phase_norb(dev, ds, main_res, main_per_frame):
    """The first 4 frames of [main] on ``kernel_norb``: the same poses bit
    for bit, with K1 launched once more per backward."""
    import numpy as np
    import torch
    from repro_torch.slam.graphs import EngineStats
    from repro_torch.slam.session import SLAMConfig, session_init, session_step

    cfg = SLAMConfig(capacity=131072, frag_capacity=K, map_window=4, iters_track=12,
                     iters_map=24, backend="kernel_norb")
    kernels, plains = reset_counters()
    stats = EngineStats()
    t0 = time.perf_counter()
    sess = session_init(ds, cfg, device=dev, stats=stats)
    for idx in range(1, 4):
        sess, _ = session_step(sess, ds.frames[idx], stats=stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in kernels.items()}
    plain_calls = sum(fn.calls for fn in plains)
    traj = sess.traj[:4].cpu().numpy()
    main4 = main_per_frame[3]
    log(f"[norb] [main]'s first 4 frames on kernel_norb: {wall * 1e3 / 4:.1f} ms per frame, "
        f"{stats.dispatches} dispatches, {stats.syncs} syncs, {stats.replays} graph replays "
        f"(launching {sess.runner.replayed_launches}); "
        f"launches {launches} against [main]'s {main4}; poses equal to [main]'s: "
        f"{bool(np.array_equal(traj, np.stack(main_res.est_w2c[:4])))}")
    require(np.array_equal(traj, np.stack(main_res.est_w2c[:4])),
            "[norb] poses differ from [main]'s first 4")
    require(launches["K2"] == main4["K2"] and launches["K3"] == main4["K3"],
            f"[norb] backwards {launches['K2']} != [main]'s {main4['K2']}")
    require(launches["K1"] == main4["K1"] + launches["K2"],
            f"[norb] K1 {launches['K1']} != forwards {main4['K1']} + backwards "
            f"{launches['K2']}")
    require(plain_calls == 0 and launches["K4"] == launches["K5"] == 0,
            f"[norb] ran a plain version or K4/K5: {launches}, plain {plain_calls}")
    return launches


def phase_algos(dev, ds, frames=6):
    """GS-SLAM, Photo-SLAM and SplaTAM with RTGS on, on the first
    ``frames`` frames of the 640x448 scene (``tests/test_system.py``'s
    bounds)."""
    import numpy as np
    import torch
    from repro_torch.core.keyframes import KeyframePolicy
    from repro_torch.slam.datasets import SLAMDataset
    from repro_torch.slam.session import run_sequence

    part = SLAMDataset(ds.name, ds.intrinsics, ds.frames[:frames], ds.gt_field)
    policies = {"gsslam": KeyframePolicy(kind="gsslam", trans_thresh=0.08, rot_thresh=0.08),
                "photoslam": KeyframePolicy(kind="photoslam", pho_thresh=0.04),
                "splatam": KeyframePolicy(kind="splatam")}
    out = {}
    for algo, policy in policies.items():
        cfg = rtgs_config(base_algo=algo, keyframe=policy)
        kernels, plains = reset_counters()
        res = run_sequence(part, cfg, device=dev)
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in kernels.items()}
        plain_calls = sum(fn.calls for fn in plains)
        log(f"[algos] {algo} + RTGS, {W}x{RTGS_H}, {frames} frames: "
            f"{res.wall_time_s * 1e3 / frames:.1f} ms per frame, ATE {res.ate * 100:.2f} cm, "
            f"mean keyframe PSNR {res.mean_psnr:.2f} dB, {len(res.keyframe_psnr)} keyframes, "
            f"removed {res.prune_removed}, alive {res.alive_per_frame}; {res.dispatches} "
            f"dispatches, {res.syncs} syncs; launches {launches}, "
            f"plain versions {plain_calls}; work {res.work}")
        require(all(launches[k] > 0 for k in ("K1", "K2", "K3")),
                f"[algos] {algo} did not launch K1, K2 and K3: {launches}")
        require(launches["K3"] == launches["K2"], f"[algos] {algo}: one K3 merge per backward")
        require(plain_calls == 0, f"[algos] {algo} ran a plain version {plain_calls} times")
        require(np.isfinite(res.ate) and res.ate < 0.6, f"[algos] {algo} ATE {res.ate:.3f} m")
        require(res.mean_psnr > 14.0, f"[algos] {algo} PSNR {res.mean_psnr:.2f} dB <= 14")
        out[algo] = launches
    return out


NEW_SCENES = ("desk0", "stairs0", "corridor0")


def phase_scenes(dev):
    """desk0, stairs0 and corridor0 at 640x480 (4 frames, 16384 ground-truth
    Gaussians each), rendered through K1 on the card with the counters set
    to 0 just before: fragments per view, the tile-load tail ratio (max /
    mean of the counts) and the empty tiles; then K1, K2, K4 and K5 against
    their plain versions on the packed attrs of frame 3's view, whose tile
    loads no earlier phase had.  Returns the kernels' numbers and the
    builds' launches."""
    import numpy as np
    out, built = {}, {}
    for name in NEW_SCENES:
        kernels, plains = reset_counters()
        ds = make_scene(dev, name, frames=4)
        launches = {k: fn.launches for k, fn in kernels.items()}
        plain_calls = sum(fn.calls for fn in plains)
        require(launches["K1"] == 4 and plain_calls == 0,
                f"[scenes] {name} not built through K1: {launches}, plain {plain_calls}")
        built = {k: built.get(k, 0) + v for k, v in launches.items()}
        views = []
        for idx in range(4):
            _, _, frags = gt_view(dev, ds, frame=idx)
            c = frags.count.double()
            views.append((int(frags.total), int(frags.overflow), float(c.max() / c.mean()),
                          int((frags.count == 0).sum())))
        log(f"[scenes] {name} {W}x{H}: per view (fragments, over K={K}, tile-load tail "
            f"ratio, empty tiles) {[(t, o, round(r, 2), e) for t, o, r, e in views]}, "
            f"mean {np.mean([v[0] for v in views]):.0f} fragments per view")
        grid, proj, frags = gt_view(dev, ds, frame=3)
        attrs, count = view_attrs(proj, frags)
        out[name], _ = raster_suite(dev, grid, attrs, count, 1,
                                    f"{name} view 3 ({int(frags.total)} fragments)", 40)
        del ds, attrs, count, proj, frags
    return out, built


# The sparse run: the reference bench's configuration
# (``benchmarks/bench_sparse.py:69-85``) at the main path's sizes.
SPARSE_FRAMES = 16
SPARSE_TAIL = SPARSE_FRAMES - 1 - 2      # the post-warmup tail: the last 3 steps
SPARSE_WARMUP = (SPARSE_TAIL - 1) * 12 + 1


def sparse_config(backend, sparse):
    from repro_torch.core.keyframes import KeyframePolicy
    from repro_torch.core.pruning import PruneConfig
    from repro_torch.slam.session import SLAMConfig
    return SLAMConfig(capacity=131072, frag_capacity=512, map_window=4, iters_track=12,
                      iters_map=24, keyframe=KeyframePolicy(kind="monogs", interval=2),
                      backend=backend, sparse_opt=sparse,
                      prune=PruneConfig(k0=3, step_frac=0.1, stable_ema_beta=0.6,
                                        stable_rel=4.0, stable_age=4,
                                        stable_warmup=SPARSE_WARMUP))


def sparse_run(dev, ds, backend, sparse, profile=False):
    """One 16-frame session of the sparse configuration, every counter set
    to 0 just before: per-step times and work, the tail's sums, launches,
    peak memory; in sparse runs, at every keyframe with stable rows, whether
    those rows kept their parameters and zero Adam moments.  With
    ``profile``, the tail keyframe is traced and its kernel-busy time kept
    (that step is then left out of the times)."""
    import numpy as np
    import torch
    from repro_torch.core import gaussians as G
    from repro_torch.slam.graphs import EngineStats
    from repro_torch.slam.session import session_finalize, session_init, session_step

    cfg = sparse_config(backend, sparse)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels, plains = reset_counters()
    stats = EngineStats()
    sess = session_init(ds, cfg, device=dev, stats=stats)
    rows, frozen, busy = [], [], None
    tail_kf = max(i for i in range(SPARSE_TAIL, SPARSE_FRAMES) if i % 2 == 0)
    for idx in range(1, SPARSE_FRAMES):
        before = ({k: v.clone() for k, v in G.params_of(sess.g).items()}
                  if sparse and idx % 2 == 0 else None)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if profile and idx == tail_kf:
            sess, out, busy = profiled_step(
                sess, ds.frames[idx], f"[sparse] {ds.name} "
                f"{'sparse' if sparse else 'dense'} keyframe {idx}", stats)
        else:
            sess, out = session_step(sess, ds.frames[idx], stats=stats)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        rows.append(dict(idx=idx, kf=out.is_kf, ms=ms, profiled=busy is not None
                         and idx == tail_kf, work=[int(x) for x in out.work],
                         stable=int(sess.pstate.stable.sum())))
        if before is not None and out.is_kf and rows[-1]["stable"]:
            st = sess.pstate.stable
            after = G.params_of(sess.g)
            frozen.append(all(torch.equal(before[k][st], after[k][st]) for k in before)
                          and all(not bool(sess.map_opt.mu[k][st].any())
                                  and not bool(sess.map_opt.nu[k][st].any())
                                  for k in before))
    res = session_finalize(sess, gt_w2c=[f.w2c_gt for f in ds.frames], stats=stats)
    fields = list(type(out.work)._fields)
    tail = {f: sum(r["work"][fields.index(f)] for r in rows if r["idx"] >= SPARSE_TAIL)
            for f in fields}
    return dict(res=res, rows=rows, tail=tail, frozen=frozen, busy_ms=busy, stats=stats,
                replayed=sess.runner.replayed_launches,
                launches={k: fn.launches for k, fn in kernels.items()},
                plain=sum(fn.calls for fn in plains),
                peak_gb=torch.cuda.max_memory_allocated() / 1e9)


def profiled_step(sess, frame, label, stats=None):
    """One session step under ``torch.profiler``: the step's results and
    its kernel-busy time (ms, the kernel rows' device time); prints the
    operators by device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.slam.session import session_step
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sess, out = session_step(sess, frame, stats=stats)
        torch.cuda.synchronize()
    events = prof.key_averages()
    busy = sum(e.self_device_time_total for e in events
               if e.device_type == DeviceType.CUDA) / 1e3
    log(f"[profile] {label}: kernels busy {busy:.1f} ms")
    log(events.table(sort_by="self_cuda_time_total", row_limit=20))
    return sess, out, busy


def phase_sparse(dev, profile=False):
    """Sparse stable/unstable mapping against dense mapping on room0 and
    desk0 (640x480, 16 frames) on the ``schedule`` backend, then sparse room0
    on ``kernel``.  The stability rule warms up until the last 3 steps (the
    tail), so the warmup's poses equal the dense run's; the tail optimizes
    and schedules less."""
    import numpy as np
    runs = {}
    for name in ("room0", "desk0"):
        ds = make_scene(dev, name, frames=SPARSE_FRAMES)
        for sparse in (False, True):
            runs[(name, sparse)] = sparse_run(dev, ds, "schedule", sparse, profile)
        if name == "room0":
            runs[("room0", "kernel")] = sparse_run(dev, ds, "kernel", True)
        del ds
    for key, r in runs.items():
        name, mode = key
        label = {False: "dense", True: "sparse"}.get(mode, "sparse on kernel")
        res, rows = r["res"], r["rows"]
        timed = [x for x in rows if not x["profiled"]]
        kf = [x["ms"] for x in timed if x["kf"]]
        tr = [x["ms"] for x in timed if not x["kf"]]
        log(f"[sparse] {name} {label}: ATE {res.ate * 100:.2f} cm, mean keyframe PSNR "
            f"{res.mean_psnr:.3f} dB, keyframe {np.mean(kf):.1f} ms, tracking-only frame "
            f"{np.mean(tr):.1f} ms, peak device memory {r['peak_gb']:.2f} GB, "
            f"{res.dispatches} dispatches, {res.syncs} syncs, {r['stats'].replays} graph "
            f"replays launching {r['replayed']}; stable rows "
            f"per frame {[x['stable'] for x in rows]}; tail (steps {SPARSE_TAIL}-"
            f"{SPARSE_FRAMES - 1}) unstable_gaussians {r['tail']['unstable_gaussians']}, "
            f"sched_programs {r['tail']['sched_programs']}, skipped_fragments "
            f"{r['tail']['skipped_fragments']}, fragments {r['tail']['fragments']}; "
            f"launches K3 {r['launches']['K3']}, K1 {r['launches']['K1']}, K2 "
            f"{r['launches']['K2']}, K4 {r['launches']['K4']}, K5 {r['launches']['K5']}, "
            f"plain versions {r['plain']}"
            + ("" if r["busy_ms"] is None else
               f"; tail keyframe {max(x['idx'] for x in rows if x['profiled'])} under the "
               f"profiler: kernels busy {r['busy_ms']:.1f} ms"))
    for name in ("room0", "desk0"):
        d, sp = runs[(name, False)], runs[(name, True)]
        fd, fs = d["res"], sp["res"]
        red_u = d["tail"]["unstable_gaussians"] / max(sp["tail"]["unstable_gaussians"], 1)
        red_p = d["tail"]["sched_programs"] / max(sp["tail"]["sched_programs"], 1)
        loss_db = fd.mean_psnr - fs.mean_psnr
        warm = all(np.array_equal(a, b) for a, b in
                   zip(fd.est_w2c[:SPARSE_TAIL], fs.est_w2c[:SPARSE_TAIL]))
        log(f"[sparse] {name}: tail reduction {red_u:.2f}x optimized Gaussians, "
            f"{red_p:.2f}x scheduled programs; PSNR loss {loss_db:.3f} dB; ATE "
            f"{fd.ate * 100:.2f} -> {fs.ate * 100:.2f} cm; warmup poses (frames 0-"
            f"{SPARSE_TAIL - 1}) equal to dense: {warm}; stable rows byte-frozen at "
            f"{sum(sp['frozen'])} of {len(sp['frozen'])} checked keyframes")
        require(warm, f"[sparse] {name}: warmup poses differ from the dense run's")
        require(sp["frozen"] and all(sp["frozen"]),
                f"[sparse] {name}: stable rows moved in a mapping phase {sp['frozen']}")
        require(sp["tail"]["unstable_gaussians"] < d["tail"]["unstable_gaussians"]
                and sp["tail"]["sched_programs"] < d["tail"]["sched_programs"],
                f"[sparse] {name}: the tail optimized or scheduled no less than dense")
        require(sp["tail"]["skipped_fragments"] > 0, f"[sparse] {name}: nothing skipped")
        require(loss_db < 0.35, f"[sparse] {name}: PSNR loss {loss_db:.3f} dB >= 0.35")
        require(np.isfinite(fs.ate) and fs.ate <= fd.ate * 1.05 + 0.02,
                f"[sparse] {name}: ATE {fs.ate:.4f} m outside 5% + 2 cm of {fd.ate:.4f}")
    rk, rs = runs[("room0", "kernel")]["res"], runs[("room0", True)]["res"]
    same = (all(np.array_equal(a, b) for a, b in zip(rk.est_w2c, rs.est_w2c))
            and rk.keyframe_psnr == rs.keyframe_psnr)
    log(f"[sparse] room0 sparse: kernel == schedule bit for bit (poses, PSNR): {same}")
    require(same, "[sparse] sparse kernel and schedule runs differ")
    for (name, mode), r in runs.items():
        fwd, bwd = ("K1", "K2") if mode == "kernel" else ("K4", "K5")
        others = [k for k in ("K1", "K2", "K4", "K5") if k not in (fwd, bwd)]
        tag = f"[sparse] {name} " + {False: "dense", True: "sparse"}.get(mode, mode)
        require(r["plain"] == 0, f"{tag}: plain versions ran {r['plain']} times")
        require(r["launches"][fwd] > 0 and r["launches"]["K3"] == r["launches"][bwd] > 0,
                f"{tag}: K3 merges != backwards: {r['launches']}")
        require(all(r["launches"][k] == 0 for k in others),
                f"{tag}: launched {others}: {r['launches']}")
    paths = {f"sparse_{n}" + ("" if m is True else "_dense" if m is False else "_kernel"):
             r["launches"] for (n, m), r in runs.items()}
    busy = {n: (runs[(n, False)]["busy_ms"], runs[(n, True)]["busy_ms"])
            for n in ("room0", "desk0")}
    return paths, busy


# ---------------------------------------------------------------------------
# serving: stacked sessions, the server and the scheduler
# ---------------------------------------------------------------------------

SERVE_SCENES = ("room0", "desk0", "stairs0", "corridor0")
SERVE_RETIRE = 6        # stairs0 leaves after its frame 6; room1 takes its slot
SERVE_PRUNE_FRAMES = 8
# corridor0's camera flies ~10 m down a corridor, and the reference's own
# MonoGS run there measures an ATE of 50.48 cm (``BENCH_slam.json``, the
# ``paged`` row): the room scenes' 0.30 m bound does not hold for it.  Its
# row is held to its solo run bit for bit and to the PSNR bound.
ATE_UNBOUNDED = ("corridor0",)


def main_config(**kw):
    """[main]'s configuration (one runner with it: sessions of an equal
    config share their graphs)."""
    from repro_torch.slam.session import SLAMConfig
    return SLAMConfig(capacity=131072, frag_capacity=K, map_window=4, iters_track=12,
                      iters_map=24, **kw)


def pose_digest(poses) -> str:
    import numpy as np
    return hashlib.sha256(np.ascontiguousarray(np.stack(poses)).tobytes()).hexdigest()[:16]


def solo_run(dev, ds, cfg, frames, max_frames=None):
    """A solo session over ``ds``'s first ``frames`` frames (init and
    steps), every counter set to 0 just before: the final session, its
    result, its launches and its boundaries fired."""
    import torch
    from repro_torch.core import pruning
    from repro_torch.slam.session import session_finalize, session_init, session_step
    kernels, plains = reset_counters()
    reads0 = pruning.interval_update.host_reads
    sess = session_init(ds, cfg, device=dev, max_frames=max_frames)
    fired = 0
    for idx in range(1, frames):
        sess, out = session_step(sess, ds.frames[idx])
        fired += int(out.fired.sum())
    torch.cuda.synchronize()
    res = session_finalize(sess, gt_w2c=[f.w2c_gt for f in ds.frames])
    require(sum(fn.calls for fn in plains) == 0, "a solo run ran a plain version")
    return dict(sess=sess, res=res, fired=fired,
                reads=pruning.interval_update.host_reads - reads0,
                launches={k: fn.launches for k, fn in kernels.items()})


def serve_steps(srv, feeds, steps, between=None):
    """Drive ``srv`` for ``steps`` lockstep frame-steps: each step submits
    the next frame of every live slot's feed (``feeds[slot]`` is a list of
    host frames, consumed from its head) and pumps, timed with the host
    clock to a ``torch.cuda.synchronize()``.  ``between(step)`` runs before
    each step.  Returns per-step rows: ms, ``EngineStats`` delta, keyframe
    flags."""
    import dataclasses

    import torch
    pool, rows = srv.pool, []
    for step in range(1, steps + 1):
        if between is not None:
            between(step)
        for slot in srv.live_slots():
            srv.submit(slot, feeds[slot].pop(0))
        before = dataclasses.replace(pool.stats)
        t0 = time.perf_counter()
        require(srv.pump() == 1, "a lockstep frame-step did not dispatch")
        torch.cuda.synchronize()
        rows.append(dict(step=step, ms=(time.perf_counter() - t0) * 1e3,
                         counts=pool.stats.since(before), kf=srv.last_result.is_kf,
                         fired=[int(f.sum()) for f in srv.last_result.fired]))
    srv.drain()
    return rows


def step_split(rows):
    """Mean ms and counts of the tracking-only frame-steps and of the
    keyframe frame-steps that captured no graph, and the capturing
    steps' ms."""
    import numpy as np
    out = {}
    for kind in ("tracking", "keyframe"):
        sel = [r for r in rows if any(r["kf"]) == (kind == "keyframe")
               and not r["counts"].captures]
        out[kind] = {"ms": float(np.mean([r["ms"] for r in sel])) if sel else float("nan"),
                     "steps": len(sel),
                     **{f: float(np.mean([getattr(r["counts"], f) for r in sel]))
                        if sel else float("nan")
                        for f in ("dispatches", "syncs", "replays")}}
    out["capture_ms"] = [round(r["ms"], 1) for r in rows if r["counts"].captures]
    return out


def split_line(width, split) -> str:
    t, k = split["tracking"], split["keyframe"]
    return (f"S={width}: tracking-only frame-step {t['ms']:.1f} ms ({t['steps']} steps, "
            f"{t['dispatches']:.1f} dispatches, {t['syncs']:.1f} syncs, "
            f"{t['replays']:.1f} replays; {width * 1e3 / t['ms']:.1f} frames/s), "
            f"keyframe frame-step {k['ms']:.1f} ms ({k['steps']} steps, "
            f"{k['dispatches']:.1f} dispatches, {k['syncs']:.1f} syncs, "
            f"{k['replays']:.1f} replays), steps that captured a graph "
            f"{split['capture_ms'] or 'none'} ms")


def phase_serve(dev, ds, main_launches, main_info):
    """``[serve]``: a ``SlamServer`` over a ``ShardedPool`` of S=4 rows on
    [main]'s config (room0, desk0, stairs0, corridor0, 12 frames each, fed
    through ``submit`` and ``pump``), stairs0 retired after its frame 6 and
    a fresh room1 session admitted in its slot; then S=2 (room0, desk0).
    Every row must equal its solo run bit for bit (room0's is [main]), a
    tracking-only frame-step must be 1 dispatch, 0 syncs and 1 replay, a
    keyframe frame-step must add [main]'s keyframe work per keyframe row,
    K1/K2/K3 must launch the sum of the solo runs' launches, no plain
    version may run, and every row's ATE must be under 0.30 m (but
    corridor0's, ``ATE_UNBOUNDED``) and its mean keyframe PSNR over 17 dB."""
    import numpy as np
    import torch
    from _session_state import same_session
    from repro_torch.slam.sched import default_decode
    from repro_torch.slam.server import ShardedPool, SlamServer
    from repro_torch.slam.session import session_finalize, session_init

    cfg = main_config()
    data = {"room0": ds, **{n: make_scene(dev, n) for n in (*SERVE_SCENES[1:], "room1")}}
    host = {n: [default_decode(f) for f in d.frames] for n, d in data.items()}
    solo = {"desk0": solo_run(dev, data["desk0"], cfg, 12),
            "corridor0": solo_run(dev, data["corridor0"], cfg, 12),
            "stairs0": solo_run(dev, data["stairs0"], cfg, SERVE_RETIRE + 1),
            "room1": solo_run(dev, data["room1"], cfg, 12 - SERVE_RETIRE)}
    solo["room0"] = dict(sess=main_info["sess"], launches=main_launches)
    gt = {n: [f.w2c_gt for f in d.frames] for n, d in data.items()}

    # S=4, with a retirement and an admission mid-run.
    torch.cuda.synchronize()
    base_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    kernels, plains = reset_counters()
    pool = ShardedPool([session_init(data[n], cfg, device=dev) for n in SERVE_SCENES])
    srv = SlamServer(pool, queue_depth=2)
    feeds = {s: host[n][1:] for s, n in enumerate(SERVE_SCENES)}
    retired = {}

    def churn(step):
        if step == SERVE_RETIRE + 1:
            retired["stairs0"] = srv.retire(2)
            t0 = time.perf_counter()
            require(srv.admit(session_init(data["room1"], cfg, device=dev)) == 2,
                    "[serve] room1 not admitted in stairs0's slot")
            retired["admit_ms"] = (time.perf_counter() - t0) * 1e3
            feeds[2] = host["room1"][1:]

    t_run = time.perf_counter()
    rows = serve_steps(srv, feeds, 11, churn)
    wall = time.perf_counter() - t_run
    launches = {k: fn.launches for k, fn in kernels.items()}
    plain_calls = sum(fn.calls for fn in plains)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    names = {0: "room0", 1: "desk0", 2: "room1", 3: "corridor0"}
    finals = {n: pool.session(s) for s, n in names.items()}
    finals["stairs0"] = retired["stairs0"]
    results = {n: session_finalize(sess, gt_w2c=gt[n]) for n, sess in finals.items()}
    split4 = step_split(rows)
    kf = main_info["split"]["keyframe"]
    per_kf = {f: kf[f] - (1 if f != "syncs" else 0) for f in ("dispatches", "syncs", "replays")}
    bad_counts = [r["step"] for r in rows if not r["counts"].captures and (
        (r["counts"].dispatches, r["counts"].syncs, r["counts"].replays)
        != (1 + per_kf["dispatches"] * sum(r["kf"]), per_kf["syncs"] * sum(r["kf"]),
            1 + per_kf["replays"] * sum(r["kf"])))]
    want = {k: sum(solo[n]["launches"][k] for n in solo) for k in ("K1", "K2", "K3")}
    equal = {n: same_session(finals[n], solo[n]["sess"]) for n in solo}
    digest = pose_digest(results["room0"].est_w2c)
    log(f"[serve] S=4 {W}x{H} rows {list(SERVE_SCENES)}, 12 frames each, stairs0 retired "
        f"after frame {SERVE_RETIRE} and room1 admitted in its slot ({retired['admit_ms']:.0f} "
        f"ms, session_init included): wall {wall:.2f} s for 11 frame-steps; "
        + split_line(4, split4) + f"; keyframe steps {[r['step'] for r in rows if any(r['kf'])]} "
        f"with {[sum(r['kf']) for r in rows if any(r['kf'])]} keyframe rows; per keyframe row "
        f"+{per_kf['dispatches']:.0f} dispatches, +{per_kf['syncs']:.0f} syncs, "
        f"+{per_kf['replays']:.0f} replays ([main]'s keyframe less its tracking replay)")
    log(f"[serve] S=4 rows equal their solo runs bit for bit: {equal}; room0 poses sha256 "
        f"{digest} ([main] {main_info['digest']}); launches {launches} against the solo "
        f"runs' sum {want}, plain versions {plain_calls}; peak device memory "
        f"{peak_gb:.2f} GB ({peak_gb - base_gb:+.2f} GB over the {base_gb:.2f} GB held "
        f"before the pool); admin swaps {pool.admin_dispatches}; per row ATE / mean "
        "keyframe PSNR: " + ", ".join(
            f"{n} {r.ate * 100:.2f} cm / {r.mean_psnr:.2f} dB ({r.work.frames} frames)"
            for n, r in results.items()))
    require(all(equal.values()), f"[serve] a row differs from its solo run: {equal}")
    require(digest == main_info["digest"], f"[serve] room0 sha256 {digest} != [main]'s")
    require(not bad_counts, f"[serve] frame-steps {bad_counts} break the count formula")
    require(split4["tracking"]["steps"] > 0 and split4["keyframe"]["steps"] > 0,
            f"[serve] no tracking-only or keyframe step without a capture: {split4}")
    require(all(launches[k] == want[k] for k in want),
            f"[serve] launches {launches} != the solo runs' {want}")
    require(plain_calls == 0 and launches["K4"] == launches["K5"] == 0,
            f"[serve] ran a plain version or K4/K5: {launches}, plain {plain_calls}")
    for n, r in results.items():
        require(np.isfinite(r.ate) and (r.ate < 0.30 or n in ATE_UNBOUNDED),
                f"[serve] {n} ATE {r.ate:.3f} m")
        require(r.mean_psnr > 17.0, f"[serve] {n} mean keyframe PSNR {r.mean_psnr:.2f} dB")

    # S=2: room0 and desk0, 12 frames.
    torch.cuda.synchronize()
    base2 = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    pool2 = ShardedPool([session_init(data[n], cfg, device=dev) for n in SERVE_SCENES[:2]])
    srv2 = SlamServer(pool2, queue_depth=2)
    rows2 = serve_steps(srv2, {0: host["room0"][1:], 1: host["desk0"][1:]}, 11)
    peak2 = torch.cuda.max_memory_allocated() / 1e9
    split2 = step_split(rows2)
    equal2 = [same_session(pool2.session(0), solo["room0"]["sess"]),
              same_session(pool2.session(1), solo["desk0"]["sess"])]
    log(f"[serve] S=2 rows room0, desk0: " + split_line(2, split2)
        + f"; rows equal their solo runs: {equal2}; peak device memory {peak2:.2f} GB "
        f"({peak2 - base2:+.2f} GB over {base2:.2f})")
    s1 = main_info["split"]
    log(f"[serve] ms per frame-step and aggregate frames/s by S (tracking-only / "
        f"keyframe steps): S=1 ([main]) {s1['tracking']['ms']:.1f} / "
        f"{s1['keyframe']['ms']:.1f} ms, {1e3 / s1['tracking']['ms']:.1f} frames/s; S=2 "
        f"{split2['tracking']['ms']:.1f} / {split2['keyframe']['ms']:.1f} ms, "
        f"{2e3 / split2['tracking']['ms']:.1f} frames/s; S=4 "
        f"{split4['tracking']['ms']:.1f} / {split4['keyframe']['ms']:.1f} ms, "
        f"{4e3 / split4['tracking']['ms']:.1f} frames/s")
    require(all(equal2), f"[serve] S=2 rows differ from their solo runs: {equal2}")
    require(split2["tracking"]["dispatches"] == 1 and split2["tracking"]["syncs"] == 0
            and split2["tracking"]["replays"] == 1, f"[serve] S=2 counts {split2}")
    return launches, solo, data, host


def phase_serve_prune(dev, data, host):
    """``[serve-prune]``: S=2 rows (room0, desk0) on [rtgs]'s
    ``PruneConfig`` with downsampling off, at 640x480 for 8 frames: each
    row equals its solo run bit for bit, with the same boundaries."""
    import torch
    from _session_state import same_session
    from repro_torch.core import pruning
    from repro_torch.core.pruning import PruneConfig
    from repro_torch.slam.server import ShardedPool, SlamServer
    from repro_torch.slam.session import session_init

    cfg = main_config(prune=PruneConfig(k0=5, step_frac=0.08))
    names, n = ("room0", "desk0"), SERVE_PRUNE_FRAMES
    solo = {m: solo_run(dev, data[m], cfg, n, max_frames=n) for m in names}
    kernels, plains = reset_counters()
    reads0 = pruning.interval_update.host_reads
    pool = ShardedPool([session_init(data[m], cfg, device=dev, max_frames=n) for m in names])
    srv = SlamServer(pool, queue_depth=2)
    rows = serve_steps(srv, {s: host[m][1:n] for s, m in enumerate(names)}, n - 1)
    reads = pruning.interval_update.host_reads - reads0
    launches = {k: fn.launches for k, fn in kernels.items()}
    plain_calls = sum(fn.calls for fn in plains)
    fired = [sum(r["fired"][s] for r in rows) for s in range(2)]
    equal = [same_session(pool.session(s), solo[m]["sess"]) for s, m in enumerate(names)]
    want = {k: sum(solo[m]["launches"][k] for m in names) for k in ("K1", "K2", "K3")}
    split = step_split(rows)
    log(f"[serve-prune] S=2 {W}x{H} rows {list(names)}, {n} frames, PruneConfig(k0=5, "
        f"step_frac=0.08), no downsampling: boundaries fired per row {fired} (solo "
        f"{[solo[m]['fired'] for m in names]}), {reads} host reads for them; rows equal "
        f"their solo runs bit for bit: {equal}; " + split_line(2, split)
        + f"; launches {launches} against the solo runs' sum {want}, plain versions "
        f"{plain_calls}; per step dispatches "
        f"{[r['counts'].dispatches for r in rows]}, replays "
        f"{[r['counts'].replays for r in rows]}")
    require(all(equal), f"[serve-prune] rows differ from their solo runs: {equal}")
    require(fired == [solo[m]["fired"] for m in names] and sum(fired) > 0,
            f"[serve-prune] boundaries {fired} != solo")
    require(reads == sum(fired), f"[serve-prune] {reads} reads for {sum(fired)} boundaries")
    require(all(launches[k] == want[k] for k in want) and plain_calls == 0,
            f"[serve-prune] launches {launches} != {want} or plain {plain_calls}")
    return launches


def phase_sched(dev, data, host, solo):
    """``[sched]``: a ``PoolLadder`` of widths (1, 2, 4) on [main]'s config;
    ``warmup``, then room0, desk0 and corridor0 through an
    ``IngestWorker`` thread, room0 migrated S=1 -> S=2 mid-trajectory with
    frames queued.  ``compile_cache_stats()`` must equal its warmup
    baseline at the end, and every stream its solo run bit for bit."""
    import torch
    from _session_state import same_session
    from repro_torch.obs import Telemetry
    from repro_torch.slam.sched import (
        IngestWorker, PoolLadder, QueueDepthPolicy, SlamScheduler)
    from repro_torch.slam.server import compile_cache_stats
    from repro_torch.slam.session import session_init

    cfg = main_config()
    tele = Telemetry()
    kernels, plains = reset_counters()
    t0 = time.perf_counter()
    ladder = PoolLadder(session_init(data["room0"], cfg, device=dev), widths=(1, 2, 4),
                        queue_depth=2, telemetry=tele)
    before = compile_cache_stats()
    baseline = ladder.warmup()
    warm_ms = (time.perf_counter() - t0) * 1e3
    # The policy migrates nothing on its own here (a stream would have to
    # starve for a minute): the one migration is the manual one below.
    sched = SlamScheduler(ladder, policy=QueueDepthPolicy(starve_s=60.0),
                          telemetry=tele, reserve_slots=0)
    streams = ("room0", "desk0", "corridor0")
    for n in streams:
        sched.admit(n, session_init(data[n], cfg, device=dev))
    placed = {n: sched.placement(n) for n in streams}
    t_run = time.perf_counter()
    # room0's first frames from this thread, two at a time; its fifth is
    # left queued when it migrates to the S=2 rung beside desk0.
    for t in range(1, 5, 2):
        require(sched.offer("room0", host["room0"][t])
                and sched.offer("room0", host["room0"][t + 1]), "[sched] offer refused")
        while ladder[0].server.queue.fill(0):
            sched.tick()
    require(sched.offer("room0", host["room0"][5]), "[sched] offer refused")
    migrated_at = (ladder[0].server.stats.steps, ladder[0].server.queue.fill(0))
    sched.migrate("room0", 1)
    # The rest of every stream through the ingest thread.
    worker = IngestWorker(sched, {n: host[n][6 if n == "room0" else 1:] for n in streams})
    worker.start()
    try:
        sched.serve(worker=worker, timeout_s=300)
    finally:
        worker.stop()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_run
    census = compile_cache_stats()
    launches = {k: fn.launches for k, fn in kernels.items()}
    plain_calls = sum(fn.calls for fn in plains)
    equal = {n: same_session(sched.row(n), solo[n]["sess"]) for n in streams}
    groups = []
    for rung in ladder.rungs:
        steps = rung.server.stats.steps
        disp = tele.registry.sum_counters("dispatches", kind="step", group=rung.name)
        groups.append(f"{rung.name} {steps} frame-steps, {disp / max(steps, 1):.2f} step "
                      f"dispatches and {rung.pool.stats.dispatches / max(steps, 1):.2f} engine "
                      f"dispatches per frame-step, {rung.pool.stats.replays} replays, "
                      f"{rung.server.stats.blank_row_steps} free-slot rows stepped on blank "
                      f"frames ({rung.server.stats.blank_keyframes} of them keyframes)")
    log(f"[sched] ladder widths (1, 2, 4) on [main]'s config: construction and warmup "
        f"{warm_ms:.0f} ms, census before warmup {before}, after {baseline}, at the end "
        f"{census}; streams placed {placed}; room0 migrated S=1 -> S=2 after "
        f"{migrated_at[0]} frame-steps with {migrated_at[1]} frame(s) queued; "
        f"{len(streams) * 11} frames in {wall:.2f} s, {worker.offered} of them through "
        f"the ingest thread ({worker.rejected} offers bounced); "
        + "; ".join(groups) + f"; migrations {sched.stats.migrations_by_reason}; rows equal "
        f"their solo runs bit for bit: {equal}; launches {launches}, plain versions "
        f"{plain_calls}")
    require(census == baseline, f"[sched] census {census} != warmup's {baseline}")
    require(all(equal.values()), f"[sched] a stream differs from its solo run: {equal}")
    require(migrated_at == (4, 1) and sched.stats.migrations == 1
            and worker.offered == len(streams) * 11 - 5,
            f"[sched] migrated at {migrated_at}, migrations {sched.stats.migrations}, "
            f"offered {worker.offered}")
    require(plain_calls == 0, f"[sched] ran a plain version {plain_calls} times")
    for rung in ladder.rungs:
        disp = tele.registry.sum_counters("dispatches", kind="step", group=rung.name)
        require(disp == rung.server.stats.steps, f"[sched] {rung.name} {disp} step "
                f"dispatches for {rung.server.stats.steps} frame-steps")
    return launches


def phase_profile(dev, ds, ds_rtgs, main_split):
    """Where a frame's time goes (after the default run, with ``profile``):
    a ``torch.profiler`` trace of one tracking-only frame and one keyframe of
    the full-size MonoGS session, fused and eager, and of one RTGS tracking
    frame (factor 2, pruning on) of the 640x448 session, fused, summed by
    operator, printed as tables, with each frame's ``cudaLaunchKernel`` and
    ``cudaGraphLaunch`` calls, dispatches, syncs and the device's idle
    share.  Every traced frame replays graphs captured in an earlier,
    untraced step."""
    import dataclasses

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.slam.graphs import EngineStats
    from repro_torch.slam.session import SLAMConfig, session_init, session_step

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    stats = EngineStats()
    sessions = {fused: session_init(ds, SLAMConfig(
        capacity=131072, frag_capacity=K, map_window=4, iters_track=12, iters_map=24,
        fused=fused), device=dev) for fused in (True, False)}
    with profile(activities=activities):          # the tracer's own start-up
        sessions[True], _ = session_step(sessions[True], ds.frames[1])
        torch.cuda.synchronize()
    sessions["rtgs"] = session_init(ds_rtgs, rtgs_config(), device=dev)
    out = {}
    for key, idx, label in ((True, 2, "tracking-only frame"), (True, 8, "keyframe"),
                            (False, 2, "eager tracking-only frame"),
                            (False, 8, "eager keyframe"),
                            ("rtgs", 3, "RTGS tracking frame (factor 2, pruning)")):
        frames = ds_rtgs.frames if key == "rtgs" else ds.frames
        sess = sessions[key]
        while sess.frame_idx < idx:
            step = {"factor": RTGS_FACTORS[sess.frame_idx - 1]} if key == "rtgs" else {}
            sess, _ = session_step(sess, frames[sess.frame_idx], **step)
        step = {"factor": RTGS_FACTORS[idx - 1]} if key == "rtgs" else {}
        before = dataclasses.replace(stats)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=activities) as prof:
            sess, _ = session_step(sess, frames[idx], stats=stats, **step)
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        sessions[key] = sess
        counts = stats.since(before)
        events = prof.key_averages()
        # Kernel rows only: an operator's self device time repeats its kernels'.
        dev_ms = sum(e.self_device_time_total for e in events
                     if e.device_type == DeviceType.CUDA) / 1e3
        calls = {name: sum(e.count for e in events if e.key == name)
                 for name in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                              "cudaGraphLaunch", "cudaMemcpyAsync")}
        out[label] = dict(calls, busy_ms=dev_ms, wall_ms=wall_ms,
                          dispatches=counts.dispatches, syncs=counts.syncs)
        ref = main_split["keyframe" if "keyframe" in label else "tracking"]["ms"]
        log(f"[profile] {label} {idx}: wall {wall_ms:.1f} ms under the profiler, "
            f"kernels busy {dev_ms:.1f} ms, device idle {100 * (1 - dev_ms / wall_ms):.0f}% "
            f"of it" + ("" if key is not True else
                        f" ({100 * (1 - dev_ms / ref):.0f}% of [main]'s untraced "
                        f"{ref:.1f} ms)")
            + "; host calls " + ", ".join(f"{n} {c}" for n, c in calls.items())
            + f"; {counts.dispatches} dispatches, {counts.syncs} syncs, "
            f"{counts.replays} graph replays")
        log(events.table(sort_by="self_cuda_time_total", row_limit=25))
        log(events.table(sort_by="self_cpu_time_total", row_limit=15))
        ops_ = {name: [e for e in events if e.key == name]
                for name in ("aten::index_add_", "aten::sort")}
        k3 = [e for e in events if e.device_type == DeviceType.CUDA and "k3_" in e.key]
        log(f"[profile] {label} {idx}: " + ", ".join(
            f"{name} {sum(e.count for e in es)} calls "
            f"{sum(e.device_time_total for e in es) / 1e3:.2f} ms" for name, es in ops_.items())
            + f", K3 kernels {sum(e.count for e in k3)} launches "
            f"{sum(e.self_device_time_total for e in k3) / 1e3:.2f} ms (device time)")
    fused, eager = out["tracking-only frame"], out["eager tracking-only frame"]
    log(f"[profile] cudaLaunchKernel per tracking-only frame: fused {fused['cudaLaunchKernel']}"
        f" (+ {fused['cudaGraphLaunch']} cudaGraphLaunch) against eager "
        f"{eager['cudaLaunchKernel']}")
    require(fused["cudaGraphLaunch"] > 0, "[profile] the fused frame launched no graph")
    return out


def main(argv) -> int:
    if argv not in ([], ["profile"]):
        print("usage: python3 chip_smoke.py [profile]", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir() or not (TESTS / "_kernel_inputs.py").is_file():
        print("chip_smoke.py: run it from the root of a checkout of the "
              "repository (src/repro_torch or tests/ not found)", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 3
    sys.path[:0] = [str(SRC), str(TESTS)]
    import repro_torch  # noqa: F401  (sets the precision flags)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    card = smi.splitlines()[0]
    dev = torch.device("cuda", 0)
    log(f"[env] torch {torch.__version__} (CUDA {torch.version.cuda}), python "
        f"{sys.version.split()[0]}, card: {card}")

    t_all = time.perf_counter()
    phase_build()
    kernel_rows = phase_kernels(dev)
    k3 = phase_gmu(dev)
    ds = make_scene(dev)
    ds_rtgs = make_scene(dev, height=RTGS_H)
    real_rows, merge = phase_real_view(dev, ds)
    grid_rows = phase_new_grids(dev, ds_rtgs)
    scene_rows, launches_sc = phase_scenes(dev)
    bwd_ms = phase_render(dev, ds)
    phase_small_session(dev)
    counters = launch_counters()[0]
    k3_check_launches = counters["K3"].launches + counters["K3 scan"].launches
    main = phase_main(dev, ds)
    launches, main_res, main_kfs, main_per_frame, main_info = main
    launches_e, _ = phase_main_eager(dev, ds, main)
    launches_s, replayed_s = phase_main_sched(dev, ds, main_res, main_kfs)
    launches_n = phase_norb(dev, ds, main_res, main_per_frame)
    rtgs = phase_rtgs(dev, ds_rtgs)
    launches_r, rtgs_res, rtgs_kfs, _ = rtgs
    phase_rtgs_eager(dev, ds_rtgs, rtgs)
    launches_rs = phase_rtgs_sched(dev, ds_rtgs, rtgs_res, rtgs_kfs)
    launches_a = phase_algos(dev, ds_rtgs)
    launches_sp, busy = phase_sparse(dev, profile=argv == ["profile"])
    launches_sv, solo, serve_data, serve_host = phase_serve(dev, ds, launches, main_info)
    launches_sp.update(serve=launches_sv,
                       serve_prune=phase_serve_prune(dev, serve_data, serve_host),
                       sched=phase_sched(dev, serve_data, serve_host, solo))
    if argv == ["profile"]:
        log("[profile] [sparse] tail keyframe (step 14), kernels busy: " + ", ".join(
            f"{n} dense {d:.1f} ms, sparse {sp:.1f} ms" for n, (d, sp) in busy.items()))
        phase_profile(dev, ds, ds_rtgs, main_info["split"])

    paths = {"main": launches, "main_eager": launches_e, "main_sched": launches_s,
             "norb": launches_n,
             "rtgs": launches_r, "rtgs_sched": launches_rs,
             **{f"algos_{a}": v for a, v in launches_a.items()},
             "scenes": launches_sc, **launches_sp}
    meta = {
        "K1": ("tile_render_fwd", "src/repro_torch/csrc/tile_render.cu",
               "src/repro/kernels/tile_render.py:175", launches["K1"]),
        "K2": ("tile_render_bwd", "src/repro_torch/csrc/tile_render_bp.cu",
               "src/repro/kernels/tile_render_bp.py:208", launches["K2"]),
        "K4": ("tile_render_fwd_sched", "src/repro_torch/csrc/tile_render.cu",
               "src/repro/kernels/tile_render.py:280", launches_s["K4"]),
        "K5": ("tile_render_bwd_sched", "src/repro_torch/csrc/tile_render_bp.cu",
               "src/repro/kernels/tile_render_bp.py:302", launches_s["K5"]),
    }
    tiles = H // 16 * W // 16
    kernels = []
    for key, (name, source, replaces, n_launch) in meta.items():
        b1, b4, rv = kernel_rows[(key, 1)], kernel_rows[(key, 4)], real_rows[key]
        f2, f4 = grid_rows[2][key], grid_rows[4][key]
        sc = {n: scene_rows[n][key] for n in NEW_SCENES}
        row = {
            "name": f"{key} {name}", "route": "cuda", "source": source,
            "replaces": replaces, "launches": n_launch,
            # of them, launched by CUDA graph replays ([main] / [main-sched])
            "launches_replayed": (main_info["replayed"] if key in ("K1", "K2")
                                  else replayed_s)[name],
            "launches_by_path": {p: v[key] for p, v in paths.items()},
            "max_abs_err": max(o["max_abs_err"] for o in (b1, b4, rv, f2, f4, *sc.values())),
            "ms": b1["ms"], "plain_ms": b1["plain_ms"],
            "bound_ms": b1["bound_ms"], "bound_by": b1["bound_by"],
            "library_ms": None,
            "shape": f"{tiles} tiles x K={K}, B=1 near-tile attrs (tracking); "
                     "*_b4 keys: B=4 stacked views (mapping window); "
                     "*_real keys: B=1 packed attrs of a ground-truth view; "
                     f"*_f2 / *_f4: a ground-truth view of the {W}x{RTGS_H} scene at "
                     "factor 2 (280 tiles) / 4 (70 tiles); *_desk0 / *_stairs0 / "
                     f"*_corridor0: frame 3's ground-truth view of that scene at {W}x{H}",
            "ms_b4": b4["ms"], "plain_ms_b4": b4["plain_ms"],
            "bound_ms_b4": b4["bound_ms"],
            "ms_real": rv["ms"], "plain_ms_real": rv["plain_ms"],
            "bound_ms_real": rv["bound_ms"],
            "ms_f2": f2["ms"], "plain_ms_f2": f2["plain_ms"], "bound_ms_f2": f2["bound_ms"],
            "ms_f4": f4["ms"], "plain_ms_f4": f4["plain_ms"], "bound_ms_f4": f4["bound_ms"],
            **{f"{k}_{n}": o[k] for n, o in sc.items() for k in ("ms", "plain_ms", "bound_ms")},
        }
        if key == "K1":
            # kernel_norb's backward re-runs K1: the whole backward's device
            # time with and without that re-run, B=1 and B=4 ground-truth views.
            row.update({f"backward_ms_{b}_b{v}": bwd_ms[v][b]
                        for v in (1, 4) for b in ("kernel", "kernel_norb")})
        kernels.append(row)
    m1, m4 = merge[1], merge[4]
    kernels.insert(2, {
        "name": "K3 merge_runs (and block_cumsum)", "route": "cuda",
        "source": "src/repro_torch/csrc/gmu.cu", "replaces": "src/repro/kernels/gmu.py:83",
        # GMU level 2, K3's merge epilogue, once per backward: [main]'s
        # count, then [main-sched]'s; the scan epilogue's counts on both
        # paths; then both epilogues' launches in the checks and timings.
        "launches": launches["K3"], "launches_sched": launches_s["K3"],
        "launches_replayed": main_info["replayed"]["merge_runs"],
        "launches_by_path": {p: v["K3"] for p, v in paths.items()},
        "scan_launches": launches["K3 scan"], "scan_launches_sched": launches_s["K3 scan"],
        "check_launches": k3_check_launches,
        "max_abs_err": max(m1["max_abs_err"], m4["max_abs_err"], k3["max_abs_err"]),
        "ms": m1["ms"], "plain_ms": m1["plain_ms"], "bound_ms": m1["bound_ms"],
        "bound_by": m1["bound_by"], "library_ms": m1["library_ms"],
        "call_ms": m1["call_ms"], "call_host_ms": m1["host_ms"],
        "unique_gaussians": m1["unique"],
        "boundary_row_share": m1["boundary_share"],
        "ms_b4": m4["ms"], "plain_ms_b4": m4["plain_ms"], "bound_ms_b4": m4["bound_ms"],
        "library_ms_b4": m4["library_ms"], "call_ms_b4": m4["call_ms"],
        "call_host_ms_b4": m4["host_ms"],
        "scan_ms": k3["ms"], "scan_host_ms": k3["host_ms"], "scan_plain_ms": k3["plain_ms"],
        "scan_bound_ms": k3["bound_ms"], "scan_bound_by": k3["bound_by"],
        "scan_library_ms": k3["library_ms"], "scan_inner_cumsum_ms": k3["inner_ms"],
        "shape": f"merge: the K2 gradients ({tiles}, 10, {K}) and ids of a ground-truth "
                 "view, B=1 (tracking) and *_b4: four copies merged at once (mapping "
                 "window); ms is merge_runs (zero fill and kernel) on sorted keys, "
                 "call_ms the whole merge_views call (keys, stable sort, zero fill, "
                 "kernel), library_ms one index_add_ of the valid rows, all device "
                 "time from CUDA-graph replays; *_host_ms: CUDA events around calls "
                 f"launched from the host; scan_*: block_cumsum at ({tiles * K}, 10), "
                 "scan_library_ms torch.cumsum(x, 0)",
    })
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    require(sorted(k["name"].split()[0] for k in kernels) == ["K1", "K2", "K3", "K4", "K5"]
            and all(x in k for k in kernels for x in keys),
            "the kernels line lacks a kernel or a key")
    log(f"[done] {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
