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
3. ``[lm]``: the LM scaffold's serving path (``models/``,
   ``launch/serve.py``; it reaches no ``pallas_call``, so it adds no kernel
   to the kernels line): zamba2-1.2b and phi4-mini-3.8b initialised on the
   card at full width and served through ``launch.serve.serve`` (4 x 256
   prompt tokens, 64 greedy tokens; one warm-up, then the median of 3),
   every logit finite and every tensor on the card, prefill tokens/s,
   decode ms per step and tokens/s, peak memory and parameter bytes,
   decode vs forward at 128 tokens, one decode step under
   ``set_sync_debug_mode("error")`` (with ``profile``, one traced decode
   step each: launches, busy and idle time, top device operations); then
   the ten architectures at
   reduced size, card against the port's own CPU run (prefill, pad_cache
   and 4 teacher-forced decode steps), and the reference's
   decode-vs-forward invariant on the card for four of them;
   ``[lm-train]``: the LM training path (``models/`` under autograd,
   ``train/``, ``launch/train.py``; no ``pallas_call`` either):
   phi4-mini-3.8b (8 x 4096 tokens) and zamba2-1.2b (4 x 4096) at full
   width through ``launch/train.py``'s path, 5 AdamW steps on one repeated
   batch (loss and gradient norm finite, the parameters moved, the loss
   falling by 0.05, peak memory under 80 GB; ms per step, tokens/s and
   model-FLOP share), phi4's step with its config's 8 microbatches against
   the plain one, remat "none" against "block" at full width (bit for bit,
   "block" lower in memory), the ten architectures' train steps at reduced
   size card against CPU and a Trainer's checkpoint and resume on the card
   (with ``profile``, one traced train step per full-width model);
   ``[dist]``: the distributed layer (``launch/mesh.py``, ``distributed/``)
   on a one-rank NCCL process group: a 1x1 ("data", "model") mesh,
   phi4-mini-3.8b's ``param_specs`` and ``cache_specs`` at full width on
   ``meta`` tensors, its real parameters and a prefill cache distributed
   onto the mesh (``shard_tree``), ``[lm]``'s phi4 prefill on its
   parameters replicated on the mesh (``shard_tree`` of the pure-DP specs)
   and replicated DTensor inputs with ``ctx`` set on that mesh
   (every ``constrain_batch`` in the model redistributing its activation)
   against the plain prefill with ``ctx`` unset (bit for bit),
   ``launch/dryrun.build_case``'s sharded steps on that mesh at full width
   (phi4-mini-3.8b's train step, 2 microbatches of 1 x 1024, and
   zamba2-1.2b's decode step, parameters on ``param_specs`` and the cache
   on ``cache_specs``) against the same steps on plain tensors from the
   same seed (max |d| 0 on loss, grad norm, parameters, logits and cache;
   the median of 3 steps each way after an untimed one), and
   ``pipeline_apply`` at S=1, M=6 on (8, 4096) bf16 microbatches against
   the sequential stack, forward and gradients (the peak of the last
   sharded train and decode step measured, its arguments allocated);
   ``[dryrun]``: ``launch/dryrun.py`` on fake process groups, every fake
   tensor on the card: those two peaks predicted on a one-rank fake group
   (``measure_step``, within 10%), then phi4-mini-3.8b's ``train_4k`` (its
   8 microbatches fewer than the 16 data ranks; depth cut to
   ``DRYRUN_PHI4_LAYERS``) and qwen3-moe-30b-a3b's ``decode_32k`` on the
   16x16 mesh of 256 fake ranks (per-device peak, counted FLOPs and bytes,
   collective bytes by kind, bottleneck, seconds); ``[roofline]``:
   ``analysis/roofline.py``'s rows of phi4's and zamba2's full-width train
   steps and phi4's prefill and decode step, FLOPs and bytes counted over
   one extra, untimed call of each (in ``[lm]`` and ``[lm-train]``), the
   train steps' times from ``[lm-train]``'s medians and the serving calls'
   from the medians of 10 calls each, timed alone, with one traced call of
   each (kernels busy against wall), printed as ``analysis/report.py``'s table with each row's counted-FLOP
   and 6 N T shares of the bf16 peak;
4. holds K1, K2, K4 and K5 against their plain PyTorch versions on the
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
5. repeats the comparisons and times of step 3 on the packed attrs of a
   full-size ground-truth view (uneven tile loads), prints their tile-load
   and pair-load imbalance, and holds K3's merge (GMU level 2) on that
   view's K2 gradients, alone and as four views at once, against its plain
   version (bit for bit), a second launch and a float64 segment sum, and
   times it, the whole ``merge_views`` call and one ``index_add_`` of the
   valid rows;
6. renders the full-size ground-truth scene through the ``kernel`` backend
   and the pure-tensor ``ref`` backend and compares images and gradients;
   checks that the ``schedule`` backend equals the ``kernel`` backend bit
   for bit (images and per-Gaussian gradients, 1 and 4 views) and that a
   batched 4-view render equals four single-view renders;
7. runs a small session on the card and on the CPU from the same inputs
   and compares poses and PSNR;
8. runs the MonoGS SLAM session on the full-size room0 scene (640x480,
   12 frames, a 131072-Gaussian pool) with every launch counter set to 0
   just before, fused (the default: each phase's iterations replayed as a
   CUDA graph), and checks that K1, K2 and K3 carried it (one K3 merge per
   backward, counted through the replays), that no plain version ran, and
   that ATE < 0.30 m and mean keyframe PSNR > 17 dB, and that every
   tracking-only frame counts 1 dispatch, 0 syncs and 1 graph replay and
   every keyframe 2 / 0 / 2 (tracking, then the keyframe graph: densify,
   the window builds, the 24 iterations with their stride rebuilds, the
   eval render and the serving-cache build); then ``[main-eager]``,
   the same session with ``fused=False``, which must equal it bit for bit
   with the same launches, and both once more in turns (fused, eager,
   eager, fused), printing ms per frame, dispatches, syncs and graph
   replays per tracking-only frame and keyframe, and the keyframe's ms
   beside the parent's;
9. runs the same session on the ``schedule`` backend, counters set to 0
   again, and checks that K4, K5 and K3 carried it (one K3 merge per
   backward; no K1, K2 or plain run), the same bounds, the same counts
   per step, the same keyframes, and camera centres within 1 mm of step
   7's; then [main]'s first frames
   on ``kernel_norb``, the RTGS session (pruning and downsampling, 640x448)
   on both backends and eager (``[rtgs-eager]``, equal bit for bit), whose
   fused tracking phase, every pruning boundary inside it under CUDA graph
   conditional nodes, is one replay (1 / 0 / 1 per tracking-only frame,
   2 / 0 / 2 per keyframe; the capture seconds of its tracking graphs
   printed), and
   the other three base algorithms with RTGS; then ``[kf-device]``:
   GS-SLAM and Photo-SLAM at [main]'s config, whose keyframe decisions
   stay on the device, fused (2 dispatches, 0 syncs and 2 replays on every
   step, keyframe or not) against eager, bit for bit;
10. ``[scenes]``: builds desk0, stairs0 and corridor0 at 640x480 through K1
   and holds K1, K2, K4 and K5 against their plain versions on one view of
   each;
11. ``[sparse]``: sparse stable/unstable mapping against dense on room0 and
    desk0 (640x480, 16 frames, ``schedule``), then sparse room0 on
    ``kernel``: the warmup poses equal dense bit for bit, ``kernel``
    equals ``schedule``, stable rows stay byte-frozen, the tail optimizes
    fewer Gaussians and schedules fewer programs, the PSNR loss is under
    0.35 dB, and K3 merges once per backward with no plain run;
12. ``[serve]``: a ``SlamServer`` over a ``ShardedPool`` of S=4 stacked
    sessions on [main]'s config (room0, desk0, stairs0, corridor0, 12
    frames each, fed through ``submit`` and ``pump``; stairs0 retired after
    its frame 6 and a fresh room1 session admitted in its slot; the S=4
    and S=2 keyframe graphs captured before, as ``PoolLadder.warmup`` does), then S=2:
    every row equals its solo run bit for bit (room0's poses hash to
    [main]'s), a tracking-only frame-step is 1 dispatch, 0 syncs and 1
    graph replay for all rows, a frame-step with keyframe rows 2 / 0 / 2
    (one replay of the S-row keyframe graph maps them all), K1/K2/K3
    launch the sum of the solo runs' launches and no plain version runs; prints ms per frame-step and
    aggregate frames/s at S=1, 2 and 4, capture ms and peak memory;
    ``[serve-prune]``: S=2 rows under [rtgs]'s pruning without
    downsampling, 8 frames, equal to their solo runs with the same
    boundaries, at 1 / 0 / 1 and 2 / 0 / 2 per frame-step; ``[sched]``:
    a ``PoolLadder`` of widths (1, 2, 4),
    ``warmup`` (each rung's tracking and S-row keyframe graphs), three streams through an ``IngestWorker`` thread with one
    migration S=1 -> S=2 while frames are queued; the runner census after
    serving equals the warmup's and every stream its solo run;
13. ``[paged]``: PagedMap.  [main]'s config with every page in view
    (``PagedConfig(1024, 128)``) equals ``[main]`` and ``[main-sched]``
    bit for bit, with their launches and 1 / 0 / 1 and 2 / 0 / 2 counts,
    and a 2-row pool of it its solo runs (2 / 0 / 2 per frame-step with
    keyframe rows); then the reference PagedMap
    bench's corridor config (48x64, capacity 4096, ``PagedConfig(256,
    6)``, 24 frames) on the bench's own inputs and on the port's draw, and
    corridor0 at 640x480 (capacity 131072, ``PagedConfig(1024, 48)``),
    flat and paged: ms per frame, build rows, ATE, PSNR, peak memory and
    the bench's four gates (printed as pass or fail); both runs must count
    the flat step's formula, every paged build must sweep the view's rows,
    and paged must equal flat bit for bit up to the first step whose view
    leaves out an alive row; on the bench's own inputs the first tracking
    iteration's pose gradient over the view must equal flat's bit for bit
    and the four gates must pass;
14. with ``profile``, traces the tail keyframe of each ``[sparse]`` run,
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
import math
import os
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


KERNEL_SYMBOLS = {"K2": "tile_render_bwd_kernel",
                  "K5": "tile_render_bwd_sched_kernel",
                  # K1 and K4 at each cluster size (blocks per tile or pair)
                  **{f"K{k} cluster {c}": f"{sym}ILi{c}E"
                     for k, sym in ((1, "tile_render_fwd_kernel"),
                                    (4, "tile_render_fwd_sched_kernel"))
                     for c in (1, 2)},
                  # K3 at the main path's width (G = 10 columns)
                  "K3 merge pass 1": "k3_totalsILb1ELi10E",
                  "K3 merge pass 2": "k3_rowsILb1ELi10E",
                  "K3 scan pass 1": "k3_totalsILb0ELi10E",
                  "K3 scan pass 2": "k3_rowsILb0ELi10E"}
NO_SPILLS = ("K2", "K5", "K3 merge pass 1", "K3 merge pass 2",  # the main path's
             *(f"K{k} cluster {c}" for k in (1, 4) for c in (1, 2)))
PTXAS_USAGE: dict = {}  # KERNEL_SYMBOLS key -> (registers, spill stores, spill loads)


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
    from repro_torch.kernels import tile_render as tr
    sh = tr.fwd_launch_shape(1, K, CHUNK, "cuda")
    log(f"[build] K1 / K4 launch shapes: a cluster of {tr.FWD_SPLIT} blocks of "
        f"{tr.FWD_THREADS // tr.FWD_SPLIT} threads per tile (K1) or pair of slots (K4) "
        f"below {tr.FWD_SPLIT_BELOW} tiles (pairs) per SM, else one block of "
        f"{tr.FWD_THREADS}; a thread a pixel; {sh['smem_bytes']} B of dynamic shared "
        f"memory a block at K={K}, chunk {CHUNK} (at most {tr.FWD_WINDOW} fragments "
        "staged)")
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
        PTXAS_USAGE[key] = found[0]
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
        # K1 and K4 keep the plain version's operation order: bit for bit.
        require(torch.equal(g, w_), f"{name} {out} is not the plain version's bit for bit "
                f"({label}): max |d| {max_err(g, w_):.3g}")
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
        fwd_launch_shape, raise_on_sched_fault, tile_render_fwd, tile_render_fwd_plain,
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
    shapes = {"K1": fwd_launch_shape(attrs.shape[0], attrs.shape[2], CHUNK, attrs.device),
              "K4": fwd_launch_shape(perm.shape[0] // 2, attrs.shape[2], CHUNK,
                                     attrs.device)}
    for name, sh in shapes.items():
        regs, sst, sld = PTXAS_USAGE.get(f"{name} cluster {sh['cluster']}", (None,) * 3)
        sh.update(registers=regs, spill_stores=sst, spill_loads=sld)
        per = "tile" if name == "K1" else "pair of slots"
        how = f"a cluster of {sh['cluster']} blocks" if sh["cluster"] > 1 else "one block"
        log(f"[kernels] {label}: {name} launch: {how} per {per}, {sh['threads']} "
            f"threads a block, {sh['smem_bytes']} B of dynamic shared memory, {regs} "
            f"registers, spills {sst} / {sld} B")
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
    # ms: CUDA events around 40 launches from the host; device_ms: CUDA-graph
    # replays, the kernel alone (on the 70-tile grid a launch from the host
    # takes longer than K1 itself).
    out = {}
    for name, (kernel, plain, err) in calls.items():
        b, by = bounds[name]
        out[name] = dict(max_abs_err=err, ms=cuda_ms(kernel, 40), device_ms=graph_ms(kernel),
                         plain_ms=cuda_ms(plain, 2), bound_ms=b, bound_by=by,
                         launch=shapes.get(name))
    frag_skip, group_skip = warp_skips(stash, count, CHUNK, REDUCE_GROUP)
    log(f"[kernels] {label}: {n_ran} of {n_trips} chunks below the trip count ran, "
        f"{100 * saturated:.1f}% of tiles saturated; K4 == K1 and K5 == K2 bitwise "
        f"after inv; backward warp skips: {100 * frag_skip:.1f}% of (warp, fragment) "
        f"pairs drawn by no lane, {100 * group_skip:.1f}% in idle groups of "
        f"{REDUCE_GROUP}")
    for name, o in out.items():
        rate = (f", {bwd_bytes / o['ms'] / 1e6:.0f} GB/s of the backward's bytes"
                if name in ("K2", "K5") else "")
        log(f"[kernels] {label}: {name} {o['ms']:.4f} ms launched from the host, "
            f"{o['device_ms']:.4f} ms of device time (plain {o['plain_ms']:.1f} ms, "
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
    while it is entered (it wraps ``pruning.interval_update``).  It writes
    them in place into buffers of its own, made at its first call: on the
    card the boundary is a conditional body of the fused tracking graph,
    recorded once at capture and run by the replays whose boundary fires.
    A capture's warm-up runs every body once, so a frame that captures
    must fire a boundary for the buffers to hold a real one
    (``small_rtgs`` requires it)."""

    def __enter__(self):
        import torch
        from repro_torch.core import pruning
        self.inner, self.last = pruning.interval_update, None

        def recorded(state, g, tile_count, cfg):
            alive = g.alive & ~state.masked
            if self.last is None:
                self.last = (torch.empty_like(state.score), torch.empty_like(alive))
            self.last[0].copy_(state.score)
            self.last[1].copy_(alive)
            return self.inner(state, g, tile_count, cfg)

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
                captures = len(tracking_captures(sess.runner))
                sess, r = session_step(sess, ds.frames[idx], factor=factors[-1],
                                       perm=torch.as_tensor(perms[idx]))
                last = idx if r.is_kf else last
                require(len(tracking_captures(sess.runner)) == captures
                        or bool(r.fired.any()),
                        f"[small] RTGS frame {idx} captured a graph and fired no "
                        "boundary: the selection recorder holds the capture's warm-up")
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


def tracking_captures(runner) -> list:
    """``(factor, rows, seconds)`` of each §4.1 tracking graph (the pruning
    path's, its boundaries under conditional nodes) the runner captured:
    the host's seconds for the warm-up run and the capture."""
    return [(key[2], key[4], sec) for key, sec in runner.capture_times
            if key[0] == "track-prune"]


def capture_text(runner) -> str:
    return ", ".join(f"factor {f} S={n} {sec:.2f} s"
                     for f, n, sec in tracking_captures(runner)) or "none"


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
    # Per step (the ones that capture a graph too): a tracking-only frame
    # is one replay, a keyframe two (tracking, then its keyframe graph).
    counts = {kind: sorted({(c.dispatches, c.syncs, c.replays)
                            for c, k in zip(stats_rows[1:], kf_flags[1:])
                            if k == (kind == "keyframe")})
              for kind in ("tracking", "keyframe")}
    log(f"{tag} dispatches, syncs and graph replays per step: {counts}")
    if fused:
        require(counts == {"tracking": [(1, 0, 1)], "keyframe": [(2, 0, 2)]},
                f"{tag} counts {counts}, want tracking (1, 0, 1) and keyframe (2, 0, 2)")
    return launches, res, keyframes, per_frame, dict(
        split=split, peak_gb=peak_gb, ms=wall * 1e3 / frames, counts=counts,
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
    # [main]'s own keyframe captures the keyframe graph; the later fused
    # turn replays it (the runner is cached per config).
    kf = [t["split"]["keyframe"] for _, t in turns]
    log(f"[main] keyframe without a capture: fused {kf[3]['ms']:.1f} ms "
        f"({kf[3]['dispatches']:.0f} dispatches, {kf[3]['syncs']:.0f} syncs), eager "
        f"{kf[1]['ms']:.1f} / {kf[2]['ms']:.1f} ms; the parent's fused keyframe "
        f"468.3-572.1 ms at 17 dispatches and 3 syncs (PERF.md section 5)")
    return launches, turns


def phase_main_sched(dev, ds, main_res, main_keyframes):
    """The same session on the WSU ``schedule`` backend, against [main];
    returns its launches, results, keyframes and info."""
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
    return launches, res, keyframes, info


RTGS_H = 448     # TUM's 640x480 less 32 rows: 64-divisible, as §4.2 needs
RTGS_FACTORS = [4, 2, 2, 2, 2, 2, 2, 1, 4, 2, 2]   # frames 1-11, keyframe 8


def reset_counters():
    """Every launch and plain-version counter set to 0, and every phase
    runner's count of launches made by graph replays (sessions of one
    config share a runner across phases), after folding in the launches of
    the keyframe bodies the device decided to run (one read per runner
    that has such bodies, outside every timed window)."""
    from repro_torch.slam.session import cached_runners
    for runner in cached_runners():
        runner.fold_launches()
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
    t0 = time.perf_counter()
    sess = session_init(ds, cfg, device=dev, stats=stats)
    torch.cuda.synchronize()
    init_ms, rows, last = (time.perf_counter() - t0) * 1e3, [], 0
    for idx in range(1, ds.num_frames):
        factor = frame_factor(ds, idx, last, cfg)
        # The frame's tracking lists, built again outside the timed step
        # (no kernel runs in a build): how far they overflow K.
        with torch.no_grad():
            pre = sess.stage_at(factor)._build(sess.g, sess.cur_masked,
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
    log(f"{tag} pruning boundaries fired per frame {fired} ({sum(fired)} in all); "
        f"syncs per frame {[r['counts'].syncs for r in rows]}; alive per frame "
        f"{res.alive_per_frame}; removed {res.prune_removed}; tracking graphs captured "
        f"(warm-up and capture, host seconds): {capture_text(sess.runner)}")
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
    require((stats.replays > 0) == fused, f"{tag} made {stats.replays} graph replays")
    # Fused, the tracking phase (its build, the 12 iterations and every
    # fired boundary) is one replay; eager, its calls, and one read per
    # iteration for the boundary check.
    k, sched = cfg.iters_track, int(backend == "schedule")
    kf_eager = 3 + sess.stage._map_dispatches(False)
    for r in rows:
        c = r["counts"]
        want = ((1 + r["kf"], 0, 1 + r["kf"]) if fused else
                (1 + sched + k + r["fired"] * (2 + sched) + kf_eager * r["kf"], k, 0))
        require((c.dispatches, c.syncs, c.replays) == want,
                f"{tag} frame {r['idx']} counts {(c.dispatches, c.syncs, c.replays)}, "
                f"not {want}")
    require(sum(fired) > 0, f"{tag} fired no pruning boundary")
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


# [kf-device]'s policies at [main]'s config: room0's camera moves ~0.12 m a
# frame and two frames apart differ by an RMSE of ~0.10, so both map about
# every third frame (``tools/main_ab.py`` runs the same ones).
KF_DEVICE = {"gsslam": dict(kind="gsslam", trans_thresh=0.3, rot_thresh=0.25),
             "photoslam": dict(kind="photoslam", pho_thresh=0.12)}


def phase_kf_device(dev, ds):
    """``[kf-device]``: GS-SLAM and Photo-SLAM at [main]'s config (room0,
    640x480, 12 frames), fused, then eager (``fused=False``, which reads
    each keyframe flag).  Fused, every step must count 2 dispatches, 0
    syncs and 2 replays, keyframe or not: tracking, then the keyframe
    graph, whose mapping runs under the device's decision in a conditional
    node.  The runs must hold keyframes and tracking-only frames and equal
    each other bit for bit (poses, PSNR, alive counts, work, the session,
    the launches once the device-counted ones are folded in), K1/K2/K3
    must carry them with no plain run, ATE < 0.6 m and PSNR > 14 dB
    ([algos]'s bounds).  Prints each run's poses digest (``tools/main_ab.py
    --cases gsslam,photoslam`` prints the parent's), keyframes and ms per
    tracking-only frame and keyframe; the flags are read after the run."""
    import dataclasses

    import numpy as np
    import torch
    from _session_state import same_session
    from repro_torch.core.keyframes import KeyframePolicy
    from repro_torch.slam.graphs import EngineStats
    from repro_torch.slam.session import session_finalize, session_init, session_step

    out = {}
    for algo, policy in KF_DEVICE.items():
        runs = {}
        for fused in (True, False):
            cfg = main_config(base_algo=algo, keyframe=KeyframePolicy(**policy), fused=fused)
            torch.cuda.synchronize()
            kernels, plains = reset_counters()
            stats = EngineStats()
            t_run = time.perf_counter()
            sess = session_init(ds, cfg, device=dev, stats=stats)
            torch.cuda.synchronize()
            rows, flags = [], []
            for idx in range(1, ds.num_frames):
                before = dataclasses.replace(stats)
                t0 = time.perf_counter()
                sess, r = session_step(sess, ds.frames[idx], stats=stats)
                torch.cuda.synchronize()
                rows.append(((time.perf_counter() - t0) * 1e3, stats.since(before)))
                flags.append(r.is_kf)
            wall = time.perf_counter() - t_run
            res = session_finalize(sess, gt_w2c=[f.w2c_gt for f in ds.frames],
                                   wall_time_s=wall, stats=stats)
            require(all(isinstance(f, torch.Tensor) for f in flags),
                    f"[kf-device] {algo}: a keyframe flag came back to the host")
            flags = [bool(f) for f in torch.stack(flags).tolist()]
            counts = sorted({(c.dispatches, c.syncs, c.replays) for _, c in rows})

            def mean_ms(kf):
                sel = [t for (t, c), k in zip(rows, flags) if k == kf and not c.captures]
                return float(np.mean(sel)) if sel else float("nan")

            runs[fused] = dict(
                res=res, sess=sess, flags=flags, counts=counts,
                launches={k: fn.launches for k, fn in kernels.items()},
                plain_calls=sum(fn.calls for fn in plains), digest=pose_digest(res.est_w2c),
                tracking_ms=mean_ms(False), keyframe_ms=mean_ms(True),
                capture_ms=[round(t, 1) for t, c in rows if c.captures])
        f, e = runs[True], runs[False]
        same = {"poses": f["digest"] == e["digest"],
                "PSNR": f["res"].keyframe_psnr == e["res"].keyframe_psnr,
                "keyframes": f["flags"] == e["flags"],
                "alive": f["res"].alive_per_frame == e["res"].alive_per_frame,
                "work": f["res"].work == e["res"].work,
                "session": same_session(f["sess"], e["sess"]),
                "launches": f["launches"] == e["launches"]}
        kfs = [i + 1 for i, k in enumerate(f["flags"]) if k]
        res = f["res"]
        log(f"[kf-device] {algo} {policy}, [main]'s config, {ds.num_frames} frames: keyframes "
            f"{kfs}, poses sha256 {f['digest']}, ATE {res.ate * 100:.2f} cm, mean keyframe "
            f"PSNR {res.mean_psnr:.2f} dB, alive {res.alive_per_frame[-1]}; fused counts per "
            f"step {f['counts']}, eager {e['counts']}; ms per tracking-only frame / keyframe "
            f"without a capture: fused {f['tracking_ms']:.1f} / {f['keyframe_ms']:.1f}, eager "
            f"{e['tracking_ms']:.1f} / {e['keyframe_ms']:.1f}; fused steps that captured "
            f"{f['capture_ms']} ms; fused equal to eager bit for bit: {same}; launches "
            f"{f['launches']}, plain versions {f['plain_calls']}; densify pick table "
            f"{tuple(f['sess'].kf_picks.shape)}, "
            f"{f['sess'].kf_picks.numel() * f['sess'].kf_picks.element_size()} bytes")
        require(f["counts"] == [(2, 0, 2)],
                f"[kf-device] {algo} fused counts {f['counts']}, want (2, 0, 2) on every step")
        require(all(c[1] == 1 for c in e["counts"]),
                f"[kf-device] {algo} eager counts {e['counts']}: one flag read per step")
        require(any(f["flags"]) and not all(f["flags"]),
                f"[kf-device] {algo} keyframes {kfs}: no mix of keyframes and tracking frames")
        require(all(same.values()), f"[kf-device] {algo} fused differs from eager: {same}")
        launches = f["launches"]
        require(all(launches[k] > 0 for k in ("K1", "K2", "K3"))
                and launches["K3"] == launches["K2"] and f["plain_calls"] == 0,
                f"[kf-device] {algo} launches {launches}, plain {f['plain_calls']}")
        require(np.isfinite(res.ate) and res.ate < 0.6 and res.mean_psnr > 14.0,
                f"[kf-device] {algo} ATE {res.ate:.3f} m, PSNR {res.mean_psnr:.2f} dB")
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
        counts0 = EngineStats(**vars(stats))
        if profile and idx == tail_kf:
            sess, out, busy = profiled_step(
                sess, ds.frames[idx], f"[sparse] {ds.name} "
                f"{'sparse' if sparse else 'dense'} keyframe {idx}", stats)
        else:
            sess, out = session_step(sess, ds.frames[idx], stats=stats)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        c = stats.since(counts0)
        rows.append(dict(idx=idx, kf=out.is_kf, ms=ms, profiled=busy is not None
                         and idx == tail_kf, work=[int(x) for x in out.work],
                         stable=int(sess.pstate.stable.sum()),
                         counts=(c.dispatches, c.syncs, c.replays)))
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
                captures=capture_text(sess.runner),
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
            f"plain versions {r['plain']}; (dispatches, syncs, replays) per step "
            f"{[x['counts'] for x in rows]}; the config's tracking graphs captured "
            f"(host seconds): {r['captures']}"
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
        # The stability warmup's end and every boundary ride inside the
        # one tracking replay.
        bad = [x["idx"] for x in r["rows"]
               if x["counts"] != (1 + x["kf"], 0, 1 + x["kf"])]
        require(not bad, f"{tag}: steps {bad} do not count 1 / 0 / 1 or 2 / 0 / 2")
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
    result, its launches, its boundaries fired and its steps' syncs."""
    import torch
    from repro_torch.slam.graphs import EngineStats
    from repro_torch.slam.session import session_finalize, session_init, session_step
    kernels, plains = reset_counters()
    sess = session_init(ds, cfg, device=dev, max_frames=max_frames)
    fired, stats = 0, EngineStats()
    for idx in range(1, frames):
        sess, out = session_step(sess, ds.frames[idx], stats=stats)
        fired += int(out.fired.sum())
    torch.cuda.synchronize()
    res = session_finalize(sess, gt_w2c=[f.w2c_gt for f in ds.frames])
    require(sum(fn.calls for fn in plains) == 0, "a solo run ran a plain version")
    return dict(sess=sess, res=res, fired=fired, syncs=stats.syncs,
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
    frame-step with keyframe rows must add [main]'s keyframe work once (2 /
    0 / 2: the S-row keyframe graph maps every keyframe row in one replay),
    K1/K2/K3 must launch the sum of the solo runs' launches, no plain
    version may run, and every row's ATE must be under 0.30 m (but
    corridor0's, ``ATE_UNBOUNDED``) and its mean keyframe PSNR over 17 dB."""
    import numpy as np
    import torch
    from _session_state import same_session
    from repro_torch.slam.sched import default_decode
    from repro_torch.slam.server import ShardedPool, SlamServer
    from repro_torch.slam.session import session_finalize, session_init, warm_keyframe

    cfg = main_config()
    data = {"room0": ds, **{n: make_scene(dev, n) for n in (*SERVE_SCENES[1:], "room1")}}
    host = {n: [default_decode(f) for f in d.frames] for n, d in data.items()}
    solo = {"desk0": solo_run(dev, data["desk0"], cfg, 12),
            "corridor0": solo_run(dev, data["corridor0"], cfg, 12),
            "stairs0": solo_run(dev, data["stairs0"], cfg, SERVE_RETIRE + 1),
            "room1": solo_run(dev, data["room1"], cfg, 12 - SERVE_RETIRE)}
    solo["room0"] = dict(sess=main_info["sess"], launches=main_launches)
    gt = {n: [f.w2c_gt for f in d.frames] for n, d in data.items()}

    # The S=4 and S=2 keyframe graphs, captured before serving as
    # ``PoolLadder.warmup`` captures them (a scratch keyframe on copies of
    # room0's session), so that a keyframe frame-step captures nothing.
    t0 = time.perf_counter()
    for width in (4, 2):
        warm_keyframe(session_init(ds, cfg, device=dev), width)
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3

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
    # [main]'s keyframe less its tracking replay (its counts hold whether or
    # not the step captured a graph), once per frame-step with keyframe rows.
    (kf_d, kf_s, kf_r), = main_info["counts"]["keyframe"]
    per_kf = {"dispatches": kf_d - 1, "syncs": kf_s, "replays": kf_r - 1}
    bad_counts = [r["step"] for r in rows if not r["counts"].captures and (
        (r["counts"].dispatches, r["counts"].syncs, r["counts"].replays)
        != (1 + per_kf["dispatches"] * any(r["kf"]), per_kf["syncs"] * any(r["kf"]),
            1 + per_kf["replays"] * any(r["kf"])))]
    want = {k: sum(solo[n]["launches"][k] for n in solo) for k in ("K1", "K2", "K3")}
    equal = {n: same_session(finals[n], solo[n]["sess"]) for n in solo}
    digest = pose_digest(results["room0"].est_w2c)
    log(f"[serve] S=4 {W}x{H} rows {list(SERVE_SCENES)}, 12 frames each, stairs0 retired "
        f"after frame {SERVE_RETIRE} and room1 admitted in its slot ({retired['admit_ms']:.0f} "
        f"ms, session_init included): wall {wall:.2f} s for 11 frame-steps; "
        + split_line(4, split4) + f"; keyframe steps {[r['step'] for r in rows if any(r['kf'])]} "
        f"with {[sum(r['kf']) for r in rows if any(r['kf'])]} keyframe rows; per keyframe "
        f"frame-step +{per_kf['dispatches']:.0f} dispatches, +{per_kf['syncs']:.0f} syncs, "
        f"+{per_kf['replays']:.0f} replays ([main]'s keyframe less its tracking replay), "
        "however many rows map")
    log(f"[serve] S=4 rows equal their solo runs bit for bit: {equal}; room0 poses sha256 "
        f"{digest} ([main] {main_info['digest']}); the S=4 and S=2 keyframe graphs captured "
        f"before serving in {warm_ms:.0f} ms; launches {launches} against the solo "
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
    row equals its solo run bit for bit, with the same boundaries, and
    every frame-step counts 1 / 0 / 1 (2 / 0 / 2 with keyframe rows): the
    rows' boundaries run inside the one tracking replay."""
    import torch
    from _session_state import same_session
    from repro_torch.core.pruning import PruneConfig
    from repro_torch.slam.server import ShardedPool, SlamServer
    from repro_torch.slam.session import session_init

    cfg = main_config(prune=PruneConfig(k0=5, step_frac=0.08))
    names, n = ("room0", "desk0"), SERVE_PRUNE_FRAMES
    solo = {m: solo_run(dev, data[m], cfg, n, max_frames=n) for m in names}
    kernels, plains = reset_counters()
    pool = ShardedPool([session_init(data[m], cfg, device=dev, max_frames=n) for m in names])
    srv = SlamServer(pool, queue_depth=2)
    torch.cuda.synchronize()
    base_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    rows = serve_steps(srv, {s: host[m][1:n] for s, m in enumerate(names)}, n - 1)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = {k: fn.launches for k, fn in kernels.items()}
    plain_calls = sum(fn.calls for fn in plains)
    fired = [sum(r["fired"][s] for r in rows) for s in range(2)]
    equal = [same_session(pool.session(s), solo[m]["sess"]) for s, m in enumerate(names)]
    want = {k: sum(solo[m]["launches"][k] for m in names) for k in ("K1", "K2", "K3")}
    counts = [(r["counts"].dispatches, r["counts"].syncs, r["counts"].replays) for r in rows]
    want_counts = [(1 + any(r["kf"]), 0, 1 + any(r["kf"])) for r in rows]
    split = step_split(rows)
    log(f"[serve-prune] S=2 {W}x{H} rows {list(names)}, {n} frames, PruneConfig(k0=5, "
        f"step_frac=0.08), no downsampling: boundaries fired per row {fired} (solo "
        f"{[solo[m]['fired'] for m in names]}), solo runs' syncs "
        f"{[solo[m]['syncs'] for m in names]}; rows equal "
        f"their solo runs bit for bit: {equal}; " + split_line(2, split)
        + f"; launches {launches} against the solo runs' sum {want}, plain versions "
        f"{plain_calls}; per step (dispatches, syncs, replays) {counts}; tracking "
        f"graphs captured (host seconds): {capture_text(pool.stacked.runner)}; peak "
        f"device memory {peak_gb:.2f} GB ({peak_gb - base_gb:+.2f} GB over the "
        f"{base_gb:.2f} GB held before the pool stepped)")
    require(all(equal), f"[serve-prune] rows differ from their solo runs: {equal}")
    require(fired == [solo[m]["fired"] for m in names] and sum(fired) > 0,
            f"[serve-prune] boundaries {fired} != solo")
    require(counts == want_counts, f"[serve-prune] counts {counts} != {want_counts}")
    require(all(solo[m]["syncs"] == 0 for m in names),
            f"[serve-prune] the solo runs read {[solo[m]['syncs'] for m in names]} times")
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


# PagedMap.  The reference bench's corridor config
# (``benchmarks/bench_paged.py:57-78``) at its own 48x64, then corridor0 at
# the card's 640x480 with the same share of storage in view (48 of 128
# pages: the bench's 6 of 16) and the bench's pose and mapping knobs.
PAGED_FRAMES = 24
# (tag, the dataset's source, height, width, capacity, (page_capacity,
# visible_pages), Gaussians).  "reference": the bench's own inputs, the
# reference's corridor0 draw (``tests/data``, written by
# ``tests/_bench_data.py``); "port": the port's numpy draw of the scene.
PAGED_CORRIDORS = (("bench", "reference", 48, 64, 4096, (256, 6), 4096),
                   ("bench, port's draw", "port", 48, 64, 4096, (256, 6), 4096),
                   ("card", "port", H, W, 131072, (1024, 48), 16384))
BENCH_DATA = TESTS / "data" / "corridor0_48x64_24.npz"
PAGED_BENCH = dict(iters_track=8, lr_pose=0.02, iters_map=8, map_window=3,
                   map_rebuild_stride=3, densify_per_kf=128, frag_capacity=256)


def paged_bench_config(capacity, paged=None):
    from repro_torch.core.keyframes import KeyframePolicy
    from repro_torch.core.pruning import PruneConfig
    from repro_torch.slam.session import SLAMConfig
    return SLAMConfig(capacity=capacity, keyframe=KeyframePolicy(kind="monogs", interval=2),
                      prune=PruneConfig(k0=3, step_frac=0.1), paged=paged, **PAGED_BENCH)


def paged_run(dev, ds, cfg, frames, profile_label=None):
    """A solo session over ``ds``'s first ``frames`` frames, every counter
    set to 0 just before: per step its ms (host clock to a
    ``torch.cuda.synchronize()``), ``EngineStats`` delta, keyframe flag and
    ``frag_build_rows``; the result, launches and peak device memory.  With
    ``profile_label``, one more keyframe step after the run (frame
    ``frames - 1``'s images again) under ``torch.profiler``: the device
    time of its gemm/gemv kernels (the projection's batched 3x3 products,
    ``aten::bmm``, replayed inside the keyframe graph)."""
    import dataclasses

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.slam.graphs import EngineStats
    from repro_torch.slam.session import session_finalize, session_init, session_step

    torch.cuda.synchronize()
    base_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    kernels, plains = reset_counters()
    stats = EngineStats()
    t_run = time.perf_counter()
    sess = session_init(ds, cfg, device=dev, stats=stats)
    torch.cuda.synchronize()
    rows = []
    for idx in range(1, frames):
        # Alive rows the step's working set leaves out (paged; computed
        # outside the timed step, as the step computes it inside).
        alive_out = 0
        if cfg.paged is not None:
            view = torch.zeros_like(sess.g.alive).index_fill_(0, sess.stage._working_set(
                sess.page, sess.velocity @ sess.pose, sess.kf_w2c), True)
            alive_out = int((sess.g.alive & ~view).sum())
            torch.cuda.synchronize()
        before = dataclasses.replace(stats)
        t0 = time.perf_counter()
        sess, out = session_step(sess, ds.frames[idx], stats=stats)
        torch.cuda.synchronize()
        rows.append(dict(step=idx, ms=(time.perf_counter() - t0) * 1e3,
                         counts=stats.since(before), kf=(bool(out.is_kf),),
                         fired=int(out.fired.sum()), alive_out=alive_out,
                         pose=out.pose.clone(), build_rows=int(out.work.frag_build_rows)))
    wall = time.perf_counter() - t_run
    res = session_finalize(sess, gt_w2c=[f.w2c_gt for f in ds.frames[:frames]],
                           wall_time_s=wall, stats=stats)
    out = dict(sess=sess, res=res, rows=rows, wall=wall,
               launches={k: fn.launches for k, fn in kernels.items()},
               plain_calls=sum(fn.calls for fn in plains), base_gb=base_gb,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    if profile_label is not None:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            sess, step = session_step(sess, ds.frames[frames - 1])
            torch.cuda.synchronize()
        require(step.is_kf, f"[paged] {profile_label}: the profiled step is no keyframe")
        events = prof.key_averages()
        kern = [e for e in events if e.device_type == DeviceType.CUDA]
        gemm = [e for e in kern if "gemm" in e.key.lower() or "gemv" in e.key.lower()]
        out["bmm_ms"] = sum(e.self_device_time_total for e in gemm) / 1e3
        out["busy_ms"] = sum(e.self_device_time_total for e in kern) / 1e3
        log(f"[profile] [paged] {profile_label} keyframe: kernels busy {out['busy_ms']:.1f} "
            f"ms, gemm/gemv kernels (the projection's aten::bmm) {out['bmm_ms']:.1f} ms in "
            f"{sum(e.count for e in gemm)} launches")
        log(events.table(sort_by="self_cuda_time_total", row_limit=12))
    return out


def paged_text(tag, run, storage_rows):
    sp = step_split(run["rows"])
    t, k = sp["tracking"], sp["keyframe"]
    rows = [r["build_rows"] for r in run["rows"]]
    res = run["res"]
    return (f"{tag}: {run['wall'] * 1e3 / (len(run['rows']) + 1):.1f} ms per frame with "
            f"init; tracking-only frame {t['ms']:.1f} ms ({t['steps']} steps, "
            f"{t['dispatches']:.1f} / {t['syncs']:.1f} / {t['replays']:.1f} dispatches / syncs "
            f"/ replays), keyframe {k['ms']:.1f} ms ({k['steps']} steps, {k['dispatches']:.1f} "
            f"/ {k['syncs']:.1f} / {k['replays']:.1f}), steps that captured a graph "
            f"{sp['capture_ms'] or 'none'} ms; frag_build_rows {sum(rows)} (last 3 steps "
            f"{sum(rows[-3:])}; {sum(rows) / (storage_rows * len(rows)):.3f} of storage per "
            f"step), ATE {res.ate * 100:.2f} cm, mean keyframe PSNR {res.mean_psnr:.3f} dB, "
            f"alive {res.alive_per_frame[-1]}, densify dropped {res.work.densify_dropped}, "
            f"peak device memory {run['peak_gb']:.2f} GB ({run['peak_gb'] - run['base_gb']:+.2f} GB "
            f"over the {run['base_gb']:.2f} GB held before the run), launches "
            + ", ".join(f"{k_} {v}" for k_, v in run["launches"].items() if v)
            + (f", gemm/gemv per keyframe {run['bmm_ms']:.1f} ms" if "bmm_ms" in run else "")
            + f"; sha256 {pose_digest(res.est_w2c)}; the config's tracking graphs "
            f"captured (host seconds): {capture_text(run['sess'].runner)}")


def bench_dataset(dev):
    """The reference bench's corridor0 inputs from ``BENCH_DATA`` as a port
    dataset."""
    from types import SimpleNamespace

    import numpy as np
    from repro_torch import convert
    z = np.load(BENCH_DATA)
    fx, fy, cx, cy, width, height = z["intrinsics"]
    frames = [SimpleNamespace(rgb=r, depth=d, w2c_gt=w)
              for r, d, w in zip(z["rgb"], z["depth"], z["w2c"])]
    gt = SimpleNamespace(**{k[3:]: z[k] for k in z.files if k.startswith("gt_")})
    return convert.dataset_from_numpy(SimpleNamespace(
        name="corridor0", frames=frames, gt_field=gt,
        intrinsics=SimpleNamespace(fx=fx, fy=fy, cx=cx, cy=cy, width=width,
                                   height=height)), device=dev)


def step_counts_ok(run, cfg) -> bool:
    """Every step counts what the fused engine's formula gives a flat step
    of the same keyframe decision (``slam/graphs.py``): 1 / 0 / 1 and, on
    a keyframe, 2 / 0 / 2, with pruning too (its boundaries ride inside
    the tracking replay)."""
    for r in run["rows"]:
        kf = int(r["kf"][0])
        if (r["counts"].dispatches, r["counts"].syncs, r["counts"].replays) != (
                1 + kf, 0, 1 + kf):
            return False
    return True


def paged_first_gradient(dev, ds, pc):
    """From the first state of a flat and a paged session of the bench's
    config: the first tracking iteration's render, loss and pose gradient
    over the whole pool (flat) and over the view (paged, whose products
    with the pose run over storage-sized operands, ``project``'s
    ``storage``); they must agree bit for bit."""
    import torch
    from repro_torch.core import lie
    from repro_torch.core.losses import slam_loss
    from repro_torch.slam.engine import silence
    from repro_torch.slam.map.paged import gather_field
    from repro_torch.slam.session import session_init

    sess = session_init(ds, paged_bench_config(4096, pc), device=dev)
    st, base, frame = sess.stage, sess.velocity @ sess.pose, ds.frames[1]
    view = st._working_set(sess.page, base, sess.kf_w2c)
    out = {}
    for name, g, masked, storage in (
            ("flat", sess.g, sess.cur_masked, None),
            ("paged", gather_field(sess.g, view), sess.cur_masked.index_select(0, view),
             (view, sess.g.capacity))):
        xi = torch.zeros(6, device=dev, requires_grad=True)
        with torch.enable_grad():
            r = st._render(silence(g, masked), lie.se3_exp(xi) @ base,
                           st._build(g, masked, base), storage=storage)
            loss = slam_loss(r.image, r.depth, r.alpha, frame.rgb, frame.depth,
                             st.cfg.lambda_pho)
            out[name] = (r.image.detach(), loss.detach(), torch.autograd.grad(loss, [xi])[0])
    (img_f, loss_f, grad_f), (img_p, loss_p, grad_p) = out["flat"], out["paged"]
    same = {"image": torch.equal(img_f, img_p), "loss": torch.equal(loss_f, loss_p),
            "pose gradient": torch.equal(grad_f, grad_p)}
    log(f"[paged] the bench config's first tracking iteration from one state, over the "
        f"pool's {sess.g.capacity} rows and the view's {view.numel()}: equal bit for bit "
        f"{same} (largest pose-gradient difference "
        f"{float((grad_f - grad_p).abs().max()):.3g} of {float(grad_f.abs().max()):.3g})")
    require(all(same.values()), f"[paged] the first tracking iteration differs: {same}")


def paged_gates(flat, paged, cfg, psnr_gate=0.2):
    """``bench_paged.py:159-171``'s gates, unchanged: late (last 3 steps)
    fragment-build rows fall >= 1.6x, PSNR loss <= ``psnr_gate`` dB, paged
    ATE within 5% + 2 cm of flat's; and the port's form of its one-dispatch
    gate: paged adds no dispatch, sync or replay, i.e. each step of both
    runs counts the formula of a flat step with its boundaries and keyframe
    decision (``step_counts_ok``)."""
    f_rows = [r["build_rows"] for r in flat["rows"]]
    p_rows = [r["build_rows"] for r in paged["rows"]]
    late = sum(f_rows[-3:]) / max(sum(p_rows[-3:]), 1)
    loss = flat["res"].mean_psnr - paged["res"].mean_psnr
    ate_f, ate_p = flat["res"].ate, paged["res"].ate

    return {
        f"late build-row reduction {late:.2f}x >= 1.6x": late >= 1.6,
        f"PSNR loss {loss:.3f} dB <= {psnr_gate} dB": loss <= psnr_gate,
        f"paged ATE {ate_p * 100:.2f} cm <= flat {ate_f * 100:.2f} cm x 1.05 + 2 cm":
            ate_p <= ate_f * 1.05 + 2e-2,
        "paged and flat count the flat step's dispatches, syncs and replays":
            step_counts_ok(flat, cfg) and step_counts_ok(paged, cfg),
    }


def phase_paged(dev, ds, main, sched, desk0, profile=False):
    """``[paged]``: PagedMap on the card.

    1. [main]'s config with ``PagedConfig(page_capacity=1024,
       visible_pages=128)``, every page in view: equal to [main] bit for
       bit (poses, PSNR, keyframes, every work counter, the map), counting
       1 / 0 / 1 per tracking-only frame and 2 / 0 / 2 per keyframe, with
       [main]'s launches; the same on ``schedule`` against [main-sched];
       then a 2-row pool (room0, desk0) equal to its solo paged runs.
    2. The corridor runs (:func:`phase_paged_corridors`)."""
    import dataclasses

    import numpy as np
    import torch
    from _session_state import same_session
    from repro_torch.core import gaussians as G
    from repro_torch.slam.map.paged import PagedConfig
    from repro_torch.slam.server import ShardedPool
    from repro_torch.slam.session import session_init

    launches_by = {}
    capacity = main_config().capacity
    all_visible = PagedConfig(page_capacity=1024, visible_pages=capacity // 1024)
    for label, (m_launches, m_res, m_kfs, m_info), backend in (
            ("kernel", main, "kernel"), ("schedule", sched, "schedule")):
        cfg = main_config(backend=backend, paged=all_visible)
        run = paged_run(dev, ds, cfg, ds.num_frames)
        res, sess = run["res"], run["sess"]
        kfs = [0] + [r["step"] for r in run["rows"] if r["kf"][0]]
        same_map = all(torch.equal(getattr(sess.g, f), getattr(m_info["sess"].g, f))
                       for f in G.PARAM_FIELDS + ("alive",))
        same = {"poses": pose_digest(res.est_w2c) == m_info["digest"]
                and all(np.array_equal(a, b) for a, b in zip(res.est_w2c, m_res.est_w2c)),
                "PSNR": res.keyframe_psnr == m_res.keyframe_psnr,
                "keyframes": kfs == m_kfs, "work": res.work == m_res.work,
                "alive": res.alive_per_frame == m_res.alive_per_frame, "map": same_map,
                "launches": all(run["launches"][k] == m_launches[k] for k in m_launches)}
        counts = {kind: sorted({(r["counts"].dispatches, r["counts"].syncs,
                                 r["counts"].replays) for r in run["rows"]
                                if r["kf"][0] == (kind == "keyframe")})
                  for kind in ("tracking", "keyframe")}
        log(f"[paged] all {cfg.capacity // 1024} pages of 1024 in view, [main]'s config on "
            f"{label}: " + paged_text("room0", run, cfg.capacity)
            + f"; equal to [main{'' if label == 'kernel' else '-sched'}] bit for bit: {same}; "
            f"counts per step {counts}")
        require(all(same.values()), f"[paged] all-visible {label} differs from flat: {same}")
        require(counts == {"tracking": [(1, 0, 1)], "keyframe": [(2, 0, 2)]},
                f"[paged] all-visible {label} counts {counts}")
        require(run["plain_calls"] == 0, f"[paged] {label} ran a plain version")
        launches_by["paged" if label == "kernel" else "paged_sched"] = run["launches"]
        if label == "kernel":
            solo_room0 = sess

    # A 2-row pool of the all-visible config against its solo runs.
    cfg = main_config(paged=all_visible)
    solo_desk0 = paged_run(dev, desk0, cfg, desk0.num_frames)["sess"]
    kernels, plains = reset_counters()
    pool = ShardedPool([session_init(d, cfg, device=dev) for d in (ds, desk0)])
    counts = []
    for t in range(1, ds.num_frames):
        before = dataclasses.replace(pool.stats)
        res = pool.step([ds.frames[t], desk0.frames[t]])
        d = pool.stats.since(before)
        counts.append((sum(res.is_kf), d.dispatches, d.syncs, d.replays, d.captures))
    launches_by["paged_pool"] = {k: fn.launches for k, fn in kernels.items()}
    equal = [same_session(pool.session(0), solo_room0),
             same_session(pool.session(1), solo_desk0)]
    log(f"[paged] S=2 pool (room0, desk0), all pages in view: rows equal their solo paged "
        f"runs bit for bit: {equal}; per frame-step (keyframe rows, dispatches, syncs, "
        f"replays, captures) {counts}")
    require(all(equal), f"[paged] pool rows differ from their solo runs: {equal}")
    require(all((d, s, r) == (1 + (n > 0), 0, 1 + (n > 0)) for n, d, s, r, c in counts
                if not c), f"[paged] pool counts {counts}")
    launches_by.update(phase_paged_corridors(dev, profile))
    return launches_by


def phase_paged_corridors(dev, profile=False):
    """``[paged]``'s corridor runs: the reference bench's corridor config at
    48x64 (capacity 4096, ``PagedConfig(256, 6)``, 24 frames) on the
    bench's own inputs (``BENCH_DATA``), then on the port's own draw of
    corridor0, then corridor0 at 640x480 (capacity 131072,
    ``PagedConfig(1024, 48)``, the bench's knobs), flat and paged: ms per
    frame, build rows, ATE, PSNR, peak memory, (``profile``) the keyframe's
    gemm time, and the bench's four gates, printed as pass or fail.
    Required of each: both runs count the flat step's formula at every
    step, every paged build sweeps the view's rows, and paged equals flat
    bit for bit up to the first step whose view leaves out an alive row;
    on the bench's own inputs, first, the first tracking iteration's pose
    gradient over the view equals flat's bit for bit, and the four gates
    pass."""
    import numpy as np
    import torch
    from repro_torch.slam.datasets import make_dataset
    from repro_torch.slam.map.paged import PagedConfig

    launches_by = {}
    for tag, source, height, width, capacity, (page_capacity, visible), gaussians \
            in PAGED_CORRIDORS:
        paged_cfg = PagedConfig(page_capacity=page_capacity, visible_pages=visible)
        t0 = time.perf_counter()
        dsc = (bench_dataset(dev) if source == "reference" else make_dataset(
            "corridor0", num_frames=PAGED_FRAMES, height=height, width=width,
            num_gaussians=gaussians, frag_capacity=PAGED_BENCH["frag_capacity"], device=dev))
        require((dsc.num_frames, dsc.intrinsics.height, dsc.intrinsics.width)
                == (PAGED_FRAMES, height, width), f"[paged] {tag}: dataset shape")
        if source == "reference":
            paged_first_gradient(dev, dsc, paged_cfg)
        runs = {}
        for name, pc in (("flat", None), ("paged", paged_cfg)):
            runs[name] = paged_run(dev, dsc, paged_bench_config(capacity, pc), PAGED_FRAMES,
                                   profile_label=f"{tag} {name}" if profile and tag == "card"
                                   else None)
            log(f"[paged] corridor0 ({source}'s draw) {width}x{height}, capacity {capacity}, "
                + (f"PagedConfig({pc.page_capacity}, {pc.visible_pages}) "
                   f"({pc.visible_pages * pc.page_capacity / capacity:.3f} of storage)"
                   if pc else "flat")
                + f", {PAGED_FRAMES} frames, the bench's knobs: "
                + paged_text(name, runs[name], capacity))
            require(runs[name]["plain_calls"] == 0, f"[paged] {tag} {name} ran a plain version")
            require(np.isfinite(runs[name]["res"].mean_psnr), f"[paged] {tag} {name} PSNR")
        cfg = paged_bench_config(capacity)
        gates = paged_gates(runs["flat"], runs["paged"], cfg)
        # Where paged parts from flat, and where its working set first
        # leaves out an alive row.
        f_rows, p_rows = runs["flat"]["rows"], runs["paged"]["rows"]
        first_out = next((r["step"] for r in p_rows if r["alive_out"]), None)
        first_diff = next((a["step"] for a, b in zip(f_rows, p_rows)
                           if not torch.equal(a["pose"], b["pose"])), None)
        m_rows = visible * page_capacity
        log(f"[paged] corridor0 {tag} ({width}x{height}) gates: " + "; ".join(
            f"{g}: {'pass' if ok else 'FAIL'}" for g, ok in gates.items())
            + f"; alive rows out of the view per step {[r['alive_out'] for r in p_rows]}, "
            f"first at step {first_out}; paged poses equal flat's bit for bit through step "
            f"{(first_diff or PAGED_FRAMES) - 1} of {PAGED_FRAMES - 1}; "
            f"{time.perf_counter() - t0:.1f} s")
        require(step_counts_ok(runs["flat"], cfg) and step_counts_ok(runs["paged"], cfg),
                f"[paged] {tag}: a step breaks the count formula")
        require(first_diff is None or (first_out is not None and first_diff >= first_out),
                f"[paged] {tag}: paged parts from flat at step {first_diff}, before any "
                f"alive row left the view (step {first_out})")
        if source == "reference":
            require(all(gates.values()), f"[paged] {tag}: the bench's gates {gates}")
        require(all(r["build_rows"] % m_rows == 0 for r in p_rows),
                f"[paged] {tag}: a paged build swept other than the view's {m_rows} rows")
        if source == "reference" or tag == "card":
            launches_by[f"paged_corridor_{tag}"] = runs["paged"]["launches"]
    return launches_by


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


# [lm]: the LM scaffold's serving path (models/, launch/serve.py).  It
# reaches no pallas_call, so it adds no kernel to the kernels line.
LM_FULL = ("zamba2-1.2b", "phi4-mini-3.8b")
LM_FORWARD_CHECK = ("llama3-405b", "xlstm-125m", "zamba2-1.2b", "qwen3-moe-30b-a3b")
LM_PREFILL_TOL, LM_DECODE_TOL = 3e-2, 7e-2  # the reference's own prefill / decode
# whisper-large-v3's prefill on the card parts from its CPU run by up to
# ~5e-2 at reduced size: cuBLAS and MKL sum the bf16 GEMMs in other orders,
# and its two encoder and four decoder layers, each attending over the whole
# memory, spread one flipped rounding furthest; it is held to the decode
# tolerance, which the reference sets for accumulation-order differences.
LM_PREFILL_TOL_BY_ARCH = {"whisper-large-v3": LM_DECODE_TOL}
LM_SERVE_BATCH, LM_PROMPT, LM_GEN = 4, 256, 64
# Decode vs forward at full width (prefill 127 / decode token 128 against a
# forward over 128).  The reference's own gap grows with depth at full width:
# zamba2's is 0.05 at 2 layers and 0.09 at 8 (its bf16 causal conv rounds
# each product in the chunked path and once in the decode step), which
# tests/test_torch_lm.py measures on the CPU against the port's, and
# tools/lm_serve.py gaps prints on the card by depth; phi4 stays within the
# reference's decode tolerance.
LM_FULL_GAP_TOL = {"zamba2-1.2b": 0.25, "phi4-mini-3.8b": LM_DECODE_TOL}


def lm_tree(tree, fn):
    return {k: lm_tree(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def lm_leaves(tree) -> list:
    return [x for v in tree.values()
            for x in (lm_leaves(v) if isinstance(v, dict) else [v])]


def lm_teacher_forced(model, params, batch, feed):
    """Prefill, pad_cache, then one decode step per row of ``feed``; every
    step's logits."""
    import torch
    logits, cache = model.prefill(params, batch)
    cache = model.pad_cache(cache, model.prompt_len(batch) + len(feed) + 1)
    out = [logits]
    for tok in feed:
        logits, cache = model.decode_step(params, cache, tok)
        out.append(logits)
    return out, cache


def lm_decode_vs_forward(model, params, toks, tol=None):
    """The reference's invariant (tests/test_models.py): prefill over all
    but the last token, decode the last, against one forward over all of
    them.  Returns the two max |d| and whether each is within tolerance
    (``tol``, else the prefill and decode tolerances)."""
    from repro_torch.models.lm import BF16
    n = toks.shape[1] - 1
    xx = model._backbone(params, model._embed_inputs(params, {"tokens": toks}))[0]
    full = model._logits(params, xx[:, n - 1:n + 1].to(BF16))
    logits_p, cache = model.prefill(params, {"tokens": toks[:, :n]})
    logits_d, _ = model.decode_step(params, model.pad_cache(cache, n + 2), toks[:, n:])
    pairs = ((logits_p[:, 0], full[:, 0], tol or LM_PREFILL_TOL),
             (logits_d[:, 0], full[:, 1], tol or LM_DECODE_TOL))
    return [(max_err(a, b), close(a, b, tol, tol)) for a, b, tol in pairs]


def phase_lm(dev, profile=False):
    """The LM serving path on the card: zamba2-1.2b and phi4-mini-3.8b at
    full width (init on the card, ``serve`` of 4 x 256 prompt tokens and 64
    greedy tokens: one warm-up, then the median of 3; decode vs forward at
    128 tokens; a decode step under ``set_sync_debug_mode("error")``; with
    ``profile`` one traced decode step each), first, so that no CPU work of
    this phase runs beside the timed runs; then the ten architectures at
    reduced size against the port's own CPU run (prefill, pad_cache, 4
    teacher-forced decode steps) and the reference's decode-vs-forward
    invariant on the card."""
    import dataclasses
    import statistics

    import numpy as np
    import torch
    from repro_torch.configs import get_arch, list_archs
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.serve import device_batch, serve
    from repro_torch.models.lm import Model, init_params
    from repro_torch.train.data import synthetic_batch

    t0 = time.perf_counter()
    out = {}
    for name in LM_FULL:
        cfg = get_arch(name)
        model = Model(cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        t1 = time.perf_counter()
        params = init_params(cfg, gen, device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t1
        leaves = lm_leaves(params)
        param_bytes = sum(t.numel() * t.element_size() for t in leaves)
        require(all(t.device.type == "cuda" for t in leaves), f"[lm] {name}: params off the card")
        batch = device_batch(synthetic_batch(
            cfg, ShapeSpec("serve", LM_PROMPT, LM_SERVE_BATCH, "prefill"), 0), dev)
        init_peak = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        runs = [serve(model, params, batch, LM_GEN) for _ in range(4)]  # warm-up + 3
        for res in runs:
            require(bool(res.finite), f"[lm] {name}: a logit of the run is not finite")
            require(all(t.device.type == "cuda" for t in (res.tokens, res.last_logits)),
                    f"[lm] {name}: an output is off the card")
            require(int(res.tokens.min()) >= 0 and int(res.tokens.max()) < cfg.vocab_size,
                    f"[lm] {name}: a generated id is out of the vocabulary")
        require(all(torch.equal(r.tokens, runs[0].tokens) for r in runs[1:]),
                f"[lm] {name}: the greedy ids differ between identical runs")
        peak = torch.cuda.max_memory_allocated(dev)
        pre = statistics.median(r.prefill_s for r in runs[1:])
        dec = statistics.median(r.decode_s for r in runs[1:])
        tol = LM_FULL_GAP_TOL[name]
        (ep, okp), (ed, okd) = lm_decode_vs_forward(model, params, batch["tokens"][:, :128], tol)
        # no readback in a decode step at full width
        logits, cache = model.prefill(params, {"tokens": batch["tokens"][:, :32]})
        cache = model.pad_cache(cache, 40)
        tok = torch.argmax(logits, dim=-1)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            logits2, cache = model.decode_step(params, cache, tok)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        require(bool(torch.isfinite(logits2).all()), f"[lm] {name}: synced decode not finite")
        ntok = LM_SERVE_BATCH * LM_PROMPT
        out[name] = dict(params=sum(t.numel() for t in leaves), param_bytes=param_bytes,
                         init_s=init_s, prefill_ms=pre * 1e3, prefill_tok_s=ntok / pre,
                         decode_ms_per_token=dec * 1e3 / LM_GEN,
                         decode_tok_s=LM_SERVE_BATCH * LM_GEN / dec, peak_bytes=peak,
                         init_peak_bytes=init_peak,
                         decode_vs_forward=(ep, ed))
        log(f"[lm] {name} full width ({out[name]['params'] / 1e9:.3f} B params, "
            f"{param_bytes / 2**30:.2f} GiB bf16/f32, init {init_s:.2f} s): serve "
            f"{LM_SERVE_BATCH} x {LM_PROMPT} + {LM_GEN}: prefill {pre * 1e3:.2f} ms "
            f"({ntok / pre:.0f} tok/s), decode {dec * 1e3 / LM_GEN:.3f} ms per step "
            f"({LM_SERVE_BATCH * LM_GEN / dec:.1f} tok/s), median of 3 after a warm-up "
            f"(runs: prefill " + ", ".join(f"{r.prefill_s * 1e3:.2f}" for r in runs)
            + " ms; decode " + ", ".join(f"{r.decode_s * 1e3:.1f}" for r in runs)
            + f" ms); peak memory serving {peak / 2**30:.2f} GiB (init "
            f"{init_peak / 2**30:.2f} GiB); greedy ids of row 0 "
            f"{runs[0].tokens[0, :8].tolist()}...; decode vs forward at 128 tokens: "
            f"prefill of 127 {ep:.2e}, decode of token 128 {ed:.2e}; a decode step under "
            "set_sync_debug_mode('error') ran")
        require(okp and okd, f"[lm] {name}: decode disagrees with the forward at full width")
        if profile:
            out[name]["profile"] = lm_profile(name, model, params, cache, tok)
        if name in LM_ROOFLINE_SERVE:
            out[name]["counts"] = lm_serve_counts(model, params, batch)
            out[name]["times"] = lm_serve_times(name, model, params, batch)
        del params, cache, runs, leaves, logits, logits2
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    shape = ShapeSpec("lm", seq_len=32, global_batch=2, kind="prefill")
    for name in list_archs():
        cfg = get_arch(name).reduced()
        model = Model(cfg)
        gen = torch.Generator()
        gen.manual_seed(0)
        p_cpu = init_params(cfg, gen, device="cpu")
        p_dev = lm_tree(p_cpu, lambda t: t.to(dev))
        feed = np.random.default_rng(1).integers(0, cfg.vocab_size, size=(4, 2, 1)).astype(np.int32)
        runs = {}
        for d, params in (("cpu", p_cpu), ("card", p_dev)):
            where = "cpu" if d == "cpu" else dev
            runs[d], cache = lm_teacher_forced(
                model, params, device_batch(synthetic_batch(cfg, shape, 0), where),
                [torch.from_numpy(t).to(where) for t in feed])
        require(all(t.device.type == "cuda" for t in runs["card"] + lm_leaves(cache)),
                f"[lm] {name}: a tensor of the card's run is not on the card")
        errs = [max_err(a.cpu(), b) for a, b in zip(runs["card"], runs["cpu"])]
        ok = [close(a.cpu(), b, tol, tol) for a, b, tol in zip(
            runs["card"], runs["cpu"],
            [LM_PREFILL_TOL_BY_ARCH.get(name, LM_PREFILL_TOL)] + [LM_DECODE_TOL] * len(feed))]
        log(f"[lm] {name} reduced, card vs CPU: max |d| prefill {errs[0]:.2e} "
            f"(tol {LM_PREFILL_TOL_BY_ARCH.get(name, LM_PREFILL_TOL):.0e}), "
            f"decode steps " + ", ".join(f"{e:.2e}" for e in errs[1:]) + " (tol 7e-2)"
            + ("" if all(ok) else "  FAIL"))
        require(all(ok), f"[lm] {name}: card and CPU logits differ beyond tolerance")
    for name in LM_FORWARD_CHECK:
        cfg = get_arch(name).reduced()
        if cfg.num_experts:  # no capacity drops: decode == forward needs them off
            cfg = dataclasses.replace(cfg, moe_capacity_factor=float(cfg.num_experts))
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        model, params = Model(cfg), init_params(cfg, gen, device=dev)
        toks = torch.from_numpy(np.random.default_rng(7).integers(
            0, cfg.vocab_size, size=(2, 17)).astype(np.int32)).to(dev)
        (ep, okp), (ed, okd) = lm_decode_vs_forward(model, params, toks)
        log(f"[lm] {name} reduced, decode vs forward on the card: prefill of 16 {ep:.2e}, "
            f"decode of token 16 {ed:.2e}")
        require(okp and okd, f"[lm] {name}: decode disagrees with the forward")
    t_reduced = time.perf_counter() - t1

    log(f"[lm] done in {time.perf_counter() - t0:.1f} s (the ten reduced architectures "
        f"and the decode-vs-forward checks {t_reduced:.1f} s)")
    return out


def lm_serve_counts(model, params, batch) -> dict:
    """FLOPs and bytes (``analysis.roofline.count_step``) of one untimed
    prefill as ``serve`` runs it (prefill and ``pad_cache``) and of one of
    its decode steps (``decode_step`` and the greedy pick)."""
    import torch
    from repro_torch.analysis.roofline import count_step

    t0 = time.perf_counter()

    def prefill():
        logits, cache = model.prefill(params, batch)
        return logits, model.pad_cache(cache, model.prompt_len(batch) + LM_GEN + 1)

    pre = count_step(prefill)
    logits, cache = pre.pop("out")

    def decode(cache, toks):
        logits, cache = model.decode_step(params, cache, toks)
        return torch.argmax(logits, dim=-1), cache

    dec = count_step(decode, cache, torch.argmax(logits, dim=-1))
    toks, _ = dec.pop("out")
    require(bool(torch.isfinite(logits).all()) and toks.shape == (batch["tokens"].shape[0], 1),
            "[roofline] a counted serving call went wrong")
    return {"prefill": pre, "decode": dec, "count_s": time.perf_counter() - t0}


def lm_serve_times(name, model, params, batch) -> dict:
    """The roofline rows' serving times: the median wall time of
    ``LM_ROOFLINE_REPS`` prefills (as ``serve`` runs them) and of as many
    decode steps, each call synchronized alone, then one of each traced:
    its kernels' busy time against its wall time says whether the card or
    the host bounds the call."""
    import statistics

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def prefill():
        logits, cache = model.prefill(params, batch)
        return logits, model.pad_cache(cache, model.prompt_len(batch) + LM_GEN + 1)

    def timed(fn, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn(*args)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, res

    pre = [timed(prefill)[0] for _ in range(LM_ROOFLINE_REPS)]
    logits, cache = prefill()
    tok = torch.argmax(logits, dim=-1)
    dec = []
    for _ in range(LM_ROOFLINE_REPS):
        t, (logits, cache) = timed(model.decode_step, params, cache, tok)
        dec.append(t)
    out = {"prefill_s": statistics.median(pre), "decode_s": statistics.median(dec)}
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for what, fn in (("prefill", prefill), ("decode", lambda: model.decode_step(params, cache, tok))):
        with profile(activities=activities):   # the tracer's own start-up
            timed(fn)
        with profile(activities=activities) as prof:
            wall = timed(fn)[0]
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA) / 1e6
        out[what + "_trace"] = dict(wall_s=wall, busy_s=busy)
    log(f"[roofline] {name} serving times, {LM_ROOFLINE_REPS} calls each, synchronized alone: "
        f"prefill median {out['prefill_s'] * 1e3:.2f} ms (min {min(pre) * 1e3:.2f}, max "
        f"{max(pre) * 1e3:.2f}), decode step median {out['decode_s'] * 1e3:.3f} ms (min "
        f"{min(dec) * 1e3:.3f}, max {max(dec) * 1e3:.3f}); traced: " + "; ".join(
            f"{w} wall {t['wall_s'] * 1e3:.2f} ms, kernels busy {t['busy_s'] * 1e3:.2f} ms, "
            f"device idle {100 * (1 - t['busy_s'] / t['wall_s']):.0f}%"
            for w, t in ((w, out[w + "_trace"]) for w in ("prefill", "decode"))))
    return out


def lm_profile(name, model, params, cache, tok) -> dict:
    """One traced full-width decode step: its host launch calls, the
    device's busy and idle time, and the top device operations."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for _ in range(2):   # warm: the tracer's own start-up, then one step
        with profile(activities=activities):
            _, cache = model.decode_step(params, cache, tok)
            torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=activities) as prof:
        _, cache = model.decode_step(params, cache, tok)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    busy_ms = sum(e.self_device_time_total for e in events
                  if e.device_type == DeviceType.CUDA) / 1e3
    launches = sum(e.count for e in events if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC"))
    log(f"[lm-profile] {name} one full-width decode step: wall {wall_ms:.2f} ms under the "
        f"profiler, kernels busy {busy_ms:.2f} ms, device idle {wall_ms - busy_ms:.2f} ms "
        f"({100 * (1 - busy_ms / wall_ms):.0f}%), {launches} cudaLaunchKernel calls")
    log(events.table(sort_by="self_cuda_time_total", row_limit=12))
    return dict(wall_ms=wall_ms, busy_ms=busy_ms, launches=launches)


# [lm-train]: the LM training path (models/ under autograd, train/optimizer.py,
# train/trainer.py, train/checkpoint.py, launch/train.py).  It reaches no
# pallas_call either, so it adds no kernel to the kernels line.
LM_TRAIN_FULL = {"phi4-mini-3.8b": 8, "zamba2-1.2b": 4}  # batch at 4096 tokens
LM_TRAIN_SEQ, LM_TRAIN_STEPS = 4096, 5   # train_4k's sequence length; step 1 warms up
LM_TRAIN_MB_CHECK = "phi4-mini-3.8b"     # one step with the config's microbatches
LM_TRAIN_FALL = 0.05                     # loss fall over the steps (tests/test_models.py)
LM_TRAIN_MB_TOL = dict(loss_rtol=2e-2, atol=3e-2)  # the reference's microbatch test
LM_TRAIN_PEAK_LIMIT = 80e9               # bytes: the card's memory
LM_ROOFLINE_SERVE = ("phi4-mini-3.8b",)  # [lm]'s models whose prefill and decode are counted
LM_ROOFLINE_REPS = 10                    # and timed again, call by call, for their rows
LM_REMAT_LAYERS, LM_REMAT_BATCH = 4, 2   # phi4-mini at full width cut to 4 layers
# The full-width microbatched step against the plain one, beyond the
# reference's tolerances (which a first Adam step meets with any gradient:
# it moves each element by about lr, m / sqrt(v) = +-1): the gradient norm,
# and on a strided sample of every leaf the share of elements that moved in
# either step whose moves differ in sign (a zero or wrong gradient gives
# ~1; only gradients near zero flip between the sums, and the bf16 rounding
# of the new value can keep one step's element in place).  Measured on an
# H100 80GB HBM3 at 700 W: grad norm 1.98e-4 apart, 102 of 32767 moved
# elements (3.1e-3).
LM_TRAIN_MB_GNORM_RTOL = 2e-2
LM_TRAIN_MB_SIGN_SHARE = 5e-2
LM_TRAIN_SAMPLE = 4096                   # elements sampled from each leaf
# The ten architectures at reduced size, card against the port's CPU run
# from the same state.  The gradients of loss_fn leaf by leaf, to the bound
# the CPU tests hold the port's to the reference's (relative L2 and cosine;
# a leaf whose CPU gradient is under 1e-6 in norm is held below 1e-5): the
# card sums its bf16 GEMMs and its atomics in other orders (worst measured
# on an H100 80GB HBM3: 2.31e-2 / 0.999735, whisper-large-v3's).  Then one
# train step: the loss and gradient norm (sums over every token and element) to
# rtol 1e-2, the parameters to the reference's microbatch tolerance as a
# sanity check (a first Adam step moves each element by about lr).
LM_GRAD_BOUND = dict(rel=5e-2, cos=0.998)
LM_TRAIN_CARD_TOL = dict(loss_rtol=1e-2, gnorm_rtol=1e-2, atol=3e-2)


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    return smi.splitlines()[0]


def lm_sample(t):
    """A strided sample of LM_TRAIN_SAMPLE elements across the leaf ``t``."""
    flat = t.reshape(-1)
    return flat[::max(1, flat.numel() // LM_TRAIN_SAMPLE)][:LM_TRAIN_SAMPLE].clone()


def lm_grad_worst(got: dict, want: dict, bound: dict):
    """Leaf by leaf, ``got``'s gradients against ``want``'s (the same paths):
    (worst relative L2, worst cosine, the leaves outside ``bound``)."""
    worst_rel, worst_cos, bad = 0.0, 1.0, []
    for k, w in want.items():
        wv, gv = w.double().reshape(-1), got[k].cpu().double().reshape(-1)
        wn, gn = float(wv.norm()), float(gv.norm())
        if wn < 1e-6:
            if not gn < 1e-5:
                bad.append((k, gn))
            continue
        rel = float((gv - wv).norm()) / wn
        cos = float(gv @ wv) / (wn * gn) if gn > 0 else 0.0
        worst_rel, worst_cos = max(worst_rel, rel), min(worst_cos, cos)
        if not (rel <= bound["rel"] and cos >= bound["cos"]):
            bad.append((k, rel, cos))
    return worst_rel, worst_cos, bad


def lm_free(dev) -> None:
    import gc

    import torch
    gc.collect()
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()


def lm_train_shape(batch_size: int):
    from repro_torch.configs.base import ShapeSpec

    return ShapeSpec(f"train_{batch_size}x{LM_TRAIN_SEQ}", LM_TRAIN_SEQ, batch_size, "train")


def lm_train_full(dev, name, batch_size, profile=False) -> dict:
    """``launch/train.py``'s path at full width (``--full --seq-len 4096
    --batch B``, TrainerConfig's AdamW with clipping) on one repeated batch:
    LM_TRAIN_STEPS steps, then for LM_TRAIN_MB_CHECK one step with the
    config's microbatches from the same initial state."""
    import dataclasses
    import itertools
    import statistics

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import train as launch_train
    from repro_torch.train.data import device_batch, synthetic_batch
    from repro_torch.train.optimizer import tree_paths
    from repro_torch.train.trainer import make_train_step
    from repro_torch.analysis import roofline

    args = launch_train.parse_args(["--arch", name, "--full", "--seq-len", str(LM_TRAIN_SEQ),
                                    "--batch", str(batch_size), "--steps", "1"])
    cfg = dataclasses.replace(get_arch(name), microbatches=1)
    batch = synthetic_batch(cfg, ShapeSpec("train", LM_TRAIN_SEQ, batch_size, "train"), 0)
    lm_free(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    trainer = launch_train.build(args, itertools.repeat(batch))
    require(trainer.device.type == "cuda", f"[lm-train] {name}: the trainer is not on the card")
    state = trainer.init_state()
    leaves = tree_paths(state["params"])
    n_params = sum(t.numel() for t in leaves.values())
    require(all(t.device.type == "cuda" for t in leaves.values()),
            f"[lm-train] {name}: params off the card")
    sample = {k: lm_sample(t) for k, t in leaves.items()}
    del leaves  # the step writes new leaves; these would keep the old ones
    state = trainer.run(state=state)          # step 1, the warm-up
    after_one = None
    if name == LM_TRAIN_MB_CHECK:
        after_one = {k: t.to("cpu") for k, t in tree_paths(state["params"]).items()}
    trainer.tcfg.steps = LM_TRAIN_STEPS
    state = trainer.run(state=state)
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev)
    hist = trainer.history
    losses = [h["loss"] for h in hist]
    gnorms = [h["grad_norm"] for h in hist]
    require(len(hist) == LM_TRAIN_STEPS and all(map(math.isfinite, losses + gnorms)),
            f"[lm-train] {name}: a loss or gradient norm is not finite: {losses} {gnorms}")
    leaves = tree_paths(state["params"])
    moved = {k: float((lm_sample(leaves[k]).float() - s.float()).abs().max())
             for k, s in sample.items()}
    # Every leaf but a norm's gain must move: a gain starts at 1.0, where an update
    # of about lr = 1e-3 is below half a bf16 ulp (2**-8), so it may not.
    still = [k for k, v in moved.items() if not v > 0]
    require(all(k.split("/")[-1] in ("ln", "ln1", "ln2", "lnx", "final_ln") for k in still),
            f"[lm-train] {name}: parameters did not move: {still}")
    step_s = statistics.median(trainer.step_times[1:])
    tokens = batch_size * LM_TRAIN_SEQ
    mfu = roofline.peak_share(roofline.model_flops(cfg, lm_train_shape(batch_size)), step_s)
    out = dict(params=n_params, batch=batch_size, seq=LM_TRAIN_SEQ, losses=losses,
               grad_norms=gnorms, step_ms=step_s * 1e3, step_ms_all=[t * 1e3 for t in
                                                                    trainer.step_times],
               tokens_s=tokens / step_s, mfu=mfu, peak_bytes=peak)
    log(f"[lm-train] {name} full width ({n_params / 1e9:.3f} B params) on {card_line()}, "
        f"launch/train.py "
        f"--full --seq-len {LM_TRAIN_SEQ} --batch {batch_size}, AdamW lr {trainer.tcfg.lr} "
        f"decay {trainer.tcfg.weight_decay} clip {trainer.tcfg.clip_norm}, remat "
        f"{cfg.remat}, one repeated batch: loss per step "
        + ", ".join(f"{v:.4f}" for v in losses) + "; grad norm "
        + ", ".join(f"{v:.3f}" for v in gnorms)
        + f"; {step_s * 1e3:.0f} ms per step (median of steps 2-{LM_TRAIN_STEPS}; all: "
        + ", ".join(f"{t * 1e3:.0f}" for t in trainer.step_times)
        + f" ms), {tokens / step_s:.0f} tokens/s, model-FLOP share {100 * mfu:.2f}% of "
        f"989 TFLOP/s (analysis.roofline: 6 N T, N = the config's "
        f"{cfg.active_param_count() / 1e9:.3f} B), peak memory {peak / 2**30:.2f} GiB ({peak / 1e9:.1f} GB); "
        f"{len(moved) - len(still)} of {len(moved)} leaves moved (not: {still})")
    require(losses[0] - losses[-1] >= LM_TRAIN_FALL,
            f"[lm-train] {name}: the loss fell by {losses[0] - losses[-1]:.4f} < {LM_TRAIN_FALL}")
    require(peak < LM_TRAIN_PEAK_LIMIT, f"[lm-train] {name}: peak memory {peak / 1e9:.1f} GB")
    if profile:
        out["profile"] = lm_train_profile(name, trainer, state, batch)
    del leaves
    # [roofline]: one more step, untimed, under the FLOP and byte counters
    t0 = time.perf_counter()
    counts = roofline.count_step(trainer.step_fn, state.pop("params"), state.pop("opt"),
                                 device_batch(batch, dev))
    metrics = counts.pop("out")[0]
    require(math.isfinite(float(metrics["loss"])), f"[roofline] {name}: the counted step's loss")
    out["counts"] = dict(counts, count_s=time.perf_counter() - t0)
    del state, metrics
    if after_one is not None:
        lm_free(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        mb = get_arch(name).microbatches
        fresh = trainer.init_state()
        step = make_train_step(trainer.model, trainer.opt, mb, trainer.tcfg.grad_compression)
        t0 = time.perf_counter()
        metrics, params, _ = step(fresh["params"], fresh["opt"], device_batch(batch, dev))
        loss_mb, gnorm_mb = float(metrics["loss"]), float(metrics["grad_norm"])
        mb_s = time.perf_counter() - t0
        worst = max(float((t.float() - after_one[k].to(dev).float()).abs().max())
                    for k, t in tree_paths(params).items())
        # the moves of the sampled elements in the 1- and the mb-microbatch step
        flips = either = 0
        for k, t in tree_paths(params).items():
            d1 = torch.sign(lm_sample(after_one[k]).float() - sample[k].cpu().float())
            dm = torch.sign(lm_sample(t).cpu().float() - sample[k].cpu().float())
            either += int(((d1 != 0) | (dm != 0)).sum())
            flips += int((d1 != dm).sum())
        sign_share = flips / max(either, 1)
        dg = abs(gnorm_mb - gnorms[0]) / abs(gnorms[0])
        mb_peak = torch.cuda.max_memory_allocated(dev)
        ok = (abs(loss_mb - losses[0]) <= LM_TRAIN_MB_TOL["loss_rtol"] * abs(losses[0])
              and worst <= LM_TRAIN_MB_TOL["atol"] and dg <= LM_TRAIN_MB_GNORM_RTOL
              and either > 0 and sign_share <= LM_TRAIN_MB_SIGN_SHARE)
        out.update(mb=mb, mb_loss=loss_mb, mb_param_max_abs=worst, mb_gnorm_rel=dg,
                   mb_sign_share=sign_share, mb_step_ms=mb_s * 1e3, mb_peak_bytes=mb_peak)
        log(f"[lm-train] {name} one step with the config's {mb} microbatches of "
            f"{batch_size // mb} x {LM_TRAIN_SEQ} from the same initial state: loss "
            f"{loss_mb:.4f} against {losses[0]:.4f} in one batch (rtol "
            f"{LM_TRAIN_MB_TOL['loss_rtol']}), parameters max |d| {worst:.3e} (atol "
            f"{LM_TRAIN_MB_TOL['atol']}), grad norm {gnorm_mb:.4f} against {gnorms[0]:.4f} "
            f"(rel {dg:.2e}, rtol {LM_TRAIN_MB_GNORM_RTOL}), moves of opposite or one-sided "
            f"sign {flips} of {either} sampled elements that moved ({sign_share:.3e}, bound "
            f"{LM_TRAIN_MB_SIGN_SHARE}), {mb_s * 1e3:.0f} ms, peak {mb_peak / 2**30:.2f} GiB"
            + ("" if ok else "  FAIL"))
        require(ok, f"[lm-train] {name}: the microbatched step disagrees with the plain one")
        del params, fresh, after_one
    del sample
    del trainer
    lm_free(dev)
    return out


def lm_train_profile(name, trainer, state, batch) -> dict:
    """One traced full-width train step: the device's busy share and the
    top device operations."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.train.data import device_batch

    b = device_batch(batch, trainer.device)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        metrics, params, opt = trainer.step_fn(state["params"], state["opt"], b)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    state.update(params=params, opt=opt)
    events = prof.key_averages()
    busy_ms = sum(e.self_device_time_total for e in events
                  if e.device_type == DeviceType.CUDA) / 1e3
    launches = sum(e.count for e in events if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC"))
    log(f"[lm-train-profile] {name} one full-width train step: wall {wall_ms:.0f} ms under "
        f"the profiler, kernels busy {busy_ms:.0f} ms ({100 * busy_ms / wall_ms:.0f}% busy), "
        f"{launches} kernel launches")
    log(events.table(sort_by="self_cuda_time_total", row_limit=15))
    return dict(wall_ms=wall_ms, busy_ms=busy_ms, launches=launches)


def lm_train_remat(dev) -> dict:
    """phi4-mini at full width cut to LM_REMAT_LAYERS layers: loss and
    gradients under remat "none" and "block" (equal bit for bit), and each
    one's peak memory above the parameters ("block" must be below)."""
    import dataclasses

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.models.lm import Model, init_params
    from repro_torch.train.data import device_batch, synthetic_batch
    from repro_torch.train.optimizer import tree_paths
    from repro_torch.train.trainer import loss_and_grads

    cfg = dataclasses.replace(get_arch("phi4-mini-3.8b"), num_layers=LM_REMAT_LAYERS)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = init_params(cfg, gen, device=dev)
    batch = device_batch(synthetic_batch(
        cfg, ShapeSpec("train", LM_TRAIN_SEQ, LM_REMAT_BATCH, "train"), 0), dev)
    runs, peaks = {}, {}
    for mode in ("none", "block"):
        lm_free(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        runs[mode] = loss_and_grads(Model(dataclasses.replace(cfg, remat=mode)), params, batch)
        torch.cuda.synchronize(dev)
        peaks[mode] = torch.cuda.max_memory_allocated(dev) - base
    ga, gb = tree_paths(runs["none"][1]), tree_paths(runs["block"][1])
    equal = torch.equal(runs["none"][0], runs["block"][0]) and all(
        torch.equal(ga[k], gb[k]) for k in ga)
    log(f"[lm-train] remat at full width, phi4-mini cut to {LM_REMAT_LAYERS} layers, "
        f"{LM_REMAT_BATCH} x {LM_TRAIN_SEQ}: loss and all {len(ga)} gradients of \"none\" and "
        f"\"block\" equal bit for bit: {equal}; peak above the parameters \"none\" "
        f"{peaks['none'] / 2**30:.2f} GiB, \"block\" {peaks['block'] / 2**30:.2f} GiB")
    require(equal, "[lm-train] remat \"block\" differs from \"none\" on the card")
    require(peaks["block"] < peaks["none"], "[lm-train] remat \"block\" does not save memory")
    del params, runs, ga, gb
    lm_free(dev)
    return {"equal": equal, "peak_none": peaks["none"], "peak_block": peaks["block"]}


def lm_train_reduced(dev) -> dict:
    """The ten architectures at reduced size, card against the port's CPU
    run from the same state: loss_fn's gradients leaf by leaf, then one
    train step (TrainerConfig's AdamW with clipping); then a 4-step Trainer
    run on the card against 2 steps, a checkpoint, a resume and 2 more."""
    import tempfile

    import torch
    from repro_torch.configs import get_arch, list_archs
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.models.lm import Model, init_params
    from repro_torch.train import checkpoint as ckpt_lib
    from repro_torch.train.data import data_iterator, device_batch, synthetic_batch
    from repro_torch.train.optimizer import Adam, tree_paths
    from repro_torch.train.trainer import (
        Trainer, TrainerConfig, loss_and_grads, make_train_step)

    shape = ShapeSpec("lm", seq_len=32, global_batch=2, kind="train")
    tc = TrainerConfig()
    out, failed = {}, []
    for name in list_archs():
        cfg = get_arch(name).reduced()
        opt = Adam(lr=tc.lr, weight_decay=tc.weight_decay, clip_norm=tc.clip_norm)
        model = Model(cfg)
        step = make_train_step(model, opt)
        gen = torch.Generator()
        gen.manual_seed(0)
        p_cpu = init_params(cfg, gen, device="cpu")
        p_dev = lm_tree(p_cpu, lambda t: t.to(dev))
        res, grads = {}, {}
        for d, params in (("cpu", p_cpu), ("card", p_dev)):
            where = "cpu" if d == "cpu" else dev
            batch = device_batch(synthetic_batch(cfg, shape, 0), where)
            grads[d] = tree_paths(loss_and_grads(model, params, batch)[1])
            m, p, _ = step(params, opt.init(params), batch)
            res[d] = (float(m["loss"]), float(m["grad_norm"]), tree_paths(p))
        require(all(t.device.type == "cuda" for t in res["card"][2].values()),
                f"[lm-train] {name}: a parameter of the card's step is off the card")
        g_rel, g_cos, g_bad = lm_grad_worst(grads["card"], grads["cpu"], LM_GRAD_BOUND)
        (lc, gc_, pc), (lg, gg, pg) = res["cpu"], res["card"]
        dl, dg = abs(lg - lc) / abs(lc), abs(gg - gc_) / abs(gc_)
        dp = max(max_err(pg[k].cpu(), pc[k]) for k in pc)
        ok = (not g_bad and dl <= LM_TRAIN_CARD_TOL["loss_rtol"]
              and dg <= LM_TRAIN_CARD_TOL["gnorm_rtol"] and dp <= LM_TRAIN_CARD_TOL["atol"])
        out[name] = dict(grad_rel=g_rel, grad_cos=g_cos, loss_rel=dl, gnorm_rel=dg,
                         param_max_abs=dp)
        log(f"[lm-train] {name} reduced, card vs CPU: loss_fn gradients of {len(grads['cpu'])} "
            f"leaves worst relative L2 {g_rel:.2e}, worst cosine {g_cos:.6f} (bound {LM_GRAD_BOUND}"
            + (f"; outside: {g_bad}" if g_bad else "") + f"); one train step: loss "
            f"{lg:.5f} / {lc:.5f} (rel {dl:.1e}), grad norm {gg:.4f} / {gc_:.4f} (rel "
            f"{dg:.1e}), parameters max |d| {dp:.2e} (tol {LM_TRAIN_CARD_TOL})"
            + ("" if ok else "  FAIL"))
        if not ok:
            failed.append(name)
    require(not failed, f"[lm-train] the card's gradients or train step differ from the "
                        f"CPU's: {failed}")
    cfg = get_arch("xlstm-125m").reduced()

    def trainer(ckpt, steps, ckpt_every, start=0):
        tcfg = TrainerConfig(steps=steps, ckpt_every=ckpt_every, ckpt_dir=ckpt, lr=1e-3)
        return Trainer(cfg, tcfg, data_iterator(cfg, shape, seed=0, start_step=start))

    with tempfile.TemporaryDirectory() as tmp:
        end_a = trainer(f"{tmp}/a", 4, 10).run()
        trainer(f"{tmp}/b", 2, 2).run()
        restored = ckpt_lib.restore(f"{tmp}/b")
        resumed = trainer(f"{tmp}/b", 4, 10, start=2)
        end_b = resumed.run()
        pa, pb = tree_paths(end_a["params"]), tree_paths(end_b["params"])
        on_card = all(t.device.type == "cuda" for t in tree_paths(restored["params"]).values())
        equal = all(torch.equal(pa[k], pb[k]) for k in pa) and all(
            torch.equal(a, b) for a, b in zip(tree_paths(end_a["opt"].mu).values(),
                                              tree_paths(end_b["opt"].mu).values()))
        log(f"[lm-train] Trainer on the card (xlstm-125m reduced): 4 steps against 2, a "
            f"checkpoint (step {restored['step']}, restored onto the card: {on_card}), a resume "
            f"from it and 2 more ({[h['step'] for h in resumed.history]}): parameters and "
            f"moments equal bit for bit: {equal}; checkpoints {sorted(os.listdir(f'{tmp}/b'))}")
        require(on_card and equal and ckpt_lib.latest_step(f"{tmp}/b") == 4,
                "[lm-train] the resumed Trainer run differs from the straight one")
    return out


def phase_lm_train(dev, profile=False) -> dict:
    """The LM training path on the card: phi4-mini-3.8b and zamba2-1.2b at
    full width through launch/train.py's path, remat "none" against
    "block" at full width, then the ten architectures at reduced size
    against the port's CPU run and the Trainer's checkpoint and resume."""
    t0 = time.perf_counter()
    out = {name: lm_train_full(dev, name, b, profile) for name, b in LM_TRAIN_FULL.items()}
    t1 = time.perf_counter()
    out["remat"] = lm_train_remat(dev)
    t2 = time.perf_counter()
    out["reduced"] = lm_train_reduced(dev)
    log(f"[lm-train] done in {time.perf_counter() - t0:.1f} s (full width {t1 - t0:.1f} s, "
        f"remat {t2 - t1:.1f} s, reduced and Trainer {time.perf_counter() - t2:.1f} s)")
    return out


# [dist]: the distributed layer on one card.  The S=1 pipeline runs its M
# microbatches one at a time (bf16 products of 8 rows) and accumulates the
# weight gradient in float32 over them; the sequential stack runs all 48
# rows in one product, whose bf16 output cuBLAS may round another way:
# forward within 4 bf16 ulps at 1, gradients within relative L2 1e-2.
DIST_ARCH = "phi4-mini-3.8b"
DIST_PIPE_M, DIST_PIPE_MB, DIST_PIPE_D = 6, 8, 4096
DIST_PIPE_FWD_ATOL, DIST_PIPE_GRAD_REL = 4 * 2.0 ** -8, 1e-2
# build_case's sharded steps at full width on the 1x1 mesh: phi4-mini's
# train step (2 microbatches of 1 x 1024) and zamba2's decode step (4 rows
# against a 512-slot cache), each run 1 + DIST_STEPS times on DTensors and
# on plain tensors from the same seed, the first step untimed
DIST_TRAIN_ARCH, DIST_TRAIN_SHAPE = "phi4-mini-3.8b", (1024, 2)
DIST_DECODE_ARCH, DIST_DECODE_SHAPE = "zamba2-1.2b", (512, 4)
DIST_STEPS = 3
DRYRUN_PHI4_LAYERS = 4


def rel_l2(got, want) -> float:
    want = want.double()
    return float((got.double() - want).norm() / want.norm())


def phase_dist(dev) -> dict:
    """``launch/mesh.py`` and ``distributed/`` on a one-rank NCCL process
    group, started from a ``FileStore`` in a temporary directory and
    destroyed at the end of the phase."""
    import tempfile

    import torch
    import torch.distributed as dist

    require(not dist.is_initialized(), "[dist] a process group is already up")
    t0 = time.perf_counter()
    torch.cuda.set_device(dev)
    with tempfile.TemporaryDirectory() as tmp:
        store = dist.FileStore(os.path.join(tmp, "store"), 1)
        dist.init_process_group("nccl", store=store, rank=0, world_size=1)
        try:
            out = dist_checks(dev)
        finally:
            dist.destroy_process_group()
    log(f"[dist] done in {time.perf_counter() - t0:.1f} s (process group destroyed)")
    return out


def dist_checks(dev) -> dict:
    import dataclasses

    import torch
    from torch.distributed.tensor import DTensor, Replicate, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed import ctx, sharding
    from repro_torch.distributed.pipeline_parallel import pipeline_apply
    from repro_torch.launch.mesh import axis_size, dp_axes, make_mesh
    from repro_torch.launch.serve import device_batch
    from repro_torch.models.lm import Model, init_params
    from repro_torch.train.data import synthetic_batch
    from repro_torch.train.optimizer import tree_map, tree_paths

    out = {}
    mesh = make_mesh((1, 1), ("data", "model"))
    require(mesh.device_mesh is not None and mesh.device_type == dev.type,
            "[dist] the 1x1 mesh carries no DeviceMesh on the card")
    cfg = get_arch(DIST_ARCH)
    model = Model(cfg)
    cache_len = LM_PROMPT + LM_GEN + 1
    meta = init_params(cfg, torch.Generator(), device="meta")
    pspecs = sharding.param_specs(cfg, meta, mesh)
    cspecs = sharding.cache_specs(
        cfg, model.cache_struct(LM_SERVE_BATCH, cache_len, device="meta"), mesh)
    flat_p, flat_c = tree_paths(pspecs), tree_paths(cspecs)
    n_sh = sum(any(a is not None for a in v) for v in flat_p.values())
    log(f"[dist] {mesh.devices.shape} ('data', 'model') mesh on a one-rank NCCL group "
        f"({mesh.device_mesh}); {DIST_ARCH} at full width on meta: {len(flat_p)} parameter "
        f"specs, {n_sh} sharded (wq {flat_p['layers/wq']}, embed {flat_p['embed']}), "
        f"{len(flat_c)} cache specs (k "
        f"{next(v for k, v in flat_c.items() if k.endswith('/k'))})")

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = init_params(cfg, gen, device=dev)
    t1 = time.perf_counter()
    sharded = sharding.shard_tree(params, mesh, pspecs)
    torch.cuda.synchronize()
    shard_s = time.perf_counter() - t1
    want, got = tree_paths(params), tree_paths(sharded)
    bad = [k for k, t in got.items()
           if not (isinstance(t, DTensor)
                   and t.placements == sharding.placements(mesh.axis_names, flat_p[k])
                   and torch.equal(t.to_local(), want[k]))]
    require(not bad, f"[dist] shard_tree: leaves not the specs' DTensors of the input: {bad}")
    batch = device_batch(synthetic_batch(
        cfg, ShapeSpec("serve", LM_PROMPT, LM_SERVE_BATCH, "prefill"), 0), dev)
    logits_u, cache_u = model.prefill(params, batch)
    dp = dp_axes(mesh)
    # the parameters as pure data parallelism lays them out (replicated):
    # with the heads sharded on "model" beside the batch on "data", the
    # attention's einsum would flatten two sharded dims, which DTensor
    # refuses (ROADMAP 13d)
    replicated = sharding.shard_tree(
        params, mesh, sharding.param_specs(dataclasses.replace(cfg, pure_dp=True), meta, mesh))
    dbatch = {k: distribute_tensor(v, mesh.device_mesh, [Replicate(), Replicate()])
              for k, v in batch.items()}
    seen, constrain_batch = [], ctx.constrain_batch

    def spy(x):
        y = constrain_batch(x)
        seen.append(tuple(str(p) for p in y.placements) if isinstance(y, DTensor) else None)
        return y

    ctx.constrain_batch = spy
    # the sequence axis stays unset: DTensor cannot flatten a (B, S, d)
    # activation sharded on S for a product (ROADMAP 13d)
    ctx.set_dp_axes(dp, math.prod(axis_size(mesh, a) for a in dp))
    ctx.set_model_axis("model", axis_size(mesh, "model"))
    try:
        # ops on tensors the model makes itself (positions, masks) take
        # them as replicated
        with implicit_replication():
            logits_s, cache_s = model.prefill(replicated, dbatch)
    finally:
        ctx.constrain_batch = constrain_batch
        ctx.set_dp_axes(None)
        ctx.set_model_axis(None)
    con = (sorted(set(map(str, seen))), len(seen))
    require(isinstance(logits_s, DTensor), "[dist] the prefill on DTensors gave a plain tensor")
    logits_s = logits_s.full_tensor()
    cache_s = tree_map(lambda t: t.full_tensor() if isinstance(t, DTensor) else t, cache_s)
    cu, cs = tree_paths(cache_u), tree_paths(cache_s)
    d_logits = max_err(logits_s, logits_u)
    d_cache = max(max_err(cs[k].float(), cu[k].float()) for k in cu)
    padded = model.pad_cache(cache_u, cache_len)
    sc = tree_paths(sharding.shard_tree(padded, mesh, cspecs))
    d_sc = max(max_err(t.to_local().float(), v.float()) for t, v in zip(
        sc.values(), tree_paths(padded).values()))
    n_params = sum(t.numel() for t in want.values())
    log(f"[dist] shard_tree of {len(got)} parameter leaves ({n_params / 1e9:.3f} B) in "
        f"{shard_s:.2f} s, each the specs' DTensor equal to its input; {DIST_ARCH} prefill "
        f"{LM_SERVE_BATCH} x {LM_PROMPT} on its parameters replicated on the mesh (pure-DP "
        f"specs) and replicated DTensor inputs, ctx "
        f"set on the mesh (dp {dp}, model 'model'), against plain tensors with "
        f"ctx unset: max |d| logits {d_logits:.1e}, cache {d_cache:.1e}; {con[1]} "
        f"constrain_batch calls in the model, output placements {con[0]}; the padded cache "
        f"distributed on its cache_specs, max |d| {d_sc:.1e}")
    require(d_logits == 0 and d_cache == 0 and d_sc == 0,
            "[dist] the prefill on DTensors differs from the plain one, or a distributed "
            "tensor changed")
    require(con[1] > 0 and con[0] == [str(("S(0)", "R"))],
            f"[dist] constrain_batch calls in the model and their placements: {con}")
    out.update(specs=len(flat_p), sharded=n_sh, shard_s=shard_s, d_logits=d_logits,
               d_cache=d_cache, d_cache_sharded=d_sc, constrain=con)
    del params, sharded, replicated, got, want, logits_u, cache_u, logits_s, cache_s, padded, sc
    del cu, cs, dbatch
    lm_free(dev)
    out.update(dist_sharded_steps(dev, mesh))
    lm_free(dev)

    # pipeline_apply at S=1 against the sequential stack
    pmesh = make_mesh((1,), ("stage",))
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    shape = (DIST_PIPE_M, DIST_PIPE_MB, DIST_PIPE_D)
    x0 = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
    w0 = (torch.randn((1, DIST_PIPE_D, DIST_PIPE_D), generator=g, device=dev)
          / DIST_PIPE_D ** 0.5).to(torch.bfloat16)
    cot = torch.randn(shape, generator=g, device=dev)

    def stage_fn(p, xb):
        return torch.tanh(xb @ p["w"])

    res = {}
    for how in ("pipeline", "stack"):
        w = w0.clone().requires_grad_(True)
        x = x0.clone().requires_grad_(True)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        y = (pipeline_apply(stage_fn, {"w": w}, x, pmesh) if how == "pipeline"
             else stage_fn({"w": w[0]}, x))
        (y.float() * cot).sum().backward()
        torch.cuda.synchronize()
        res[how] = (y.detach(), x.grad, w.grad, time.perf_counter() - t1)
    (yp, gxp, gwp, tp), (ys, gxs, gws, ts) = res["pipeline"], res["stack"]
    d_fwd = max_err(yp.float(), ys.float())
    r_gx, r_gw = rel_l2(gxp, gxs), rel_l2(gwp, gws)
    log(f"[dist] pipeline_apply S=1, M={DIST_PIPE_M}, microbatches ({DIST_PIPE_MB}, "
        f"{DIST_PIPE_D}) bf16, stage tanh(x @ W) with W ({DIST_PIPE_D}, {DIST_PIPE_D}): "
        f"forward max |d| {d_fwd:.2e} against the sequential stack (atol "
        f"{DIST_PIPE_FWD_ATOL:.2e}), gradients x max |d| {max_err(gxp.float(), gxs.float()):.2e} "
        f"(rel L2 {r_gx:.2e}), W max |d| {max_err(gwp.float(), gws.float()):.2e} (rel L2 "
        f"{r_gw:.2e}; bound {DIST_PIPE_GRAD_REL}); forward and backward {tp * 1e3:.1f} ms "
        f"(stack {ts * 1e3:.1f} ms, first calls)")
    require(bool(torch.isfinite(yp.float()).all()) and d_fwd <= DIST_PIPE_FWD_ATOL
            and r_gx <= DIST_PIPE_GRAD_REL and r_gw <= DIST_PIPE_GRAD_REL,
            "[dist] the S=1 pipeline disagrees with the sequential stack")
    out.update(pipe_fwd=d_fwd, pipe_gx_rel=r_gx, pipe_gw_rel=r_gw)
    return out


def dist_timed(fn):
    """(``fn()``'s value, its wall time in ms, the card synchronized on
    both sides)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    value = fn()
    torch.cuda.synchronize()
    return value, (time.perf_counter() - t0) * 1e3


def dist_peak_base(dev, args) -> int:
    """Resets the card's peak memory and returns what the peak must lose to
    be the step's own: the bytes allocated now less the step's arguments'
    (their local storages), so the step's peak counts its arguments, as
    ``launch/dryrun.measure_step`` predicts it, and nothing else the
    process holds."""
    import torch
    from repro_torch.launch.dryrun import local_bytes

    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    return torch.cuda.memory_allocated(dev) - local_bytes(args)


def dist_sharded_steps(dev, mesh) -> dict:
    """``build_case``'s train step (phi4-mini) and decode step (zamba2) at
    full width on the 1x1 mesh against the same step on plain tensors
    drawn from the same seed: on one rank every redistribution is an
    identity, so they must agree bit for bit."""
    import dataclasses
    import statistics

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed import ctx
    from repro_torch.launch import dryrun
    from repro_torch.train.optimizer import tree_paths

    def clear_ctx():
        ctx.set_dp_axes(None)
        ctx.set_model_axis(None)
        ctx.set_seq_axis(None)

    out, card = {}, card_line()
    seq, rows = DIST_TRAIN_SHAPE
    cfg = dataclasses.replace(get_arch(DIST_TRAIN_ARCH), microbatches=2)
    shape = ShapeSpec("dist_train", seq, rows, "train")
    try:
        step, (params, opt_state, batch) = dryrun.build_case(cfg, shape, mesh)
    finally:
        clear_ctx()
    runs = {}
    for how in ("dtensor", "plain"):
        if how == "plain":
            params, opt_state = dryrun.abstract_state(cfg, True, dev, 0)
            batch = {k: v.to_local() for k, v in batch.items()}
        metrics, ms = [], []
        for i in range(1 + DIST_STEPS):
            measure = how == "dtensor" and i == DIST_STEPS
            if measure:
                base = dist_peak_base(dev, (params, opt_state, batch))
            (m, params, opt_state), t = dist_timed(lambda: step(params, opt_state, batch))
            if measure:
                out["train_peak"] = torch.cuda.max_memory_allocated(dev) - base
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
            ms.append(t)
        ms = ms[1:]
        local = {k: (v.to_local() if how == "dtensor" else v)
                 for k, v in tree_paths(params).items()}
        runs[how] = dict(metrics=metrics, ms=ms, params=local,
                         placements=sorted({str(tuple(v.placements)) for v in
                                            tree_paths(params).values()}) if how == "dtensor"
                         else None)
        del params, opt_state
        lm_free(dev)
    sh, pl = runs["dtensor"], runs["plain"]
    d_metrics = max(abs(a - b) for x, y in zip(sh["metrics"], pl["metrics"])
                    for a, b in zip(x, y))
    d_params = max(max_err(sh["params"][k].float(), v.float()) for k, v in pl["params"].items())
    med_s, med_p = statistics.median(sh["ms"]), statistics.median(pl["ms"])
    log(f"[dist] build_case train step, {DIST_TRAIN_ARCH} at full width, 2 microbatches of "
        f"{rows // 2} x {seq}, AdamW lr 1e-4 with clipping, 1 + {DIST_STEPS} steps on DTensors "
        f"(parameter placements {sh['placements']}) and on plain tensors from the same seed: "
        f"loss / grad norm per step {sh['metrics']} against {pl['metrics']}, max |d| "
        f"{d_metrics:.1e}; parameters after max |d| {d_params:.1e}; median step "
        f"{med_s:.1f} ms on DTensors, {med_p:.1f} ms plain (steps {[round(t, 1) for t in sh['ms']]}"
        f" / {[round(t, 1) for t in pl['ms']]} ms) on {card}")
    require(d_metrics == 0 and d_params == 0,
            f"[dist] the sharded train step differs from the plain one: metrics max |d| "
            f"{d_metrics}, parameters max |d| {d_params}")
    out.update(train_ms=med_s, train_plain_ms=med_p, train_d=max(d_metrics, d_params))
    del runs, sh, pl
    lm_free(dev)

    seq, rows = DIST_DECODE_SHAPE
    cfg = get_arch(DIST_DECODE_ARCH)
    model = dryrun.Model(cfg)
    try:
        decode, (params, cache, tokens) = dryrun.build_case(
            cfg, ShapeSpec("dist_decode", seq, rows, "decode"), mesh)
    finally:
        clear_ctx()
    plain_params = {k: (v.to_local() if not isinstance(v, dict)
                        else {n: t.to_local() for n, t in v.items()}) for k, v in params.items()}
    plain_cache = model.cache_struct(rows, seq, device=dev)
    plain_tokens = tokens.to_local()
    d_logits, d_cache, ms_s, ms_p = 0.0, 0.0, [], []
    for i in range(1 + DIST_STEPS):
        if i == DIST_STEPS:
            base = dist_peak_base(dev, (params, cache, tokens))
        (ls, cache), ts = dist_timed(lambda: decode(params, cache, tokens))
        if i == DIST_STEPS:
            out["decode_peak"] = torch.cuda.max_memory_allocated(dev) - base
        (lp, plain_cache), tp = dist_timed(
            lambda: model.decode_step(plain_params, plain_cache, plain_tokens))
        ms_s.append(ts)
        ms_p.append(tp)
        d_logits = max(d_logits, max_err(ls.to_local().float(), lp.float()))
        cs, cp = tree_paths(cache), tree_paths(plain_cache)
        d_cache = max(d_cache, max(max_err(cs[k].to_local().float(), v.float())
                                   for k, v in cp.items()))
    ms_s, ms_p = ms_s[1:], ms_p[1:]
    med_s, med_p = statistics.median(ms_s), statistics.median(ms_p)
    log(f"[dist] build_case decode step, {DIST_DECODE_ARCH} at full width, {rows} rows against "
        f"a {seq}-slot cache on its cache_specs, 1 + {DIST_STEPS} steps on DTensors and on "
        f"plain tensors: logits max |d| {d_logits:.1e}, every cache leaf max |d| {d_cache:.1e}; "
        f"median step {med_s:.2f} ms on DTensors, {med_p:.2f} ms plain (steps "
        f"{[round(t, 2) for t in ms_s]} / {[round(t, 2) for t in ms_p]} ms) on {card}; "
        f"peak of the last DTensor step with its arguments: train {out['train_peak'] / 1e9:.3f} "
        f"GB, decode {out['decode_peak'] / 1e9:.3f} GB")
    require(d_logits == 0 and d_cache == 0,
            f"[dist] the sharded decode step differs from the plain one: logits max |d| "
            f"{d_logits}, cache max |d| {d_cache}")
    out.update(decode_ms=med_s, decode_plain_ms=med_p, decode_d=max(d_logits, d_cache))
    return out


DRYRUN_PEAK_REL = 0.10
# [dryrun] (b): the 16x16 cells run, (arch, shape, layers kept; None: all)
DRYRUN_CELLS = (("phi4-mini-3.8b", "train_4k", DRYRUN_PHI4_LAYERS),
                ("qwen3-moe-30b-a3b", "decode_32k", None))


def phase_dryrun(dev, dist_out: dict) -> dict:
    """``launch/dryrun.py`` on fake process groups, every fake tensor on the
    card: (a) the per-device peak of ``[dist]``'s two sharded steps
    predicted on a one-rank fake group and held to the peak ``[dist]``
    measured of the same step (its arguments allocated); (b) two
    production cells on the 16x16 mesh (256 fake ranks): phi4-mini's
    ``train_4k``, whose 8 microbatches are fewer than its 16 data ranks, and
    an MoE cell.  Every group is destroyed at the phase's end."""
    import dataclasses

    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import SHAPES, ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh

    t0 = time.perf_counter()
    card, out = card_line(), {}
    (tseq, trows), (dseq, drows) = DIST_TRAIN_SHAPE, DIST_DECODE_SHAPE
    cases = (("train", dataclasses.replace(get_arch(DIST_TRAIN_ARCH), microbatches=2),
              ShapeSpec("dist_train", tseq, trows, "train"), dist_out["train_peak"]),
             ("decode", get_arch(DIST_DECODE_ARCH), ShapeSpec("dist_decode", dseq, drows,
                                                              "decode"),
              dist_out["decode_peak"]))
    with dryrun.fake_group(1):
        mesh = make_mesh((1, 1), ("data", "model"))
        for what, cfg, shape, measured in cases:
            t1 = time.perf_counter()
            try:
                with FakeTensorMode(allow_non_fake_inputs=True):
                    fn, args = dryrun.build_case(cfg, shape, mesh)
                    require(all(t.device.type == "cuda" for t in dryrun.local_tensors(args)),
                            "[dryrun] a fake argument is not on the card")
                    m = dryrun.measure_step(fn, args)
                    del fn, args
            finally:
                dryrun.clear_ctx()
            mem, pred = m["memory"], m["memory"]["peak"]
            rel = abs(pred - measured) / measured
            log(f"[dryrun] {cfg.name} {what} step ({shape.global_batch} x {shape.seq_len}) on a "
                f"1x1 fake group: predicted peak {pred / 1e9:.3f} GB (arguments "
                f"{mem['argument'] / 1e9:.3f}, output {mem['output'] / 1e9:.3f}, temp "
                f"{mem['temp'] / 1e9:.3f}, alias {mem['alias'] / 1e9:.3f}), measured by [dist] "
                f"{measured / 1e9:.3f} GB on {card}: {100 * rel:.2f}% apart (bound "
                f"{100 * DRYRUN_PEAK_REL:.0f}%); collectives {m['counts']['collectives']}; "
                f"fake run {time.perf_counter() - t1:.1f} s")
            require(rel <= DRYRUN_PEAK_REL and m["counts"]["collective_bytes"] == 0,
                    f"[dryrun] {what}: predicted peak {pred} against measured {measured}")
            out[f"{what}_pred"], out[f"{what}_measured"] = pred, measured
    with dryrun.fake_group(256):
        for arch, shape_name, layers in DRYRUN_CELLS:
            cfg = get_arch(arch)
            if layers is not None:
                cfg = dataclasses.replace(cfg, num_layers=layers)
            rec = dryrun.run_cell(cfg, SHAPES[shape_name], False, dev)
            require(rec["ok"], f"[dryrun] {arch} {shape_name} on 16x16 failed: "
                               f"{rec.get('error')}\n{rec.get('traceback')}")
            rf = rec["roofline"]
            log(f"[dryrun] {arch} {shape_name} on 16x16 (256 fake ranks"
                + (f", {layers} of {get_arch(arch).num_layers} layers" if layers else "")
                + f"): per-device peak {rec['memory']['peak_gb']:.3f} GB (argument "
                f"{rec['memory']['argument_gb']:.3f}, temp {rec['memory']['temp_gb']:.3f}), "
                f"counted {rec['counted_flops'] / 256:.4e} FLOPs and "
                f"{rec['counted_bytes'] / 256:.4e} bytes per device, collective GB per device "
                + ", ".join(f"{k} {v['bytes'] / 1e9:.4f} ({v['count']:.0f})"
                            for k, v in sorted(rec["collectives"].items()))
                + f"; bottleneck {rf['bottleneck']} (t_compute {rf['t_compute_s']:.4g} s, "
                f"t_memory {rf['t_memory_s']:.4g} s, t_collective {rf['t_collective_s']:.4g} s); "
                f"fake run {rec['compile_s']} s")
            require(0 < rec["memory"]["peak_gb"] < 80 and rec["counted_flops"] > 0,
                    f"[dryrun] {arch} {shape_name}: {rec['memory']}")
            out[(arch, shape_name)] = rec
    require(not torch.distributed.is_initialized(), "[dryrun] a process group is still up")
    log(f"[dryrun] done in {time.perf_counter() - t0:.1f} s (fake groups destroyed)")
    return out


def phase_roofline(lm_out: dict, train_out: dict, card: str) -> list:
    """The roofline rows of the counted LM steps: each one's counted FLOPs
    and bytes (``count_step``, over one extra, untimed call) beside its
    measured median time."""
    from repro_torch.analysis import report, roofline
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeSpec

    cases = []
    for name, batch_size in LM_TRAIN_FULL.items():
        r = train_out[name]
        cases.append((name, lm_train_shape(batch_size), r["counts"], r["step_ms"] / 1e3,
                       r["peak_bytes"], r["counts"]["count_s"]))
    for name in LM_ROOFLINE_SERVE:
        r = lm_out[name]
        c = r["counts"]
        cases.append((name, ShapeSpec(f"prefill_{LM_SERVE_BATCH}x{LM_PROMPT}", LM_PROMPT,
                                      LM_SERVE_BATCH, "prefill"),
                      c["prefill"], r["times"]["prefill_s"], r["peak_bytes"], c["count_s"]))
        cases.append((name, ShapeSpec(f"decode_{LM_SERVE_BATCH}x{LM_PROMPT + LM_GEN + 1}",
                                      LM_PROMPT + LM_GEN + 1, LM_SERVE_BATCH, "decode"),
                      c["decode"], r["times"]["decode_s"], r["peak_bytes"], 0.0))
    rows = []
    for name, shape, counts, step_s, peak, count_s in cases:
        cfg = get_arch(name)
        rf = roofline.from_counts(cfg, shape, report.MESH, 1, counts, peak)
        rows.append({"arch": rf.arch, "shape": rf.shape, "mesh": rf.mesh, "ok": True,
                     "roofline": rf.row(), "memory": {"peak_gb": peak / 1e9},
                     "step_s": step_s})
        log(f"[roofline] {name} {shape.name} on {card}: measured {step_s * 1e3:.2f} ms; "
            f"counted {counts['flops']:.4e} FLOPs "
            f"({100 * roofline.peak_share(counts['flops'], step_s):.2f}% of the bf16 peak in "
            f"the measured time) and {counts['bytes']:.4e} bytes; 6 N T (2 N T) "
            f"{rf.model_flops:.4e} ({100 * roofline.peak_share(rf.model_flops, step_s):.2f}%); "
            f"t_compute {rf.t_compute * 1e3:.3f} ms, t_memory {rf.t_memory * 1e3:.3f} ms, "
            f"bottleneck {rf.bottleneck}, flops_ratio {rf.flops_ratio:.3f}; counted in "
            f"{count_s:.1f} s")
        require(counts["flops"] > 0 and counts["bytes"] > 0 and 0 < rf.flops_ratio
                and step_s > 0, f"[roofline] {name} {shape.name}: an empty count")
    table = report.roofline_table({(r["arch"], r["shape"], r["mesh"]): r for r in rows})
    log("[roofline] analysis/report.py's table (one H100, " + card + "):\n" + table)
    require(len(rows) == 4, "[roofline] not four rows")
    return rows


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

    card = card_line()
    dev = torch.device("cuda", 0)
    log(f"[env] torch {torch.__version__} (CUDA {torch.version.cuda}), python "
        f"{sys.version.split()[0]}, card: {card}")

    t_all = time.perf_counter()
    phase_build()
    lm_out = phase_lm(dev, profile=argv == ["profile"])
    train_out = phase_lm_train(dev, profile=argv == ["profile"])
    dist_out = phase_dist(dev)
    phase_dryrun(dev, dist_out)
    phase_roofline(lm_out, train_out, card)
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
    launches_e, turns = phase_main_eager(dev, ds, main)
    sched = phase_main_sched(dev, ds, main_res, main_kfs)
    launches_s, replayed_s = sched[0], sched[3]["replayed"]
    launches_n = phase_norb(dev, ds, main_res, main_per_frame)
    rtgs = phase_rtgs(dev, ds_rtgs)
    launches_r, rtgs_res, rtgs_kfs, _ = rtgs
    phase_rtgs_eager(dev, ds_rtgs, rtgs)
    launches_rs = phase_rtgs_sched(dev, ds_rtgs, rtgs_res, rtgs_kfs)
    launches_a = phase_algos(dev, ds_rtgs)
    launches_kd = phase_kf_device(dev, ds)
    launches_sp, busy = phase_sparse(dev, profile=argv == ["profile"])
    # S=1's ms in [serve]'s table: the fused turn that captured nothing.
    launches_sv, solo, serve_data, serve_host = phase_serve(
        dev, ds, launches, dict(main_info, split=turns[-1][1]["split"]))
    launches_sp.update(serve=launches_sv,
                       serve_prune=phase_serve_prune(dev, serve_data, serve_host),
                       sched=phase_sched(dev, serve_data, serve_host, solo))
    launches_sp.update(phase_paged(dev, ds, (launches, main_res, main_kfs, main_info),
                                   sched, serve_data["desk0"], profile=argv == ["profile"]))
    if argv == ["profile"]:
        log("[profile] [sparse] tail keyframe (step 14), kernels busy: " + ", ".join(
            f"{n} dense {d:.1f} ms, sparse {sp:.1f} ms" for n, (d, sp) in busy.items()))
        # The last fused turn replayed every graph: [main]'s own keyframe
        # captured the keyframe graph.
        phase_profile(dev, ds, ds_rtgs, turns[-1][1]["split"])

    paths = {"main": launches, "main_eager": launches_e, "main_sched": launches_s,
             "norb": launches_n,
             "rtgs": launches_r, "rtgs_sched": launches_rs,
             **{f"algos_{a}": v for a, v in launches_a.items()},
             **{f"kf_device_{a}": v for a, v in launches_kd.items()},
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
                     f"*_corridor0: frame 3's ground-truth view of that scene at {W}x{H}; "
                     "ms: CUDA events around 40 launches from the host; device_ms: "
                     "device time from CUDA-graph replays",
            "ms_b4": b4["ms"], "plain_ms_b4": b4["plain_ms"],
            "bound_ms_b4": b4["bound_ms"],
            "ms_real": rv["ms"], "plain_ms_real": rv["plain_ms"],
            "bound_ms_real": rv["bound_ms"],
            "ms_f2": f2["ms"], "plain_ms_f2": f2["plain_ms"], "bound_ms_f2": f2["bound_ms"],
            "ms_f4": f4["ms"], "plain_ms_f4": f4["plain_ms"], "bound_ms_f4": f4["bound_ms"],
            **{f"{k}_{n}": o[k] for n, o in sc.items() for k in ("ms", "plain_ms", "bound_ms")},
        }
        by_shape = (("", b1), ("_b4", b4), ("_real", rv), ("_f2", f2), ("_f4", f4),
                    *((f"_{n}", o) for n, o in sc.items()))
        # ms is CUDA events around 40 launches from the host; device_ms the
        # kernel's time from CUDA-graph replays
        row.update({f"device_ms{s}": o["device_ms"] for s, o in by_shape})
        if key in ("K1", "K4"):
            # threads, blocks per tile or pair (the cluster), shared memory,
            # registers and spills, at each shape's launch
            row.update({f"launch{s}": o["launch"] for s, o in by_shape})
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
