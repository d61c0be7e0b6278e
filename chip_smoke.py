#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # the checks and the main path
    python3 chip_smoke.py profile    # the same, then torch.profiler tables

Run from the root of a checkout.  In order, it

1. prints the PyTorch version and the card's name and power limit;
2. builds the CUDA kernels K1 (forward tile rasterizer) and K2 (backward)
   from ``src/repro_torch/csrc`` with ``nvcc`` for ``sm_90a`` and prints
   the ``-Xptxas -v`` register and shared-memory lines;
3. holds K1 and K2 against their plain PyTorch versions on the card at the
   slice's shapes (1200 tiles of a 640x480 frame, K=256 fragments per tile,
   B=1 and B=4 stacked views) and times all of them with CUDA events; the
   packed attrs are wide splats near their own tile (``tests/_kernel_inputs``),
   so most tiles saturate and skip chunks while the rest blend them all;
4. renders the full-size ground-truth scene through the ``kernel`` backend
   and the pure-tensor ``ref`` backend and compares images and gradients;
   checks that a batched 4-view render equals four single-view renders;
5. runs a small session on the card and on the CPU from the same inputs
   and compares poses and PSNR;
6. runs the MonoGS SLAM session on the full-size room0 scene (640x480,
   12 frames, a 131072-Gaussian pool) with every launch counter set to 0
   just before, and checks that K1 and K2 carried it, that no plain version
   ran, and that ATE < 0.30 m and mean keyframe PSNR > 17 dB;
7. with ``profile``, traces one tracking-only frame and one keyframe of a
   second full-size session with ``torch.profiler`` and prints the tables.

It prints one JSON line with every kernel's numbers, then the card's name
and power limit, then as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failed check raises, so the script exits non-zero and prints no result;
it also refuses to run without a CUDA device or outside a checkout.
"""

from __future__ import annotations

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
# K2: pass A replay (14); pass B replay and prefix (13), dL/dalpha (6),
# the chain to q and the 10 per-pixel gradients (31), the sum over the
# tile's pixels (10), the transmittance update (2).
OPS_K2 = 76

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


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.build_all(force=True)
    log(f"[build] nvcc {' '.join(_build.NVCC_FLAGS)}: "
        f"{time.perf_counter() - t0:.1f} s")
    for name in _build.SOURCES:
        for line in _build.PTXAS_REPORT[name].splitlines():
            if any(k in line for k in ("registers", "spill", "Compiling")):
                log(f"[build] {name}: {line.strip()}")


def phase_kernels(dev):
    """K1 and K2 against their plain versions at the slice's shapes."""
    import numpy as np
    import torch
    from repro_torch.core.sorting import make_tile_grid
    from repro_torch.kernels.tile_render import (
        tile_render_fwd, tile_render_fwd_plain)
    from repro_torch.kernels.tile_render_bp import (
        tile_render_bwd, tile_render_bwd_plain)

    from _kernel_inputs import random_attrs

    grid = make_tile_grid(H, W)
    tiles = grid.num_tiles
    rows_out = {}
    for views in (1, 4):
        a_np, c_np = random_attrs(42 + views, views * tiles, K, H, W, near_tile=True)
        attrs = torch.as_tensor(a_np, device=dev)
        count = torch.as_tensor(c_np, device=dev)
        kw = dict(chunk=CHUNK, tiles_per_view=tiles)

        got = tile_render_fwd(attrs, count, grid, **kw)
        want = tile_render_fwd_plain(attrs, count, grid, **kw)
        torch.cuda.synchronize()
        names = ("color", "depth", "final_T", "stash")
        for name, g, w_ in zip(names, got, want):
            tol = DEPTH_TOL if name == "depth" else FWD_ATOL
            rtol = DEPTH_TOL if name == "depth" else FWD_RTOL
            require(bool(torch.isfinite(g).all()), f"K1 {name} not finite (B={views})")
            require(close(g, w_, tol, rtol),
                    f"K1 {name} disagrees with plain (B={views}): "
                    f"max |d| {max_err(g, w_):.3g}")
        err1 = max(max_err(g, w_) for g, w_ in zip(got, want))
        stash = got[3]
        del want

        r = np.random.default_rng(7 + views)
        rows = views * tiles
        g_color = torch.as_tensor(r.normal(size=(rows, 3, 256)).astype(np.float32), device=dev)
        g_depth = torch.as_tensor(r.normal(size=(rows, 256)).astype(np.float32), device=dev)
        g_finalt = torch.as_tensor(r.normal(size=(rows, 256)).astype(np.float32), device=dev)
        bargs = (attrs, count, stash, g_color, g_depth, g_finalt, grid)
        got2 = tile_render_bwd(*bargs, **kw)
        want2 = tile_render_bwd_plain(*bargs, **kw)
        torch.cuda.synchronize()
        require(bool(torch.isfinite(got2).all()), f"K2 grads not finite (B={views})")
        atol2 = grad_atol(want2)
        require(close(got2, want2, atol2),
                f"K2 disagrees with plain (B={views}): max |d| "
                f"{max_err(got2, want2):.3g} > {atol2:.3g}")
        err2 = max_err(got2, want2)
        del want2

        # Bounds count what this data needs: K1 reads the attrs of the chunks
        # it runs and writes every output (zeros included); K2 reads the
        # attrs and stash of those chunks and the cotangents, and writes
        # every gradient.
        ran = processed_chunks(stash, count, CHUNK)
        n_ran = int(ran.sum())
        n_trips = int(torch.div(count + CHUNK - 1, CHUNK, rounding_mode="floor").sum())
        saturated = float((got[2].amax(1) <= 1e-4).double().mean())
        pairs = n_ran * CHUNK * 256
        elt = 4
        k1_bytes = elt * (n_ran * CHUNK * 12 + count.numel()
                          + sum(t.numel() for t in got))
        k2_bytes = elt * (n_ran * CHUNK * (12 + 256) + count.numel()
                          + g_color.numel() + g_depth.numel()
                          + g_finalt.numel() + got2.numel())
        ms1 = cuda_ms(lambda: tile_render_fwd(attrs, count, grid, **kw), 40)
        pms1 = cuda_ms(lambda: tile_render_fwd_plain(attrs, count, grid, **kw), 2)
        ms2 = cuda_ms(lambda: tile_render_bwd(*bargs, **kw), 40)
        pms2 = cuda_ms(lambda: tile_render_bwd_plain(*bargs, **kw), 2)
        b1, by1 = bound(k1_bytes, pairs * OPS_K1)
        b2, by2 = bound(k2_bytes, pairs * OPS_K2)
        rows_out[("K1", views)] = dict(max_abs_err=err1, ms=ms1, plain_ms=pms1,
                                       bound_ms=b1, bound_by=by1)
        rows_out[("K2", views)] = dict(max_abs_err=err2, ms=ms2, plain_ms=pms2,
                                       bound_ms=b2, bound_by=by2)
        log(f"[kernels] B={views}: {n_ran} of {n_trips} chunks below the trip "
            f"count ran, {100 * saturated:.1f}% of tiles saturated")
        log(f"[kernels] B={views}: K1 {ms1:.3f} ms (plain {pms1:.1f} ms, bound "
            f"{b1:.3f} ms by {by1}, max |d| {err1:.2e}); K2 {ms2:.3f} ms "
            f"(plain {pms2:.1f} ms, bound {b2:.3f} ms by {by2}, max |d| {err2:.2e})")
        del got, got2, stash, bargs
        torch.cuda.empty_cache()
    return rows_out


def make_room(dev, frames=12):
    import torch
    from repro_torch.slam.datasets import make_dataset
    t0 = time.perf_counter()
    ds = make_dataset("room0", num_frames=frames, height=H, width=W,
                      num_gaussians=16384, frag_capacity=K, device=dev)
    torch.cuda.synchronize()
    log(f"[dataset] room0 {W}x{H}, {frames} frames, 16384 Gaussians: "
        f"{time.perf_counter() - t0:.2f} s")
    for f in ds.frames:
        require(bool(torch.isfinite(f.rgb).all() and torch.isfinite(f.depth).all()),
                "dataset frame not finite")
    return ds


def phase_render(dev, ds):
    """The kernel backend against the ref backend on the full-size scene."""
    import numpy as np
    import torch
    from repro_torch.core.camera import Camera
    from repro_torch.core.projection import project
    from repro_torch.core.raster_api import RasterInputs, RasterPlan
    from repro_torch.core.render import render
    from repro_torch.core.sorting import build_fragment_lists, make_tile_grid
    from repro_torch.kernels import ops

    grid = make_tile_grid(H, W)
    cam = Camera(ds.intrinsics, torch.as_tensor(ds.frames[3].w2c_gt, device=dev))
    with torch.no_grad():
        proj = project(ds.gt_field, cam)
        frags = build_fragment_lists(proj, grid, K)
    target = torch.as_tensor(np.random.default_rng(3).uniform(
        size=(H, W, 3)).astype(np.float32), device=dev)
    outs, grads = {}, {}
    for backend in ("kernel", "ref"):
        leaves = [x.detach().clone().requires_grad_(True) for x in
                  (proj.mu2d, proj.conic, proj.color, proj.opacity, proj.depth)]
        img, dep, ft = ops.rasterize(RasterInputs(*leaves, frags=frags),
                                     RasterPlan(grid=grid, backend=backend, capacity=K))
        loss = ((img - target) ** 2).mean() + 0.1 * dep.mean() + 0.05 * ft.mean()
        grads[backend] = torch.autograd.grad(loss, leaves)
        outs[backend] = (img.detach(), dep.detach(), ft.detach())
        del img, dep, ft, loss
        torch.cuda.empty_cache()
    for name, g, w_ in zip(("color", "depth", "final_T"), outs["kernel"], outs["ref"]):
        tol = DEPTH_TOL if name == "depth" else FWD_ATOL
        rtol = DEPTH_TOL if name == "depth" else FWD_RTOL
        require(close(g, w_, tol, rtol),
                f"kernel render {name} disagrees with ref: max |d| {max_err(g, w_):.3g}")
    worst = 0.0
    for name, g, w_ in zip(("mu2d", "conic", "color", "opacity", "depth"),
                           grads["kernel"], grads["ref"]):
        atol = grad_atol(w_)
        require(close(g, w_, atol),
                f"kernel gradient of {name} disagrees with ref: max |d| "
                f"{max_err(g, w_):.3g} > {atol:.3g}")
        worst = max(worst, max_err(g, w_) / atol)
    log(f"[render] kernel vs ref at {W}x{H}, {int(frags.total)} fragments "
        f"({int(frags.overflow)} over K={K}): images within {FWD_ATOL}/{FWD_RTOL}, "
        f"gradients within max(3e-6, 3e-5 max|g|) (worst at {worst:.2f} of it)")

    # Batched: one stacked launch over 4 views equals 4 single-view renders.
    plan = RasterPlan(grid=grid, backend="kernel", capacity=K)
    poses = torch.stack([torch.as_tensor(ds.frames[i].w2c_gt, device=dev)
                         for i in (0, 4, 8, 11)])
    with torch.no_grad():
        batched = render(ds.gt_field, Camera(ds.intrinsics, poses), plan, device=dev)
        for b in range(4):
            single = render(ds.gt_field, Camera(ds.intrinsics, poses[b]), plan,
                            device=dev)
            require(torch.equal(batched.image[b], single.image)
                    and torch.equal(batched.depth[b], single.depth),
                    f"batched render view {b} differs from its single-view render")
    log("[render] 4-view batched render is bitwise equal to 4 single-view renders")


def phase_small_session(dev):
    """A 64x64 session on the card and on the CPU from the same inputs."""
    import numpy as np
    import torch
    from repro_torch.core.keyframes import KeyframePolicy
    from repro_torch.slam.datasets import make_dataset
    from repro_torch.slam.session import SLAMConfig, run_sequence

    cfg = SLAMConfig(iters_track=3, iters_map=4, capacity=1024, frag_capacity=48,
                     map_window=2, keyframe=KeyframePolicy(interval=2))
    rng = np.random.default_rng(11)
    perms = {i: rng.permutation(2 * cfg.densify_per_kf) for i in range(1, 6)}
    res = {}
    for d in ("cpu", dev):
        ds = make_dataset("room0", num_frames=6, height=64, width=64,
                          num_gaussians=400, frag_capacity=48, device="cpu")
        if d != "cpu":
            for f in ds.frames:
                f.rgb, f.depth = f.rgb.to(d), f.depth.to(d)
        res[str(d)] = run_sequence(ds, cfg, device=d,
                                   perms={k: torch.as_tensor(v) for k, v in perms.items()})
    a, b = res["cpu"], res[str(dev)]
    pose_d = max(float(np.abs(x - y).max()) for x, y in zip(a.est_w2c, b.est_w2c))
    centre_d = max(float(np.linalg.norm(np.linalg.inv(x)[:3, 3] - np.linalg.inv(y)[:3, 3]))
                   for x, y in zip(a.est_w2c, b.est_w2c))
    psnr_d = abs(a.mean_psnr - b.mean_psnr)
    log(f"[small] 64x64 room0, 6 frames: card vs CPU pose entries within "
        f"{pose_d:.2e}, camera centres within {centre_d * 1e3:.2f} mm, mean PSNR "
        f"{b.mean_psnr:.3f} vs {a.mean_psnr:.3f} dB, ATE {b.ate * 100:.2f} vs "
        f"{a.ate * 100:.2f} cm")
    # The card sums in other orders than the CPU (K2's warp tree, cuBLAS),
    # and five frames of optimization grow those last-bit differences: on an
    # H100 80GB HBM3 the camera centres read 0.19-0.33 mm apart (pose
    # entries up to 2.9e-3) in three runs.  1 mm is three times the largest.
    require(centre_d < 1e-3, f"card and CPU camera centres differ by {centre_d:.3g} m")
    require(psnr_d < 0.1, f"card and CPU PSNR differ by {psnr_d:.3g} dB")


def phase_main(dev, ds):
    """The MonoGS session on the full-size scene; returns its numbers."""
    import numpy as np
    import torch
    from repro_torch.kernels.tile_render import tile_render_fwd, tile_render_fwd_plain
    from repro_torch.kernels.tile_render_bp import tile_render_bwd, tile_render_bwd_plain
    from repro_torch.slam.session import (
        SLAMConfig, session_finalize, session_init, session_step)

    cfg = SLAMConfig(capacity=131072, frag_capacity=K, map_window=4,
                     iters_track=12, iters_map=24)
    counters = (tile_render_fwd, tile_render_bwd)
    plains = (tile_render_fwd_plain, tile_render_bwd_plain)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters:
        fn.launches = 0
    for fn in plains:
        fn.calls = 0
    t_run = time.perf_counter()
    sess = session_init(ds, cfg, device=dev)
    torch.cuda.synchronize()
    step_ms, kf_flags = [(time.perf_counter() - t_run) * 1e3], [True]
    for idx in range(1, ds.num_frames):
        t0 = time.perf_counter()
        sess, out = session_step(sess, ds.frames[idx])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        kf_flags.append(bool(out.is_kf))
    wall = time.perf_counter() - t_run
    res = session_finalize(sess, gt_w2c=[f.w2c_gt for f in ds.frames],
                           wall_time_s=wall)
    launches = {"K1": tile_render_fwd.launches, "K2": tile_render_bwd.launches}
    plain_calls = sum(fn.calls for fn in plains)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    frames = ds.num_frames
    kf_ms = [t for t, k in zip(step_ms[1:], kf_flags[1:]) if k]
    tr_ms = [t for t, k in zip(step_ms[1:], kf_flags[1:]) if not k]
    log(f"[main] room0 {W}x{H}, {frames} frames, capacity {cfg.capacity}, "
        f"K={K}, window {cfg.map_window}: wall {wall:.2f} s, "
        f"{wall * 1e3 / frames:.1f} ms per frame (init+boot {step_ms[0]:.0f} ms, "
        f"tracking-only frame {np.mean(tr_ms):.1f} ms, keyframe "
        f"{np.mean(kf_ms) if kf_ms else float('nan'):.1f} ms)")
    log(f"[main] ATE {res.ate * 100:.2f} cm, mean keyframe PSNR {res.mean_psnr:.2f} dB "
        f"({', '.join(f'{p:.2f}' for p in res.keyframe_psnr)}), keyframes "
        f"{[i for i, k in enumerate(kf_flags) if k]}, alive {res.alive_per_frame[-1]}")
    log(f"[main] launches: K1 {launches['K1']} ({launches['K1'] / frames:.2f} per frame), "
        f"K2 {launches['K2']} ({launches['K2'] / frames:.2f} per frame), plain versions "
        f"{plain_calls}; peak device memory {peak_gb:.2f} GB; cached-list fragments "
        f"{int(sess.frags.total)}, overflow {int(sess.frags.overflow)}; work {res.work}")
    require(launches["K1"] > 0 and launches["K2"] > 0,
            f"the main path did not launch both kernels: {launches}")
    require(plain_calls == 0, f"the main path ran a plain version {plain_calls} times")
    require(np.isfinite(res.ate) and res.ate < 0.30, f"ATE {res.ate:.3f} m >= 0.30 m")
    require(res.mean_psnr > 17.0, f"mean keyframe PSNR {res.mean_psnr:.2f} dB <= 17")
    return launches


def phase_profile(dev, ds):
    """Where a frame's time goes (after the default run, with ``profile``):
    a ``torch.profiler`` trace of one tracking-only frame and one keyframe of
    the full-size session, summed by operator, printed as tables."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.slam.session import SLAMConfig, session_init, session_step

    cfg = SLAMConfig(capacity=131072, frag_capacity=K, map_window=4,
                     iters_track=12, iters_map=24)
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    sess = session_init(ds, cfg, device=dev)
    with profile(activities=activities):          # the tracer's own start-up
        sess, _ = session_step(sess, ds.frames[1])
        torch.cuda.synchronize()
    for idx, label in ((2, "tracking-only frame"), (8, "keyframe")):
        while sess.frame_idx < idx:
            sess, _ = session_step(sess, ds.frames[sess.frame_idx])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=activities) as prof:
            sess, _ = session_step(sess, ds.frames[idx])
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        events = prof.key_averages()
        # Kernel rows only: an operator's self device time repeats its kernels'.
        dev_ms = sum(e.self_device_time_total for e in events
                     if e.device_type == DeviceType.CUDA) / 1e3
        log(f"[profile] {label} {idx}: wall {wall_ms:.1f} ms under the profiler, "
            f"kernels busy {dev_ms:.1f} ms ({100 * dev_ms / wall_ms:.0f}%)")
        log(events.table(sort_by="self_cuda_time_total", row_limit=25))
        log(events.table(sort_by="self_cpu_time_total", row_limit=15))


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
    ds = make_room(dev)
    phase_render(dev, ds)
    phase_small_session(dev)
    launches = phase_main(dev, ds)
    if argv == ["profile"]:
        phase_profile(dev, ds)

    meta = {
        "K1": ("tile_render_fwd", "src/repro_torch/csrc/tile_render.cu",
               "src/repro/kernels/tile_render.py:175"),
        "K2": ("tile_render_bwd", "src/repro_torch/csrc/tile_render_bp.cu",
               "src/repro/kernels/tile_render_bp.py:208"),
    }
    kernels = []
    for key, (name, source, replaces) in meta.items():
        b1, b4 = kernel_rows[(key, 1)], kernel_rows[(key, 4)]
        kernels.append({
            "name": f"{key} {name}", "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[key],
            "max_abs_err": max(b1["max_abs_err"], b4["max_abs_err"]),
            "ms": b1["ms"], "plain_ms": b1["plain_ms"],
            "bound_ms": b1["bound_ms"], "bound_by": b1["bound_by"],
            "library_ms": None,
            "shape": f"{H // 16 * W // 16} tiles x K={K}, B=1 (tracking); "
                     "*_b4 keys: B=4 stacked views (mapping window)",
            "ms_b4": b4["ms"], "plain_ms_b4": b4["plain_ms"],
            "bound_ms_b4": b4["bound_ms"],
        })
    log(f"[done] {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
