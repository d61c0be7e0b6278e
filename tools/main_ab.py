#!/usr/bin/env python3
"""Same-call A/B of the port's main path across checkouts, on one NVIDIA GPU.

    python3 tools/main_ab.py PARENT . . PARENT
    python3 tools/main_ab.py --cases main,gsslam,photoslam,rows2,rows4 PARENT . . PARENT
    python3 tools/main_ab.py --cases rtgs,prune-rows2 PARENT . . PARENT
    python3 tools/main_ab.py --cases fwd PARENT . . PARENT

Each argument is the root of a checkout (for example a ``git archive`` of
the parent commit unpacked under ``build/``); each runs, in the order given
and in a process of its own, with its kernels built from that checkout's
sources, the cases named by ``--cases`` (default ``main``), each printing
one JSON line:

* ``main``: the ``[main]`` session of ``chip_smoke.py`` (room0 at 640x480,
  12 frames, a 131072-Gaussian pool, the ``kernel`` backend), twice: the
  first session captures the config's graphs, the second replays them (a
  process's runners are cached per config).  It prints the first
  session's ms per frame (init and captures included), and of the second,
  ms per frame (init included), the mean tracking-only frame and keyframe,
  its ATE, mean keyframe PSNR, keyframes, alive counts, work counters and
  a sha256 of the estimated poses (two checkouts whose poses agree to the
  last bit print the same digest), and the process's peak device memory so
  far.  A checkout whose session counts dispatches, syncs and graph
  replays (``repro_torch.slam.graphs.EngineStats``) also prints those per
  tracking-only frame and per keyframe of the second session;
* ``gsslam``, ``photoslam``: the same with that base algorithm and
  ``chip_smoke.py``'s ``[kf-device]`` keyframe policy;
* ``rtgs``: ``chip_smoke.py``'s ``[rtgs]`` session (the checkout's own
  ``rtgs_config()``: room0 at 640x448, §4.1 pruning and §4.2
  downsampling, each frame at ``frame_factor``'s choice), twice as for
  ``main``: of the second session, ms per tracking-only frame at factors
  4 and 2 and per keyframe, dispatches, syncs and replays per
  tracking-only frame and keyframe, the boundaries fired, ATE, PSNR,
  removed and the poses digest; of the first, the ms of each frame that
  captured a tracking graph and, where the checkout's runner records
  them, the capture seconds of its §4.1 tracking graphs; the peak device
  memory of the two;
* ``rowsS``: an S-row ``SessionPool`` of [main]'s config (room0, desk0,
  stairs0, corridor0, ...), 12 frame-steps: ms per tracking-only and
  keyframe frame-step (after the first pool, which captures), dispatches,
  syncs and replays per frame-step, the poses digest of every row and the
  pool's peak device memory over what the process held before it;
* ``prune-rowsS``: the same with ``chip_smoke.py``'s ``[serve-prune]``
  pruning (``PruneConfig(k0=5, step_frac=0.08)``) and, where the
  checkout's runner records them, the capture seconds of the S-row §4.1
  tracking graph;
* ``sparse``, ``paged-b``, ``algos``: the checkout's own ``chip_smoke.py``
  runs of ``[sparse]`` (its five 16-frame sessions), ``[paged]`` (b) (the
  reference bench's corridor config on the bench's inputs and on the
  port's draw, flat and paged) and ``[algos]`` (GS-SLAM, Photo-SLAM and
  SplaTAM with RTGS, 6 frames): of each session its poses digest,
  keyframes, keyframe PSNR, alive counts, removed count and work
  counters, to hold two checkouts' results to each other;
* ``fwd``: the checkout's K1 and K4 wrappers (``tile_render_fwd``,
  ``tile_render_fwd_sched``) on ``chip_smoke.py``'s ground-truth views of
  the 640x448 scene at factors 4 and 2 (70 and 280 tiles) and of room0 at
  640x480, three times each: ms launched from the host (CUDA events
  around 40 calls, ``chip_smoke.cuda_ms``, as ``[kernels]``' ``ms``) and
  device ms from CUDA-graph replays (``chip_smoke.graph_ms``); and the
  host's own time per call (the least of three loops of 500 calls on the
  host clock, not waiting for the card) of the K1 wrapper and, as a
  reference for the host's speed in that process, of the four
  ``torch.empty`` of its outputs alone.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

# chip_smoke.py's [kf-device] policies.
KF_DEVICE = {"gsslam": dict(kind="gsslam", trans_thresh=0.3, rot_thresh=0.25),
             "photoslam": dict(kind="photoslam", pho_thresh=0.12)}
ROW_SCENES = ("room0", "desk0", "stairs0", "corridor0")


def run(tree: Path, cases) -> list:
    """The cases on the checkout at ``tree`` (in this process)."""
    sys.path[:0] = [str(tree / "src"), str(tree)]
    import dataclasses
    import hashlib

    import numpy as np
    import torch
    import repro_torch  # noqa: F401  (sets the precision flags)
    import chip_smoke
    from repro_torch.core.keyframes import KeyframePolicy
    from repro_torch.core.pruning import PruneConfig
    from repro_torch.kernels import _build
    from repro_torch.slam.datasets import make_dataset
    from repro_torch.slam.session import (
        SessionPool, SLAMConfig, frame_factor, session_finalize, session_init,
        session_row, session_step)

    try:
        from repro_torch.slam.graphs import EngineStats
    except ImportError:             # a checkout from before the fused engine
        EngineStats = None
    dev = torch.device("cuda", 0)
    _build.build_all()  # what this checkout has not built yet
    scenes = {}

    def scene(name, height=480):
        if (name, height) not in scenes:
            scenes[(name, height)] = make_dataset(
                name, num_frames=12, height=height, width=640, num_gaussians=16384,
                frag_capacity=256, device=dev)
        return scenes[(name, height)]

    def config(case):
        kw = {}
        if case in KF_DEVICE:
            kw = dict(base_algo=case, keyframe=KeyframePolicy(**KF_DEVICE[case]))
        return SLAMConfig(capacity=131072, frag_capacity=256, map_window=4,
                          iters_track=12, iters_map=24, **kw)

    def digest(poses):
        return hashlib.sha256(np.ascontiguousarray(np.stack(poses)).tobytes()).hexdigest()[:16]

    def capture_seconds(runner) -> list:
        """(factor, rows, host seconds) of the runner's §4.1 tracking
        graphs, where the checkout's runner records its captures."""
        return [[key[2], key[4], sec] for key, sec in getattr(runner, "capture_times", ())
                if key[0] == "track-prune"]

    def one_session(cfg, ds, factors=False) -> dict:
        stats = EngineStats() if EngineStats else None
        kw = {"stats": stats} if stats else {}
        t_run = time.perf_counter()
        sess = session_init(ds, cfg, device=dev, **kw)
        torch.cuda.synchronize()
        step_ms, kf, counts, facs, fired, last = [], [], [], [], [], 0
        for idx in range(1, ds.num_frames):
            if factors:
                facs.append(frame_factor(ds, idx, last, cfg))
                kw["factor"] = facs[-1]
            before = (stats.dispatches, stats.syncs, stats.replays) if stats else None
            t0 = time.perf_counter()
            sess, out = session_step(sess, ds.frames[idx], **kw)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            kf.append(out.is_kf)
            fired.append(out.fired)
            if stats:
                counts.append([a - b for a, b in zip(
                    (stats.dispatches, stats.syncs, stats.replays), before)])
            if factors:     # a MonoGS flag: a host bool
                last = idx if out.is_kf else last
        wall = time.perf_counter() - t_run
        kf = [bool(k) for k in kf]      # read after the timed steps
        res = session_finalize(sess, gt_w2c=[f.w2c_gt for f in ds.frames],
                               wall_time_s=wall)
        tracking = [i for i, k in enumerate(kf) if not k and i > 0]
        keyframes = [i for i, k in enumerate(kf) if k]
        per = {}
        for name, idx in (("tracking", tracking), ("keyframe", keyframes)):
            for j, field in enumerate(("dispatches", "syncs", "replays") if stats else ()):
                per[f"{name}_{field}"] = float(np.mean([counts[i][j] for i in idx]))
        out = {
            "ms_per_frame": wall * 1e3 / ds.num_frames,
            "tracking_ms": float(np.mean([step_ms[i] for i in tracking])),
            "first_tracking_ms": step_ms[0],
            "keyframe_ms": float(np.mean([step_ms[i] for i in keyframes])), **per,
            "ate_cm": res.ate * 100, "psnr_db": res.mean_psnr,
            "keyframes": [i + 1 for i in keyframes],
            "alive": res.alive_per_frame, "work": dict(vars(res.work)),
            "poses_sha256": digest(res.est_w2c),
        }
        if factors:
            first_at = {}       # the first frame at each factor captures its graph
            for i, f in enumerate(facs):
                first_at.setdefault(f, i)
            out.update(
                factors=facs, fired=[int(f.sum()) for f in fired],
                removed=res.prune_removed,
                tracking_ms_by_factor={f: float(np.mean([step_ms[i] for i in tracking
                                                          if facs[i] == f]))
                                       for f in sorted({facs[i] for i in tracking})},
                capture_frame_ms={i + 1: step_ms[i] for i in first_at.values()},
                capture_s=capture_seconds(sess.runner))
        return out

    def pool_run(width, prune=False) -> dict:
        names = [ROW_SCENES[s % len(ROW_SCENES)] for s in range(width)]
        data = [scene(n) for n in names]
        cfg = config("main")
        if prune:       # chip_smoke.py's [serve-prune] pruning
            cfg = dataclasses.replace(cfg, prune=PruneConfig(k0=5, step_frac=0.08))
        out = {}
        for turn in ("capture", "replay"):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            pool = SessionPool([session_init(d, cfg, device=dev) for d in data])
            rows = []
            for t in range(1, 12):
                before = dataclasses.replace(pool.stats)
                t0 = time.perf_counter()
                res = pool.step([d.frames[t] for d in data])
                torch.cuda.synchronize()
                c = pool.stats.since(before)
                rows.append(((time.perf_counter() - t0) * 1e3, res.is_kf,
                             (c.dispatches, c.syncs, c.replays), int(res.fired.sum())))
            rows = [(ms, any(bool(k) for k in kf), c, f) for ms, kf, c, f in rows]
            out[turn] = dict(rows=rows, rise_gb=(torch.cuda.max_memory_allocated() - base) / 1e9)
        rows = out["replay"]["rows"]
        finals = [session_finalize(session_row(pool.stacked, s)) for s in range(width)]
        line = {
            "rows": names,
            "tracking_step_ms": float(np.mean([ms for ms, k, _, _ in rows if not k])),
            "keyframe_step_ms": float(np.mean([ms for ms, k, _, _ in rows if k])),
            "keyframe_steps": [i + 1 for i, (_, k, _, _) in enumerate(rows) if k],
            "step_counts": [c for _, _, c, _ in rows],
            "peak_rise_gb_capture": out["capture"]["rise_gb"],
            "peak_rise_gb": out["replay"]["rise_gb"],
            "poses_sha256": [digest(r.est_w2c) for r in finals],
        }
        if prune:
            line.update(fired=[f for _, _, _, f in rows],
                        capture_step_ms=[ms for ms, _, _, _ in out["capture"]["rows"]][:2],
                        capture_s=capture_seconds(pool.stacked.runner))
        return line

    def host_us(fn, calls=500) -> float:
        """The host's time per ``fn()`` in microseconds: the least of three
        loops, each followed by a synchronize that it does not count."""
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            best = min(best, (time.perf_counter() - t0) / calls * 1e6)
            torch.cuda.synchronize()
        return best

    def outcome(res) -> dict:
        """What a session computed, to compare checkouts."""
        return {"poses_sha256": digest(res.est_w2c), "keyframe_psnr": res.keyframe_psnr,
                "alive": res.alive_per_frame, "removed": res.prune_removed,
                "work": dict(vars(res.work))}

    def smoke_runs(case) -> dict:
        """The checkout's ``chip_smoke.py`` sessions of ``case``."""
        from repro_torch.slam.datasets import SLAMDataset
        from repro_torch.slam.session import run_sequence
        chip_smoke.log = lambda *parts: None
        out = {}
        if case == "sparse":
            for name in ("room0", "desk0"):
                ds = chip_smoke.make_scene(dev, name, frames=chip_smoke.SPARSE_FRAMES)
                runs = [("schedule", False), ("schedule", True)]
                runs += [("kernel", True)] if name == "room0" else []
                for backend, sparse in runs:
                    r = chip_smoke.sparse_run(dev, ds, backend, sparse)
                    out[f"{name} {backend} {'sparse' if sparse else 'dense'}"] = outcome(r["res"])
        elif case == "paged-b":
            from repro_torch.slam.map.paged import PagedConfig
            for src in ("reference", "port"):
                ds = (chip_smoke.bench_dataset(dev) if src == "reference" else
                      make_dataset("corridor0", num_frames=chip_smoke.PAGED_FRAMES,
                                   height=48, width=64, num_gaussians=4096,
                                   frag_capacity=256, device=dev))
                for pc in (None, PagedConfig(256, 6)):
                    r = chip_smoke.paged_run(dev, ds, chip_smoke.paged_bench_config(4096, pc),
                                             chip_smoke.PAGED_FRAMES)
                    out[f"{src} {'flat' if pc is None else 'paged'}"] = outcome(r["res"])
        elif case == "algos":
            ds = scene("room0", chip_smoke.RTGS_H)
            part = SLAMDataset(ds.name, ds.intrinsics, ds.frames[:6], ds.gt_field)
            policies = {"gsslam": KeyframePolicy(kind="gsslam", trans_thresh=0.08,
                                                 rot_thresh=0.08),
                        "photoslam": KeyframePolicy(kind="photoslam", pho_thresh=0.04),
                        "splatam": KeyframePolicy(kind="splatam")}
            for algo, policy in policies.items():
                res = run_sequence(part, chip_smoke.rtgs_config(base_algo=algo,
                                                                keyframe=policy), device=dev)
                out[algo] = outcome(res)
        return out

    lines = []
    for case in cases:
        if case in ("sparse", "paged-b", "algos"):
            lines.append({"tree": str(tree), "case": case, **smoke_runs(case)})
            continue
        if case.startswith(("rows", "prune-rows")):
            line = pool_run(int(case.split("rows")[1]), prune=case.startswith("prune"))
        elif case == "fwd":
            from repro_torch.kernels import tile_render as tr
            line = {}
            for label, height, factor in (("f4", chip_smoke.RTGS_H, 4),
                                          ("f2", chip_smoke.RTGS_H, 2),
                                          ("real", chip_smoke.H, 1)):
                g, proj, frags = chip_smoke.gt_view(dev, chip_smoke.make_scene(dev, height=height),
                                                    factor)
                attrs, count = chip_smoke.view_attrs(proj, frags)
                perm, trips, _, _ = chip_smoke.sched_flat(count, g.num_tiles, 1)
                kw = dict(chunk=chip_smoke.CHUNK, tiles_per_view=g.num_tiles)
                calls = {"K1": lambda: tr.tile_render_fwd(attrs, count, g, **kw),
                         "K4": lambda: tr.tile_render_fwd_sched(attrs, perm, trips, g, **kw)}
                for name, fn in calls.items():
                    line[f"{name}_{label}_ms"] = [chip_smoke.cuda_ms(fn, 40) for _ in range(3)]
                    line[f"{name}_{label}_device_ms"] = [chip_smoke.graph_ms(fn)
                                                         for _ in range(3)]
                rows, _, cap = attrs.shape

                def empties():
                    for shape in ((rows, 3, 256), (rows, 256), (rows, 256), (rows, cap, 256)):
                        torch.empty(shape, dtype=torch.float32, device=dev)
                line[f"K1_{label}_host_us"] = host_us(calls["K1"])
                line[f"empty4_{label}_host_us"] = host_us(empties)
                del attrs, count, proj, frags
                torch.cuda.empty_cache()
        elif case == "rtgs":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            cfg, ds = chip_smoke.rtgs_config(), scene("room0", chip_smoke.RTGS_H)
            first = one_session(cfg, ds, factors=True)
            line = {"first_ms_per_frame": first["ms_per_frame"],
                    "capture_frame_ms": first["capture_frame_ms"],
                    "capture_s": first["capture_s"],
                    **{k: v for k, v in one_session(cfg, ds, factors=True).items()
                       if k not in ("capture_frame_ms", "capture_s")},
                    "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        else:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            cfg = config(case)
            first = one_session(cfg, scene("room0"))
            line = {"first_ms_per_frame": first["ms_per_frame"],
                    **one_session(cfg, scene("room0")),
                    "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        lines.append({"tree": str(tree), "case": case, **line})
    return lines


def main(argv) -> int:
    cases = ["main"]
    if argv[:1] == ["--cases"]:
        cases, argv = argv[1].split(","), argv[2:]
    if len(argv) == 2 and argv[0] == "--run":
        for line in run(Path(argv[1]).resolve(), cases):
            print(json.dumps(line), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    for tree in argv:
        out = subprocess.run([sys.executable, __file__, "--cases", ",".join(cases),
                              "--run", tree], capture_output=True, text=True, check=False)
        if out.returncode:
            print(out.stdout + out.stderr, file=sys.stderr)
            return out.returncode
        for line in out.stdout.strip().splitlines():
            if line.startswith("{"):
                print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
