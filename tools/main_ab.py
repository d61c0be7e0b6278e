#!/usr/bin/env python3
"""Same-call A/B of the port's main path across checkouts, on one NVIDIA GPU.

    python3 tools/main_ab.py PARENT . . PARENT
    python3 tools/main_ab.py --cases main,gsslam,photoslam,rows2,rows4 PARENT . . PARENT

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
* ``rowsS``: an S-row ``SessionPool`` of [main]'s config (room0, desk0,
  stairs0, corridor0, ...), 12 frame-steps: ms per tracking-only and
  keyframe frame-step (after the first pool, which captures), the poses
  digest of every row and the pool's peak device memory over what the
  process held before it.
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
    sys.path[:0] = [str(tree / "src")]
    import hashlib

    import numpy as np
    import torch
    import repro_torch  # noqa: F401  (sets the precision flags)
    from repro_torch.core.keyframes import KeyframePolicy
    from repro_torch.kernels import _build
    from repro_torch.slam.datasets import make_dataset
    from repro_torch.slam.session import (
        SessionPool, SLAMConfig, session_finalize, session_init, session_row,
        session_step)

    try:
        from repro_torch.slam.graphs import EngineStats
    except ImportError:             # a checkout from before the fused engine
        EngineStats = None
    dev = torch.device("cuda", 0)
    _build.build_all()  # what this checkout has not built yet
    scenes = {}

    def scene(name):
        if name not in scenes:
            scenes[name] = make_dataset(name, num_frames=12, height=480, width=640,
                                        num_gaussians=16384, frag_capacity=256,
                                        device=dev)
        return scenes[name]

    def config(case):
        kw = {}
        if case in KF_DEVICE:
            kw = dict(base_algo=case, keyframe=KeyframePolicy(**KF_DEVICE[case]))
        return SLAMConfig(capacity=131072, frag_capacity=256, map_window=4,
                          iters_track=12, iters_map=24, **kw)

    def digest(poses):
        return hashlib.sha256(np.ascontiguousarray(np.stack(poses)).tobytes()).hexdigest()[:16]

    def one_session(cfg) -> dict:
        ds = scene("room0")
        stats = EngineStats() if EngineStats else None
        kw = {"stats": stats} if stats else {}
        t_run = time.perf_counter()
        sess = session_init(ds, cfg, device=dev, **kw)
        torch.cuda.synchronize()
        step_ms, kf, counts = [], [], []
        for idx in range(1, ds.num_frames):
            before = (stats.dispatches, stats.syncs, stats.replays) if stats else None
            t0 = time.perf_counter()
            sess, out = session_step(sess, ds.frames[idx], **kw)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            kf.append(out.is_kf)
            if stats:
                counts.append([a - b for a, b in zip(
                    (stats.dispatches, stats.syncs, stats.replays), before)])
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
        return {
            "ms_per_frame": wall * 1e3 / ds.num_frames,
            "tracking_ms": float(np.mean([step_ms[i] for i in tracking])),
            "first_tracking_ms": step_ms[0],
            "keyframe_ms": float(np.mean([step_ms[i] for i in keyframes])), **per,
            "ate_cm": res.ate * 100, "psnr_db": res.mean_psnr,
            "keyframes": [i + 1 for i in keyframes],
            "alive": res.alive_per_frame, "work": dict(vars(res.work)),
            "poses_sha256": digest(res.est_w2c),
        }

    def pool_run(width) -> dict:
        names = [ROW_SCENES[s % len(ROW_SCENES)] for s in range(width)]
        data = [scene(n) for n in names]
        cfg = config("main")
        out = {}
        for turn in ("capture", "replay"):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            pool = SessionPool([session_init(d, cfg, device=dev) for d in data])
            rows = []
            for t in range(1, 12):
                t0 = time.perf_counter()
                res = pool.step([d.frames[t] for d in data])
                torch.cuda.synchronize()
                rows.append(((time.perf_counter() - t0) * 1e3, res.is_kf))
            rows = [(ms, any(bool(k) for k in kf)) for ms, kf in rows]
            out[turn] = dict(rows=rows, rise_gb=(torch.cuda.max_memory_allocated() - base) / 1e9)
        rows = out["replay"]["rows"]
        finals = [session_finalize(session_row(pool.stacked, s)) for s in range(width)]
        return {
            "rows": names,
            "tracking_step_ms": float(np.mean([ms for ms, k in rows if not k])),
            "keyframe_step_ms": float(np.mean([ms for ms, k in rows if k])),
            "keyframe_steps": [i + 1 for i, (_, k) in enumerate(rows) if k],
            "peak_rise_gb_capture": out["capture"]["rise_gb"],
            "peak_rise_gb": out["replay"]["rise_gb"],
            "poses_sha256": [digest(r.est_w2c) for r in finals],
        }

    lines = []
    for case in cases:
        if case.startswith("rows"):
            line = pool_run(int(case[4:]))
        else:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            cfg = config(case)
            first = one_session(cfg)
            line = {"first_ms_per_frame": first["ms_per_frame"], **one_session(cfg),
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
