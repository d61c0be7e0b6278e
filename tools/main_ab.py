#!/usr/bin/env python3
"""Same-call A/B of the port's main path across checkouts, on one NVIDIA GPU.

    python3 tools/main_ab.py PARENT . . PARENT

Each argument is the root of a checkout (for example a ``git archive`` of
the parent commit unpacked under ``build/``); each runs, in the order given
and in a process of its own, the ``[main]`` session of ``chip_smoke.py``:
room0 at 640x480, 12 frames, a 131072-Gaussian pool, the ``kernel``
backend, its kernels built from that checkout's sources, twice: the
first session captures the config's graphs, the second replays them (a
process's runners are cached per config).  Each run prints one JSON
line: the first session's ms per frame (init and captures included), and
of the second, ms per frame (init included), the mean tracking-only frame
and keyframe, and its ATE, mean keyframe PSNR and a sha256 of the
estimated poses, so two checkouts whose poses agree to the last bit print
the same digest; and the process's peak device memory.  A checkout whose
session counts dispatches, syncs and graph replays
(``repro_torch.slam.graphs.EngineStats``) also prints those per
tracking-only frame and per keyframe of the second session.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path


def run(tree: Path) -> dict:
    """The main path of the checkout at ``tree`` (in this process)."""
    sys.path[:0] = [str(tree / "src")]
    import hashlib

    import numpy as np
    import torch
    import repro_torch  # noqa: F401  (sets the precision flags)
    from repro_torch.kernels import _build
    from repro_torch.slam.datasets import make_dataset
    from repro_torch.slam.session import (
        SLAMConfig, session_finalize, session_init, session_step)

    try:
        from repro_torch.slam.graphs import EngineStats
    except ImportError:             # a checkout from before the fused engine
        EngineStats = None
    dev = torch.device("cuda", 0)
    _build.build_all()  # what this checkout has not built yet
    ds = make_dataset("room0", num_frames=12, height=480, width=640,
                      num_gaussians=16384, frag_capacity=256, device=dev)
    cfg = SLAMConfig(capacity=131072, frag_capacity=256, map_window=4,
                     iters_track=12, iters_map=24)

    def one_session() -> dict:
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
            kf.append(bool(out.is_kf))
            if stats:
                counts.append([a - b for a, b in zip(
                    (stats.dispatches, stats.syncs, stats.replays), before)])
        wall = time.perf_counter() - t_run
        res = session_finalize(sess, gt_w2c=[f.w2c_gt for f in ds.frames],
                               wall_time_s=wall)
        digest = hashlib.sha256(np.ascontiguousarray(np.stack(res.est_w2c)).tobytes())
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
            "poses_sha256": digest.hexdigest()[:16],
        }

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    first = one_session()
    return {"tree": str(tree), "first_ms_per_frame": first["ms_per_frame"],
            **one_session(), "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def main(argv) -> int:
    if len(argv) == 2 and argv[0] == "--run":
        print(json.dumps(run(Path(argv[1]).resolve())), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    for tree in argv:
        out = subprocess.run([sys.executable, __file__, "--run", tree],
                             capture_output=True, text=True, check=False)
        if out.returncode:
            print(out.stdout + out.stderr, file=sys.stderr)
            return out.returncode
        print(out.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
