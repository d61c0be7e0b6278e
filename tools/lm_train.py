#!/usr/bin/env python3
"""``chip_smoke.py``'s LM training phase alone, on one NVIDIA GPU.

    python3 tools/lm_train.py            # from the root of a checkout
    python3 tools/lm_train.py profile    # plus one traced full-width step per model

Runs ``chip_smoke.phase_lm_train`` with its prints and requirements:
phi4-mini-3.8b (8 x 4096 tokens) and zamba2-1.2b (4 x 4096) trained at full
width through ``launch/train.py``'s path, phi4's microbatched step, remat
"none" against "block", and the ten architectures at reduced size against
the port's CPU run with the Trainer's checkpoint and resume.  ``profile``
adds, for each full-width model, one traced train step: the device's busy
share and its top operations.  Any failed requirement raises, and the
script exits non-zero.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv) -> int:
    if argv not in ([], ["profile"]):
        print("usage: python3 tools/lm_train.py [profile]", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT)]
    import chip_smoke
    import torch
    if not torch.cuda.is_available():
        print("lm_train.py: no CUDA device", file=sys.stderr)
        return 3
    sys.path[:0] = [str(chip_smoke.SRC), str(chip_smoke.TESTS)]
    import repro_torch  # noqa: F401  (sets the precision flags)

    t0 = time.perf_counter()
    chip_smoke.phase_lm_train(torch.device("cuda", 0), profile=argv == ["profile"])
    chip_smoke.log(f"[lm-train] tools/lm_train.py done in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
