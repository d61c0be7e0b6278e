#!/usr/bin/env python3
"""``chip_smoke.py``'s PagedMap corridor runs alone, on one NVIDIA GPU.

    python3 tools/paged_corridors.py            # from the root of a checkout
    python3 tools/paged_corridors.py profile    # plus the 640x480 keyframe's trace

Builds the kernels from the checkout's sources and runs
``chip_smoke.phase_paged_corridors``: the reference PagedMap bench's
corridor config at 48x64 on the bench's own inputs and on the port's draw,
and corridor0 at 640x480, flat and paged, with the same prints and the same
requirements as in the whole smoke run (about a minute against its
several).  Any failed requirement raises, and the script exits non-zero.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv) -> int:
    if argv not in ([], ["profile"]):
        print("usage: python3 tools/paged_corridors.py [profile]", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT)]
    import chip_smoke
    import torch
    if not torch.cuda.is_available():
        print("paged_corridors.py: no CUDA device", file=sys.stderr)
        return 3
    sys.path[:0] = [str(chip_smoke.SRC), str(chip_smoke.TESTS)]
    import repro_torch  # noqa: F401  (sets the precision flags)

    t0 = time.perf_counter()
    chip_smoke.phase_build()
    chip_smoke.phase_paged_corridors(torch.device("cuda", 0), profile=argv == ["profile"])
    chip_smoke.log(f"[paged] corridor runs done in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
