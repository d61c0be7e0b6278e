#!/usr/bin/env python3
"""``chip_smoke.py``'s ``[dist]``, ``[dryrun]`` and ``[roofline]`` phases, on
one NVIDIA GPU.

    python3 tools/lm_dist.py             # from the root of a checkout
    python3 tools/lm_dist.py dist        # [dist] and [dryrun] alone

Runs ``chip_smoke.phase_lm`` and ``phase_lm_train`` (whose full-width
models also count one untimed call each), then ``phase_dist`` (a one-rank
NCCL group: the mesh, the sharding rules, ``ctx``, ``build_case``'s sharded
train and decode steps at full width against the plain ones, and the S=1
pipeline), ``phase_dryrun`` (``launch/dryrun.py`` on fake process groups:
``[dist]``'s peaks predicted, two 16x16 cells) and
``phase_roofline`` (the counted rows and ``analysis/report.py``'s table),
with their prints and requirements; ``dist`` runs ``phase_dist`` and
``phase_dryrun`` only.
Any failed requirement raises, and the script exits non-zero.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv) -> int:
    if argv not in ([], ["dist"]):
        print("usage: python3 tools/lm_dist.py [dist]", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT)]
    import chip_smoke
    import torch
    if not torch.cuda.is_available():
        print("lm_dist.py: no CUDA device", file=sys.stderr)
        return 3
    sys.path[:0] = [str(chip_smoke.SRC), str(chip_smoke.TESTS)]
    import repro_torch  # noqa: F401  (sets the precision flags)

    dev = torch.device("cuda", 0)
    card = chip_smoke.card_line()
    t0 = time.perf_counter()
    if argv == ["dist"]:
        chip_smoke.phase_dryrun(dev, chip_smoke.phase_dist(dev))
    else:
        lm_out = chip_smoke.phase_lm(dev)
        train_out = chip_smoke.phase_lm_train(dev)
        chip_smoke.phase_dryrun(dev, chip_smoke.phase_dist(dev))
        chip_smoke.phase_roofline(lm_out, train_out, card)
    chip_smoke.log(f"[dist] tools/lm_dist.py done in {time.perf_counter() - t0:.1f} s on {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
