#!/usr/bin/env python3
"""``chip_smoke.py``'s LM serving phase alone, on one NVIDIA GPU.

    python3 tools/lm_serve.py            # from the root of a checkout
    python3 tools/lm_serve.py profile    # plus one traced decode step per model
    python3 tools/lm_serve.py gaps       # decode vs forward by depth, full width

The default and ``profile`` run ``chip_smoke.phase_lm`` with its prints and
requirements: zamba2-1.2b and phi4-mini-3.8b served at full width, the ten
architectures at reduced size against the port's CPU run, and the
decode-vs-forward checks (under a minute).  ``gaps`` prints, for each of
the two models at full width cut to a few depths, the largest logit
difference between (prefill 127 tokens, decode token 128) and one forward
over 128 tokens: how the reference's bf16 rounding gap grows with depth.
Any failed requirement raises, and the script exits non-zero.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
GAP_DEPTHS = {"zamba2-1.2b": (2, 8, 16, 38), "phi4-mini-3.8b": (2, 8, 32)}


def gaps(dev) -> None:
    import torch
    from chip_smoke import LM_PROMPT, LM_SERVE_BATCH, lm_decode_vs_forward, log
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.serve import device_batch
    from repro_torch.models.lm import Model, init_params
    from repro_torch.train.data import synthetic_batch

    for name, depths in GAP_DEPTHS.items():
        for layers in depths:
            cfg = dataclasses.replace(get_arch(name), num_layers=layers)
            gen = torch.Generator(device=dev)
            gen.manual_seed(0)
            model, params = Model(cfg), init_params(cfg, gen, device=dev)
            toks = device_batch(synthetic_batch(
                cfg, ShapeSpec("serve", LM_PROMPT, LM_SERVE_BATCH, "prefill"), 0), dev)["tokens"]
            (ep, _), (ed, _) = lm_decode_vs_forward(model, params, toks[:, :128])
            log(f"[lm-gaps] {name} at full width, {layers} layers: max |d| prefill of 127 "
                f"{ep:.3e}, decode of token 128 {ed:.3e} (against a forward over 128)")
            del params
            torch.cuda.empty_cache()


def main(argv) -> int:
    if argv not in ([], ["profile"], ["gaps"]):
        print("usage: python3 tools/lm_serve.py [profile | gaps]", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT)]
    import chip_smoke
    import torch
    if not torch.cuda.is_available():
        print("lm_serve.py: no CUDA device", file=sys.stderr)
        return 3
    sys.path[:0] = [str(chip_smoke.SRC), str(chip_smoke.TESTS)]
    import repro_torch  # noqa: F401  (sets the precision flags)

    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    if argv == ["gaps"]:
        gaps(dev)
    else:
        chip_smoke.phase_lm(dev, profile=argv == ["profile"])
    chip_smoke.log(f"[lm] tools/lm_serve.py done in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
