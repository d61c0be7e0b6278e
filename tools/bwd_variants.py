#!/usr/bin/env python3
"""Design variants of K2/K5 (``src/repro_torch/csrc/tile_render_bp.cu``)
built side by side on one NVIDIA GPU, each checked and timed.

    python3 tools/bwd_variants.py          # from the root of a checkout

Each variant is the committed source with a few exact-text edits (every
edit must apply once, or the script stops), so each row isolates one
design choice of ``backward_tile``:

  committed         the source as it is
  opacity_divide    the opacity gradient divides per pixel (no staged 1/o)
  group_4/group_16  4 or 16 fragments per warp reduce-scatter (not 8)
  loads_in_slot     each stash load issued at its fragment, not the group's
                    8 together; the group vote then sees termination only
  no_fragment_skip  every fragment's arithmetic runs, drawn or not
  no_group_skip     every group's exchanges run, drawn or not
  launch_bounds_3   K2 and K5 under __launch_bounds__(256, 3): at most 80
                    registers, 3 blocks per SM

It builds every variant with ``nvcc`` at once (the build flags of
``kernels/_build.py``), prints ptxas's registers and spills for K2 and K5,
then, on the slice's inputs (near-tile attrs at B=1 and B=4, and a
ground-truth view of room0, as ``chip_smoke.py``), runs K1 and K4 once and
each variant's K2 and K5 on their outputs: K2 against the plain version
(bit for bit where the variant keeps the committed arithmetic, else within
max(3e-6, 3e-5 max|g|)), K5 gathered by ``inv`` against K2 bit for bit, and
CUDA-event times over 40 launches.  The table goes to standard output and
``build/bwd_variants/variants.json``.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BUILD = ROOT / "build" / "bwd_variants"

_LOADS = """#pragma unroll
      for (int s = 0; s < GROUP; ++s) {
        al[s] = base + s < chunk ? st[static_cast<size_t>(start + base + s) * PIX + pix]
                                 : 0.f;
      }
      if (!idle) {
        idle = true;
#pragma unroll
        for (int s = 0; s < GROUP; ++s) idle = idle && al[s] == 0.f;
      }"""

VARIANTS = {
    "committed": [],
    "opacity_divide": [
        ("""      s_attr[i][r] = r == NUM_ATTRS - 1
          ? 1.0f / fmaxf(a[8 * capacity + start + i], 1e-12f)
          : a[r * capacity + start + i];""",
         """      s_attr[i][r] = a[r * capacity + start + i];"""),
        ("v[8] = da * (al_s * p2.w) * clip;",
         "v[8] = da * (al_s / fmaxf(p2.x, 1e-12f)) * clip;")],
    "group_4": [("constexpr int GROUP = 8;", "constexpr int GROUP = 4;")],
    "group_16": [("constexpr int GROUP = 8;", "constexpr int GROUP = 16;")],
    "loads_in_slot": [
        (_LOADS, ""),
        ("const float al_s = al[s];",
         "const float al_s = base + s < chunk ? "
         "st[static_cast<size_t>(start + base + s) * PIX + pix] : 0.f;")],
    "no_fragment_skip": [("if (__any_sync(FULL, am != 0.f)) {", "if (true) {")],
    "no_group_skip": [("if (__all_sync(FULL, idle)) {", "if (false) {")],
    "launch_bounds_3": [("__launch_bounds__(PIX)\ntile_render_bwd_kernel(",
                         "__launch_bounds__(PIX, 3)\ntile_render_bwd_kernel("),
                        ("__launch_bounds__(PIX)\ntile_render_bwd_sched_kernel(",
                         "__launch_bounds__(PIX, 3)\ntile_render_bwd_sched_kernel(")],
}
# Variants whose arithmetic is the committed one: K2 equals the plain
# version bit for bit.
BITWISE = set(VARIANTS) - {"opacity_divide"}


def variant_source(src: str, edits) -> str:
    for old, new in edits:
        if src.count(old) != 1:
            raise SystemExit(f"edit does not apply once: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def main() -> int:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests"), str(ROOT)]
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("bwd_variants.py: no CUDA device", file=sys.stderr)
        return 3
    import chip_smoke as cs
    import repro_torch  # noqa: F401  (sets the precision flags)
    from _kernel_inputs import random_attrs
    from repro_torch.core.sorting import make_tile_grid
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import tile_render_bp as bp
    from repro_torch.kernels.tile_render import (
        raise_on_sched_fault, tile_render_fwd, tile_render_fwd_sched)

    BUILD.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "tile_render_bp.cu").read_text()
    procs = {}
    for name, edits in VARIANTS.items():
        cu = BUILD / f"{name}.cu"
        cu.write_text(variant_source(src, edits))
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(BUILD / f"lib{name}.so"),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, usage = {}, {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        u = cs.ptxas_usage(log)
        usage[name] = {key: next(v for k, v in u.items() if cs.KERNEL_SYMBOLS[key] + "E" in k)
                       for key in ("K2", "K5")}
        libs[name] = ctypes.CDLL(str(BUILD / f"lib{name}.so"))
        print(f"[variants] {name}: K2 {usage[name]['K2']}, K5 {usage[name]['K5']} "
              "(registers, spill store B, spill load B)", flush=True)

    dev = torch.device("cuda", 0)
    H, W, K, C = cs.H, cs.W, cs.K, cs.CHUNK
    grid = make_tile_grid(H, W)
    tiles = grid.num_tiles
    inputs = {}
    for views in (1, 4):
        a, c = random_attrs(42 + views, views * tiles, K, H, W, near_tile=True)
        inputs[f"near-tile B={views}"] = (torch.as_tensor(a, device=dev),
                                          torch.as_tensor(c, device=dev), views)
    _, proj, frags = cs.gt_view(dev, cs.make_scene(dev))
    with torch.no_grad():
        attrs = ops._pack_attrs(proj.mu2d, proj.conic, proj.color, proj.opacity,
                                proj.depth, frags.idx).contiguous()
    inputs["real view B=1"] = (attrs, frags.count.contiguous(), 1)

    kw = dict(chunk=C, tiles_per_view=tiles)
    table = {}
    for label, (attrs, count, views) in inputs.items():
        perm, trips, inv, _ = cs.sched_flat(count, tiles, views)
        fwd = tile_render_fwd(attrs, count, grid, **kw)
        fwd_s = tile_render_fwd_sched(attrs, perm, trips, grid, **kw)
        r = np.random.default_rng(7 + views)
        rows = views * tiles
        cots = [torch.as_tensor(r.normal(size=s).astype(np.float32), device=dev)
                for s in ((rows, 3, 256), (rows, 256), (rows, 256))]
        slot_cots = [x[perm.long()].contiguous() for x in cots]
        want = bp.tile_render_bwd_plain(attrs, count, *fwd, *cots, grid, **kw)
        atol = cs.grad_atol(want)
        for name, lib in libs.items():
            _build._LIBS["tile_render_bp"] = lib

            def k2():
                return bp.tile_render_bwd(attrs, count, *fwd, *cots, grid, **kw)

            def k5():
                return bp.tile_render_bwd_sched(attrs, perm, trips, *fwd_s, *slot_cots,
                                                grid, **kw)

            g2, g5 = k2(), k5()
            torch.cuda.synchronize()
            err = cs.max_err(g2, want)
            cs.require(torch.equal(g2, want) if name in BITWISE else err <= atol,
                       f"{name} K2 off its plain version ({label}): max |d| {err:.3g}")
            cs.require(torch.equal(g5[inv], g2), f"{name} K5[inv] != K2 ({label})")
            t2, t5 = cs.cuda_ms(k2, 40), cs.cuda_ms(k5, 40)
            table.setdefault(name, {})[label] = dict(k2_ms=t2, k5_ms=t5, max_abs_err=err)
            print(f"[variants] {label} {name}: K2 {t2:.4f} ms, K5 {t5:.4f} ms, "
                  f"max |d| from plain {err:.3g}", flush=True)
        raise_on_sched_fault(dev)

    (BUILD / "variants.json").write_text(json.dumps(
        {"card": torch.cuda.get_device_name(0), "usage": usage, "times": table}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
