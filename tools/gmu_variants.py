#!/usr/bin/env python3
"""Design variants of GMU level 2 around K3 (``src/repro_torch/csrc/gmu.cu``),
on one NVIDIA GPU, each checked and timed.

    python3 tools/gmu_variants.py          # from the root of a checkout

Every variant computes GMU level 2 of the K2 gradients of a ground-truth
view of room0 (as ``chip_smoke.py``'s real view), one view (tracking) and
four copies of it (the mapping window's backward), and must equal the
committed path bit for bit.  Source variants are the committed ``gmu.cu``
with exact-text edits (each must apply once), built side by side:

  committed        ``merge_views``: keys, one stable sort, K3's merge;
                   pass 1 gathers the rows through the sort's order from
                   the gradients' (tiles, 10, K) layout and keeps them in
                   sorted order, pass 2 reads them in order; 10 columns
                   in registers
  regather         pass 2 gathers the rows through the order again
  width_16         16 columns in registers (10 used)
  blocks_6/8       both passes under __launch_bounds__(256, 6 or 8): at
                   most 40 or 32 registers, 6 or 8 blocks per SM

and, for timing only (its results are wrong, not checked):

  no_arrival       pass 1 without arrivals: no carries are computed, so
                   its pass 1 time less the committed one's is the cost of
                   the carries (the last block's work and the wait for it)

Call variants, on the committed build:

  row_major        the gradients first copied to (M, 10) rows
  pre_gathered     the sorted rows gathered first (``rows[order]``)
  per_view         one sort and one K3 merge per view
  index_add_chain  the level-2 chain K3's merge replaced: per view a stable
                   argsort, the sorted rows masked, K3's scan
                   (``block_cumsum``) of them padded to 256 rows, and the
                   boundary values sent by two ``index_add_`` calls into
                   N + 1 rows whose last collects every other row

Times are device time of the whole call (``chip_smoke.graph_ms``: CUDA-graph
replays) and, for the source variants, each K3 pass's kernel time from
``torch.profiler``; K3's scan at (307200, 10) is timed for each source
variant too.  The table goes to standard output and
``build/gmu_variants/variants.json``.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BUILD = ROOT / "build" / "gmu_variants"

_ARRIVE = """    __threadfence();
    s_last = atomicAdd(group_arrivals, 1u) == static_cast<unsigned>(in_group - 1);"""

SOURCE_VARIANTS = {
    "committed": [],
    "regather": [
        ("      store_rows<W>(a.sorted + first, g, s_rows, x);\n", ""),
        ("    load_rows<W>(a.sorted + first, g, s_rows, x);",
         "    gather_row<W>(a, view, blk, seg, x);")],
    "width_16": [("a.num_g <= 10 ? launch_width<MERGE, 10>",
                  "a.num_g <= 16 ? launch_width<MERGE, 16>")],
    "blocks_6": [("__launch_bounds__(BLOCK)\nk3_totals(", "__launch_bounds__(BLOCK, 6)\nk3_totals("),
                 ("__launch_bounds__(BLOCK)\nk3_rows(", "__launch_bounds__(BLOCK, 6)\nk3_rows(")],
    "blocks_8": [("__launch_bounds__(BLOCK)\nk3_totals(", "__launch_bounds__(BLOCK, 8)\nk3_totals("),
                 ("__launch_bounds__(BLOCK)\nk3_rows(", "__launch_bounds__(BLOCK, 8)\nk3_rows(")],
    "no_arrival": [(_ARRIVE, "    s_last = false;")],
}
DIAGNOSTIC = {"no_arrival"}


def variant_source(src: str, edits) -> str:
    for old, new in edits:
        if src.count(old) != 1:
            raise SystemExit(f"edit does not apply once: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def pass_ms(fn, reps: int = 10) -> dict:
    """Kernel time per call of K3's two passes, from ``torch.profiler``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        for name in ("k3_totals", "k3_rows"):
            if e.device_type == DeviceType.CUDA and name in e.key:
                out[name] = out.get(name, 0.0) + e.self_device_time_total / 1e3 / reps
    return out


def main() -> int:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests"), str(ROOT)]
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("gmu_variants.py: no CUDA device", file=sys.stderr)
        return 3
    import chip_smoke as cs
    import repro_torch  # noqa: F401  (sets the precision flags)
    from repro_torch.kernels import _build, gmu, ops
    from repro_torch.kernels.tile_render import tile_render_fwd
    from repro_torch.kernels.tile_render_bp import tile_render_bwd

    BUILD.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "gmu.cu").read_text()
    procs = {}
    for name, edits in SOURCE_VARIANTS.items():
        cu = BUILD / f"{name}.cu"
        cu.write_text(variant_source(src, edits))
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(BUILD / f"lib{name}.so"),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        usage = {k: v for k, v in cs.ptxas_usage(log).items() if "ILb" in k}
        libs[name] = ctypes.CDLL(str(BUILD / f"lib{name}.so"))
        print(f"[variants] {name}: " + ", ".join(
            f"{k.split('_cu_')[-1][:22]} {v}" for k, v in sorted(usage.items()))
            + " (registers, spill store B, spill load B)", flush=True)

    dev = torch.device("cuda", 0)
    grid, proj, frags = cs.gt_view(dev, cs.make_scene(dev))
    with torch.no_grad():
        attrs = ops._pack_attrs(proj.mu2d, proj.conic, proj.color, proj.opacity,
                                proj.depth, frags.idx).contiguous()
    count = frags.count.contiguous()
    tiles, n = grid.num_tiles, proj.mu2d.shape[0]
    kw = dict(chunk=cs.CHUNK, tiles_per_view=tiles)
    fwd = tile_render_fwd(attrs, count, grid, **kw)
    r = np.random.default_rng(17)
    cots = [torch.as_tensor(r.normal(size=s).astype(np.float32), device=dev)
            for s in ((tiles, 3, 256), (tiles, 256), (tiles, 256))]
    grads1 = tile_render_bwd(attrs, count, *fwd, *cots, grid, **kw)   # (T, 10, K)
    g = grads1.shape[1]
    x = torch.as_tensor(np.random.default_rng(5).normal(size=(tiles * 256, g))
                        .astype(np.float32), device=dev)

    def keys_of(ids, views):
        offs = torch.arange(views, dtype=torch.int32, device=dev)[:, None] * (n + 1)
        return torch.sort((torch.where(ids >= 0, ids, n) + offs).reshape(-1), stable=True)

    def committed(grads, ids, views):
        return gmu.merge_views(grads, ids, n)

    def row_major(grads, ids, views):
        rows = grads.transpose(1, 2).reshape(-1, g)
        keys_s, order = keys_of(ids, views)
        return gmu.merge_runs(rows[:, :, None], order, keys_s, views, n)

    def pre_gathered(grads, ids, views):
        keys_s, order = keys_of(ids, views)
        rows = grads.transpose(1, 2).reshape(-1, g)[order]
        ident = torch.arange(order.numel(), device=dev)
        return gmu.merge_runs(rows[:, :, None], ident, keys_s, views, n)

    def per_view(grads, ids, views):
        return torch.stack([gmu.merge_views(grads[v * tiles:(v + 1) * tiles],
                                            ids[v:v + 1], n)[0] for v in range(views)])

    def chain_one(vals, ids):
        m = vals.shape[0]
        keys = torch.where(ids >= 0, ids, torch.full_like(ids, n))
        order = torch.argsort(keys, stable=True)
        ids_s = keys[order]
        valid = ids_s < n
        vals_s = torch.where(valid[:, None], vals[order], torch.zeros_like(vals))
        pad = torch.zeros(((-m) % gmu.BLOCK, g), dtype=vals.dtype, device=dev)
        pref = gmu.block_cumsum(torch.cat([vals_s, pad]))[:m]
        pref_excl = pref - vals_s
        differs = ids_s[1:] != ids_s[:-1]
        one = torch.ones((1,), dtype=torch.bool, device=dev)
        is_start = torch.cat([one, differs]) & valid
        is_end = torch.cat([differs, one]) & valid
        dump = torch.full_like(ids_s, n)
        zero = torch.zeros_like(pref)
        out = torch.zeros((n + 1, g), dtype=vals.dtype, device=dev)
        out.index_add_(0, torch.where(is_end, ids_s, dump).long(),
                       torch.where(is_end[:, None], pref, zero))
        out.index_add_(0, torch.where(is_start, ids_s, dump).long(),
                       torch.where(is_start[:, None], -pref_excl, zero))
        return out[:n]

    def index_add_chain(grads, ids, views):
        return torch.stack([
            chain_one(grads[v * tiles:(v + 1) * tiles].transpose(1, 2).reshape(-1, g),
                      ids[v]) for v in range(views)])

    calls = {"row_major": row_major, "pre_gathered": pre_gathered,
             "per_view": per_view, "index_add_chain": index_add_chain}
    table = {}
    for views in (1, 4):
        grads = grads1.repeat(views, 1, 1).contiguous()
        ids = frags.idx.reshape(1, -1).repeat(views, 1).contiguous()
        keys_s, order = keys_of(ids, views)
        _build._LIBS["gmu"] = libs["committed"]
        want = committed(grads, ids, views)
        scan_want = gmu.block_cumsum(x)
        runs = [(name, lib, committed) for name, lib in libs.items()]
        runs += [(name, libs["committed"], fn) for name, fn in calls.items()]
        for name, lib, fn in runs:
            _build._LIBS["gmu"] = lib
            got = fn(grads, ids, views)
            torch.cuda.synchronize()
            cs.require(name in DIAGNOSTIC or torch.equal(got, want),
                       f"{name} differs from the committed merge (B={views}): max |d| "
                       f"{cs.max_err(got, want):.3g}")
            row = {"call_ms": cs.graph_ms(lambda: fn(grads, ids, views))}
            if name in libs:
                row["merge_ms"] = cs.graph_ms(
                    lambda: gmu.merge_runs(grads, order, keys_s, views, n))
                row["merge_pass_ms"] = pass_ms(
                    lambda: gmu.merge_runs(grads, order, keys_s, views, n))
                if views == 1:
                    cs.require(name in DIAGNOSTIC or torch.equal(gmu.block_cumsum(x),
                                                                 scan_want),
                               f"{name} scan differs from the committed scan")
                    row["scan_ms"] = cs.graph_ms(lambda: gmu.block_cumsum(x))
                    row["scan_pass_ms"] = pass_ms(lambda: gmu.block_cumsum(x))
            table.setdefault(name, {})[f"B={views}"] = row
            print(f"[variants] real view B={views} {name}: "
                  + ", ".join(f"{k} {v:.4f}" if isinstance(v, float) else
                              f"{k} " + " / ".join(f"{p} {t:.4f}" for p, t in v.items())
                              for k, v in row.items())
                  + (" (ms); timing only" if name in DIAGNOSTIC else
                     " (ms); bitwise equal to committed"), flush=True)
    _build._LIBS["gmu"] = libs["committed"]
    (BUILD / "variants.json").write_text(json.dumps(
        {"card": torch.cuda.get_device_name(0), "times_ms": table}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
