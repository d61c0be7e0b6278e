#!/usr/bin/env python3
"""Design variants of K1/K4 (``src/repro_torch/csrc/tile_render.cu``) and
the parent's source, built side by side on one NVIDIA GPU, each checked
bit for bit against the plain versions and timed.

    python3 tools/fwd_variants.py PARENT_CU      # from the root of a checkout

``PARENT_CU`` is the ``tile_render.cu`` to compare with (for example
``git show HEAD~1:src/repro_torch/csrc/tile_render.cu > build/parent.cu``);
its C interface is the one before the cluster argument.  The other builds
are the committed source, or ``tools/fwd_split_variant.cu`` (an earlier
design that also has a split path), with a few exact-text edits (every
edit must apply once, or the script stops), so each isolates one design
choice:

  committed        the source as it is: a thread a pixel, one 256-thread
                   block a tile (pair) from two tiles (pairs) per SM up, a
                   cluster of two 128-thread blocks below; timed at the
                   wrappers' choice and forced to 1 and 2 blocks per tile
  clusters_4_8     the committed source with clusters of 4 and 8 blocks of
                   64 and 32 threads a tile (pair) as well
  split            clusters of 2-8 blocks on the split path: 256-thread
                   blocks, 256 / cluster threads blending while the others
                   evaluate the next group's alphas into shared memory
  large_block      the split path in one block of 512 or 1024 threads a
                   tile (pair), in place of a cluster of 2 or 4
  group_1024, group_4096
                   the split path with 1024 or 4096 alphas a group, not 2048
  split_scalar_stores, split_bulk_stores
                   the split path's stash rows stored 4 bytes at a time, or
                   as cp.async.bulk copies from shared memory issued by one
                   evaluating thread, not as 16-byte vectors
  whole_row        the whole row staged up front, not the first 64
                   fragments and the rest when first needed
  chunk_staging    each chunk's fragments staged at its start
  k1_min_6         K1's launch bounds ask for 6 resident blocks per SM
                   (at most 40 registers), not 1
  unroll_4         a thread a pixel unrolls the fragment loop 4 times, not 8
  scalar_zeros     the zero rows stored 4 bytes a thread, not as 16-byte
                   vectors
  chevron_launch   the cluster size fixed in the kernels (__cluster_dims__)
                   and launched with <<<...>>>, not cudaLaunchKernelEx

It prints ptxas's registers and spills for every K1/K4 instantiation, then,
at the eight shapes of ``PERF.md``'s kernel table (near-tile attrs at B=1
and B=4 stacked views, a ground-truth view of room0 at 640x480, of the
640x448 scene at factors 2 and 4, and frame 3 of desk0, stairs0 and
corridor0), checks every build's K1 and K4 against the plain versions bit
for bit (and K4 gathered by ``inv`` against K1) and times each as device
time from CUDA-graph replays (``chip_smoke.graph_ms``: on the 70-tile grid
a launch from the host takes longer than the kernel), the parent and the
committed build in turns (parent, committed, ..., committed, parent).  The
parent, the committed build and chevron_launch at the wrappers' choice
are also timed launched from the host (``chip_smoke.cuda_ms``, 40
launches, the four outputs allocated at each as the wrappers do), and so
are the wrappers themselves.  On the two tracking grids it then times the committed K1 at
every cluster size with each row's count capped at 0, 16, 64 and 256
fragments (0 writes zero rows only): the stash's floor and the cost of a
chunk.  The table goes to standard output and
``build/fwd_variants/variants.json``.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BUILD = ROOT / "build" / "fwd_variants"
SPLIT_CU = ROOT / "tools" / "fwd_split_variant.cu"

_VECTOR = """          for (int j = e; j < min(n, nc) * chunk * Q; j += E) {
            dst[j / Q * (PIX / 4) + j % Q] = src[j];
          }"""
_EVAL_END = """            out[f * P + p] = alpha_of(s.v0[k0 + f], s.v1[k0 + f], px, py);
          }
          mbar_arrive(&full[g & 1]);"""


def _split_launches(new):
    """Edits of fwd_split_variant.cu's cluster launches (2, 4, 8) of K1 and
    K4 to `new(c)`."""
    return [(f"case {c}: return launch_{k}<{c}, PIX / {c}, ONE>(",
             f"case {c}: return launch_{k}<{new(c)}>(") for c in (2, 4, 8)
            for k in ("fwd", "sched")]


def _more_clusters(src: str) -> str:
    """The committed source with launch cases for clusters of 4 and 8."""
    for kind in ("fwd", "sched"):
        m = re.search(rf"    case 2: return launch_{kind}<2>\(.*?\);\n", src, re.S)
        if m is None:
            raise SystemExit(f"no cluster-2 launch of {kind}")
        more = "".join(m.group(0).replace("case 2", f"case {c}").replace("<2>", f"<{c}>")
                       for c in (4, 8))
        src = src.replace(m.group(0), m.group(0) + more)
    return src


def _chevron(src: str) -> str:
    """The committed source with each kernel's cluster size fixed at
    compile time and the launches made with <<<...>>>."""
    bounds = "__global__ void __launch_bounds__(PIX / CLUSTER, 1)\n"
    if src.count(bounds) != 2:
        raise SystemExit("chevron_launch: the kernels' declarations moved")
    src = src.replace(bounds, "__global__ void __cluster_dims__(CLUSTER, 1, 1) "
                              "__launch_bounds__(PIX / CLUSTER, 1)\n")
    m = re.search(r"  cudaLaunchAttribute attr\[1\];.*?cudaGetLastError\(\)\);\n", src, re.S)
    if m is None:
        raise SystemExit("chevron_launch: no cudaLaunchKernelEx launch")
    return src.replace(m.group(0), "  kernel<<<blocks * CLUSTER, PIX / CLUSTER, "
                       "smem_bytes(capacity, chunk), stream>>>(args...);\n"
                       "  return static_cast<int>(cudaGetLastError());\n")


_SPLIT = _split_launches(lambda c: f"{c}, PIX, SPLIT")

# name -> (base source, edits); a callable edit rewrites the whole source.
VARIANTS = {
    "committed": ("committed", []),
    "clusters_4_8": ("committed", [_more_clusters]),
    "split": ("split", _SPLIT),
    "large_block": ("split", _split_launches(lambda c: f"1, PIX * {min(c, 4)}, SPLIT")),
    "group_1024": ("split", _SPLIT + [("constexpr int GROUP_PAIRS = 2048;",
                                       "constexpr int GROUP_PAIRS = 1024;")]),
    "group_4096": ("split", _SPLIT + [("constexpr int GROUP_PAIRS = 2048;",
                                       "constexpr int GROUP_PAIRS = 4096;")]),
    "split_scalar_stores": ("split", _SPLIT + [(_VECTOR, """          const float* src1 = buf + (g & 1) * gf * P;
          float* dst1 = st + static_cast<size_t>(c0) * chunk * PIX + pix0;
          for (int j = e; j < min(n, nc) * chunk * P; j += E) {
            dst1[j / P * PIX + j % P] = src1[j];
          }""")]),
    "split_bulk_stores": ("split", _SPLIT + [
        (_EVAL_END, _EVAL_END.replace("          mbar_arrive", """          asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");
          mbar_arrive""")),
        (_VECTOR, """          if (e == 0) {
            for (int r = 0; r < min(n, nc) * chunk; ++r) {
              asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\\n"
                           ::"l"(reinterpret_cast<float*>(dst + r * (PIX / 4))),
                           "r"(smem_addr(src + r * Q)), "r"(P * 4) : "memory");
            }
            asm volatile("cp.async.bulk.commit_group;\\n"
                         "cp.async.bulk.wait_group.read 0;\\n" ::: "memory");
          }""")]),
    "whole_row": ("committed", [("constexpr int FIRST_STAGE = 64;",
                                 "constexpr int FIRST_STAGE = 1024;")]),
    "chunk_staging": ("committed", [
        ("constexpr int FIRST_STAGE = 64;", "constexpr int FIRST_STAGE = 1;"),
        ("    if (k0 == end) stage_from(k0, trips * chunk);",
         "    if (k0 == end) stage_from(k0, k0 + chunk);")]),
    "k1_min_6": ("committed", [("__launch_bounds__(PIX / CLUSTER, 1)\ntile_render_fwd_kernel(",
                                "__launch_bounds__(PIX / CLUSTER, 6)\ntile_render_fwd_kernel(")]),
    "unroll_4": ("committed", [
        ("#pragma unroll 8\n    for (int k = k0; k < k0 + chunk; ++k) {",
         "#pragma unroll 4\n    for (int k = k0; k < k0 + chunk; ++k) {")]),
    "chevron_launch": ("committed", [_chevron]),
    "scalar_zeros": ("committed", [("""  for (int j = t; j < nz; j += P) {
    st4[(static_cast<size_t>(z0 + j / Q) * PIX + pix0) / 4 + j % Q] =
        make_float4(0.f, 0.f, 0.f, 0.f);
  }""", """  for (int k = z0; k < capacity; ++k) {
    st[static_cast<size_t>(k) * PIX + pix] = 0.f;
  }""")]),
}
_P, _I = ctypes.c_void_p, ctypes.c_int


def variant_source(src: str, edits) -> str:
    for edit in edits:
        if callable(edit):
            src = edit(src)
            continue
        old, new = edit
        if src.count(old) != 1:
            raise SystemExit(f"edit does not apply once: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def load(path: Path, parent: bool):
    lib = ctypes.CDLL(str(path))
    extra = [] if parent else [_I]
    lib.tile_render_fwd.argtypes = [_P] * 6 + [_I] * 5 + [_P] + extra
    lib.tile_render_fwd_sched.argtypes = [_P] * 8 + [_I] * 6 + [_P] + extra
    lib.tile_render_fwd.restype = lib.tile_render_fwd_sched.restype = _I
    return lib


def main(argv) -> int:
    if len(argv) != 1 or not Path(argv[0]).is_file():
        print("usage: python3 tools/fwd_variants.py PARENT_TILE_RENDER_CU", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests"), str(ROOT)]
    import numpy as np  # noqa: F401
    import torch
    if not torch.cuda.is_available():
        print("fwd_variants.py: no CUDA device", file=sys.stderr)
        return 3
    import chip_smoke as cs
    import repro_torch  # noqa: F401  (sets the precision flags)
    from _kernel_inputs import random_attrs
    from repro_torch.core.sorting import make_tile_grid
    from repro_torch.kernels import _build
    from repro_torch.kernels import tile_render as tr

    BUILD.mkdir(parents=True, exist_ok=True)
    bases = {"committed": (_build.CSRC / "tile_render.cu").read_text(),
             "split": SPLIT_CU.read_text()}
    sources = {"parent": Path(argv[0]).read_text(),
               **{n: variant_source(bases[b], e) for n, (b, e) in VARIANTS.items()}}
    procs = {}
    for name, text in sources.items():
        cu = BUILD / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(BUILD / f"lib{name}.so"),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, usage = {}, {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        usage[name] = {}
        for sym, v in cs.ptxas_usage(log).items():  # K1 / K4 by (cluster, threads a block)
            m = re.search(r"tile_render_fwd(_sched)?_kernel"
                          r"(?:ILi(\d+)E(?:Li(\d+)ELi(\d+)E)?)?", sym)
            if m:
                key = "K4" if m.group(1) else "K1"
                if m.group(2):  # cluster, and on the split file threads and path
                    c = int(m.group(2))
                    t, path = (m.group(3), ("one", "split")[int(m.group(4))]) if m.group(3) \
                        else (256 // c, "one")
                    key += f" cluster {c} x {t} {path}"
                usage[name][key] = v
        libs[name] = load(BUILD / f"lib{name}.so", name == "parent")
        print(f"[variants] {name}: " + ", ".join(
            f"{k} {v[0]} registers, spills {v[1]}/{v[2]} B" for k, v in usage[name].items()),
            flush=True)

    dev = torch.device("cuda", 0)
    H, W, K, C = cs.H, cs.W, cs.K, cs.CHUNK
    inputs = {}
    grid = make_tile_grid(H, W)
    for views in (1, 4):
        a, c = random_attrs(42 + views, views * grid.num_tiles, K, H, W, near_tile=True)
        inputs[f"near-tile B={views}"] = (grid, torch.as_tensor(a, device=dev),
                                          torch.as_tensor(c, device=dev), views)
    ds = cs.make_scene(dev)
    g, proj, frags = cs.gt_view(dev, ds)
    inputs["real view"] = (g, *cs.view_attrs(proj, frags), 1)
    ds = cs.make_scene(dev, height=cs.RTGS_H)
    for factor in (2, 4):
        g, proj, frags = cs.gt_view(dev, ds, factor)
        inputs[f"factor {factor} ({g.num_tiles} tiles)"] = (g, *cs.view_attrs(proj, frags), 1)
    for name in cs.NEW_SCENES:
        ds = cs.make_scene(dev, name, frames=4)
        g, proj, frags = cs.gt_view(dev, ds, frame=3)
        inputs[name] = (g, *cs.view_attrs(proj, frags), 1)
    del ds, proj, frags

    def outputs(rows, cap):
        kw = dict(dtype=torch.float32, device=dev)
        return (torch.empty((rows, 3, 256), **kw), torch.empty((rows, 256), **kw),
                torch.empty((rows, 256), **kw), torch.empty((rows, cap, 256), **kw))

    fault = tr.sched_fault_word(dev)
    table = {}
    for label, (grid, attrs, count, views) in inputs.items():
        tiles = grid.num_tiles
        rows, _, cap = attrs.shape
        perm, trips, inv, _ = cs.sched_flat(count, tiles, views)
        slots = perm.shape[0]
        kw = dict(chunk=C, tiles_per_view=tiles)
        want1 = tr.tile_render_fwd_plain(attrs, count, grid, **kw)
        want4 = tr.tile_render_fwd_sched_plain(attrs, perm, trips, grid, **kw)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        auto1, auto4 = tr.fwd_cluster(rows, sms), tr.fwd_cluster(slots // 2, sms)
        ran = cs.processed_chunks(want1[3], count, C)
        n_ran = int(ran.sum())
        fwd_bytes = 4 * (n_ran * C * 12 + count.numel() + sum(t.numel() for t in want1))
        b1 = cs.bound(fwd_bytes, n_ran * C * 256 * cs.OPS_K1)
        b4 = cs.bound(fwd_bytes + 4 * (2 * slots - rows), n_ran * C * 256 * cs.OPS_K1)

        def runs(name, cluster):
            lib = libs[name]
            extra = [] if name == "parent" else [cluster[0]]
            extra4 = [] if name == "parent" else [cluster[1]]
            o1, o4 = outputs(rows, cap), outputs(slots, cap)

            def k1():  # on the current stream: a graph capture's, when timed
                err = lib.tile_render_fwd(attrs.data_ptr(), count.data_ptr(),
                                          *(t.data_ptr() for t in o1), rows, cap, C, tiles,
                                          grid.grid_w, torch.cuda.current_stream().cuda_stream,
                                          *extra)
                assert err == 0, f"{name} K1 cudaError {err}"

            def k4():
                err = lib.tile_render_fwd_sched(
                    attrs.data_ptr(), perm.data_ptr(), trips.data_ptr(),
                    *(t.data_ptr() for t in o4), fault.data_ptr(), rows, slots, cap, C,
                    tiles, grid.grid_w, torch.cuda.current_stream().cuda_stream, *extra4)
                assert err == 0, f"{name} K4 cudaError {err}"
            return k1, k4, o1, o4

        plan = [("parent", (0, 0)), ("committed", (auto1, auto4))]
        plan += [("committed", (c, c)) for c in (1, 2)]
        plan += [("clusters_4_8", (c, c)) for c in (4, 8)]
        plan += [("split", (c, c)) for c in (2, 4, 8)]
        plan += [("large_block", (c, c)) for c in (2, 4)]
        plan += [(n, (8, 8)) for n in ("group_1024", "group_4096", "split_scalar_stores",
                                        "split_bulk_stores")]
        plan += [(n, (auto1, auto4)) for n in ("whole_row", "chunk_staging", "k1_min_6",
                                                "unroll_4", "scalar_zeros", "chevron_launch")]
        plan += [("committed", (auto1, auto4)), ("parent", (0, 0))]
        times, launched = {}, {}
        for name, cl in plan:
            k1, k4, o1, o4 = runs(name, cl)
            k1()
            k4()
            torch.cuda.synchronize()
            tag = name if name == "parent" else f"{name} c{cl[0]}/{cl[1]}"
            for out, g1, w1, g4, w4 in zip(("color", "depth", "final_T", "stash"),
                                           o1, want1, o4, want4):
                cs.require(torch.equal(g1, w1), f"{tag} K1 {out} != plain ({label})")
                cs.require(torch.equal(g4, w4), f"{tag} K4 {out} != plain ({label})")
                cs.require(torch.equal(g4[inv], g1), f"{tag} K4[inv] {out} != K1 ({label})")
            t1, t4 = cs.graph_ms(k1), cs.graph_ms(k4)
            times.setdefault(tag, []).append((t1, t4))
            if name == "parent" or (name in ("committed", "chevron_launch")
                                    and cl == (auto1, auto4)):
                def k1_host():  # the wrapper's allocations, then the launch
                    outputs(rows, cap)
                    k1()

                def k4_host():
                    outputs(slots, cap)
                    k4()
                launched.setdefault(tag, []).extend(
                    (cs.cuda_ms(k1_host, 40), cs.cuda_ms(k4_host, 40)) for _ in range(3))
            del o1, o4
        launched["wrappers"] = [(
            cs.cuda_ms(lambda: tr.tile_render_fwd(attrs, count, grid, **kw), 40),
            cs.cuda_ms(lambda: tr.tile_render_fwd_sched(attrs, perm, trips, grid, **kw), 40))]
        tr.raise_on_sched_fault(dev)
        row = {tag: dict(k1_ms=[t[0] for t in v], k4_ms=[t[1] for t in v])
               for tag, v in times.items()}
        host = {tag: dict(k1_ms=[t[0] for t in v], k4_ms=[t[1] for t in v])
                for tag, v in launched.items()}
        table[label] = dict(rows=rows, chunks_ran=n_ran, bound_k1_ms=b1[0],
                            bound_k4_ms=b4[0], bound_by=b1[1], auto=(auto1, auto4),
                            times=row, launched_from_the_host=host)
        for tag, v in row.items():
            print(f"[variants] {label}: {tag}: K1 "
                  f"{' / '.join(f'{x:.4f}' for x in v['k1_ms'])} ms, K4 "
                  f"{' / '.join(f'{x:.4f}' for x in v['k4_ms'])} ms (bound "
                  f"{b1[0]:.4f} / {b4[0]:.4f} ms by {b1[1]}; bit for bit)", flush=True)
        for tag, v in host.items():
            print(f"[variants] {label}: {tag} launched from the host: K1 "
                  f"{' / '.join(f'{x:.4f}' for x in v['k1_ms'])} ms, K4 "
                  f"{' / '.join(f'{x:.4f}' for x in v['k4_ms'])} ms", flush=True)
        del attrs, count, want1, want4
        torch.cuda.empty_cache()

    # Where K1's time goes on the tracking grids: the committed build with
    # every row's count capped at n (n = 0 writes zero rows only).
    sweep = {}
    for label, (grid, attrs, count, _) in inputs.items():
        if not label.startswith("factor"):
            continue
        rows, _, cap = attrs.shape
        o1 = outputs(rows, cap)
        for n in (0, 16, 64, 256):
            capped = torch.clamp(count, max=n).contiguous()
            row = sweep.setdefault(label, {}).setdefault(n, {})
            for c in (1, 2, 4, 8):
                def k1():
                    err = libs["committed" if c <= 2 else "clusters_4_8"].tile_render_fwd(
                        attrs.data_ptr(), capped.data_ptr(), *(t.data_ptr() for t in o1), rows,
                        cap, C, grid.num_tiles, grid.grid_w,
                        torch.cuda.current_stream().cuda_stream, c)
                    assert err == 0, f"K1 cudaError {err}"
                row[c] = cs.graph_ms(k1)
            print(f"[variants] {label}: committed K1 with counts capped at {n}: "
                  + ", ".join(f"c{c} {t:.4f}" for c, t in row.items()) + " ms", flush=True)

    card = cs.card_line()
    print(f"[variants] card: {card}")
    (BUILD / "variants.json").write_text(json.dumps(
        {"card": card, "usage": usage, "shapes": table, "count_sweep": sweep}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
