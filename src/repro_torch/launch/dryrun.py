"""The production-mesh dry run: every (arch x shape) cell's sharded step on
the 16x16 and 2x16x16 meshes, run on one rank of a fake process group
under ``FakeTensorMode`` (the port of ``repro.launch.dryrun``).

The reference forces 512 host devices, builds each cell's step from
``jax.eval_shape`` stand-ins under explicit shardings, and lowers and
compiles it: XLA's memory analysis proves it fits, the HLO gives its
FLOPs, bytes and collective bytes.  The port's counterpart runs the step
instead, allocating nothing: ``torch.distributed``'s fake backend stands
in for the mesh's 256 or 512 ranks (this process is rank 0; a collective
returns at once), and under ``FakeTensorMode`` every tensor is a shape,
dtype and device with no storage behind it.  So ``build_case`` draws the
cell's inputs as it does on real ranks, and :func:`run_case` runs one step
and reads, on this rank:

  memory       :func:`measure_step` follows every storage alive during
               the step (:class:`LiveBytes`): argument = the local bytes of
               the inputs, output = of the results, alias = the results
               that take the place of a consumed input (the reference's
               donated arguments: a train step's parameters and Adam's
               state, a decode step's cache), each paired with the input
               leaf at its tree path and counted where it was written into
               that leaf's storage or matches its shape and dtype, as XLA
               aliases a donated buffer; peak = the most alive at once;
               temp = peak - argument - output + alias, the reference's
               identity (here: the peak over what is alive when the step
               returns);
  counts       ``analysis/roofline.count_step``: FLOPs, bytes and
               ``analysis/census.py``'s collectives of this rank, DTensor
               ops counted as the ops DTensor runs on the local shards;
  the roofline ``from_counts``, the counts scaled by the mesh's chips as
               the reference scales its per-device counts.

``compile_s`` is the seconds the fake run took (build and step); XLA's
raw ``cost_analysis`` FLOPs and ``--save-hlo`` have no counterpart, and
``unknown_trip_counts`` stays 0 (``analysis/census.py`` says why).  The
records have the reference's keys otherwise; a cell that raises is
recorded with its error and traceback.  The numbers do not depend on
whether the fake tensors are on the card or the CPU.

    python -m repro_torch.launch.dryrun --arch phi4-mini-3.8b --shape train_4k
    python -m repro_torch.launch.dryrun --all --mesh both --out build/dryrun.jsonl

(``--device cpu`` puts the fake tensors on the CPU.)  :func:`main` starts
the fake group of each mesh's size and destroys it when the mesh's cells
are done; nothing here starts a group at import.  The matrix is a few
hours of one CPU core; to spread it over cores, run one process per
architecture, all appending to one ``--out`` file:

    python -c "from repro_torch.configs import list_archs; print(*list_archs())" \
      | tr ' ' '\n' | xargs -P 4 -I{} python -m repro_torch.launch.dryrun \
          --arch {} --mesh both --out build/dryrun.jsonl

``build_case`` and its helpers are the port of ``input_specs``,
``abstract_state`` and ``build_case``: the reference's ``jax.eval_shape``
stand-ins become tensors drawn from a seed (real on real ranks, fake in
the dry run), placed on the mesh by the same specs
(``distributed/sharding.py``), and ``build_case`` returns the step as a
function to call.  The mesh must carry a ``DeviceMesh`` (a process group
of the mesh's size is up, ``launch/mesh.py``).  ``build_case`` sets
``distributed/ctx.py``'s axes as the reference does and leaves them set;
the caller clears them.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import logging
import math
import sys
import time
import traceback
import weakref

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch._device import resolve_device
from repro_torch.analysis import roofline
from repro_torch.configs import get_arch, list_archs
from repro_torch.configs.base import SHAPES, ArchConfig, ShapeSpec, shape_cells
from repro_torch.distributed import ctx, sharding
from repro_torch.launch.mesh import axis_size, dp_axes, make_production_mesh
from repro_torch.models import sharded
from repro_torch.models.lm import Model, init_params
from repro_torch.train.data import synthetic_batch
from repro_torch.train.optimizer import Adam
from repro_torch.train.trainer import make_train_step


def abstract_state(cfg: ArchConfig, with_opt: bool, device=None, seed: int = 0):
    """(parameters, Adam's state or None): real tensors on ``device`` (the
    card unless the caller asks for the CPU), the parameters drawn from a
    generator seeded with ``seed``, where the reference takes shapes only."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = init_params(cfg, gen, device=dev)
    if not with_opt:
        return params, None
    return params, Adam(lr=1e-4).init(params)


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    """Every model input of this cell as a ``meta`` tensor (its shape and
    dtype: the reference's ``ShapeDtypeStruct``)."""
    b, s = shape.global_batch, shape.seq_len

    def spec(*dims, dtype=torch.float32):
        return torch.empty(dims, dtype=dtype, device="meta")

    if shape.kind == "decode":
        return {"tokens": spec(b, 1, dtype=torch.int32)}
    toks = s - (cfg.patch_tokens if cfg.family == "vlm" else 0)
    specs = {"tokens": spec(b, toks, dtype=torch.int32)}
    if cfg.family == "vlm":
        specs["patches"] = spec(b, cfg.patch_tokens, cfg.d_model)
    if cfg.family == "encdec":
        specs["frames"] = spec(b, cfg.encoder_seq, cfg.d_model)
    return specs


def draw_inputs(cfg: ArchConfig, shape: ShapeSpec, device, seed: int = 0) -> dict:
    """The inputs ``input_specs`` describes, drawn from ``seed``: the
    synthetic token stream (``train/data.py``) for a train or prefill cell,
    uniform tokens for a decode cell."""
    if shape.kind == "decode":
        rng = np.random.default_rng(seed)
        arrays = {"tokens": rng.integers(0, cfg.vocab_size, size=(shape.global_batch, 1),
                                         dtype=np.int32)}
    else:
        arrays = synthetic_batch(cfg, shape, 0, seed)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in arrays.items()}


def microbatch_count(cfg: ArchConfig, shape: ShapeSpec, dp_size: int) -> int:
    """The reference's mesh-aware microbatch count: each microbatch's rows
    stay divisible by the data-parallel degree."""
    return max(min(cfg.microbatches, shape.global_batch // dp_size), 1)


def build_case(cfg: ArchConfig, shape: ShapeSpec, mesh, seed: int = 0):
    """Returns ``(fn, args)``: ``fn(*args)`` runs the cell's step on the
    mesh, with ``args`` placed by the reference's specs.

    train    ``fn(params, opt_state, batch) -> (metrics, params, opt_state)``,
             the microbatched AdamW step (it consumes its state);
    prefill  ``fn(params, batch) -> (logits, caches)``;
    decode   ``fn(params, cache, tokens) -> (logits, cache)``, the cache in
             and out on ``cache_specs`` (the input is consumed).

    ``fn.donates`` maps each consumed argument's index to the index of the
    result that takes its place, the reference's ``donate_argnums``."""
    if cfg.pure_dp and shape.global_batch % math.prod(mesh.devices.shape) != 0:
        # pure DP pays only when the batch fills the whole mesh
        cfg = dataclasses.replace(cfg, pure_dp=False)

    dp = dp_axes(mesh)
    dp_size = math.prod(axis_size(mesh, a) for a in dp)
    if cfg.pure_dp:  # the model axis carries batch too
        dp = dp + ("model",)
        dp_size *= axis_size(mesh, "model")
    ctx.set_dp_axes(dp, dp_size)
    ctx.set_model_axis("model", axis_size(mesh, "model"))
    ctx.set_seq_axis("model" if cfg.seq_parallel else None, axis_size(mesh, "model"))

    model = Model(cfg)
    dev = torch.device(mesh.device_type)
    batch = draw_inputs(cfg, shape, dev, seed)
    batch = sharding.shard_tree(batch, mesh, sharding.batch_specs(cfg, batch, mesh))

    if shape.kind == "train":
        params, opt_state = abstract_state(cfg, True, dev, seed)
        p_specs = sharding.param_specs(cfg, params, mesh)
        o_specs = sharding.opt_specs(cfg, params, mesh)
        opt = Adam(lr=1e-4, weight_decay=0.01, clip_norm=1.0)
        mb = microbatch_count(cfg, shape, dp_size)
        # post-split microbatch specs: (mb, B/mb, ...) with the batch on DP
        mb_specs = None
        if mb > 1:
            inner = {k: torch.empty((v.shape[0] // mb,) + tuple(v.shape[1:]), device="meta")
                     for k, v in batch.items()}
            mb_specs = {k: sharding.P(None, *s)
                        for k, s in sharding.batch_specs(cfg, inner, mesh).items()}
        step = make_train_step(model, opt, mb, microbatch_specs=mb_specs, grad_specs=p_specs)
        step.donates = {0: 1, 1: 2}
        return step, (sharding.shard_tree(params, mesh, p_specs),
                      sharding.shard_tree(opt_state, mesh, o_specs), batch)

    params, _ = abstract_state(cfg, False, dev, seed)
    params = sharding.shard_tree(params, mesh, sharding.param_specs(cfg, params, mesh))

    if shape.kind == "prefill":
        return (lambda p, b: sharded.prefill(model, p, b)), (params, batch)

    # decode: one new token against a seq_len-deep cache
    cache = model.cache_struct(shape.global_batch, shape.seq_len, device=dev)
    c_specs = sharding.cache_specs(cfg, cache, mesh)
    c_sh = sharding.to_shardings(mesh, c_specs)

    def decode(p, c, tokens):
        logits, c = sharded.decode_step(model, p, c, tokens)
        return logits, sharding.redistribute_tree(c, c_sh)

    decode.donates = {1: 1}
    return decode, (params, sharding.shard_tree(cache, mesh, c_specs), batch["tokens"])


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------

MESHES = {False: ("16x16", 256), True: ("2x16x16", 512)}   # multi_pod -> (name, chips)


@contextlib.contextmanager
def fake_group(world_size: int):
    """This process as rank 0 of a fake process group of ``world_size``
    ranks (``torch.distributed``'s "fake" backend: collectives return at
    once and move nothing), destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already up")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _local(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def local_tensors(tree) -> list:
    """Every tensor of ``tree`` (a DTensor's local tensor)."""
    from repro_torch.analysis.census import _tensors

    return [_local(t) for t in _tensors(tree)]


def local_bytes(tree) -> int:
    """The bytes of the storages behind ``tree``'s tensors on this rank,
    each storage once (a step's argument bytes)."""
    return sum(n for _, n in _storages(tree).values())


def _storages(tree) -> dict:
    """{storage key: (storage, bytes)} of every tensor in ``tree`` (a DTensor's
    local tensor), each storage once."""
    out = {}
    for t in local_tensors(tree):
        st = t.untyped_storage()
        out[st._cdata] = (st, st.nbytes())
    return out


class LiveBytes(TorchDispatchMode):
    """The bytes of the storages alive on this rank while entered: those of
    ``tensors`` (the step's arguments) and every storage an op makes, each
    until it is freed.  ``peak`` is the most at once.  A DTensor op counts
    as the local ops DTensor runs (the mode steps aside for it)."""

    def __init__(self, tensors):
        super().__init__()
        self.live, self.refs = {}, {}
        self.now = self.peak = 0
        for key, (st, n) in _storages(tensors).items():
            self._add(key, st, n)

    def _add(self, key, st, n):
        self.live[key] = n
        self.refs[key] = weakref.ref(st, lambda _, k=key: self._free(k))
        self.now += n
        self.peak = max(self.peak, self.now)

    def _free(self, key):
        # a key is a storage's address, which a later storage may take
        self.now -= self.live.pop(key, 0)
        self.refs.pop(key, None)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        for key, (st, n) in _storages(out).items():
            if key not in self.live:
                self._add(key, st, n)
        return out

    def __exit__(self, *exc):
        self.refs.clear()   # no callback after the step
        return super().__exit__(*exc)


def _leaf_paths(tree, prefix=()) -> dict:
    """{path: tensor} over nested dicts, tuples and lists (a path is the
    keys and indices down to the leaf)."""
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    items = tree.items() if isinstance(tree, dict) else \
        enumerate(tree) if isinstance(tree, (list, tuple)) else ()
    out = {}
    for k, v in items:
        out.update(_leaf_paths(v, prefix + (k,)))
    return out


def _aliased(args, out, donates: dict) -> set:
    """The storage keys of the results that take a consumed input's place:
    for each ``donates`` pair (argument index -> result index), every
    result leaf whose input leaf at the same tree path it was written into,
    or which matches that leaf's local shape and dtype (where XLA aliases a
    donated buffer)."""
    keys = set()
    for i, j in donates.items():
        before = _leaf_paths(args[i])
        for path, t in _leaf_paths(out[j]).items():
            if path not in before:
                continue
            a, b = _local(before[path]), _local(t)
            st = b.untyped_storage()
            if st._cdata == a.untyped_storage()._cdata or \
                    (a.shape == b.shape and a.dtype == b.dtype):
                keys.add(st._cdata)
    return keys


def measure_step(fn, args) -> dict:
    """Run ``fn(*args)`` once and measure it on this rank: {"memory" (bytes:
    argument, output, temp, alias, peak), "counts" (``count_step``'s), "out"}
    (see the module's docstring).  ``args`` is consumed as ``fn`` consumes
    it; ``fn.donates`` ({argument index: result index}, :func:`build_case`)
    names the arguments a result takes the place of."""
    arg_bytes = local_bytes(args)
    with LiveBytes(args) as live:
        counts = roofline.count_step(fn, *args)
    out = counts.pop("out")
    results = {k: n for k, (_, n) in _storages(out).items()}
    out_bytes = sum(results.values())
    alias = sum(results[k] for k in _aliased(args, out, getattr(fn, "donates", {})))
    peak = live.peak
    mem = {"argument": arg_bytes, "output": out_bytes, "alias": alias, "peak": peak,
           "temp": peak - arg_bytes - out_bytes + alias}
    return {"memory": mem, "counts": counts, "out": out}


def clear_ctx():
    """Unsets the axes ``build_case`` sets in ``distributed/ctx.py``."""
    ctx.set_dp_axes(None)
    ctx.set_model_axis(None)
    ctx.set_seq_axis(None)


def run_case(arch: str, shape_name: str, multi_pod: bool, device=None) -> dict:
    """One cell's dry run on the production mesh (the reference's
    ``run_case``): a fake group of the mesh's size must be up
    (:func:`fake_group`).  Returns its record."""
    return run_cell(get_arch(arch), SHAPES[shape_name], multi_pod, device)


def run_cell(cfg: ArchConfig, shape: ShapeSpec, multi_pod: bool, device=None) -> dict:
    """:func:`run_case` of a configuration and shape given whole."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    mesh_name, chips = MESHES[multi_pod]
    t0 = time.time()
    rec = {"arch": cfg.name, "shape": shape.name, "mesh": mesh_name, "ok": False}
    try:
        mesh = make_production_mesh(multi_pod=multi_pod, device=device)
        try:
            with FakeTensorMode(allow_non_fake_inputs=True):
                fn, args = build_case(cfg, shape, mesh)
                m = measure_step(fn, args)
                del fn, args
        finally:
            clear_ctx()
        mem, counts = m["memory"], m["counts"]
        mem_stats = {f"{k}_gb": mem[k] / 1e9 for k in ("argument", "output", "temp", "alias",
                                                        "peak")}
        roof = roofline.from_counts(cfg, shape, mesh_name, chips, counts, mem["peak"])
        rec.update({
            "ok": True,
            "compile_s": round(time.time() - t0, 1),
            "memory": {k: round(v, 3) for k, v in mem_stats.items()},
            "counted_flops": counts["flops"] * chips,
            "counted_bytes": counts["bytes"] * chips,
            "counted_transcendentals": counts["transcendentals"] * chips,
            "unknown_trip_counts": 0,
            "collectives": {k: {"count": float(v["count"]), "bytes": float(v["bytes"])}
                            for k, v in counts["collectives"].items()},
            "collective_gb_per_device": round(counts["collective_bytes"] / 1e9, 4),
            "roofline": {k: (round(v, 6) if isinstance(v, float) else v)
                         for k, v in roof.row().items()},
        })
    except Exception as e:  # noqa: BLE001 — a failed cell is a fault to report
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    return rec


def cells(arch_filter=None, shape_filter=None):
    for arch in list_archs():
        if arch_filter and arch != arch_filter:
            continue
        for shape in shape_cells(get_arch(arch)):
            if shape_filter and shape.name != shape_filter:
                continue
            yield arch, shape.name


def _line(rec) -> str:
    if not rec["ok"]:
        return f"FAIL {rec['arch']:26s} {rec['shape']:12s} {rec['mesh']:8s} {rec.get('error', '')}"
    return (f"OK   {rec['arch']:26s} {rec['shape']:12s} {rec['mesh']:8s} "
            f"fake run={rec['compile_s']}s peak={rec['memory']['peak_gb']:.2f}GB "
            f"bottleneck={rec['roofline']['bottleneck']}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the production-mesh dry run on a fake "
                                             "process group")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["pod", "multipod", "both"], default="pod")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None,
                    help="the fake tensors' device: the card unless 'cpu'")
    args = ap.parse_args(argv)
    if not (args.all or args.arch or args.shape):
        ap.error("name --arch and/or --shape, or --all")
    resolve_device(args.device)
    # DTensor's advice on flattening mesh dims, once per op and layout
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)

    meshes = {"pod": [False], "multipod": [True], "both": [False, True]}[args.mesh]
    todo = list(cells(args.arch, args.shape))
    if not todo:
        ap.error("no cells match the filter")
    out_f = open(args.out, "a") if args.out else None
    t0 = time.time()
    recs = []

    try:
        for mp in meshes:
            with fake_group(MESHES[mp][1]):
                for arch, shape in todo:
                    rec = run_case(arch, shape, mp, args.device)
                    recs.append(rec)
                    print(_line(rec), flush=True)
                    if out_f:
                        out_f.write(json.dumps(rec) + "\n")
                        out_f.flush()
    finally:
        if out_f:
            out_f.close()
    n_ok = sum(r["ok"] for r in recs)
    print(f"\n{n_ok}/{len(recs)} cells ran in {time.time() - t0:.1f} s")
    return 0 if n_ok == len(recs) else 1


if __name__ == "__main__":
    sys.exit(main())
