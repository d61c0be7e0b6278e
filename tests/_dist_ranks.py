"""One CPU rank of the gloo group that ``tests/test_torch_distributed.py``
and ``tests/test_torch_sharded.py`` share (:func:`spawn`, started once per
test run): eight of these run every distributed case of the port (meshes,
``shard_tree``, ``ctx`` on DTensors and inside the model on them, elastic
checkpoint restore, ``pipeline_apply``, ``launch/dryrun.build_case``'s
sharded train, prefill and decode steps, the gradient sync's bytes) and
each pickles what it saw for the tests to check, with each case's seconds.

    python -m _dist_ranks RANK WORLD STORE_FILE OUT_DIR INPUTS_NPZ

(with ``src`` and ``tests`` on ``PYTHONPATH``).  A case that raises records
its traceback instead of its results; the other cases still run.  Imports
torch and the port only.
"""

import os
import pickle
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeSpec
from repro_torch.distributed import ctx
from repro_torch.distributed import sharding as S
from repro_torch.distributed.pipeline_parallel import pipeline_apply
from repro_torch.launch import mesh as M
from repro_torch.models.lm import Model, init_params
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.data import synthetic_batch
from repro_torch.train.optimizer import tree_leaves, tree_map, tree_paths


def _np(t):
    return t.detach().float().numpy()


def case_meshes(inputs, out_dir):
    res = {}
    for shape in ((2, 4), (4, 2)):
        m = M.make_mesh(shape, ("data", "model"), device="cpu")
        dm = m.device_mesh
        res[shape] = dict(
            axis_names=m.axis_names, devices_shape=m.devices.shape,
            dm_shape=tuple(dm.shape), dm_names=tuple(dm.mesh_dim_names),
            coordinate=tuple(dm.get_coordinate()),
            groups={a: dist.get_process_group_ranks(dm.get_group(a)) for a in m.axis_names},
            dp_axes=M.dp_axes(m), sizes={a: M.axis_size(m, a) for a in ("data", "model", "pod")})
    d = M.make_data_mesh(device="cpu")
    res["data"] = dict(axis_names=d.axis_names, shape=d.devices.shape,
                       has_dm=d.device_mesh is not None,
                       sub=M.make_data_mesh(2, device="cpu").device_mesh is None)
    for what, fn in (("too_big", lambda: M.make_mesh((4, 4), ("data", "model"), device="cpu")),
                     ("production", lambda: M.make_production_mesh(device="cpu"))):
        try:
            fn()
            res[what] = None
        except ValueError as e:
            res[what] = str(e)
    return res


def case_shard_tree(inputs, out_dir):
    cfg = get_arch("llama3-405b").reduced()
    gen = torch.Generator()
    gen.manual_seed(0)
    params = init_params(cfg, gen, device="cpu")
    mesh = M.make_mesh((2, 4), ("data", "model"), device="cpu")
    sharded = S.shard_tree(params, mesh, S.param_specs(cfg, params, mesh))
    res = {}
    full = tree_paths(params)
    for path, t in tree_paths(sharded).items():
        res[path] = dict(placements=tuple(str(p) for p in t.placements),
                         local_shape=tuple(t.to_local().shape), shape=tuple(t.shape),
                         equal=bool(torch.equal(t.full_tensor(), full[path])))
    return res


def case_ctx(inputs, out_dir):
    from torch.distributed.tensor import Replicate, distribute_tensor

    mesh = M.make_mesh((2, 4), ("data", "model"), device="cpu")
    dm = mesh.device_mesh
    x = torch.from_numpy(inputs["act"])
    xd = distribute_tensor(x, dm, [Replicate(), Replicate()])
    e = torch.from_numpy(inputs["dispatch"])
    ed = distribute_tensor(e, dm, [Replicate(), Replicate()])
    res = {"unset_same": ctx.constrain_batch(xd) is xd}
    try:
        ctx.set_dp_axes(("data",), 2)
        ctx.set_model_axis("model", 4)
        res["plain_same"] = ctx.constrain_batch(x) is x and ctx.constrain_moe_dispatch(e) is e
        for tag in ("batch", "batch_seq"):
            if tag == "batch_seq":
                ctx.set_seq_axis("model", 4)
            y = ctx.constrain_batch(xd)
            res[tag] = dict(placements=tuple(str(p) for p in y.placements),
                            local_shape=tuple(y.to_local().shape),
                            equal=bool(torch.equal(y.full_tensor(), x)))
        y = ctx.constrain_moe_dispatch(ed)
        res["moe"] = dict(placements=tuple(str(p) for p in y.placements),
                          local_shape=tuple(y.to_local().shape),
                          equal=bool(torch.equal(y.full_tensor(), e)))
    finally:
        ctx.set_dp_axes(None)
        ctx.set_model_axis(None)
        ctx.set_seq_axis(None)
    return res


def _lm_run(model, params, batch):
    """(logits, loss, gradients) of one prefill and one loss_fn backward."""
    logits, _ = model.prefill(params, batch)
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss = model.loss_fn(live, batch)
    grads = torch.autograd.grad(loss, tree_leaves(live), allow_unused=True)
    return logits, loss.detach(), grads


def case_ctx_model(inputs, out_dir):
    """Reduced phi4 (attention) and zamba2 (Mamba2 and a shared attention
    block) with every parameter and input a replicated DTensor on the
    (2, 4) mesh and the data axis set: the constraints inside the model
    redistribute the activations (batch over "data") through prefill and
    through loss_fn under remat and its backward.  The same calls on plain
    tensors are the yardstick."""
    from torch.distributed.tensor import DTensor, Replicate, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    dm = M.make_mesh((2, 4), ("data", "model"), device="cpu").device_mesh
    rep = [Replicate(), Replicate()]
    seen, constrain = [], ctx._constrain

    def spy(x, spec):
        y = constrain(x, spec)
        if isinstance(y, DTensor):
            seen.append((str(spec), tuple(str(p) for p in x.placements),
                         tuple(str(p) for p in y.placements)))
        return y

    res = {}
    for name in ("phi4-mini-3.8b", "zamba2-1.2b"):
        cfg = get_arch(name).reduced()
        gen = torch.Generator()
        gen.manual_seed(0)
        params = init_params(cfg, gen, device="cpu")
        model = Model(cfg)
        batch = {k: torch.as_tensor(v) for k, v in synthetic_batch(
            cfg, ShapeSpec("smoke", 32, 2, "train"), 0).items()}
        logits, loss, grads = _lm_run(model, params, batch)
        dparams = tree_map(lambda t: distribute_tensor(t, dm, rep), params)
        dbatch = {k: distribute_tensor(v, dm, rep) for k, v in batch.items()}
        seen.clear()
        ctx._constrain = spy
        ctx.set_dp_axes(("data",), 2)
        ctx.set_model_axis("model", 4)
        try:
            with implicit_replication():
                dlogits, dloss, dgrads = _lm_run(model, dparams, dbatch)
        finally:
            ctx._constrain = constrain
            ctx.set_dp_axes(None)
            ctx.set_model_axis(None)
        res[name] = dict(
            calls=list(seen), logits_placements=tuple(str(p) for p in dlogits.placements),
            logits_equal=bool(torch.equal(dlogits.full_tensor(), logits)),
            loss_d=float((dloss.full_tensor() - loss).abs()),
            grad_rel=[float((d.full_tensor().float() - g.float()).abs().max()
                            / g.float().abs().max().clamp_min(1e-30))
                      for d, g in zip(dgrads, grads) if g is not None])
    return res


def case_elastic(inputs, out_dir):
    """Saved from (2, 4), restored onto (4, 2).  The save gathers no leaf
    (``full_tensor`` is never called) and the restore reads each rank's
    block only: numpy's peak allocation stays under half of the largest
    leaf, of which a rank's block is an eighth."""
    import tracemalloc

    from torch.distributed.tensor import DTensor

    m1 = M.make_mesh((2, 4), ("data", "model"), device="cpu")
    leaves = {"w": torch.arange(64.0).reshape(8, 8),
              "big": torch.from_numpy(inputs["big"]),
              "u": torch.arange(30.0).reshape(6, 5).to(torch.bfloat16)}   # uneven blocks
    specs = {"w": S.P("data", "model"), "big": S.P(("data", "model"), None),
             "u": S.P("model", None)}
    state = {"params": S.shard_tree(leaves, m1, specs), "step": 3}
    where = os.path.join(out_dir, "ckpt")
    gathers, full_tensor = [], DTensor.full_tensor
    DTensor.full_tensor = lambda self, *a, **k: gathers.append(1) or full_tensor(self, *a, **k)
    try:
        ckpt.save(where, state)
    finally:
        DTensor.full_tensor = full_tensor
    m2 = M.make_mesh((4, 2), ("data", "model"), device="cpu")
    targets = {"w": S.P("data", "model"), "big": S.P(None, ("data", "model")),
               "u": S.P(None, "data")}
    sh = {"params": {k: S.NamedSharding(m2, v) for k, v in targets.items()}, "step": None}
    tracemalloc.start()
    got = ckpt.restore(where, device="cpu", shardings=sh)
    peak = tracemalloc.get_traced_memory()[1]
    tracemalloc.stop()
    res = dict(step=got["step"], gathers=len(gathers), peak=peak,
               big_bytes=leaves["big"].numel() * leaves["big"].element_size())
    for k, t in got["params"].items():
        res[k] = dict(mesh_shape=tuple(t.device_mesh.shape),
                      placements=tuple(str(p) for p in t.placements), local=_np(t.to_local()),
                      dtype=str(t.dtype), full_equal=bool(torch.equal(t.full_tensor(), leaves[k])))
    return res


def _stage_fn(p, xb):
    return torch.tanh(xb @ p["w"])


def case_pipeline(inputs, out_dir):
    """The stage weights as DTensors sharded over "stage": distributed from
    the whole stack, or built from the rank's own stage only.  A plain
    stack over four stages is refused."""
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

    mesh = M.make_mesh((4, 2), ("stage", "data"), device="cpu")
    dm = mesh.device_mesh
    stage = dm.get_local_rank("stage")
    res = {"stage": stage}
    placements = [Shard(0), Replicate()]
    for form in ("local", "dtensor"):
        w = torch.from_numpy(inputs["w"])
        if form == "dtensor":
            w = distribute_tensor(w, dm, placements)
        else:
            w = DTensor.from_local(w[stage:stage + 1].clone(), dm, placements, run_check=False)
        w.requires_grad_(True)
        x = torch.from_numpy(inputs["x"]).requires_grad_(True)
        out = pipeline_apply(_stage_fn, {"w": w}, x, mesh, axis="stage")
        (out * torch.from_numpy(inputs["cot"])).sum().backward()
        res[form] = dict(out=_np(out), gx=_np(x.grad), gw=_np(w.grad.full_tensor()))
    try:
        pipeline_apply(_stage_fn, {"w": torch.from_numpy(inputs["w"])},
                       torch.from_numpy(inputs["x"]), mesh, axis="stage")
        res["stack_refused"] = None
    except ValueError as e:
        res["stack_refused"] = str(e)
    return res


# ``launch/dryrun.build_case`` on the (2, 4) mesh: the reference's mini
# dry-run (train, and prefill and decode at its decode shape) and the train
# step of the other seven architectures, every family's sharding roles once
DRYRUN_FULL = ("qwen3-moe-30b-a3b", "zamba2-1.2b", "whisper-large-v3")
DRYRUN_TRAIN = ("llama3-405b", "gemma3-27b", "llava-next-mistral-7b", "phi4-mini-3.8b",
                "h2o-danube-1.8b", "qwen3-moe-235b-a22b", "xlstm-125m")
DRYRUN_TRAIN_SHAPE = ShapeSpec("t", 64, 8, "train")
DRYRUN_DECODE_SHAPE = ShapeSpec("d", 64, 8, "decode")


# decode from a cache filled to FILLED_LEN of its 64 slots: on (2, 4) each
# "model" rank holds 16 slots, so every rank holds live slots, and the
# FILLED_STEPS steps write slots 60-63 (rank 3) and then wrap to 0-1 (rank 0)
FILLED_LEN, FILLED_STEPS = 60, 6


def filled_cache(cfg, seed: int = 1):
    """``cache_struct`` at the decode shape with every leaf drawn from
    ``seed`` (normal, attention and cross-attention K/V at unit scale, the
    SSM states at half) and ``len`` = ``FILLED_LEN``."""
    model = Model(cfg)
    cache = model.cache_struct(DRYRUN_DECODE_SHAPE.global_batch, DRYRUN_DECODE_SHAPE.seq_len,
                               device="cpu")
    rng = np.random.default_rng(seed)

    def fill(path, t):
        if path == "len":
            return torch.full((), FILLED_LEN, dtype=t.dtype)
        scale = 1.0 if path.rsplit("/", 1)[-1] in ("k", "v", "xk", "xv") else 0.5
        return torch.from_numpy(rng.normal(size=t.shape).astype(np.float32) * scale).to(t.dtype)

    return {k: ({n: fill(f"{k}/{n}", t) for n, t in v.items()} if isinstance(v, dict)
                else fill(k, v)) for k, v in cache.items()}


def dryrun_cfg(name):
    import dataclasses

    return dataclasses.replace(get_arch(name).reduced(), microbatches=2)


def _gathered(tree, keep: bool):
    """Each DTensor leaf's whole value as float32 numpy (every rank takes
    part in the gathers; only rank 0 keeps them when ``keep`` is False)."""
    return tree_map(lambda t: (lambda a: a if keep else None)(_np(t.full_tensor())), tree)


def _placed(tree):
    return {k: tuple(str(p) for p in t.placements) for k, t in tree_paths(tree).items()}


def _local_bytes(tree):
    return {k: t.to_local().numel() * t.element_size() for k, t in tree_paths(tree).items()}


def _dryrun_train(name, mesh, keep):
    from repro_torch.launch.dryrun import build_case

    cfg = dryrun_cfg(name)
    try:
        step, (params, opt_state, batch) = build_case(cfg, DRYRUN_TRAIN_SHAPE, mesh)
        # the inputs' fingerprint: the tests draw them again from the seed
        res = dict(input_sums={k: float(t.full_tensor().double().sum())
                               for k, t in tree_paths(params).items()},
                   batch=_gathered(batch, keep),
                   param_placements=_placed(params), param_bytes=_local_bytes(params),
                   mu_bytes=_local_bytes(opt_state.mu), nu_bytes=_local_bytes(opt_state.nu),
                   batch_placements=_placed(batch))
        # the step in its two halves, reading the gradients in between
        loss, grads = step.grads(params, batch)
        res.update(grads=_gathered(grads, keep),
                   grad_placements=_placed(grads),
                   grad_dtypes={k: str(t.dtype) for k, t in tree_paths(grads).items()})
        metrics, params, opt_state = step.apply(loss, grads, params, opt_state)
        res.update(loss=float(metrics["loss"]), grad_norm=float(metrics["grad_norm"]),
                   params=_gathered(params, keep), after_placements=_placed(params),
                   opt_step=int(opt_state.step.full_tensor()))
    finally:
        ctx.set_dp_axes(None)
        ctx.set_model_axis(None)
        ctx.set_seq_axis(None)
    return res


def case_dryrun(inputs, out_dir):
    """``build_case``'s steps; rank 0 keeps the gathered values, the other
    ranks their placements and local sizes."""
    from repro_torch.launch.dryrun import build_case

    keep = dist.get_rank() == 0
    mesh = M.make_mesh((2, 4), ("data", "model"), device="cpu")
    res = {}
    for name in DRYRUN_FULL + DRYRUN_TRAIN:
        res[name] = {"train": _dryrun_train(name, mesh, keep)}
    for name in DRYRUN_FULL:
        cfg = dryrun_cfg(name)
        try:
            shape = ShapeSpec("d", DRYRUN_DECODE_SHAPE.seq_len,
                              DRYRUN_DECODE_SHAPE.global_batch, "prefill")
            fn, (params, batch) = build_case(cfg, shape, mesh)
            logits, cache = fn(params, batch)
            res[name]["prefill"] = dict(batch=_gathered(batch, keep),
                                        logits=_gathered(logits, keep),
                                        cache=_gathered(cache, keep),
                                        logits_placements=tuple(map(str, logits.placements)),
                                        cache_placements=_placed(cache))
            fn, (params, cache, tokens) = build_case(cfg, DRYRUN_DECODE_SHAPE, mesh)
            first, steps = tokens, []
            for _ in range(2):
                logits, cache = fn(params, cache, tokens)
                steps.append(dict(logits=_gathered(logits, keep), cache=_gathered(cache, keep),
                                  cache_placements=_placed(cache)))
                tokens = _next_tokens(logits, tokens)
            res[name]["decode"] = dict(tokens=_gathered(tokens, keep), steps=steps)
            # from a cache whose live slots lie on every "model" rank, past
            # the ring's end
            filled = filled_cache(cfg)
            cache = S.shard_tree(filled, mesh, S.cache_specs(cfg, filled, mesh))
            tokens, steps = first, []
            for _ in range(FILLED_STEPS):
                logits, cache = fn(params, cache, tokens)
                steps.append(dict(logits=_gathered(logits, keep), cache=_gathered(cache, keep)))
                tokens = _next_tokens(logits, tokens)
            res[name]["decode_filled"] = dict(tokens=_gathered(tokens, keep), steps=steps)
        finally:
            ctx.set_dp_axes(None)
            ctx.set_model_axis(None)
            ctx.set_seq_axis(None)
    return res


def _next_tokens(logits, tokens):
    """The greedy next tokens, as a DTensor laid out as ``tokens``."""
    from torch.distributed.tensor import DTensor

    nxt = torch.argmax(logits.to_local(), -1).to(torch.int32)
    return DTensor.from_local(nxt, tokens.device_mesh, tokens.placements, run_check=False)


class CommBytes:
    """The bytes each collective takes in (its operand bytes), on this rank:
    ``analysis/census.Census``'s collectives, whose result bytes
    (``census.collective_stats``) the reference's ``hlo.py`` counts."""

    def __enter__(self):
        from repro_torch.analysis.census import Census

        self.census = Census()
        self.census.__enter__()
        return self

    def __exit__(self, *exc):
        self.census.__exit__(*exc)

    @property
    def ops(self) -> list:
        return [(c.op, c.operand_bytes) for c in self.census.collectives]


def case_wire(inputs, out_dir):
    """xlstm-125m at reduced size with ``fsdp=False`` on an (8,) data mesh,
    batch (8, 32): the bytes of one step's collectives with
    ``grad_compression="bf16"``, and of a copy of the step that casts after
    the sync (each microbatch's gradients synced in float32)."""
    import dataclasses

    from repro_torch.analysis.census import collective_stats
    from repro_torch.launch.dryrun import build_case
    from repro_torch.train import trainer as T
    from repro_torch.train.optimizer import Adam

    mesh = M.make_mesh((8,), ("data",), device="cpu")
    cfg = dataclasses.replace(get_arch("xlstm-125m").reduced(), fsdp=False)
    res = {}
    try:
        for what in ("bf16", "cast_after_sync"):
            _, (params, opt_state, batch) = build_case(cfg, ShapeSpec("w", 32, 8, "train"), mesh)
            step = T.make_train_step(T.Model(cfg), Adam(lr=1e-3), 1, grad_compression="bf16")
            sync = T._sharded_grads
            if what == "cast_after_sync":
                T._sharded_grads = lambda m, c, p, b, specs, wire: sync(m, c, p, b, specs,
                                                                        torch.float32)
            try:
                with CommBytes() as count:
                    metrics, params, _ = step(params, opt_state, batch)
            finally:
                T._sharded_grads = sync
            res[what] = dict(ops=count.ops, stats=collective_stats(count.census),
                             loss=float(metrics["loss"]),
                             param_bytes=sum(t.numel() * t.element_size()
                                             for t in tree_leaves(params)))
    finally:
        ctx.set_dp_axes(None)
        ctx.set_model_axis(None)
        ctx.set_seq_axis(None)
    return res


SPLIT_ARCH = "phi4-mini-3.8b"


def case_split(inputs, out_dir):
    """``build_case``'s train step on a (4, 2) mesh, whose data degree (4)
    does not divide the 2 microbatches: the batch's rows reach the
    microbatches by one all-to-all (``trainer._split_batch``).  Rank 0
    keeps each microbatch's rows and the step's loss, grad norm and
    parameters."""
    from repro_torch.launch.dryrun import build_case
    from repro_torch.train import trainer as T

    keep = dist.get_rank() == 0
    mesh = M.make_mesh((4, 2), ("data", "model"), device="cpu")
    try:
        step, (params, opt_state, batch) = build_case(dryrun_cfg(SPLIT_ARCH),
                                                      DRYRUN_TRAIN_SHAPE, mesh)
        parts = T._split_batch(batch, 2, {"tokens": S.P(None, "data")})
        res = dict(microbatches=[_gathered(p, keep) for p in parts],
                   placements=[_placed(p) for p in parts])
        metrics, params, opt_state = step(params, opt_state, batch)
        res.update(loss=float(metrics["loss"]), grad_norm=float(metrics["grad_norm"]),
                   params=_gathered(params, keep), param_placements=_placed(params))
    finally:
        ctx.set_dp_axes(None)
        ctx.set_model_axis(None)
        ctx.set_seq_axis(None)
    return res


CASES = {"meshes": case_meshes, "shard_tree": case_shard_tree, "ctx": case_ctx,
         "ctx_model": case_ctx_model, "elastic": case_elastic, "pipeline": case_pipeline,
         "dryrun": case_dryrun, "wire": case_wire, "split": case_split}


WORLD = 8
PIPE_S, PIPE_M, PIPE_D, PIPE_MB = 4, 6, 16, 8
REPO = Path(__file__).resolve().parent.parent


def inputs() -> dict:
    r = np.random.default_rng(0)
    return dict(
        w=(r.normal(size=(PIPE_S, PIPE_D, PIPE_D)) * 0.3).astype(np.float32),
        x=r.normal(size=(PIPE_M, PIPE_MB, PIPE_D)).astype(np.float32),
        cot=r.normal(size=(PIPE_M, PIPE_MB, PIPE_D)).astype(np.float32),
        act=r.normal(size=(8, 16, 32)).astype(np.float32),
        dispatch=r.normal(size=(4, 8, 3, 16)).astype(np.float32),
        big=r.normal(size=(512, 512)).astype(np.float32))


def spawn(where: Path) -> list:
    """Starts the ``WORLD`` ranks in ``where`` (from a test process, which
    never joins the group) and returns what each one saw."""
    import subprocess

    where.mkdir(parents=True, exist_ok=True)
    np.savez(where / "inputs.npz", **inputs())
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(REPO / "src"), str(REPO / "tests")]))
    procs = []
    for rank in range(WORLD):
        log = open(where / f"rank{rank}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "_dist_ranks", str(rank), str(WORLD),
             str(where / "store"), str(where), str(where / "inputs.npz")],
            env=env, stdout=log, stderr=subprocess.STDOUT, cwd=REPO), log))
    try:
        for p, _ in procs:
            p.wait(timeout=600)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    bad = [r for r, (p, _) in enumerate(procs) if p.returncode != 0]
    assert not bad, "\n".join((where / f"rank{r}.log").read_text()[-3000:] for r in bad)
    return [pickle.loads((where / f"rank{r}.pkl").read_bytes()) for r in range(WORLD)]


def main(argv):
    rank, world = int(argv[0]), int(argv[1])
    store, out_dir, inputs = argv[2], argv[3], dict(np.load(argv[4]))
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    res = {"seconds": {}}
    try:
        for name, case in CASES.items():
            t0 = time.perf_counter()
            try:
                res[name] = case(inputs, out_dir)
            except Exception:
                res[name] = {"error": traceback.format_exc()}
            dist.barrier()
            res["seconds"][name] = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


if __name__ == "__main__":
    main(sys.argv[1:])
