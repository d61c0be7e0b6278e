"""One CPU rank of the gloo group that ``tests/test_torch_distributed.py``
starts: eight of these run every distributed case of the port (meshes,
``shard_tree``, ``ctx`` on DTensors and inside the model on them, elastic checkpoint restore,
``pipeline_apply``) and each pickles what it saw for the tests to check.

    python -m _dist_ranks RANK WORLD STORE_FILE OUT_DIR INPUTS_NPZ

(with ``src`` and ``tests`` on ``PYTHONPATH``).  A case that raises records
its traceback instead of its results; the other cases still run.  Imports
torch and the port only.
"""

import os
import pickle
import sys
import traceback

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


CASES = {"meshes": case_meshes, "shard_tree": case_shard_tree, "ctx": case_ctx,
         "ctx_model": case_ctx_model, "elastic": case_elastic, "pipeline": case_pipeline}


def main(argv):
    rank, world = int(argv[0]), int(argv[1])
    store, out_dir, inputs = argv[2], argv[3], dict(np.load(argv[4]))
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    res = {}
    try:
        for name, case in CASES.items():
            try:
                res[name] = case(inputs, out_dir)
            except Exception:
                res[name] = {"error": traceback.format_exc()}
            dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


if __name__ == "__main__":
    main(sys.argv[1:])
