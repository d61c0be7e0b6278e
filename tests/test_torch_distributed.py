"""Parity of the port's distributed layer with ``repro``'s: the sharding
rules (``param_specs``, ``opt_specs``, ``cache_specs``, ``batch_specs``) of
every architecture at full size on the reference's production and test
mesh shapes, with ``fsdp`` and ``pure_dp`` toggled; ``ctx`` as an identity
on plain tensors, with every LM output unchanged bit for bit; then eight
CPU ranks over gloo: ``launch/mesh.py``'s meshes, ``shard_tree``,
``constrain_batch`` redistributing a DTensor, elastic checkpoint restore
from a (2, 4) mesh onto (4, 2), and ``pipeline_apply`` at S=4, M=6, D=16
against the sequential stack, forward and backward.

The rules read a mesh's axis names and sizes only, so both packages get
the same stand-in mesh.  The reference's trees come from ``jax.eval_shape``,
the port's are the same shapes as ``meta`` tensors; specs must be equal
leaf by leaf.  The pipeline is held to the sequential stack (the reference's
own test's yardstick: its ``pipeline_apply`` runs only on forced host
devices) within 1e-5, computed with torch autograd and with ``jnp`` and
``jax.grad`` on the same numpy inputs.

The eight ranks (``tests/_dist_ranks.py``) are started once per test run
and their results shared by the xdist workers (``tests/_shared_runs.py``);
no process group is ever started in a test process.
"""

import dataclasses
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from _dist_ranks import PIPE_M, PIPE_S, WORLD, spawn
from _dist_ranks import inputs as _pipe_inputs
from _shared_runs import shared
from repro import configs as jconfigs
from repro.configs import base as jbase
from repro.distributed import pipeline_parallel as jpp
from repro.distributed import sharding as jsh
from repro.models import lm as JLM
from repro_torch import configs as tconfigs
from repro_torch.configs import base as tbase
from repro_torch.distributed import ctx
from repro_torch.distributed import pipeline_parallel as tpp
from repro_torch.distributed import sharding as tsh
from repro_torch.launch import mesh as tmesh
from repro_torch.models import lm as TLM
from repro_torch.train.optimizer import tree_leaves, tree_map

ARCHS = jconfigs.list_archs()
# the reference's production meshes and its tests' meshes
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "8": ((8,), ("data",))}
TOGGLES = ("default", "fsdp", "pure_dp")
PIPE_TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _stand_in(name):
    shape, axes = MESHES[name]
    return SimpleNamespace(axis_names=axes, devices=np.empty(shape, object))


def _toggled(cfg, toggle):
    if toggle == "fsdp":
        return dataclasses.replace(cfg, fsdp=not cfg.fsdp)
    if toggle == "pure_dp":
        return dataclasses.replace(cfg, pure_dp=not cfg.pure_dp)
    return cfg


def _key(k) -> str:
    if hasattr(k, "key"):
        return str(k.key)
    if hasattr(k, "name"):
        return "." + k.name
    return str(k.idx)


def _ref_flat(specs) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(specs, is_leaf=lambda x: isinstance(x, JP))[0]
    return {"/".join(_key(k) for k in path): tuple(s) for path, s in flat}


def _port_flat(tree, prefix=()) -> dict:
    if isinstance(tree, tsh.PartitionSpec):
        return {"/".join(prefix): tuple(tree)}
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree) for k, v in _port_flat(tree[key], prefix + (str(key),)).items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {k: v for f in tree._fields
                for k, v in _port_flat(getattr(tree, f), prefix + ("." + f,)).items()}
    return {k: v for i, x in enumerate(tree) for k, v in _port_flat(x, prefix + (str(i),)).items()}


def _batch_shapes(cfg, shape) -> dict:
    """The shapes of a shape cell's model inputs (``launch/dryrun.py``'s
    ``input_specs``)."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return {"tokens": (b, 1)}
    out = {"tokens": (b, s - (cfg.patch_tokens if cfg.family == "vlm" else 0))}
    if cfg.family == "vlm":
        out["patches"] = (b, cfg.patch_tokens, cfg.d_model)
    if cfg.family == "encdec":
        out["frames"] = (b, cfg.encoder_seq, cfg.d_model)
    return out


def _cells(lib, cfg, reduced):
    """The architecture's shape cells at full size; at reduced size the
    reference's mini dry-run cells (``tests/test_multidevice.py``)."""
    if reduced:
        return (lib.ShapeSpec("t", 64, 8, "train"), lib.ShapeSpec("d", 64, 8, "decode"))
    return lib.shape_cells(cfg)


@functools.lru_cache(maxsize=None)
def _ref_trees(name, reduced=False):
    cfg = jconfigs.get_arch(name)
    cfg = cfg.reduced() if reduced else cfg
    cells = _cells(jbase, cfg, reduced)
    params = jax.eval_shape(lambda: JLM.init_params(cfg, jax.random.PRNGKey(0)))
    caches = {c.name: jax.eval_shape(lambda c=c: JLM.Model(cfg).cache_struct(
        c.global_batch, c.seq_len)) for c in cells if c.kind == "decode"}
    batches = {c.name: {k: jax.ShapeDtypeStruct(v, jnp.int32 if k == "tokens" else jnp.float32)
                        for k, v in _batch_shapes(cfg, c).items()}
               for c in cells}
    return params, caches, batches


@functools.lru_cache(maxsize=None)
def _port_trees(name, reduced=False):
    """The port's trees: ``meta`` tensors at full size, the CPU's own
    ``init_params`` and ``cache_struct`` at reduced size."""
    cfg = tconfigs.get_arch(name)
    cfg = cfg.reduced() if reduced else cfg
    dev = "cpu" if reduced else "meta"
    gen = torch.Generator()
    gen.manual_seed(0)
    cells = _cells(tbase, cfg, reduced)
    params = TLM.init_params(cfg, gen, device=dev)
    caches = {c.name: TLM.Model(cfg).cache_struct(c.global_batch, c.seq_len, device=dev)
              for c in cells if c.kind == "decode"}
    batches = {c.name: {k: torch.empty(v, device="meta") for k, v in _batch_shapes(cfg, c).items()}
               for c in cells}
    return params, caches, batches


def _all_specs(lib, cfg, trees, mesh) -> dict:
    """{what: flat spec dict} of one package's four rules."""
    params, caches, batches = trees
    flat = _ref_flat if lib is jsh else _port_flat
    out = {"params": flat(lib.param_specs(cfg, params, mesh)),
           "opt": flat(lib.opt_specs(cfg, params, mesh))}
    out.update({f"cache {k}": flat(lib.cache_specs(cfg, c, mesh)) for k, c in caches.items()})
    out.update({f"batch {k}": flat(lib.batch_specs(cfg, b, mesh)) for k, b in batches.items()})
    return out


def _assert_specs_equal(name, toggle, reduced):
    jcfg = _toggled(jconfigs.get_arch(name), toggle)
    tcfg = _toggled(tconfigs.get_arch(name), toggle)
    if reduced:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    jt, tt = _ref_trees(name, reduced), _port_trees(name, reduced)
    sharded = 0
    for mname in MESHES:
        mesh = _stand_in(mname)
        want, got = _all_specs(jsh, jcfg, jt, mesh), _all_specs(tsh, tcfg, tt, mesh)
        assert got.keys() == want.keys()
        for what in want:
            assert got[what] == want[what], (mname, what)
            sharded += sum(any(a is not None for a in s) for s in got[what].values())
    return sharded


@pytest.mark.parametrize("toggle", TOGGLES)
@pytest.mark.parametrize("name", ARCHS)
def test_specs_match_at_full_size(name, toggle):
    """All four rules, every stand-in mesh, full size (``meta`` trees)."""
    sharded = _assert_specs_equal(name, toggle, reduced=False)
    assert sharded > 0


@pytest.mark.parametrize("name", ARCHS)
def test_specs_match_on_the_ports_reduced_trees(name):
    """At reduced size the port's own ``init_params`` and
    ``cache_struct(device="cpu")`` trees give the reference's paths and specs."""
    _assert_specs_equal(name, "default", reduced=True)


def test_partition_spec_and_placements():
    from torch.distributed.tensor import Replicate, Shard

    assert tsh.P(("data",), None) == tuple(JP(("data",), None))
    assert tsh.P(("pod", "data"), "model") == tuple(JP(("pod", "data"), "model"))
    axes = ("pod", "data", "model")
    assert tsh.placements(axes, tsh.P(("pod", "data"), None, "model")) == (
        Shard(0), Shard(0), Shard(2))
    assert tsh.placements(axes, tsh.P()) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="axis order"):
        tsh.placements(axes, tsh.P(("data", "pod")))
    with pytest.raises(ValueError, match="two dimensions"):
        tsh.placements(axes, tsh.P("model", "model"))


def test_mesh_helpers_match_the_reference():
    from repro.launch import mesh as jmesh

    for mname in MESHES:
        mesh = _stand_in(mname)
        assert tmesh.dp_axes(mesh) == jmesh.dp_axes(mesh)
        for a in ("pod", "data", "model", "stage"):
            assert tmesh.axis_size(mesh, a) == jmesh.axis_size(mesh, a)
    one = tmesh.make_mesh((1,), ("data",), device="cpu")
    assert one.devices.shape == (1,) and one.device_mesh is None
    with pytest.raises(ValueError, match="needs 256 ranks"):
        tmesh.make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="needs 2 ranks"):
        tmesh.make_mesh((2,), ("data",), device="cpu")


# ---------------------------------------------------------------------------
# ctx
# ---------------------------------------------------------------------------

@pytest.fixture
def ctx_set():
    ctx.set_dp_axes(("data",), 2)
    ctx.set_model_axis("model", 2)
    ctx.set_seq_axis("model", 2)
    yield
    ctx.set_dp_axes(None)
    ctx.set_model_axis(None)
    ctx.set_seq_axis(None)


def test_ctx_is_the_identity_while_unset_and_on_plain_tensors():
    x = torch.ones(4, 6, 8)
    e = torch.ones(4, 2, 3, 8)
    assert ctx.get_dp_axes() is None
    assert ctx.constrain_batch(x) is x and ctx.constrain_moe_dispatch(e) is e
    ctx.set_dp_axes(("data",), 2)
    try:
        assert ctx.get_dp_axes() == ("data",)
        assert ctx.constrain_batch(x) is x and ctx.constrain_moe_dispatch(e) is e
    finally:
        ctx.set_dp_axes(None)


def _lm_outputs(cfg, params, batch):
    model = TLM.Model(cfg)
    logits, cache = model.prefill(params, batch)
    tok = torch.argmax(logits, -1).to(torch.int32)
    step_logits, cache = model.decode_step(params, model.pad_cache(cache, 40), tok)
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss = model.loss_fn(live, batch)
    grads = torch.autograd.grad(loss, tree_leaves(live), allow_unused=True)
    return [logits, step_logits, loss.detach(), *[g for g in grads if g is not None],
            *[v for g in cache.values() for v in (g.values() if isinstance(g, dict) else [g])]]


@pytest.mark.parametrize("name", ARCHS)
def test_ctx_calls_leave_every_lm_output_bit_for_bit(name, monkeypatch):
    """The four calls the reference makes (the scan carry, the embedded
    inputs, the MoE dispatch and combine) are back; with the axes set they
    run and, on plain tensors, change no bit of prefill, decode, the loss
    or its gradients.  ``test_gloo_ctx_redistributes_inside_the_model``
    runs them on DTensors."""
    from repro_torch.train.data import synthetic_batch

    cfg = tconfigs.get_arch(name).reduced()
    gen = torch.Generator()
    gen.manual_seed(0)
    params = TLM.init_params(cfg, gen, device="cpu")
    batch = {k: torch.as_tensor(v) for k, v in synthetic_batch(
        cfg, tbase.ShapeSpec("smoke", 32, 2, "train"), 0).items()}
    unset = _lm_outputs(cfg, params, batch)
    seen = {"batch": 0, "moe": 0}
    real_b, real_m = ctx.constrain_batch, ctx.constrain_moe_dispatch

    def spy_b(x):
        seen["batch"] += 1
        return real_b(x)

    def spy_m(x):
        seen["moe"] += 1
        return real_m(x)

    monkeypatch.setattr(ctx, "constrain_batch", spy_b)
    monkeypatch.setattr(ctx, "constrain_moe_dispatch", spy_m)
    ctx.set_dp_axes(("data",), 2)
    ctx.set_model_axis("model", 2)
    ctx.set_seq_axis("model", 2)
    try:
        got = _lm_outputs(cfg, params, batch)
    finally:
        ctx.set_dp_axes(None)
        ctx.set_model_axis(None)
        ctx.set_seq_axis(None)
    assert len(got) == len(unset)
    assert all(torch.equal(a, b) for a, b in zip(got, unset))
    assert seen["batch"] > 0
    assert (seen["moe"] > 0) == (cfg.family == "moe")


# ---------------------------------------------------------------------------
# eight gloo ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ranks(request, tmp_path_factory):
    return shared(request, tmp_path_factory, "torch_dist_ranks",
                  lambda: spawn(tmp_path_factory.mktemp("gloo")))


def _case(ranks, name) -> list:
    for r, res in enumerate(ranks):
        assert "error" not in res[name], f"rank {r}:\n{res[name].get('error')}"
    return [res[name] for res in ranks]


@pytest.mark.parametrize("shape", [(2, 4), (4, 2)])
def test_gloo_make_mesh(ranks, shape):
    rows, cols = shape
    for rank, res in enumerate(_case(ranks, "meshes")):
        m = res[shape]
        assert m["axis_names"] == ("data", "model") and m["dm_names"] == ("data", "model")
        assert m["devices_shape"] == shape and m["dm_shape"] == shape
        i, j = divmod(rank, cols)
        assert m["coordinate"] == (i, j)
        assert m["groups"] == {"data": [j + cols * a for a in range(rows)],
                               "model": [cols * i + b for b in range(cols)]}
        assert m["dp_axes"] == ("data",)
        assert m["sizes"] == {"data": rows, "model": cols, "pod": 1}


def test_gloo_data_mesh_and_too_few_ranks(ranks):
    for res in _case(ranks, "meshes"):
        assert res["data"] == dict(axis_names=("data",), shape=(WORLD,), has_dm=True, sub=True)
        assert "needs 16 ranks" in res["too_big"] and "8 available" in res["too_big"]
        assert "needs 256 ranks" in res["production"]


def test_gloo_shard_tree_llama3_reduced(ranks):
    """The reference's test (``test_param_sharding_actually_shards``) and
    more: every leaf's ``full_tensor()`` is the input, the local shards are
    real parts of it, and the placements are the specs'."""
    for res in _case(ranks, "shard_tree"):
        assert all(v["equal"] for v in res.values())
        n_sharded = sum(1 for v in res.values() if any(p.startswith("S") for p in v["placements"]))
        assert n_sharded >= 6
        assert any(v["local_shape"] != v["shape"] for v in res.values())
        # wq (L, d, H*hd): FSDP over data on d, TP over model on the heads
        assert res["layers/wq"]["placements"] == ("S(1)", "S(2)")
        assert res["layers/wq"]["local_shape"] == (4, 64, 32)
        assert res["final_ln"]["placements"] == ("R", "R")


def test_gloo_constrain_batch_redistributes_a_dtensor(ranks):
    for res in _case(ranks, "ctx"):
        assert res["unset_same"] and res["plain_same"]
        assert res["batch"] == dict(placements=("S(0)", "R"), local_shape=(4, 16, 32), equal=True)
        assert res["batch_seq"] == dict(placements=("S(0)", "S(1)"), local_shape=(4, 4, 32),
                                        equal=True)
        assert res["moe"] == dict(placements=("S(0)", "S(1)"), local_shape=(2, 2, 3, 16),
                                  equal=True)


@pytest.mark.parametrize("name", ["phi4-mini-3.8b", "zamba2-1.2b"])
def test_gloo_ctx_redistributes_inside_the_model(ranks, name):
    """Replicated DTensor parameters and inputs on the (2, 4) mesh: every
    ``constrain_batch`` in prefill and in loss_fn (under remat, and its
    backward) returns the batch sharded over "data", and the outputs are
    the plain run's: logits bit for bit, the float32 loss within 1e-5 and
    each bf16 gradient within 4 bf16 ulps (2^-6) of its leaf's largest
    entry, since the batch sums are taken as two halves."""
    for res in _case(ranks, "ctx_model"):
        r = res[name]
        assert len(r["calls"]) >= 8
        assert {c[0] for c in r["calls"]} == {"P('data', None, None)"}
        assert {c[2] for c in r["calls"]} == {("S(0)", "R")}
        assert ("R", "R") in {c[1] for c in r["calls"]}
        assert r["logits_placements"] == ("S(0)", "R") and r["logits_equal"]
        assert r["loss_d"] <= 1e-5
        assert r["grad_rel"] and max(r["grad_rel"]) <= 2.0 ** -6


def test_gloo_elastic_restore_onto_a_new_mesh(ranks):
    """Saved sharded on (2, 4), restored onto (4, 2): every rank holds its
    (4, 2) block of what was saved (the reference's
    ``test_elastic_checkpoint_restore_new_mesh``), uneven and empty blocks
    and bf16 included.  No rank gathers a leaf to save it or loads a whole
    leaf to restore it."""
    w = np.arange(64.0, dtype=np.float32).reshape(8, 8)
    big = _pipe_inputs()["big"]
    u = np.arange(30.0, dtype=np.float32).reshape(6, 5)
    for rank, res in enumerate(_case(ranks, "elastic")):
        assert res["step"] == 3 and res["gathers"] == 0
        assert res["peak"] < res["big_bytes"] // 2, (res["peak"], res["big_bytes"])
        for k in ("w", "big", "u"):
            assert res[k]["full_equal"] and res[k]["mesh_shape"] == (4, 2), k
        i, j = divmod(rank, 2)
        assert res["w"]["placements"] == ("S(0)", "S(1)")
        np.testing.assert_array_equal(res["w"]["local"], w[2 * i:2 * i + 2, 4 * j:4 * j + 4])
        assert res["big"]["placements"] == ("S(1)", "S(1)")
        np.testing.assert_array_equal(res["big"]["local"], big[:, 64 * rank:64 * rank + 64])
        assert res["u"]["placements"] == ("S(1)", "R") and res["u"]["dtype"] == "torch.bfloat16"
        np.testing.assert_array_equal(res["u"]["local"], u[:, 2 * i:2 * i + 2])


def _sequential_torch():
    inp = _pipe_inputs()
    w = torch.from_numpy(inp["w"]).requires_grad_(True)
    x = torch.from_numpy(inp["x"]).requires_grad_(True)
    y = x
    for s in range(PIPE_S):
        y = torch.tanh(y @ w[s])
    (y * torch.from_numpy(inp["cot"])).sum().backward()
    return y.detach().numpy(), x.grad.numpy(), w.grad.numpy()


def _sequential_jax():
    inp = _pipe_inputs()

    def stack(w, x):
        for s in range(PIPE_S):
            x = jnp.tanh(x @ w[s])
        return x

    def loss(w, x):
        return jnp.sum(stack(w, x) * inp["cot"])

    gw, gx = jax.grad(loss, argnums=(0, 1))(jnp.asarray(inp["w"]), jnp.asarray(inp["x"]))
    return np.asarray(stack(inp["w"], inp["x"])), np.asarray(gx), np.asarray(gw)


@pytest.mark.parametrize("form", ["local", "dtensor"])
def test_gloo_pipeline_forward_matches_the_sequential_stack(ranks, form):
    want, _, _ = _sequential_torch()
    jwant, _, _ = _sequential_jax()
    results = _case(ranks, "pipeline")
    assert sorted(r["stage"] for r in results) == sorted(list(range(PIPE_S)) * 2)
    for res in results:
        np.testing.assert_allclose(res[form]["out"], want, **PIPE_TOL)
        np.testing.assert_allclose(res[form]["out"], jwant, **PIPE_TOL)
    assert 0 < tpp.bubble_fraction(PIPE_S, PIPE_M) < 0.5


@pytest.mark.parametrize("ref", ["torch", "jax"])
@pytest.mark.parametrize("form", ["local", "dtensor"])
def test_gloo_pipeline_grads_match_the_sequential_stack(ranks, form, ref):
    """d/dx and d/dw of sum(out * cot) on every rank, against autograd
    through the sequential stack and ``jax.grad`` of the reference's math."""
    _, gx, gw = _sequential_torch() if ref == "torch" else _sequential_jax()
    for res in _case(ranks, "pipeline"):
        np.testing.assert_allclose(res[form]["gx"], gx, **PIPE_TOL)
        np.testing.assert_allclose(res[form]["gw"], gw, **PIPE_TOL)


def test_gloo_pipeline_refuses_a_plain_stack_over_stages(ranks):
    for res in _case(ranks, "pipeline"):
        assert "must be a DTensor sharded on dim 0 over 'stage'" in res["stack_refused"]


@pytest.mark.parametrize("stages,mbs", [(1, 1), (4, 6), (8, 2), (2, 16)])
def test_bubble_fraction_matches_the_reference(stages, mbs):
    assert tpp.bubble_fraction(stages, mbs) == jpp.bubble_fraction(stages, mbs)


def test_pipeline_one_stage_on_the_cpu_matches_the_stack():
    """S=1 runs with no process group: forward and gradients of the
    sequential stack, microbatch by microbatch."""
    inp = _pipe_inputs()
    mesh = SimpleNamespace(axis_names=("stage",), devices=np.empty((1,), object),
                           device_mesh=None)
    w = torch.from_numpy(inp["w"][:1]).requires_grad_(True)
    x = torch.from_numpy(inp["x"]).requires_grad_(True)
    out = tpp.pipeline_apply(lambda p, xb: torch.tanh(xb @ p["w"]), {"w": w}, x, mesh)
    (out * torch.from_numpy(inp["cot"])).sum().backward()
    w2 = torch.from_numpy(inp["w"][:1]).requires_grad_(True)
    x2 = torch.from_numpy(inp["x"]).requires_grad_(True)
    want = torch.tanh(x2 @ w2[0])
    (want * torch.from_numpy(inp["cot"])).sum().backward()
    assert torch.equal(out, want.detach()) and torch.equal(x.grad, x2.grad)
    torch.testing.assert_close(w.grad, w2.grad, **PIPE_TOL)
    with torch.no_grad():
        assert torch.equal(tpp.pipeline_apply(lambda p, xb: torch.tanh(xb @ p["w"]),
                                              {"w": w}, x, mesh), out)
