"""Gradients of the port's LM against ``jax.grad`` of ``repro``'s: the
building blocks of ``models/layers.py``, ``models/ssm.py`` and
``models/moe.py`` at the shapes ``tests/test_torch_lm_layers.py`` uses,
the tie rule of ``at_least`` / ``at_most`` (the reference's
``jnp.maximum`` / ``jnp.minimum``), ``Model.loss_fn``'s value and
gradient for seven architectures at ``reduced()`` size, and the three
remat modes bit for bit.

Inputs are made with numpy from a seed; the LM parameters are the
reference's, carried across by ``convert.lm_params_from_numpy``.
Tolerances (the measured worst value beside each):

* building blocks in float32: relative L2 of each gradient 1e-5
  (attention 2.5e-7, cross-entropy 1.6e-7, GLA 3.9e-7, causal conv 7.6e-8,
  sLSTM 1.8e-7, the MoE FFN 2.7e-7);
* ``loss_fn`` at reduced size: the loss rtol 1e-3 (worst 3.5e-4, qwen3);
  each gradient leaf relative L2 <= 5e-2 and cosine >= 0.998 (worst
  3.4e-2 / 0.9995, zamba2's ``mamba1/dt_bias``).  qwen3-moe-30b-a3b is held
  to 8e-2 / 0.996 (worst 6.5e-2 / 0.9979, its expert weights): its last
  layer sends 3 of 64 tokens to another expert than the reference does
  (their second and third router probabilities lie within 7e-4, inside
  the bf16 forward's difference), which moves those experts' gradients.
  A leaf whose reference gradient is below 1e-6 in norm (rounding level)
  is held to a norm below 1e-5 instead.
* remat "none" / "group" / "block": equal bit for bit, with two or more
  groups in a scan (every architecture but zamba2 at ``reduced()`` size;
  ``scan_group`` alone at 4 and 9 layers).

The reference gradients, one JAX compile per architecture, are built once
per test run and shared by the xdist workers (``tests/_shared_runs.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _shared_runs import shared
from repro import configs as jconfigs
from repro.configs import base as jbase
from repro.models import layers as JL
from repro.models import lm as JLM
from repro.models import moe as JM
from repro.models import ssm as JS
from repro.train import data as jdata
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.models import layers as TL
from repro_torch.models import lm as TLM
from repro_torch.models import moe as TM
from repro_torch.models import ssm as TS
from repro_torch.train.optimizer import tree_leaves, tree_paths
from repro_torch.train.trainer import loss_and_grads

SMOKE = jbase.ShapeSpec("smoke", seq_len=32, global_batch=2, kind="train")
# the reference's test_loss_decreases list, and gemma3's local:global windows
GRAD_ARCHS = ["phi4-mini-3.8b", "xlstm-125m", "qwen3-moe-30b-a3b", "zamba2-1.2b",
              "whisper-large-v3", "llava-next-mistral-7b", "gemma3-27b"]
LEAF_BOUND = dict(rel=5e-2, cos=0.998)
LEAF_BOUND_BY_ARCH = {"qwen3-moe-30b-a3b": dict(rel=8e-2, cos=0.996)}


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """Reduced-size models are thousands of small CPU ops, which a pool of
    intra-op threads only slows, the more so when the test run's other
    workers hold every core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(x):
    return x.detach().float().numpy() if torch.is_tensor(x) else np.asarray(x, np.float32)


def _rel(got, want) -> float:
    g, w = _np(got).ravel(), _np(want).ravel()
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))


def _grads_both(jfn, tfn, arrays, cot_seed, argnums):
    """Gradients of sum(out * cot) with respect to ``arrays[argnums]`` for
    the reference function and the port's, on the same float32 inputs; a
    tuple output takes a cotangent per element."""
    jargs = [jnp.asarray(a) for a in arrays]
    out = jax.eval_shape(jfn, *jargs)
    outs = out if isinstance(out, tuple) else (out,)
    r = np.random.default_rng(cot_seed)
    cots = [r.normal(size=o.shape).astype(np.float32) for o in outs]

    def jloss(*args):
        o = jfn(*args)
        o = o if isinstance(o, tuple) else (o,)
        return sum(jnp.sum(a.astype(jnp.float32) * c) for a, c in zip(o, cots))

    want = jax.jit(jax.grad(jloss, argnums=argnums))(*jargs)
    targs = [torch.tensor(a, requires_grad=i in argnums) for i, a in enumerate(arrays)]
    o = tfn(*targs)
    o = o if isinstance(o, tuple) else (o,)
    loss = sum(torch.sum(a.float() * torch.from_numpy(c)) for a, c in zip(o, cots))
    got = torch.autograd.grad(loss, [targs[i] for i in argnums])
    return got, want


# ---------------------------------------------------------------------------
# the repaired clamps: JAX's gradient at a tie
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("site,fn,jfn,bound", [
    ("layers.blockwise_attention: acc / max(l, 1e-30)", TL.at_least, jnp.maximum, 1e-30),
    ("ssm.chunked_gla: exp(min(A_i - A_j, 0))", TL.at_most, jnp.minimum, 0.0),
    ("ssm.slstm_scan: c / max(n, 1)", TL.at_least, jnp.maximum, 1.0),
    ("lm._mlstm_seq and decode: num / max(|den|, 1)", TL.at_least, jnp.maximum, 1.0),
    ("moe.moe_ffn: w / max(sum w, 1e-9)", TL.at_least, jnp.maximum, 1e-9),
])
def test_tie_gradient_is_jaxs(site, fn, jfn, bound):
    """At x == bound the gradient splits half and half (``torch.clamp``
    would pass 1); off the tie it is 1 or 0, as ``jax.grad`` gives."""
    xs = np.array([bound, bound, np.float32(bound) * 2 + 1, np.float32(bound) - 1], np.float32)
    x = torch.tensor(xs, requires_grad=True)
    w = torch.tensor([1.0, -3.0, 2.0, 5.0])
    (got,) = torch.autograd.grad(torch.sum(fn(x, bound) * w), [x])
    want = jax.grad(lambda v: jnp.sum(jfn(v, bound) * jnp.asarray(w.numpy())))(jnp.asarray(xs))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(fn(x, bound).detach().numpy(),
                                  torch.clamp(x, **({"min": bound} if jfn is jnp.maximum
                                                    else {"max": bound})).detach().numpy())


def test_slstm_gradient_at_a_tie_is_jaxs():
    """sLSTM's first step from a state with n = 1, a forget gate of 1 and an
    input gate of 0: the step's n is exactly 1, tied with the floor of
    ``max(n, 1)``, and the gradient reaches the initial state's n."""
    b, h, hd = 1, 2, 3
    gates = np.zeros((b, 2, h, hd, 4), np.float32)
    gates[..., 0] = -200.0      # log i: exp(log_i - m) underflows to 0
    gates[..., 1] = 100.0       # log sigmoid(100) == 0 in float32
    gates[..., 2] = 0.5
    gates[..., 3] = 0.3
    r = np.zeros((4, h, hd, hd), np.float32)
    init = [np.full((b, h, hd), v, np.float32) for v in (0.7, 1.0, 0.0, 0.2)]

    def tfn(g, rr, c, n, m, hh):
        return TS.slstm_scan(g, rr, init=(c, n, m, hh))[0]

    def jfn(g, rr, c, n, m, hh):
        return JS.slstm_scan(g, rr, init=(c, n, m, hh))[0]

    got, want = _grads_both(jfn, tfn, [gates, r, *init], 1, (0, 2, 3, 4, 5))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


@pytest.mark.parametrize("causal,window,t,kv_chunk,heads,q_offset", [
    (True, 0, 16, 4, (4, 4), 0),
    (True, 5, 16, 4, (4, 2), 0),
    (False, 0, 20, 8, (4, 1), 0),
    (False, 0, 7, 16, (2, 2), 0),
    (True, 3, 16, 16, (6, 3), 4),
], ids=["causal", "window-gqa", "padded-kv", "short-kv", "offset"])
def test_blockwise_attention_grad(causal, window, t, kv_chunk, heads, q_offset):
    h, kv = heads
    s = t if q_offset == 0 else 8
    arrs = [_rand(10, 2, s, h, 16), _rand(11, 2, t, kv, 16), _rand(12, 2, t, kv, 16)]
    kw = dict(causal=causal, window=window, q_offset=q_offset, kv_chunk=kv_chunk)
    got, want = _grads_both(lambda q, k, v: JL.blockwise_attention(q, k, v, **kw),
                            lambda q, k, v: TL.blockwise_attention(q, k, v, **kw),
                            arrs, 13, (0, 1, 2))
    for g, w in zip(got, want):
        assert _rel(g, w) < 1e-5


@pytest.mark.parametrize("s,chunk", [(16, 512), (20, 8), (24, 8)])
def test_chunked_cross_entropy_grad(s, chunk):
    r = np.random.default_rng(30)
    labels = r.integers(0, 50, size=(2, s)).astype(np.int32)
    x = r.normal(size=(2, s, 24)).astype(np.float32)
    head = r.normal(size=(24, 50)).astype(np.float32) * 0.3
    mask = (r.uniform(size=(2, s)) > 0.2).astype(np.float32)
    jl, jm = jnp.asarray(labels), jnp.asarray(mask)
    tl, tm = torch.from_numpy(labels), torch.from_numpy(mask)
    got, want = _grads_both(
        lambda a, hd: JL.chunked_cross_entropy(a, hd, jl, jm, chunk=chunk),
        lambda a, hd: TL.chunked_cross_entropy(a, hd, tl, tm, chunk=chunk),
        [x, head], 31, (0, 1))
    for g, w in zip(got, want):
        assert _rel(g, w) < 1e-5


def test_chunked_cross_entropy_backward_holds_one_chunk():
    """Under autograd the forward keeps each chunk's inputs only: no saved
    tensor is as large as one chunk's (B, C, V) logits."""
    x = torch.randn(2, 64, 8, requires_grad=True)
    head = torch.randn(8, 1000, requires_grad=True)
    labels = torch.randint(0, 1000, (2, 64))
    mask = torch.ones(2, 64)
    sizes = []

    def pack(t):
        sizes.append(t.numel())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = TL.chunked_cross_entropy(x, head, labels, mask, chunk=16)
    assert max(sizes) < 2 * 16 * 1000
    loss.backward()
    assert x.grad is not None and head.grad is not None


def _gla_inputs(seed, b, s, h, dk, dv):
    r = np.random.default_rng(seed)
    q, k = (r.normal(size=(b, s, h, dk)).astype(np.float32) for _ in range(2))
    v = r.normal(size=(b, s, h, dv)).astype(np.float32)
    a = -np.log1p(np.exp(r.normal(size=(b, s, h)))).astype(np.float32)
    return [q, k, v, a]


@pytest.mark.parametrize("s,chunk,with_state", [
    (8, 4, False), (16, 16, False), (32, 8, False), (24, 8, True)])
def test_chunked_gla_grad(s, chunk, with_state):
    arrs = _gla_inputs(40, 2, s, 3, 5, 7)
    if with_state:
        arrs.append(np.random.default_rng(41).normal(size=(2, 3, 5, 7)).astype(np.float32))
    n = len(arrs)
    got, want = _grads_both(
        lambda *a: JS.chunked_gla(*a[:4], state=a[4] if n == 5 else None, chunk=chunk),
        lambda *a: TS.chunked_gla(*a[:4], state=a[4] if n == 5 else None, chunk=chunk),
        arrs, 42, tuple(range(n)))
    for g, w in zip(got, want):
        assert _rel(g, w) < 1e-5


def test_causal_conv1d_grad():
    got, want = _grads_both(JS.causal_conv1d, TS.causal_conv1d,
                            [_rand(50, 2, 10, 6), _rand(51, 4, 6)], 52, (0, 1))
    for g, w in zip(got, want):
        assert _rel(g, w) < 1e-5


def test_slstm_scan_grad():
    got, want = _grads_both(lambda g, r: JS.slstm_scan(g, r)[0],
                            lambda g, r: TS.slstm_scan(g, r)[0],
                            [_rand(60, 2, 16, 2, 8, 4, scale=2.0), _rand(61, 4, 2, 8, 8, scale=0.2)],
                            62, (0, 1))
    for g, w in zip(got, want):
        assert _rel(g, w) < 1e-5


@pytest.mark.parametrize("s,e,k,factor", [
    (16, 4, 2, 4.0), (32, 8, 2, 8.0), (8, 8, 4, 8.0),
    (32, 8, 2, 1.0), (32, 4, 2, 0.05)],
    ids=["16-4-2", "32-8-2", "8-8-4", "drops-1.0", "drops-0.05"])
def test_moe_ffn_grad(s, e, k, factor):
    """Through the gather / ``scatter_add_`` dispatch, the gate weights and
    the load-balancing loss, dropped assignments included."""
    r = np.random.default_rng(80)
    arrs = [r.normal(size=(2, s, 16)).astype(np.float32) * 0.5,
            r.normal(size=(16, e)).astype(np.float32),
            *(r.normal(size=sh).astype(np.float32) * 0.2
              for sh in [(e, 16, 24), (e, 16, 24), (e, 24, 16)])]
    got, want = _grads_both(lambda *a: JM.moe_ffn(*a, k, capacity_factor=factor),
                            lambda *a: TM.moe_ffn(*a, k, factor),
                            arrs, 81, tuple(range(5)))
    for g, w in zip(got, want):
        assert _rel(g, w) < 1e-5


# ---------------------------------------------------------------------------
# loss_fn at reduced size
# ---------------------------------------------------------------------------


def _build_ref_grads(name):
    cfg = jconfigs.get_arch(name).reduced()
    params = JLM.init_params(cfg, jax.random.PRNGKey(0))
    batch = jdata.synthetic_batch(cfg, SMOKE, 0)
    loss, grads = jax.jit(jax.value_and_grad(JLM.Model(cfg).loss_fn))(
        params, jax.tree.map(jnp.asarray, batch))
    return dict(params=jax.device_get(params), batch=batch, loss=float(loss),
                grads=jax.device_get(grads))


@pytest.fixture(scope="module", params=GRAD_ARCHS)
def ref_grads(request, tmp_path_factory):
    name = request.param
    run = shared(request, tmp_path_factory, f"torch_lm_grad_{name}",
                 lambda: _build_ref_grads(name))
    cfg = tconfigs.get_arch(name).reduced()
    params = convert.lm_params_from_numpy(run["params"], device="cpu")
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in run["batch"].items()}
    return name, cfg, params, batch, run


def test_loss_and_grads_match(ref_grads):
    name, cfg, params, batch, run = ref_grads
    loss, grads = loss_and_grads(TLM.Model(cfg), params, batch)
    np.testing.assert_allclose(float(loss), run["loss"], rtol=1e-3)
    bound = LEAF_BOUND_BY_ARCH.get(name, LEAF_BOUND)
    got, want = tree_paths(grads), tree_paths(run["grads"])
    assert got.keys() == want.keys()
    for path, w in want.items():
        g = got[path]
        assert g.dtype == convert._leaf(np.asarray(w), "cpu").dtype, path
        assert tuple(g.shape) == np.shape(w), path
        wv, gv = _np(w).ravel(), _np(g).ravel()
        if np.linalg.norm(wv) < 1e-6:
            assert np.linalg.norm(gv) < 1e-5, path
            continue
        cos = float(wv @ gv / (np.linalg.norm(wv) * np.linalg.norm(gv)))
        assert _rel(g, w) <= bound["rel"] and cos >= bound["cos"], (path, _rel(g, w), cos)


@pytest.mark.parametrize("name", tconfigs.list_archs())
def test_remat_modes_equal_bit_for_bit(name, monkeypatch):
    """"none", "group" and "block" give the same loss and gradients; every
    architecture but zamba2 (two scans of 2 layers, one group each) runs a
    scan of two or more groups, where "group" and "block" differ."""
    cfg = tconfigs.get_arch(name).reduced()
    gen = torch.Generator()
    gen.manual_seed(0)
    params = TLM.init_params(cfg, gen, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in
             jdata.synthetic_batch(jconfigs.get_arch(name).reduced(), SMOKE, 0).items()}
    scans = []
    real = TLM.scan_group
    monkeypatch.setattr(TLM, "scan_group",
                        lambda x, st, body, layers, *a, **k:
                        scans.append(layers) or real(x, st, body, layers, *a, **k))
    runs = {mode: loss_and_grads(TLM.Model(dataclasses.replace(cfg, remat=mode)), params, batch)
            for mode in ("none", "group", "block")}
    groups = [n // TLM._remat_group_size(n) for n in scans]
    assert (max(groups) == 1) == (name == "zamba2-1.2b"), groups
    for mode in ("group", "block"):
        assert torch.equal(runs[mode][0], runs["none"][0]), mode
        for a, b in zip(tree_leaves(runs[mode][1]), tree_leaves(runs["none"][1])):
            assert torch.equal(a, b), mode


@pytest.mark.parametrize("layers,mode,want", [
    (4, "none", 0), (4, "group", 2), (4, "block", 2 + 4),
    (2, "group", 2), (2, "block", 2), (9, "block", 3 + 9)])
def test_remat_checkpoints_as_the_reference(layers, mode, want, monkeypatch):
    """Checkpoints per scan: none; one per group of
    ``_remat_group_size(L)`` layers ("group"); also one per layer inside
    ("block"); one per layer when there is a single group.  The output and
    the gradients equal "none"'s bit for bit."""
    assert TLM._remat_group_size(layers) == JLM._remat_group_size(layers)
    calls = []
    real = TLM.checkpointed
    monkeypatch.setattr(TLM, "checkpointed", lambda fn, *a: calls.append(1) or real(fn, *a))
    gen = torch.Generator()
    gen.manual_seed(layers)
    x0 = torch.randn(1, 2, 4, generator=gen)
    w0 = torch.randn(layers, 4, 4, generator=gen) / 2

    def body(xc, lp, _):
        return torch.tanh(xc.float() @ lp["w"].float()), None

    def run(m):
        x, w = x0.clone().requires_grad_(True), w0.clone().requires_grad_(True)
        y, _ = TLM.scan_group(x, {"w": w}, body, layers, m)
        forward_calls = len(calls)     # the backward's recompute calls again
        y.float().square().sum().backward()
        return forward_calls, (y.detach(), x.grad, w.grad)

    n, got = run(mode)
    assert n == want
    for a, b in zip(got, run("none")[1]):
        assert a is not None and torch.equal(a, b)
