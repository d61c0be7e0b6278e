"""Parity of the port's LM serving path with ``repro``: the ten
architectures' configs, the synthetic token stream, ``plan_groups``,
``init_params``' tree, and, at ``reduced()`` size, ``loss_fn``, ``prefill``
(logits and cache), ``pad_cache``, ``cache_struct`` and three teacher-forced
decode steps started from the reference's own prefill cache; then the
port's decode against its own forward, zamba2-1.2b's decode-vs-forward gap
at full width against the reference's, and ``launch/serve.py``.

Both packages run on the reference's parameters (carried across bit for
bit by ``convert.lm_params_from_numpy``).  Tolerances: logits atol/rtol
3e-2 for prefill (whisper-large-v3 4e-2, below) and 7e-2 for decode, as the
reference holds its own prefill and decode paths to each other
(``tests/test_models.py``); a prefill cache leaf 3e-2 of its largest
magnitude; ``loss_fn`` rtol 1e-3 (a mean of per-token losses, each a
logsumexp over logits within 3e-2 of each other); configs, batches,
groups, shapes, dtypes and ``pad_cache`` exactly.  The reference runs, one
per architecture, are built once per test run and shared by the xdist
workers (``tests/_shared_runs.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _shared_runs import shared
from _torch_parity import one_cpu_thread  # noqa: F401  (autouse fixture)
from repro import configs as jconfigs
from repro.configs import base as jbase
from repro.models import lm as JLM
from repro.train import data as jdata
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.launch import serve as tserve
from repro_torch.models import lm as TLM
from repro_torch.train import data as tdata

ARCHS = jconfigs.list_archs()
SMOKE = jbase.ShapeSpec("smoke", seq_len=32, global_batch=2, kind="train")
TSMOKE = tbase.ShapeSpec("smoke", seq_len=32, global_batch=2, kind="train")
DECODE_STEPS = 3
PREFILL_TOL = dict(atol=3e-2, rtol=3e-2)
DECODE_TOL = dict(atol=7e-2, rtol=7e-2)
# whisper-large-v3's prefill misses 3e-2 by 1e-3 on one of 1024 logits: a
# bf16 GEMM of its first encoder layer rounds one near-zero sum the other
# way (float32 accumulation order, XLA's against MKL's), and two encoder and
# four decoder layers, each attending over the whole memory, spread it.
PREFILL_TOL_BY_ARCH = {"whisper-large-v3": dict(atol=4e-2, rtol=4e-2)}


def _np32(x):
    return x.float().numpy() if torch.is_tensor(x) else np.asarray(x, np.float32)


def _leaves(tree, prefix=""):
    """{path: leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _build_ref(name):
    """The reference at ``reduced()`` size: params, batch, loss, prefill
    logits and cache, the padded cache, and DECODE_STEPS teacher-forced
    decode steps from it, all as numpy."""
    cfg = jconfigs.get_arch(name).reduced()
    model = JLM.Model(cfg)
    params = JLM.init_params(cfg, jax.random.PRNGKey(0))
    batch = jdata.synthetic_batch(cfg, SMOKE, 0)
    jb = jax.tree.map(jnp.asarray, batch)
    loss = jax.jit(model.loss_fn)(params, jb)
    logits, cache = jax.jit(model.prefill)(params, jb)
    padded = model.pad_cache(cache, int(cache["len"]) + DECODE_STEPS + 1)
    feed = np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(DECODE_STEPS, 2, 1)).astype(np.int32)
    decode = jax.jit(model.decode_step)
    c, dec = padded, []
    for tok in feed:
        lg, c = decode(params, c, jnp.asarray(tok))
        dec.append(np.asarray(lg))
    struct = jax.eval_shape(lambda: model.cache_struct(2, 40))
    return dict(params=jax.device_get(params), batch=batch, loss=float(loss),
                logits=np.asarray(logits), cache=jax.device_get(cache),
                padded=jax.device_get(padded), feed=feed, decode=dec,
                struct={k: (tuple(v.shape), str(v.dtype)) for k, v in _leaves(struct).items()})


@pytest.fixture(scope="module", params=ARCHS)
def ref(request, tmp_path_factory):
    name = request.param
    run = shared(request, tmp_path_factory, f"torch_lm_ref_{name}", lambda: _build_ref(name))
    cfg = tconfigs.get_arch(name).reduced()
    return name, cfg, TLM.Model(cfg), run, convert.lm_params_from_numpy(run["params"],
                                                                         device="cpu")


# ---------------------------------------------------------------------------
# configs, data, groups
# ---------------------------------------------------------------------------


def test_registry_matches():
    assert tconfigs.list_archs() == ARCHS and len(ARCHS) == 10
    assert list(tbase._REGISTRY) == list(jbase._REGISTRY)   # registration order
    assert {k: dataclasses.asdict(v) for k, v in tbase.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jbase.SHAPES.items()}
    with pytest.raises(KeyError, match="unknown arch"):
        tconfigs.get_arch("gpt-5")


@pytest.mark.parametrize("name", ARCHS)
def test_arch_config_matches(name):
    """Every field, full and reduced, and what the reference derives."""
    for t, j in ((tconfigs.get_arch(name), jconfigs.get_arch(name)),
                 (tconfigs.get_arch(name).reduced(), jconfigs.get_arch(name).reduced())):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.head_dim_ == j.head_dim_
        assert t.param_count() == j.param_count()
        assert t.active_param_count() == j.active_param_count()
        assert [s.name for s in tbase.shape_cells(t)] == [s.name for s in jbase.shape_cells(j)]
    assert [f.name for f in dataclasses.fields(tbase.ArchConfig)] == \
        [f.name for f in dataclasses.fields(jbase.ArchConfig)]


@pytest.mark.parametrize("name", ARCHS)
def test_synthetic_batch_bit_equal(name):
    cfg_t, cfg_j = tconfigs.get_arch(name).reduced(), jconfigs.get_arch(name).reduced()
    for step, seed in ((0, 0), (5, 3)):
        got = tdata.synthetic_batch(cfg_t, TSMOKE, step, seed)
        want = jdata.synthetic_batch(cfg_j, SMOKE, step, seed)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    it_t = tdata.data_iterator(cfg_t, TSMOKE, seed=2, start_step=4)
    it_j = jdata.data_iterator(cfg_j, SMOKE, seed=2, start_step=4)
    for _ in range(2):
        assert np.array_equal(next(it_t)["tokens"], next(it_j)["tokens"])


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("size", ["full", "reduced"])
def test_plan_groups_match(name, size):
    t, j = tconfigs.get_arch(name), jconfigs.get_arch(name)
    if size == "reduced":
        t, j = t.reduced(), j.reduced()
    assert [tuple(g) for g in TLM.plan_groups(t)] == [tuple(g) for g in JLM.plan_groups(j)]


def test_lm_params_from_numpy_keeps_bf16_bits():
    bits = np.random.default_rng(0).integers(0, 2 ** 16, size=(5, 7), dtype=np.uint16)
    bf = bits.view(jnp.bfloat16)
    tree = {"a": bf, "g": {"f": np.arange(6, dtype=np.float32), "i": np.arange(3, dtype=np.int32)}}
    out = convert.lm_params_from_numpy(tree, device="cpu")
    assert out["a"].dtype == torch.bfloat16
    assert np.array_equal(out["a"].view(torch.int16).numpy().view(np.uint16), bits)
    assert out["g"]["f"].dtype == torch.float32 and out["g"]["i"].dtype == torch.int32
    assert np.array_equal(out["g"]["f"].numpy(), tree["g"]["f"])
    cache = convert.lm_cache_from_numpy({"len": np.asarray(7, np.int32), "x": {"k": bf}},
                                        device="cpu")
    assert cache["len"].shape == () and cache["len"].dtype == torch.int32
    assert int(cache["len"]) == 7


def test_init_params_tree_matches(ref):
    """The reference's tree, shapes and dtypes; each leaf's spread within 10%
    of the reference's (constant leaves equal)."""
    name, cfg, _, run, _ = ref
    gen = torch.Generator()
    gen.manual_seed(0)
    got = _leaves(TLM.init_params(cfg, gen, device="cpu"))
    want = _leaves(run["params"])
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        assert tuple(g.shape) == w.shape, k
        assert str(g.dtype).replace("torch.", "") == str(w.dtype), k
        gs, ws = float(g.float().std()), float(np.asarray(w, np.float32).std())
        if ws == 0.0:
            assert np.array_equal(_np32(g), np.asarray(w, np.float32)), k
        else:
            assert abs(gs / ws - 1) < 0.1, (k, gs, ws)


def test_init_params_draws_on_the_generator():
    cfg = tconfigs.get_arch("xlstm-125m").reduced()
    draw = []
    for seed in (0, 0, 1):
        gen = torch.Generator()
        gen.manual_seed(seed)
        draw.append(TLM.init_params(cfg, gen, device="cpu")["embed"])
    assert torch.equal(draw[0], draw[1]) and not torch.equal(draw[0], draw[2])


# ---------------------------------------------------------------------------
# the model at reduced size, on the reference's parameters
# ---------------------------------------------------------------------------


def _batch(run):
    return tserve.device_batch(run["batch"], "cpu")


def test_loss_matches(ref):
    _, _, model, run, params = ref
    np.testing.assert_allclose(float(model.loss_fn(params, _batch(run))), run["loss"], rtol=1e-3)


def test_prefill_matches(ref):
    """Logits at 3e-2; each cache leaf at 3e-2 of its own largest magnitude
    (bf16 activations and float32 states of every scale, near-zero entries
    included)."""
    name, _, model, run, params = ref
    logits, cache = model.prefill(params, _batch(run))
    assert logits.dtype == torch.float32 and tuple(logits.shape) == run["logits"].shape
    np.testing.assert_allclose(_np32(logits), run["logits"],
                               **PREFILL_TOL_BY_ARCH.get(name, PREFILL_TOL))
    got, want = _leaves(cache), _leaves(run["cache"])
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape, k
        assert str(got[k].dtype).replace("torch.", "") == str(w.dtype), k
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(_np32(got[k]), w, rtol=3e-2,
                                   atol=3e-2 * max(1.0, float(np.abs(w).max())), err_msg=k)


def test_pad_cache_and_cache_struct_match(ref):
    _, _, model, run, _ = ref
    cache = convert.lm_cache_from_numpy(run["cache"], device="cpu")
    padded = model.pad_cache(cache, int(cache["len"]) + DECODE_STEPS + 1)
    got, want = _leaves(padded), _leaves(run["padded"])
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape, k
        np.testing.assert_array_equal(_np32(got[k]), np.asarray(w, np.float32), err_msg=k)
    struct = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
              for k, v in _leaves(model.cache_struct(2, 40, device="cpu")).items()}
    assert struct == run["struct"]


def test_decode_matches_from_the_reference_cache(ref):
    """Three teacher-forced steps from the reference's padded prefill cache."""
    _, _, model, run, params = ref
    cache = convert.lm_cache_from_numpy(run["padded"], device="cpu")
    start = int(cache["len"])
    for i, tok in enumerate(run["feed"]):
        logits, cache = model.decode_step(params, cache, torch.from_numpy(tok))
        np.testing.assert_allclose(_np32(logits), run["decode"][i], **DECODE_TOL,
                                   err_msg=f"step {i}")
    assert cache["len"].dtype == torch.int32 and int(cache["len"]) == start + DECODE_STEPS


@pytest.mark.parametrize("name", ["llama3-405b", "xlstm-125m", "zamba2-1.2b",
                                  "qwen3-moe-30b-a3b"])
def test_decode_consistent_with_forward(name):
    """The reference's invariant on the port: (prefill 16 tokens, decode
    token 16) against the forward over 17, within 3e-2 and 7e-2."""
    cfg = tconfigs.get_arch(name).reduced()
    if cfg.num_experts:  # capacity drops depend on the length: no drops here
        cfg = dataclasses.replace(cfg, moe_capacity_factor=float(cfg.num_experts))
    model = TLM.Model(cfg)
    gen = torch.Generator()
    gen.manual_seed(0)
    params = TLM.init_params(cfg, gen, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, size=(2, 17)).astype(np.int32))
    full = model._logits(params, model._backbone(
        params, model._embed_inputs(params, {"tokens": toks}))[0].to(TLM.BF16))
    logits_p, cache = model.prefill(params, {"tokens": toks[:, :16]})
    np.testing.assert_allclose(_np32(logits_p[:, 0]), _np32(full[:, 15]), **PREFILL_TOL)
    logits_d, _ = model.decode_step(params, model.pad_cache(cache, 24), toks[:, 16:17])
    np.testing.assert_allclose(_np32(logits_d[:, 0]), _np32(full[:, 16]), **DECODE_TOL)


@pytest.mark.parametrize("layers", [2, 8])
def test_full_width_decode_gap_is_the_references(layers):
    """zamba2-1.2b at full width, cut to a few layers, on the reference's
    parameters: (prefill 127 tokens, decode token 128) against the forward
    over 128.  Both packages part there by more than the 7e-2 that holds at
    reduced size (the chunked path's bf16 causal conv rounds every product,
    the decode step's once, and wider layers spread it further): the port's
    gap stays within 3e-2 of the reference's own.  At 2 layers the port's
    forward also holds the reference's at 3e-2."""
    jcfg = dataclasses.replace(jconfigs.get_arch("zamba2-1.2b"), num_layers=layers)
    jm = JLM.Model(jcfg)
    params = JLM.init_params(jcfg, jax.random.PRNGKey(0))
    toks = jdata.synthetic_batch(jcfg, jbase.ShapeSpec("s", 128, 1, "prefill"), 0)["tokens"]
    jt = jnp.asarray(toks)

    def forward(p, t):
        return jm._logits(p, jm._backbone(p, jm._embed_inputs(p, {"tokens": t}))[0][:, 126:])

    want = np.asarray(jax.jit(forward)(params, jt))
    _, cache = jax.jit(jm.prefill)(params, {"tokens": jt[:, :127]})
    dec_j, _ = jax.jit(jm.decode_step)(params, jm.pad_cache(cache, 129), jt[:, 127:])
    gap_j = float(np.abs(np.asarray(dec_j)[:, 0] - want[:, 1]).max())

    model = TLM.Model(dataclasses.replace(tconfigs.get_arch("zamba2-1.2b"), num_layers=layers))
    tp = convert.lm_params_from_numpy(jax.device_get(params), device="cpu")
    tt = torch.from_numpy(toks)
    x = model._backbone(tp, model._embed_inputs(tp, {"tokens": tt}))[0]
    got = model._logits(tp, x[:, 126:].to(TLM.BF16))
    _, cache_t = model.prefill(tp, {"tokens": tt[:, :127]})
    dec_t, _ = model.decode_step(tp, model.pad_cache(cache_t, 129), tt[:, 127:])
    gap_t = float((dec_t[:, 0] - got[:, 1]).abs().max())
    assert gap_t <= gap_j + 3e-2, (gap_t, gap_j)
    if layers == 2:
        np.testing.assert_allclose(_np32(got), want, **PREFILL_TOL)


# ---------------------------------------------------------------------------
# launch/serve.py
# ---------------------------------------------------------------------------


def test_serve_main_on_the_cpu(capsys):
    res = tserve.main(["--arch", "xlstm-125m", "--device", "cpu", "--gen", "4"])
    out = capsys.readouterr().out
    assert "prefill: 2x32 tokens" in out and "decode:  4 steps" in out
    assert tuple(res.tokens.shape) == (2, 5) and bool(res.finite)
    assert res.tokens.device.type == "cpu"


def test_serve_and_init_need_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tconfigs.get_arch("xlstm-125m").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.main(["--arch", "xlstm-125m"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TLM.init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TLM.Model(cfg).cache_struct(1, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.lm_params_from_numpy({"a": np.zeros(2, np.float32)})
