"""Parity of the port's LM building blocks with ``repro``: every function of
``models/layers.py``, ``models/ssm.py`` and ``models/moe.py`` on the same
inputs, made with numpy from a seed.

Tolerances: float32 attention, norms and cross-entropy 1e-5 (the same
float32 ops in another order); bf16 outputs 1 bf16 ulp (rtol 2**-7);
``chunked_gla`` / ``gla_decode_step`` 2e-4 / 1e-4 and ``causal_conv1d`` /
``conv_decode_step`` / ``slstm_scan`` 1e-5, as the reference's own tests
hold them (``tests/test_ssm_moe.py``); the MoE output 3e-3 / 1e-3 (there
too), its dispatch tables exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import one_cpu_thread  # noqa: F401  (autouse fixture)
from repro.models import layers as JL
from repro.models import moe as JM
from repro.models import ssm as JS
from repro_torch import convert
from repro_torch.models import layers as TL
from repro_torch.models import moe as TM
from repro_torch.models import ssm as TS

BF16_RTOL = 2.0 ** -7


def _np(x):
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _pair(a):
    """The same array for both packages: (jax array, torch tensor), bf16
    bits carried across exactly."""
    a = np.asarray(a)
    return jnp.asarray(a), convert._leaf(a, "cpu")


def _rand(seed, *shape, scale=1.0, dtype=np.float32):
    x = (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)
    return np.asarray(jnp.asarray(x, jnp.bfloat16)) if dtype == "bf16" else x


# ---------------------------------------------------------------------------
# layers.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rmsnorm_matches(dtype):
    xj, xt = _pair(_rand(0, 2, 7, 64, scale=3.0, dtype=dtype))
    wj, wt = _pair(_rand(1, 64, dtype=dtype))
    got, want = TL.rmsnorm(xt, wt, 1e-5), jax.jit(JL.rmsnorm)(xj, wj)
    assert got.dtype == convert._leaf(np.asarray(want), "cpu").dtype
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5 if dtype == "f32" else BF16_RTOL,
                               atol=1e-6)


@pytest.mark.parametrize("pos_shape", ["S", "BS"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rope_matches(pos_shape, dtype):
    xj, xt = _pair(_rand(2, 2, 9, 3, 16, dtype=dtype))
    pos = np.arange(9) + 5 if pos_shape == "S" else np.stack([np.arange(9), np.arange(9) * 3])
    got = TL.rope(xt, torch.from_numpy(pos), 1e4)
    want = jax.jit(lambda x, p: JL.rope(x, p, 1e4))(xj, jnp.asarray(pos))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5 if dtype == "f32" else BF16_RTOL,
                               atol=1e-5)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_silu_and_swiglu_match(dtype):
    xj, xt = _pair(_rand(3, 4, 32, scale=3.0, dtype=dtype))
    ws = [_pair(_rand(4 + i, *s, scale=0.2, dtype=dtype))
          for i, s in enumerate([(32, 48), (32, 48), (48, 32)])]
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == "f32" else dict(rtol=BF16_RTOL, atol=1e-2)
    np.testing.assert_allclose(_np(TL.silu(xt)), _np(jax.jit(jax.nn.silu)(xj)), **tol)
    got = TL.swiglu(xt, *(w[1] for w in ws))
    want = jax.jit(JL.swiglu)(xj, *(w[0] for w in ws))
    np.testing.assert_allclose(_np(got), _np(want), **tol)


@pytest.mark.parametrize("causal,window,t,kv_chunk,heads,q_offset", [
    (True, 0, 16, 4, (4, 4), 0),
    (True, 5, 16, 4, (4, 2), 0),        # sliding window, GQA
    (False, 0, 20, 8, (4, 1), 0),       # padded KV (20 = 2 chunks of 8 + 4), MQA
    (False, 0, 7, 16, (2, 2), 0),       # one chunk shorter than kv_chunk
    (True, 3, 16, 16, (6, 3), 4),       # q_offset shifts the causal mask
], ids=["causal", "window-gqa", "padded-kv", "short-kv", "offset"])
def test_blockwise_attention_matches(causal, window, t, kv_chunk, heads, q_offset):
    h, kv = heads
    s = t if q_offset == 0 else 8
    qj, qt = _pair(_rand(10, 2, s, h, 16))
    kj, kt = _pair(_rand(11, 2, t, kv, 16))
    vj, vt = _pair(_rand(12, 2, t, kv, 16))
    kw = dict(causal=causal, window=window, q_offset=q_offset, kv_chunk=kv_chunk)
    got = TL.blockwise_attention(qt, kt, vt, **kw)
    want = jax.jit(lambda q, k, v: JL.blockwise_attention(q, k, v, **kw))(qj, kj, vj)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("window,heads,as_tensor", [
    (0, (4, 4), True), (0, (4, 2), False), (6, (4, 2), True), (6, (2, 1), False)])
def test_decode_attention_matches(window, heads, as_tensor):
    h, kv = heads
    qj, qt = _pair(_rand(20, 2, 1, h, 16))
    kj, kt = _pair(_rand(21, 2, 12, kv, 16))
    vj, vt = _pair(_rand(22, 2, 12, kv, 16))
    clen = torch.tensor(9, dtype=torch.int32) if as_tensor else 9
    got = TL.decode_attention(qt, kt, vt, clen, window=window)
    want = JL.decode_attention(qj, kj, vj, jnp.asarray(9, jnp.int32), window=window)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("s,chunk", [(16, 512), (20, 8), (24, 8)])
def test_cross_entropy_matches(s, chunk):
    r = np.random.default_rng(30)
    logits = r.normal(size=(2, s, 50)).astype(np.float32) * 3
    labels = r.integers(0, 50, size=(2, s)).astype(np.int32)
    got = TL.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    want = JL.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    x = r.normal(size=(2, s, 24)).astype(np.float32)
    head = r.normal(size=(24, 50)).astype(np.float32) * 0.3
    mask = (r.uniform(size=(2, s)) > 0.2).astype(np.float32)
    got = TL.chunked_cross_entropy(*(torch.from_numpy(a) for a in (x, head, labels, mask)),
                                   chunk=chunk)
    want = JL.chunked_cross_entropy(*(jnp.asarray(a) for a in (x, head, labels, mask)),
                                    chunk=chunk)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


# ---------------------------------------------------------------------------
# ssm.py
# ---------------------------------------------------------------------------


def _gla_inputs(seed, b, s, h, dk, dv):
    r = np.random.default_rng(seed)
    q, k = (r.normal(size=(b, s, h, dk)).astype(np.float32) for _ in range(2))
    v = r.normal(size=(b, s, h, dv)).astype(np.float32)
    a = -np.log1p(np.exp(r.normal(size=(b, s, h)))).astype(np.float32)
    return q, k, v, a


@pytest.mark.parametrize("s,chunk,with_state", [
    (8, 4, False), (16, 16, False), (32, 8, False), (24, 8, True)])
def test_chunked_gla_matches(s, chunk, with_state):
    arrs = _gla_inputs(40, 2, s, 3, 5, 7)
    st = np.random.default_rng(41).normal(size=(2, 3, 5, 7)).astype(np.float32) \
        if with_state else None
    got_y, got_s = TS.chunked_gla(*(torch.from_numpy(a) for a in arrs),
                                  state=None if st is None else torch.from_numpy(st),
                                  chunk=chunk)
    want_y, want_s = JS.chunked_gla(*(jnp.asarray(a) for a in arrs),
                                    state=None if st is None else jnp.asarray(st),
                                    chunk=chunk)
    np.testing.assert_allclose(_np(got_y), _np(want_y), atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(_np(got_s), _np(want_s), atol=2e-4, rtol=1e-4)


def test_chunked_gla_needs_whole_chunks():
    arrs = _gla_inputs(42, 1, 12, 1, 2, 2)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        TS.chunked_gla(*(torch.from_numpy(a) for a in arrs), chunk=8)


def test_gla_decode_step_matches_and_continues():
    """The port's decode steps after its chunked prefix equal the
    reference's steps, and its own chunked pass over the whole sequence."""
    q, k, v, a = _gla_inputs(43, 1, 12, 2, 4, 4)
    t = lambda x: torch.from_numpy(x)
    full, _ = TS.chunked_gla(t(q), t(k), t(v), t(a), chunk=4)
    _, st_t = TS.chunked_gla(t(q[:, :8]), t(k[:, :8]), t(v[:, :8]), t(a[:, :8]), chunk=4)
    _, st_j = JS.chunked_gla(*(jnp.asarray(x[:, :8]) for x in (q, k, v, a)), chunk=4)
    for i in range(8, 12):
        y_t, st_t = TS.gla_decode_step(t(q[:, i]), t(k[:, i]), t(v[:, i]), t(a[:, i]), st_t)
        y_j, st_j = JS.gla_decode_step(*(jnp.asarray(x[:, i]) for x in (q, k, v, a)), st_j)
        np.testing.assert_allclose(_np(y_t), _np(y_j), atol=2e-4, rtol=1e-4)
        np.testing.assert_allclose(_np(y_t), _np(full[:, i]), atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(_np(st_t), _np(st_j), atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_causal_conv_and_decode_match(dtype):
    xj, xt = _pair(_rand(50, 2, 10, 6, dtype=dtype))
    wj, wt = _pair(_rand(51, 4, 6, dtype=dtype))
    tol = dict(atol=1e-5) if dtype == "f32" else dict(atol=1e-5, rtol=BF16_RTOL)
    full_t = TS.causal_conv1d(xt, wt)
    np.testing.assert_allclose(_np(full_t), _np(jax.jit(JS.causal_conv1d)(xj, wj)), **tol)
    st_t = torch.zeros((2, 3, 6), dtype=xt.dtype)
    st_j = jnp.zeros((2, 3, 6), xj.dtype)
    for i in range(10):
        y_t, st_t = TS.conv_decode_step(xt[:, i], st_t, wt)
        y_j, st_j = JS.conv_decode_step(xj[:, i], st_j, wj)
        np.testing.assert_allclose(_np(y_t), _np(y_j), **tol)
        if dtype == "f32":  # bf16: a sum of rounded products against one rounding
            np.testing.assert_allclose(_np(y_t), _np(full_t[:, i]), **tol)


def test_slstm_scan_matches_and_continues():
    gates = _rand(60, 2, 16, 2, 8, 4, scale=2.0)
    r = _rand(61, 4, 2, 8, 8, scale=0.2)
    y_t, st_t = TS.slstm_scan(torch.from_numpy(gates), torch.from_numpy(r))
    y_j, st_j = JS.slstm_scan(jnp.asarray(gates), jnp.asarray(r))
    np.testing.assert_allclose(_np(y_t), _np(y_j), atol=1e-5)
    for a, b in zip(st_t, st_j):
        np.testing.assert_allclose(_np(a), _np(b), atol=1e-5)
    y1, s1 = TS.slstm_scan(torch.from_numpy(gates[:, :8]), torch.from_numpy(r))
    y2, _ = TS.slstm_scan(torch.from_numpy(gates[:, 8:]), torch.from_numpy(r), init=s1)
    np.testing.assert_allclose(_np(torch.cat([y1, y2], 1)), _np(y_t), atol=1e-5)


# ---------------------------------------------------------------------------
# moe.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s,e,k,f", [(32, 8, 2, 1.25), (1, 8, 2, 1.25), (32, 128, 8, 1.25),
                                     (7, 4, 2, 0.05), (16, 8, 2, 8.0)])
def test_moe_capacity_matches(s, e, k, f):
    assert TM.moe_capacity(s, e, k, f) == JM.moe_capacity(s, e, k, f)


@pytest.mark.parametrize("sk,e,cap", [(64, 8, 16), (64, 8, 3), (30, 4, 1), (16, 16, 4)],
                         ids=["room", "drops", "capacity-1", "sparse"])
def test_dispatch_tables_equal(sk, e, cap):
    """``_dispatch_row`` exactly, per row and for a batch of rows at once,
    dropped assignments included."""
    ids = np.random.default_rng(70).integers(0, e, size=(3, sk)).astype(np.int64)
    gw = np.ones((3, sk), np.float32)
    got = TM._dispatch_row(torch.from_numpy(ids), None, e, cap)
    for row in range(3):
        want = np.asarray(JM._dispatch_row(jnp.asarray(ids[row], jnp.int32),
                                           jnp.asarray(gw[row]), e, cap))
        np.testing.assert_array_equal(got[row].numpy(), want)
        np.testing.assert_array_equal(
            TM._dispatch_row(torch.from_numpy(ids[row]), None, e, cap).numpy(), want)


def test_top_k_orders_ties_as_lax():
    probs = np.array([[0.2, 0.3, 0.2, 0.3], [0.25, 0.25, 0.25, 0.25],
                      [0.1, 0.4, 0.4, 0.1]], np.float32)
    v_t, i_t = TM._top_k(torch.from_numpy(probs), 3)
    v_j, i_j = jax.lax.top_k(jnp.asarray(probs), 3)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))


def _moe_inputs(seed, b, s, d, e, f):
    r = np.random.default_rng(seed)
    return (r.normal(size=(b, s, d)).astype(np.float32) * 0.5,
            r.normal(size=(d, e)).astype(np.float32),
            *(r.normal(size=sh).astype(np.float32) * 0.2
              for sh in [(e, d, f), (e, d, f), (e, f, d)]))


@pytest.mark.parametrize("s,e,k,factor", [
    (16, 4, 2, 4.0), (32, 8, 2, 8.0), (8, 8, 4, 8.0),     # no drops
    (32, 8, 2, 1.0), (32, 4, 2, 0.05)],                   # drops at capacity
    ids=["16-4-2", "32-8-2", "8-8-4", "drops-1.0", "drops-0.05"])
def test_moe_ffn_matches(s, e, k, factor):
    arrs = _moe_inputs(80, 2, s, 16, e, 24)
    got, aux_t = TM.moe_ffn(*(torch.from_numpy(a) for a in arrs), k, factor)
    want, aux_j = JM.moe_ffn(*(jnp.asarray(a) for a in arrs), k, capacity_factor=factor)
    np.testing.assert_allclose(_np(got), _np(want), atol=3e-3, rtol=1e-3)
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-5)
