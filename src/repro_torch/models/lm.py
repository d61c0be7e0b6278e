"""Unified LM model covering all 10 assigned architectures.

The port of ``repro.models.lm``: serving (prefill and ring-cache decode)
and training (``loss_fn`` under autograd, with the reference's remat as
``torch.utils.checkpoint``, see :func:`scan_group`).  A model is a
sequence of **block groups**; each group is either a stack of identical
layers (params stacked on a leading L dim, as in the
reference, so both packages hold the same tree) or a single block (zamba2's
*shared* attention block, stored once and applied at several depths; each
application has its own KV-cache slot).

Group kinds:
  dense      pre-norm GQA attention + SwiGLU  (llama3 / phi4 / danube /
             gemma3 local:global via per-layer windows / mistral-llava)
  moe        GQA attention + top-k expert FFN (qwen3)
  mamba      Mamba2 SSD block (chunked GLA)
  shared_attn  one attention+MLP block with shared params (zamba2)
  mlstm      xLSTM matrix-memory block (chunked GLA + denominator)
  slstm      xLSTM scalar-memory block (sequential scan)
  enc_dense  non-causal encoder layer (whisper)
  dec_cross  causal self-attn + cross-attn + MLP (whisper decoder)

Parameters and caches are dicts of tensors whose keys and stacked shapes
are the reference's; the functions take them explicitly
(``Model(cfg).prefill(params, batch)``), and run on the device their
inputs are on.

On local shards (``models/sharded.py``, ``distributed/local.py``) the
attention runs this rank's heads where ``wq`` holds only those (the keys
and values its KV heads, or all of them where ``wk`` is whole), the SwiGLU
its FFN columns and the MoE its experts; each ends in a sum over "model"
of float32 partials, rounded once.  The other blocks run whole on every
rank.  A block's branch follows from the shapes of the weights it is
given, so plain tensors take the plain path.  A decode step whose caches
hold this rank's block of their slots (``local.kv_slots``: sequence
parallelism) attends with every query head over that block and combines
the ranks' partial softmaxes.

Decode caches are fixed-size rings: slot = pos % T, valid length
min(pos+1, T). ``cache["len"]`` is a () int32 tensor on the cache's device
and every ring write takes its slot as a tensor index, so a decode step
reads nothing back from the device.  ``decode_step`` writes the new token's
keys and values and the recurrent states into the cache it is given, in
place, and returns the cache with ``len`` advanced: the cache passed in is
consumed.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch._device import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import ctx, local
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (
    at_least,
    blockwise_attention,
    checkpointed,
    chunked_cross_entropy,
    decode_attention,
    rmsnorm,
    rope,
    silu,
    swiglu,
)

CONV_K = 4  # mamba depthwise conv width
MAMBA_HD = 64
BF16 = torch.bfloat16


class Group(NamedTuple):
    kind: str
    key: str    # params dict key (zamba2's shared block repeats one key)
    ckey: str   # cache dict key (unique per group instance)
    layers: int
    meta: dict


def plan_groups(cfg: ArchConfig) -> List[Group]:
    f = cfg.family
    if f in ("dense", "vlm", "moe"):
        if cfg.local_global_ratio:
            r = cfg.local_global_ratio
            windows = tuple(
                0 if (l % (r + 1)) == r else cfg.sliding_window
                for l in range(cfg.num_layers)
            )
        else:
            windows = (cfg.sliding_window,) * cfg.num_layers
        kind = "moe" if f == "moe" else "dense"
        return [Group(kind, "layers", "layers", cfg.num_layers, {"windows": windows})]
    if f == "hybrid":
        groups: List[Group] = []
        remaining, i = cfg.num_layers, 0
        while remaining > 0:
            g = min(cfg.attn_every, remaining)
            groups.append(Group("mamba", f"mamba{i}", f"mamba{i}", g, {}))
            remaining -= g
            if remaining > 0:
                groups.append(Group("shared_attn", "shared", f"shared{i}", 1,
                                    {"window": cfg.sliding_window}))
            i += 1
        return groups
    if f == "ssm":  # xlstm
        groups, rep, l = [], 0, 0
        while l < cfg.num_layers:
            run = min(cfg.slstm_every - 1, cfg.num_layers - l)
            if run > 0:
                groups.append(Group("mlstm", f"mlstm{rep}", f"mlstm{rep}", run, {}))
                l += run
            if l < cfg.num_layers:
                groups.append(Group("slstm", f"slstm{rep}", f"slstm{rep}", 1, {}))
                l += 1
            rep += 1
        return groups
    if f == "encdec":
        return [
            Group("enc_dense", "encoder", "encoder", cfg.encoder_layers, {}),
            Group("dec_cross", "decoder", "decoder", cfg.num_layers, {}),
        ]
    raise ValueError(f"unknown family {f}")


# --------------------------------------------------------------------------
# Parameter init: the reference's shapes, dtypes and scales, drawn from an
# explicit torch.Generator (the bits cannot match jax.random's).  ``lead``
# is (L,) for a stacked group and () for a single block.
# --------------------------------------------------------------------------

class _Draw:
    def __init__(self, gen: torch.Generator, dev: torch.device, lead: tuple):
        self.gen, self.dev, self.lead = gen, dev, lead

    def normal(self, shape, scale, dtype=BF16) -> torch.Tensor:
        x = torch.randn(self.lead + tuple(shape), generator=self.gen, device=self.dev)
        return (x * scale).to(dtype)

    def full(self, shape, value, dtype=BF16) -> torch.Tensor:
        return torch.full(self.lead + tuple(shape), value, dtype=dtype, device=self.dev)


def _dense_layer_init(draw: _Draw, cfg: ArchConfig, cross: bool = False):
    d, hd = cfg.d_model, cfg.head_dim_
    h, kv = cfg.num_heads, cfg.num_kv_heads
    sc = d ** -0.5
    p = {
        "ln1": draw.full((d,), 1.0),
        "wq": draw.normal((d, h * hd), sc),
        "wk": draw.normal((d, kv * hd), sc),
        "wv": draw.normal((d, kv * hd), sc),
        "wo": draw.normal((h * hd, d), (h * hd) ** -0.5),
        "ln2": draw.full((d,), 1.0),
    }
    if cross:
        p.update({
            "lnx": draw.full((d,), 1.0),
            "xwq": draw.normal((d, h * hd), sc),
            "xwk": draw.normal((d, kv * hd), sc),
            "xwv": draw.normal((d, kv * hd), sc),
            "xwo": draw.normal((h * hd, d), (h * hd) ** -0.5),
        })
    if cfg.family == "moe":
        e, ff = cfg.num_experts, cfg.d_ff
        p.update({
            "router": draw.normal((d, e), sc, torch.float32),
            "wg": draw.normal((e, d, ff), sc),
            "wu": draw.normal((e, d, ff), sc),
            "wd": draw.normal((e, ff, d), ff ** -0.5),
        })
    else:
        ff = cfg.d_ff if cfg.d_ff else 4 * d
        p.update({
            "wg": draw.normal((d, ff), sc),
            "wu": draw.normal((d, ff), sc),
            "wd": draw.normal((ff, d), ff ** -0.5),
        })
    return p


def _mamba_layer_init(draw: _Draw, cfg: ArchConfig):
    d = cfg.d_model
    d_in = 2 * d
    ds = cfg.ssm_state
    h = d_in // MAMBA_HD
    conv_ch = d_in + 2 * ds
    return {
        "ln": draw.full((d,), 1.0),
        "w_in": draw.normal((d, 2 * d_in + 2 * ds + h), d ** -0.5),
        "conv_w": draw.normal((CONV_K, conv_ch), 0.5),
        "dt_bias": draw.full((h,), 0.0, torch.float32),
        "d_skip": draw.full((h,), 1.0, torch.float32),
        "w_out": draw.normal((d_in, d), d_in ** -0.5),
    }


def _mlstm_layer_init(draw: _Draw, cfg: ArchConfig):
    d = cfg.d_model
    di = 2 * d
    h = cfg.num_heads
    return {
        "ln": draw.full((d,), 1.0),
        "w_up": draw.normal((d, 2 * di), d ** -0.5),
        "wq": draw.normal((di, di), di ** -0.5),
        "wk": draw.normal((di, di), di ** -0.5),
        "wv": draw.normal((di, di), di ** -0.5),
        "w_gates": draw.normal((di, 2 * h), di ** -0.5),
        "w_down": draw.normal((di, d), di ** -0.5),
    }


def _slstm_layer_init(draw: _Draw, cfg: ArchConfig):
    d = cfg.d_model
    h = cfg.num_heads
    hd = d // h
    return {
        "ln": draw.full((d,), 1.0),
        "w_gates": draw.normal((d, h * hd * 4), d ** -0.5),
        "r_kernels": draw.normal((4, h, hd, hd), hd ** -0.5),
        "w_out": draw.normal((d, d), d ** -0.5),
    }


_LAYER_INIT = {
    "dense": _dense_layer_init,
    "moe": _dense_layer_init,
    "enc_dense": _dense_layer_init,
    "shared_attn": _dense_layer_init,
    "mamba": _mamba_layer_init,
    "mlstm": _mlstm_layer_init,
    "slstm": _slstm_layer_init,
}


def init_params(cfg: ArchConfig, generator: torch.Generator, device=None) -> Dict[str, Any]:
    """Random parameters with the reference's tree, shapes, dtypes and
    scales, drawn from ``generator``, which must live on ``device`` (the
    card unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    d, v = cfg.d_model, cfg.vocab_size
    top = _Draw(generator, dev, ())
    params: Dict[str, Any] = {
        "embed": top.normal((v, d), d ** -0.5),
        "final_ln": top.full((d,), 1.0),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = top.normal((d, v), d ** -0.5)

    for g in plan_groups(cfg):
        if g.key in params:
            continue  # shared block already created
        draw = _Draw(generator, dev, (g.layers,) if g.layers > 1 else ())
        if g.kind == "dec_cross":
            params[g.key] = _dense_layer_init(draw, cfg, cross=True)
        else:
            params[g.key] = _LAYER_INIT[g.kind](draw, cfg)
    return params


# --------------------------------------------------------------------------
# Block applies (sequence mode)
# --------------------------------------------------------------------------

# The residual stream is bf16, as in the reference, but the reference's
# compiled blocks read a residual sum before it is rounded wherever the next
# op takes it to float32 (the RMSNorm that follows), and round it where a
# bf16 op reads it or where it is stored (a layer boundary).  The port keeps
# a block's residual sum in float32 and rounds it at the same points:
# ``_residual`` adds onto the rounded stream, ``_norm`` normalizes what it is
# given, and the layer loops round their carry (the decode stacks their
# first carry too, the prefill's loops not: each as the reference computes,
# measured against it at reduced size).  On bf16 inputs this is the
# plain bf16 computation with one rounding moved; rounding every sum instead
# moves the logits at reduced size by up to ~2x the tolerance against the
# reference.

def _residual(x, delta) -> torch.Tensor:
    """x + delta: the float32 sum of the rounded stream and the block's
    output."""
    return x.to(BF16).float() + delta.float()


def _norm(x, w, cfg: ArchConfig) -> torch.Tensor:
    """RMSNorm of the (bf16 or unrounded float32) stream, in bf16."""
    return rmsnorm(x, w, cfg.norm_eps).to(BF16)


def _row_parallel(y, w) -> torch.Tensor:
    """``y @ w`` where ``w`` holds this rank's rows: float32 partial
    products summed over "model", rounded once to ``y``'s dtype."""
    return local.leave(y.float() @ w.float()).to(y.dtype)


def _q_proj(xn, wq, cfg: ArchConfig):
    """(queries (B, S, heads, hd), the input they were made from): all heads,
    or this rank's where ``wq`` holds only those."""
    b, s, _ = xn.shape
    hd = cfg.head_dim_
    hl = wq.shape[-1] // hd
    xt = xn if hl == cfg.num_heads else local.enter(xn)
    return (xt @ wq).reshape(b, s, hl, hd), xt


def _kv_pick(wq, wk, cfg: ArchConfig):
    """The slice of KV heads this rank's query heads read, where the queries
    are split over "model" and ``wk`` is whole; else None."""
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    if wq.shape[-1] == h * hd or wk.shape[-1] != kv * hd:
        return None
    lo, hi = local.local_block(h)
    return slice(lo * kv // h, (hi - 1) * kv // h + 1)


def _pick(k, sel):
    """(B, T, KV, hd) keys or values: the heads ``sel`` (all for None)."""
    return k if sel is None else local.enter(k)[:, :, sel]


def _qkv(xn, mem, p, cfg: ArchConfig, pre: str = ""):
    """q from ``xn`` (B, S, d), k and v from ``mem`` (B, T, d) (``xn`` itself
    in self-attention), and the KV heads the queries read (:func:`_kv_pick`)."""
    b, t = mem.shape[:2]
    hd = cfg.head_dim_
    wq, wk, wv = p[pre + "wq"], p[pre + "wk"], p[pre + "wv"]
    q, xt = _q_proj(xn, wq, cfg)
    kl = wk.shape[-1] // hd
    if kl != cfg.num_kv_heads:          # this rank's KV heads
        mem = xt if mem is xn else local.enter(mem)
    k = (mem @ wk).reshape(b, t, kl, hd)
    v = (mem @ wv).reshape(b, t, kl, hd)
    return q, k, v, _kv_pick(wq, wk, cfg)


def _out(o, w, cfg: ArchConfig) -> torch.Tensor:
    """(B, S, heads, hd) attention outputs through the output projection."""
    b, s, hl, hd = o.shape
    o = o.reshape(b, s, hl * hd)
    return o @ w if hl == cfg.num_heads else _row_parallel(o, w)


def _attn_seq(x, p, cfg: ArchConfig, window: int, kv_chunk, causal=True):
    s = x.shape[1]
    xn = _norm(x, p["ln1"], cfg)
    q, k, v, sel = _qkv(xn, xn, p, cfg)
    pos = torch.arange(s, device=x.device)
    q = rope(q, pos, cfg.rope_theta)
    k = rope(k, pos, cfg.rope_theta)
    o = blockwise_attention(q, _pick(k, sel), _pick(v, sel), causal=causal, window=window,
                            kv_chunk=kv_chunk)
    return _residual(x, _out(o, p["wo"], cfg)), (k, v)


def _mlp_seq(x, p, cfg: ArchConfig):
    xn = _norm(x, p["ln2"], cfg)
    if p["wg"].shape[-1] == (cfg.d_ff or 4 * cfg.d_model):
        return _residual(x, swiglu(xn, p["wg"], p["wu"], p["wd"]))
    xt = local.enter(xn)                # this rank's FFN columns
    return _residual(x, _row_parallel(silu(xt @ p["wg"]) * (xt @ p["wu"]), p["wd"]))


def _moe_seq(x, p, cfg: ArchConfig):
    xn = _norm(x, p["ln2"], cfg)
    out, aux = moe_lib.moe_ffn(xn, p["router"], p["wg"], p["wu"], p["wd"],
                               cfg.top_k, cfg.moe_capacity_factor)
    return _residual(x, out), aux


def _mamba_split(proj, d_in, ds):
    # jnp.split takes indices, as torch.tensor_split does (torch.split takes sizes)
    return torch.tensor_split(proj, [d_in, 2 * d_in, 2 * d_in + ds, 2 * d_in + 2 * ds], dim=-1)


def _mamba_seq(x, p, cfg: ArchConfig):
    b, s, d = x.shape
    d_in, ds = 2 * d, cfg.ssm_state
    h = d_in // MAMBA_HD
    xn = _norm(x, p["ln"], cfg)
    z, xv, bb, cc, dt = _mamba_split(xn @ p["w_in"], d_in, ds)
    conv_in = torch.cat([xv, bb, cc], dim=-1)
    conv_out = silu(ssm_lib.causal_conv1d(conv_in, p["conv_w"]))
    xv, bb, cc = torch.tensor_split(conv_out, [d_in, d_in + ds], dim=-1)
    # jax.nn.softplus is logaddexp(x, 0); F.softplus returns x above its
    # threshold of 20, which is the same float32 value there
    log_decay = -F.softplus(dt.float() + p["dt_bias"])  # (B,S,H)
    q = cc[:, :, None, :].expand(b, s, h, ds)
    k = bb[:, :, None, :].expand(b, s, h, ds)
    vv = xv.reshape(b, s, h, MAMBA_HD)
    y, state = ssm_lib.chunked_gla(q, k, vv, log_decay, chunk=min(256, s))
    y = y + p["d_skip"][None, None, :, None] * vv.float()
    y = y.reshape(b, s, d_in).to(BF16) * silu(z)
    conv_tail = conv_in[:, -(CONV_K - 1):, :]
    return _residual(x, y @ p["w_out"]), (state, conv_tail)


def _mlstm_seq(x, p, cfg: ArchConfig):
    b, s, d = x.shape
    di = 2 * d
    h = cfg.num_heads
    hd = di // h
    xn = _norm(x, p["ln"], cfg)
    xm, z = torch.chunk(xn @ p["w_up"], 2, dim=-1)
    q = (xm @ p["wq"]).reshape(b, s, h, hd) * hd ** -0.5
    k = (xm @ p["wk"]).reshape(b, s, h, hd) * hd ** -0.5
    v = (xm @ p["wv"]).reshape(b, s, h, hd)
    gates = (xm @ p["w_gates"]).float().reshape(b, s, h, 2)
    log_f = F.logsigmoid(gates[..., 0])
    i_gate = torch.sigmoid(gates[..., 1])  # bounded input gate (chunk-stable)
    # unrounded, as the reference's GLA reads this product (see _residual)
    k = k.float() * i_gate[..., None].to(BF16).float()
    # Fused numerator+denominator: v with a ones column, so one GLA pass
    # gives both C_t q (first hd cols) and n_t q (last col).
    v_aug = torch.cat([v, torch.ones(v.shape[:-1] + (1,), dtype=v.dtype, device=v.device)], -1)
    out, st = ssm_lib.chunked_gla(q, k, v_aug, log_f, chunk=min(256, s))
    num, den = out[..., :hd], out[..., hd:]
    y = num / at_least(torch.abs(den), 1.0)
    y = y.reshape(b, s, di).to(BF16) * silu(z)
    return _residual(x, y @ p["w_down"]), st


def _slstm_seq(x, p, cfg: ArchConfig):
    b, s, d = x.shape
    h = cfg.num_heads
    hd = d // h
    xn = _norm(x, p["ln"], cfg)
    gates = (xn @ p["w_gates"]).reshape(b, s, h, hd, 4)
    y, state = ssm_lib.slstm_scan(gates, p["r_kernels"])
    y = y.reshape(b, s, d).to(BF16)
    return _residual(x, y @ p["w_out"]), state


def _cross_seq(x, p, memory, cfg: ArchConfig, kv_chunk):
    xn = _norm(x, p["lnx"], cfg)
    q, k, v, sel = _qkv(xn, memory, p, cfg, "x")
    o = blockwise_attention(q, _pick(k, sel), _pick(v, sel), causal=False, window=0,
                            kv_chunk=kv_chunk)
    return _residual(x, _out(o, p["xwo"], cfg)), (k, v)


# --------------------------------------------------------------------------
# Stacked groups
# --------------------------------------------------------------------------

def _layer(stacked: Dict[str, torch.Tensor], l: int) -> Dict[str, torch.Tensor]:
    return {k: v[l] for k, v in stacked.items()}


def _stack(ys: list):
    """Stack per-layer outputs (None, tensors or tuples of them) on a new
    leading L axis, as ``lax.scan`` stacks its outputs."""
    if ys[0] is None:
        return None
    if isinstance(ys[0], tuple):
        return tuple(_stack([y[i] for y in ys]) for i in range(len(ys[0])))
    return torch.stack(ys)


def _remat_group_size(n: int) -> int:
    """Largest divisor of n <= ~1.5*sqrt(n) (sqrt-memory double remat)."""
    target = max(int(math.sqrt(n) * 1.5), 1)
    best = 1
    for g in range(1, n + 1):
        if n % g == 0 and g <= target:
            best = g
    return best


def _remat_on(remat) -> bool:
    return bool(remat) and remat != "none"


def _unstack(stacked: Dict[str, torch.Tensor], layers: int) -> list:
    """Per-layer views of a stacked group, one ``unbind`` per leaf: its
    backward stacks the layers' gradients once, where indexing each layer
    would add a zero-filled full-size gradient per layer."""
    cols = {k: v.unbind(0) for k, v in stacked.items()}
    return [{k: c[l] for k, c in cols.items()} for l in range(layers)]


def scan_group(x, stacked, body, layers: int, remat, extra_xs=None):
    """Apply ``body(x, layer_params, extra) -> (x, y)`` over the stacked
    layers in order; returns x and the ys stacked on a leading L axis.

    remat, as the reference's: "none" keeps every layer's activations for
    the backward; "group" checkpoints groups of ``_remat_group_size(L)``
    layers; "block" (the default) also checkpoints each layer inside its
    group, so a backward holds the group boundaries, one group's layer
    boundaries and one layer's activations.  With a single group both
    checkpoint each layer.  Values are the same in every mode."""
    use_remat = _remat_on(remat)
    if extra_xs is None:
        extra_xs = (0,) * layers
    if layers == 1:
        return body(x, stacked, extra_xs[0])
    per_layer = _unstack(stacked, layers)

    def step(xc, l):
        xc, y = body(ctx.constrain_batch(xc), per_layer[l], extra_xs[l])
        return xc.to(BF16), y  # the layer boundary: a carry, stored rounded

    def run(xc, lo, hi, layer_step):
        ys = []
        for l in range(lo, hi):
            xc, y = layer_step(xc, l)
            ys.append(y)
        return xc, ys

    def checkpointed_step(xc, l):
        return checkpointed(step, xc, l)

    g = _remat_group_size(layers) if use_remat else layers
    n_outer = layers // g
    if not use_remat or n_outer <= 1:
        x, ys = run(x, 0, layers, checkpointed_step if use_remat else step)
        return x, _stack(ys)
    layer_step = step if remat == "group" else checkpointed_step
    ys = []
    for o in range(n_outer):
        x, yo = checkpointed(run, x, o * g, (o + 1) * g, layer_step)
        ys += yo
    return x, _stack(ys)


# --------------------------------------------------------------------------
# Decode building blocks: each writes its layer's cache slice in place.
# --------------------------------------------------------------------------

def _attn_step(x, p, k_cache, v_cache, pos, window, cfg: ArchConfig):
    """One-token attention against a ring cache. x (B,1,d); pos a () int32
    tensor. Writes the token's k and v into slot pos % T of the caches.

    Where the caches hold this rank's block of their slots
    (``local.kv_slots``), the step attends with every query head over that
    block and combines the ranks' parts; the slot's holder writes it."""
    b = x.shape[0]
    tl = k_cache.shape[1]
    lo, t = local.kv_slots("k", tl)
    xn = _norm(x, p["ln1"], cfg)
    q, k, v, sel = _qkv(xn, xn, p, cfg)
    posv = pos.expand(b, 1)
    q = rope(q, posv, cfg.rope_theta)
    k = rope(k, posv, cfg.rope_theta)
    slot = torch.remainder(pos, t).long().reshape(1)
    eff_len = torch.clamp(pos + 1, max=t)
    # Linear (full-length) caches apply the sliding-window mask; ring caches
    # (t <= window, e.g. zamba2 at 500k) ARE the window — no mask needed.
    if t == tl:
        k_cache.index_copy_(1, slot, k.to(k_cache.dtype))
        v_cache.index_copy_(1, slot, v.to(v_cache.dtype))
        o = decode_attention(q, _pick(k_cache, sel), _pick(v_cache, sel), eff_len, window=window)
    else:
        hl = q.shape[2]
        for cache, new in ((k_cache, k), (v_cache, v)):
            _write_held(cache, slot - lo, local.model_gather(new, 2, cfg.num_kv_heads))
        o = decode_attention(local.model_gather(q, 2, cfg.num_heads), k_cache, v_cache, eff_len,
                             window=window, first_slot=lo, reduce=local.model_reduce)
        o = local.own_block(o, 2, hl)
    return _residual(x, _out(o, p["wo"], cfg))


def _write_held(cache, idx, new):
    """``cache[:, idx] = new`` where this rank holds slot ``idx`` of its block
    (0 <= idx < its slots; a (1,) device index, read by no host)."""
    held = (idx >= 0) & (idx < cache.shape[1])
    i = idx.clamp(0, cache.shape[1] - 1)
    cache.index_copy_(1, i, torch.where(held, new.to(cache.dtype), cache.index_select(1, i)))


def _decode_attn_stack(x, p, cache, pos, windows, cfg: ArchConfig, moe: bool):
    for l, w in enumerate(windows):
        lp = _layer(p, l)
        x = _attn_step(x, lp, cache["k"][l], cache["v"][l], pos, w, cfg)
        if moe:
            x, _ = _moe_seq(x, lp, cfg)
        else:
            x = _mlp_seq(x, lp, cfg)
        x = x.to(BF16)
    return x, cache


def _decode_mamba_stack(x, p, cache, cfg: ArchConfig):
    b, _, d = x.shape
    d_in, ds = 2 * d, cfg.ssm_state
    h = d_in // MAMBA_HD
    x = x.to(BF16)  # the loop's first carry too (the prefill's takes it as given)
    for l in range(cache["state"].shape[0]):
        lp = _layer(p, l)
        xn = _norm(x, lp["ln"], cfg)[:, 0, :]           # (B,d)
        z, xv, bb, cc, dt = _mamba_split(xn @ lp["w_in"], d_in, ds)
        conv_in = torch.cat([xv, bb, cc], dim=-1)                  # (B,C)
        conv_out, conv_st = ssm_lib.conv_decode_step(conv_in, cache["conv"][l], lp["conv_w"])
        conv_out = silu(conv_out)
        xv, bb, cc = torch.tensor_split(conv_out, [d_in, d_in + ds], dim=-1)
        log_decay = -F.softplus(dt.float() + lp["dt_bias"])
        q = cc[:, None, :].expand(b, h, ds)
        k = bb[:, None, :].expand(b, h, ds)
        vv = xv.reshape(b, h, MAMBA_HD)
        y, st = ssm_lib.gla_decode_step(q, k, vv, log_decay, cache["state"][l])
        y = y + lp["d_skip"][None, :, None] * vv.float()
        y = y.reshape(b, d_in).to(BF16) * silu(z)
        x = _residual(x, (y @ lp["w_out"])[:, None, :]).to(BF16)
        cache["state"][l].copy_(st)
        cache["conv"][l].copy_(conv_st)
    return x, cache


def _decode_mlstm_stack(x, p, cache, cfg: ArchConfig):
    b, _, d = x.shape
    di = 2 * d
    h = cfg.num_heads
    hd = di // h
    x = x.to(BF16)  # the loop's first carry too (the prefill's takes it as given)
    for l in range(cache["state"].shape[0]):
        lp = _layer(p, l)
        xn = _norm(x, lp["ln"], cfg)[:, 0, :]
        xm, z = torch.chunk(xn @ lp["w_up"], 2, dim=-1)
        q = (xm @ lp["wq"]).reshape(b, h, hd) * hd ** -0.5
        k = (xm @ lp["wk"]).reshape(b, h, hd) * hd ** -0.5
        v = (xm @ lp["wv"]).reshape(b, h, hd)
        # a float32 product, as the reference's one-row step computes it
        gates = (xm.float() @ lp["w_gates"].float()).reshape(b, h, 2)
        log_f = F.logsigmoid(gates[..., 0])
        k = k.float() * torch.sigmoid(gates[..., 1])[..., None].to(BF16).float()
        v_aug = torch.cat([v, torch.ones((b, h, 1), dtype=v.dtype, device=v.device)], -1)
        out, st = ssm_lib.gla_decode_step(q, k, v_aug, log_f, cache["state"][l])
        num, den = out[..., :hd], out[..., hd:]
        y = num / at_least(torch.abs(den), 1.0)
        y = y.reshape(b, di).to(BF16) * silu(z)
        x = _residual(x, (y @ lp["w_down"])[:, None, :]).to(BF16)
        cache["state"][l].copy_(st)
    return x, cache


def _decode_slstm(x, p, cache, cfg: ArchConfig):
    b, _, d = x.shape
    h = cfg.num_heads
    hd = d // h
    xn = _norm(x, p["ln"], cfg)
    gates = (xn @ p["w_gates"]).reshape(b, 1, h, hd, 4)
    init = (cache["c"], cache["n"], cache["m"], cache["h"])
    y, (c, n, m, hh) = ssm_lib.slstm_scan(gates, p["r_kernels"], init=init)
    y = y.reshape(b, 1, d).to(BF16)
    return _residual(x, y @ p["w_out"]), {"c": c, "n": n, "m": m, "h": hh}


def _decode_encdec_stack(x, p, cache, pos, cfg: ArchConfig):
    x = x.to(BF16)  # the loop's first carry too (the prefill's takes it as given)
    for l in range(cache["k"].shape[0]):
        lp = _layer(p, l)
        xk, xv = cache["xk"][l], cache["xv"][l]
        x = _attn_step(x, lp, cache["k"][l], cache["v"][l], pos, 0, cfg)
        xn = _norm(x, lp["lnx"], cfg)
        q, _ = _q_proj(xn, lp["xwq"], cfg)
        lo, t = local.kv_slots("xk", xk.shape[1])
        if t == xk.shape[1]:
            sel = _kv_pick(lp["xwq"], lp["xwk"], cfg)
            o = decode_attention(q, _pick(xk, sel), _pick(xv, sel), t)
        else:
            o = local.own_block(decode_attention(
                local.model_gather(q, 2, cfg.num_heads), xk, xv, t, first_slot=lo,
                reduce=local.model_reduce), 2, q.shape[2])
        x = _residual(x, _out(o, lp["xwo"], cfg))
        x = _mlp_seq(x, lp, cfg).to(BF16)
    return x, cache


# --------------------------------------------------------------------------
# Model
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig

    def _backbone(self, params, x, *, want_cache=False, memory=None):
        cfg = self.cfg
        remat = cfg.remat
        kv_chunk = cfg.kv_chunk
        caches: Dict[str, Any] = {}
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)

        for g in plan_groups(cfg):
            if g.kind == "enc_dense":
                continue  # encoder handled separately
            p = params[g.key]
            if g.kind == "dense":
                def body(xc, lp, w):
                    out, kvp = _attn_seq(xc, lp, cfg, w, kv_chunk)
                    out = _mlp_seq(out, lp, cfg)
                    return out, kvp if want_cache else None

                x, ys = scan_group(x, p, body, g.layers, remat, extra_xs=g.meta["windows"])
                if want_cache:
                    caches[g.ckey] = {"k": ys[0], "v": ys[1]}
            elif g.kind == "moe":
                def body(xc, lp, w):
                    out, kvp = _attn_seq(xc, lp, cfg, w, kv_chunk)
                    out, aux = _moe_seq(out, lp, cfg)
                    return out, (kvp, aux) if want_cache else aux

                x, ys = scan_group(x, p, body, g.layers, remat, extra_xs=g.meta["windows"])
                if want_cache:
                    caches[g.ckey] = {"k": ys[0][0], "v": ys[0][1]}
                    aux_total = aux_total + torch.sum(ys[1])
                else:
                    aux_total = aux_total + torch.sum(ys)
            elif g.kind == "mamba":
                def body(xc, lp, _):
                    out, st = _mamba_seq(xc, lp, cfg)
                    return out, st if want_cache else None

                x, ys = scan_group(x, p, body, g.layers, remat)
                if want_cache:
                    caches[g.ckey] = {"state": ys[0], "conv": ys[1]}
            elif g.kind == "shared_attn":
                def block(xc, p=p, w=g.meta["window"]):
                    out, kvp = _attn_seq(xc, p, cfg, w, kv_chunk)
                    return _mlp_seq(out, p, cfg), kvp

                # The reference leaves this single block to its compiler; here
                # each application is checkpointed under remat, or zamba2's
                # four would keep ~16 GiB of attention internals each at
                # 4 x 4096 tokens.  The values are the same.
                x, (k, v) = checkpointed(block, x) if _remat_on(remat) else block(x)
                if want_cache:
                    caches[g.ckey] = {"k": k, "v": v}
            elif g.kind == "mlstm":
                def body(xc, lp, _):
                    out, st = _mlstm_seq(xc, lp, cfg)
                    return out, st if want_cache else None

                x, ys = scan_group(x, p, body, g.layers, remat)
                if want_cache:
                    caches[g.ckey] = {"state": ys}
            elif g.kind == "slstm":
                x, st = _slstm_seq(x, p, cfg)
                if want_cache:
                    caches[g.ckey] = {"c": st[0], "n": st[1], "m": st[2], "h": st[3]}
            elif g.kind == "dec_cross":
                def body(xc, lp, _):
                    out, kvp = _attn_seq(xc, lp, cfg, 0, kv_chunk)
                    out, xkv = _cross_seq(out, lp, memory, cfg, kv_chunk)
                    out = _mlp_seq(out, lp, cfg)
                    return out, (kvp, xkv) if want_cache else None

                x, ys = scan_group(x, p, body, g.layers, remat)
                if want_cache:
                    caches[g.ckey] = {
                        "k": ys[0][0], "v": ys[0][1],
                        "xk": ys[1][0], "xv": ys[1][1],
                    }
            else:
                raise ValueError(g.kind)
        return x, caches, aux_total

    def _embed_inputs(self, params, batch):
        cfg = self.cfg
        x = params["embed"][batch["tokens"]].to(BF16)
        if cfg.family == "vlm":
            x = torch.cat([batch["patches"].to(BF16), x], dim=1)
        return ctx.constrain_batch(x)

    def _encode(self, params, frames):
        cfg = self.cfg
        x = frames.to(BF16)
        for g in plan_groups(cfg):
            if g.kind != "enc_dense":
                continue

            def body(xc, lp, w):
                out, _ = _attn_seq(xc, lp, cfg, w, cfg.kv_chunk, causal=False)
                return _mlp_seq(out, lp, cfg), None

            x, _ = scan_group(x, params[g.key], body, g.layers, cfg.remat)
        return x

    def _head(self, params):
        return params["embed"].T if self.cfg.tie_embeddings else params["lm_head"]

    def _logits(self, params, x):
        xn = _norm(x, params["final_ln"], self.cfg)
        return (xn @ self._head(params).to(xn.dtype)).float()

    # ---------------- public entry points ----------------

    def loss_fn(self, params, batch) -> torch.Tensor:
        """The training loss: next-token cross-entropy plus 0.01 x the MoE
        load-balancing loss.  Differentiable in ``params`` (autograd; the
        layer groups remat as ``cfg.remat`` says)."""
        cfg = self.cfg
        memory = self._encode(params, batch["frames"]) if cfg.family == "encdec" else None
        x = self._embed_inputs(params, batch)
        x, _, aux = self._backbone(params, x, memory=memory)
        if cfg.family == "vlm":
            x = x[:, cfg.patch_tokens:, :]
        tokens = batch["tokens"]
        xn = _norm(x, params["final_ln"], cfg)
        # Next-token labels; final position has none (mask 0).
        labels = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])], dim=1)
        mask = torch.cat([torch.ones_like(tokens[:, 1:], dtype=torch.float32),
                          torch.zeros_like(tokens[:, :1], dtype=torch.float32)], dim=1)
        loss = chunked_cross_entropy(xn, self._head(params), labels, mask,
                                     chunk=min(512, tokens.shape[1]))
        return loss + 0.01 * aux

    def prompt_len(self, batch) -> int:
        """Positions a prefill of ``batch`` fills (tokens, and a VLM's
        patches): what ``prefill`` sets ``cache["len"]`` to."""
        return batch["tokens"].shape[1] + (
            self.cfg.patch_tokens if self.cfg.family == "vlm" else 0)

    def prefill(self, params, batch):
        cfg = self.cfg
        memory = self._encode(params, batch["frames"]) if cfg.family == "encdec" else None
        x = self._embed_inputs(params, batch)
        x, caches, _ = self._backbone(params, x, want_cache=True, memory=memory)
        if cfg.family == "vlm":
            x = x[:, cfg.patch_tokens:, :]
        # a slice of the stream is stored, so rounded (see _residual)
        logits = self._logits(params, x[:, -1:, :].to(BF16))
        caches["len"] = torch.full((), self.prompt_len(batch), dtype=torch.int32,
                                   device=x.device)
        return logits, caches

    def decode_step(self, params, cache, tokens):
        """One-token decode: tokens (B, 1) -> (logits (B,1,V), cache).

        Writes ``cache`` in place (see the module's docstring) and reads
        nothing back from the device."""
        cfg = self.cfg
        pos = cache["len"]
        x = params["embed"][tokens].to(BF16)
        new_cache: Dict[str, Any] = {}

        for g in plan_groups(cfg):
            if g.kind == "enc_dense":
                continue
            p = params[g.key]
            c = cache[g.ckey]
            if g.kind in ("dense", "moe"):
                x, new_cache[g.ckey] = _decode_attn_stack(
                    x, p, c, pos, g.meta["windows"], cfg, moe=(g.kind == "moe"))
            elif g.kind == "mamba":
                x, new_cache[g.ckey] = _decode_mamba_stack(x, p, c, cfg)
            elif g.kind == "shared_attn":
                w = g.meta["window"]
                # ring == window
                w = 0 if (w and local.kv_slots("k", c["k"].shape[1])[1] <= w) else w
                x = _attn_step(x, p, c["k"], c["v"], pos, w, cfg)
                x = _mlp_seq(x, p, cfg)
                new_cache[g.ckey] = c
            elif g.kind == "mlstm":
                x, new_cache[g.ckey] = _decode_mlstm_stack(x, p, c, cfg)
            elif g.kind == "slstm":
                x, new_cache[g.ckey] = _decode_slstm(x, p, c, cfg)
            elif g.kind == "dec_cross":
                x, new_cache[g.ckey] = _decode_encdec_stack(x, p, c, pos, cfg)
            else:
                raise ValueError(g.kind)

        logits = self._logits(params, x)
        new_cache["len"] = pos + 1
        return logits, new_cache

    # ---------------- cache construction ----------------

    def pad_cache(self, cache: Dict[str, Any], new_len: int) -> Dict[str, Any]:
        """Grow attention ring caches to ``new_len`` slots (prefill returns
        length-S caches; decoding past S needs headroom)."""

        def grow(name, leaf):
            if isinstance(leaf, dict):
                return {k: grow(k, v) for k, v in leaf.items()}
            if name in ("k", "v") and leaf.ndim >= 4:
                t_idx = leaf.ndim - 3
                pad = new_len - leaf.shape[t_idx]
                if pad > 0:
                    shape = list(leaf.shape)
                    shape[t_idx] = pad
                    return torch.cat([leaf, leaf.new_zeros(shape)], dim=t_idx)
            return leaf

        return {k: grow(k, v) for k, v in cache.items()}

    def cache_struct(self, batch_size: int, cache_len: int, device=None) -> Dict[str, Any]:
        """Zero-initialized decode cache on ``device`` (the card unless the
        caller asks for the CPU).

        ``cache_len`` is the ring size: attention caches hold the last
        ``min(cache_len, window or inf)`` tokens; SSM states are O(1).
        """
        cfg = self.cfg
        dev = resolve_device(device)
        kv, hd = cfg.num_kv_heads, cfg.head_dim_
        b = batch_size
        d = cfg.d_model

        def zeros(*shape, dtype=BF16):
            return torch.zeros(shape, dtype=dtype, device=dev)

        cache: Dict[str, Any] = {"len": zeros(dtype=torch.int32)}
        for g in plan_groups(cfg):
            if g.kind == "enc_dense":
                continue
            if g.kind in ("dense", "moe"):
                cache[g.ckey] = {"k": zeros(g.layers, b, cache_len, kv, hd),
                                 "v": zeros(g.layers, b, cache_len, kv, hd)}
            elif g.kind == "shared_attn":
                t = min(cache_len, g.meta["window"]) if g.meta["window"] else cache_len
                cache[g.ckey] = {"k": zeros(b, t, kv, hd), "v": zeros(b, t, kv, hd)}
            elif g.kind == "mamba":
                d_in = 2 * d
                h = d_in // MAMBA_HD
                conv_ch = d_in + 2 * cfg.ssm_state
                cache[g.ckey] = {
                    "state": zeros(g.layers, b, h, cfg.ssm_state, MAMBA_HD, dtype=torch.float32),
                    "conv": zeros(g.layers, b, CONV_K - 1, conv_ch),
                }
            elif g.kind == "mlstm":
                h = cfg.num_heads
                hd_i = 2 * d // h
                # fused num+den state: dv = hd + 1 (ones column)
                cache[g.ckey] = {
                    "state": zeros(g.layers, b, h, hd_i, hd_i + 1, dtype=torch.float32)}
            elif g.kind == "slstm":
                h = cfg.num_heads
                hd_i = d // h
                z = [zeros(b, h, hd_i, dtype=torch.float32) for _ in range(4)]
                cache[g.ckey] = {"c": z[0], "n": z[1], "m": z[2] - 10.0, "h": z[3]}
            elif g.kind == "dec_cross":
                cache[g.ckey] = {
                    "k": zeros(g.layers, b, cache_len, kv, hd),
                    "v": zeros(g.layers, b, cache_len, kv, hd),
                    "xk": zeros(g.layers, b, cfg.encoder_seq, kv, hd),
                    "xv": zeros(g.layers, b, cfg.encoder_seq, kv, hd),
                }
        return cache
