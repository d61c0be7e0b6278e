"""Shared transformer layers: RMSNorm, RoPE, GQA attention (blockwise for
train/prefill, cached for decode), SwiGLU, cross-entropy.

The port of ``repro.models.layers``.  ``blockwise_attention`` keeps the
reference's online softmax over KV chunks in float32, op for op: the chunk
padding and masking, the causal mask, a per-layer window, GQA by reshape,
``NEG_INF`` for masked scores and the same order of ``m`` / ``l`` / ``acc``
updates.  It is plain PyTorch, not ``scaled_dot_product_attention``: the
reference computes it in plain ``jnp``, and a library kernel would change
both the masking and the rounding.  Nothing here reads the device from the
host, so a decode step can later be captured as one CUDA graph.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch._device import constant
from repro_torch.distributed import local

NEG_INF = -1e30


def at_least(x: torch.Tensor, lo: float) -> torch.Tensor:
    """``jnp.maximum(x, lo)``: at a tie the gradient splits half and half
    between ``x`` and the constant, as JAX's ``max`` does (``torch.clamp``
    would pass all of it to ``x``).  The values are ``clamp``'s."""
    return torch.maximum(x, constant(lo, x.dtype, x.device))


def at_most(x: torch.Tensor, hi: float) -> torch.Tensor:
    """``jnp.minimum(x, hi)``, with JAX's gradient at a tie (see
    :func:`at_least`)."""
    return torch.minimum(x, constant(hi, x.dtype, x.device))


def checkpointed(fn, *args):
    """``jax.checkpoint(fn)(*args)``: keep only the inputs for the
    backward and run ``fn`` again there.  Nothing here draws random numbers,
    so no RNG state is stashed.  Without autograd it is a plain call."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * w).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding. x: (B, S, H, hd); positions: (S,) or (B, S)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions.float()[..., None] * freqs  # (..., S, half)
    if ang.ndim == 2:  # (S, half) -> broadcast over batch
        ang = ang[None]
    # (B, S, 1, half) float32: a bf16 x times them promotes to float32, as in
    # the reference (neither operand is 0-d).
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    rx1 = x1 * cos - x2 * sin
    rx2 = x2 * cos + x1 * sin
    return torch.cat([rx1, rx2], dim=-1).to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: x * logistic(x), with the logistic as XLA expands it,
    1 / (1 + exp(-x)), each op rounded to x's dtype.  On bf16 that is what the
    reference computes; ``F.silu`` rounds once and differs from it by a bf16
    ulp in about a third of the elements, which grows through the layers."""
    return x * torch.reciprocal(1 + torch.exp(-x))


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    h = silu(x @ w_gate) * (x @ w_up)
    return h @ w_down


def blockwise_attention(
    q: torch.Tensor,            # (B, S, H, hd)
    k: torch.Tensor,            # (B, T, KV, hd)
    v: torch.Tensor,            # (B, T, KV, hd)
    *,
    causal: bool = True,
    window: int = 0,            # 0 = full
    q_offset: int = 0,          # absolute position of q[0] (cross/self)
    kv_chunk: int = 1024,
) -> torch.Tensor:
    """Online-softmax attention over KV chunks. O(S*chunk) memory."""
    b, s, h, hd = q.shape
    t_real = k.shape[1]
    kv = k.shape[2]
    g = h // kv
    kv_chunk = min(kv_chunk, t_real)
    pad = (-t_real) % kv_chunk
    if pad:  # e.g. whisper's 1500 encoder frames: pad + mask
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    t = t_real + pad
    n_chunks = t // kv_chunk
    dev = q.device

    qr = q.reshape(b, s, kv, g, hd).float()
    scale = hd ** -0.5
    q_pos = q_offset + torch.arange(s, device=dev)

    m = torch.full((b, s, kv, g), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, s, kv, g), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, s, kv, g, hd), dtype=torch.float32, device=dev)
    for c in range(n_chunks):
        start = c * kv_chunk
        k_c = k[:, start:start + kv_chunk].float()
        v_c = v[:, start:start + kv_chunk].float()
        # scores: (B, S, KV, g, C)
        scores = torch.einsum("bskgd,bckd->bskgc", qr, k_c) * scale
        kv_pos = start + torch.arange(kv_chunk, device=dev)
        mask = (kv_pos[None, :] < t_real).expand(s, kv_chunk)
        if causal:
            mask = mask & (q_pos[:, None] >= kv_pos[None, :])
        if window > 0:
            mask = mask & (q_pos[:, None] - kv_pos[None, :] < window)
        scores = torch.where(mask[None, :, None, None, :], scores, NEG_INF)

        m_cur = scores.amax(dim=-1)                          # (B,S,KV,g)
        m_new = torch.maximum(m, m_cur)
        p = torch.exp(scores - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bskgc,bckd->bskgd", p, v_c)
        acc = acc * corr[..., None] + pv
        m = m_new

    out = acc / at_least(l[..., None], 1e-30)
    return out.reshape(b, s, h, hd).to(q.dtype)


def decode_attention(
    q: torch.Tensor,          # (B, 1, H, hd)
    k_cache: torch.Tensor,    # (B, T, KV, hd)
    v_cache: torch.Tensor,    # (B, T, KV, hd)
    cache_len,                # valid prefix length: int or () int tensor
    *,
    window: int = 0,
    first_slot: int = 0,
    reduce=None,
) -> torch.Tensor:
    """Single-token attention over a KV cache: one masked einsum.

    ``cache_len`` may be a () device tensor: the mask is built on the
    device, so the call reads nothing back.  With ``reduce`` the caches
    hold slots ``first_slot`` onwards of a cache split over ranks: the
    softmax is taken in parts, its max and sums combined by
    ``reduce(x, "max" | "sum")`` over the ranks."""
    b, _, h, hd = q.shape
    t, kv = k_cache.shape[1], k_cache.shape[2]
    g = h // kv
    qr = q.reshape(b, kv, g, hd).float()
    scores = torch.einsum("bkgd,btkd->bkgt", qr, k_cache.float())
    scores = scores * (hd ** -0.5)
    pos = torch.arange(first_slot, first_slot + t, device=q.device)
    clen = cache_len.reshape(-1, 1) if torch.is_tensor(cache_len) else cache_len
    mask = pos[None, :] < clen
    if window > 0:
        mask = mask & (pos[None, :] >= clen - window)
    scores = torch.where(mask[:, None, None, :], scores, NEG_INF)
    if reduce is None:
        p = torch.softmax(scores, dim=-1)
        out = torch.einsum("bkgt,btkd->bkgd", p, v_cache.float())
    else:
        e = torch.exp(scores - reduce(scores.amax(-1, keepdim=True), "max"))
        out = (reduce(torch.einsum("bkgt,btkd->bkgd", e, v_cache.float()), "sum")
               / reduce(e.sum(-1)[..., None], "sum"))
    return out.reshape(b, 1, h, hd).to(q.dtype)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy in f32. logits (..., V), labels (...)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(lse - picked)


def chunked_cross_entropy(
    x: torch.Tensor,        # (B, S, d) final hidden states (already normed)
    head: torch.Tensor,     # (d, V)
    labels: torch.Tensor,   # (B, S) int
    mask: torch.Tensor,     # (B, S) float32 weights
    chunk: int = 512,
) -> torch.Tensor:
    """Sequence-chunked softmax cross-entropy: never holds the full (B, S, V)
    logits.  Each chunk is checkpointed, as the reference's
    ``@jax.checkpoint`` scan body is: the forward keeps only the chunk's
    inputs and the backward recomputes its (B, C, V) float32 logits, so a
    backward holds one chunk's at a time."""
    b, s, d = x.shape
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        mask = F.pad(mask, (0, pad))
    n = x.shape[1] // chunk
    head = head.to(x.dtype)

    def body(xc, lc, mc):
        logits = (xc @ head).float()
        lse = torch.logsumexp(logits, dim=-1)
        picked = torch.gather(logits, -1, lc[..., None].long())[..., 0]
        return torch.sum((lse - picked) * mc)

    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(n):
        sl = slice(c * chunk, (c + 1) * chunk)
        total = total + checkpointed(body, x[:, sl], labels[:, sl], mask[:, sl])
    # on local shards, the sums over every rank's batch rows
    return local.psum_dp(total) / torch.clamp(local.psum_dp(torch.sum(mask)), min=1.0)
