"""State-space / recurrent blocks: Mamba2 (SSD), mLSTM, sLSTM.

The port of ``repro.models.ssm``.  ``chunked_gla`` is chunked gated linear
attention: Mamba2's SSD and xLSTM's mLSTM are both instances of

    S_t = exp(a_t) * S_{t-1} + k_t v_t^T ,   y_t = q_t^T S_t

The within-chunk interactions are (L x L) decay-masked products and the
(dk x dv) state is carried across chunks; the reference's ``lax.scan`` over
chunks is a loop here, float32 inside as there.  sLSTM is sequential: a loop
over time steps with the exponential-gating stabilizer.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import at_least, at_most


def chunked_gla(
    q: torch.Tensor,          # (B, S, H, dk)
    k: torch.Tensor,          # (B, S, H, dk)
    v: torch.Tensor,          # (B, S, H, dv)
    log_decay: torch.Tensor,  # (B, S, H)  log f_t <= 0
    state: torch.Tensor | None = None,  # (B, H, dk, dv) initial state
    chunk: int = 256,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B,S,H,dv), final_state (B,H,dk,dv)). float32 internally."""
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of the chunk {chunk}")
    n = s // chunk

    q = q.float().reshape(b, n, chunk, h, dk)
    k = k.float().reshape(b, n, chunk, h, dk)
    v = v.float().reshape(b, n, chunk, h, dv)
    a = log_decay.float().reshape(b, n, chunk, h)

    if state is None:
        state = torch.zeros((b, h, dk, dv), dtype=torch.float32, device=q.device)

    idx = torch.arange(chunk, device=q.device)
    causal = idx[:, None] >= idx[None, :]  # (L, L) j <= i

    ys = []
    for c in range(n):
        qc, kc, vc, ac = q[:, c], k[:, c], v[:, c], a[:, c]   # (B,L,H,*)
        cum = torch.cumsum(ac, dim=1)        # A_i = sum_{t<=i} a_t  (B,L,H)
        # intra-chunk: scores_ij = exp(A_i - A_j) q_i.k_j for j <= i
        qk = torch.einsum("blhd,bmhd->bhlm", qc, kc)
        decay = cum[:, :, None, :] - cum[:, None, :, :]      # (B,L,M,H) A_i - A_j
        decay = torch.exp(at_most(decay, 0.0)).permute(0, 3, 1, 2)
        scores = qk * decay * causal[None, None]
        y_intra = torch.einsum("bhlm,bmhv->blhv", scores, vc)
        # inter-chunk: exp(A_i) q_i^T S_prev
        qdec = qc * torch.exp(cum)[..., None]
        y_inter = torch.einsum("blhd,bhdv->blhv", qdec, state)
        # state update: S = exp(A_L) S_prev + sum_j exp(A_L - A_j) k_j v_j^T
        tot = cum[:, -1]                                  # (B,H)
        kdec = kc * torch.exp(tot[:, None] - cum)[..., None]
        state = torch.exp(tot)[..., None, None] * state + torch.einsum(
            "blhd,blhv->bhdv", kdec, vc)
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(b, s, h, dv)
    return y, state


def gla_decode_step(
    q: torch.Tensor,          # (B, H, dk)
    k: torch.Tensor,
    v: torch.Tensor,          # (B, H, dv)
    log_decay: torch.Tensor,  # (B, H)
    state: torch.Tensor,      # (B, H, dk, dv)
):
    """One-token GLA update (O(1) in sequence)."""
    f = torch.exp(log_decay.float())[..., None, None]
    state = f * state + k.float()[..., :, None] * v.float()[..., None, :]
    y = torch.einsum("bhd,bhdv->bhv", q.float(), state)
    return y, state


def causal_conv1d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x (B, S, C), w (K, C)."""
    k = w.shape[0]
    pad = F.pad(x, (0, 0, k - 1, 0))
    out = pad[:, 0:x.shape[1], :] * w[0]
    for i in range(1, k):
        out = out + pad[:, i:i + x.shape[1], :] * w[i]
    return out


def conv_decode_step(x_new: torch.Tensor, conv_state: torch.Tensor, w: torch.Tensor):
    """x_new (B, C); conv_state (B, K-1, C) past inputs. Returns (y, state)."""
    full = torch.cat([conv_state, x_new[:, None, :]], dim=1)  # (B,K,C)
    # a contraction over K, accumulated in float32 and rounded once, as the
    # reference's einsum (a dot) is; a bf16 einsum here rounds each product
    y = torch.einsum("bkc,kc->bc", full.float(), w.float()).to(
        torch.promote_types(full.dtype, w.dtype))
    return y, full[:, 1:, :]


# --------------------------------------------------------------------------
# sLSTM: sequential scalar-memory recurrence with exponential gating.
# --------------------------------------------------------------------------

def slstm_scan(
    gates: torch.Tensor,      # (B, S, H, hd, 4) pre-activations [i, f, z, o]
    r_kernels: torch.Tensor,  # (4, H, hd, hd) recurrent block-diagonal weights
    init: tuple | None = None,  # (c, n, m, h) each (B, H, hd)
):
    b, s, h, hd = gates.shape[:4]
    if init is None:
        zero = torch.zeros((b, h, hd), dtype=torch.float32, device=gates.device)
        init = (zero, zero, zero - 10.0, zero)
    c, n, m, h_prev = init
    r = r_kernels.float()
    hs = []
    for t in range(s):
        rec = torch.einsum("ghde,bhe->gbhd", r, h_prev)
        gi = gates[:, t].float()
        log_i = gi[..., 0] + rec[0]
        log_f = F.logsigmoid(gi[..., 1] + rec[1])
        z = torch.tanh(gi[..., 2] + rec[2])
        o = torch.sigmoid(gi[..., 3] + rec[3])
        m_new = torch.maximum(log_f + m, log_i)
        ci = torch.exp(log_i - m_new)
        cf = torch.exp(log_f + m - m_new)
        c = cf * c + ci * z
        n = cf * n + ci
        h_prev = o * c / at_least(n, 1.0)
        m = m_new
        hs.append(h_prev)
    return torch.stack(hs, dim=1), (c, n, m, h_prev)  # (B,S,H,hd), state
