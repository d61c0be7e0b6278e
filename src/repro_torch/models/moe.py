"""Mixture-of-Experts FFN with sort-based capacity dispatch.

The port of ``repro.models.moe``.  Per batch row, token->expert assignments
are sorted by expert id (a stable sort, as ``jnp.argsort``) and positions
within each expert's run come from a running maximum of run starts (the
reference's ``associative_scan(maximum)``), so the dispatch tables ``dest``
equal the reference's exactly, including which assignments are dropped at
capacity.

Shapes (per batch row, S tokens, E experts, top-k):
  capacity C = ceil(S * k / E * capacity_factor)
  dispatch index (E, C) (-1 pad), combine weight (E, C)
  expert compute: einsum (B, E, C, d) x (E, d, f).

The reference's out-of-range writes (``mode="drop"`` into expert row E and
token row S) land here in one spare row that is then cut off.

On local shards (``distributed/local.py``) with the expert weights split
over "model" (EP), every rank routes its batch rows to all E experts, as on
one rank, and then dispatches, computes and combines only its own experts'
slots; the combined rows, partial sums in float32, are summed over "model"
and rounded once.  The load-balancing loss's means run over every rank's
batch rows.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import ctx, local
from repro_torch.models.layers import at_least, silu


def moe_capacity(seq_len: int, num_experts: int, top_k: int, factor: float) -> int:
    return max(int(math.ceil(seq_len * top_k / num_experts * factor)), top_k)


def _top_k(probs: torch.Tensor, k: int):
    """``lax.top_k``: the k largest along the last axis, the lower index
    first on ties (a stable descending sort; ``torch.topk`` promises no
    order among equal values)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _dispatch_row(expert_ids: torch.Tensor, gate_w, num_experts: int,
                  capacity: int) -> torch.Tensor:
    """Dispatch tables of one row or a batch of rows. expert_ids: (..., S*k);
    ``gate_w`` is unused, as in the reference. Returns dest (..., E, C): the
    index into the row's flattened (S*k,) assignment list of each expert
    slot, -1 where empty."""
    lead, sk = expert_ids.shape[:-1], expert_ids.shape[-1]
    dev = expert_ids.device
    order = torch.argsort(expert_ids, dim=-1, stable=True)
    e_sorted = torch.gather(expert_ids, -1, order)
    # position within each expert's run
    is_start = torch.ones_like(e_sorted, dtype=torch.bool)
    is_start[..., 1:] = e_sorted[..., 1:] != e_sorted[..., :-1]
    ar = torch.arange(sk, device=dev).expand_as(e_sorted)
    run_start = torch.cummax(torch.where(is_start, ar, 0), dim=-1).values
    pos = ar - run_start
    keep = pos < capacity
    rows = int(math.prod(lead))
    # one spare expert row takes every dropped assignment
    dest = torch.full((rows, num_experts + 1, capacity), -1, dtype=torch.int32, device=dev)
    r_idx = torch.arange(rows, device=dev)[:, None].expand(rows, sk)
    dest[r_idx, torch.where(keep, e_sorted, num_experts).reshape(rows, sk),
         torch.where(keep, pos, 0).reshape(rows, sk)] = order.reshape(rows, sk).to(torch.int32)
    return dest[:, :num_experts].reshape(*lead, num_experts, capacity)


def moe_ffn(
    x: torch.Tensor,             # (B, S, d)
    router_w: torch.Tensor,      # (d, E)
    w_gate: torch.Tensor,        # (E, d, f)
    w_up: torch.Tensor,          # (E, d, f)
    w_down: torch.Tensor,        # (E, f, d)
    top_k: int,
    capacity_factor: float = 1.25,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (out (B,S,d), aux_loss scalar)."""
    b, s, d = x.shape
    e = router_w.shape[1]
    c = moe_capacity(s, e, top_k, capacity_factor)
    dev = x.device

    logits = x.float() @ router_w.float()                        # (B,S,E)
    probs = torch.softmax(logits, dim=-1)
    gate_w, expert_ids = _top_k(probs, top_k)                    # (B,S,k)
    gate_w = gate_w / at_least(gate_w.sum(-1, keepdim=True), 1e-9)

    flat_ids = expert_ids.reshape(b, s * top_k)
    flat_w = gate_w.reshape(b, s * top_k)
    dest = _dispatch_row(flat_ids, flat_w, e, c).long()         # (B,E,C)
    ep = w_gate.shape[0] != e       # this rank's experts only
    if ep:
        lo, hi = local.local_block(e)
        dest, e = dest[:, lo:hi], hi - lo
        # the gathered rows and weights feed this rank's experts only
        x, flat_w = local.enter(x), local.enter(flat_w)

    token_of = torch.div(dest, top_k, rounding_mode="floor")    # source token
    present = dest >= 0
    safe_tok = torch.where(present, token_of, 0)

    xe = torch.gather(x, 1, safe_tok.reshape(b, e * c, 1).expand(b, e * c, d))
    xe = xe.reshape(b, e, c, d)
    xe = torch.where(present[..., None], xe, 0.0)
    xe = ctx.constrain_moe_dispatch(xe)

    hdn = silu(torch.einsum("becd,edf->becf", xe, w_gate)) * torch.einsum(
        "becd,edf->becf", xe, w_up)
    ye = torch.einsum("becf,efd->becd", hdn, w_down)             # (B,E,C,d)
    ye = ctx.constrain_moe_dispatch(ye)

    w_of = torch.gather(flat_w, 1, torch.where(present, dest, 0).reshape(b, e * c))
    w_of = (w_of.reshape(b, e, c) * present).to(ye.dtype)

    # scatter-add back to tokens; the spare token row S takes empty slots
    out = torch.zeros((b, s + 1, d), dtype=torch.float32 if ep else ye.dtype, device=dev)
    scatter_tok = torch.where(present, token_of, s).reshape(b, e * c)
    contrib = (ye * w_of[..., None]).reshape(b, e * c, d)
    out.scatter_add_(1, scatter_tok[..., None].expand(b, e * c, d), contrib.to(out.dtype))
    out = out[:, :s]
    if ep:
        out, e = local.leave(out), router_w.shape[1]

    # Switch-style load-balancing auxiliary loss.
    me = local.batch_mean(probs, (0, 1))                         # mean router prob
    assign = local.batch_mean(F.one_hot(expert_ids, e).sum(2).float(), (0, 1)) / top_k
    aux = e * torch.sum(me * assign)
    return out.to(x.dtype), aux.float()
