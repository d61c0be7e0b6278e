"""The collectives of a model call run on each rank's local shards.

DTensor runs an op on sharded tensors only where it has a rule for it, and
it cannot flatten two sharded dims into one: the attention's head reshape
beside a batch sharded on "data", the MoE dispatch's ``index_put``, xLSTM's
``log_sigmoid_backward`` have none.  So a sharded model call runs the model
on each rank's local shards, as the reference's GSPMD partition does and as
``shard_map`` would: ``models/sharded.py`` hands every rank its batch rows
and each parameter in its compute layout (FSDP dims gathered; heads, FFN
columns and experts left on "model" where the model uses them per rank),
and the model takes the collectives it needs from here:

  ``enter(x)``    Megatron's f: the identity forward, a float32 sum over
                  "model" backward, where a replicated activation or weight enters
                  per-rank heads, FFN columns or experts;
  ``leave(y)``    Megatron's g: a sum over "model" forward, the identity
                  backward, after a row-parallel product;
  ``psum_dp(x)``  a sum over the batch axes forward, the identity backward:
                  the loss's token sums.

A decode step keeps a KV cache split on its slots over "model" where the
cache's specs split it so (sequence parallelism, as the reference's
GSPMD program runs it): each rank attends over its block of the slots
(:func:`kv_slots`), with every query head (``model_gather``), and the
ranks' partial softmaxes are combined by ``model_reduce``; only the rank
that holds the new token's slot writes it.  No cache moves between ranks.

Every rank's loss is then the whole batch's, and each rank's backward gives
its batch rows' share of every gradient: summed over the batch axes, the
gradient.  Outside :func:`local_mode`, and on an axis of one rank, each of
them returns its input itself: the plain path is unchanged bit for bit.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Tuple

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Local:
    dp_groups: Tuple          # one process group per batch axis
    model_group: Optional[object]
    model_size: int
    model_rank: int
    kv_split: frozenset = frozenset()   # decode cache leaves split on their slots


_LOCAL: Optional[Local] = None


@contextlib.contextmanager
def local_mode(device_mesh, dp_axes: Tuple[str, ...], model_axis: Optional[str],
               kv_split: Tuple[str, ...] = ()):
    """Run the model on local shards of ``device_mesh``: the batch split over
    ``dp_axes`` and the parameters' per-rank dims over ``model_axis`` (None
    when the model axis carries batch or is absent); the decode cache leaves
    named in ``kv_split`` hold this rank's block of their slots
    (:func:`kv_slots`)."""
    global _LOCAL
    names = device_mesh.mesh_dim_names
    groups = tuple(device_mesh.get_group(a) for a in dp_axes
                   if device_mesh.size(names.index(a)) > 1)
    m_size = device_mesh.size(names.index(model_axis)) if model_axis else 1
    state = Local(groups, device_mesh.get_group(model_axis) if m_size > 1 else None, m_size,
                  device_mesh.get_local_rank(model_axis) if model_axis else 0,
                  frozenset(kv_split) if m_size > 1 else frozenset())
    prev, _LOCAL = _LOCAL, state
    try:
        yield state
    finally:
        _LOCAL = prev


def _all_reduce(x: torch.Tensor, groups) -> torch.Tensor:
    x = x.contiguous().clone()
    for g in groups:
        dist.all_reduce(x, group=g)
    return x


class _Sum(torch.autograd.Function):
    """A sum over ``groups`` forward; the identity backward."""

    @staticmethod
    def forward(fctx, x, groups):
        return _all_reduce(x, groups)

    @staticmethod
    def backward(fctx, g):
        return g, None


class _Enter(torch.autograd.Function):
    """The identity forward; a sum over ``groups`` backward."""

    @staticmethod
    def forward(fctx, x, groups):
        fctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(fctx, g):
        # the ranks' partial gradients summed in float32, rounded once
        return _all_reduce(g.float(), fctx.groups).to(g.dtype), None


def enter(x: torch.Tensor) -> torch.Tensor:
    if _LOCAL is None or _LOCAL.model_group is None:
        return x
    return _Enter.apply(x, (_LOCAL.model_group,))


def leave(y: torch.Tensor) -> torch.Tensor:
    if _LOCAL is None or _LOCAL.model_group is None:
        return y
    return _Sum.apply(y, (_LOCAL.model_group,))


def psum_dp(x: torch.Tensor) -> torch.Tensor:
    if _LOCAL is None or not _LOCAL.dp_groups:
        return x
    return _Sum.apply(x, _LOCAL.dp_groups)


def batch_mean(x: torch.Tensor, dims: Tuple[int, ...]) -> torch.Tensor:
    """``x.mean(dims)`` over the batch rows of every rank (``dims`` start at
    the batch dim): the sum of the ranks' sums over the count of all rows."""
    if _LOCAL is None or not _LOCAL.dp_groups:
        return x.mean(dim=dims)
    n = 1
    for d in dims:
        n *= x.shape[d]
    for g in _LOCAL.dp_groups:
        n *= dist.get_world_size(g)
    return psum_dp(x.sum(dim=dims)) / n


def local_block(n: int) -> Tuple[int, int]:
    """[lo, hi) of ``n`` items (heads, experts) that this "model" rank holds
    when they are split evenly over the axis (all of them outside
    :func:`local_mode`)."""
    if _LOCAL is None:
        return 0, n
    per = n // _LOCAL.model_size
    return _LOCAL.model_rank * per, (_LOCAL.model_rank + 1) * per


def kv_slots(name: str, t_local: int) -> Tuple[int, int]:
    """(this rank's first slot, all slots) of the decode cache leaf ``name``
    ("k", "v", "xk", "xv") whose local tensor holds ``t_local`` slots:
    ``(0, t_local)`` unless the call splits that leaf's slots over "model"."""
    if _LOCAL is None or name not in _LOCAL.kv_split:
        return 0, t_local
    return _LOCAL.model_rank * t_local, _LOCAL.model_size * t_local


@torch.no_grad()
def model_gather(x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """All ``n`` entries of ``x``'s dim ``dim`` (heads), the "model" ranks'
    blocks in rank order, where ``x`` holds this rank's block; else ``x``."""
    if x.shape[dim] == n or _LOCAL is None or _LOCAL.model_group is None:
        return x
    parts = [torch.empty_like(x) for _ in range(_LOCAL.model_size)]
    dist.all_gather(parts, x.contiguous(), group=_LOCAL.model_group)
    return torch.cat(parts, dim)


def own_block(x: torch.Tensor, dim: int, n_local: int) -> torch.Tensor:
    """This "model" rank's ``n_local`` entries of ``x``'s dim ``dim`` where
    ``x`` holds all of them (the inverse of :func:`model_gather`)."""
    if x.shape[dim] == n_local:
        return x
    lo, hi = local_block(x.shape[dim])
    return x.narrow(dim, lo, hi - lo)


@torch.no_grad()
def model_reduce(x: torch.Tensor, op: str) -> torch.Tensor:
    """The "max" or "sum" of ``x`` over the "model" ranks (a decode step's
    partial softmax; no backward)."""
    if _LOCAL is None or _LOCAL.model_group is None:
        return x
    y = x.contiguous().clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM,
                    group=_LOCAL.model_group)
    return y
