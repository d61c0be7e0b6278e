"""Functional optimizers (counterpart of ``repro/train/optimizer.py``).

Shared by the SLAM pipeline (pose and Gaussian Adam) and the LM trainer
(AdamW with a cosine schedule and global-norm clipping).
``init(params) -> state`` and ``update(grads, state, params=None) ->
(updates, state)`` over dicts of tensors, nested as the LM's parameter
tree is; apply with :func:`apply_updates`.

The expression order is the reference's, leaf by leaf and in the leaf's
own dtype: ``a = lr / bc1`` and ``rsqrt(bc2)`` as float32 scalars cast to
the leaf's dtype, then ``-a * m / (sqrt(v) * rsqrt(bc2) + eps)``, less the
decoupled decay.  The Python constants (``b1``, ``1 - b1``, ``eps``, ...)
enter each leaf's expression rounded to its dtype, as JAX's weakly typed
scalars do (on a bf16 leaf ``b2 = 0.999`` is 1.0).  On float32 leaves this
is the plain float32 computation, so the SLAM path's defaults (no decay, no
clipping, a float ``lr``) keep their bits.  ``torch.optim.Adam`` orders
the bias correction differently and is not used.

:meth:`Adam.update_apply` is ``update`` then ``apply_updates`` leaf by
leaf, writing each new leaf over the old one in the caller's dicts: the
step holds one leaf's temporaries beyond the state, not whole trees
(phi4-mini's parameters, gradients and moments are 30.7 GB in bf16).

The row-masked forms (:meth:`Adam.update_masked`,
:func:`apply_updates_masked`) serve sparse stable/unstable mapping: rows
outside the mask get a zero update, keep their moments and keep their
parameter bits.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, NamedTuple, Optional, Union

import torch

from repro_torch._device import constant


class AdamState(NamedTuple):
    step: torch.Tensor  # () int32
    mu: dict
    nu: dict


# ---------------------------------------------------------------------------
# trees: nested dicts of tensors, leaves in ``jax.tree.leaves`` order
# ---------------------------------------------------------------------------

def tree_map(fn, tree, *rest):
    """``jax.tree.map`` over nested dicts (the first tree's keys)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of nested dicts with keys sorted at every level, the
    order ``jax.tree.leaves`` gives."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_paths(tree, prefix: str = "") -> dict:
    """{"a/b/c": leaf} over nested dicts, in ``tree_leaves`` order."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        out.update(tree_paths(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: v})
    return out


def tree_unflatten(tree, leaves) -> dict:
    """A tree like ``tree`` holding ``leaves`` (in ``tree_leaves`` order)."""
    return _fill(tree, iter(leaves))


# The tree walks are module functions: a nested function that calls itself
# is a reference cycle, which would keep the leaves it reached alive until
# the garbage collector runs (gigabytes at full width).
def _fill(tree, it):
    if isinstance(tree, dict):
        return {k: _fill(tree[k], it) for k in sorted(tree)}
    return next(it)


def _first_leaf(tree) -> torch.Tensor:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


@functools.lru_cache(maxsize=None)
def _in(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as a Python float: what a weakly
    typed scalar is in a JAX expression on a leaf of that dtype."""
    return torch.tensor(value, dtype=dtype).item()


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves (in ``tree_leaves`` order) of each
    leaf's float32 sum of squares: a () float32 tensor."""
    return torch.sqrt(sum(torch.sum(torch.square(l.float())) for l in tree_leaves(tree)))


@dataclasses.dataclass(frozen=True)
class Adam:
    lr: Union[float, Callable[[torch.Tensor], torch.Tensor]] = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0       # AdamW-style decoupled decay
    clip_norm: Optional[float] = None

    def init(self, params: dict) -> AdamState:
        return AdamState(
            step=torch.zeros((), dtype=torch.int32, device=_first_leaf(params).device),
            mu=tree_map(torch.zeros_like, params),
            nu=tree_map(torch.zeros_like, params),
        )

    def _scalars(self, grads: dict, state: AdamState, gnorm=None):
        """The new step and the float32 scalars every leaf reads: the
        clipping scale (None without clipping), ``lr / bc1``,
        ``rsqrt(bc2)`` and ``lr``.  ``gnorm`` is ``global_norm(grads)``
        where the caller has it."""
        step = state.step + 1
        scale = None
        if self.clip_norm is not None:
            if gnorm is None:
                gnorm = global_norm(grads)
            scale = torch.clamp(self.clip_norm / (gnorm + 1e-12), max=1.0)
        stepf = step.to(torch.float32)
        bc1 = 1.0 - constant(self.b1, torch.float32, step.device) ** stepf
        bc2 = 1.0 - constant(self.b2, torch.float32, step.device) ** stepf
        lr = (self.lr(step).to(torch.float32) if callable(self.lr)
              else constant(self.lr, torch.float32, step.device))
        return step, scale, lr / bc1, torch.rsqrt(bc2), lr

    def _leaf(self, g, m, v, p, scale, a, inv_sqrt_bc2, lr):
        """One leaf's (new m, new v, update), in the leaf's dtype."""
        dt = m.dtype
        if scale is not None:
            g = g * scale.to(g.dtype)
        m = _in(self.b1, dt) * m + _in(1 - self.b1, dt) * g
        v = _in(self.b2, dt) * v + _in(1 - self.b2, dt) * g * g
        u = -a.to(dt) * m / (torch.sqrt(v) * inv_sqrt_bc2.to(dt) + _in(self.eps, dt))
        if self.weight_decay and p is not None:
            u = u - (lr * self.weight_decay).to(dt) * p
        return m, v, u

    def update(self, grads: dict, state: AdamState, params: Optional[dict] = None):
        step, *scalars = self._scalars(grads, state)
        if params is None:
            out = tree_map(lambda g, m, v: self._leaf(g, m, v, None, *scalars),
                           grads, state.mu, state.nu)
        else:
            out = tree_map(lambda g, m, v, p: self._leaf(g, m, v, p, *scalars),
                           grads, state.mu, state.nu, params)
        pick = lambda i: tree_map(lambda t: t[i], out)
        return pick(2), AdamState(step=step, mu=pick(0), nu=pick(1))

    def update_apply(self, grads: dict, state: AdamState, params: dict):
        """``update`` then ``apply_updates``, leaf by leaf and bit for bit
        the same, written over the old leaves: ``params``, ``state.mu`` and
        ``state.nu`` are updated in place (their dicts, not their tensors)
        and ``grads`` is consumed (each gradient leaves its dict once its
        leaf's update is computed).  Returns (params, state, the gradients'
        ``global_norm``).

        A failure before the first leaf is written raises as it came, with
        ``params``, the moments and ``grads`` whole, so the caller may save
        the state.  A failure after it raises :class:`UpdateInterrupted`:
        some leaves then hold the new step and the others the old one, so
        the state must not be saved."""
        gnorm = global_norm(grads)
        step, *scalars = self._scalars(grads, state, gnorm)
        written = []
        try:
            _apply_walk(self._leaf, scalars, grads, state.mu, state.nu, params, written)
        except Exception as e:
            if not written:
                raise
            raise UpdateInterrupted(
                "the update failed part way: parameters and moments are partly "
                "written") from e
        return params, AdamState(step=step, mu=state.mu, nu=state.nu), gnorm

    def update_masked(self, grads: dict, state: AdamState, row_mask: torch.Tensor):
        """:meth:`update` restricted to the rows where the (N,) bool
        ``row_mask`` is True: the other rows get a zero update and keep
        their moments; the shared step still advances.  An all-True mask
        equals :meth:`update` bit for bit."""
        updates, new = self.update(grads, state)

        def sel(n, o):
            return torch.where(_row_mask(row_mask, n), n, o)

        return (tree_map(lambda u: sel(u, torch.zeros_like(u)), updates),
                AdamState(step=new.step,
                          mu=tree_map(sel, new.mu, state.mu),
                          nu=tree_map(sel, new.nu, state.nu)))


class UpdateInterrupted(RuntimeError):
    """:meth:`Adam.update_apply` failed after it began writing leaves."""


def _apply_walk(leaf, scalars, g, m, v, p, written: list):
    """``Adam.update_apply``'s walk: each leaf's new moments and parameter
    written over the old ones.  A gradient is popped only once its leaf's
    update is computed, and ``written`` gains an entry at the first write,
    so a failure before it leaves every tree whole."""
    for k in list(g):
        if isinstance(g[k], dict):
            _apply_walk(leaf, scalars, g[k], m[k], v[k], p[k], written)
            del g[k]
            continue
        mk, vk, u = leaf(g[k], m[k], v[k], p[k], *scalars)
        del g[k]
        written.append(k)
        m[k], v[k] = mk, vk
        p[k] = p[k] + u.to(p[k].dtype)


class SGDState(NamedTuple):
    step: torch.Tensor  # () int32
    momentum: dict


@dataclasses.dataclass(frozen=True)
class SGD:
    lr: float = 1e-2
    momentum: float = 0.0

    def init(self, params: dict) -> SGDState:
        return SGDState(
            step=torch.zeros((), dtype=torch.int32, device=_first_leaf(params).device),
            momentum=tree_map(torch.zeros_like, params))

    def update(self, grads: dict, state: SGDState, params: Optional[dict] = None):
        mom = tree_map(lambda m, g: _in(self.momentum, m.dtype) * m + g, state.momentum, grads)
        updates = tree_map(lambda m: _in(-self.lr, m.dtype) * m, mom)
        return updates, SGDState(step=state.step + 1, momentum=mom)


def _row_mask(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A (N,) row mask broadcast over a (N, ...) leaf."""
    return mask.reshape(mask.shape + (1,) * (x.ndim - 1))


def gather_rows(state: AdamState, idx: torch.Tensor) -> AdamState:
    """The moments' rows ``idx`` (a paged view's (M,) storage rows); the
    shared step passes through."""
    return AdamState(step=state.step,
                     mu={k: v.index_select(0, idx) for k, v in state.mu.items()},
                     nu={k: v.index_select(0, idx) for k, v in state.nu.items()})


def scatter_rows(full: AdamState, view: AdamState, idx: torch.Tensor) -> AdamState:
    """``full``'s moments with the view's rows written back at ``idx``; the
    step comes from the view."""
    return AdamState(step=view.step,
                     mu={k: v.index_copy(0, idx, view.mu[k]) for k, v in full.mu.items()},
                     nu={k: v.index_copy(0, idx, view.nu[k]) for k, v in full.nu.items()})


def apply_updates(params: dict, updates: dict) -> dict:
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)


def apply_updates_masked(params: dict, updates: dict,
                         row_mask: torch.Tensor) -> dict:
    """:func:`apply_updates` on the rows where ``row_mask`` is True.  The
    other rows return the original values through a select, not ``p + 0``
    (which turns ``-0.0`` into ``+0.0``), so they keep their bits."""
    return tree_map(lambda p, u: torch.where(_row_mask(row_mask, p), p + u.to(p.dtype), p),
                    params, updates)


def cosine_schedule(base_lr: float, warmup: int, total: int, floor: float = 0.1):
    """Linear warmup then cosine decay to ``floor * base_lr``: a function of
    the () int step giving a () float32 learning rate."""

    def lr(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        warm = base_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor * base_lr + (1 - floor) * base_lr * 0.5 * (1 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, cos)

    return lr
