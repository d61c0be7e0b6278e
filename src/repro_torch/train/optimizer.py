"""Functional Adam (counterpart of ``repro/train/optimizer.py``'s ``Adam``).

``init(params) -> AdamState`` and ``update(grads, state) -> (updates,
state)`` over dicts of tensors.  The expression order is the reference's:
``a = lr / bc1`` and ``rsqrt(bc2)`` as float32 scalars, then
``-a * m / (sqrt(v) * rsqrt(bc2) + eps)`` per leaf.  ``torch.optim.Adam``
orders the bias correction differently and is not used.

The row-masked forms (:meth:`Adam.update_masked`,
:func:`apply_updates_masked`) serve sparse stable/unstable mapping: rows
outside the mask get a zero update, keep their moments and keep their
parameter bits.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch._device import constant


class AdamState(NamedTuple):
    step: torch.Tensor  # () int32
    mu: dict
    nu: dict


@dataclasses.dataclass(frozen=True)
class Adam:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params: dict) -> AdamState:
        any_leaf = next(iter(params.values()))
        return AdamState(
            step=torch.zeros((), dtype=torch.int32, device=any_leaf.device),
            mu={k: torch.zeros_like(p) for k, p in params.items()},
            nu={k: torch.zeros_like(p) for k, p in params.items()},
        )

    def update(self, grads: dict, state: AdamState):
        step = state.step + 1
        mu = {k: self.b1 * state.mu[k] + (1 - self.b1) * g for k, g in grads.items()}
        nu = {k: self.b2 * state.nu[k] + (1 - self.b2) * g * g
              for k, g in grads.items()}
        stepf = step.to(torch.float32)
        bc1 = 1.0 - constant(self.b1, torch.float32, step.device) ** stepf
        bc2 = 1.0 - constant(self.b2, torch.float32, step.device) ** stepf
        a = constant(self.lr, torch.float32, step.device) / bc1
        inv_sqrt_bc2 = torch.rsqrt(bc2)
        updates = {k: -a * mu[k] / (torch.sqrt(nu[k]) * inv_sqrt_bc2 + self.eps)
                   for k in grads}
        return updates, AdamState(step=step, mu=mu, nu=nu)

    def update_masked(self, grads: dict, state: AdamState,
                      row_mask: torch.Tensor):
        """:meth:`update` restricted to the rows where the (N,) bool
        ``row_mask`` is True: the other rows get a zero update and keep
        their moments; the shared step still advances.  An all-True mask
        equals :meth:`update` bit for bit."""
        updates, new = self.update(grads, state)

        def sel(n, o):
            return torch.where(_row_mask(row_mask, n), n, o)

        return ({k: sel(u, torch.zeros_like(u)) for k, u in updates.items()},
                AdamState(step=new.step,
                          mu={k: sel(v, state.mu[k]) for k, v in new.mu.items()},
                          nu={k: sel(v, state.nu[k]) for k, v in new.nu.items()}))


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
    return {k: p + updates[k] for k, p in params.items()}


def apply_updates_masked(params: dict, updates: dict,
                         row_mask: torch.Tensor) -> dict:
    """:func:`apply_updates` on the rows where ``row_mask`` is True.  The
    other rows return the original values through a select, not ``p + 0``
    (which turns ``-0.0`` into ``+0.0``), so they keep their bits."""
    return {k: torch.where(_row_mask(row_mask, p), p + updates[k], p)
            for k, p in params.items()}
