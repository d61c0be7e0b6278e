"""Sharding rules for every architecture (DP / FSDP / TP / EP / SP), the
port of ``repro.distributed.sharding``.

Policy (per-arch knobs in ArchConfig):
  * TP ("model" axis): attention heads, FFN hidden, vocab, MoE experts (EP).
  * FSDP ("data" axis, cfg.fsdp=True): the *other* matmul dim of each large
    parameter additionally sharded for storage.  Params replicate across
    the "pod" axis — FSDP within pod, pure DP across pods.
  * DP ("pod" x "data"): batch dims of inputs and caches.
  * SP: decode KV caches are sequence-sharded on "model".

Every rule degrades to replication when a dim is not divisible by the axis
size.  The rules read only the config, each leaf's shape and the mesh's
axis names and sizes, so they take trees of ``meta`` tensors (a full-size
llama3-405b costs no memory) and stand-in meshes.

A :class:`PartitionSpec` has one entry per tensor dimension: ``None``
(replicated), an axis name, or a tuple of names (the dimension split over
those mesh axes, the first the major).  :func:`to_shardings` turns specs
into ``DTensor`` placements on a mesh's ``DeviceMesh`` and
:func:`shard_tree` distributes a tree of tensors onto them, the port's
``jax.device_put(x, NamedSharding(mesh, spec))``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.mesh import axis_size, dp_axes


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``: ``P("data", None, ("pod", "data"))``.
    A one-name tuple is stored as the name, as JAX stores it."""

    def __new__(cls, *entries):
        return super().__new__(cls, (e[0] if isinstance(e, tuple) and len(e) == 1 else e
                                     for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def _div(mesh, axis, n) -> bool:
    return axis is not None and n % max(axis_size(mesh, axis), 1) == 0


def _maybe(mesh, axis, n):
    return axis if _div(mesh, axis, n) else None


def _dp_or_none(mesh, n, extra_model: bool = False):
    """All DP axes if the dim divides their product, else replicate.
    ``extra_model``: pure-DP archs also spread batch over the model axis
    (falling back to plain DP when the batch doesn't divide that far)."""
    dp = dp_axes(mesh)
    candidates = []
    if extra_model and "model" in mesh.axis_names:
        candidates.append(dp + ("model",))
    candidates.append(dp)
    for axes in candidates:
        total = 1
        for a in axes:
            total *= axis_size(mesh, a)
        if axes and n % total == 0:
            return axes
    return None


# Role templates for UNSTACKED parameter shapes, keyed by leaf name.
# "tp" -> model axis, "fsdp" -> data axis (if cfg.fsdp), None -> replicate.
_PARAM_ROLES = {
    # name: roles per dim (matched from the right for stacked leaves)
    "embed": ("tp", "fsdp"),
    "lm_head": ("fsdp", "tp"),
    "wq": ("fsdp", "tp"), "wk": ("fsdp", "tp"), "wv": ("fsdp", "tp"),
    "xwq": ("fsdp", "tp"), "xwk": ("fsdp", "tp"), "xwv": ("fsdp", "tp"),
    "wo": ("tp", "fsdp"), "xwo": ("tp", "fsdp"),
    "w_in": ("fsdp", "tp"), "w_up": ("fsdp", "tp"),
    "w_out": ("tp", "fsdp"), "w_down": ("tp", "fsdp"),
    "w_gates": ("fsdp", "tp"),
    "conv_w": (None, "tp"),
    "dt_bias": ("tp",), "d_skip": ("tp",),
    "r_kernels": (None, None, None, None),  # small; sharding fought GSPMD
    "router": (None, None),
}
# MoE expert weights (3D unstacked): experts on model (EP).
_MOE_ROLES = {
    "wg": ("tp", "fsdp", None),
    "wu": ("tp", "fsdp", None),
    "wd": ("tp", None, "fsdp"),
}
# Dense MLP weights (2D unstacked).
_DENSE_MLP_ROLES = {
    "wg": ("fsdp", "tp"),
    "wu": ("fsdp", "tp"),
    "wd": ("tp", "fsdp"),
}


def _leaf_spec(cfg: ArchConfig, mesh, name: str, shape) -> P:
    nd = len(shape)
    if getattr(cfg, "pure_dp", False):
        return P()  # replicate everything; the model axis carries batch
    if name.startswith("ln") or name in ("final_ln",):
        return P()
    if name in ("wg", "wu", "wd"):
        if nd >= 3 and cfg.family == "moe":
            roles = _MOE_ROLES[name]
            if not cfg.fsdp_experts:
                roles = tuple(None if r == "fsdp" else r for r in roles)
        else:
            roles = _DENSE_MLP_ROLES[name]
    elif name in _PARAM_ROLES:
        roles = _PARAM_ROLES[name]
    else:
        return P()

    # Stacked leaves have a leading layer dim -> prepend replication.
    pad = nd - len(roles)
    roles = (None,) * pad + tuple(roles)
    axes = []
    for role, dim in zip(roles, shape):
        if role == "tp":
            axes.append(_maybe(mesh, "model", dim))
        elif role == "fsdp" and cfg.fsdp:
            axes.append(_maybe(mesh, "data", dim))
        else:
            axes.append(None)
    return P(*axes)


def _walk(fn, tree, *rest, name=None):
    """``fn(name, leaf, *rest_leaves)`` over nested dicts, NamedTuples,
    tuples and lists (a :class:`PartitionSpec` and None are leaves), each
    tree of ``rest`` having ``tree``'s containers; ``name`` is the nearest
    enclosing dict key (what the reference reads from a leaf's key path)."""
    if isinstance(tree, dict):
        return {k: _walk(fn, v, *(r[k] for r in rest), name=k if isinstance(k, str) else name)
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)) and not isinstance(tree, PartitionSpec):
        items = [_walk(fn, v, *(r[i] for r in rest), name=name) for i, v in enumerate(tree)]
        return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)
    return fn(name, tree, *rest)


def param_specs(cfg: ArchConfig, params_tree: Any, mesh) -> Any:
    """PartitionSpec tree matching ``params_tree`` (tensors, ``meta`` ones
    included: only shapes are read)."""
    return _walk(lambda name, leaf: _leaf_spec(cfg, mesh, name or "", leaf.shape), params_tree)


def opt_specs(cfg: ArchConfig, params_tree: Any, mesh):
    """AdamState sharding: moments mirror params, step replicated."""
    from repro_torch.train.optimizer import AdamState

    ps = param_specs(cfg, params_tree, mesh)
    return AdamState(step=P(), mu=ps, nu=ps)


def batch_specs(cfg: ArchConfig, batch: Any, mesh):
    xm = getattr(cfg, "pure_dp", False)

    def leaf(name, x):
        if name == "tokens":
            return P(_dp_or_none(mesh, x.shape[0], xm), None)
        if name in ("patches", "frames"):
            return P(_dp_or_none(mesh, x.shape[0], xm), None, None)
        return P()

    return _walk(leaf, batch)


def cache_specs(cfg: ArchConfig, cache: Any, mesh):
    """Decode-cache shardings: batch on DP, sequence on model (SP)."""

    def leaf(name, x):
        shape = x.shape
        nd = len(shape)
        if name == "len":
            return P()
        if name in ("k", "v", "xk", "xv"):
            # (L, B, T, KV, hd) stacked or (B, T, KV, hd) single block.
            t_idx = nd - 3
            b_idx = 1 if nd == 5 else 0
            axes = [None] * nd
            axes[b_idx] = _dp_or_none(mesh, shape[b_idx])
            axes[t_idx] = _maybe(mesh, "model", shape[t_idx])  # SP
            return P(*axes)
        if name in ("state", "nstate"):
            # (L, B, H, dk, dv): shard the first divisible inner dim on model.
            axes = [None] * nd
            axes[1] = _dp_or_none(mesh, shape[1])
            for i in range(2, nd):
                if _div(mesh, "model", shape[i]) and shape[i] > 1:
                    axes[i] = "model"
                    break
            return P(*axes)
        if name == "conv":
            axes = [None] * nd
            axes[1] = _dp_or_none(mesh, shape[1])
            axes[-1] = _maybe(mesh, "model", shape[-1])
            return P(*axes)
        if name in ("c", "n", "m", "h"):
            axes = [None] * nd
            axes[0] = _dp_or_none(mesh, shape[0])
            axes[-1] = _maybe(mesh, "model", shape[-1])
            return P(*axes)
        return P()

    return _walk(leaf, cache)


# ---------------------------------------------------------------------------
# specs to DTensor placements
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: ``jax.sharding.NamedSharding``."""
    mesh: Any
    spec: P

    @property
    def placements(self) -> tuple:
        return placements(self.mesh.axis_names, self.spec)


def placements(axis_names, spec: P) -> tuple:
    """One DTensor placement per mesh axis: ``Shard(d)`` where tensor
    dimension ``d``'s entry names the axis, else ``Replicate()``.  A tuple
    entry shards one dimension over several axes, which DTensor splits in
    mesh order, so the tuple must list them in that order."""
    from torch.distributed.tensor import Replicate, Shard

    axis_names = tuple(axis_names)
    out = [Replicate()] * len(axis_names)
    for d, entry in enumerate(spec):
        names = () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [axis_names.index(a) for a in names]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} is not in the mesh's axis order "
                             f"{axis_names}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"mesh axis {axis_names[i]!r} shards two dimensions in {spec}")
            out[i] = Shard(d)
    return tuple(out)


def to_shardings(mesh, specs: Any):
    """Each spec of ``specs`` as a :class:`NamedSharding` on ``mesh`` (a
    ``None`` stays ``None``)."""
    return _walk(lambda _, s: None if s is None else NamedSharding(mesh, s), specs)


def distribute(x, sharding: NamedSharding):
    """``x`` (every rank holding the whole tensor) as a DTensor on
    ``sharding``; its mesh must carry a ``DeviceMesh``."""
    from torch.distributed.tensor import distribute_tensor

    dm = sharding.mesh.device_mesh
    if dm is None:
        raise ValueError("the mesh has no DeviceMesh: start a process group whose "
                         "world size is the mesh's size before making the mesh")
    return distribute_tensor(x.to(dm.device_type), dm, sharding.placements)


def shard_tree(tree: Any, mesh, specs: Any):
    """Every leaf of ``tree`` distributed onto its spec in ``specs`` on
    ``mesh`` (a None spec leaves its leaf as it is):
    ``jax.device_put(tree, NamedSharding(mesh, specs))``."""
    return _walk(lambda _, x, s: x if s is None else distribute(x, NamedSharding(mesh, s)),
                 tree, specs)


def redistribute_tree(tree: Any, shardings: Any):
    """Every DTensor leaf of ``tree`` redistributed onto its
    :class:`NamedSharding` in ``shardings`` (a None leaves its leaf as it
    is): ``jax.jit``'s ``out_shardings``."""
    return _walk(lambda _, x, s: x if s is None else x.redistribute(
        s.mesh.device_mesh, s.placements), tree, shardings)
