"""The LM on sharded parameters: ``prefill``, ``decode_step`` and the local
gradients of ``loss_fn``, with every parameter a DTensor placed by
``distributed/sharding.py``'s specs (FSDP, TP and EP on a ("data",
"model") mesh, or pure DP).

DTensor cannot run the model itself (``distributed/local.py`` says why),
so each call is a local map, the port's ``shard_map`` of the model:

  in   each parameter is redistributed to its compute layout and its local
       tensor taken.  The layout replicates every mesh axis (FSDP's shards
       are gathered), except that on "model" a leaf already split on the
       dim the model runs per rank stays split: the heads of ``wq`` / ``wo``
       (and of ``wk`` / ``wv`` where the KV heads divide too), the FFN
       columns of ``wg`` / ``wu`` and rows of ``wd``, the experts of an MoE
       block.  Each batch leaf gives its local rows; the mesh axes it is
       sharded on are the call's batch axes.
  run  the model on those plain tensors under ``local.local_mode``.
  out  logits sharded on the batch axes; caches in their compute layout
       (:func:`_cache_layout`), which the caller redistributes to
       ``cache_specs``.  A decode step keeps a KV cache split on its slots
       over "model" where ``cache_specs`` splits it so: the cache moves
       between no ranks, and the model attends over each rank's block of
       slots (``distributed/local.py``).

The model's blocks take their per-rank branch from the shapes of the
weights they are given, so on a mesh of one rank (every layout whole) the
calls run the plain path on the same tensors.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import local
from repro_torch.models.lm import plan_groups

_SPLIT_KINDS = ("dense", "moe", "shared_attn", "enc_dense", "dec_cross")
_KV = ("k", "v", "xk", "xv")


def _heads_split(cfg: ArchConfig, m: int) -> bool:
    """Whether the attention runs its query heads per rank over ``m``
    "model" ranks: the heads divide, and each rank's heads read whole KV
    heads (the KV heads divide too, or a rank's block of query heads lies
    inside one KV head's group, or is made of whole groups)."""
    h, kv = cfg.num_heads, cfg.num_kv_heads
    if m <= 1 or h % m:
        return False
    hl, g = h // m, h // kv
    return kv % m == 0 or hl % g == 0 or g % hl == 0


def _split_dim(cfg: ArchConfig, kind, name: str, nd: int, m: int):
    """The dim of a parameter leaf that the model runs per "model" rank, or
    None where every rank needs it whole."""
    if kind not in _SPLIT_KINDS:
        return None
    heads = _heads_split(cfg, m)
    if name in ("wq", "xwq"):
        return nd - 1 if heads else None
    if name in ("wo", "xwo"):
        return nd - 2 if heads else None
    if name in ("wk", "wv", "xwk", "xwv"):
        return nd - 1 if heads and cfg.num_kv_heads % m == 0 else None
    if name in ("wg", "wu", "wd"):
        if kind == "moe":
            return nd - 3
        return nd - 2 if name == "wd" else nd - 1
    return None


def _placements(dm, entry) -> Tuple:
    """One placement per mesh axis: ``entry(axis_name, axis_size)``."""
    return tuple(entry(a, dm.size(i)) for i, a in enumerate(dm.mesh_dim_names))


def _param_layout(cfg: ArchConfig, kind, name: str, t, model_axis) -> Tuple:
    """The compute layout of the DTensor parameter ``t`` (see the module's
    docstring)."""
    from torch.distributed.tensor import Replicate, Shard

    def entry(axis, size):
        d = _split_dim(cfg, kind, name, t.ndim, size) if axis == model_axis else None
        here = t.placements[t.device_mesh.mesh_dim_names.index(axis)]
        return here if d is not None and here == Shard(d) else Replicate()

    return _placements(t.device_mesh, entry)


def _slots_split(dm, model_axis, name: str, t) -> bool:
    """Whether a decode step keeps KV cache leaf ``t`` split on its slots
    over "model", as ``cache_specs`` lays it out (sequence parallelism)."""
    if name not in _KV or model_axis is None:
        return False
    m = dm.size(dm.mesh_dim_names.index(model_axis))
    return m > 1 and t.shape[t.ndim - 3] % m == 0


def _cache_layout(cfg: ArchConfig, layouts: dict, dm, dp, model_axis, cache,
                  decode: bool = False) -> dict:
    """The compute layout of each leaf of a decode cache (global shapes):
    the batch dim on the batch axes; on "model", in a decode step, the
    slots of a KV leaf whose slots ``cache_specs`` splits there
    (:func:`_slots_split`), else the KV heads of a group whose ``wk`` is
    split there; the rest replicated."""
    from torch.distributed.tensor import Replicate, Shard

    key_of = {g.ckey: g.key for g in plan_groups(cfg)}

    def leaf(ckey, name, t):
        nd = t.ndim
        if name == "len":
            return _placements(dm, lambda a, n: Replicate())
        b = (1 if nd == 5 else 0) if name in _KV else (0 if name in ("c", "n", "m", "h") else 1)
        split = None
        if decode and _slots_split(dm, model_axis, name, t):
            split = nd - 3
        elif name in _KV:
            wk = layouts[key_of[ckey]]["xwk" if name.startswith("x") else "wk"]
            if any(p.is_shard() and a == model_axis for a, p in zip(dm.mesh_dim_names, wk)):
                split = nd - 2

        def entry(axis, size):
            if axis in dp:
                return Shard(b)
            return Shard(split) if split is not None and axis == model_axis else Replicate()

        return _placements(dm, entry)

    return {k: ({n: leaf(k, n, t) for n, t in v.items()} if isinstance(v, dict)
                else leaf(k, k, v)) for k, v in cache.items()}


class LocalCall(NamedTuple):
    mesh: Any               # the DeviceMesh
    dp: Tuple[str, ...]     # the batch axes
    model_axis: Any         # "model", or None where it carries batch or is absent
    params: dict            # local tensors in their compute layout
    layouts: dict           # each parameter's compute layout
    batch: dict             # local rows


def _local(t, placements):
    return t.redistribute(t.device_mesh, placements).to_local()


@torch.no_grad()
def localize(cfg: ArchConfig, params: dict, batch: dict) -> LocalCall:
    """Every rank's tensors for one call on the DTensor ``params`` and
    ``batch`` (see the module's docstring)."""
    from torch.distributed.tensor import DTensor, Shard

    tokens = batch["tokens"]
    leaf = params["embed"]
    dm = leaf.device_mesh
    names = dm.mesh_dim_names
    dp = tuple(a for a, p in zip(names, tokens.placements) if p == Shard(0)) \
        if isinstance(tokens, DTensor) else ()
    model_axis = "model" if "model" in names and "model" not in dp else None
    kinds = {g.key: g.kind for g in plan_groups(cfg)}
    layouts, lparams = {}, {}
    for k, v in params.items():
        if isinstance(v, dict):
            layouts[k] = {n: _param_layout(cfg, kinds[k], n, t, model_axis) for n, t in v.items()}
            lparams[k] = {n: _local(t, layouts[k][n]) for n, t in v.items()}
        else:
            layouts[k] = _param_layout(cfg, None, k, v, model_axis)
            lparams[k] = _local(v, layouts[k])
    lbatch = {k: v.to_local() if isinstance(v, DTensor) else v for k, v in batch.items()}
    return LocalCall(dm, dp, model_axis, lparams, layouts, lbatch)


def grad_layout(call: LocalCall, layout: Tuple) -> Tuple:
    """The placements of a local gradient of a leaf computed in ``layout``:
    a partial sum on the batch axes (each rank's rows' share), the
    compute layout elsewhere."""
    from torch.distributed.tensor import Partial

    return tuple(Partial() if a in call.dp else p
                 for a, p in zip(call.mesh.mesh_dim_names, layout))


def _out(t, dm, placements):
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(t, dm, placements, run_check=False)


def _batch_placements(call: LocalCall) -> Tuple:
    from torch.distributed.tensor import Replicate, Shard

    return _placements(call.mesh, lambda a, n: Shard(0) if a in call.dp else Replicate())


def _cache_out(model, call: LocalCall, cache: dict, lay=None) -> dict:
    if lay is None:
        lay = _cache_layout(model.cfg, call.layouts, call.mesh, call.dp, call.model_axis, cache)
    return {k: ({n: _out(t, call.mesh, lay[k][n]) for n, t in v.items()} if isinstance(v, dict)
                else _out(v, call.mesh, lay[k])) for k, v in cache.items()}


def prefill(model, params: dict, batch: dict):
    """``model.prefill`` on DTensor parameters and batch: (logits sharded
    on the batch axes, the caches in their compute layout)."""
    call = localize(model.cfg, params, batch)
    with local.local_mode(call.mesh, call.dp, call.model_axis):
        logits, cache = model.prefill(call.params, call.batch)
    return _out(logits, call.mesh, _batch_placements(call)), _cache_out(model, call, cache)


def decode_step(model, params: dict, cache: dict, tokens):
    """``model.decode_step`` on DTensor parameters, cache and tokens: the
    cache is redistributed to its compute layout (consumed where that is
    its layout already, as the plain step consumes its cache); returns
    (logits sharded on the batch axes, the cache in its compute layout)."""
    call = localize(model.cfg, params, {"tokens": tokens})
    lay = _cache_layout(model.cfg, call.layouts, call.mesh, call.dp, call.model_axis, cache,
                        decode=True)
    split = {n for v in cache.values() if isinstance(v, dict) for n, t in v.items()
             if _slots_split(call.mesh, call.model_axis, n, t)}
    if any(_slots_split(call.mesh, call.model_axis, n, t) != (n in split)
           for v in cache.values() if isinstance(v, dict) for n, t in v.items() if n in _KV):
        raise ValueError("decode cache leaves of one name differ in whether their slots split "
                         "over the model axis")
    with torch.no_grad():
        lcache = {k: ({n: _local(t, lay[k][n]) for n, t in v.items()} if isinstance(v, dict)
                      else _local(v, lay[k])) for k, v in cache.items()}
    with local.local_mode(call.mesh, call.dp, call.model_axis, kv_split=tuple(split)):
        logits, lcache = model.decode_step(call.params, lcache, call.batch["tokens"])
    return (_out(logits, call.mesh, _batch_placements(call)),
            _cache_out(model, call, lcache, lay))
