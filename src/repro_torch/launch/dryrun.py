"""The sharded train, prefill and decode steps of one (arch, shape, mesh)
cell: the port of ``repro.launch.dryrun``'s ``input_specs``,
``abstract_state`` and ``build_case``.

The reference builds each cell's step under explicit shardings and lowers
and compiles it on the production meshes (``run_case`` and the compile
matrix, which read XLA's memory and cost analyses and its HLO).  The port
runs the cell instead: the reference's ``jax.eval_shape`` stand-ins become
real tensors drawn from a seed, placed on the mesh by the same specs
(``distributed/sharding.py``), and ``build_case`` returns the step as a
function to call.  ``run_case`` and the compile matrix are not ported.

The mesh must carry a ``DeviceMesh`` (a process group of the mesh's size
is up, ``launch/mesh.py``).  ``build_case`` sets ``distributed/ctx.py``'s
axes as the reference does and leaves them set; the caller clears them.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.distributed import ctx, sharding
from repro_torch.launch.mesh import axis_size, dp_axes
from repro_torch.models import sharded
from repro_torch.models.lm import Model, init_params
from repro_torch.train.data import synthetic_batch
from repro_torch.train.optimizer import Adam
from repro_torch.train.trainer import make_train_step


def abstract_state(cfg: ArchConfig, with_opt: bool, device=None, seed: int = 0):
    """(parameters, Adam's state or None): real tensors on ``device`` (the
    card unless the caller asks for the CPU), the parameters drawn from a
    generator seeded with ``seed``, where the reference takes shapes only."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = init_params(cfg, gen, device=dev)
    if not with_opt:
        return params, None
    return params, Adam(lr=1e-4).init(params)


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    """Every model input of this cell as a ``meta`` tensor (its shape and
    dtype: the reference's ``ShapeDtypeStruct``)."""
    b, s = shape.global_batch, shape.seq_len

    def spec(*dims, dtype=torch.float32):
        return torch.empty(dims, dtype=dtype, device="meta")

    if shape.kind == "decode":
        return {"tokens": spec(b, 1, dtype=torch.int32)}
    toks = s - (cfg.patch_tokens if cfg.family == "vlm" else 0)
    specs = {"tokens": spec(b, toks, dtype=torch.int32)}
    if cfg.family == "vlm":
        specs["patches"] = spec(b, cfg.patch_tokens, cfg.d_model)
    if cfg.family == "encdec":
        specs["frames"] = spec(b, cfg.encoder_seq, cfg.d_model)
    return specs


def draw_inputs(cfg: ArchConfig, shape: ShapeSpec, device, seed: int = 0) -> dict:
    """The inputs ``input_specs`` describes, drawn from ``seed``: the
    synthetic token stream (``train/data.py``) for a train or prefill cell,
    uniform tokens for a decode cell."""
    if shape.kind == "decode":
        rng = np.random.default_rng(seed)
        arrays = {"tokens": rng.integers(0, cfg.vocab_size, size=(shape.global_batch, 1),
                                         dtype=np.int32)}
    else:
        arrays = synthetic_batch(cfg, shape, 0, seed)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in arrays.items()}


def microbatch_count(cfg: ArchConfig, shape: ShapeSpec, dp_size: int) -> int:
    """The reference's mesh-aware microbatch count: each microbatch's rows
    stay divisible by the data-parallel degree."""
    return max(min(cfg.microbatches, shape.global_batch // dp_size), 1)


def build_case(cfg: ArchConfig, shape: ShapeSpec, mesh, seed: int = 0):
    """Returns ``(fn, args)``: ``fn(*args)`` runs the cell's step on the
    mesh, with ``args`` placed by the reference's specs.

    train    ``fn(params, opt_state, batch) -> (metrics, params, opt_state)``,
             the microbatched AdamW step (it consumes its state);
    prefill  ``fn(params, batch) -> (logits, caches)``;
    decode   ``fn(params, cache, tokens) -> (logits, cache)``, the cache in
             and out on ``cache_specs`` (the input is consumed)."""
    if cfg.pure_dp and shape.global_batch % math.prod(mesh.devices.shape) != 0:
        # pure DP pays only when the batch fills the whole mesh
        cfg = dataclasses.replace(cfg, pure_dp=False)

    dp = dp_axes(mesh)
    dp_size = math.prod(axis_size(mesh, a) for a in dp)
    if cfg.pure_dp:  # the model axis carries batch too
        dp = dp + ("model",)
        dp_size *= axis_size(mesh, "model")
    ctx.set_dp_axes(dp, dp_size)
    ctx.set_model_axis("model", axis_size(mesh, "model"))
    ctx.set_seq_axis("model" if cfg.seq_parallel else None, axis_size(mesh, "model"))

    model = Model(cfg)
    dev = torch.device(mesh.device_type)
    batch = draw_inputs(cfg, shape, dev, seed)
    batch = sharding.shard_tree(batch, mesh, sharding.batch_specs(cfg, batch, mesh))

    if shape.kind == "train":
        params, opt_state = abstract_state(cfg, True, dev, seed)
        p_specs = sharding.param_specs(cfg, params, mesh)
        o_specs = sharding.opt_specs(cfg, params, mesh)
        opt = Adam(lr=1e-4, weight_decay=0.01, clip_norm=1.0)
        mb = microbatch_count(cfg, shape, dp_size)
        # post-split microbatch specs: (mb, B/mb, ...) with the batch on DP
        mb_specs = None
        if mb > 1:
            inner = {k: torch.empty((v.shape[0] // mb,) + tuple(v.shape[1:]), device="meta")
                     for k, v in batch.items()}
            mb_specs = {k: sharding.P(None, *s)
                        for k, s in sharding.batch_specs(cfg, inner, mesh).items()}
        step = make_train_step(model, opt, mb, microbatch_specs=mb_specs, grad_specs=p_specs)
        return step, (sharding.shard_tree(params, mesh, p_specs),
                      sharding.shard_tree(opt_state, mesh, o_specs), batch)

    params, _ = abstract_state(cfg, False, dev, seed)
    params = sharding.shard_tree(params, mesh, sharding.param_specs(cfg, params, mesh))

    if shape.kind == "prefill":
        return (lambda p, b: sharded.prefill(model, p, b)), (params, batch)

    # decode: one new token against a seq_len-deep cache
    cache = model.cache_struct(shape.global_batch, shape.seq_len, device=dev)
    c_specs = sharding.cache_specs(cfg, cache, mesh)
    c_sh = sharding.to_shardings(mesh, c_specs)

    def decode(p, c, tokens):
        logits, c = sharded.decode_step(model, p, c, tokens)
        return logits, sharding.redistribute_tree(c, c_sh)

    return decode, (params, sharding.shard_tree(cache, mesh, c_specs), batch["tokens"])
