"""Training step and fault-tolerant training loop (the port of
``repro/train/trainer.py``).

``make_train_step`` builds the (loss, params, opt_state) update with
gradient-accumulation microbatching (``cfg.microbatches``) and optional
gradient compression (gradients cast to bf16, as the reference does before
its cross-replica reduction).  The gradients come from autograd through
``Model.loss_fn``; a step consumes the parameters and optimizer state it is
given (``Adam.update_apply`` writes each new leaf over the old one).

On DTensor parameters (a sharded step, ``launch/dryrun.build_case``) the
parameters are put in their compute layout once a step (``models/
sharded.py``: FSDP dims gathered, so a rank holds its share of every
leaf for the whole step), each microbatch's gradients come from the
model run on every rank's local shards and are then synced explicitly: each leaf's local
gradient, a partial sum over the batch axes, is cast to its wire dtype and
redistributed to ``grad_specs``, so on an FSDP leaf the sync is a
reduce-scatter onto the leaf's shard.  The wire dtype is bf16 with
``grad_compression="bf16"`` (2 bytes an element, the reference's
compression) and float32 without it.  The batch is split into microbatches
on ``microbatch_specs`` by one all-to-all of its rows over the batch axes
(``_split_batch``), so every microbatch stays sharded over them and holds
the reference's rows whatever the data degree and microbatch count.
Adam then updates the DTensor leaves in place, clipping by the global norm
of the whole sharded tree.

``Trainer`` is the loop: periodic, final and emergency checkpoints
(``train/checkpoint.py``, the reference's format; no emergency checkpoint
when the in-place update failed after writing a leaf, which leaves the
state half written), crash resume from the latest checkpoint, a
straggler watchdog (an EMA of step wall time; steps slower than
``straggler_factor`` x the EMA are counted) and ``history``.
It runs on the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import local
from repro_torch.distributed.sharding import placements
from repro_torch.models import sharded
from repro_torch.models.lm import BF16, Model, init_params
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train.data import device_batch
from repro_torch.train.optimizer import (
    Adam, UpdateInterrupted, tree_leaves, tree_map, tree_unflatten)


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def loss_and_grads(model: Model, params: dict, batch: dict):
    """``jax.value_and_grad(model.loss_fn)(params, batch)``: the () float32
    loss (detached) and a gradient tree like ``params`` (zeros for a leaf
    the loss does not read)."""
    with torch.enable_grad():
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss = model.loss_fn(live, batch)
        leaves = tree_leaves(live)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    del live
    grads = [torch.zeros_like(p.detach()) if g is None else g for g, p in zip(grads, leaves)]
    return loss.detach(), tree_unflatten(params, grads)


def _sharded_grads(model: Model, call, params, batch, grad_specs, wire: torch.dtype):
    """(the loss, gradients like ``params``) of one (micro)batch on DTensors,
    the parameters' local tensors taken from ``call`` (``sharded.localize``,
    once a step): local gradients synced in ``wire`` onto ``grad_specs``
    (the parameters' own placements where None), in the parameters' dtypes."""
    from torch.distributed.tensor import DTensor

    rows = {k: v.to_local() for k, v in batch.items()}
    with local.local_mode(call.mesh, call.dp, call.model_axis):
        loss, grads = loss_and_grads(model, call.params, rows)
    names = call.mesh.mesh_dim_names
    specs = tree_map(lambda p: p.placements, params) if grad_specs is None else \
        tree_map(lambda s: placements(names, s), grad_specs)

    def sync(g, layout, p, target):
        g = DTensor.from_local(g.to(wire), call.mesh, sharded.grad_layout(call, layout),
                               run_check=False, shape=p.shape, stride=p.stride())
        return g.redistribute(call.mesh, target).to(p.dtype)

    return loss, tree_map(sync, grads, call.layouts, params, specs)


def _split_batch(batch: dict, mb: int, microbatch_specs) -> list:
    """The mb microbatches of a DTensor batch, as the reference's reshape
    (B, ...) -> (mb, B/mb, ...) gives them: microbatch i holds the global
    rows [i·B/mb, (i+1)·B/mb), laid out on ``microbatch_specs`` (the batch
    axes on dim 1) where given, then one microbatch at a time."""
    out = {}
    for k, v in batch.items():
        if microbatch_specs is None:
            out[k] = v.reshape((mb, v.shape[0] // mb) + tuple(v.shape[1:]))
            continue
        dm = v.device_mesh
        target = placements(dm.mesh_dim_names, microbatch_specs[k])
        axes = _shard_axes(v.placements, dm, 0)
        if axes != _shard_axes(target, dm, 1):
            raise ValueError(f"{k}: rows on {axes}, its microbatches' on "
                             f"{_shard_axes(target, dm, 1)}")
        out[k] = _rows_to_microbatches(v, axes, mb, target)
    return [{k: v[i] for k, v in out.items()} for i in range(mb)]


def _shard_axes(placed, dm, dim: int) -> tuple:
    """The mesh axes that shard tensor dim ``dim``, in mesh order."""
    from torch.distributed.tensor import Shard

    return tuple(a for a, p in zip(dm.mesh_dim_names, placed) if p == Shard(dim))


def _rows_to_microbatches(v, axes: tuple, mb: int, target):
    """``v`` (B, ...) sharded on ``axes`` as (mb, B/mb, ...) sharded on dim 1
    over the same axes, by one all-to-all of rows over ``axes`` (with no
    axes, or one rank on them, nothing moves): DTensor cannot unflatten
    the sharded dim where mb is not a multiple of the axes' degree (16
    data ranks and 8 microbatches on a 16x16 mesh).

    Of B rows over D ranks, rank d holds rows [d·c, (d+1)·c), c = B/D, and
    must end with rows i·n + d·r + [0, r) of every microbatch i (n = B/mb,
    r = n/D): it sends each of its rows to rank (row mod n) // r, in row
    order, and receives them in row order, which is microbatch by
    microbatch.  Only rows move, so each microbatch sums the rows it did."""
    import numpy as np
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import _disable_current_modes

    dm = v.device_mesh
    big, d, group = 1, 0, None
    if axes:
        with _disable_current_modes():   # the mesh's own bookkeeping, real even in a fake run
            group = dm.get_group(axes[0]) if len(axes) == 1 else dm[axes]._flatten().get_group()
        big, d = dist.get_world_size(group), dist.get_rank(group)
    b, local = v.shape[0], v.to_local()
    if b % mb or (b // mb) % big:
        raise ValueError(f"{b} rows do not split into {mb} microbatches over {big} ranks")
    got = local   # one rank holds every row: nothing moves
    if big > 1:
        c, n = b // big, b // mb
        r = n // big
        dest = (np.arange(d * c, (d + 1) * c) % n) // r
        want = (np.arange(mb)[:, None] * n + d * r + np.arange(r)[None, :]).ravel()
        # the local rows grouped by destination: runs of consecutive rows, each
        # with one destination, in destination order
        cuts = [0] + [i for i in range(1, c) if dest[i] != dest[i - 1]] + [c]
        runs = sorted(zip(cuts[:-1], cuts[1:]), key=lambda se: dest[se[0]])
        send = torch.cat([local[s:e] for s, e in runs]) if len(runs) > 1 else local
        got = local.new_empty((mb * r,) + tuple(local.shape[1:]))
        dist.all_to_all_single(got, send.contiguous(),
                               np.bincount(want // c, minlength=big).tolist(),
                               np.bincount(dest, minlength=big).tolist(), group=group)
    shape = (mb, b // mb) + tuple(v.shape[1:])
    return DTensor.from_local(got.reshape((mb, -1) + tuple(local.shape[1:])), dm, target,
                              run_check=False, shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())


def make_train_step(model: Model, opt, microbatches: int = 1,
                    grad_compression: str = "none", microbatch_specs=None, grad_specs=None):
    """Returns step(params, opt_state, batch) -> (metrics, params,
    opt_state); ``metrics`` holds the () float32 ``loss`` and ``grad_norm``
    on the device.  The step consumes ``params`` and ``opt_state``.

    On DTensors (see the module's docstring) ``microbatch_specs`` are the
    split batch's specs, (mb, B/mb, ...) with the batch axes on dim 1, and
    ``grad_specs`` the specs each microbatch's gradients are synced onto:
    the reference's two sharding constraints."""

    def compress(g):
        if grad_compression == "bf16":
            return tree_map(lambda a: a.to(BF16), g)
        return g

    def grads_of(params, batch):
        """The step's (loss, gradients): averaged over the microbatches,
        each compressed as ``grad_compression`` says."""
        if _is_dtensor(batch["tokens"]):
            wire = BF16 if grad_compression == "bf16" else torch.float32
            call = sharded.localize(model.cfg, params, batch)

            def one(b):
                return _sharded_grads(model, call, params, b, grad_specs, wire)

            parts = [batch] if microbatches == 1 else \
                _split_batch(batch, microbatches, microbatch_specs)
        else:
            def one(b):
                return loss_and_grads(model, params, b)

            mb = microbatches
            split = {k: v.reshape((mb, v.shape[0] // mb) + v.shape[1:]) for k, v in batch.items()}
            parts = [batch] if mb == 1 else [{k: v[i] for k, v in split.items()} for i in range(mb)]
        if microbatches == 1:
            loss, grads = one(parts[0])
            return loss, compress(grads)
        # accumulated in the parameters' dtype, as the reference's
        # zeros_like(params) carry
        grads = tree_map(torch.zeros_like, params)
        loss = torch.zeros((), dtype=torch.float32, device=batch["tokens"].device)
        for part in parts:
            l, g = one(part)
            tree_map(lambda a, b: a.add_(b.to(a.dtype)), grads, compress(g))
            loss = loss + l
            del g
        loss = loss / microbatches
        tree_map(lambda g: g.div_(microbatches), grads)
        return loss, grads

    def apply(loss, grads, params, opt_state):
        """The step's update from ``grads_of``'s output (``grads`` consumed)."""
        if not _is_dtensor(tree_leaves(params)[0]):
            params, opt_state, gnorm = opt.update_apply(grads, opt_state, params)
            return {"loss": loss, "grad_norm": gnorm}, params, opt_state
        from torch.distributed.tensor.experimental import implicit_replication

        # Adam's scalars are plain tensors: on DTensor leaves they are replicated
        with implicit_replication():
            params, opt_state, gnorm = opt.update_apply(grads, opt_state, params)
        return {"loss": loss, "grad_norm": gnorm.full_tensor()}, params, opt_state

    def step(params, opt_state, batch):
        return apply(*grads_of(params, batch), params, opt_state)

    # its two halves, for a caller that reads the gradients in between
    step.grads, step.apply = grads_of, apply
    return step


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    log_every: int = 10
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    straggler_factor: float = 3.0
    grad_compression: str = "none"
    lr: float = 3e-4
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    seed: int = 0


class Trainer:
    def __init__(self, cfg: ArchConfig, tcfg: TrainerConfig, data_iter, mesh=None,
                 shardings=None, device=None):
        # ``mesh`` is kept and ``shardings`` taken and unused, as in the reference
        self.cfg = cfg
        self.tcfg = tcfg
        self.data_iter = data_iter
        self.mesh = mesh
        self.device = resolve_device(device)
        self.model = Model(cfg)
        self.opt = Adam(lr=tcfg.lr, weight_decay=tcfg.weight_decay,
                        clip_norm=tcfg.clip_norm)
        self.step_fn = make_train_step(self.model, self.opt, cfg.microbatches,
                                       tcfg.grad_compression)
        self.step_times: list[float] = []
        self.straggler_events: list[int] = []
        self.history: list[dict] = []

    def init_state(self, device=None):
        """Parameters drawn on a generator seeded with ``tcfg.seed`` on the
        trainer's device (or ``device``), Adam's zero moments, step 0."""
        dev = self.device if device is None else torch.device(device)
        gen = torch.Generator(device="cpu" if dev.type == "meta" else dev)
        gen.manual_seed(self.tcfg.seed)
        params = init_params(self.cfg, gen, device=dev)
        return {"params": params, "opt": self.opt.init(params), "step": 0}

    def run(self, state=None, on_step: Optional[Callable] = None):
        tcfg = self.tcfg
        if state is None and tcfg.ckpt_dir and ckpt_lib.latest_step(tcfg.ckpt_dir) is not None:
            template = self.init_state(device="meta")       # crash resume
            state = ckpt_lib.restore(tcfg.ckpt_dir, template=template, device=self.device)
        if state is None:
            state = self.init_state()

        params, opt_state, start = state["params"], state["opt"], state["step"]
        ema = None
        for step in range(start, tcfg.steps):
            batch = device_batch(next(self.data_iter), self.device)
            t0 = time.time()
            whole_at = step     # the step the state in hand stands at
            try:
                metrics, params, opt_state = self.step_fn(params, opt_state, batch)
                whole_at = step + 1
                # one read of the device for the step's metrics
                values = torch.stack([metrics[k] for k in metrics]).tolist()
                metrics = dict(zip(metrics, values))
            except UpdateInterrupted:
                # The state is half written (the update runs in place), so
                # nothing is saved: a restart resumes from the last checkpoint.
                raise
            except Exception:
                # Emergency checkpoint before surfacing the failure so a
                # restarted job loses at most one step.
                if tcfg.ckpt_dir:
                    ckpt_lib.save(tcfg.ckpt_dir,
                                  {"params": params, "opt": opt_state, "step": whole_at})
                raise
            dt = time.time() - t0
            self.step_times.append(dt)
            # Straggler watchdog: EMA of step time, flag outliers.
            if ema is None:
                ema = dt
            else:
                if dt > tcfg.straggler_factor * ema and step > start + 2:
                    self.straggler_events.append(step)
                ema = 0.9 * ema + 0.1 * dt
            self.history.append({"step": step, **metrics, "time_s": dt})
            if on_step:
                on_step(step, metrics)
            if tcfg.ckpt_dir and (step + 1) % tcfg.ckpt_every == 0:
                ckpt_lib.save(tcfg.ckpt_dir,
                              {"params": params, "opt": opt_state, "step": step + 1})
        if tcfg.ckpt_dir:
            ckpt_lib.save(tcfg.ckpt_dir,
                          {"params": params, "opt": opt_state, "step": tcfg.steps})
        return {"params": params, "opt": opt_state, "step": tcfg.steps}
