"""Training step and fault-tolerant training loop (the port of
``repro/train/trainer.py``).

``make_train_step`` builds the (loss, params, opt_state) update with
gradient-accumulation microbatching (``cfg.microbatches``) and optional
gradient compression (gradients cast to bf16, as the reference does before
its cross-replica reduction).  The gradients come from autograd through
``Model.loss_fn``; a step consumes the parameters and optimizer state it is
given (``Adam.update_apply`` writes each new leaf over the old one).

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
from repro_torch.models.lm import BF16, Model, init_params
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train.data import device_batch
from repro_torch.train.optimizer import (
    Adam, UpdateInterrupted, tree_leaves, tree_map, tree_unflatten)


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


def make_train_step(model: Model, opt, microbatches: int = 1,
                    grad_compression: str = "none"):
    """Returns step(params, opt_state, batch) -> (metrics, params,
    opt_state); ``metrics`` holds the () float32 ``loss`` and ``grad_norm``
    on the device.  The step consumes ``params`` and ``opt_state``."""

    def compress(g):
        if grad_compression == "bf16":
            return tree_map(lambda a: a.to(BF16), g)
        return g

    def step(params, opt_state, batch):
        if microbatches == 1:
            loss, grads = loss_and_grads(model, params, batch)
            grads = compress(grads)
        else:
            mb = microbatches
            batches = {k: v.reshape((mb, v.shape[0] // mb) + v.shape[1:])
                       for k, v in batch.items()}
            # accumulated in the parameters' dtype, as the reference's
            # zeros_like(params) carry
            grads = tree_map(torch.zeros_like, params)
            loss = torch.zeros((), dtype=torch.float32, device=batch["tokens"].device)
            for i in range(mb):
                l, g = loss_and_grads(model, params, {k: v[i] for k, v in batches.items()})
                tree_map(lambda a, b: a.add_(b.to(a.dtype)), grads, compress(g))
                loss = loss + l
                del g
            loss = loss / mb
            tree_map(lambda g: g.div_(mb), grads)
        params, opt_state, gnorm = opt.update_apply(grads, opt_state, params)
        return {"loss": loss, "grad_norm": gnorm}, params, opt_state

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
    def __init__(self, cfg: ArchConfig, tcfg: TrainerConfig, data_iter, device=None):
        self.cfg = cfg
        self.tcfg = tcfg
        self.data_iter = data_iter
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
