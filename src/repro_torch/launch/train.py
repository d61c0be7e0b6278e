"""Training entry point: ``python -m repro_torch.launch.train --arch <id> [options]``.

The port of ``repro.launch.train``: data -> model -> optimizer ->
checkpoints -> metrics, on the --reduced config unless --full is given, with
the config's microbatches set to 1 as there.  It runs on the card unless
``--device cpu`` is given; without a card the default raises, it never
falls back to the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

from repro_torch.configs import get_arch, list_archs
from repro_torch.configs.base import ShapeSpec
from repro_torch.train.data import data_iterator
from repro_torch.train.trainer import Trainer, TrainerConfig


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--grad-compression", choices=["none", "bf16"], default="none")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--out", default=None, help="write history JSON here")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs on the CPU)")
    return ap.parse_args(argv)


def build(args, data_iter=None) -> Trainer:
    """The trainer the command line describes; its data is the synthetic
    stream of ``--batch`` x ``--seq-len`` unless ``data_iter`` is given."""
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, microbatches=1)

    shape = ShapeSpec("cli", seq_len=args.seq_len, global_batch=args.batch,
                      kind="train")
    tcfg = TrainerConfig(
        steps=args.steps, ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir,
        lr=args.lr, grad_compression=args.grad_compression,
        log_every=args.log_every,
    )
    data = data_iterator(cfg, shape) if data_iter is None else data_iter
    return Trainer(cfg, tcfg, data, device=args.device)


def main(argv=None) -> Trainer:
    args = parse_args(argv)
    trainer = build(args)

    def on_step(step, metrics):
        if step % args.log_every == 0:
            print(f"step {step:5d} loss {metrics['loss']:.4f} "
                  f"gnorm {metrics['grad_norm']:.3f}")

    trainer.run(on_step=on_step)
    print(f"done: {args.steps} steps, final loss "
          f"{trainer.history[-1]['loss']:.4f}, "
          f"stragglers flagged: {len(trainer.straggler_events)}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(trainer.history, f)
    return trainer


if __name__ == "__main__":
    main()
