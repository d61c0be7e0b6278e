"""Serving entry point: batched prefill + greedy decode loop over ring caches.

``python -m repro_torch.launch.serve --arch xlstm-125m --prompt-len 32 --gen 16``

Runs on the card unless ``--device cpu`` is given; without a card the
default raises, it never falls back to the CPU.  As in the reference,
``--reduced`` is on whatever the command line says: the full widths are
served by calling :func:`serve` with the full config.
"""

from __future__ import annotations

import argparse
import time
from typing import NamedTuple

import torch

from repro_torch._device import resolve_device
from repro_torch.configs import get_arch, list_archs
from repro_torch.configs.base import ShapeSpec
from repro_torch.models.lm import Model, init_params
from repro_torch.train.data import device_batch, synthetic_batch


class Served(NamedTuple):
    tokens: torch.Tensor       # (B, gen + 1) greedy ids: prefill's, then each step's
    last_logits: torch.Tensor  # (B, 1, V) the last decode step's
    finite: torch.Tensor       # () bool: every logit of the run was finite
    prefill_s: float           # prefill + pad_cache, host clock to a device sync
    decode_s: float            # the gen decode steps, host clock to a device sync


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(model: Model, params: dict, batch: dict, gen: int) -> Served:
    """Prefill ``batch``, grow the ring caches by ``gen + 1`` slots, then
    decode ``gen`` tokens greedily.  Nothing in the loop reads the device;
    the two clocks end in a device sync."""
    dev = batch["tokens"].device
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, batch)
    cache = model.pad_cache(cache, model.prompt_len(batch) + gen + 1)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    finite = torch.isfinite(logits).all()
    toks = torch.argmax(logits, dim=-1)
    out = [toks]
    t0 = time.perf_counter()
    for _ in range(gen):
        logits, cache = model.decode_step(params, cache, toks)
        toks = torch.argmax(logits, dim=-1)
        finite = finite & torch.isfinite(logits).all()
        out.append(toks)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    return Served(torch.cat(out, dim=1), logits, finite, t_prefill, t_decode)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs on the CPU)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = Model(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = init_params(cfg, gen, device=dev)

    shape = ShapeSpec("serve", seq_len=args.prompt_len, global_batch=args.batch,
                      kind="prefill")
    batch = device_batch(synthetic_batch(cfg, shape, 0), dev)
    res = serve(model, params, batch, args.gen)

    print(f"prefill: {args.batch}x{args.prompt_len} tokens in {res.prefill_s:.3f}s")
    print(f"decode:  {args.gen} steps in {res.decode_s:.3f}s "
          f"({args.gen * args.batch / max(res.decode_s, 1e-9):.1f} tok/s)")
    print("generated token ids (first row):", res.tokens[0].tolist())
    return res


if __name__ == "__main__":
    main()
