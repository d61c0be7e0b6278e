"""Deterministic, seekable synthetic token pipeline.

Production property we actually need for fault tolerance: given (seed, step)
the batch is reproducible, so restore-from-checkpoint resumes mid-stream
without data loss or duplication (the iterator is seekable by construction
— no shared filesystem state). The "corpus" is a Zipf-ish unigram stream
with Markov bigram structure so smoke-test losses have signal to descend.

The port's copy of ``repro.train.data``: numpy only, the same batches bit
for bit (``hash`` of a tuple of ints does not depend on ``PYTHONHASHSEED``).
Callers move the arrays to their device.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec


def synthetic_batch(cfg: ArchConfig, shape: ShapeSpec, step: int, seed: int = 0):
    rng = np.random.default_rng(hash((seed, step)) % (2**63))
    b, s = shape.global_batch, shape.seq_len
    v = cfg.vocab_size
    # Markov-ish stream: next token = (3 * prev + noise) mod V.
    noise = rng.integers(0, max(v // 8, 2), size=(b, s), dtype=np.int64)
    tokens = np.zeros((b, s), dtype=np.int64)
    tokens[:, 0] = rng.integers(0, v, size=(b,))
    for t in range(1, s):
        tokens[:, t] = (3 * tokens[:, t - 1] + noise[:, t]) % v
    batch = {"tokens": tokens.astype(np.int32)}
    if cfg.family == "vlm":
        batch["tokens"] = batch["tokens"][:, : s - cfg.patch_tokens]
        batch["patches"] = rng.standard_normal(
            (b, cfg.patch_tokens, cfg.d_model), dtype=np.float32
        )
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model), dtype=np.float32
        )
    return batch


def data_iterator(cfg: ArchConfig, shape: ShapeSpec, seed: int = 0,
                  start_step: int = 0) -> Iterator[dict]:
    step = start_step
    while True:
        yield synthetic_batch(cfg, shape, step, seed)
        step += 1


def device_batch(batch: dict, device) -> dict:
    """A batch's numpy arrays as tensors on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}
