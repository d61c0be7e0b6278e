"""Architecture + shape configuration system (the port's copy of
``repro.configs.base``, field for field, so a config means the same in both
packages).

Every assigned architecture registers an ``ArchConfig`` here; the launcher
selects with ``--arch <id>``. ``reduced()`` returns the same family scaled to
CPU-smoke size (small layers/width/experts/vocab) for the per-arch smoke
tests and the card-vs-CPU checks; the one-card serving path runs the full
configs whose weights fit one card.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    # --- attention pattern ---
    sliding_window: int = 0     # 0 = full attention
    local_global_ratio: int = 0  # gemma3: N local layers per 1 global
    # --- MoE ---
    num_experts: int = 0
    top_k: int = 0
    moe_capacity_factor: float = 1.25
    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_heads: int = 0          # mamba2 value heads (0 -> derived)
    slstm_every: int = 0        # xlstm: every Nth layer is sLSTM
    attn_every: int = 0         # zamba2: shared attn block after every Nth ssm layer
    # --- encoder-decoder ---
    encoder_layers: int = 0
    encoder_seq: int = 0        # whisper frame count (stub frontend)
    # --- VLM ---
    patch_tokens: int = 0       # llava: prepended patch embeddings (stub)
    # --- misc ---
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    subquadratic: bool = False  # eligible for long_500k
    source: str = ""            # provenance note
    # --- distribution policy knobs (hillclimbable) ---
    # The sharding rules (distributed/sharding.py) read fsdp / pure_dp /
    # fsdp_experts; the training path reads remat and microbatches;
    # seq_parallel is for the caller that sets distributed/ctx.py's axes.
    fsdp: bool = True           # shard param storage over the data axis too
    pure_dp: bool = False       # small archs: model axis joins data (DP-256;
                                # TP would shard 4 heads 16 ways = replication
                                # + per-layer activation all-reduces for nothing)
    fsdp_experts: bool = True   # MoE: FSDP the expert weights too (off ->
                                # experts shard on EP only; kills the 16x
                                # per-layer expert-weight all-gather)
    seq_parallel: bool = False  # Megatron SP: residual stream S on TP axis
    remat: str = "block"        # none | block  (R&B-buffer-insight knob)
    microbatches: int = 1       # gradient-accumulation chunks in train_step
    q_chunk: int = 1024         # flash-attention query chunk
    kv_chunk: int = 1024        # flash-attention kv chunk

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    def reduced(self) -> "ArchConfig":
        """Same family, CPU-smoke size."""
        return dataclasses.replace(
            self,
            num_layers=min(self.num_layers, 4),
            d_model=128,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads < self.num_heads else 4,
            head_dim=32,
            d_ff=256 if self.num_experts == 0 else 64,
            vocab_size=512,
            num_experts=min(self.num_experts, 8) if self.num_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_heads=0,
            attn_every=min(self.attn_every, 2) if self.attn_every else 0,
            encoder_layers=min(self.encoder_layers, 2) if self.encoder_layers else 0,
            encoder_seq=min(self.encoder_seq, 32) if self.encoder_seq else 0,
            patch_tokens=min(self.patch_tokens, 16) if self.patch_tokens else 0,
            sliding_window=min(self.sliding_window, 16) if self.sliding_window else 0,
            microbatches=1,
            q_chunk=16,
            kv_chunk=16,
        )

    def param_count(self) -> int:
        """Approximate total parameters (for MODEL_FLOPS in the roofline)."""
        d, ff, v, hd = self.d_model, self.d_ff, self.vocab_size, self.head_dim_
        attn = d * hd * self.num_heads + 2 * d * hd * self.num_kv_heads + hd * self.num_heads * d
        mlp = 3 * d * ff if self.family != "moe" else 3 * d * ff * self.num_experts
        per_layer = attn + mlp + 2 * d
        if self.family in ("ssm", "hybrid"):
            d_inner = 2 * d
            ssm_layer = d * (2 * d_inner + 2 * self.ssm_state + 8) + d_inner * d
            per_layer = ssm_layer + 2 * d
        total = self.num_layers * per_layer
        if self.family == "hybrid" and self.attn_every:
            total += attn + 3 * d * ff  # one shared attention+MLP block
        if self.family == "encdec":
            enc = self.encoder_layers * (attn + 3 * d * ff + 2 * d)
            total += enc + self.num_layers * attn  # cross-attention
        total += v * d * (1 if self.tie_embeddings else 2)
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top-k experts count)."""
        if self.family != "moe":
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        dense = self.param_count() - self.num_layers * 3 * d * ff * self.num_experts
        return int(dense + self.num_layers * 3 * d * ff * self.top_k)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


_REGISTRY: Dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs():
    return sorted(_REGISTRY)


def shape_cells(cfg: ArchConfig) -> Tuple[ShapeSpec, ...]:
    """The shape cells this arch runs (long_500k only for sub-quadratic)."""
    cells = [SHAPES["train_4k"], SHAPES["prefill_32k"], SHAPES["decode_32k"]]
    if cfg.subquadratic:
        cells.append(SHAPES["long_500k"])
    return tuple(cells)
