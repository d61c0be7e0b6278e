"""qwen3-moe-30b-a3b — 128 experts, top-8.

[moe] 48L d_model=2048 32H (GQA kv=4) d_ff=768 vocab=151936, MoE 128e top-8
[hf:Qwen/Qwen3-30B-A3B; hf]

d_ff=768 is the per-expert FFN width. Experts are sharded on the model axis
(EP, 8 experts/chip at TP=16); dispatch is the sort-free cumulative-position
gather (the same construction as the rasterizer's fragment lists — and the
arch where the paper's GMU insight maps directly, see DESIGN.md §4).
"""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    d_ff=768,
    vocab_size=151936,
    num_experts=128,
    top_k=8,
    subquadratic=False,
    fsdp=True,
    microbatches=8,
    source="hf:Qwen/Qwen3-30B-A3B; hf",
))
