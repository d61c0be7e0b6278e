"""qwen3-moe-235b-a22b — 128 experts, top-8 (the larger Qwen3 MoE).

[moe] 94L d_model=4096 64H (GQA kv=4) d_ff=1536 vocab=151936, MoE 128e top-8
[hf:Qwen/Qwen3-30B-A3B; hf]
"""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    d_ff=1536,
    vocab_size=151936,
    num_experts=128,
    top_k=8,
    subquadratic=False,
    fsdp=True,
    microbatches=8,
    source="hf:Qwen/Qwen3-30B-A3B; hf",
))
