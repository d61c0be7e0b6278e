"""phi4-mini-3.8b — dense, RoPE SwiGLU GQA, 200k vocab.

[dense] 32L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=200064
[arXiv:2412.08905; hf]
"""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="phi4-mini-3.8b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=200064,
    tie_embeddings=True,
    subquadratic=False,
    fsdp=False,
    microbatches=8,
    source="arXiv:2412.08905; hf",
))
