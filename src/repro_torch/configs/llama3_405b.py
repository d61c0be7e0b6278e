"""llama3-405b — dense GQA, 128k vocab.

[dense] 126L d_model=16384 128H (GQA kv=8) d_ff=53248 vocab=128256
[arXiv:2407.21783; unverified]

Pure full attention -> long_500k skipped (DESIGN.md §Arch-applicability).
The memory heavyweight: FSDP(data) x TP(model) param sharding and
gradient-accumulation microbatching are required to fit v5e HBM.
"""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="llama3-405b",
    family="dense",
    num_layers=126,
    d_model=16384,
    num_heads=128,
    num_kv_heads=8,
    d_ff=53248,
    vocab_size=128256,
    rope_theta=5e5,
    subquadratic=False,
    fsdp=True,
    microbatches=16,
    source="arXiv:2407.21783; unverified",
))
