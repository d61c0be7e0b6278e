"""gemma3-27b — dense, 5:1 local:global attention, 256k vocab.

[dense] 62L d_model=5376 32H (GQA kv=16) d_ff=21504 vocab=262144
[hf:google/gemma-3-1b-pt; unverified]

Every 6th layer is global full attention; the other five use a 1024-token
sliding window. Pure full attention on globals -> long_500k skipped.
"""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="gemma3-27b",
    family="dense",
    num_layers=62,
    d_model=5376,
    num_heads=32,
    num_kv_heads=16,
    d_ff=21504,
    vocab_size=262144,
    local_global_ratio=5,
    sliding_window=1024,
    rope_theta=1e6,
    tie_embeddings=True,
    subquadratic=False,
    fsdp=True,
    microbatches=8,
    source="hf:google/gemma-3-1b-pt; unverified",
))
