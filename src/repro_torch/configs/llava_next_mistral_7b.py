"""llava-next-mistral-7b — VLM: mistral-7b backbone, anyres patch tiling.

[vlm] 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]

Per the brief the modality frontend is a STUB: ``input_specs()`` provides
576 precomputed patch embeddings per example, prepended to the token
sequence before the causal backbone.
"""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    patch_tokens=576,
    sliding_window=4096,       # mistral SWA
    subquadratic=False,
    fsdp=True,
    microbatches=8,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified",
))
