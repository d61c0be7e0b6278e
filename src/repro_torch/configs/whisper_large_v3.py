"""whisper-large-v3 — encoder-decoder audio backbone, conv frontend stubbed.

[audio] 32L d_model=1280 20H (GQA kv=20) d_ff=5120 vocab=51866
[arXiv:2212.04356; unverified]

32 encoder + 32 decoder layers; the conv frontend is a STUB — ``input_specs``
provides 1500 precomputed frame embeddings (B, 1500, d_model). Decoder has
causal self-attention + cross-attention to the encoder memory; decode shapes
lower the decoder serve_step with a cached cross-attention memory.
"""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="whisper-large-v3",
    family="encdec",
    num_layers=32,
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    encoder_layers=32,
    encoder_seq=1500,
    subquadratic=False,
    fsdp=False,
    microbatches=8,
    source="arXiv:2212.04356; unverified",
))
