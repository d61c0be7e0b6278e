"""zamba2-1.2b — Mamba2 backbone + shared attention blocks.

[hybrid] 38L d_model=2048 32H (GQA kv=32) d_ff=8192 vocab=32000, ssm_state=64
[arXiv:2411.15242; hf]

Zamba2's signature design: a single shared transformer (attention + MLP)
block whose parameters are reused at periodic depths of the Mamba2 stack.
We apply the shared block after every 8th SSM layer. Sub-quadratic
(SSM state + sliding-window on the shared attention) -> runs long_500k.
"""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    ssm_state=64,
    attn_every=8,
    sliding_window=4096,       # bounds the shared block's KV at 500k decode
    tie_embeddings=True,
    subquadratic=True,
    fsdp=False,                # 1.2B: replicate over data, TP only
    microbatches=16,           # f32 GLA chunk states dominate train memory
    source="arXiv:2411.15242; hf",
))
