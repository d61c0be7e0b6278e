"""h2o-danube-1.8b — llama+mistral mix with sliding-window attention.

[dense] 24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000
[arXiv:2401.16818; hf]

Listed [dense]; its SWA would make long_500k feasible but per the brief's
family rule we skip long_500k for the dense family (noted in DESIGN.md).
"""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="h2o-danube-1.8b",
    family="dense",
    num_layers=24,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    d_ff=6912,
    vocab_size=32000,
    sliding_window=4096,
    subquadratic=False,
    fsdp=False,
    microbatches=4,
    source="arXiv:2401.16818; hf",
))
