"""configs of the PyTorch port: the reference's ten architectures, the same
values in the same registration order."""

from repro_torch.configs.base import (  # noqa: F401
    ArchConfig,
    ShapeSpec,
    SHAPES,
    get_arch,
    list_archs,
    register,
)

# Importing the package registers every assigned architecture.
from repro_torch.configs import (  # noqa: F401
    zamba2_1p2b,
    llama3_405b,
    phi4_mini_3p8b,
    h2o_danube_1p8b,
    gemma3_27b,
    xlstm_125m,
    llava_next_mistral_7b,
    whisper_large_v3,
    qwen3_moe_30b_a3b,
    qwen3_moe_235b_a22b,
)
