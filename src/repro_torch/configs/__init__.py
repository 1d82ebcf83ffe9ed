"""Model configurations of the port (tinyllama-1.1b, rwkv6-3b,
mistral-nemo-12b, phi3-mini-3.8b, gemma-2b, recurrentgemma-2b,
moonshot-v1-16b-a3b, qwen3-moe-235b-a22b, qwen2-vl-72b and the
encoder-decoder seamless-m4t-medium) and input shapes."""

# importing each config module registers it
from repro_torch.configs import (  # noqa: F401
    gemma_2b,
    mistral_nemo_12b,
    moonshot_v1_16b_a3b,
    phi3_mini_3_8b,
    qwen2_vl_72b,
    qwen3_moe_235b_a22b,
    recurrentgemma_2b,
    rwkv6_3b,
    seamless_m4t_medium,
    tinyllama_1_1b,
)
from repro_torch.configs.base import (  # noqa: F401
    SHAPES,
    ModelConfig,
    ShapeSpec,
    get_config,
    list_configs,
    register,
    shape_applicable,
)
