"""Model configurations of the port (tinyllama-1.1b, rwkv6-3b) and input
shapes."""

# importing each config module registers it
from repro_torch.configs import rwkv6_3b, tinyllama_1_1b  # noqa: F401
from repro_torch.configs.base import (  # noqa: F401
    ModelConfig,
    ShapeSpec,
    get_config,
    list_configs,
    register,
)
