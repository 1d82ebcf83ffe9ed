"""Model configurations of the port (tinyllama-1.1b) and input shapes."""

from repro_torch.configs import tinyllama_1_1b  # noqa: F401  (registers)
from repro_torch.configs.base import (  # noqa: F401
    ModelConfig,
    ShapeSpec,
    get_config,
    list_configs,
    register,
)
