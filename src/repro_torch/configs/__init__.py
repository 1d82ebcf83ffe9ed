"""Model configurations of the port (the slice serves tinyllama-1.1b)."""

from repro_torch.configs import tinyllama_1_1b  # noqa: F401  (registers)
from repro_torch.configs.base import (  # noqa: F401
    ModelConfig,
    get_config,
    list_configs,
    register,
)
