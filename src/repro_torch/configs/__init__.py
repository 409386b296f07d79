from repro_torch.configs.base import (ARCH_IDS,  # noqa: F401
                                      SHAPES, ModelConfig, get_config)
