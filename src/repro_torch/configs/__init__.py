from repro_torch.configs.base import (ARCH_IDS,  # noqa: F401
                                      ModelConfig, get_config)
