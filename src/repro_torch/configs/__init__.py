from repro_torch.configs.base import (ARCH_IDS, MLAConfig, ModelConfig,
                                      MoEConfig, SSMConfig, get_config,
                                      reduced)
