from repro_torch.configs.base import (ARCH_IDS, MLAConfig, ModelConfig,
                                      MoEConfig, ShapeCell, SSMConfig,
                                      get_config, reduced)
