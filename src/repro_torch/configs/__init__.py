"""Architecture configs (the port's own copy)."""
from repro_torch.configs.base import (MERGE_STRATEGIES, ArchConfig,
                                      HybridConfig, MoEConfig, SSMConfig,
                                      VerticalConfig, get_arch, register)

__all__ = ["MERGE_STRATEGIES", "ArchConfig", "HybridConfig", "MoEConfig",
           "SSMConfig", "VerticalConfig", "get_arch", "register"]
