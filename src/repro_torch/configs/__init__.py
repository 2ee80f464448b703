"""Architecture configs (the port's own copy)."""
from repro_torch.configs.base import (MERGE_STRATEGIES, ArchConfig,
                                      EncDecConfig, HybridConfig, MoEConfig,
                                      SSMConfig, VerticalConfig, VLMConfig,
                                      get_arch, register)

__all__ = ["MERGE_STRATEGIES", "ArchConfig", "EncDecConfig", "HybridConfig",
           "MoEConfig", "SSMConfig", "VLMConfig", "VerticalConfig",
           "get_arch", "register"]
