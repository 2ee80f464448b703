"""internvl2-26b — VLM backbone (InternViT stubbed + InternLM2) [arXiv:2404.16821].

The vision encoder + projector are a stub: callers provide precomputed
patch embeddings of shape (batch, num_vision_tokens, d_model)
(``repro_torch.models.frontend``); this config is the language decoder.
The values are the JAX package's.
"""
from repro_torch.configs.base import (ArchConfig, VerticalConfig, VLMConfig,
                                      register)

INTERNVL2_26B = register(
    ArchConfig(
        name="internvl2-26b",
        family="vlm",
        num_layers=48,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        d_ff=16384,
        vocab_size=92553,
        rope_theta=1000000.0,
        vlm=VLMConfig(num_vision_tokens=1024),
        # by-source split (the paper's most natural case): vision vs text client
        vertical=VerticalConfig(num_clients=2, tower_layers=1, merge="avg"),
        source="arXiv:2404.16821",
    )
)
