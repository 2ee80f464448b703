"""zamba2-7b — hybrid Mamba2 + shared attention blocks [arXiv:2411.15242]."""
from repro_torch.configs.base import (
    ArchConfig,
    HybridConfig,
    SSMConfig,
    VerticalConfig,
    register,
)

ZAMBA2_7B = register(
    ArchConfig(
        name="zamba2-7b",
        family="hybrid",
        num_layers=81,
        d_model=3584,
        num_heads=32,
        num_kv_heads=32,
        d_ff=14336,  # shared attention block's MLP width
        vocab_size=32000,
        ssm=SSMConfig(d_state=64, expand=2, head_dim=64, chunk_size=128),
        hybrid=HybridConfig(shared_attn_every=6),
        vertical=VerticalConfig(num_clients=4, tower_layers=2, merge="avg"),
        source="arXiv:2411.15242",
    )
)
