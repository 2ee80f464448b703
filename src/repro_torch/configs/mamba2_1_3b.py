"""mamba2-1.3b — attention-free SSD (state-space duality) [arXiv:2405.21060]."""
from repro_torch.configs.base import (ArchConfig, SSMConfig, VerticalConfig,
                                      register)

MAMBA2_1_3B = register(
    ArchConfig(
        name="mamba2-1.3b",
        family="ssm",
        num_layers=48,
        d_model=2048,
        num_heads=0,  # attention-free
        num_kv_heads=0,
        d_ff=0,
        vocab_size=50280,
        ssm=SSMConfig(d_state=128, expand=2, head_dim=64, chunk_size=128),
        vertical=VerticalConfig(num_clients=4, tower_layers=2, merge="avg"),
        source="arXiv:2405.21060",
    )
)
