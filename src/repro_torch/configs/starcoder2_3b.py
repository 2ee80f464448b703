"""starcoder2-3b — dense code LM, GQA kv=2, RoPE [arXiv:2402.19173]."""
from repro_torch.configs.base import ArchConfig, VerticalConfig, register

STARCODER2_3B = register(
    ArchConfig(
        name="starcoder2-3b",
        family="dense",
        num_layers=30,
        d_model=3072,
        num_heads=24,
        num_kv_heads=2,
        d_ff=12288,
        vocab_size=49152,
        rope_theta=999999.0,
        vertical=VerticalConfig(num_clients=4, tower_layers=2, merge="avg"),
        source="arXiv:2402.19173",
    )
)
