"""qwen3-32b — dense LM with qk_norm, GQA kv=8 [hf:Qwen/Qwen3-8B]."""
from repro_torch.configs.base import ArchConfig, VerticalConfig, register

QWEN3_32B = register(
    ArchConfig(
        name="qwen3-32b",
        family="dense",
        num_layers=64,
        d_model=5120,
        num_heads=64,
        num_kv_heads=8,
        d_ff=25600,
        vocab_size=151936,
        qk_norm=True,
        rope_theta=1000000.0,
        head_dim=128,
        vertical=VerticalConfig(num_clients=4, tower_layers=2, merge="avg"),
        source="hf:Qwen/Qwen3-8B",
    )
)
