"""stablelm-3b — dense LM [hf:stabilityai/stablelm-2-1_6b]."""
from repro_torch.configs.base import ArchConfig, VerticalConfig, register

STABLELM_3B = register(
    ArchConfig(
        name="stablelm-3b",
        family="dense",
        num_layers=32,
        d_model=2560,
        num_heads=32,
        num_kv_heads=32,
        d_ff=6912,
        vocab_size=50304,
        rope_theta=10000.0,
        vertical=VerticalConfig(num_clients=4, tower_layers=2, merge="avg"),
        source="hf:stabilityai/stablelm-2-1_6b",
    )
)
