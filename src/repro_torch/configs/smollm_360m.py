"""smollm-360m — llama-arch small dense LM [hf:HuggingFaceTB/SmolLM-135M]."""
from repro_torch.configs.base import ArchConfig, VerticalConfig, register

SMOLLM_360M = register(
    ArchConfig(
        name="smollm-360m",
        family="dense",
        num_layers=32,
        d_model=960,
        num_heads=15,
        num_kv_heads=5,
        d_ff=2560,
        vocab_size=49152,
        rope_theta=10000.0,
        tie_embeddings=True,
        vertical=VerticalConfig(num_clients=4, tower_layers=2, merge="avg"),
        source="hf:HuggingFaceTB/SmolLM-135M",
    )
)
