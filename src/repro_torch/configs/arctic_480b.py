"""arctic-480b — 128-expert top-2 MoE with dense residual [hf:Snowflake/snowflake-arctic-base]."""
from repro_torch.configs.base import ArchConfig, MoEConfig, VerticalConfig, register

ARCTIC_480B = register(
    ArchConfig(
        name="arctic-480b",
        family="moe",
        num_layers=35,
        d_model=7168,
        num_heads=56,
        num_kv_heads=8,
        d_ff=4864,  # per-expert ffn width
        vocab_size=32000,
        rope_theta=10000.0,
        moe=MoEConfig(
            num_experts=128,
            top_k=2,
            dense_residual=True,  # arctic: dense FFN in parallel with MoE
            d_ff_dense_residual=4864,
            capacity_factor=1.25,
        ),
        vertical=VerticalConfig(num_clients=4, tower_layers=2, merge="avg"),
        source="hf:Snowflake/snowflake-arctic-base",
    )
)
