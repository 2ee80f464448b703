"""deepseek-moe-16b — fine-grained MoE: 2 shared + 64 routed top-6 [arXiv:2401.06066]."""
from repro_torch.configs.base import ArchConfig, MoEConfig, VerticalConfig, register

DEEPSEEK_MOE_16B = register(
    ArchConfig(
        name="deepseek-moe-16b",
        family="moe",
        num_layers=28,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        d_ff=1408,  # per-expert ffn width (fine-grained)
        vocab_size=102400,
        rope_theta=10000.0,
        moe=MoEConfig(
            num_experts=64,
            top_k=6,
            num_shared_experts=2,
            capacity_factor=1.25,
            first_dense_layers=1,  # deepseek-moe keeps layer 0 dense
        ),
        vertical=VerticalConfig(num_clients=4, tower_layers=2, merge="avg"),
        source="arXiv:2401.06066",
    )
)
