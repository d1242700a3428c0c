"""granite-moe-3b-a800m — fine-grained MoE, 40 experts top-8, tiny experts.
[hf:ibm-granite/granite-3.0-3b-a800m-base; hf]"""
from repro_torch.configs.base import ModelConfig, MoEConfig

ARCH_ID = "granite-moe-3b-a800m"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="moe",
        n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8,
        d_ff=512, vocab=49155, head_dim=64,
        moe=MoEConfig(num_experts=40, top_k=8, capacity_factor=1.25),
        tie_embeddings=True, rope_theta=1e4, act="silu",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="moe",
        n_layers=2, d_model=48, n_heads=4, n_kv_heads=2,
        d_ff=32, vocab=256, head_dim=12,
        moe=MoEConfig(num_experts=8, top_k=4, capacity_factor=1.5),
        tie_embeddings=True, rope_theta=1e4, act="silu",
    )
