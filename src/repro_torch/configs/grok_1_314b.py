"""grok-1-314b — MoE, 8 experts top-2, gated expert MLP.
[hf:xai-org/grok-1; unverified]"""
from repro_torch.configs.base import ModelConfig, MoEConfig

ARCH_ID = "grok-1-314b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="moe",
        n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8,
        d_ff=32768, vocab=131072, head_dim=128,
        moe=MoEConfig(num_experts=8, top_k=2, capacity_factor=1.25),
        rope_theta=1e4, act="silu",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=96, vocab=256, head_dim=16,
        moe=MoEConfig(num_experts=4, top_k=2, capacity_factor=1.5),
        rope_theta=1e4, act="silu",
    )
