"""qwen3-14b — dense, qk_norm, GQA, head_dim 128. [hf:Qwen/Qwen3-8B family; hf]"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "qwen3-14b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        n_layers=40, d_model=5120, n_heads=40, n_kv_heads=8,
        d_ff=17408, vocab=151936, head_dim=128,
        qk_norm=True, rope_theta=1e6, act="silu",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=96, vocab=256, head_dim=32,
        qk_norm=True, rope_theta=1e4, act="silu",
    )
