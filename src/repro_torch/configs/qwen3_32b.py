"""qwen3-32b — dense, qk_norm, GQA. [hf:Qwen/Qwen3-8B family; hf]"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "qwen3-32b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        n_layers=64, d_model=5120, n_heads=64, n_kv_heads=8,
        d_ff=25600, vocab=151936,
        qk_norm=True, rope_theta=1e6, act="silu",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=256,
        qk_norm=True, rope_theta=1e4, act="silu",
    )
