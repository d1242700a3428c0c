"""minitron-4b — dense, pruned nemotron, GQA. [arXiv:2407.14679; hf]"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "minitron-4b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8,
        d_ff=9216, vocab=256000, head_dim=128,
        tie_embeddings=True, rope_theta=1e4, act="silu",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="dense",
        n_layers=2, d_model=48, n_heads=6, n_kv_heads=2,
        d_ff=96, vocab=512, head_dim=16,
        tie_embeddings=True, rope_theta=1e4, act="silu",
    )
