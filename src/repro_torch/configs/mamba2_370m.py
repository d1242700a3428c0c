"""mamba2-370m — attention-free SSD (state-space duality).
[arXiv:2405.21060; unverified]"""
from repro_torch.configs.base import ModelConfig, SSMConfig

ARCH_ID = "mamba2-370m"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="ssm",
        n_layers=48, d_model=1024, n_heads=1, n_kv_heads=1,
        d_ff=0, vocab=50280,
        ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, n_groups=1,
                      conv_width=4, chunk_size=256),
        tie_embeddings=True, sub_quadratic=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="ssm",
        n_layers=2, d_model=64, n_heads=1, n_kv_heads=1,
        d_ff=0, vocab=256,
        ssm=SSMConfig(state_dim=16, head_dim=8, expand=2, n_groups=1,
                      conv_width=4, chunk_size=16),
        tie_embeddings=True, sub_quadratic=True,
    )
