"""granite-34b — dense code model, MQA (kv=1), GPTBigCode-style GeLU MLP.
[arXiv:2405.04324; hf]"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "granite-34b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1,
        d_ff=24576, vocab=49152, head_dim=128,
        rope_theta=1e5, act="gelu",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=1,
        d_ff=128, vocab=256, head_dim=16,
        rope_theta=1e4, act="gelu",
    )
