"""zamba2-2.7b — hybrid: Mamba2 backbone + weight-shared attention block
applied every 6 layers. [arXiv:2411.15242; hf]

Adaptation note (DESIGN.md): the released model interleaves two shared
blocks with per-invocation LoRA deltas; we implement one fully-shared block
per period, which preserves the defining property (attention params are
O(1) in depth) with the assigned dims."""
from repro_torch.configs.base import HybridConfig, ModelConfig, SSMConfig

ARCH_ID = "zamba2-2.7b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="hybrid",
        n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
        d_ff=10240, vocab=32000,
        ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, n_groups=1,
                      conv_width=4, chunk_size=256),
        hybrid=HybridConfig(period=6),
        rope_theta=1e4, act="silu", sub_quadratic=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="hybrid",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=256,
        ssm=SSMConfig(state_dim=16, head_dim=8, expand=2, n_groups=1,
                      conv_width=4, chunk_size=16),
        hybrid=HybridConfig(period=2),
        rope_theta=1e4, act="silu", sub_quadratic=True,
    )
