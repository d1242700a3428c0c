"""qwen2-vl-72b — VLM backbone with M-RoPE; patch frontend is a STUB
(input_specs provides token ids + M-RoPE position ids). [arXiv:2409.12191; hf]"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "qwen2-vl-72b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
        d_ff=29568, vocab=152064, head_dim=128,
        mrope=True, mrope_sections=(16, 24, 24),
        rope_theta=1e6, act="silu",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=256, head_dim=32,
        mrope=True, mrope_sections=(4, 6, 6),
        rope_theta=1e4, act="silu",
    )
