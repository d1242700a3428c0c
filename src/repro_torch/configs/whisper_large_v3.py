"""whisper-large-v3 — enc-dec audio backbone; conv/mel frontend is a STUB
(input_specs provides precomputed frame embeddings). [arXiv:2212.04356]

Adaptation notes (DESIGN.md §2): the backbone uses RoPE for decoder positions
instead of Whisper's learned absolute embeddings — positional scheme is not
the assignment's focus; dims/heads/layers match the assigned spec (32L each
for encoder and decoder, as in the released large checkpoints)."""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "whisper-large-v3"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="encdec",
        n_layers=32, encoder_layers=32, encoder_seq=1500,
        d_model=1280, n_heads=20, n_kv_heads=20,
        d_ff=5120, vocab=51866,
        rope_theta=1e4, act="gelu",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="encdec",
        n_layers=2, encoder_layers=2, encoder_seq=30,
        d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=256,
        rope_theta=1e4, act="gelu",
    )
