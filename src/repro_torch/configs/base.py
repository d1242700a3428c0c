"""Model / run configuration system.

One :class:`ModelConfig` covers all assigned architecture families (dense,
MoE, SSM, hybrid, enc-dec audio, VLM backbone).  Per-arch files in this
package export ``config()`` with the exact assigned dims, plus
``smoke_config()`` — a reduced same-family config for CPU tests.

Shapes are :class:`ShapeConfig`; the four assigned shape sets are constants.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "ssm", "hybrid", "encdec"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    router_z_loss: float = 1e-3
    load_balance_loss: float = 1e-2


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) hyper-parameters."""

    state_dim: int = 128          # N
    head_dim: int = 64            # P
    expand: int = 2               # d_inner = expand * d_model
    n_groups: int = 1             # B/C groups (GVA)
    conv_width: int = 4
    chunk_size: int = 256         # SSD chunk length


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    """Zamba2-style: shared attention block applied every `period` layers."""

    period: int = 6               # one shared-attn invocation per 6 mamba layers


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                 # 0 => d_model // n_heads
    qk_norm: bool = False
    rope_theta: float = 1e6
    mrope: bool = False               # Qwen2-VL M-RoPE (3-section t/h/w)
    mrope_sections: tuple = (16, 24, 24)
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    act: str = "silu"                 # silu => SwiGLU MLP; gelu => GeLU MLP
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    hybrid: HybridConfig | None = None
    # enc-dec (whisper): n_layers applies to BOTH encoder and decoder stacks
    encoder_layers: int = 0
    encoder_seq: int = 1500           # whisper frame count after conv stub
    # numerics
    param_dtype: str = "bfloat16"
    activation_dtype: str = "bfloat16"
    # notes for DESIGN/roofline
    sub_quadratic: bool = False       # can run long_500k

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    def param_count(self) -> int:
        """Analytic parameter count (for 6·N·D roofline + sanity checks)."""
        d, v, hd = self.d_model, self.vocab, self.resolved_head_dim
        emb = v * d * (1 if self.tie_embeddings else 2)
        att = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
            + (self.n_heads * hd) * d
        if self.qk_norm:
            att += 2 * hd
        if self.act == "silu":
            mlp = 3 * d * self.d_ff
        else:
            mlp = 2 * d * self.d_ff
        if self.moe is not None:
            mlp = mlp * self.moe.num_experts + d * self.moe.num_experts
        norms = 2 * d
        per_layer = att + mlp + norms

        if self.family == "ssm":
            per_layer = self._ssm_layer_params() + d
        elif self.family == "hybrid":
            shared = att + mlp + norms
            per_layer = self._ssm_layer_params() + d
            return emb + self.n_layers * per_layer + shared + d
        elif self.family == "encdec":
            # encoder: self-attn + mlp; decoder: self-attn + cross-attn + mlp
            enc = self.encoder_layers * (att + mlp + norms)
            dec = self.n_layers * (att + att + mlp + 3 * d)
            return emb + enc + dec + d

        return emb + self.n_layers * per_layer + d

    def _ssm_layer_params(self) -> int:
        s = self.ssm or SSMConfig()
        d = self.d_model
        d_in = s.expand * d
        nheads = d_in // s.head_dim
        conv_dim = d_in + 2 * s.n_groups * s.state_dim
        in_proj = d * (2 * d_in + 2 * s.n_groups * s.state_dim + nheads)
        return (in_proj + conv_dim * s.conv_width + nheads * 2  # A_log, D
                + d_in                                           # gated-norm weight
                + d_in * d)                                      # out_proj

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top-k experts count)."""
        if self.moe is None:
            return self.param_count()
        full = self.param_count()
        expert = (3 if self.act == "silu" else 2) * self.d_model * self.d_ff
        inactive = self.n_layers * expert * (self.moe.num_experts - self.moe.top_k)
        return full - inactive


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


TRAIN_4K = ShapeConfig("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Distribution + numerics knobs for a training/serving run."""

    microbatches: int = 1            # gradient-accumulation steps
    remat: str = "full"              # none | dots | full
    zero3: bool = False              # shard params over the data axis (FSDP)
    seq_shard_kv: bool = True        # decode: shard KV cache seq over model axis
    seq_parallel: bool = False       # shard activation seq dim over model axis
    expert_axis: str | None = None   # MoE expert-parallel axis (None = expert-TP)
    moe_group_size: int = 2048       # GShard expert-group size (dispatch is
                                     # O(S·C)=O(S²) per group -> smaller is cheaper)
    decode_carry_cache: bool = False # thread KV cache through the layer-scan
                                     # CARRY (guaranteed in-place) instead of
                                     # xs->ys (which copies the full cache)
    decode_attn_impl: str = "direct" # direct | chunked (flash-decoding scan;
                                     # never materializes [B,H,S] scores)
    grad_compression: str = "none"   # none | bf16 | int8_ef
    grad_accum_dtype: str = "float32"  # float32 | bfloat16 — microbatch grad
                                     # accumulator (bf16 halves grad-AR wire)
    attention_impl: str = "chunked"  # chunked | naive | pallas
    attention_chunk: int = 1024
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip: float = 1.0
    warmup_steps: int = 100
