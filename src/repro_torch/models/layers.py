"""Core transformer layers: RMSNorm, RoPE, GQA/MQA attention, MLP.

Counterpart of ``repro/models/layers.py``.  Parameters live in small
``nn.Module`` containers (``RMSNorm``, ``Attention``, ``MLP``,
``Embedding``) and every ``*_apply`` is a plain tensor function over one of
them, so each can be held against the jnp function of the same name.
Attention cores:

* ``naive``   — full score matrix (tests/smoke only; O(S²) memory)
* ``chunked`` — online softmax over KV chunks (the flash algorithm in
                plain PyTorch)
* ``pallas``  — the hand-written CUDA kernels in ``repro_torch.kernels``
                (their plain versions on a CPU tensor)

Numerics follow the reference: params in cfg.param_dtype, attention logits
and softmax sums in f32, residual stream in the activation dtype.  Where
the reference rounds to the working dtype (q·scale in ``chunked_attention``,
p before p·V in ``decode_attention``) the port rounds at the same place.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops

NEG_INF = -2.0e30


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


def _normal(p: nn.Parameter, scale: float, gen: torch.Generator) -> None:
    """p <- N(0, 1)·scale drawn in f32, then cast (as ``layers.init_*``)."""
    z = torch.randn(p.shape, generator=gen, dtype=torch.float32,
                    device=p.device)
    p.copy_(z.mul_(scale))


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

class RMSNorm(nn.Module):
    def __init__(self, d: int, dtype, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d, dtype=dtype, device=device),
                                  requires_grad=False)


def rmsnorm_apply(params: RMSNorm, x: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    return ops.rmsnorm(x, params.scale, eps=eps)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float) -> torch.Tensor:
    """positions [..., S] -> angles [..., S, head_dim//2] (f32)."""
    half = head_dim // 2
    exponent = torch.arange(half, dtype=torch.float32,
                            device=positions.device) / half
    inv_freq = 1.0 / (theta ** exponent)
    return positions.float()[..., None] * inv_freq


def apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x: [B, S, H, Dh]; angles: [B, S, Dh//2] (broadcast over heads)."""
    dtype = x.dtype
    x = x.float()
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(dtype)


# ---------------------------------------------------------------------------
# Attention cores
# ---------------------------------------------------------------------------

def naive_attention(q, k, v, *, causal: bool, q_offset: int = 0):
    """Reference attention.  q: [B,Sq,H,Dh], k/v: [B,Sk,KH,Dh] with H=KH*G."""
    B, Sq, H, Dh = q.shape
    KH = k.shape[2]
    G = H // KH
    qg = q.reshape(B, Sq, KH, G, Dh).float()
    s = torch.einsum("bqkgd,bckd->bqkgc", qg, k.float()) * (1.0 / math.sqrt(Dh))
    if causal:
        qpos = q_offset + torch.arange(Sq, device=q.device)
        kpos = torch.arange(k.shape[1], device=q.device)
        mask = kpos[None, :] > qpos[:, None]                # [Sq, Sk]
        s = s.masked_fill(mask[None, :, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bqkgc,bckd->bqkgd", p, v.float())
    return out.reshape(B, Sq, H, Dh).to(q.dtype)


def chunked_attention(q, k, v, *, causal: bool, chunk: int = 1024,
                      q_offset: int = 0):
    """Online-softmax attention over KV chunks (flash algorithm, PyTorch)."""
    B, Sq, H, Dh = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    G = H // KH
    scale = 1.0 / math.sqrt(Dh)
    chunk = min(chunk, Sk)
    qg = (q.reshape(B, Sq, KH, G, Dh) * scale).to(q.dtype).float()
    qpos = q_offset + torch.arange(Sq, device=q.device)
    acc = torch.zeros((B, Sq, KH, G, Dh), dtype=torch.float32, device=q.device)
    m = torch.full((B, Sq, KH, G), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, Sq, KH, G), dtype=torch.float32, device=q.device)
    for idx in range(cdiv(Sk, chunk)):
        # the reference pads K/V to whole chunks; padded keys are masked, so
        # a short last chunk computes the same online update
        ks = k[:, idx * chunk:(idx + 1) * chunk]
        vs = v[:, idx * chunk:(idx + 1) * chunk]
        n = ks.shape[1]
        s = torch.einsum("bqkgd,bckd->bqkgc", qg, ks.float())
        if causal:
            kpos = idx * chunk + torch.arange(n, device=q.device)
            invalid = kpos[None, :] > qpos[:, None]
            s = s.masked_fill(invalid[None, :, None, None, :], NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bqkgc,bckd->bqkgd", p.to(v.dtype).float(), vs.float())
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(B, Sq, H, Dh).to(q.dtype)


def decode_attention(q, k_cache, v_cache, cache_len):
    """Single-token attention against a KV cache.

    q: [B, H, Dh]; k_cache/v_cache: [B, S, KH, Dh]; cache_len: filled
    length (int, [B] or [B, 1]).
    """
    B, H, Dh = q.shape
    S, KH = k_cache.shape[1], k_cache.shape[2]
    G = H // KH
    qg = (q.reshape(B, KH, G, Dh) * (1.0 / math.sqrt(Dh))).float()
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float())
    valid = (torch.arange(S, device=q.device)[None, :]
             < torch.as_tensor(cache_len, device=q.device).reshape(-1, 1))
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(B, H, Dh).to(q.dtype)


# ---------------------------------------------------------------------------
# Attention block (projections + norm + rope + core)
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device=None):
        super().__init__()
        d, H, KH = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
        Dh = cfg.resolved_head_dim
        self.wq = _param((d, H * Dh), dtype, device)
        self.wk = _param((d, KH * Dh), dtype, device)
        self.wv = _param((d, KH * Dh), dtype, device)
        self.wo = _param((H * Dh, d), dtype, device)
        if cfg.qk_norm:
            self.q_norm = RMSNorm(Dh, dtype, device)
            self.k_norm = RMSNorm(Dh, dtype, device)

    def init_weights(self, cfg: ModelConfig, gen: torch.Generator) -> None:
        s = 1.0 / math.sqrt(cfg.d_model)
        for w in (self.wq, self.wk, self.wv):
            _normal(w, s, gen)
        _normal(self.wo, 1.0 / math.sqrt(cfg.n_heads * cfg.resolved_head_dim),
                gen)


def attention_qkv(params: Attention, x: torch.Tensor, cfg: ModelConfig,
                  angles: torch.Tensor | None):
    """Project + (qk-norm) + rope.  Returns q [B,S,H,Dh], k/v [B,S,KH,Dh]."""
    B, S, _ = x.shape
    H, KH, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = (x @ params.wq).reshape(B, S, H, Dh)
    k = (x @ params.wk).reshape(B, S, KH, Dh)
    v = (x @ params.wv).reshape(B, S, KH, Dh)
    if cfg.qk_norm:
        q = rmsnorm_apply(params.q_norm, q, cfg.norm_eps)
        k = rmsnorm_apply(params.k_norm, k, cfg.norm_eps)
    if angles is not None:
        q = apply_rope(q, angles)
        k = apply_rope(k, angles)
    return q, k, v


def attention_core(q, k, v, *, causal: bool, impl: str, chunk: int):
    """The prefill attention core that ``impl`` names."""
    if impl == "naive":
        return naive_attention(q, k, v, causal=causal)
    if impl == "pallas":
        return ops.flash_attention(q, k, v, causal=causal)
    return chunked_attention(q, k, v, causal=causal, chunk=chunk)


def attention_apply(params: Attention, x: torch.Tensor, cfg: ModelConfig, *,
                    angles: torch.Tensor | None, causal: bool = True,
                    impl: str = "chunked", chunk: int = 1024,
                    kv_override: tuple | None = None) -> torch.Tensor:
    """Full attention block on [B, S, D].  kv_override: cross-attention."""
    B, S, _ = x.shape
    H, Dh = cfg.n_heads, cfg.resolved_head_dim
    q, k, v = attention_qkv(params, x, cfg, angles)
    if kv_override is not None:
        k, v = kv_override
    o = attention_core(q, k, v, causal=causal, impl=impl, chunk=chunk)
    return o.reshape(B, S, H * Dh) @ params.wo


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GeLU)
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device=None):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        if cfg.act == "silu":
            self.w_gate = _param((d, f), dtype, device)
        self.w_up = _param((d, f), dtype, device)
        self.w_down = _param((f, d), dtype, device)

    def init_weights(self, cfg: ModelConfig, gen: torch.Generator) -> None:
        s_in = 1.0 / math.sqrt(cfg.d_model)
        if cfg.act == "silu":
            _normal(self.w_gate, s_in, gen)
        _normal(self.w_up, s_in, gen)
        _normal(self.w_down, 1.0 / math.sqrt(cfg.d_ff), gen)


def mlp_apply(params: MLP, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.act == "silu":
        h = F.silu(x @ params.w_gate) * (x @ params.w_up)
    else:
        h = F.gelu(x @ params.w_up, approximate="tanh")   # jax.nn.gelu default
    return h @ params.w_down


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

class Embedding(nn.Module):
    """Token table [V, D] and, untied, the unembedding [D, V].

    The reference computes logits in f32 from f32-cast weights.  To keep
    those numerics without casting [D, V] on every call, the unembedding is
    kept in f32 (values of param_dtype, cast once); tied tables use the
    table itself."""

    def __init__(self, cfg: ModelConfig, dtype, device=None):
        super().__init__()
        self.table = _param((cfg.vocab, cfg.d_model), dtype, device)
        if not cfg.tie_embeddings:
            self.unembed = _param((cfg.d_model, cfg.vocab), torch.float32,
                                  device)
        self.param_dtype = dtype

    def init_weights(self, cfg: ModelConfig, gen: torch.Generator) -> None:
        _normal(self.table, 0.02, gen)
        if not cfg.tie_embeddings:
            _normal(self.unembed, 0.02, gen)
            # round through param_dtype, as the reference stores it
            self.unembed.copy_(self.unembed.to(self.param_dtype))


def embed_apply(params: Embedding, tokens: torch.Tensor, dtype) -> torch.Tensor:
    """Token embedding lookup.  The reference's one-hot matmul exists only
    for vocab-sharded tables; on one card the gather gives the same values."""
    return params.table[tokens.long()].to(dtype)


def unembed_apply(params: Embedding, x: torch.Tensor) -> torch.Tensor:
    """Logits in f32 (loss numerics)."""
    if hasattr(params, "unembed"):
        w = params.unembed
    else:
        w = params.table.float().T
    return torch.einsum("bsd,dv->bsv", x.float(), w)
