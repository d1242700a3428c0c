"""Model assembly — the dense family (decoder-only LM, GQA/MQA + SwiGLU)
and the ssm family (attention-free Mamba2 stack).

Counterpart of ``repro/models/transformer.py``.  ``dense`` and ``ssm`` are
ported; the other families raise ``NotImplementedError`` at dispatch.
Every ported family exposes:

  init(seed, cfg, device="cuda")                  -> params (nn.Module)
  forward(params, batch, cfg, run)                -> (logits, aux)
  init_cache(cfg, batch, max_seq, device="cuda")  -> cache dict
  decode_step(params, cache, batch, cfg, run)     -> (logits, cache)
  prefill_with_cache(params, batch, cfg, run, max_seq, cache=, slot=)

The reference's ``lax.scan`` over stacked layers is a Python loop over an
``nn.ModuleList``.  The cache keeps the reference layout
``[L, B, S, KH, Dh]`` and is written in place: decode writes each new
token's K/V at its slot's position (both of the reference's
``decode_carry_cache`` variants are this one path), and prefill writes the
prompt's K/V straight into its slot's rows of a pool.

``run.attention_impl == "pallas"`` selects the hand-written CUDA kernels
for both attention cores (flash attention in prefill, decode attention in
decode) and, in the ssm family, the SSD scan kernel in prefill (decode is
the one-token recurrence); every RMSNorm goes through the rmsnorm kernel
wrapper.  The ssm cache holds each slot's recurrent state (``ssm``
[L, B, H, N, P] f32) and conv tail (``conv`` [L, B, W-1, conv_dim]), both
updated in place.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.kernels import ops

from . import layers as L
from . import mamba2 as M

_AUX_KEYS = ("moe_load_balance", "moe_z_loss", "moe_drop_fraction")


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises if it names CUDA and none is
    present (the port's entry points never fall back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _adtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.activation_dtype)


def _pdtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def _dec_attn(run: RunConfig):
    """Decode attention core per RunConfig."""
    if run.decode_attn_impl == "chunked":
        raise NotImplementedError("decode_attn_impl='chunked' "
                                  "(decode_attention_chunked) is not ported")
    if run.attention_impl == "pallas":
        return ops.decode_attention
    return L.decode_attention


def _angles(cfg: ModelConfig, positions: torch.Tensor) -> torch.Tensor | None:
    """positions: [B, S] (or [B, 3, S], whose first stream is taken)."""
    if cfg.attn_free:
        return None
    if cfg.mrope:
        raise NotImplementedError("M-RoPE (mrope_angles) is not ported")
    if positions.ndim == 3:
        positions = positions[:, 0, :]
    return L.rope_angles(positions, cfg.resolved_head_dim, cfg.rope_theta)


# ===========================================================================
# Parameters
# ===========================================================================

class AttnLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device=None):
        super().__init__()
        self.ln1 = L.RMSNorm(cfg.d_model, dtype, device)
        self.attn = L.Attention(cfg, dtype, device)
        self.ln2 = L.RMSNorm(cfg.d_model, dtype, device)
        self.mlp = L.MLP(cfg, dtype, device)


class DenseLM(nn.Module):
    """Parameters of a dense decoder: embed, layers[L], final_norm."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        dt = _pdtype(cfg)
        self.embed = L.Embedding(cfg, dt, device)
        self.layers = nn.ModuleList(AttnLayer(cfg, dt, device)
                                    for _ in range(cfg.n_layers))
        self.final_norm = L.RMSNorm(cfg.d_model, dt, device)


def _attn_layer_apply(lp: AttnLayer, x: torch.Tensor, cfg: ModelConfig,
                      run: RunConfig, angles, causal: bool) -> torch.Tensor:
    h = L.attention_apply(lp.attn, L.rmsnorm_apply(lp.ln1, x, cfg.norm_eps),
                          cfg, angles=angles, causal=causal,
                          impl=run.attention_impl, chunk=run.attention_chunk)
    return _ffn(x + h, lp, cfg)


def _ffn(x: torch.Tensor, lp: AttnLayer, cfg: ModelConfig) -> torch.Tensor:
    xn = L.rmsnorm_apply(lp.ln2, x, cfg.norm_eps)
    return x + L.mlp_apply(lp.mlp, xn, cfg)


# ===========================================================================
# dense decoder-only LM
# ===========================================================================

@torch.no_grad()
def init_dense(gen: torch.Generator, cfg: ModelConfig, device) -> DenseLM:
    model = DenseLM(cfg, device=device)
    model.embed.init_weights(cfg, gen)
    for lp in model.layers:
        lp.attn.init_weights(cfg, gen)
        lp.mlp.init_weights(cfg, gen)
    return model


def _positions(batch: dict, B: int, S: int, device) -> torch.Tensor:
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(S, device=device)[None, :].expand(B, S)
    return positions


@torch.no_grad()
def forward_dense(params: DenseLM, batch: dict, cfg: ModelConfig,
                  run: RunConfig, last_only: bool = False):
    tokens = batch["tokens"]                       # [B, S]
    B, S = tokens.shape
    x = L.embed_apply(params.embed, tokens, _adtype(cfg))
    ang = _angles(cfg, _positions(batch, B, S, tokens.device))
    for lp in params.layers:
        x = _attn_layer_apply(lp, x, cfg, run, ang, causal=True)
    if last_only:
        x = x[:, -1:]
    x = L.rmsnorm_apply(params.final_norm, x, cfg.norm_eps)
    logits = L.unembed_apply(params.embed, x)
    aux = {k: torch.zeros((), device=x.device) for k in _AUX_KEYS}
    return logits, aux


# -- decode -----------------------------------------------------------------

def init_cache_dense(cfg: ModelConfig, batch: int, max_seq: int,
                     device) -> dict:
    KH, Dh = cfg.n_kv_heads, cfg.resolved_head_dim
    shape = (cfg.n_layers, batch, max_seq, KH, Dh)
    return {"k": torch.zeros(shape, dtype=_adtype(cfg), device=device),
            "v": torch.zeros(shape, dtype=_adtype(cfg), device=device)}


def _active_pos(batch: dict, max_seq: int) -> torch.Tensor:
    """Write positions with inactive slots pushed out of range (dropped)."""
    seq_lens = batch["seq_lens"]
    active = batch.get("active")
    if active is None:
        return seq_lens
    return torch.where(active, seq_lens, max_seq)


def _cache_insert(cache: torch.Tensor, kv: torch.Tensor,
                  pos: torch.Tensor) -> None:
    """In-place per-slot write: cache [B,S,KH,Dh], kv [B,1,KH,Dh], pos [B].

    Each sequence writes at its own position.  A slot with pos >= S (an
    inactive slot) is dropped, as the reference's mode="drop" scatter: its
    row at S-1 is written back with its own values, so no host-side mask
    (and no sync) is needed and its data do not change."""
    B, S = cache.shape[:2]
    b = torch.arange(B, device=cache.device)
    row = pos.clamp(max=S - 1)
    keep = (pos < S)[:, None, None]
    cache[b, row] = torch.where(keep, kv[:, 0].to(cache.dtype), cache[b, row])


@torch.no_grad()
def decode_dense(params: DenseLM, cache: dict, batch: dict, cfg: ModelConfig,
                 run: RunConfig):
    """One decode step.  batch: tokens [B,1], seq_lens [B] (tokens already
    in each slot's cache), optional active [B] bool.  Writes the new K/V
    into ``cache`` in place; returns (logits [B, V], cache)."""
    tokens = batch["tokens"]
    seq_lens = batch["seq_lens"]                   # [B]: per-slot position
    B = tokens.shape[0]
    H, Dh = cfg.n_heads, cfg.resolved_head_dim
    x = L.embed_apply(params.embed, tokens, _adtype(cfg))
    ang = _angles(cfg, seq_lens[:, None])
    wpos = _active_pos(batch, cache["k"].shape[2])
    lens = (seq_lens + 1).to(torch.int32)
    attend = _dec_attn(run)
    for l, lp in enumerate(params.layers):
        xn = L.rmsnorm_apply(lp.ln1, x, cfg.norm_eps)
        q, k, v = L.attention_qkv(lp.attn, xn, cfg, ang)
        _cache_insert(cache["k"][l], k, wpos)
        _cache_insert(cache["v"][l], v, wpos)
        o = attend(q[:, 0], cache["k"][l], cache["v"][l], lens)
        x = x + o.reshape(B, 1, H * Dh) @ lp.attn.wo
        x = _ffn(x, lp, cfg)
    x = L.rmsnorm_apply(params.final_norm, x, cfg.norm_eps)
    logits = L.unembed_apply(params.embed, x)[:, 0]
    return logits, cache


# ===========================================================================
# ssm (Mamba2)
# ===========================================================================

class SSMLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device=None):
        super().__init__()
        self.ln = L.RMSNorm(cfg.d_model, dtype, device)
        self.mixer = M.Mamba2(cfg, dtype, device)


class SSMLM(nn.Module):
    """Parameters of a Mamba2 LM: embed, layers[L], final_norm."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        dt = _pdtype(cfg)
        self.embed = L.Embedding(cfg, dt, device)
        self.layers = nn.ModuleList(SSMLayer(cfg, dt, device)
                                    for _ in range(cfg.n_layers))
        self.final_norm = L.RMSNorm(cfg.d_model, dt, device)


def _ssm_impl(run: RunConfig) -> str:
    return "pallas" if run.attention_impl == "pallas" else "chunked"


@torch.no_grad()
def init_ssm(gen: torch.Generator, cfg: ModelConfig, device) -> SSMLM:
    model = SSMLM(cfg, device=device)
    model.embed.init_weights(cfg, gen)
    for lp in model.layers:
        lp.mixer.init_weights(cfg, gen)
    return model


@torch.no_grad()
def forward_ssm(params: SSMLM, batch: dict, cfg: ModelConfig, run: RunConfig,
                last_only: bool = False):
    x = L.embed_apply(params.embed, batch["tokens"], _adtype(cfg))
    impl = _ssm_impl(run)
    for lp in params.layers:
        x = x + M.mamba2_apply(lp.mixer,
                               L.rmsnorm_apply(lp.ln, x, cfg.norm_eps),
                               cfg, impl=impl)
    if last_only:
        x = x[:, -1:]
    x = L.rmsnorm_apply(params.final_norm, x, cfg.norm_eps)
    return L.unembed_apply(params.embed, x), {}


def init_cache_ssm(cfg: ModelConfig, batch: int, max_seq: int,
                   device) -> dict:
    dm = M.ssm_dims(cfg)
    return {
        "ssm": torch.zeros((cfg.n_layers, batch, dm["nheads"], dm["state"],
                            dm["head_dim"]), dtype=torch.float32,
                           device=device),
        "conv": torch.zeros((cfg.n_layers, batch, dm["conv_width"] - 1,
                             dm["conv_dim"]), dtype=_adtype(cfg),
                            device=device),
    }


def _masked_state(new: torch.Tensor, old: torch.Tensor,
                  active: torch.Tensor | None) -> torch.Tensor:
    """Recurrent-state update gate: inactive slots keep their old state
    (a lockstep decode step must not advance slots that are not decoding
    this tick).  A select on the device: no host sync, no boolean index."""
    if active is None:
        return new
    mask = active.reshape((active.shape[0],) + (1,) * (new.ndim - 1))
    return torch.where(mask, new, old)


@torch.no_grad()
def decode_ssm(params: SSMLM, cache: dict, batch: dict, cfg: ModelConfig,
               run: RunConfig):
    """One decode step.  batch: tokens [B,1], optional active [B] bool.
    Each layer's state in ``cache`` is updated in place (inactive slots
    keep theirs); returns (logits [B, V], cache)."""
    active = batch.get("active")
    x = L.embed_apply(params.embed, batch["tokens"], _adtype(cfg))
    for l, lp in enumerate(params.layers):
        h, ssm_new, conv_new = M.mamba2_decode(
            lp.mixer, L.rmsnorm_apply(lp.ln, x, cfg.norm_eps), cfg,
            cache["ssm"][l], cache["conv"][l])
        x = x + h
        cache["ssm"][l] = _masked_state(ssm_new, cache["ssm"][l], active)
        cache["conv"][l] = _masked_state(conv_new, cache["conv"][l], active)
    x = L.rmsnorm_apply(params.final_norm, x, cfg.norm_eps)
    logits = L.unembed_apply(params.embed, x)[:, 0]
    return logits, cache


# ===========================================================================
# Family dispatch
# ===========================================================================

_FAMILY = {
    "dense": (init_dense, forward_dense, init_cache_dense, decode_dense),
    "ssm": (init_ssm, forward_ssm, init_cache_ssm, decode_ssm),
}


def _family(cfg: ModelConfig, table: dict):
    if cfg.family not in table:
        raise NotImplementedError(f"the {cfg.family!r} family is not ported "
                                  f"to repro_torch yet")
    return table[cfg.family]


def init(seed: int | torch.Generator, cfg: ModelConfig, *,
         device="cuda") -> nn.Module:
    """Random parameters at the reference's scales.  ``seed``: an int, or a
    ``torch.Generator`` on ``device``."""
    dev = resolve_device(device)
    init_fn = _family(cfg, _FAMILY)[0]
    gen = seed if isinstance(seed, torch.Generator) else \
        torch.Generator(device=dev).manual_seed(int(seed))
    return init_fn(gen, cfg, dev)


def forward(params: nn.Module, batch: dict, cfg: ModelConfig, run: RunConfig,
            last_only: bool = False):
    return _family(cfg, _FAMILY)[1](params, batch, cfg, run,
                                    last_only=last_only)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, *,
               device="cuda") -> dict:
    return _family(cfg, _FAMILY)[2](cfg, batch, max_seq,
                                    resolve_device(device))


def decode_step(params: nn.Module, cache: dict, batch: dict, cfg: ModelConfig,
                run: RunConfig):
    return _family(cfg, _FAMILY)[3](params, cache, batch, cfg, run)


# ===========================================================================
# Serving prefill: forward pass that also fills the decode cache
# ===========================================================================

def _last_hidden(x: torch.Tensor, batch: dict) -> torch.Tensor:
    """Select the true last-prompt position per sequence.

    Prompts may be right-padded to a bucket length; `last_index` [B] gives
    each sequence's final real position (default: the last column)."""
    idx = batch.get("last_index")
    if idx is None:
        return x[:, -1:]
    B = x.shape[0]
    return x[torch.arange(B, device=x.device), idx.long()][:, None]


@torch.no_grad()
def prefill_dense_with_cache(params: DenseLM, batch: dict, cfg: ModelConfig,
                             run: RunConfig, max_seq: int, *,
                             cache: dict | None = None, slot: int = 0):
    """Returns (last_logits [B, V], cache).

    The prompt's K/V go straight into rows [0, S) of slots
    [slot, slot + B) of ``cache`` (a new zeroed cache of B slots when None);
    rows past S keep what they held, and decode never reads them before it
    writes them."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    H, Dh = cfg.n_heads, cfg.resolved_head_dim
    if cache is None:
        cache = init_cache_dense(cfg, B, max_seq, tokens.device)
    x = L.embed_apply(params.embed, tokens, _adtype(cfg))
    ang = _angles(cfg, _positions(batch, B, S, tokens.device))
    for l, lp in enumerate(params.layers):
        xn = L.rmsnorm_apply(lp.ln1, x, cfg.norm_eps)
        q, k, v = L.attention_qkv(lp.attn, xn, cfg, ang)
        o = L.attention_core(q, k, v, causal=True, impl=run.attention_impl,
                             chunk=run.attention_chunk)
        x = x + o.reshape(B, S, H * Dh) @ lp.attn.wo
        x = _ffn(x, lp, cfg)
        cache["k"][l, slot:slot + B, :S] = k
        cache["v"][l, slot:slot + B, :S] = v
    x = L.rmsnorm_apply(params.final_norm, _last_hidden(x, batch),
                        cfg.norm_eps)
    logits = L.unembed_apply(params.embed, x)[:, 0]
    return logits, cache


@torch.no_grad()
def prefill_ssm_with_cache(params: SSMLM, batch: dict, cfg: ModelConfig,
                           run: RunConfig, max_seq: int, *,
                           cache: dict | None = None, slot: int = 0):
    """Returns (last_logits [B, V], cache).  Each layer's final state and
    conv tail go straight into slots [slot, slot + B) of ``cache`` (a new
    zeroed cache of B slots when None).  The state is taken at the end of
    the tokens: prompts must be exact-length (the engine does so)."""
    tokens = batch["tokens"]
    B = tokens.shape[0]
    if cache is None:
        cache = init_cache_ssm(cfg, B, max_seq, tokens.device)
    x = L.embed_apply(params.embed, tokens, _adtype(cfg))
    impl = _ssm_impl(run)
    for l, lp in enumerate(params.layers):
        h, (ssm_state, conv_state) = M.mamba2_apply(
            lp.mixer, L.rmsnorm_apply(lp.ln, x, cfg.norm_eps), cfg,
            impl=impl, return_state=True)
        x = x + h
        cache["ssm"][l, slot:slot + B] = ssm_state
        cache["conv"][l, slot:slot + B] = conv_state
    x = L.rmsnorm_apply(params.final_norm, _last_hidden(x, batch),
                        cfg.norm_eps)
    logits = L.unembed_apply(params.embed, x)[:, 0]
    return logits, cache


_PREFILL_CACHE = {
    "dense": prefill_dense_with_cache,
    "ssm": prefill_ssm_with_cache,
}


def prefill_with_cache(params: nn.Module, batch: dict, cfg: ModelConfig,
                       run: RunConfig, max_seq: int, *,
                       cache: dict | None = None, slot: int = 0):
    """(last_logits [B, V], decode-ready cache) for every ported family."""
    return _family(cfg, _PREFILL_CACHE)(params, batch, cfg, run, max_seq,
                                        cache=cache, slot=slot)
