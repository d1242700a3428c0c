"""Mamba2 — SSD (state-space duality) mixer layer (arXiv:2405.21060).

Counterpart of ``repro/models/mamba2.py``:

  per head h, with per-step decay a_t = exp(dt_t * A_h):
    intra-chunk:  Y_ij = C_i·B_j · exp(Σ_{j<r<=i} log a_r) · (dt_j x_j), i>=j
    chunk state:  S_c  = Σ_j exp(Σ_{j<r<=last} log a_r) B_j ⊗ (dt_j x_j)
    inter-chunk:  recurrence S <- decay(chunk) · S + S_c
    output:       y_i += C_i · S_prev · exp(Σ_{r<=i} log a_r)

Decode is the O(1) recurrent update:  S <- a·S + B⊗(dt·x);  y = C·S + D·x.

Layer wiring follows the Mamba2 block: in_proj -> (z, xBC, dt); causal
depthwise conv over xBC; SSD; gated RMSNorm; out_proj.  Parameters live in
a ``Mamba2`` module whose attribute names are the reference's keys.
``impl="pallas"`` runs the SSD through the hand-written CUDA kernel
(``ops.ssd_scan``; its plain version on a CPU tensor), ``"chunked"``
through ``ssd_chunked`` below; the gated norm goes through the rmsnorm
kernel either way.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.kernels import ops

from . import layers as L


# ---------------------------------------------------------------------------
# Dimensions and parameters
# ---------------------------------------------------------------------------

def ssm_dims(cfg: ModelConfig) -> dict:
    s = cfg.ssm or SSMConfig()
    d_in = s.expand * cfg.d_model
    nheads = d_in // s.head_dim
    conv_dim = d_in + 2 * s.n_groups * s.state_dim
    return {"d_inner": d_in, "nheads": nheads, "conv_dim": conv_dim,
            "state": s.state_dim, "head_dim": s.head_dim,
            "groups": s.n_groups, "conv_width": s.conv_width,
            "chunk": s.chunk_size}


class Mamba2(nn.Module):
    """Separate z / xBC / dt projections, as the reference.  ``A_log``,
    ``D`` and ``dt_bias`` are f32 whatever ``dtype`` is."""

    def __init__(self, cfg: ModelConfig, dtype, device=None):
        super().__init__()
        dm = ssm_dims(cfg)
        d, d_in = cfg.d_model, dm["d_inner"]
        H, conv_dim = dm["nheads"], dm["conv_dim"]
        self.w_z = L._param((d, d_in), dtype, device)
        self.w_xBC = L._param((d, conv_dim), dtype, device)
        self.w_dt = L._param((d, H), dtype, device)
        self.conv_w = L._param((dm["conv_width"], conv_dim), dtype, device)
        self.conv_b = L._param((conv_dim,), dtype, device)
        self.A_log = L._param((H,), torch.float32, device)
        self.D = L._param((H,), torch.float32, device)
        self.dt_bias = L._param((H,), torch.float32, device)
        self.gate_norm = L.RMSNorm(d_in, dtype, device)
        self.out_proj = L._param((d_in, d), dtype, device)

    def init_weights(self, cfg: ModelConfig, gen: torch.Generator) -> None:
        """The reference's ``init_mamba2`` scales."""
        H = self.A_log.shape[0]
        s_in = 1.0 / math.sqrt(cfg.d_model)
        for w in (self.w_z, self.w_xBC, self.w_dt):
            L._normal(w, s_in, gen)
        L._normal(self.conv_w, 0.1, gen)
        L._normal(self.out_proj, 1.0 / math.sqrt(self.out_proj.shape[0]), gen)
        self.conv_b.zero_()
        self.A_log.copy_(torch.log(torch.linspace(1.0, 16.0, H)))
        self.D.fill_(1.0)
        self.dt_bias.zero_()


# ---------------------------------------------------------------------------
# Causal depthwise conv
# ---------------------------------------------------------------------------

def causal_conv(x: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """x: [B, L, C]; w: [W, C] depthwise; left-pad to keep causality."""
    W, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = torch.zeros_like(x)
    for i in range(W):  # W is tiny (4)
        out = out + xp[:, i:i + S, :] * w[i]
    return out + b


def conv_step(x_t: torch.Tensor, conv_state: torch.Tensor, w: torch.Tensor,
              b: torch.Tensor) -> tuple:
    """Decode: x_t [B, C]; conv_state [B, W-1, C] (previous inputs)."""
    window = torch.cat([conv_state, x_t[:, None, :]], dim=1)   # [B, W, C]
    out = torch.einsum("bwc,wc->bc", window, w) + b
    return out, window[:, 1:, :]


# ---------------------------------------------------------------------------
# SSD core (chunked, plain PyTorch)
# ---------------------------------------------------------------------------

def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bmat: torch.Tensor, Cmat: torch.Tensor, chunk: int,
                init_state: torch.Tensor | None = None):
    """SSD scan.

    x:    [B, L, H, P]  (head inputs)
    dt:   [B, L, H]     (positive step sizes, post-softplus)
    A:    [H]           (negative per-head decay rates)
    Bmat: [B, L, G, N]
    Cmat: [B, L, G, N]
    Returns (y [B, L, H, P], final_state [B, H, N, P] f32).
    """
    Bsz, L, H, P = x.shape
    G, N = Bmat.shape[2], Bmat.shape[3]
    HperG = H // G
    nchunks = -(-L // chunk)
    pad = nchunks * chunk - L
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bmat = F.pad(Bmat, (0, 0, 0, 0, 0, pad))
        Cmat = F.pad(Cmat, (0, 0, 0, 0, 0, pad))
    Lp = nchunks * chunk

    xq = x.reshape(Bsz, nchunks, chunk, H, P).float()
    dtq = dt.reshape(Bsz, nchunks, chunk, H).float()
    Bq = Bmat.reshape(Bsz, nchunks, chunk, G, N).float()
    Cq = Cmat.reshape(Bsz, nchunks, chunk, G, N).float()

    dA = dtq * A.float()                             # [B,nc,Q,H] (negative)
    cum = torch.cumsum(dA, dim=2)                    # inclusive cumsum
    seg_total = cum[:, :, -1, :]                     # [B,nc,H]
    xdt = xq * dtq[..., None]                        # dt-weighted inputs

    # ---- intra-chunk (quadratic within chunk) --------------------------------
    li = cum[:, :, :, None, :]                       # [B,nc,Q,1,H]
    lj = cum[:, :, None, :, :]                       # [B,nc,1,Q,H]
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=x.device))[None, None, :, :, None]
    # clamp before exp: masked (i<j) entries have li-lj > 0 and could
    # overflow; valid entries have li-lj <= 0, so the clamp is exact there
    decay = torch.where(mask, torch.exp(torch.clamp(li - lj, max=0.0)), 0.0)
    cb = torch.einsum("bcign,bcjgn->bcijg", Cq, Bq)  # [B,nc,Q,Q,G]
    M = cb.repeat_interleave(HperG, dim=-1) * decay  # [B,nc,Q,Q,H]
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", M, xdt)

    # ---- chunk states ----------------------------------------------------------
    decay_to_end = torch.exp(seg_total[:, :, None, :] - cum)        # [B,nc,Q,H]
    Bh = Bq.repeat_interleave(HperG, dim=3)                         # [B,nc,Q,H,N]
    states = torch.einsum("bcqhn,bcqhp,bcqh->bchnp", Bh, xdt, decay_to_end)

    # ---- inter-chunk recurrence (sequential over chunks) -----------------------
    S = (init_state.float() if init_state is not None
         else torch.zeros((Bsz, H, N, P), dtype=torch.float32, device=x.device))
    S_prevs = []
    for c in range(nchunks):
        S_prevs.append(S)
        S = S * torch.exp(seg_total[:, c])[:, :, None, None] + states[:, c]
    S_prevs = torch.stack(S_prevs, dim=1)            # [B,nc,H,N,P]

    # ---- inter-chunk contribution ---------------------------------------------
    Ch = Cq.repeat_interleave(HperG, dim=3)                         # [B,nc,Q,H,N]
    y_inter = torch.einsum("bcqhn,bchnp,bcqh->bcqhp", Ch, S_prevs,
                           torch.exp(cum))
    y = (y_intra + y_inter).reshape(Bsz, Lp, H, P)[:, :L]
    return y.to(x.dtype), S


def ssd_decode_step(state: torch.Tensor, x_t: torch.Tensor,
                    dt_t: torch.Tensor, A: torch.Tensor, B_t: torch.Tensor,
                    C_t: torch.Tensor):
    """One-token recurrence.

    state: [B, H, N, P]; x_t: [B, H, P]; dt_t: [B, H];
    B_t/C_t: [B, G, N].  Returns (y [B, H, P], new_state f32).
    """
    H = state.shape[1]
    HperG = H // B_t.shape[1]
    a = torch.exp(dt_t.float() * A.float())                  # [B, H]
    xdt = x_t.float() * dt_t.float()[..., None]              # [B, H, P]
    Bh = B_t.float().repeat_interleave(HperG, dim=1)         # [B, H, N]
    Ch = C_t.float().repeat_interleave(HperG, dim=1)
    new_state = state.float() * a[:, :, None, None] + torch.einsum(
        "bhn,bhp->bhnp", Bh, xdt)
    y = torch.einsum("bhn,bhnp->bhp", Ch, new_state)
    return y.to(x_t.dtype), new_state


# ---------------------------------------------------------------------------
# Full Mamba2 block
# ---------------------------------------------------------------------------

def _project(params: Mamba2, x: torch.Tensor):
    """x: [..., D] -> (z, xBC, dt) via the three separate projections."""
    return x @ params.w_z, x @ params.w_xBC, x @ params.w_dt


def _split_xBC(xBC: torch.Tensor, dm: dict):
    d_in, g, n = dm["d_inner"], dm["groups"], dm["state"]
    x = xBC[..., :d_in]
    B = xBC[..., d_in:d_in + g * n]
    C = xBC[..., d_in + g * n:]
    return x, B, C


def _gate_out(params: Mamba2, y: torch.Tensor, z: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    """Gated RMSNorm (the rmsnorm kernel at width d_inner) and out_proj."""
    return L.rmsnorm_apply(params.gate_norm, y * F.silu(z),
                           cfg.norm_eps) @ params.out_proj


def mamba2_apply(params: Mamba2, x: torch.Tensor, cfg: ModelConfig, *,
                 impl: str = "chunked", return_state: bool = False):
    """Full-sequence Mamba2 block.  x: [B, L, D] -> [B, L, D].

    ``return_state=True`` also returns (ssm_state [B,H,N,P] f32,
    conv_state [B,W-1,conv_dim]) so serving prefill can seed decode."""
    dm = ssm_dims(cfg)
    Bsz, S, _ = x.shape
    H, P, G, N = dm["nheads"], dm["head_dim"], dm["groups"], dm["state"]
    W = dm["conv_width"]

    z, xBC_raw, dt = _project(params, x)
    xBC = F.silu(causal_conv(xBC_raw, params.conv_w, params.conv_b))
    xs, Bm, Cm = _split_xBC(xBC, dm)
    xs = xs.reshape(Bsz, S, H, P)
    Bm = Bm.reshape(Bsz, S, G, N)
    Cm = Cm.reshape(Bsz, S, G, N)
    dt = F.softplus(dt.float() + params.dt_bias)
    A = -torch.exp(params.A_log)

    if impl == "pallas":
        # the kernel takes contiguous x/B/C (views of xBC here)
        y, final_state = ops.ssd_scan(xs.contiguous(), dt, A, Bm.contiguous(),
                                      Cm.contiguous(), chunk=dm["chunk"])
    else:
        y, final_state = ssd_chunked(xs, dt, A, Bm, Cm, chunk=dm["chunk"])
    y = y + xs * params.D[None, None, :, None].to(y.dtype)
    out = _gate_out(params, y.reshape(Bsz, S, dm["d_inner"]), z, cfg)
    if not return_state:
        return out
    # conv state = last W-1 RAW xBC inputs (pre-conv, pre-silu), left-padded
    if S < W - 1:
        tail = F.pad(xBC_raw, (0, 0, W - 1 - S, 0))
    else:
        tail = xBC_raw[:, S - (W - 1):, :]
    return out, (final_state, tail)


def mamba2_decode(params: Mamba2, x: torch.Tensor, cfg: ModelConfig,
                  ssm_state: torch.Tensor, conv_state: torch.Tensor):
    """One-token decode.  x: [B, 1, D]; returns (y [B,1,D], ssm', conv')."""
    dm = ssm_dims(cfg)
    Bsz = x.shape[0]
    H, P, G, N = dm["nheads"], dm["head_dim"], dm["groups"], dm["state"]

    z, xBC, dt = _project(params, x[:, 0, :])
    xBC, conv_state = conv_step(xBC, conv_state, params.conv_w, params.conv_b)
    xBC = F.silu(xBC)
    xs, Bm, Cm = _split_xBC(xBC, dm)
    xs = xs.reshape(Bsz, H, P)
    Bm = Bm.reshape(Bsz, G, N)
    Cm = Cm.reshape(Bsz, G, N)
    dt = F.softplus(dt.float() + params.dt_bias)
    A = -torch.exp(params.A_log)

    y, ssm_state = ssd_decode_step(ssm_state, xs, dt, A, Bm, Cm)
    y = y + xs * params.D[None, :, None].to(y.dtype)
    out = _gate_out(params, y.reshape(Bsz, dm["d_inner"]), z, cfg)
    return out[:, None, :], ssm_state, conv_state
